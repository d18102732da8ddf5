// Paged flash-decode attention over the in-place kv pool.
//
// Replaces the TPU kernel tensorflowonspark_tpu/ops/paged_attention.py
// `_decode_kernel` (reached through `paged_attention`) and the split
// combine that the JAX wrapper does around it.  Same contract: q [B, S,
// H, Dh] against pools [NP, page, n_kv, Dh] through page_table [B,
// max_pages] and lengths [B]; query s of row b sees key j iff j <=
// lengths[b] - S + s; only the row's occupied pages are read (n_vis =
// min(lengths[b], max_pages * page) keys, table entries clipped into the
// pool); the GQA group of one kv head is handled inside the block; the
// output is [B, S, H, Dh] in q's dtype, exact zeros for a row with
// lengths == 0.
//
// What bounds it on the card: bytes.  A decode step reads every occupied
// k and v row once (FLAGSHIP_DECODE: 16 rows x 2001 tokens x 8 kv heads
// x 128 x 2 B x 2 = 131 MB per layer, 39 us at 3.35 TB/s) and does ~2
// FLOP per byte, far under the card's ~295 FLOP/byte ridge; an m16
// tensor-core product would waste 7/8 of its rows on the 2 grouped query
// rows of a kv head.  So the design is about keeping bytes in flight:
//
// - Spans over the occupied pages.  Split sp of n_splits (the wrapper's
//   divisor of max_pages, as the TPU wrapper picks it) walks pages [sp *
//   n_per, (sp + 1) * n_per) of the row's ceil(n_vis / page) occupied
//   pages, n_per = ceil(that / n_splits).  Every split of a long row has
//   work (fixed spans over max_pages left half of FLAGSHIP_DECODE's 1024
//   blocks empty), and the span depends on the row's own length only,
//   so a row gives the same bits alone as in a batch.
// - Tiles of tokens with 16-byte loads.  A lane owns 8 contiguous
//   elements of a kv row (one 16-byte load of bf16, 8 bytes of int8, 32
//   of f32), so Dh / 8 lanes span a row and a warp load covers 32 / (Dh /
//   8) tokens; each warp iteration issues U such loads of k and of v
//   before any arithmetic (U = 8 bf16, 8 int8, 2 f32: 8 KB in flight per
//   warp in bf16, 4 KB over int8 or f32, against 512 B a token at a time
//   before), for a tile of TT = U * 32 / (Dh / 8) tokens (16 at Dh 128
//   over bf16 or int8).  The 4 warps of a block take every 4th tile of
//   the split.  (At FLAGSHIP_DECODE on the card, against this form: U =
//   4 in bf16 took 3% longer, U = 4 over int8 8%; 8 warps a block 2%
//   longer in bf16, 11% over int8; a 64-register cap 29% / 90%.  PERF.md
//   has the times.)
// - One online-softmax update per tile: the tile's scores (a reduction
//   over the Dh / 8 lanes of a row), one max over the warp and one
//   rescale per row, then P V in f32 registers.  Masked and out-of-span
//   keys get p = 0 (their loads are clamped onto the span's last token).
// - The 4 warps' states merge in shared memory; each split writes an
//   unnormalised partial (acc, m, l), and `paged_decode_combine_kernel`
//   merges the splits in split order in one launch (weights exp(m_sp -
//   max m), the denominator clamped at 1e-30, so a row with no key
//   comes out as exact zeros), writing q's dtype.
//
// int8 kv pools (the JAX kernel's `quant` branch): f32 per-(token, head)
// scales in their canonical [NP, page, n_kv] layout, read in place
// (stride n_kv; the TPU wrapper's transposed scale copy exists for its
// lane tiling only), one 4-byte load per token beside its payload.  The
// scales fold into the f32 products instead of into each value: score =
// (q . k_int) * k_scale * sm_scale, and P V sums (p * v_scale) * v_int;
// the payload converts to f32 exactly, so this differs from `_decode_
// kernel`'s (k_int * k_scale) . q only in f32 rounding.  Nothing rounds
// through bf16.  Bound: bytes, half the bf16 pool's plus 8 B of scales
// per (token, head): FLAGSHIP_DECODE reads 67.6 MB per layer, 20 us.
#include <type_traits>

#include "common.cuh"

namespace tos {

constexpr int kDecodeWarps = 4;

// 8 consecutive elements of a kv or q row, as loaded; U such loads of k
// and of v per lane and warp iteration.
template <typename T>
struct Row8;

template <>
struct Row8<__nv_bfloat16> {
  static constexpr int U = 8;
  uint4 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    w = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void to_f32(float (&f)[8]) const {
    const unsigned x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(x[i] << 16);
      f[2 * i + 1] = __uint_as_float(x[i] & 0xffff0000u);
    }
  }
};

template <>
struct Row8<int8_t> {
  static constexpr int U = 8;
  uint2 w;
  __device__ __forceinline__ void load(const int8_t* p) {
    w = *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ void to_f32(float (&f)[8]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i] = static_cast<float>(static_cast<int>(w.x << (24 - 8 * i)) >> 24);
      f[4 + i] =
          static_cast<float>(static_cast<int>(w.y << (24 - 8 * i)) >> 24);
    }
  }
};

template <>
struct Row8<float> {
  static constexpr int U = 2;
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void to_f32(float (&f)[8]) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

// Grouped query rows per block: the smallest of 1, 2, 4 that holds S *
// group, tiled by 4 beyond that (a lane keeps RT x 8 q values, RT x 8
// accumulators and RT x U tile scores in registers).
constexpr int kMaxRowTile = 4;

static int decode_row_tile(int rows) {
  return rows <= 1 ? 1 : rows <= 2 ? 2 : kMaxRowTile;
}

// T: q's type; TK: the pool's storage type (T, or int8_t with scales).
template <typename T, typename TK, int DH, int RT>
__global__ void __launch_bounds__(kDecodeWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const TK* __restrict__ pk,
                    const TK* __restrict__ pv, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths,
                    float* __restrict__ acc_out, float* __restrict__ m_out,
                    float* __restrict__ l_out, int S, int H, int n_kv,
                    int page, int max_pages, int n_pages, int n_splits,
                    float sm_scale) {
  constexpr bool kQuant = std::is_same<TK, int8_t>::value;
  constexpr int L = DH / 8;           // lanes a kv row spans
  constexpr int G = 32 / L;           // tokens a warp load covers
  constexpr int U = Row8<TK>::U;      // loads of k (and v) per iteration
  constexpr int TT = G * U;           // tokens a warp iteration
  __shared__ float sm_m[kDecodeWarps][RT];
  __shared__ float sm_l[kDecodeWarps][RT];
  __shared__ float sm_acc[kDecodeWarps][RT][DH];

  const int sp = blockIdx.x;
  const int h = blockIdx.y % n_kv;
  const int rt = blockIdx.y / n_kv;
  const int b = blockIdx.z;
  const int group = H / n_kv;
  const int rows = S * group;
  const int r0 = rt * RT;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slot = lane / L;          // the lane's token within a load
  const int col = (lane % L) * 8;     // the lane's first element

  // the split's span over the row's occupied pages
  const int n_tok = lengths[b];
  const int n_vis = min(n_tok, max_pages * page);  // keys the table maps
  const int n_per = ((n_vis + page - 1) / page + n_splits - 1) / n_splits;
  const int t_begin = sp * n_per * page;
  const int t_end = min(t_begin + n_per * page, n_vis);

  float qr[RT][8];
  int lim[RT];  // last visible key of each grouped row
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = r0 + r;
    if (row < rows) {
      const int s = row / group;
      const int hq = h * group + row % group;
      Row8<T> qv;
      qv.load(q + ((size_t(b) * S + s) * H + hq) * DH + col);
      qv.to_f32(qr[r]);
      lim[r] = n_tok - S + s;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[r][e] = 0.f;
      lim[r] = -1;
    }
  }

  float m[RT], l[RT], acc[RT][8];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }

  const int* row_table = table + size_t(b) * max_pages;
  for (int t0 = t_begin + warp * TT; t0 < t_end; t0 += kDecodeWarps * TT) {
    // every load of the tile first; a token past the span reloads the
    // span's last one and is masked below
    Row8<TK> kr[U], vr[U];
    float ksc[U], vsc[U];
    int tok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      tok[u] = t0 + u * G + slot;
      const int t = min(tok[u], t_end - 1);
      // out-of-range table entries clamp into the pool, as a JAX gather
      // clips them
      const int phys = min(max(row_table[t / page], 0), n_pages - 1);
      const size_t row = (size_t(phys) * page + t % page) * n_kv + h;
      kr[u].load(pk + row * DH + col);
      vr[u].load(pv + row * DH + col);
      if constexpr (kQuant) {
        ksc[u] = ks[row];
        vsc[u] = vs[row];
      }
    }

    // scores of the lane's U tokens, reduced over the row's L lanes
    float s[RT][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[8];
      kr[u].to_f32(kf);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(qr[r][e], kf[e], d);
#pragma unroll
        for (int o = 1; o < L; o <<= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        if constexpr (kQuant) d *= ksc[u];
        s[r][u] = d * sm_scale;
      }
    }

    // one online-softmax update per row for the whole tile
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      bool vis[U];
      float mx = NEG_INF;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        vis[u] = tok[u] <= lim[r] && tok[u] < t_end;
        if (vis[u]) mx = fmaxf(mx, s[r][u]);
      }
#pragma unroll
      for (int o = L; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - mn);
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = vis[u] ? expf(s[r][u] - mn) : 0.f;
        ps += p;
        s[r][u] = p;
      }
      l[r] = l[r] * alpha + ps;
      m[r] = mn;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[8];
      vr[u].to_f32(vf);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float p = s[r][u];
        if constexpr (kQuant) p *= vsc[u];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
      }
    }
  }

  // the lane slots' partial sums (m is the same across the warp), then
  // the warps' states merged in shared memory: weights exp(m_w - M)
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int o = L; o < 32; o <<= 1) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
    }
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
    if (slot == 0) {
#pragma unroll
      for (int e = 0; e < 8; ++e) sm_acc[warp][r][col + e] = acc[r][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < RT * DH; i += kDecodeWarps * 32) {
    const int r = i / DH;
    const int d = i % DH;
    const int row = r0 + r;
    if (row >= rows) continue;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float wt = expf(sm_m[w][r] - mx);
      a = fmaf(wt, sm_acc[w][r][d], a);
      ls = fmaf(wt, sm_l[w][r], ls);
    }
    const size_t part = (size_t(b) * n_kv + h) * n_splits + sp;
    acc_out[(part * rows + row) * DH + d] = a;
    if (d == 0) {
      m_out[part * rows + row] = mx;
      l_out[part * rows + row] = ls;
    }
  }
}

// The split combine: one warp per (row b, kv head, grouped row), lanes
// over Dh.  Lane i reads split i's m and l (32 splits a pass), so every
// load of a pass is in flight at once; the weights exp(m_sp - max m)
// then scale each split's acc in split order, so repeated launches give
// the same bits.  out [B, S, H, Dh] in T.
template <typename T, int DH>
__global__ void __launch_bounds__(128)
paged_decode_combine_kernel(const float* __restrict__ acc,
                            const float* __restrict__ m,
                            const float* __restrict__ l, T* __restrict__ out,
                            int S, int H, int n_kv, int n_splits, int n_rows) {
  constexpr int EPT = DH / 32;
  const int w = blockIdx.x * 4 + (threadIdx.x >> 5);
  if (w >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const int group = H / n_kv;
  const int rows = S * group;
  const int row = w % rows;
  const int bh = w / rows;          // b * n_kv + h
  const size_t part0 = size_t(bh) * n_splits;
  float mx = NEG_INF;
  for (int s0 = lane; s0 < n_splits; s0 += 32)
    mx = fmaxf(mx, m[(part0 + s0) * rows + row]);
  mx = warp_max(mx);
  float denom = 0.f, o[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) o[e] = 0.f;
  for (int s0 = 0; s0 < n_splits; s0 += 32) {
    const int sp = s0 + lane;
    float wt = 0.f, wl = 0.f;
    if (sp < n_splits) {
      const size_t pr = (part0 + sp) * rows + row;
      wt = expf(m[pr] - mx);
      wl = wt * l[pr];
    }
    denom += warp_sum(wl);
    const int n = min(32, n_splits - s0);
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
      const float wi = __shfl_sync(0xffffffffu, wt, i);
      float a[EPT];
      VecLoad<float, EPT>::run(
          acc + ((part0 + s0 + i) * rows + row) * DH + lane * EPT, a);
#pragma unroll
      for (int e = 0; e < EPT; ++e) o[e] = fmaf(wi, a[e], o[e]);
    }
  }
  // splits past a row's keys carry (m = -1e30, l = 0, acc = 0) and drop
  // out; a row with no key anywhere comes out as 0 / 1e-30 = 0
  denom = fmaxf(denom, 1e-30f);
  const int b = bh / n_kv, h = bh % n_kv;
  const int s = row / group, hq = h * group + row % group;
  T* dst = out + ((size_t(b) * S + s) * H + hq) * DH + lane * EPT;
#pragma unroll
  for (int e = 0; e < EPT; ++e) dst[e] = from_f32<T>(o[e] / denom);
}

template <typename T, typename TK, int DH>
static void launch_decode_rt(int RT, dim3 grid, cudaStream_t st,
                             const void* q, const void* pk, const void* pv,
                             const float* ks, const float* vs,
                             const int* table, const int* lengths,
                             float* acc, float* m, float* l, int S, int H,
                             int n_kv, int page, int max_pages, int n_pages,
                             int n_splits, float sm_scale) {
  const dim3 block(kDecodeWarps * 32);
#define TOS_DECODE(R)                                                      \
  paged_decode_kernel<T, TK, DH, R><<<grid, block, 0, st>>>(               \
      static_cast<const T*>(q), static_cast<const TK*>(pk),                \
      static_cast<const TK*>(pv), ks, vs, table, lengths, acc, m, l, S, H, \
      n_kv, page, max_pages, n_pages, n_splits, sm_scale)
  switch (RT) {
    case 1: TOS_DECODE(1); break;
    case 2: TOS_DECODE(2); break;
    default: TOS_DECODE(4); break;
  }
#undef TOS_DECODE
}

template <typename T, typename TK>
static int launch_decode(int Dh, int RT, dim3 grid, cudaStream_t st,
                         const void* q, const void* pk, const void* pv,
                         const float* ks, const float* vs, const int* table,
                         const int* lengths, float* acc, float* m, float* l,
                         int S, int H, int n_kv, int page, int max_pages,
                         int n_pages, int n_splits, float sm_scale) {
  if (Dh == 128)
    launch_decode_rt<T, TK, 128>(RT, grid, st, q, pk, pv, ks, vs, table,
                                 lengths, acc, m, l, S, H, n_kv, page,
                                 max_pages, n_pages, n_splits, sm_scale);
  else if (Dh == 64)
    launch_decode_rt<T, TK, 64>(RT, grid, st, q, pk, pv, ks, vs, table,
                                lengths, acc, m, l, S, H, n_kv, page,
                                max_pages, n_pages, n_splits, sm_scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_combine(int Dh, int n_rows, cudaStream_t st,
                          const float* acc, const float* m, const float* l,
                          void* out, int S, int H, int n_kv, int n_splits) {
  const dim3 grid((n_rows + 3) / 4);
  if (Dh == 128)
    paged_decode_combine_kernel<T, 128><<<grid, 128, 0, st>>>(
        acc, m, l, static_cast<T*>(out), S, H, n_kv, n_splits, n_rows);
  else if (Dh == 64)
    paged_decode_combine_kernel<T, 64><<<grid, 128, 0, st>>>(
        acc, m, l, static_cast<T*>(out), S, H, n_kv, n_splits, n_rows);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tos

// The split partials: acc [B, n_kv, n_splits, S * group, Dh], m and l
// [B, n_kv, n_splits, S * group], f32.  kv_dtype: the pool's storage
// code, q's dtype or kI8 (then ks / vs are the [NP, page, n_kv] f32
// scale pools; otherwise they are unused).
extern "C" int tos_paged_decode(const void* q, const void* pk, const void* pv,
                                const float* ks, const float* vs,
                                const int* table, const int* lengths,
                                float* acc, float* m, float* l, int B, int S,
                                int H, int n_kv, int Dh, int page,
                                int max_pages, int n_pages, int n_splits,
                                float sm_scale, int dtype, int kv_dtype,
                                void* stream) {
  using namespace tos;
  const int rows = S * (H / n_kv);
  const int RT = decode_row_tile(rows);
  const int n_rt = (rows + RT - 1) / RT;
  const dim3 grid(n_splits, n_kv * n_rt, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TOS_ARGS                                                             \
  Dh, RT, grid, st, q, pk, pv, ks, vs, table, lengths, acc, m, l, S, H,     \
      n_kv, page, max_pages, n_pages, n_splits, sm_scale
  if (dtype == kBF16 && kv_dtype == kBF16)
    return launch_decode<__nv_bfloat16, __nv_bfloat16>(TOS_ARGS);
  if (dtype == kBF16 && kv_dtype == kI8)
    return launch_decode<__nv_bfloat16, int8_t>(TOS_ARGS);
  if (dtype == kF32 && kv_dtype == kF32)
    return launch_decode<float, float>(TOS_ARGS);
  if (dtype == kF32 && kv_dtype == kI8)
    return launch_decode<float, int8_t>(TOS_ARGS);
#undef TOS_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// The splits' partials merged into out [B, S, H, Dh] in `dtype`.
extern "C" int tos_paged_decode_combine(const float* acc, const float* m,
                                        const float* l, void* out, int B,
                                        int S, int H, int n_kv, int Dh,
                                        int n_splits, int dtype,
                                        void* stream) {
  using namespace tos;
  const int n_rows = B * S * H;   // B * n_kv * (S * group)
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_combine<__nv_bfloat16>(Dh, n_rows, st, acc, m, l, out, S,
                                         H, n_kv, n_splits);
  if (dtype == kF32)
    return launch_combine<float>(Dh, n_rows, st, acc, m, l, out, S, H, n_kv,
                                 n_splits);
  return static_cast<int>(cudaErrorInvalidValue);
}
