// Paged flash-decode attention over the in-place kv pool.
//
// Replaces the TPU kernel tensorflowonspark_tpu/ops/paged_attention.py
// `_decode_kernel` (reached through `paged_attention`).  Same contract:
// q [B, S, H, Dh] against pools [NP, page, n_kv, Dh] through
// page_table [B, max_pages] and lengths [B]; query s of row b sees key j
// iff j <= lengths[b] - S + s; only the row's occupied pages are read;
// the GQA group of one kv head is handled inside the block; each split
// of the page axis writes an unnormalised partial (acc, m, l) that the
// wrapper merges with a log-sum-exp combine (rows with lengths == 0 come
// out as exact zeros there).
//
// What bounds it on the card: bytes.  A decode step reads every occupied
// k and v row once (FLAGSHIP_DECODE: 16 rows x 2000 tokens x 8 kv heads
// x 128 x 2 B x 2 = 131 MB per layer, 39 us at 3.35 TB/s) and does ~2
// FLOP per byte, far under the card's ~295 FLOP/byte ridge.
//
// Design against that bound: one block per (split, kv head, row tile,
// batch row) gives B * n_kv * splits blocks (1024 at FLAGSHIP_DECODE) so
// all 132 SMs have loads in flight.  Each of the block's 4 warps walks
// every 4th token of the split; a lane owns Dh/32 contiguous elements of
// the token's k and v rows, so one token costs the warp one coalesced
// 256-byte read of k and one of v (bf16, Dh 128) and no shared memory.
// The page table is read in the kernel (the TPU version prefetches it as
// scalars).  q rows, the online-softmax state and the accumulator live
// in registers, f32 throughout; the 4 warps' partial states merge in
// shared memory at the end.  Pages at or past the row's length are never
// touched.
//
// int8 kv pools (the JAX kernel's `quant` branch): the same walk over int8
// payloads with f32 per-(token, head) scales in their canonical
// [NP, page, n_kv] layout, read in place (stride n_kv; the TPU wrapper's
// transposed scale copy exists for its lane tiling only).  Each value is
// cast to f32 and multiplied by its token's scale in f32 before the dot
// product and the P @ V update, as `_decode_kernel` dequantises; nothing
// rounds through bf16.  A lane still owns Dh/32 contiguous values, so a
// warp reads a 128-byte int8 row (Dh 128) in one 4-byte load per lane
// plus one broadcast scale load.  Bound: bytes, half the bf16 pool's
// plus 8 B of scales per (token, head): FLAGSHIP_DECODE reads 67.6 MB per
// layer, 20 us at 3.35 TB/s.
#include <type_traits>

#include "common.cuh"

namespace tos {

constexpr int kDecodeWarps = 4;

// T: q's type; TK: the pool's storage type (T, or int8_t with scales).
template <typename T, typename TK, int EPT, int RT>
__global__ void __launch_bounds__(kDecodeWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const TK* __restrict__ pk,
                    const TK* __restrict__ pv, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths,
                    float* __restrict__ acc_out, float* __restrict__ m_out,
                    float* __restrict__ l_out, int S, int H, int n_kv,
                    int page, int max_pages, int n_pages, int n_splits,
                    int n_per, float sm_scale) {
  constexpr int DH = 32 * EPT;
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

  const int n_tok = lengths[b];
  const int n_vis = min(n_tok, max_pages * page);  // keys the table maps
  const int t_begin = sp * n_per * page;
  const int t_end = min(t_begin + n_per * page, n_vis);

  float qr[RT][EPT];
  int lim[RT];  // last visible key of each grouped row
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = r0 + r;
    if (row < rows) {
      const int s = row / group;
      const int hq = h * group + row % group;
      VecLoad<T, EPT>::run(q + ((size_t(b) * S + s) * H + hq) * DH +
                               lane * EPT, qr[r]);
      lim[r] = n_tok - S + s;
    } else {
#pragma unroll
      for (int e = 0; e < EPT; ++e) qr[r][e] = 0.f;
      lim[r] = -1;
    }
  }

  float m[RT], l[RT], acc[RT][EPT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[r][e] = 0.f;
  }

  const int* row_table = table + size_t(b) * max_pages;
  for (int t = t_begin + warp; t < t_end; t += kDecodeWarps) {
    // out-of-range table entries clamp into the pool, as a JAX gather
    // clips them
    const int phys = min(max(row_table[t / page], 0), n_pages - 1);
    const size_t row = (size_t(phys) * page + t % page) * n_kv + h;
    const size_t off = row * DH + lane * EPT;
    float kf[EPT], vf[EPT];
    VecLoad<TK, EPT>::run(pk + off, kf);
    VecLoad<TK, EPT>::run(pv + off, vf);
    if constexpr (std::is_same<TK, int8_t>::value) {
      const float sk = ks[row];
      const float sv = vs[row];
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        kf[e] *= sk;
        vf[e] *= sv;
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < EPT; ++e) d = fmaf(qr[r][e], kf[e], d);
      d = warp_sum(d);
      const float s = (t <= lim[r]) ? d * sm_scale : NEG_INF;
      const float mn = fmaxf(m[r], s);
      const float alpha = expf(m[r] - mn);
      const float p = expf(s - mn);
      l[r] = l[r] * alpha + p;
#pragma unroll
      for (int e = 0; e < EPT; ++e) acc[r][e] = fmaf(acc[r][e], alpha, p * vf[e]);
      m[r] = mn;
    }
  }

  // merge the warps' partial states: weights exp(m_w - M)
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < EPT; ++e) sm_acc[warp][r][lane * EPT + e] = acc[r][e];
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

template <typename T, typename TK, int EPT>
static void launch_decode_rt(int RT, dim3 grid, cudaStream_t st,
                             const void* q, const void* pk, const void* pv,
                             const float* ks, const float* vs,
                             const int* table, const int* lengths,
                             float* acc, float* m, float* l, int S, int H,
                             int n_kv, int page, int max_pages, int n_pages,
                             int n_splits, int n_per, float sm_scale) {
  const dim3 block(kDecodeWarps * 32);
#define TOS_DECODE(R)                                                      \
  paged_decode_kernel<T, TK, EPT, R><<<grid, block, 0, st>>>(              \
      static_cast<const T*>(q), static_cast<const TK*>(pk),                \
      static_cast<const TK*>(pv), ks, vs, table, lengths, acc, m, l, S, H, \
      n_kv, page, max_pages, n_pages, n_splits, n_per, sm_scale)
  switch (RT) {
    case 1: TOS_DECODE(1); break;
    case 2: TOS_DECODE(2); break;
    case 4: TOS_DECODE(4); break;
    default: TOS_DECODE(8); break;
  }
#undef TOS_DECODE
}

template <typename T, typename TK>
static int launch_decode(int Dh, int RT, dim3 grid, cudaStream_t st,
                         const void* q, const void* pk, const void* pv,
                         const float* ks, const float* vs, const int* table,
                         const int* lengths, float* acc, float* m, float* l,
                         int S, int H, int n_kv, int page, int max_pages,
                         int n_pages, int n_splits, int n_per,
                         float sm_scale) {
  if (Dh == 128)
    launch_decode_rt<T, TK, 4>(RT, grid, st, q, pk, pv, ks, vs, table,
                               lengths, acc, m, l, S, H, n_kv, page,
                               max_pages, n_pages, n_splits, n_per, sm_scale);
  else if (Dh == 64)
    launch_decode_rt<T, TK, 2>(RT, grid, st, q, pk, pv, ks, vs, table,
                               lengths, acc, m, l, S, H, n_kv, page,
                               max_pages, n_pages, n_splits, n_per, sm_scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Grouped query rows per block: the smallest of 1, 2, 4, 8 that holds
// S * group, tiled by 8 beyond that.
static int decode_row_tile(int rows) {
  return rows <= 1 ? 1 : rows <= 2 ? 2 : rows <= 4 ? 4 : 8;
}

}  // namespace tos

// kv_dtype: the pool's storage code, q's dtype or kI8 (then ks / vs are
// the [NP, page, n_kv] f32 scale pools; otherwise they are unused).
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
  const int n_per = max_pages / n_splits;
  const dim3 grid(n_splits, n_kv * n_rt, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TOS_ARGS                                                             \
  Dh, RT, grid, st, q, pk, pv, ks, vs, table, lengths, acc, m, l, S, H,     \
      n_kv, page, max_pages, n_pages, n_splits, n_per, sm_scale
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
