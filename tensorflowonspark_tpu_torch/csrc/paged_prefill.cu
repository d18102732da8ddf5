// Paged prefill: the in-place page write and the chunked flash read.
//
// Replaces the two TPU kernels of tensorflowonspark_tpu/ops/
// paged_prefill.py: `_page_write_kernel` (reached through `_write_pages`)
// and `_prefill_read_kernel` (reached through `_read_attention`), which
// `paged_prefill` runs back to back for every S > 1 prefill chunk.
//
// Page write.  Chunk position s of row b lands at
// pool[table[b, clip((start + s) // page, 0, max_pages - 1)],
// (start + s) % page] -- the same clip as the TPU kernel, so bucket-pad
// overshoot and the all-sink tables of pad rows land in the sink page.
// The pool is updated in place (the TPU kernel aliases it in and out).
// Two rows that both write the sink race here where the TPU kernel sums;
// sink bytes are garbage by contract and masked on every read.
// Bound: bytes, nothing else (FLAGSHIP_PREFILL_KERNEL: 4 rows x 256 x
// 8 x 128 x 2 B, read once and written once for k and v: 8.4 MB per
// layer, 2.5 us at 3.35 TB/s).  Design: one block per (s, b) copies the
// n_kv * Dh row of k and of v with 16-byte vector moves; no arithmetic.
//
// Prefill read.  Online softmax of the chunk's queries over
// [context pages < start || the chunk's own k/v], the chunk part under
// the causal triangle jc <= s.  Bound: operations (FLAGSHIP_PREFILL_
// KERNEL: 18.9 GFLOP per layer, 19 us at the bf16 tensor-core peak, 0.28
// ms at the 67 TFLOP/s f32 rate of the CUDA cores; its 33 MB of context
// would take 9.8 us).
//
// bf16 pools: `prefill_read_mma_kernel`, on the tensor cores.  One block
// of 4 warps per (64-row tile of grouped queries, kv head, batch row);
// row r of the tile is query position r / group and GQA member r %
// group, so each kv head's context is read once per 64-row tile.  The
// block stages its Q rows and 64-key K / V tiles in shared memory with
// 16-byte `cp.async` copies (two stages), first the context tiles, each
// 16-byte chunk of key row j through its own page-table entry (clipped
// to the pool, as below; the page size need not match the tile), then
// the chunk's own strided k / v, and each warp runs the shared tile loop
// of mma.cuh (`AttnWarp`: `mma.sync.m16n8k16`, online softmax in
// registers, P rounded to bf16 before P V).  Masks: context keys j <
// n_ctx = min(start, max_pages * page); chunk keys jc <= r / group;
// chunk tiles past the tile's last query position are skipped.  The
// longest tiles (the last rows) are scheduled first.  Left to later
// work: `wgmma`, TMA and warp specialisation.
//
// f32 and int8 pools: `prefill_read_kernel`, in f32 on the CUDA cores,
// far from the bound.  Design: one block per (64-row tile of grouped
// queries, kv head, batch row), 256 threads.
// The block keeps its q tile in shared memory, streams 32-key tiles of
// k and v through shared memory (context pages looked up in the table,
// then the chunk), and each thread holds 4 query rows x (2 scores,
// Dh/16 output columns) of f32 state.  A block reads the row's context
// once, so the context is read once per 64-row tile: ceil(S * group /
// 64) times in all (8 at FLAGSHIP_PREFILL_KERNEL).
//
// int8 kv pools (the JAX kernels' `quant` branch).  The page write takes
// the chunk in its activation dtype and fuses the JAX wrapper's
// `_quantize` into the store: one warp per (token, kv head) reduces the
// amax over Dh, then scale = max(amax, 1e-12) / 127 and q = clip(rint(x /
// scale), -127, 127), with IEEE division and round-half-to-even, so the
// bytes equal `_kv_quantize`'s.  It stores the int8 row and the scale (in
// the canonical [NP, page, n_kv] scale pool, under the same clip and
// dropped out-of-range store) and also writes the chunk dequantised and
// rounded to the activation dtype, which is what the read's chunk part
// attends to (JAX `_dequantize(k_st, k_sc, k.dtype)`).  Bound: bytes
// (FLAGSHIP_PREFILL_KERNEL: the bf16 chunk read once, the dequantised
// bf16 chunk written once, int8 payload and f32 scales stored: 10.55 MB
// per layer, 3.1 us).  The decode step's one-token write of an int8 pool
// runs the same kernel (S = 1).  The read dequantises each context value
// in f32 (payload x its token's scale) as it fills the shared-memory key
// and value tiles, as `_prefill_read_kernel` does; the chunk part is
// unchanged.
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace tos {

__global__ void __launch_bounds__(128)
page_write_kernel(const uint8_t* __restrict__ k, const uint8_t* __restrict__ v,
                  uint8_t* __restrict__ pk, uint8_t* __restrict__ pv,
                  const int* __restrict__ table,
                  const int* __restrict__ starts, int S, int row_bytes,
                  int page, int max_pages, int n_pages) {
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int pos = starts[b] + s;
  const int blk = min(max(pos / page, 0), max_pages - 1);
  const int phys = table[size_t(b) * max_pages + blk];
  // an out-of-range page drops the store, as a JAX scatter drops it
  if (phys < 0 || phys >= n_pages) return;
  const size_t dst = (size_t(phys) * page + pos % page) * row_bytes;
  const size_t src = (size_t(b) * S + s) * row_bytes;
  if (row_bytes % 16 == 0) {
    const int n = row_bytes / 16;
    const uint4* ks = reinterpret_cast<const uint4*>(k + src);
    const uint4* vs = reinterpret_cast<const uint4*>(v + src);
    uint4* kd = reinterpret_cast<uint4*>(pk + dst);
    uint4* vd = reinterpret_cast<uint4*>(pv + dst);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      kd[i] = ks[i];
      vd[i] = vs[i];
    }
  } else {
    for (int i = threadIdx.x; i < row_bytes; i += blockDim.x) {
      pk[dst + i] = k[src + i];
      pv[dst + i] = v[src + i];
    }
  }
}

// One kv row (one token, one head) of the chunk: quantise, store payload
// and scale (when the page is in range), write the dequantised row.
template <typename T, int EPT>
__device__ __forceinline__ void quantize_row(const T* __restrict__ x,
                                             int8_t* __restrict__ dst,
                                             float* __restrict__ scale_dst,
                                             T* __restrict__ deq, int lane) {
  float xf[EPT];
  VecLoad<T, EPT>::run(x + lane * EPT, xf);
  float amax = 0.f;
#pragma unroll
  for (int e = 0; e < EPT; ++e) amax = fmaxf(amax, fabsf(xf[e]));
  amax = warp_max(amax);
  const float scale = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
  int8_t q8[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const float r = rintf(__fdiv_rn(xf[e], scale));
    q8[e] = static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
    deq[lane * EPT + e] =
        from_f32<T>(__fmul_rn(static_cast<float>(q8[e]), scale));
  }
  if (dst != nullptr) {
#pragma unroll
    for (int e = 0; e < EPT; ++e) dst[lane * EPT + e] = q8[e];
    if (lane == 0) *scale_dst = scale;
  }
}

template <typename T, int EPT>
__global__ void __launch_bounds__(256)
page_write_int8_kernel(const T* __restrict__ k, const T* __restrict__ v,
                       int8_t* __restrict__ pk, int8_t* __restrict__ pv,
                       float* __restrict__ ks, float* __restrict__ vs,
                       T* __restrict__ ck, T* __restrict__ cv,
                       const int* __restrict__ table,
                       const int* __restrict__ starts, int S, int n_kv,
                       int page, int max_pages, int n_pages) {
  constexpr int DH = 32 * EPT;
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int pos = starts[b] + s;
  const int blk = min(max(pos / page, 0), max_pages - 1);
  const int phys = table[size_t(b) * max_pages + blk];
  // an out-of-range page drops the store (a JAX scatter drops it); the
  // dequantised chunk row is written either way
  const bool keep = phys >= 0 && phys < n_pages;
  for (int h = threadIdx.x >> 5; h < n_kv; h += blockDim.x >> 5) {
    const size_t src = ((size_t(b) * S + s) * n_kv + h) * DH;
    const size_t row =
        (size_t(keep ? phys : 0) * page + pos % page) * n_kv + h;
    quantize_row<T, EPT>(k + src, keep ? pk + row * DH : nullptr, ks + row,
                         ck + src, lane);
    quantize_row<T, EPT>(v + src, keep ? pv + row * DH : nullptr, vs + row,
                         cv + src, lane);
  }
}

constexpr int kBR = 64;   // grouped query rows per block
constexpr int kBC = 32;   // keys per shared-memory tile
constexpr int kNT = 256;  // threads: 16 (tx) x 16 (ty)

template <int DH>
constexpr int prefill_smem_bytes() {
  return ((kBR + 2 * kBC) * (DH + 1) + kBR * (kBC + 1)) * 4;
}

// One key tile: scores, online-softmax update, P @ V.  `visible(row, j)`
// says whether grouped row `row` sees tile key `j`.
template <int DH, typename Vis>
__device__ __forceinline__ void prefill_tile(
    const float* Qs, const float* Ks, const float* Vs, float* Ps, int tx,
    int ty, int r0, int j0, float sm_scale, Vis visible, float (&m)[4],
    float (&l)[4], float (&acc)[4][DH / 16]) {
  constexpr int DP = DH + 1;
  constexpr int CPT = DH / 16;
  float sc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * DP + d];
    const float k0 = Ks[tx * DP + d];
    const float k1 = Ks[(tx + 16) * DP + d];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sc[i][0] = fmaf(a[i], k0, sc[i][0]);
      sc[i][1] = fmaf(a[i], k1, sc[i][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    const float s0 = visible(row, j0 + tx) ? sc[i][0] * sm_scale : NEG_INF;
    const float s1 = visible(row, j0 + tx + 16) ? sc[i][1] * sm_scale
                                                : NEG_INF;
    const float mn = fmaxf(m[i], half_warp_max(fmaxf(s0, s1)));
    const float alpha = expf(m[i] - mn);
    const float p0 = expf(s0 - mn);
    const float p1 = expf(s1 - mn);
    l[i] = l[i] * alpha + half_warp_sum(p0 + p1);
    m[i] = mn;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    Ps[(ty * 4 + i) * (kBC + 1) + tx] = p0;
    Ps[(ty * 4 + i) * (kBC + 1) + tx + 16] = p1;
  }
  __syncthreads();
#pragma unroll 4
  for (int c = 0; c < kBC; ++c) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * (kBC + 1) + c];
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const float vv = Vs[c * DP + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(p[i], vv, acc[i][cc]);
    }
  }
  __syncthreads();
}

// T: q's and the chunk's type; TK: the pool's storage type (T, or int8_t
// with the f32 scale pools ks / vs).
template <typename T, typename TK, int DH>
__global__ void __launch_bounds__(kNT)
prefill_read_kernel(const T* __restrict__ q, const T* __restrict__ ck,
                    const T* __restrict__ cv, const TK* __restrict__ pk,
                    const TK* __restrict__ pv, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ table,
                    const int* __restrict__ starts, T* __restrict__ out,
                    int S, int H, int n_kv, int page, int max_pages,
                    int n_pages, float sm_scale) {
  constexpr int DP = DH + 1;
  constexpr int CPT = DH / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // [kBR][DP]
  float* Ks = Qs + kBR * DP;     // [kBC][DP]
  float* Vs = Ks + kBC * DP;     // [kBC][DP]
  float* Ps = Vs + kBC * DP;     // [kBR][kBC + 1]

  const int r0 = blockIdx.x * kBR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / n_kv;
  const int rows = S * group;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int n_ctx = min(starts[b], max_pages * page);

  for (int i = tid; i < kBR * DH; i += kNT) {
    const int r = i / DH;
    const int d = i % DH;
    const int row = r0 + r;
    float val = 0.f;
    if (row < rows) {
      const int s = row / group;
      const int hq = h * group + row % group;
      val = to_f32(q[((size_t(b) * S + s) * H + hq) * DH + d]);
    }
    Qs[r * DP + d] = val;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // context: every chunk query sits at or past `start`, so all keys
  // j < start are visible
  const int* row_table = table + size_t(b) * max_pages;
  for (int j0 = 0; j0 < n_ctx; j0 += kBC) {
    for (int i = tid; i < kBC * DH; i += kNT) {
      const int c = i / DH;
      const int d = i % DH;
      const int j = j0 + c;
      float kv = 0.f, vv = 0.f;
      if (j < n_ctx) {
        const int phys = min(max(row_table[j / page], 0), n_pages - 1);
        const size_t row = (size_t(phys) * page + j % page) * n_kv + h;
        kv = to_f32(pk[row * DH + d]);
        vv = to_f32(pv[row * DH + d]);
        if constexpr (std::is_same<TK, int8_t>::value) {
          kv *= ks[row];
          vv *= vs[row];
        }
      }
      Ks[c * DP + d] = kv;
      Vs[c * DP + d] = vv;
    }
    __syncthreads();
    prefill_tile<DH>(Qs, Ks, Vs, Ps, tx, ty, r0, j0, sm_scale,
                     [n_ctx](int, int j) { return j < n_ctx; }, m, l, acc);
  }

  // the chunk's own keys under the causal triangle jc <= s; tiles past
  // the tile's last query position are skipped
  const int last_row = min(rows, r0 + kBR) - 1;
  const int n_ck = min(S, last_row / group + 1);
  for (int j0 = 0; j0 < n_ck; j0 += kBC) {
    for (int i = tid; i < kBC * DH; i += kNT) {
      const int c = i / DH;
      const int d = i % DH;
      const int j = j0 + c;
      float kv = 0.f, vv = 0.f;
      if (j < S) {
        const size_t src = ((size_t(b) * S + j) * n_kv + h) * DH + d;
        kv = to_f32(ck[src]);
        vv = to_f32(cv[src]);
      }
      Ks[c * DP + d] = kv;
      Vs[c * DP + d] = vv;
    }
    __syncthreads();
    prefill_tile<DH>(
        Qs, Ks, Vs, Ps, tx, ty, r0, j0, sm_scale,
        [S, group](int row, int j) { return j < S && j <= row / group; }, m,
        l, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= rows) continue;
    const int s = row / group;
    const int hq = h * group + row % group;
    T* dst = out + ((size_t(b) * S + s) * H + hq) * DH;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      dst[tx + 16 * c] = from_f32<T>(acc[i][c] * inv);
  }
}

// The bf16-pool read on the tensor cores (see the header): q / out [B,
// S, H, D], ck / cv [B, S, n_kv, D], pools pk / pv [n_pages, page, n_kv,
// D], all bf16.
template <int D>
__global__ void __launch_bounds__(kAttnThreads, 2)
prefill_read_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ ck,
                        const __nv_bfloat16* __restrict__ cv,
                        const __nv_bfloat16* __restrict__ pk,
                        const __nv_bfloat16* __restrict__ pv,
                        const int* __restrict__ table,
                        const int* __restrict__ starts,
                        __nv_bfloat16* __restrict__ out, int S, int H,
                        int n_kv, int page, int max_pages, int n_pages,
                        float sm_scale) {
  using Sm = AttnSmem<D>;
  constexpr int LD = Sm::LD, CH = Sm::CHUNKS;
  extern __shared__ __align__(16) unsigned char attn_smem[];
  const unsigned base = smem_u32(attn_smem);

  const int r0 = (gridDim.x - 1 - blockIdx.x) * kAttnRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / n_kv;
  const int rows = S * group;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_ctx = min(starts[b], max_pages * page);
  const int* row_table = table + size_t(b) * max_pages;

  // grouped query row r0 + r -> q[b, r / group, h * group + r % group]
  auto q_row = [&](int row) {
    return (size_t(b) * S + row / group) * H + h * group + row % group;
  };
#pragma unroll
  for (int i = tid; i < kAttnRows * CH; i += kAttnThreads) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < rows;
    cp_async16(base + Sm::Q + (r * LD + c * 8) * 2,
               ok ? q + q_row(r0 + r) * D + c * 8 : q, ok);
  }
  cp_async_commit();

  // context tiles first (every chunk query sits at or past `start`, so
  // all keys j < n_ctx are visible), then the chunk's own keys up to the
  // tile's last query position
  const int n_ctx_t = (n_ctx + kAttnKeys - 1) / kAttnKeys;
  const int n_ck = min(S, (min(rows, r0 + kAttnRows) - 1) / group + 1);
  const int n_t = n_ctx_t + (n_ck + kAttnKeys - 1) / kAttnKeys;
  auto stage_tile = [&](int t, int st) {
    const unsigned kd = base + Sm::K(st), vd = base + Sm::V(st);
    if (t < n_ctx_t) {
      const int j0 = t * kAttnKeys;
#pragma unroll
      for (int i = tid; i < kAttnKeys * CH; i += kAttnThreads) {
        const int r = i / CH, c = i % CH;
        const int j = j0 + r;
        const bool ok = j < n_ctx;
        size_t src = 0;
        if (ok) {
          const int phys = min(max(row_table[j / page], 0), n_pages - 1);
          src = ((size_t(phys) * page + j % page) * n_kv + h) * D + c * 8;
        }
        const unsigned off = (r * LD + c * 8) * 2;
        cp_async16(kd + off, pk + src, ok);
        cp_async16(vd + off, pv + src, ok);
      }
    } else {
      const int j0 = (t - n_ctx_t) * kAttnKeys;
#pragma unroll
      for (int i = tid; i < kAttnKeys * CH; i += kAttnThreads) {
        const int r = i / CH, c = i % CH;
        const int j = j0 + r;
        const bool ok = j < S;
        const size_t src =
            ok ? ((size_t(b) * S + j) * n_kv + h) * D + c * 8 : 0;
        const unsigned off = (r * LD + c * 8) * 2;
        cp_async16(kd + off, ck + src, ok);
        cp_async16(vd + off, cv + src, ok);
      }
    }
  };
  // the lane's two fragment rows, and the chunk keys they see (jc <= s)
  const int row0 = r0 + warp * 16 + (lane >> 2);
  const int ck_lim0 = min(S, row0 / group + 1);
  const int ck_lim1 = min(S, (row0 + 8) / group + 1);
  AttnWarp<D> w;
  w.run(base, n_t, sm_scale * kLog2e, stage_tile,
        [&](int t, int (&lim)[2]) {
          if (t < n_ctx_t) {
            lim[0] = lim[1] = n_ctx - t * kAttnKeys;
          } else {
            const int j0 = (t - n_ctx_t) * kAttnKeys;
            lim[0] = ck_lim0 - j0;
            lim[1] = ck_lim1 - j0;
          }
        });

  float row_lse[2];
  w.store(attn_smem, row_lse, [&](int r) -> __nv_bfloat16* {
    const int row = r0 + warp * 16 + r;
    return row < rows ? out + q_row(row) * D : nullptr;
  });
}

template <int D>
static int launch_prefill_read_mma(dim3 grid, cudaStream_t st,
                                   const void* q, const void* ck,
                                   const void* cv, const void* pk,
                                   const void* pv, const int* table,
                                   const int* starts, void* out, int S,
                                   int H, int n_kv, int page, int max_pages,
                                   int n_pages, float sm_scale) {
  using BF = __nv_bfloat16;
  constexpr int smem = AttnSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      prefill_read_mma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  prefill_read_mma_kernel<D><<<grid, kAttnThreads, smem, st>>>(
      static_cast<const BF*>(q), static_cast<const BF*>(ck),
      static_cast<const BF*>(cv), static_cast<const BF*>(pk),
      static_cast<const BF*>(pv), table, starts, static_cast<BF*>(out), S, H,
      n_kv, page, max_pages, n_pages, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TK, int DH>
static int launch_prefill_read(dim3 grid, cudaStream_t st, const void* q,
                               const void* ck, const void* cv, const void* pk,
                               const void* pv, const float* ks,
                               const float* vs, const int* table,
                               const int* starts, void* out, int S, int H,
                               int n_kv, int page, int max_pages, int n_pages,
                               float sm_scale) {
  constexpr int smem = prefill_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      prefill_read_kernel<T, TK, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  prefill_read_kernel<T, TK, DH><<<grid, kNT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(ck),
      static_cast<const T*>(cv), static_cast<const TK*>(pk),
      static_cast<const TK*>(pv), ks, vs, table, starts, static_cast<T*>(out),
      S, H, n_kv, page, max_pages, n_pages, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TK>
static int launch_prefill_read_dh(int Dh, dim3 grid, cudaStream_t st,
                                  const void* q, const void* ck,
                                  const void* cv, const void* pk,
                                  const void* pv, const float* ks,
                                  const float* vs, const int* table,
                                  const int* starts, void* out, int S, int H,
                                  int n_kv, int page, int max_pages,
                                  int n_pages, float sm_scale) {
  if (Dh == 128)
    return launch_prefill_read<T, TK, 128>(grid, st, q, ck, cv, pk, pv, ks,
                                           vs, table, starts, out, S, H,
                                           n_kv, page, max_pages, n_pages,
                                           sm_scale);
  if (Dh == 64)
    return launch_prefill_read<T, TK, 64>(grid, st, q, ck, cv, pk, pv, ks,
                                          vs, table, starts, out, S, H, n_kv,
                                          page, max_pages, n_pages, sm_scale);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
static int launch_page_write_int8(int Dh, dim3 grid, cudaStream_t st,
                                  const void* k, const void* v, void* pk,
                                  void* pv, float* ks, float* vs, void* ck,
                                  void* cv, const int* table,
                                  const int* starts, int S, int n_kv,
                                  int page, int max_pages, int n_pages) {
#define TOS_WRITE8(EPT)                                                     \
  page_write_int8_kernel<T, EPT><<<grid, 256, 0, st>>>(                     \
      static_cast<const T*>(k), static_cast<const T*>(v),                   \
      static_cast<int8_t*>(pk), static_cast<int8_t*>(pv), ks, vs,           \
      static_cast<T*>(ck), static_cast<T*>(cv), table, starts, S, n_kv,     \
      page, max_pages, n_pages)
  if (Dh == 128)
    TOS_WRITE8(4);
  else if (Dh == 64)
    TOS_WRITE8(2);
  else
    return static_cast<int>(cudaErrorInvalidValue);
#undef TOS_WRITE8
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tos

extern "C" int tos_page_write(const void* k, const void* v, void* pk,
                              void* pv, const int* table, const int* starts,
                              int B, int S, int row_bytes, int page,
                              int max_pages, int n_pages, void* stream) {
  using namespace tos;
  const dim3 grid(S, B);
  page_write_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(k), static_cast<const uint8_t*>(v),
      static_cast<uint8_t*>(pk), static_cast<uint8_t*>(pv), table, starts, S,
      row_bytes, page, max_pages, n_pages);
  return static_cast<int>(cudaGetLastError());
}

// The page write of an int8 pool: k / v [B, S, n_kv, Dh] in `dtype`,
// payload pools pk / pv int8, scale pools ks / vs f32 [NP, page, n_kv],
// ck / cv [B, S, n_kv, Dh] in `dtype` receive the dequantised chunk.
extern "C" int tos_page_write_int8(const void* k, const void* v, void* pk,
                                   void* pv, float* ks, float* vs, void* ck,
                                   void* cv, const int* table,
                                   const int* starts, int B, int S, int n_kv,
                                   int Dh, int page, int max_pages,
                                   int n_pages, int dtype, void* stream) {
  using namespace tos;
  const dim3 grid(S, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch_page_write_int8<__nv_bfloat16>(
        Dh, grid, st, k, v, pk, pv, ks, vs, ck, cv, table, starts, S, n_kv,
        page, max_pages, n_pages);
  if (dtype == kF32)
    return launch_page_write_int8<float>(Dh, grid, st, k, v, pk, pv, ks, vs,
                                         ck, cv, table, starts, S, n_kv,
                                         page, max_pages, n_pages);
  return static_cast<int>(cudaErrorInvalidValue);
}

// kv_dtype: the pool's storage code, q's dtype or kI8 (then ks / vs are
// the f32 scale pools; otherwise they are unused).
extern "C" int tos_prefill_read(const void* q, const void* ck, const void* cv,
                                const void* pk, const void* pv,
                                const float* ks, const float* vs,
                                const int* table, const int* starts, void* out,
                                int B, int S, int H, int n_kv, int Dh,
                                int page, int max_pages, int n_pages,
                                float sm_scale, int dtype, int kv_dtype,
                                void* stream) {
  using namespace tos;
  const int rows = S * (H / n_kv);
  const dim3 grid((rows + kBR - 1) / kBR, n_kv, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TOS_ARGS                                                          \
  Dh, grid, st, q, ck, cv, pk, pv, ks, vs, table, starts, out, S, H, n_kv, \
      page, max_pages, n_pages, sm_scale
  if (dtype == kBF16 && kv_dtype == kBF16) {
    // bf16 pools: the tensor cores
    if (Dh == 128)
      return launch_prefill_read_mma<128>(grid, st, q, ck, cv, pk, pv, table,
                                          starts, out, S, H, n_kv, page,
                                          max_pages, n_pages, sm_scale);
    if (Dh == 64)
      return launch_prefill_read_mma<64>(grid, st, q, ck, cv, pk, pv, table,
                                         starts, out, S, H, n_kv, page,
                                         max_pages, n_pages, sm_scale);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == kBF16 && kv_dtype == kI8)
    return launch_prefill_read_dh<__nv_bfloat16, int8_t>(TOS_ARGS);
  if (dtype == kF32 && kv_dtype == kF32)
    return launch_prefill_read_dh<float, float>(TOS_ARGS);
  if (dtype == kF32 && kv_dtype == kI8)
    return launch_prefill_read_dh<float, int8_t>(TOS_ARGS);
#undef TOS_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
