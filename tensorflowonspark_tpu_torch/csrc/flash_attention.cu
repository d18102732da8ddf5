// Flash attention: the forward with its log-sum-exp, and the blocked
// backward (dq; narrow dk/dv).
//
// Replaces the three TPU kernels of tensorflowonspark_tpu/ops/
// flash_attention.py: `_fwd_kernel` (reached through `_flash_fwd_impl`),
// `_bwd_dq_kernel` and `_bwd_dkv_kernel` (both reached through
// `_flash_bwd_impl`), which the `custom_vjp` of `flash_attention` runs.
//
// Layout.  q and dO are [B, S, H, D], k and v the narrow GQA [B, S, H_kv,
// D], read in place (no transpose, no pad copy: the ragged last tile is
// bounds-checked instead of padded).  Query head h reads kv head
// h / (H / H_kv); no repeated k/v is ever written.  lse and delta are f32
// [B, H, S].  Scores are masked with NEG_INF = -1e30 (not -inf), so exp of
// a masked score is exactly 0; rows that see no key get lse = 0, as the
// TPU kernel's sentinel.
//
// Bound: operations.  At one layer of the flagship train step (B 8, S
// 1024, H 16, H_kv 8, D 128, causal) the visible (query, key) pairs are
// V = B*H*S*(S+1)/2 = 67.2M; the forward does 4*V*D = 34 GFLOP (35 us at
// the bf16 tensor-core peak, 0.51 ms at the 67 TFLOP/s f32 rate of the
// CUDA cores), dq 6*V*D and dk/dv 8*V*D, against 17 MB of operands (5 us
// at 3.35 TB/s).
//
// Card tests of these kernels (and the paged prefill read's): python -m
// pytest --noconftest -m cuda tests/test_torch_cuda.py -k "flash or prefill"
//
// bf16 forward: `flash_fwd_mma_kernel`, on the tensor cores.  One block
// of 4 warps per (64-query tile, q head, batch row), the longest causal
// tiles (the last ones) scheduled first so they do not leave a tail
// wave.  The block stages its Q tile and 64-key K / V tiles in shared
// memory with 16-byte `cp.async` copies (two stages: tile t + 1 lands
// while tile t is multiplied; rows past S are zero-filled), and each
// warp runs the shared tile loop of mma.cuh (`AttnWarp`: S = Q K^T and
// O += P V by `mma.sync.m16n8k16`, bf16 in and f32 sums, the online
// softmax in registers, P rounded to bf16 before P V and l summed from
// the f32 p).  Causal key tiles strictly above the diagonal are skipped;
// masks apply on the diagonal tile and the ragged last one.  O / l is
// staged through the warp's Q rows and written with 16-byte stores.
// q, k and v must be 16-byte aligned (the C entry refuses others).
// Left to later work: `wgmma`, TMA and warp specialisation.
//
// bf16 backward: `flash_bwd_dq_mma_kernel` and `flash_bwd_dkv_mma_kernel`,
// on the tensor cores, built from the warp-level steps of mma.cuh
// (`mma_scores`, `c_to_a`, `mma_accumulate`, `store_rows`).  Both
// recompute p = exp2(s * scale * log2 e - lse * log2 e) (lse in natural
// log from the forward, 0 for a row that saw no key, so a masked p is 0)
// and ds = p (dp - delta) in f32 registers.
// - dq: one block of 4 warps per (64-query tile, q head, batch row), the
//   longest causal tiles first.  Q and dO are staged once and held as A
//   fragments; the lane's two rows' lse and delta in registers; 64-key
//   K / V tiles in two `cp.async` stages.  Each warp walks a tile in
//   16-key slices: S = Q K^T and dP = dO V^T (K and V as the `.col`
//   operand), ds, then dQ += dS K with dS converted to bf16 A fragments
//   in registers and K read by ldmatrix.trans.  Slices past the warp's
//   last row are skipped.  dq = scale dQ leaves through the warp's Q rows
//   in 16-byte stores.
// - dk/dv: one block of 4 warps per (64-key tile, kv head, batch row),
//   each warp 16 keys; K and V stay resident in shared memory and are
//   read as A fragments per k16 step (held in registers they would need
//   ~64 more a thread on top of the 128 of the dk and dv accumulators).
//   The block walks the group's q heads and, for each, the 64-query tiles
//   from the diagonal on, staging Q, dO and the tile's lse and delta in
//   two stages; a warp takes 32-query slices: S^T = K Q^T and dP^T = V
//   dO^T (Q and dO as `.col` operands), p^T and ds^T, then dV += P^T dO
//   and dK += dS^T Q with dO and Q by ldmatrix.trans from the same staged
//   tiles.  dk = scale dK and dv = dV are written narrow once (no
//   atomics, no repeat-then-sum).
// Where the trouble lies, and what the design does about it:
// - registers: dk + dv take 128 f32 a thread at D 128; with K / V read
//   from shared memory and 32-query slices (S^T, dP^T 32 more), both
//   kernels stay under `__launch_bounds__(128, 2)`'s 255 without spills;
// - the dk/dv mask is a window: fragment rows are keys and columns
//   queries, so query qc is visible to key row r iff lo[r] <= qc < S
//   (lo = key when causal, else 0; S for a key past S).  Zero-filled
//   queries past S read lse = delta = 0 and would give p = 1 unless
//   masked explicitly;
// - lse and delta lie along the columns in dk/dv: each lane's columns are
//   8 n + 2 (lane & 3) + {0, 1}, read from the staged [64] vectors;
// - rounding: the JAX kernels keep p and ds in f32 for their products;
//   here p is rounded to bf16 before P^T dO and ds before dS K and dS^T Q
//   (as FlashAttention-2 does), with f32 sums;
// - determinism: every output element is written once by one block and
//   summed in a fixed order, so two launches give the same bits.
// q, k, v, dO and the outputs must be 16-byte aligned.
//
// f32 (all three kernels) computes in f32 on the CUDA cores, so it sits
// far from the bound (the tensor cores have no exact f32 product).
// Design, common to the three CUDA-core kernels: 256 threads (16 x 16)
// per block.
// A block keeps one 64-row tile resident in shared memory and streams
// 32-row tiles of the other
// operand through shared memory; thread (tx, ty) owns 4 resident rows
// (ty * 4 + i) x 2 streamed rows (tx, tx + 16) of every score tile and 4
// rows x D/16 columns (tx + 16 c) of every f32 accumulator.  Causal tiles
// strictly above the diagonal are skipped, as the TPU kernels skip them.
//
// - forward: one block per (64-query tile, q head, batch row); streams
//   k/v tiles up to the diagonal with a running max, denominator and
//   accumulator (online softmax); finishes with l = max(l, 1e-30).
// - dq: one block per (64-query tile, q head, batch row); recomputes
//   p = exp(s * scale - lse), ds = p * (dO.v - delta), dq += scale ds.k.
// - dk/dv: one block per (64-key tile, kv head, batch row); loops over the
//   group's q heads, then over 32-query tiles from the diagonal on, and
//   accumulates dv += p^T.dO and dk += scale ds^T.q, written narrow once
//   (no atomics, no repeat-then-sum).
#include <initializer_list>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace tos {

constexpr int kFR = 64;    // resident rows per block
constexpr int kFC = 32;    // streamed rows per shared-memory tile
constexpr int kFNT = 256;  // threads: 16 (tx) x 16 (ty)
constexpr int kFP = kFC + 1;  // row pitch of the [kFR][kFC] score tile

// `rows` rows of head `h` from position `s0` of a [B, S, nh, D] tensor
// into a [rows][D + 1] f32 tile; rows at or past S are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          int b, int s0, int rows, int S,
                                          int nh, int h) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < rows * D; i += kFNT) {
    const int r = i / D;
    const int d = i % D;
    const int s = s0 + r;
    dst[r * DP + d] =
        s < S ? to_f32(src[((size_t(b) * S + s) * nh + h) * D + d]) : 0.f;
  }
}

// `rows` entries of a [B, H, S] f32 row vector (lse or delta) from
// position s0; entries past S are zeros.
__device__ __forceinline__ void load_vec(float* dst,
                                         const float* __restrict__ src,
                                         int bh, int s0, int rows, int S) {
  for (int i = threadIdx.x; i < rows; i += kFNT)
    dst[i] = s0 + i < S ? src[size_t(bh) * S + s0 + i] : 0.f;
}

// out[i][c] = A[ty * 4 + i] . Bt[tx + 16 c] over D, A a resident tile and
// Bt a streamed one, both [rows][D + 1].
template <int D>
__device__ __forceinline__ void tile_dots(const float* A, const float* Bt,
                                          int tx, int ty, float (&out)[4][2]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i][0] = out[i][1] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * DP + d];
    const float b0 = Bt[tx * DP + d];
    const float b1 = Bt[(tx + 16) * DP + d];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[i][0] = fmaf(a[i], b0, out[i][0]);
      out[i][1] = fmaf(a[i], b1, out[i][1]);
    }
  }
}

// acc[i][c] += sum_j P[ty * 4 + i][j] * X[j][tx + 16 c] over the kFC
// streamed rows j; P is [kFR][kFP], X [kFC][D + 1].
template <int D>
__device__ __forceinline__ void tile_accumulate(const float* P, const float* X,
                                                int tx, int ty,
                                                float (&acc)[4][D / 16]) {
  constexpr int DP = D + 1;
#pragma unroll 4
  for (int j = 0; j < kFC; ++j) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty * 4 + i) * kFP + j];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float x = X[j * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], x, acc[i][c]);
    }
  }
}

// key j is visible to query i (both < S): j <= i under the causal mask
__device__ __forceinline__ bool visible(int i, int j, int S, int causal) {
  return i < S && j < S && (!causal || j <= i);
}

template <int D>
constexpr int fwd_smem_bytes() {
  return ((kFR + 2 * kFC) * (D + 1) + kFR * kFP) * 4;
}

template <int D>
constexpr int bwd_smem_bytes() {
  return (2 * (kFR + kFC) * (D + 1) + kFR * kFP + 2 * kFR) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(kFNT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int H, int n_kv,
                 float sm_scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int CPT = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;             // [kFR][DP]
  float* Ks = Qs + kFR * DP;    // [kFC][DP]
  float* Vs = Ks + kFC * DP;    // [kFC][DP]
  float* Ps = Vs + kFC * DP;    // [kFR][kFP]

  const int q0 = blockIdx.x * kFR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / n_kv);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_rows<T, D>(Qs, q, b, q0, kFR, S, H, h);
  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // causal: key tiles past the tile's last query are skipped
  const int k_end = causal ? min(S, q0 + kFR) : S;
  for (int k0 = 0; k0 < k_end; k0 += kFC) {
    load_rows<T, D>(Ks, k, b, k0, kFC, S, n_kv, hk);
    load_rows<T, D>(Vs, v, b, k0, kFC, S, n_kv, hk);
    __syncthreads();
    float sc[4][2];
    tile_dots<D>(Qs, Ks, tx, ty, sc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      const float s0 =
          visible(row, k0 + tx, S, causal) ? sc[i][0] * sm_scale : NEG_INF;
      const float s1 = visible(row, k0 + tx + 16, S, causal)
                           ? sc[i][1] * sm_scale
                           : NEG_INF;
      const float mn = fmaxf(m[i], half_warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m[i] - mn);
      const float p0 = expf(s0 - mn);
      const float p1 = expf(s1 - mn);
      l[i] = l[i] * alpha + half_warp_sum(p0 + p1);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
      Ps[(ty * 4 + i) * kFP + tx] = p0;
      Ps[(ty * 4 + i) * kFP + tx + 16] = p1;
    }
    __syncthreads();
    tile_accumulate<D>(Ps, Vs, tx, ty, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float lv = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / lv;
    T* dst = out + ((size_t(b) * S + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) dst[tx + 16 * c] = from_f32<T>(acc[i][c] * inv);
    // a row that saw no key keeps the finite sentinel 0, so the
    // backward's exp(NEG_INF - lse) underflows to exactly 0
    if (lse != nullptr && tx == 0)
      lse[(size_t(b) * H + h) * S + row] =
          m[i] <= NEG_INF / 2 ? 0.f : m[i] + logf(lv);
  }
}

// 64 rows s0.. of head `hh` of a [B, S, nh, D] bf16 tensor into the
// shared tile at `dst` ([64][D + 8]), by 16-byte `cp.async` copies that
// the caller commits; rows at or past S read 0
template <int D>
__device__ __forceinline__ void stage_tile(unsigned dst,
                                           const __nv_bfloat16* src, int b,
                                           int s0, int S, int nh, int hh) {
  constexpr int LD = D + 8, CH = D / 8;
#pragma unroll
  for (int i = threadIdx.x; i < kAttnRows * CH; i += kAttnThreads) {
    const int r = i / CH, c = i % CH;
    const bool ok = s0 + r < S;
    const __nv_bfloat16* p =
        ok ? src + ((size_t(b) * S + s0 + r) * nh + hh) * D + c * 8 : src;
    cp_async16(dst + (r * LD + c * 8) * 2, p, ok);
  }
}

// The bf16 forward on the tensor cores (see the header): q [B, S, H, D],
// k / v [B, S, n_kv, D], out like q, lse f32 [B, H, S] or null.
template <int D>
__global__ void __launch_bounds__(kAttnThreads, 2)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int S, int H, int n_kv,
                     float sm_scale, int causal) {
  using Sm = AttnSmem<D>;
  extern __shared__ __align__(16) unsigned char attn_smem[];
  const unsigned base = smem_u32(attn_smem);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kAttnRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / n_kv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // causal: key tiles past the tile's last query are skipped
  const int k_end = causal ? min(S, q0 + kAttnRows) : S;
  stage_tile<D>(base + Sm::Q, q, b, q0, S, H, h);
  cp_async_commit();
  // the lane's two fragment rows, and the keys they see
  const int row0 = q0 + warp * 16 + (lane >> 2);
  const int row1 = row0 + 8;
  const int lim0 = causal ? min(S, row0 + 1) : S;
  const int lim1 = causal ? min(S, row1 + 1) : S;
  AttnWarp<D> w;
  w.run(base, (k_end + kAttnKeys - 1) / kAttnKeys, sm_scale * kLog2e,
        [&](int t, int st) {
          stage_tile<D>(base + Sm::K(st), k, b, t * kAttnKeys, S, n_kv, hk);
          stage_tile<D>(base + Sm::V(st), v, b, t * kAttnKeys, S, n_kv, hk);
        },
        [&](int t, int (&lim)[2]) {
          lim[0] = lim0 - t * kAttnKeys;
          lim[1] = lim1 - t * kAttnKeys;
        });

  float row_lse[2];
  w.store(attn_smem, row_lse, [&](int r) -> __nv_bfloat16* {
    const int row = q0 + warp * 16 + r;
    return row < S ? out + ((size_t(b) * S + row) * H + h) * D : nullptr;
  });
  // a row that saw no key keeps the finite sentinel 0, so the
  // backward's exp(NEG_INF - lse) underflows to exactly 0
  if (lse != nullptr && (lane & 3) == 0) {
    float* dst = lse + (size_t(b) * H + h) * S;
    if (row0 < S) dst[row0] = row_lse[0];
    if (row1 < S) dst[row1] = row_lse[1];
  }
}

// Shared memory of the bf16 backward kernels: six [64][D + 8] bf16 tiles
// (dq: Q, dO, then K and V in two stages each; dk/dv: K, V, then Q and
// dO in two stages each) and, for dk/dv, the query tile's lse and delta
// ([64] f32 each) in two stages.  D 128: 104,448 B (+ 1,024 B for
// dk/dv), so two blocks fit an SM.
template <int D>
struct BwdSmem {
  static constexpr unsigned TILE = AttnSmem<D>::TILE_BYTES;
  static constexpr unsigned VEC = 6 * TILE;
  static constexpr int DQ_BYTES = 6 * TILE;
  static constexpr int DKV_BYTES = 6 * TILE + 2 * 2 * kAttnRows * 4;
};

// query slice of the dk/dv kernel: S^T and dP^T over 32 queries at a time
// keep a thread's live f32 state at dk + dv (2 D / 8 x 4) + 2 x 16
constexpr int kBwdSlice = 32;

// The bf16 dq on the tensor cores (see the header): q, dO and dq [B, S,
// H, D], k / v [B, S, n_kv, D], lse (natural log) and delta f32 [B, H,
// S].
template <int D>
__global__ void __launch_bounds__(kAttnThreads, 2)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int S, int H,
                        int n_kv, float sm_scale, int causal) {
  constexpr int LD = D + 8;
  constexpr unsigned T = BwdSmem<D>::TILE;
  extern __shared__ __align__(16) unsigned char attn_smem[];
  const unsigned base = smem_u32(attn_smem);   // Q, dO, K(2), V(2)

  // the longest causal tiles (the last ones) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kAttnRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / n_kv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  stage_tile<D>(base, q, b, q0, S, H, h);
  stage_tile<D>(base + T, dout, b, q0, S, H, h);
  cp_async_commit();
  // causal: key tiles past the tile's last query are skipped, and in a
  // warp the 16-key slices past its last row
  const int k_end = causal ? min(S, q0 + kAttnRows) : S;
  const int n_t = (k_end + kAttnKeys - 1) / kAttnKeys;
  const int w_end = causal ? min(S, q0 + warp * 16 + 16) : S;
  auto stage = [&](int t, int st) {
    stage_tile<D>(base + (2 + st) * T, k, b, t * kAttnKeys, S, n_kv, hk);
    stage_tile<D>(base + (4 + st) * T, v, b, t * kAttnKeys, S, n_kv, hk);
  };
  stage(0, 0);
  cp_async_commit();

  // the lane's two fragment rows: the keys they see, their lse in log2
  // units and their delta (rows past S read 0 and are not written)
  const int row0 = q0 + warp * 16 + (lane >> 2);
  int lim[2];
  float l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    lim[i] = causal ? min(S, row + 1) : S;
    const size_t at = (size_t(b) * H + h) * S + row;
    l2[i] = row < S ? lse[at] * kLog2e : 0.f;
    dl[i] = row < S ? delta[at] : 0.f;
  }

  cp_async_wait<1>();   // Q and dO landed
  __syncthreads();
  unsigned qf[D / 16][4], of[D / 16][4];
  load_a<D>(qf, base + warp * 16 * LD * 2, lane);
  load_a<D>(of, base + T + warp * 16 * LD * 2, lane);
  float acc[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  const float scale2 = sm_scale * kLog2e;
  const int c = (lane & 3) * 2;
  for (int t = 0; t < n_t; ++t) {
    if (t + 1 < n_t) stage(t + 1, (t + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();   // key tile t landed
    __syncthreads();
    const int k0 = t * kAttnKeys;
    const unsigned ks = base + (2 + (t & 1)) * T;
    const unsigned vs = base + (4 + (t & 1)) * T;
#pragma unroll
    for (int j = 0; j < kAttnKeys / 16; ++j) {
      if (k0 + 16 * j >= w_end) break;   // the same for the whole warp
      const unsigned kj = ks + j * 16 * LD * 2;
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      // S = Q K^T and dP = dO V^T over the slice's 16 keys
      mma_scores<D, 2>(
          s,
          [&](int kk, unsigned (&f)[4]) {
#pragma unroll
            for (int e = 0; e < 4; ++e) f[e] = qf[kk][e];
          },
          kj, lane);
      mma_scores<D, 2>(
          dp,
          [&](int kk, unsigned (&f)[4]) {
#pragma unroll
            for (int e = 0; e < 4; ++e) f[e] = of[kk][e];
          },
          vs + j * 16 * LD * 2, lane);
      // ds = p (dp - delta), p = exp2(s scale2 - lse2) and 0 where masked
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          const int key = k0 + 16 * j + 8 * n + c + (e & 1);
          const float p =
              key < lim[hh] ? exp2f(s[n][e] * scale2 - l2[hh]) : 0.f;
          s[n][e] = p * (dp[n][e] - dl[hh]);
        }
      // dQ += dS K, dS rounded to bf16 in registers, K by ldmatrix.trans
      unsigned f[1][4];
      c_to_a(f[0], s[0], s[1]);
      mma_accumulate<D, 1>(acc, f, kj, lane);
    }
    __syncthreads();      // tile t read before its stage is refilled
  }

  // dq = scale dQ, staged through the warp's Q rows
  store_rows<D>(reinterpret_cast<__nv_bfloat16*>(attn_smem) + warp * 16 * LD,
                acc, sm_scale, sm_scale, lane,
                [&](int r) -> __nv_bfloat16* {
                  const int row = q0 + warp * 16 + r;
                  return row < S ? dq + ((size_t(b) * S + row) * H + h) * D
                                 : nullptr;
                });
}

// The bf16 narrow dk/dv on the tensor cores (see the header): inputs as
// flash_bwd_dq_mma_kernel's, dk / dv [B, S, n_kv, D].
template <int D>
__global__ void __launch_bounds__(kAttnThreads, 2)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int S, int H,
                         int n_kv, float sm_scale, int causal) {
  constexpr int LD = D + 8;
  constexpr int QS = kBwdSlice;
  constexpr unsigned T = BwdSmem<D>::TILE;
  static_assert(kAttnThreads == 2 * kAttnRows, "one lse/delta copy a thread");
  extern __shared__ __align__(16) unsigned char attn_smem[];
  const unsigned base = smem_u32(attn_smem);   // K, V, Q(2), dO(2), vec
  // stage st: lse at vec[st * 128 + i], delta at vec[st * 128 + 64 + i]
  const float* vec = reinterpret_cast<const float*>(attn_smem +
                                                    BwdSmem<D>::VEC);

  const int k0 = blockIdx.x * kAttnKeys;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / n_kv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  stage_tile<D>(base, k, b, k0, S, n_kv, hk);
  stage_tile<D>(base + T, v, b, k0, S, n_kv, hk);
  cp_async_commit();
  // the walk: each q head of the group, each query tile from the
  // diagonal on (causal: earlier tiles see none of the block's keys)
  const int q_begin = causal ? k0 : 0;
  const int n_qt = (S - q_begin + kAttnRows - 1) / kAttnRows;
  const int n_it = group * n_qt;
  auto q_start = [&](int it) { return q_begin + (it % n_qt) * kAttnRows; };
  auto stage = [&](int it, int st) {
    const int h = hk * group + it / n_qt;
    const int q0 = q_start(it);
    stage_tile<D>(base + (2 + st) * T, q, b, q0, S, H, h);
    stage_tile<D>(base + (4 + st) * T, dout, b, q0, S, H, h);
    // thread i < 64 copies lse[q0 + i], thread 64 + i delta[q0 + i]
    const int i = tid & (kAttnRows - 1);
    const bool ok = q0 + i < S;
    const float* src = (tid < kAttnRows ? lse : delta) +
                       (size_t(b) * H + h) * S + (ok ? q0 + i : 0);
    cp_async4(base + BwdSmem<D>::VEC + (st * 2 * kAttnRows + tid) * 4, src,
              ok);
  };
  stage(0, 0);
  cp_async_commit();

  // the lane's two fragment rows are keys; query column qc is visible to
  // row i iff lo[i] <= qc < S (lo = S for a key past S: none is)
  int lo[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + warp * 16 + (lane >> 2) + 8 * i;
    lo[i] = key >= S ? S : (causal ? key : 0);
  }
  const int w_key = k0 + warp * 16;    // the warp's first key
  // K and V rows of the warp, read as A fragments per k16 step
  const unsigned ka = a_rows<D>(base + warp * 16 * LD * 2, lane);
  const unsigned va = a_rows<D>(base + T + warp * 16 * LD * 2, lane);
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[t][e] = dva[t][e] = 0.f;

  const float scale2 = sm_scale * kLog2e;
  const int c = (lane & 3) * 2;
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) stage(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();   // K, V and query tile it landed
    __syncthreads();
    const int st = it & 1;
    const int q0 = q_start(it);
    const unsigned qs = base + (2 + st) * T;
    const unsigned os = base + (4 + st) * T;
    const float* ls = vec + st * 2 * kAttnRows;
    const float* dls = ls + kAttnRows;
#pragma unroll
    for (int j = 0; j < kAttnRows / QS; ++j) {
      const int qa = q0 + j * QS;
      // the same for the whole warp: slices past S, and (causal) slices
      // before the warp's first key
      if (qa >= S || w_key >= S) break;
      if (causal && qa + QS <= w_key) continue;
      const unsigned qj = qs + j * QS * LD * 2;
      const unsigned oj = os + j * QS * LD * 2;
      float s[QS / 8][4], dp[QS / 8][4];
#pragma unroll
      for (int n = 0; n < QS / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      // S^T = K Q^T and dP^T = V dO^T: keys are rows, queries columns
      mma_scores<D, QS / 8>(
          s, [&](int kk, unsigned (&f)[4]) { ldmatrix_x4(f, ka + kk * 32); },
          qj, lane);
      mma_scores<D, QS / 8>(
          dp, [&](int kk, unsigned (&f)[4]) { ldmatrix_x4(f, va + kk * 32); },
          oj, lane);
      // p^T and ds^T = p^T (dp^T - delta); the lane's columns are queries
      // j QS + 8 n + c + {0, 1}, with lse and delta per column
#pragma unroll
      for (int n = 0; n < QS / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = j * QS + 8 * n + c + e;
          const int qc = q0 + col;
          const float l2 = ls[col] * kLog2e;
          const float dl = dls[col];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int x = 2 * i + e;
            const float p = qc >= lo[i] && qc < S
                                ? exp2f(s[n][x] * scale2 - l2)
                                : 0.f;
            s[n][x] = p;
            dp[n][x] = p * (dp[n][x] - dl);
          }
        }
      // dV += P^T dO and dK += dS^T Q: P^T and dS^T rounded to bf16 in
      // registers, dO and Q by ldmatrix.trans from the staged tiles
      unsigned pf[QS / 16][4], df[QS / 16][4];
#pragma unroll
      for (int kk = 0; kk < QS / 16; ++kk) {
        c_to_a(pf[kk], s[2 * kk], s[2 * kk + 1]);
        c_to_a(df[kk], dp[2 * kk], dp[2 * kk + 1]);
      }
      mma_accumulate<D, QS / 16>(dva, pf, oj, lane);
      mma_accumulate<D, QS / 16>(dka, df, qj, lane);
    }
    __syncthreads();      // tile it read before its stage is refilled
  }

  // dk = scale dK and dv = dV, staged through the warp's own K and V rows
  auto key_rows = [&](__nv_bfloat16* out) {
    return [=](int r) -> __nv_bfloat16* {
      const int key = w_key + r;
      return key < S ? out + ((size_t(b) * S + key) * n_kv + hk) * D
                     : nullptr;
    };
  };
  __nv_bfloat16* rows = reinterpret_cast<__nv_bfloat16*>(attn_smem);
  store_rows<D>(rows + warp * 16 * LD, dka, sm_scale, sm_scale, lane,
                key_rows(dk));
  store_rows<D>(rows + (kAttnRows + warp * 16) * LD, dva, 1.f, 1.f, lane,
                key_rows(dv));
}

template <typename T, int D>
__global__ void __launch_bounds__(kFNT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int H, int n_kv, float sm_scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int CPT = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;              // [kFR][DP]
  float* Os = Qs + kFR * DP;     // [kFR][DP]  dO
  float* Ks = Os + kFR * DP;     // [kFC][DP]
  float* Vs = Ks + kFC * DP;     // [kFC][DP]
  float* Ps = Vs + kFC * DP;     // [kFR][kFP]  ds
  float* Ls = Ps + kFR * kFP;    // [kFR]
  float* Dl = Ls + kFR;          // [kFR]

  const int q0 = blockIdx.x * kFR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / n_kv);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_rows<T, D>(Qs, q, b, q0, kFR, S, H, h);
  load_rows<T, D>(Os, dout, b, q0, kFR, S, H, h);
  load_vec(Ls, lse, b * H + h, q0, kFR, S);
  load_vec(Dl, delta, b * H + h, q0, kFR, S);
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  const int k_end = causal ? min(S, q0 + kFR) : S;
  for (int k0 = 0; k0 < k_end; k0 += kFC) {
    load_rows<T, D>(Ks, k, b, k0, kFC, S, n_kv, hk);
    load_rows<T, D>(Vs, v, b, k0, kFC, S, n_kv, hk);
    __syncthreads();
    float sc[4][2], dp[4][2];
    tile_dots<D>(Qs, Ks, tx, ty, sc);
    tile_dots<D>(Os, Vs, tx, ty, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float s = visible(q0 + r, k0 + tx + 16 * c, S, causal)
                            ? sc[i][c] * sm_scale
                            : NEG_INF;
        const float p = expf(s - Ls[r]);
        Ps[r * kFP + tx + 16 * c] = p * (dp[i][c] - Dl[r]);
      }
    }
    __syncthreads();
    tile_accumulate<D>(Ps, Ks, tx, ty, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    T* dst = dq + ((size_t(b) * S + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      dst[tx + 16 * c] = from_f32<T>(sm_scale * acc[i][c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kFNT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int H, int n_kv,
                     float sm_scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int CPT = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;              // [kFR][DP]
  float* Vs = Ks + kFR * DP;     // [kFR][DP]
  float* Qs = Vs + kFR * DP;     // [kFC][DP]
  float* Os = Qs + kFC * DP;     // [kFC][DP]  dO
  float* Ps = Os + kFC * DP;     // [kFR][kFP]  p^T, then ds^T
  float* Ls = Ps + kFR * kFP;    // [kFC]
  float* Dl = Ls + kFR;          // [kFC]

  const int k0 = blockIdx.x * kFR;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / n_kv;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_rows<T, D>(Ks, k, b, k0, kFR, S, n_kv, hk);
  load_rows<T, D>(Vs, v, b, k0, kFR, S, n_kv, hk);
  float dk_acc[4][CPT], dv_acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // causal: query tiles before the key tile see none of its keys
  const int q_begin = causal ? k0 : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int q0 = q_begin; q0 < S; q0 += kFC) {
      load_rows<T, D>(Qs, q, b, q0, kFC, S, H, h);
      load_rows<T, D>(Os, dout, b, q0, kFC, S, H, h);
      load_vec(Ls, lse, b * H + h, q0, kFC, S);
      load_vec(Dl, delta, b * H + h, q0, kFC, S);
      __syncthreads();
      float sc[4][2], dp[4][2], ds[4][2];
      tile_dots<D>(Ks, Qs, tx, ty, sc);   // s^T: [key][query]
      tile_dots<D>(Vs, Os, tx, ty, dp);   // (dO.v)^T
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = tx + 16 * c;
          const float s = visible(q0 + j, k0 + r, S, causal)
                              ? sc[i][c] * sm_scale
                              : NEG_INF;
          const float p = expf(s - Ls[j]);
          ds[i][c] = p * (dp[i][c] - Dl[j]);
          Ps[r * kFP + j] = p;
        }
      }
      __syncthreads();
      tile_accumulate<D>(Ps, Os, tx, ty, dv_acc);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) Ps[(ty * 4 + i) * kFP + tx + 16 * c] = ds[i][c];
      __syncthreads();
      tile_accumulate<D>(Ps, Qs, tx, ty, dk_acc);
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= S) continue;
    const size_t base = ((size_t(b) * S + key) * n_kv + hk) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dk[base + tx + 16 * c] = from_f32<T>(sm_scale * dk_acc[i][c]);
      dv[base + tx + 16 * c] = from_f32<T>(dv_acc[i][c]);
    }
  }
}

// Calls f(T{}, integral_constant<int, D>{}) for the dtype code and head
// dim; other combinations are refused.
template <typename F>
static int dispatch_flash(int dtype, int D, F&& f) {
  using D64 = std::integral_constant<int, 64>;
  using D128 = std::integral_constant<int, 128>;
  if (dtype == kBF16 && D == 128) return f(__nv_bfloat16{}, D128{});
  if (dtype == kBF16 && D == 64) return f(__nv_bfloat16{}, D64{});
  if (dtype == kF32 && D == 128) return f(float{}, D128{});
  if (dtype == kF32 && D == 64) return f(float{}, D64{});
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename Kernel>
static int prepare(Kernel kernel, int smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

// true when any pointer is not 16-byte aligned (the tensor-core kernels'
// 16-byte copies need aligned rows)
static bool misaligned16(std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  return (bits & 15) != 0;
}

}  // namespace tos

extern "C" int tos_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, float* lse, int B, int S, int H,
                             int n_kv, int D, float sm_scale, int causal,
                             int dtype, void* stream) {
  using namespace tos;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((S + kFR - 1) / kFR, H, B);
  return dispatch_flash(dtype, D, [&](auto t, auto d) {
    using T = decltype(t);
    constexpr int DD = decltype(d)::value;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      // bf16: the tensor cores
      if (misaligned16({q, k, v, out}))
        return static_cast<int>(cudaErrorMisalignedAddress);
      constexpr int smem = AttnSmem<DD>::BYTES;
      int err = prepare(flash_fwd_mma_kernel<DD>, smem);
      if (err) return err;
      flash_fwd_mma_kernel<DD><<<grid, kAttnThreads, smem, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out), lse, S, H, n_kv,
          sm_scale, causal);
      return static_cast<int>(cudaGetLastError());
    } else {
      constexpr int smem = fwd_smem_bytes<DD>();
      int err = prepare(flash_fwd_kernel<T, DD>, smem);
      if (err) return err;
      flash_fwd_kernel<T, DD><<<grid, kFNT, smem, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out), lse, S, H, n_kv,
          sm_scale, causal);
      return static_cast<int>(cudaGetLastError());
    }
  });
}

extern "C" int tos_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dq, int B, int S,
                                int H, int n_kv, int D, float sm_scale,
                                int causal, int dtype, void* stream) {
  using namespace tos;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((S + kFR - 1) / kFR, H, B);
  return dispatch_flash(dtype, D, [&](auto t, auto d) {
    using T = decltype(t);
    constexpr int DD = decltype(d)::value;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      // bf16: the tensor cores
      if (misaligned16({q, k, v, dout, dq}))
        return static_cast<int>(cudaErrorMisalignedAddress);
      constexpr int smem = BwdSmem<DD>::DQ_BYTES;
      int err = prepare(flash_bwd_dq_mma_kernel<DD>, smem);
      if (err) return err;
      flash_bwd_dq_mma_kernel<DD><<<grid, kAttnThreads, smem, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
          static_cast<T*>(dq), S, H, n_kv, sm_scale, causal);
      return static_cast<int>(cudaGetLastError());
    } else {
      constexpr int smem = bwd_smem_bytes<DD>();
      int err = prepare(flash_bwd_dq_kernel<T, DD>, smem);
      if (err) return err;
      flash_bwd_dq_kernel<T, DD><<<grid, kFNT, smem, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
          static_cast<T*>(dq), S, H, n_kv, sm_scale, causal);
      return static_cast<int>(cudaGetLastError());
    }
  });
}

extern "C" int tos_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dk, void* dv,
                                 int B, int S, int H, int n_kv, int D,
                                 float sm_scale, int causal, int dtype,
                                 void* stream) {
  using namespace tos;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((S + kFR - 1) / kFR, n_kv, B);
  return dispatch_flash(dtype, D, [&](auto t, auto d) {
    using T = decltype(t);
    constexpr int DD = decltype(d)::value;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      // bf16: the tensor cores
      if (misaligned16({q, k, v, dout, dk, dv}))
        return static_cast<int>(cudaErrorMisalignedAddress);
      constexpr int smem = BwdSmem<DD>::DKV_BYTES;
      int err = prepare(flash_bwd_dkv_mma_kernel<DD>, smem);
      if (err) return err;
      flash_bwd_dkv_mma_kernel<DD><<<grid, kAttnThreads, smem, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
          static_cast<T*>(dk), static_cast<T*>(dv), S, H, n_kv, sm_scale,
          causal);
      return static_cast<int>(cudaGetLastError());
    } else {
      constexpr int smem = bwd_smem_bytes<DD>();
      int err = prepare(flash_bwd_dkv_kernel<T, DD>, smem);
      if (err) return err;
      flash_bwd_dkv_kernel<T, DD><<<grid, kFNT, smem, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
          static_cast<T*>(dk), static_cast<T*>(dv), S, H, n_kv, sm_scale,
          causal);
      return static_cast<int>(cudaGetLastError());
    }
  });
}
