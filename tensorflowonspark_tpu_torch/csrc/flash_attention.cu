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
// f32 (all three kernels) and the bf16 backward compute in f32 on the
// CUDA cores, so they sit far from the bound.  Design, common to the
// three CUDA-core kernels: 256 threads (16 x 16) per block.
// A block keeps one 64-row tile resident in shared memory (as f32, for
// bf16 and f32 inputs alike) and streams 32-row tiles of the other
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
  constexpr int LD = Sm::LD, CH = Sm::CHUNKS;
  extern __shared__ __align__(16) unsigned char attn_smem[];
  const unsigned base = smem_u32(attn_smem);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kAttnRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / n_kv);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // rows s0.. of head `hh` of a [B, S, nh, D] tensor into the tile at
  // `dst`; rows at or past S read 0
  auto stage_rows = [&](unsigned dst, const __nv_bfloat16* src, int s0,
                        int nh, int hh) {
#pragma unroll
    for (int i = tid; i < kAttnRows * CH; i += kAttnThreads) {
      const int r = i / CH, c = i % CH;
      const bool ok = s0 + r < S;
      const __nv_bfloat16* p =
          ok ? src + ((size_t(b) * S + s0 + r) * nh + hh) * D + c * 8 : src;
      cp_async16(dst + (r * LD + c * 8) * 2, p, ok);
    }
  };

  // causal: key tiles past the tile's last query are skipped
  const int k_end = causal ? min(S, q0 + kAttnRows) : S;
  stage_rows(base + Sm::Q, q, q0, H, h);
  cp_async_commit();
  // the lane's two fragment rows, and the keys they see
  const int row0 = q0 + warp * 16 + (lane >> 2);
  const int row1 = row0 + 8;
  const int lim0 = causal ? min(S, row0 + 1) : S;
  const int lim1 = causal ? min(S, row1 + 1) : S;
  AttnWarp<D> w;
  w.run(base, (k_end + kAttnKeys - 1) / kAttnKeys, sm_scale * kLog2e,
        [&](int t, int st) {
          stage_rows(base + Sm::K(st), k, t * kAttnKeys, n_kv, hk);
          stage_rows(base + Sm::V(st), v, t * kAttnKeys, n_kv, hk);
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
      // bf16: the tensor cores, whose 16-byte copies need aligned rows
      if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
           reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out))
          & 15)
        return static_cast<int>(cudaErrorMisalignedAddress);
      constexpr int smem = AttnSmem<DD>::BYTES;
      int err = prepare(flash_fwd_mma_kernel<DD>, smem);
      if (err) return err;
      flash_fwd_mma_kernel<DD><<<grid, kAttnThreads, smem, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out), lse, S, H, n_kv,
          sm_scale, causal);
      return static_cast<int>(cudaGetLastError());
    }
    constexpr int smem = fwd_smem_bytes<DD>();
    int err = prepare(flash_fwd_kernel<T, DD>, smem);
    if (err) return err;
    flash_fwd_kernel<T, DD><<<grid, kFNT, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), lse, S, H, n_kv,
        sm_scale, causal);
    return static_cast<int>(cudaGetLastError());
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
    constexpr int smem = bwd_smem_bytes<DD>();
    int err = prepare(flash_bwd_dq_kernel<T, DD>, smem);
    if (err) return err;
    flash_bwd_dq_kernel<T, DD><<<grid, kFNT, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dq), S, H, n_kv, sm_scale, causal);
    return static_cast<int>(cudaGetLastError());
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
    constexpr int smem = bwd_smem_bytes<DD>();
    int err = prepare(flash_bwd_dkv_kernel<T, DD>, smem);
    if (err) return err;
    flash_bwd_dkv_kernel<T, DD><<<grid, kFNT, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dk), static_cast<T*>(dv), S, H, n_kv, sm_scale,
        causal);
    return static_cast<int>(cudaGetLastError());
  });
}
