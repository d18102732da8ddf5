// Fused-dequant weight matmuls: y = x @ dequant(w), W8A16 and W4A16.
//
// Replaces the TPU kernels `_int8_kernel` (kernel 9) and `_int4_kernel`
// (kernel 10) of tensorflowonspark_tpu/ops/quant_matmul.py, reached
// through `_int8_call` / `_int4_call` from `quant_matmul`.
//
// Per element, as the TPU kernels compute it:
//   int8: w[k, n] = T(f32(q[k, n]) * scale[0, n])
//   int4: byte b = packed[k / 2, n]; v = k even ? (int)(b << 28) >> 28
//                                               : (int)(b << 24) >> 28
//         w[k, n] = T(f32(v) * scale[k / G, n])
//   y[m, n] = T(sum_k f32(x[m, k]) * f32(w[k, n]))   (f32 accumulation)
// where T is x's dtype: the dequantised weight is rounded to T and back,
// so the products are the ones the TPU kernel feeds the MXU.
//
// Bound, on an NVIDIA H100 SXM at its 700 W limit (3.35 TB/s, 989
// TFLOP/s bf16).  At decode (M <= 16 rows) the call is a GEMV: bytes, the
// weight read once (K*N int8, or K*N/2 packed bytes plus the group
// scales); 5.1 us (int8) and 2.8 us (int4) at the flagship `wi` shape
// (K 2048, N 8192).  At prefill (M 1024) it is a GEMM: operations,
// 2*M*K*N = 34.4 GFLOP, 0.035 ms on the bf16 tensor cores.  The f32 FMAs
// of this CUDA-core design alone take 8 us at M 16 (67 TFLOP/s f32), so
// it cannot reach the decode bound; tensor cores are the later step.
//
// Design (a simple kernel that is right; tensor cores come later).  A
// block of 256 threads owns a [BM, 128] output tile and walks a range of
// K in 32-row steps.  Each step stages the activation tile [BM, 32] (f32)
// and the weight tile, dequantised in registers, [32, 128] (f32) in
// shared memory; the weight loads run along N, where the [K, N] layout is
// contiguous, one 4-byte word (4 columns, or 4 columns x 2 rows packed)
// per thread.  The raw words of the next step are loaded into registers
// while the current step computes.  Each thread accumulates a TM x 4
// micro-tile with FMAs on the CUDA cores.  Ragged M, K and N are
// bounds-checked in place (no padded copies); a packed row i holds
// k = 2i and 2i + 1, so no even/odd split of x is needed.  Two launch
// shapes: BM 16 for decode rows and BM 64 for prefill.
//
// K is summed in fixed chunks of `tiles_per_chunk` steps, a function of
// K and N only: each chunk sums in order from 0, and the chunk sums add
// in order from 0.  So a row's result does not depend on how many rows
// share the call (a request decodes the same tokens alone or in a
// batch).  When the output tiles alone cannot fill the card (the decode
// GEMV has 64 tiles at N 8192), each chunk runs in its own block and
// writes f32 partials, and a second pass adds them in chunk order and
// writes x's dtype once; otherwise one block walks every chunk.
#include "common.cuh"

namespace tos {

constexpr int QMM_THREADS = 256;
constexpr int QMM_BN = 128;
constexpr int QMM_BK = 32;

__device__ __forceinline__ float dequant_round(float v, float s,
                                               const float*) {
  return __fmul_rn(v, s);
}
__device__ __forceinline__ float dequant_round(float v, float s,
                                               const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(__fmul_rn(v, s)));
}

// The raw global words of one 32-row step for one thread: the activation
// values it stages and the weight words (and int4 scales) of its 4
// columns.  Loading them is separate from storing them, so the next
// step's loads are in flight while the current step computes.
template <typename T, bool INT4, int TM>
struct QmmRaw {
  static constexpr int BM = 8 * TM;
  static constexpr int XPT = BM * QMM_BK / QMM_THREADS;   // 2 or 8
  static constexpr int PASSES = INT4 ? QMM_BK / 16 : QMM_BK / 8;
  float xv[XPT];
  unsigned w[PASSES];
  float4 s4[INT4 ? PASSES : 1];
};

// TM output rows per thread; 8 thread rows x 32 thread columns of 4.
template <typename T, bool INT4, int TM>
__global__ void __launch_bounds__(QMM_THREADS, 2)
quant_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                    const float* __restrict__ scale, T* __restrict__ out,
                    float* __restrict__ partial, int M, int K, int N,
                    int q_rows, int group, int tiles_per_chunk,
                    int chunks_per_block, int vec) {
  using Raw = QmmRaw<T, INT4, TM>;
  constexpr int BM = Raw::BM;
  __shared__ float xs[BM][QMM_BK];
  __shared__ __align__(16) float ws[QMM_BK][QMM_BN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;            // 0..7
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * QMM_BN;
  const int k_tiles = (K + QMM_BK - 1) / QMM_BK;
  const int t_begin = blockIdx.z * chunks_per_block * tiles_per_chunk;
  const int t_end = min(t_begin + chunks_per_block * tiles_per_chunk,
                        k_tiles);

  // the 4 weight columns this thread loads: fixed for the whole walk
  const int nc = n0 + 4 * lane;
  const bool full4 = vec && nc + 3 < N;
  float s8[4] = {0.f, 0.f, 0.f, 0.f};
  if (!INT4) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (nc + j < N) s8[j] = scale[nc + j];
  }

  // the 4 bytes of row `row` at columns nc..nc+3 as one word (0 past N)
  auto load_word = [&](long long row) -> unsigned {
    const int8_t* p = q + row * N + nc;
    if (full4) return *reinterpret_cast<const unsigned*>(p);
    unsigned word = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (nc + j < N)
        word |= (static_cast<unsigned>(p[j]) & 0xFFu) << (8 * j);
    return word;
  };

  auto load = [&](int t, Raw& r) {
    const int k0 = t * QMM_BK;
    // activation tile, coalesced along K; rows past M and K read as 0
#pragma unroll
    for (int e = 0; e < Raw::XPT; ++e) {
      const int i = tid + e * QMM_THREADS;
      const int m = m0 + i / QMM_BK, k = k0 + i % QMM_BK;
      r.xv[e] = (m < M && k < K)
                    ? to_f32(x[static_cast<long long>(m) * K + k])
                    : 0.f;
    }
#pragma unroll
    for (int p = 0; p < Raw::PASSES; ++p) {
      r.w[p] = 0u;
      if (!INT4) {
        const int k = k0 + p * 8 + warp;          // one row per warp
        if (k < K) r.w[p] = load_word(k);
      } else {
        const int pr = p * 8 + warp;               // one packed row per warp
        const int prow = k0 / 2 + pr;
        const int k = k0 + 2 * pr;                 // the low nibble's row
        float4 sv = make_float4(0.f, 0.f, 0.f, 0.f);
        if (prow < q_rows && k < K) {
          r.w[p] = load_word(prow);
          const float* srow = scale + static_cast<long long>(k / group) * N;
          if (full4) {
            sv = *reinterpret_cast<const float4*>(srow + nc);
          } else {
            if (nc < N) sv.x = srow[nc];
            if (nc + 1 < N) sv.y = srow[nc + 1];
            if (nc + 2 < N) sv.z = srow[nc + 2];
            if (nc + 3 < N) sv.w = srow[nc + 3];
          }
        }
        r.s4[INT4 ? p : 0] = sv;
      }
    }
  };

  auto store = [&](const Raw& r) {
#pragma unroll
    for (int e = 0; e < Raw::XPT; ++e) {
      const int i = tid + e * QMM_THREADS;
      xs[i / QMM_BK][i % QMM_BK] = r.xv[e];
    }
#pragma unroll
    for (int p = 0; p < Raw::PASSES; ++p) {
      const unsigned word = r.w[p];
      if (!INT4) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = dequant_round(
              static_cast<float>(static_cast<int>(word << (24 - 8 * j)) >> 24),
              s8[j], x);
        *reinterpret_cast<float4*>(&ws[p * 8 + warp][4 * lane]) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
        const int pr = p * 8 + warp;
        const float4 sv = r.s4[INT4 ? p : 0];
        const float s[4] = {sv.x, sv.y, sv.z, sv.w};
        float lo[4], hi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned b = (word >> (8 * j)) & 0xFFu;
          lo[j] = dequant_round(
              static_cast<float>(static_cast<int>(b << 28) >> 28), s[j], x);
          // the high nibble's row k + 1 may lie past K (odd K): x reads
          // 0 there, and the packed padding holds 0
          hi[j] = dequant_round(
              static_cast<float>(static_cast<int>(b << 24) >> 28), s[j], x);
        }
        *reinterpret_cast<float4*>(&ws[2 * pr][4 * lane]) =
            make_float4(lo[0], lo[1], lo[2], lo[3]);
        *reinterpret_cast<float4*>(&ws[2 * pr + 1][4 * lane]) =
            make_float4(hi[0], hi[1], hi[2], hi[3]);
      }
    }
  };

  float acc[TM][4], total[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = total[i][j] = 0.f;

  Raw raw;
  if (t_begin < t_end) load(t_begin, raw);
  for (int t = t_begin; t < t_end; ++t) {
    store(raw);
    __syncthreads();
    if (t + 1 < t_end) load(t + 1, raw);      // in flight during compute
#pragma unroll 8
    for (int kk = 0; kk < QMM_BK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][4 * lane]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float a = xs[warp * TM + i][kk];   // one address per warp
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
    // a chunk ends: its sum joins the total in chunk order
    if ((t + 1) % tiles_per_chunk == 0 || t + 1 == t_end) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          total[i][j] += acc[i][j];
          acc[i][j] = 0.f;
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + warp * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nc + j;
      if (n >= N) continue;
      const long long o = static_cast<long long>(m) * N + n;
      if (partial)
        partial[static_cast<long long>(blockIdx.z) * M * N + o] =
            total[i][j];
      else
        out[o] = from_f32<T>(total[i][j]);
    }
  }
}

// out = T(sum over splits of partial[s]), in split order
template <typename T>
__global__ void __launch_bounds__(256)
split_sum_kernel(const float* __restrict__ partial, T* __restrict__ out,
                 long long mn, int splits) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < mn; i += stride) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += partial[z * mn + i];
    out[i] = from_f32<T>(s);
  }
}

template <typename T, bool INT4, int TM>
static int launch_qmm(const void* x, const void* q, const float* scale,
                      void* out, float* partial, int M, int K, int N,
                      int q_rows, int group, int tiles_per_chunk, int splits,
                      int vec, cudaStream_t st) {
  constexpr int BM = 8 * TM;
  const int k_tiles = (K + QMM_BK - 1) / QMM_BK;
  const int chunks = (k_tiles + tiles_per_chunk - 1) / tiles_per_chunk;
  // `splits` is 1 (one block walks every chunk) or the chunk count (one
  // block per chunk)
  if (splits != 1 && splits != chunks) return cudaErrorInvalidValue;
  dim3 grid((N + QMM_BN - 1) / QMM_BN, (M + BM - 1) / BM, splits);
  quant_matmul_kernel<T, INT4, TM><<<grid, QMM_THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q), scale,
      static_cast<T*>(out), splits > 1 ? partial : nullptr, M, K, N, q_rows,
      group, tiles_per_chunk, splits > 1 ? 1 : chunks, vec);
  if (splits > 1) {
    const long long mn = static_cast<long long>(M) * N;
    const long long blocks = (mn + 255) / 256;
    split_sum_kernel<T><<<static_cast<int>(blocks < 4096 ? blocks : 4096),
                          256, 0, st>>>(partial, static_cast<T*>(out), mn,
                                        splits);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool INT4>
static int dispatch_rows(const void* x, const void* q, const float* scale,
                         void* out, float* partial, int M, int K, int N,
                         int q_rows, int group, int block_m,
                         int tiles_per_chunk, int splits, int vec,
                         cudaStream_t st) {
  if (block_m == 16)
    return launch_qmm<T, INT4, 2>(x, q, scale, out, partial, M, K, N,
                                  q_rows, group, tiles_per_chunk, splits,
                                  vec, st);
  if (block_m == 64)
    return launch_qmm<T, INT4, 8>(x, q, scale, out, partial, M, K, N,
                                  q_rows, group, tiles_per_chunk, splits,
                                  vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tos

// x [M, K] (dtype), q [q_rows, N] int8 (int8: q_rows == K; int4: packed,
// q_rows == ceil(K / group) * group / 2), scale [1, N] or
// [ceil(K / group), N] f32, out [M, N] (dtype).  K sums in chunks of
// `tiles_per_chunk` 32-row steps; `splits` is 1 or the chunk count, and
// `partial` holds splits * M * N f32 when splits > 1.  `vec` = N is a
// multiple of 4 and q / scale are 16-byte aligned (word loads along N).
extern "C" int tos_quant_matmul(const void* x, const void* q,
                                const float* scale, void* out, float* partial,
                                int M, int K, int N, int q_rows, int group,
                                int int4, int block_m, int tiles_per_chunk,
                                int splits, int vec, int dtype,
                                void* stream) {
  using namespace tos;
  if (M <= 0 || N <= 0) return 0;
  if (splits < 1 || tiles_per_chunk < 1 ||
      (int4 && (group < 2 || group % 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return int4 ? dispatch_rows<float, true>(x, q, scale, out, partial, M, K,
                                             N, q_rows, group, block_m,
                                             tiles_per_chunk, splits, vec, st)
                : dispatch_rows<float, false>(x, q, scale, out, partial, M,
                                              K, N, q_rows, group, block_m,
                                              tiles_per_chunk, splits, vec,
                                              st);
  if (dtype == kBF16)
    return int4 ? dispatch_rows<__nv_bfloat16, true>(
                      x, q, scale, out, partial, M, K, N, q_rows, group,
                      block_m, tiles_per_chunk, splits, vec, st)
                : dispatch_rows<__nv_bfloat16, false>(
                      x, q, scale, out, partial, M, K, N, q_rows, group,
                      block_m, tiles_per_chunk, splits, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
