// Row LayerNorm with f32 statistics.
//
// Replaces the TPU kernel tensorflowonspark_tpu/ops/layernorm.py
// `_ln_kernel` (reached through `fused_layernorm` -> `_ln_impl`).  Same
// math: per row of x [N, D], mean = sum(x) / D, then the CENTRED variance
// var = sum((x - mean)^2) / D (two passes, not E[x^2] - E[x]^2 and not
// Welford), y = (x - mean) * rsqrt(var + eps) * scale + bias, all in f32
// whatever the input type, and y stored in x's dtype.  scale and bias
// [D] may be f32 or bf16 (a serving model keeps them at its compute
// width); they are widened to f32 as the TPU kernel does.
//
// What bounds it on the card: bytes, and at a decode step latency.  Each
// row is read once and written once at a handful of FLOP per element (a
// 1024 x 2048 bf16 prefill dispatch moves 8.39 MB, 2.5 us at 3.35 TB/s);
// most of the serving path's launches are decode steps of 8 rows (64 KB),
// where the time is one trip to device memory and back.
//
// Design against that:
// - Layout by D and the dtype alone (ops/layernorm.py `kernel_layout`):
//   a row is split into chunks of V values, 16 bytes of x (8 bf16, 4 f32)
//   where the row's byte width allows it, else single values (V 1, e.g.
//   bf16 D 100); `lanes` threads share a row (a power of two), thread l
//   keeping chunks l, l + lanes, ... -- at most kLnValues f32 values.  At
//   D 2048 in bf16: 64 threads, 4 chunks of 8 values each.
// - One trip: each thread issues all its loads -- x, scale and bias, 16
//   bytes each (scale / bias in pieces of at most 16 bytes) -- before the
//   first reduction, and keeps the row in registers; the output pass
//   stores 16-byte chunks.  The single-value layout (odd widths, off the
//   serving path) reads scale and bias in the output pass instead: its
//   32 values a thread and their 64 parameters held through the
//   reductions spilled.
// - Reductions: the mean and the centred sum of squares are xor-butterfly
//   warp shuffles over the row's lanes; a row of more than 32 lanes adds
//   one shared-memory exchange per reduction (its warps' totals, summed in
//   warp order), so a block takes at most 2 barriers.
// - Rows per block: as few as fill a warp at small N (a decode step's
//   rows land on separate SMs), up to 256 threads at large N.  That
//   choice never changes how a row is reduced, so a row's bits do not
//   depend on how many rows share the call.
#include "common.cuh"

namespace tos {

constexpr int kLnBlock = 256;   // most threads a block
constexpr int kLnValues = 32;   // most f32 values of x a thread keeps

// The row's sum over its `lanes` threads (a power of two; rows of more
// than 32 lanes span whole warps).  Every thread of the block calls it.
__device__ __forceinline__ float row_sum(float x, float* red, int lanes) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < lanes) x += __shfl_xor_sync(0xffffffffu, x, o);
  if (lanes <= 32) return x;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  const int first = (threadIdx.x / lanes) * (lanes >> 5);
  float total = 0.f;
  for (int w = 0; w < (lanes >> 5); ++w) total += red[first + w];
  return total;
}

// The scale and bias values of the chunk at d, in NPC pieces of PV.
template <typename TP, int PV, int NPC>
__device__ __forceinline__ void load_params(const TP* __restrict__ scale,
                                            const TP* __restrict__ bias,
                                            int d, Pack<TP, PV> (&s)[NPC],
                                            Pack<TP, PV> (&b)[NPC]) {
#pragma unroll
  for (int p = 0; p < NPC; ++p) {
    s[p] = *reinterpret_cast<const Pack<TP, PV>*>(scale + d + p * PV);
    b[p] = *reinterpret_cast<const Pack<TP, PV>*>(bias + d + p * PV);
  }
}

// T: x's and y's type; TP: the scale / bias type; V: values a chunk.
template <typename T, typename TP, int V>
__global__ void __launch_bounds__(kLnBlock)
layernorm_kernel(const T* __restrict__ x, const TP* __restrict__ scale,
                 const TP* __restrict__ bias, T* __restrict__ y, int N,
                 int D, int lanes, float eps) {
  constexpr int NC = kLnValues / V;                 // most chunks a thread
  constexpr bool kEarly = V > 1;   // scale and bias loaded with x
  constexpr int PV = V * sizeof(TP) > 16 ? 16 / sizeof(TP) : V;
  constexpr int NPC = V / PV;                       // parameter pieces
  // one array per reduction: the second exchange needs no barrier
  // against readers of the first
  __shared__ float red[2][kLnBlock / 32];
  const int lane = threadIdx.x & (lanes - 1);
  const int row = blockIdx.x * (blockDim.x / lanes) + threadIdx.x / lanes;
  const int chunks = D / V;
  // this thread's chunks are lane, lane + lanes, ...: the first `mine`
  const int mine = row < N ? (chunks - lane + lanes - 1) / lanes : 0;
  const size_t base = size_t(row) * D;

  // Every load is unconditional, so all of them issue before the first
  // use: a chunk past the row reads the row's last chunk, a row past N
  // row N - 1, and neither is summed or stored.
  const size_t live = size_t(min(row, N - 1)) * D;
  Pack<T, V> raw[NC];
  Pack<TP, PV> s[NC][NPC], b[NC][NPC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int d = min(lane + i * lanes, chunks - 1) * V;
    raw[i] = *reinterpret_cast<const Pack<T, V>*>(x + live + d);
    if constexpr (kEarly)
      load_params<TP, PV, NPC>(scale, bias, d, s[i], b[i]);
  }
  float v[NC][V];
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int j = 0; j < V; ++j) v[i][j] = to_f32(raw[i].v[j]);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i)
    if (i < mine) {
#pragma unroll
      for (int j = 0; j < V; ++j) sum += v[i][j];
    }
  const float mean =
      __fdiv_rn(row_sum(sum, red[0], lanes), static_cast<float>(D));
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i)
    if (i < mine) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        v[i][j] -= mean;
        sq = fmaf(v[i][j], v[i][j], sq);
      }
    }
  const float var =
      __fdiv_rn(row_sum(sq, red[1], lanes), static_cast<float>(D));
  const float inv = rsqrtf(var + eps);
#pragma unroll
  for (int i = 0; i < NC; ++i)
    if (i < mine) {
      const int d = (lane + i * lanes) * V;
      if constexpr (!kEarly)
        load_params<TP, PV, NPC>(scale, bias, d, s[i], b[i]);
      Pack<T, V> out;
#pragma unroll
      for (int p = 0; p < NPC; ++p)
#pragma unroll
        for (int q = 0; q < PV; ++q)
          out.v[p * PV + q] = from_f32<T>(fmaf(v[i][p * PV + q] * inv,
                                               to_f32(s[i][p].v[q]),
                                               to_f32(b[i][p].v[q])));
      *reinterpret_cast<Pack<T, V>*>(y + base + d) = out;
    }
}

template <typename T, typename TP>
static int launch_layernorm(int N, int D, int vec, int lanes,
                            cudaStream_t st, const void* x,
                            const void* scale, const void* bias, void* y,
                            float eps) {
  constexpr int kV = 16 / sizeof(T);
  const bool wide = vec == kV;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(scale) |
                         reinterpret_cast<uintptr_t>(bias);
  if ((vec != 1 && !wide) || D % vec || lanes < 1 || lanes > kLnBlock ||
      (lanes & (lanes - 1)) ||
      (D / vec + lanes - 1) / lanes > kLnValues / vec || (wide && addr % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  // rows a block: enough to fill a warp, doubled while the grid keeps
  // two blocks an SM
  int rows = lanes >= 32 ? 1 : 32 / lanes;
  const int most = kLnBlock / lanes;
  while (rows < most && (N + 2 * rows - 1) / (2 * rows) >= 2 * sm_count())
    rows *= 2;
  const int grid = (N + rows - 1) / rows;
#define TOS_LN(VV)                                                         \
  layernorm_kernel<T, TP, VV><<<grid, rows * lanes, 0, st>>>(              \
      static_cast<const T*>(x), static_cast<const TP*>(scale),             \
      static_cast<const TP*>(bias), static_cast<T*>(y), N, D, lanes, eps)
  if (wide) TOS_LN(kV);
  else TOS_LN(1);
#undef TOS_LN
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tos

// x / y [N, D] in `dtype`; scale / bias [D] in `param_dtype`; `vec` and
// `lanes` the layout of ops/layernorm.py `kernel_layout`.
extern "C" int tos_layernorm(const void* x, const void* scale,
                             const void* bias, void* y, int N, int D,
                             int vec, int lanes, float eps, int dtype,
                             int param_dtype, void* stream) {
  using namespace tos;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 0) return static_cast<int>(cudaSuccess);
#define TOS_ARGS N, D, vec, lanes, st, x, scale, bias, y, eps
  if (dtype == kBF16 && param_dtype == kF32)
    return launch_layernorm<__nv_bfloat16, float>(TOS_ARGS);
  if (dtype == kBF16 && param_dtype == kBF16)
    return launch_layernorm<__nv_bfloat16, __nv_bfloat16>(TOS_ARGS);
  if (dtype == kF32 && param_dtype == kF32)
    return launch_layernorm<float, float>(TOS_ARGS);
  if (dtype == kF32 && param_dtype == kBF16)
    return launch_layernorm<float, __nv_bfloat16>(TOS_ARGS);
#undef TOS_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
