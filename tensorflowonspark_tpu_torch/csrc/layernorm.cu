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
// What bounds it on the card: bytes.  Each row is read once and written
// once at a handful of FLOP per element (a 1024 x 2048 bf16 prefill
// dispatch moves 8.39 MB, 2.5 us at 3.35 TB/s).
//
// Design against that bound: one block of 256 threads per row; thread t
// keeps elements t, t + 256, ... of the row in registers (8 of them at D
// 2048), so x is read from device memory once and the two statistics
// passes and the output pass run on registers.  The mean and the centred
// sum of squares are two block reductions in f32 (warp shuffles, then
// the 8 warp totals in shared memory).  Ragged N needs no padding (the
// TPU version pads N to its row block); D up to 8192 (32 values per
// thread) is handled by choosing the per-thread count at launch.
#include "common.cuh"

namespace tos {

constexpr int kLnThreads = 256;

__device__ __forceinline__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  x = warp_sum(x);
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kLnThreads / 32; ++w) total += red[w];
  return total;
}

// T: x's and y's type; TP: the scale / bias type; VPT: values per thread.
template <typename T, typename TP, int VPT>
__global__ void __launch_bounds__(kLnThreads)
layernorm_kernel(const T* __restrict__ x, const TP* __restrict__ scale,
                 const TP* __restrict__ bias, T* __restrict__ y, int D,
                 float eps) {
  __shared__ float red[kLnThreads / 32];
  const size_t base = size_t(blockIdx.x) * D;
  const int t = threadIdx.x;
  float v[VPT];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int d = t + i * kLnThreads;
    v[i] = d < D ? to_f32(x[base + d]) : 0.f;
    sum += v[i];
  }
  const float mean = __fdiv_rn(block_sum(sum, red), static_cast<float>(D));
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int d = t + i * kLnThreads;
    if (d < D) {
      v[i] -= mean;
      sq = fmaf(v[i], v[i], sq);
    }
  }
  const float var = __fdiv_rn(block_sum(sq, red), static_cast<float>(D));
  const float inv = rsqrtf(var + eps);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int d = t + i * kLnThreads;
    if (d < D)
      y[base + d] = from_f32<T>(
          fmaf(v[i] * inv, to_f32(scale[d]), to_f32(bias[d])));
  }
}

template <typename T, typename TP>
static int launch_layernorm(int N, int D, cudaStream_t st, const void* x,
                            const void* scale, const void* bias, void* y,
                            float eps) {
#define TOS_LN(V)                                                           \
  layernorm_kernel<T, TP, V><<<N, kLnThreads, 0, st>>>(                     \
      static_cast<const T*>(x), static_cast<const TP*>(scale),              \
      static_cast<const TP*>(bias), static_cast<T*>(y), D, eps)
  const int per = (D + kLnThreads - 1) / kLnThreads;
  if (per <= 1) TOS_LN(1);
  else if (per <= 2) TOS_LN(2);
  else if (per <= 4) TOS_LN(4);
  else if (per <= 8) TOS_LN(8);
  else if (per <= 16) TOS_LN(16);
  else if (per <= 32) TOS_LN(32);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef TOS_LN
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tos

// x / y [N, D] in `dtype`; scale / bias [D] in `param_dtype`.
extern "C" int tos_layernorm(const void* x, const void* scale,
                             const void* bias, void* y, int N, int D,
                             float eps, int dtype, int param_dtype,
                             void* stream) {
  using namespace tos;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 0) return static_cast<int>(cudaSuccess);
  if (dtype == kBF16 && param_dtype == kF32)
    return launch_layernorm<__nv_bfloat16, float>(N, D, st, x, scale, bias,
                                                  y, eps);
  if (dtype == kBF16 && param_dtype == kBF16)
    return launch_layernorm<__nv_bfloat16, __nv_bfloat16>(N, D, st, x, scale,
                                                          bias, y, eps);
  if (dtype == kF32 && param_dtype == kF32)
    return launch_layernorm<float, float>(N, D, st, x, scale, bias, y, eps);
  if (dtype == kF32 && param_dtype == kBF16)
    return launch_layernorm<float, __nv_bfloat16>(N, D, st, x, scale, bias,
                                                  y, eps);
  return static_cast<int>(cudaErrorInvalidValue);
}
