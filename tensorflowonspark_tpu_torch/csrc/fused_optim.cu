// Fused AdamW: the whole update of one parameter in one pass.
//
// Replaces the TPU kernel `_adamw_kernel` of tensorflowonspark_tpu/ops/
// fused_optim.py (reached through `_run_leaf`), which `adamw_fused` runs
// once per parameter leaf.
//
// Per element, in the TPU kernel's expression order:
//   g   = grad * clip
//   mu  = (1 - b1) g + b1 mu
//   nu  = (1 - b2) g^2 + b2 nu
//   upd = (mu / c1) / (sqrt(nu / c2) + eps) + wd p
//   p   = p - lr upd        (`apply`; `update` writes -lr upd instead)
// with the four step scalars [lr, clip, c1 = 1 - b1^t, c2 = 1 - b2^t] read
// from a device buffer, so no step waits on the host.  Products and sums
// use the _rn intrinsics, which the compiler never contracts into FMAs:
// every rounding then matches the plain PyTorch version's separate ops.
//
// Bound: bytes.  g, p, mu and nu are read once and p, mu and nu written
// once: 24 bytes a parameter with f32 g/p/nu and bf16 mu, 20.9 GB for the
// 0.87B flagship, 6.2 ms at 3.35 TB/s.  Design: a grid-stride loop over
// the leaf, one element per thread per iteration, coalesced; the update
// is in place (p, mu and nu are read and written by the same thread), as
// the JAX train step's donation recycles the same buffers.
#include "common.cuh"

namespace tos {

template <typename T, typename TM>
__global__ void __launch_bounds__(256)
adamw_kernel(const T* g, const T* p, const TM* mu, const T* nu, T* out,
             TM* mu_out, T* nu_out, const float* __restrict__ scalars,
             long long n, float b1, float one_minus_b1, float b2,
             float one_minus_b2, float eps, float wd, int write_param) {
  const float lr = scalars[0];
  const float clip = scalars[1];
  const float c1 = scalars[2];
  const float c2 = scalars[3];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float gi = __fmul_rn(to_f32(g[i]), clip);
    const float m = __fadd_rn(__fmul_rn(one_minus_b1, gi),
                              __fmul_rn(b1, to_f32(mu[i])));
    const float v = __fadd_rn(__fmul_rn(one_minus_b2, __fmul_rn(gi, gi)),
                              __fmul_rn(b2, to_f32(nu[i])));
    float upd = __fdiv_rn(__fdiv_rn(m, c1),
                          __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), eps));
    // the parameter is read only where it is used, as in the TPU kernel
    const float pi = (wd != 0.f || write_param) ? to_f32(p[i]) : 0.f;
    if (wd != 0.f) upd = __fadd_rn(upd, __fmul_rn(wd, pi));
    const float step = __fmul_rn(lr, upd);
    out[i] = from_f32<T>(write_param ? __fsub_rn(pi, step) : -step);
    mu_out[i] = from_f32<TM>(m);
    nu_out[i] = from_f32<T>(v);
  }
}

template <typename T, typename TM>
static int launch_adamw(const void* g, const void* p, void* mu, void* nu,
                        void* out, const float* scalars, long long n,
                        float b1, float omb1, float b2, float omb2, float eps,
                        float wd, int write_param, cudaStream_t st) {
  const long long blocks = (n + 255) / 256;
  const int grid = static_cast<int>(blocks < 4096 ? blocks : 4096);
  adamw_kernel<T, TM><<<grid, 256, 0, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(p),
      static_cast<const TM*>(mu), static_cast<const T*>(nu),
      static_cast<T*>(out), static_cast<TM*>(mu), static_cast<T*>(nu),
      scalars, n, b1, omb1, b2, omb2, eps, wd, write_param);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tos

// g, p, nu and out share `dtype`; mu has `mu_dtype`.  mu and nu are
// updated in place; `out` is p itself for `apply` or a fresh buffer for
// `update`.
extern "C" int tos_adamw(const void* g, const void* p, void* mu, void* nu,
                         void* out, const float* scalars, long long n,
                         float b1, float one_minus_b1, float b2,
                         float one_minus_b2, float eps, float wd,
                         int write_param, int dtype, int mu_dtype,
                         void* stream) {
  using namespace tos;
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && mu_dtype == kBF16)
    return launch_adamw<float, __nv_bfloat16>(g, p, mu, nu, out, scalars, n,
                                              b1, one_minus_b1, b2,
                                              one_minus_b2, eps, wd,
                                              write_param, st);
  if (dtype == kF32 && mu_dtype == kF32)
    return launch_adamw<float, float>(g, p, mu, nu, out, scalars, n, b1,
                                      one_minus_b1, b2, one_minus_b2, eps, wd,
                                      write_param, st);
  if (dtype == kBF16 && mu_dtype == kBF16)
    return launch_adamw<__nv_bfloat16, __nv_bfloat16>(
        g, p, mu, nu, out, scalars, n, b1, one_minus_b1, b2, one_minus_b2,
        eps, wd, write_param, st);
  if (dtype == kBF16 && mu_dtype == kF32)
    return launch_adamw<__nv_bfloat16, float>(g, p, mu, nu, out, scalars, n,
                                              b1, one_minus_b1, b2,
                                              one_minus_b2, eps, wd,
                                              write_param, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
