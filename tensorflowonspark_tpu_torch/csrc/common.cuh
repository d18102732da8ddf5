// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel is bound through a plain C entry point (ctypes, see
// ops/_build.py): tensors arrive as raw device pointers, the stream as
// an opaque pointer, and each entry returns cudaGetLastError() so the
// Python wrapper raises on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tos {

// Same large-finite mask value as the JAX kernels: exp(NEG_INF - m) == 0
// without inf - inf NaNs.
constexpr float NEG_INF = -1e30f;

// dtype codes shared with the Python wrappers (ops/_build.py DTYPES).
// kI8 is a storage type only: int8 kv pools, whose f32 scales travel
// beside them.
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// N consecutive elements of T as they lie in memory, moved in one
// transaction of N * sizeof(T) bytes (at most 16): the base must be
// aligned to that size.
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// Load N consecutive elements starting at p (N * sizeof(T) aligned) as
// f32: one 8- or 16-byte transaction per call for the widths the kernels
// use, a scalar loop otherwise.
template <typename T, int N>
struct VecLoad {
  __device__ __forceinline__ static void run(const T* p, float* out) {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(p[i]);
  }
};

template <>
struct VecLoad<float, 4> {
  __device__ __forceinline__ static void run(const float* p, float* out) {
    float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

template <>
struct VecLoad<float, 2> {
  __device__ __forceinline__ static void run(const float* p, float* out) {
    float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  }
};

template <>
struct VecLoad<__nv_bfloat16, 4> {
  __device__ __forceinline__ static void run(const __nv_bfloat16* p,
                                             float* out) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&raw.x);
    __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&raw.y);
    float2 fa = __bfloat1622float2(a);
    float2 fb = __bfloat1622float2(b);
    out[0] = fa.x; out[1] = fa.y; out[2] = fb.x; out[3] = fb.y;
  }
};

template <>
struct VecLoad<__nv_bfloat16, 2> {
  __device__ __forceinline__ static void run(const __nv_bfloat16* p,
                                             float* out) {
    __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(p);
    float2 fa = __bfloat1622float2(a);
    out[0] = fa.x; out[1] = fa.y;
  }
};

// int8 kv payloads: 4 or 2 consecutive values in one 32- or 16-bit load.
template <>
struct VecLoad<int8_t, 4> {
  __device__ __forceinline__ static void run(const int8_t* p, float* out) {
    char4 v = *reinterpret_cast<const char4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

template <>
struct VecLoad<int8_t, 2> {
  __device__ __forceinline__ static void run(const int8_t* p, float* out) {
    char2 v = *reinterpret_cast<const char2*>(p);
    out[0] = v.x; out[1] = v.y;
  }
};

// The card's SM count (read once), for launches that size their blocks
// to fill it.
inline int sm_count() {
  static const int n = [] {
    int dev = 0, count = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Reductions over the 16 lanes of a half warp (lanes 0-15 or 16-31).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace tos
