// Shared pieces of the port's CUDA kernels: type helpers, vector loads and
// stores, and the InstanceNorm coefficients.
//
// Layout: a channels-last activation [B, S, C] (S = D*H*W spatial voxels),
// float32 or bfloat16.  Statistics are per (sample, channel) pairs (sum x,
// sum x^2) in float64, which makes E[x^2] - mean^2 safe from cancellation at
// 48^3 = 110,592 voxels.  How the sums are gathered across CTAs is each
// kernel's own: instance_norm.cu in a fixed order (bit-identical from run to
// run), residual_block.cu with atomics (low bits depend on the CTAs' order).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace lu {

enum DType : int { kF32 = 0, kBF16 = 1 };

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round a float32 value to T and back (the compute dtype's rounding point)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

// V consecutive elements, aligned so V*sizeof(T) == 16 becomes one 16-byte access
template <typename T, int V> struct alignas(sizeof(T) * V) Vec { T v[V]; };

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  Vec<T, V> r = *reinterpret_cast<const Vec<T, V>*>(p);
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = to_f<T>(r.v[j]);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  Vec<T, V> r;
#pragma unroll
  for (int j = 0; j < V; ++j) r.v[j] = from_f<T>(in[j]);
  *reinterpret_cast<Vec<T, V>*>(p) = r;
}

// y = x * a + b with (a, b) from the (sum, sum of squares) of n values:
// biased variance E[x^2] - mean^2 clamped at 0, as the TPU kernel computes it
__device__ __forceinline__ void norm_coeffs(const double* st, float scale, float bias,
                                            double n, float eps, float* a, float* b) {
  double mean = st[0] / n;
  double var = st[1] / n - mean * mean;
  if (var < 0.0) var = 0.0;
  float rstd = rsqrtf(static_cast<float>(var) + eps);
  *a = rstd * scale;
  *b = bias - static_cast<float>(mean) * (*a);
}

// 16-byte vectors along C when C allows it (every tensor here is a fresh,
// 256-byte-aligned allocation, and rows start at multiples of C elements)
template <typename T> constexpr int vec_width() { return 16 / (int)sizeof(T); }

}  // namespace lu

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
