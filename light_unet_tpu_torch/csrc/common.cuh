// Shared pieces of the port's CUDA kernels: type helpers, vector loads,
// the InstanceNorm coefficients, and the InstanceNorm statistics and
// normalize + LeakyReLU apply passes that instance_norm.cu launches as the
// fused InstanceNorm + LeakyReLU kernel.
//
// Layout: a channels-last activation [B, S, C] (S = D*H*W spatial voxels),
// float32 or bfloat16.  Statistics are per (sample, channel): a [B, C, 2]
// float64 buffer of (sum x, sum x^2), filled with atomics by many blocks.
// float64 makes E[x^2] - mean^2 safe from cancellation at 48^3 = 110,592
// voxels; the atomics make the low bits of the sums depend on block order.
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

constexpr int kThreads = 256;
constexpr long kRowsPerBlock = 2048;

// Threads of a row-parallel pass: CV = C / V vector lanes per row, and
// enough rows in flight to make about kThreads threads.
inline int row_threads(int C, int V) {
  int cv = C / V;
  int k = cv >= kThreads ? 1 : kThreads / cv;
  return cv * k;
}

// Pass 1: per-(sample, channel) sum and sum of squares.  Grid (row chunks, B).
template <typename T, int V>
__global__ void in_stats_kernel(const T* __restrict__ x, double* __restrict__ stats,
                                long S, int C) {
  extern __shared__ float sh[];  // [2][blockDim.x][V]
  const int cv = C / V;
  const int k = blockDim.x / cv;
  const int lane = threadIdx.x % cv, r = threadIdx.x / cv;
  const int b = blockIdx.y;
  const long r0 = blockIdx.x * kRowsPerBlock;
  const long r1 = r0 + kRowsPerBlock < S ? r0 + kRowsPerBlock : S;
  const T* xb = x + (long)b * S * C + lane * V;
  float s1[V], s2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.f;
  for (long row = r0 + r; row < r1; row += k) {
    float f[V];
    load_vec<T, V>(xb + row * C, f);
#pragma unroll
    for (int j = 0; j < V; ++j) { s1[j] += f[j]; s2[j] += f[j] * f[j]; }
  }
  float* sh1 = sh;
  float* sh2 = sh + blockDim.x * V;
#pragma unroll
  for (int j = 0; j < V; ++j) { sh1[threadIdx.x * V + j] = s1[j]; sh2[threadIdx.x * V + j] = s2[j]; }
  __syncthreads();
  if (r == 0) {
    for (int j = 0; j < V; ++j) {
      double t1 = 0.0, t2 = 0.0;
      for (int rr = 0; rr < k; ++rr) {
        t1 += sh1[(rr * cv + lane) * V + j];
        t2 += sh2[(rr * cv + lane) * V + j];
      }
      double* st = stats + ((long)b * C + lane * V + j) * 2;
      atomicAdd(st, t1);
      atomicAdd(st + 1, t2);
    }
  }
}

// Pass 2: y = leaky(x * a + b, slope) in T.  y may alias x.
template <typename T, int V>
__global__ void in_apply_kernel(const T* x, const double* __restrict__ stats,
                                const float* __restrict__ scale, const float* __restrict__ bias,
                                T* y, long S, int C, float eps, float slope) {
  const int cv = C / V;
  const int k = blockDim.x / cv;
  const int lane = threadIdx.x % cv, r = threadIdx.x / cv;
  const int b = blockIdx.y;
  float a[V], bb[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    int c = lane * V + j;
    norm_coeffs(stats + ((long)b * C + c) * 2, scale[c], bias[c], (double)S, eps, &a[j], &bb[j]);
  }
  const long r0 = blockIdx.x * kRowsPerBlock;
  const long r1 = r0 + kRowsPerBlock < S ? r0 + kRowsPerBlock : S;
  const long base = (long)b * S * C + lane * V;
  for (long row = r0 + r; row < r1; row += k) {
    float f[V];
    load_vec<T, V>(x + base + row * C, f);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float v = f[j] * a[j] + bb[j];
      f[j] = v > 0.f ? v : slope * v;
    }
    store_vec<T, V>(y + base + row * C, f);
  }
}

inline dim3 row_grid(int B, long S) {
  return dim3((unsigned)((S + kRowsPerBlock - 1) / kRowsPerBlock), (unsigned)B);
}

// 16-byte vectors along C when C allows it (every tensor here is a fresh,
// 256-byte-aligned allocation, and rows start at multiples of C elements)
template <typename T> constexpr int vec_width() { return 16 / (int)sizeof(T); }

template <typename T>
cudaError_t launch_in_stats(const T* x, double* stats, int B, long S, int C, cudaStream_t s) {
  constexpr int VW = vec_width<T>();
  if (C % VW == 0) {
    int th = row_threads(C, VW);
    in_stats_kernel<T, VW><<<row_grid(B, S), th, 2 * th * VW * sizeof(float), s>>>(x, stats, S, C);
  } else {
    int th = row_threads(C, 1);
    in_stats_kernel<T, 1><<<row_grid(B, S), th, 2 * th * sizeof(float), s>>>(x, stats, S, C);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_in_apply(const T* x, const double* stats, const float* scale,
                            const float* bias, T* y, int B, long S, int C, float eps,
                            float slope, cudaStream_t s) {
  constexpr int VW = vec_width<T>();
  if (C % VW == 0) {
    in_apply_kernel<T, VW><<<row_grid(B, S), row_threads(C, VW), 0, s>>>(
        x, stats, scale, bias, y, S, C, eps, slope);
  } else {
    in_apply_kernel<T, 1><<<row_grid(B, S), row_threads(C, 1), 0, s>>>(
        x, stats, scale, bias, y, S, C, eps, slope);
  }
  return cudaGetLastError();
}

}  // namespace lu

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
