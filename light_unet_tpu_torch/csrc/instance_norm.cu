// Fused affine InstanceNorm + LeakyReLU over a channels-last [B, S, C]
// activation: y = leaky((x - mean) * rsqrt(var + eps) * scale + bias, slope).
//
// Replaces the Pallas TPU kernel light_unet_tpu/ops/pallas_kernels.py:_kernel
// (launched by _fused_in_leaky_pallas).  That kernel held one whole sample
// in VMEM and read it once; an SM's 227 KB cannot hold a 3.5 MB sample, so
// here the work is two passes over device memory:
//   1. in_stats_kernel: blocks over (spatial chunk, sample) reduce sum x and
//      sum x^2 per channel in float32 registers, then add them to a
//      [B, C, 2] float64 buffer with atomics;
//   2. in_apply_kernel: each thread derives (a, b) for its channels and
//      writes y = leaky(x * a + b) with 16-byte loads and stores along C.
// Bound on the card: memory bandwidth.  The function must read x once and
// write y once (4 flops per element); this design reads x twice, so its
// floor is 1.5x the bytes bound.  No TPU artefact is carried over: no lane
// packing (W*C = 768), no chunk picking, no one-hot fold, no VMEM gate, so
// every shape runs, the 6^3 x 128 bottleneck included.
#include "common.cuh"

template <typename T>
static cudaError_t run(const void* x, const float* scale, const float* bias, void* y,
                       double* stats, int B, long S, int C, float eps, float slope,
                       cudaStream_t s) {
  cudaError_t e = cudaMemsetAsync(stats, 0, sizeof(double) * 2 * B * C, s);
  if (e != cudaSuccess) return e;
  e = lu::launch_in_stats<T>(static_cast<const T*>(x), stats, B, S, C, s);
  if (e != cudaSuccess) return e;
  return lu::launch_in_apply<T>(static_cast<const T*>(x), stats, scale, bias,
                                static_cast<T*>(y), B, S, C, eps, slope, s);
}

extern "C" int instance_norm_leaky(const void* x, const void* scale, const void* bias, void* y,
                                   void* stats, int dtype, int B, int64_t S, int C, float eps,
                                   float slope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  double* st = static_cast<double*>(stats);
  if (dtype == lu::kBF16)
    return run<__nv_bfloat16>(x, sc, bi, y, st, B, S, C, eps, slope, s);
  if (dtype == lu::kF32) return run<float>(x, sc, bi, y, st, B, S, C, eps, slope, s);
  return cudaErrorInvalidValue;
}
