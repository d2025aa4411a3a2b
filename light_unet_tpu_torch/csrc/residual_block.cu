// One whole inference ResidualBlock of the U-Net over a channels-last
// [B, D, H, W, Cin] activation:
//   h  = pw1(dw1(x))                      depthwise 3x3x3 (zero edge), pointwise 1x1x1
//   g  = leaky(IN1(h), 0.01)
//   h2 = pw2(dw2(g))
//   out = leaky(IN2(h2) + residual, 0.01)  residual = x, or IN_s(sc(x)) (1x1x1 projection)
// f32 accumulation, every intermediate rounded to the compute dtype, norm
// statistics in f32/f64 from the rounded values, eps as given.
//
// Replaces the Pallas TPU kernel light_unet_tpu/ops/pallas_block.py:_block_kernel
// (launched by _fused_block_call).  That kernel kept a whole sample resident
// in VMEM (up to ~11 MB) and touched device memory once for x and once for
// the output.  One 48^3 x 16 bf16 sample is 3.5 MB, far above an SM's
// 227 KB, so this design tiles space and makes four passes:
//   (a) dwpw_kernel: a block computes a TDxTHxTW tile of one sample for all
//       output channels.  It stages the input tile + 1-voxel halo in shared
//       memory CK channels at a time, runs the 27-tap depthwise in f32,
//       rounds, then the Cin->C pointwise as an FMA loop with the weights in
//       shared memory, rounds and stores h, and adds per-channel sum / sum of
//       squares of the rounded values to float64 statistics (for a
//       projection block also those of the shortcut conv of x);
//   (b) the apply pass of the InstanceNorm kernel (common.cuh), in place: g;
//   (c) dwpw_kernel again on g: h2 and its statistics;
//   (d) block_out_kernel: norm2 + residual (x, or the shortcut pointwise
//       recomputed from x and normalised) + LeakyReLU.
// Bound on the card: the whole block must read x and write out once; this
// design also writes and reads h and h2 (about 4 extra activation passes),
// and the pointwise FMA loops read both operands from shared memory, so
// large-Cin blocks are bound by shared-memory bandwidth, not by device
// memory.  wgmma for the pointwise product, TMA tiles and pipelining are
// left for later work.  TPU artefacts are not carried over: no H padding to
// 8, no lane padding for Cin = 1, no block-diagonal kron pointwise matrix
// and no VMEM gate, so every shape and float32 run.
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr float kLeaky = 0.01f;
constexpr int kConvThreads = 256;

struct Tile {
  int td, th, tw, ck;
};

size_t conv_smem_floats(int Cin, int C, bool sc, Tile t) {
  size_t nv = (size_t)t.td * t.th * t.tw;
  size_t nh = (size_t)(t.td + 2) * (t.th + 2) * (t.tw + 2);
  int k = sc ? 2 : 1;
  return (size_t)Cin * C * k + 27 * (size_t)Cin + nh * t.ck + nv * Cin * k + 2 * k * (size_t)C;
}

template <typename T>
__global__ void __launch_bounds__(kConvThreads)
dwpw_kernel(const T* __restrict__ x, const float* __restrict__ dw, const float* __restrict__ pw,
            const float* __restrict__ sc, T* __restrict__ out, double* __restrict__ stats,
            double* __restrict__ stats_sc, int D, int H, int W, int Cin, int C, Tile t) {
  extern __shared__ float sm[];
  const bool has_sc = sc != nullptr;
  const int nv = t.td * t.th * t.tw;
  const int hh = t.th + 2, hw = t.tw + 2;
  const int nh = (t.td + 2) * hh * hw;
  float* s_pw = sm;                                  // [Cin][C]
  float* s_sc = s_pw + Cin * C;                      // [Cin][C] (projection only)
  float* s_dw = s_sc + (has_sc ? Cin * C : 0);       // [27][Cin]
  float* s_halo = s_dw + 27 * Cin;                   // [nh][ck]
  float* s_dwo = s_halo + nh * t.ck;                 // [nv][Cin] rounded depthwise output
  float* s_xc = s_dwo + nv * Cin;                    // [nv][Cin] x at the tile (projection only)
  float* s_st = s_xc + (has_sc ? nv * Cin : 0);      // [4][C] sums

  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.y;
  const int ntw = (W + t.tw - 1) / t.tw, nth = (H + t.th - 1) / t.th;
  int tile = blockIdx.x;
  const int w0 = (tile % ntw) * t.tw;
  tile /= ntw;
  const int h0 = (tile % nth) * t.th;
  const int d0 = (tile / nth) * t.td;
  const T* xb = x + (long)b * D * H * W * Cin;

  for (int i = tid; i < Cin * C; i += nt) {
    s_pw[i] = pw[i];
    if (has_sc) s_sc[i] = sc[i];
  }
  for (int i = tid; i < 27 * Cin; i += nt) s_dw[i] = dw[i];
  for (int i = tid; i < (has_sc ? 4 : 2) * C; i += nt) s_st[i] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += t.ck) {
    const int ck = min(t.ck, Cin - c0);
    __syncthreads();  // the previous chunk's halo is consumed
    for (int i = tid; i < nh * ck; i += nt) {
      const int cc = i % ck, hv = i / ck;
      const int iw = hv % hw, ih = (hv / hw) % hh, id = hv / (hw * hh);
      const int gd = d0 + id - 1, gh = h0 + ih - 1, gw = w0 + iw - 1;
      float v = 0.f;
      if (gd >= 0 && gd < D && gh >= 0 && gh < H && gw >= 0 && gw < W)
        v = lu::to_f<T>(xb[(((long)gd * H + gh) * W + gw) * Cin + c0 + cc]);
      s_halo[hv * t.ck + cc] = v;
    }
    __syncthreads();
    for (int i = tid; i < nv * ck; i += nt) {
      const int cc = i % ck, v = i / ck;
      const int vw = v % t.tw, vh = (v / t.tw) % t.th, vd = v / (t.tw * t.th);
      const float* wt = s_dw + c0 + cc;
      float acc = 0.f;
#pragma unroll
      for (int kd = 0; kd < 3; ++kd)
#pragma unroll
        for (int kh = 0; kh < 3; ++kh)
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
            acc += s_halo[(((vd + kd) * hh + vh + kh) * hw + vw + kw) * t.ck + cc] *
                   wt[((kd * 3 + kh) * 3 + kw) * Cin];
      s_dwo[v * Cin + c0 + cc] = lu::round_to<T>(acc);
      if (has_sc) s_xc[v * Cin + c0 + cc] = s_halo[(((vd + 1) * hh + vh + 1) * hw + vw + 1) * t.ck + cc];
    }
  }
  __syncthreads();

  for (int i = tid; i < nv * C; i += nt) {
    const int co = i % C, v = i / C;
    const int gw = w0 + v % t.tw, gh = h0 + (v / t.tw) % t.th, gd = d0 + v / (t.tw * t.th);
    if (gd >= D || gh >= H || gw >= W) continue;
    const float* dv = s_dwo + v * Cin;
    float acc = 0.f;
    for (int ci = 0; ci < Cin; ++ci) acc += dv[ci] * s_pw[ci * C + co];
    const T q = lu::from_f<T>(acc);
    out[(((long)b * D + gd) * H + gh) * W * C + (long)gw * C + co] = q;
    const float r = lu::to_f<T>(q);
    atomicAdd(&s_st[co], r);
    atomicAdd(&s_st[C + co], r * r);
    if (has_sc) {
      const float* xv = s_xc + v * Cin;
      float a2 = 0.f;
      for (int ci = 0; ci < Cin; ++ci) a2 += xv[ci] * s_sc[ci * C + co];
      const float r2 = lu::round_to<T>(a2);
      atomicAdd(&s_st[2 * C + co], r2);
      atomicAdd(&s_st[3 * C + co], r2 * r2);
    }
  }
  __syncthreads();
  for (int c = tid; c < C; c += nt) {
    double* st = stats + ((long)b * C + c) * 2;
    atomicAdd(st, (double)s_st[c]);
    atomicAdd(st + 1, (double)s_st[C + c]);
    if (has_sc) {
      double* ss = stats_sc + ((long)b * C + c) * 2;
      atomicAdd(ss, (double)s_st[2 * C + c]);
      atomicAdd(ss + 1, (double)s_st[3 * C + c]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kConvThreads)
block_out_kernel(const T* __restrict__ h2, const T* __restrict__ x,
                 const double* __restrict__ st2, const float* __restrict__ n2s,
                 const float* __restrict__ n2b, const float* __restrict__ sc,
                 const double* __restrict__ st_s, const float* __restrict__ nss,
                 const float* __restrict__ nsb, T* __restrict__ out, long S, int Cin, int C,
                 int nvb, float eps) {
  extern __shared__ float sm[];
  const bool has_sc = sc != nullptr;
  float* s_a2 = sm;
  float* s_b2 = sm + C;
  float* s_as = sm + 2 * C;
  float* s_bs = sm + 3 * C;
  float* s_sc = sm + 4 * C;                     // [Cin][C] (projection only)
  float* s_x = s_sc + (has_sc ? Cin * C : 0);   // [nvb][Cin] (projection only)
  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.y;
  const long v0 = (long)blockIdx.x * nvb;
  for (int c = tid; c < C; c += nt) {
    lu::norm_coeffs(st2 + ((long)b * C + c) * 2, n2s[c], n2b[c], (double)S, eps, &s_a2[c], &s_b2[c]);
    if (has_sc)
      lu::norm_coeffs(st_s + ((long)b * C + c) * 2, nss[c], nsb[c], (double)S, eps, &s_as[c], &s_bs[c]);
  }
  if (has_sc) {
    for (int i = tid; i < Cin * C; i += nt) s_sc[i] = sc[i];
    for (int i = tid; i < nvb * Cin; i += nt) {
      const long s = v0 + i / Cin;
      s_x[i] = s < S ? lu::to_f<T>(x[((long)b * S + s) * Cin + i % Cin]) : 0.f;
    }
  }
  __syncthreads();
  for (int i = tid; i < nvb * C; i += nt) {
    const int co = i % C, v = i / C;
    const long s = v0 + v;
    if (s >= S) continue;
    const long o = ((long)b * S + s) * C + co;
    const float y = lu::round_to<T>(lu::to_f<T>(h2[o]) * s_a2[co] + s_b2[co]);
    float res;
    if (has_sc) {
      const float* xv = s_x + v * Cin;
      float acc = 0.f;
      for (int ci = 0; ci < Cin; ++ci) acc += xv[ci] * s_sc[ci * C + co];
      res = lu::round_to<T>(lu::round_to<T>(acc) * s_as[co] + s_bs[co]);
    } else {
      res = lu::to_f<T>(x[((long)b * S + s) * Cin + co]);
    }
    const float z = y + res;
    out[o] = lu::from_f<T>(z > 0.f ? z : kLeaky * z);
  }
}

int max_smem_optin() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}

template <typename T>
cudaError_t launch_conv(const T* x, const float* dw, const float* pw, const float* sc, T* out,
                        double* stats, double* stats_sc, int B, int D, int H, int W, int Cin,
                        int C, cudaStream_t s) {
  // the largest tile whose shared memory leaves room for two blocks per SM,
  // else the largest that fits at all
  const Tile cands[] = {{4, 8, 8, 16}, {4, 4, 8, 16}, {4, 4, 4, 16},
                        {2, 4, 4, 8},  {2, 2, 4, 8},  {1, 2, 4, 4}};
  const size_t limit = (size_t)max_smem_optin();
  const bool has_sc = sc != nullptr;
  Tile t{0, 0, 0, 0};
  size_t bytes = 0;
  for (size_t budget : {(size_t)100 * 1024, limit}) {
    for (Tile c : cands) {
      c.ck = c.ck < Cin ? c.ck : Cin;
      size_t nb = conv_smem_floats(Cin, C, has_sc, c) * sizeof(float);
      if (nb <= budget) { t = c; bytes = nb; break; }
    }
    if (bytes) break;
  }
  if (!bytes) return cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(dwpw_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const unsigned tiles = (unsigned)(((D + t.td - 1) / t.td) * ((H + t.th - 1) / t.th) *
                                    ((W + t.tw - 1) / t.tw));
  dwpw_kernel<T><<<dim3(tiles, B), kConvThreads, bytes, s>>>(x, dw, pw, sc, out, stats, stats_sc,
                                                             D, H, W, Cin, C, t);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_out(const T* h2, const T* x, const double* st2, const float* n2s,
                       const float* n2b, const float* sc, const double* st_s, const float* nss,
                       const float* nsb, T* out, int B, long S, int Cin, int C, float eps,
                       cudaStream_t s) {
  const bool has_sc = sc != nullptr;
  const int nvb = has_sc ? 32 : 256;
  const size_t bytes = (4 * (size_t)C + (has_sc ? (size_t)Cin * C + (size_t)nvb * Cin : 0)) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(block_out_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const unsigned blocks = (unsigned)((S + nvb - 1) / nvb);
  block_out_kernel<T><<<dim3(blocks, B), kConvThreads, bytes, s>>>(
      h2, x, st2, n2s, n2b, sc, st_s, nss, nsb, out, S, Cin, C, nvb, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const T* x, const float* dw1, const float* pw1, const float* n1s,
                const float* n1b, const float* dw2, const float* pw2, const float* n2s,
                const float* n2b, const float* sc, const float* nss, const float* nsb, T* h,
                T* h2, T* out, double* stats, int B, int D, int H, int W, int Cin, int C,
                float eps, cudaStream_t s) {
  const long S = (long)D * H * W;
  double* st1 = stats;
  double* st_s = stats + 2L * B * C;
  double* st2 = stats + 4L * B * C;
  cudaError_t e = cudaMemsetAsync(stats, 0, sizeof(double) * 6L * B * C, s);
  if (e != cudaSuccess) return e;
  e = launch_conv<T>(x, dw1, pw1, sc, h, st1, st_s, B, D, H, W, Cin, C, s);
  if (e != cudaSuccess) return e;
  e = lu::launch_in_apply<T>(h, st1, n1s, n1b, h, B, S, C, eps, kLeaky, s);
  if (e != cudaSuccess) return e;
  e = launch_conv<T>(h, dw2, pw2, nullptr, h2, st2, nullptr, B, D, H, W, C, C, s);
  if (e != cudaSuccess) return e;
  return launch_out<T>(h2, x, st2, n2s, n2b, sc, st_s, nss, nsb, out, B, S, Cin, C, eps, s);
}

}  // namespace

// Weights are float32 holding compute-dtype values: dw [27][Cin] and [27][C]
// (tap index kd*9 + kh*3 + kw), pw/sc [Cin][C] and [C][C]; norm scale/bias [C].
// sc, nss, nsb are null for an identity block (Cin == C).  h, h2: [B, S, C]
// scratch; stats: [3][B][C][2] float64 scratch.
extern "C" int residual_block(const void* x, const void* dw1, const void* pw1, const void* n1s,
                              const void* n1b, const void* dw2, const void* pw2, const void* n2s,
                              const void* n2b, const void* sc, const void* nss, const void* nsb,
                              void* h, void* h2, void* out, void* stats, int dtype, int B, int D,
                              int H, int W, int Cin, int C, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  double* st = static_cast<double*>(stats);
  if (dtype == lu::kBF16) {
    using T = __nv_bfloat16;
    return run<T>(static_cast<const T*>(x), f(dw1), f(pw1), f(n1s), f(n1b), f(dw2), f(pw2),
                  f(n2s), f(n2b), f(sc), f(nss), f(nsb), static_cast<T*>(h), static_cast<T*>(h2),
                  static_cast<T*>(out), st, B, D, H, W, Cin, C, eps, s);
  }
  if (dtype == lu::kF32) {
    return run<float>(static_cast<const float*>(x), f(dw1), f(pw1), f(n1s), f(n1b), f(dw2),
                      f(pw2), f(n2s), f(n2b), f(sc), f(nss), f(nsb), static_cast<float*>(h),
                      static_cast<float*>(h2), static_cast<float*>(out), st, B, D, H, W, Cin, C,
                      eps, s);
  }
  return cudaErrorInvalidValue;
}
