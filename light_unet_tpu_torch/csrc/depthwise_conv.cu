// Depthwise 3x3x3 convolution, inference forward, over a channels-last
// [B, D, H, W, C] activation (zero edge, stride 1, no bias):
//   y[b, d, h, w, c] = sum over kd, kh, kw of
//                      x[b, d + kd - 1, h + kh - 1, w + kw - 1, c] * w[c][kd][kh][kw]
// f32 FMAs in the order (kd, kh, kw), the output rounded once to the compute
// dtype T (bf16 or f32); the weights arrive as the float32 parameter
// [C, 1, 3, 3, 3] and are rounded to T on load, as the model's Conv3d rounds
// them: the function and rounding points of F.conv3d(groups=C) in T.
//
// Replaces no TPU kernel: the JAX package leaves this conv to XLA
// (light_unet_tpu/models/unet3d.py:DepthwiseSeparableConv, nn.Conv with
// feature_group_count = C).  Added because cuDNN has no fast 3-D depthwise
// algorithm: it runs these convs in its generic implicit_convolveNd_sgemm
// kernel at about 0.6 % of the byte bound, 76 % of the plain serving
// forward's device time.
//
// Bound on the card: bytes.  The conv reads each input element and writes
// each output element once (4 bytes an output in bf16 at 3.35 TB/s) and
// takes 27 f32 FMAs an output on the CUDA cores (67 TFLOP/s): the FMA time
// is about 2/3 of the byte time, so both count.  Design:
//   - vector path (C % 16 == 0): a CTA owns a TH x 8 tile of (h, w) and CG
//     channels (32 in bf16 when C allows, else 16) and marches along D, so
//     a tile's halo costs (TH + 2) * 10 / (TH * 8) in reads from L2, not
//     the cube of that.  Each input plane with its one-voxel halo is staged
//     in shared memory by 16-byte cp.async copies along C (zero-filled
//     outside the volume), two planes ahead in a ring of three, so each
//     input byte leaves device memory about once;
//   - a thread owns 2 channels x 8 voxels along W of one row, its 27 tap
//     pairs in registers; it reads each staged plane once (3 rows x 10
//     voxels) and adds it into three rolling accumulators, the outputs of
//     planes d - 1 (kd = 2), d (kd = 1) and d + 1 (kd = 0): 432 FMAs for 30
//     shared loads, no index arithmetic inside the tap loops (the plane
//     loop is unrolled by 3 so every accumulator index is a constant).
//     The output of plane d - 1 is then complete and stored; staged rows
//     carry one voxel of padding so a warp's loads hit distinct banks;
//   - scalar path (C == 1, the first block's conv1, and any C that is not a
//     multiple of 16): a thread owns 1 channel x 4 voxels along W, the
//     same march along D with float32 planes staged from registers loaded
//     one plane ahead; with C == 1 the loads are 16-byte vectors along W.
// The plan depends on the shape alone.  Nothing is allocated here and
// nothing is summed across threads, so every run gives the same bits.
#include "common.cuh"

namespace {

constexpr int kTW = 8;        // vector path: outputs along W a thread, and the tile's width
constexpr int kHW = kTW + 2;  // staged width (one-voxel halo each side)
constexpr int kRing = 3;      // staged planes of the vector path: two loads in flight
constexpr int kScalarThreads = 128;
constexpr int kRW = 4;        // scalar path: outputs along W a thread
constexpr int kSTW = 16;      // scalar path: the tile's width

template <int N> struct Int { static constexpr int value = N; };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two consecutive channels as floats, and back
__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ float2 ld_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st_pair(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);  // .x at the lower address
}
__device__ __forceinline__ void st_pair(float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; }

__device__ __forceinline__ void fma2(float2& acc, float2 v, float2 t) {
  acc.x = fmaf(v.x, t.x, acc.x);
  acc.y = fmaf(v.y, t.y, acc.y);
}

// The vector path's tile: CG channels (NP pairs) x TH rows x kTW columns.
template <typename T, int CG, int TH>
struct VecTile {
  static constexpr int NP = CG / 2;                     // threads along C
  static constexpr int NT = NP * TH;                    // threads
  static constexpr int V = 16 / (int)sizeof(T);         // elements of one 16-byte copy
  static constexpr int Q = CG / V;                      // copies a staged voxel
  static constexpr int ROW = (kHW + 1) * CG;            // elements of a staged row (+1 voxel pad)
  static constexpr int PLANE = (TH + 2) * ROW;          // elements of a staged plane
  static constexpr int UNITS = (TH + 2) * kHW * Q;      // copies a plane
};

// grid: one CTA per (sample, channel group, tile of rows, tile of columns)
template <typename T, int CG, int TH>
__global__ void __launch_bounds__(CG / 2 * TH, 384 / (CG / 2 * TH))
dw_vec(const T* __restrict__ x, const float* __restrict__ wt, T* __restrict__ y, int D, int H,
       int W, int C, int tiles_w, int tiles_hw, int groups) {
  using L = VecTile<T, CG, TH>;
  __shared__ __align__(16) unsigned char smem[kRing * L::PLANE * sizeof(T)];
  T* s = reinterpret_cast<T*>(smem);
  const int tid = threadIdx.x;
  const int tile = blockIdx.x % tiles_hw, bg = blockIdx.x / tiles_hw;
  const int b = bg / groups, c0 = (bg % groups) * CG;
  const int h0 = (tile / tiles_w) * TH, w0 = (tile % tiles_w) * kTW;
  const long plane = (long)H * W * C;
  const T* xs = x + (long)b * D * plane;
  T* ys = y + (long)b * D * plane;
  const int pair = tid % L::NP, r = tid / L::NP;

  float2 tap[27];  // tap kd*9 + kh*3 + kw of channels (c, c + 1), rounded to T
  {
    const float* w0p = wt + (long)(c0 + 2 * pair) * 27;
#pragma unroll
    for (int i = 0; i < 27; ++i)
      tap[i] = make_float2(lu::round_to<T>(__ldg(w0p + i)), lu::round_to<T>(__ldg(w0p + 27 + i)));
  }

  auto stage_plane = [&](int d) {  // plane d with its halo into slot d % kRing
    T* buf = s + (d % kRing) * L::PLANE;
    const T* xp = xs + (long)d * plane;
    for (int u = tid; u < L::UNITS; u += L::NT) {
      const int q = u % L::Q, rest = u / L::Q;
      const int ww = rest % kHW, hh = rest / kHW;
      const int h = h0 - 1 + hh, w = w0 - 1 + ww;
      const bool in = (unsigned)h < (unsigned)H && (unsigned)w < (unsigned)W;
      const T* src = in ? xp + (long)(h * W + w) * C + c0 + q * L::V : xs;
      cp_async16(buf + hh * L::ROW + ww * CG + q * L::V, src, in ? 16 : 0);
    }
  };

  float2 acc[3][kTW];  // rolling outputs: plane q lives in acc[q % 3]
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < kTW; ++j) acc[k][j] = make_float2(0.f, 0.f);

  auto store = [&](const float2 (&o)[kTW], int q) {
    const int h = h0 + r;
    if (h >= H) return;
    T* out = ys + ((long)(q * H + h) * W + w0) * C + c0 + 2 * pair;
#pragma unroll
    for (int j = 0; j < kTW; ++j)
      if (w0 + j < W) st_pair(out + (long)j * C, o[j]);
  };

  // plane d (its slot PH = d % 3 known at compile time): add it into the
  // outputs d - 1, d, d + 1, then store output d - 1, now complete
  auto step = [&](auto ph, int d) {
    constexpr int PH = decltype(ph)::value;
    if (d + 2 < D) stage_plane(d + 2);
    cp_async_commit();  // one group a step, empty or not, so wait<2> finds plane d
    cp_async_wait<2>();
    __syncthreads();
    float2(&prev)[kTW] = acc[(PH + 2) % 3];
    float2(&cur)[kTW] = acc[PH];
    float2(&next)[kTW] = acc[(PH + 1) % 3];
    const T* p = s + (d % kRing) * L::PLANE + r * L::ROW + 2 * pair;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      float2 v[kHW];
#pragma unroll
      for (int i = 0; i < kHW; ++i) v[i] = ld_pair(p + kh * L::ROW + i * CG);
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const float2 t0 = tap[kh * 3 + kw], t1 = tap[9 + kh * 3 + kw], t2 = tap[18 + kh * 3 + kw];
#pragma unroll
        for (int j = 0; j < kTW; ++j) {
          fma2(prev[j], v[j + kw], t2);
          fma2(cur[j], v[j + kw], t1);
          fma2(next[j], v[j + kw], t0);
        }
      }
    }
    if (d >= 1) store(prev, d - 1);
#pragma unroll
    for (int j = 0; j < kTW; ++j) prev[j] = make_float2(0.f, 0.f);
    __syncthreads();  // slot d % kRing is free for the copy of plane d + 3
  };

  stage_plane(0);
  cp_async_commit();
  if (D > 1) stage_plane(1);
  cp_async_commit();
  for (int d = 0; d < D; d += 3) {
    step(Int<0>{}, d);
    if (d + 1 < D) step(Int<1>{}, d + 1);
    if (d + 2 < D) step(Int<2>{}, d + 2);
  }
  const int last = (D - 1) % 3;  // plane D is zero: output D - 1 is complete
  if (last == 0) store(acc[0], D - 1);
  else if (last == 1) store(acc[1], D - 1);
  else store(acc[2], D - 1);
}

// The scalar path: CC channels (masked past C) x TH rows x kSTW columns;
// with VEC (C == 1, W a multiple of the vector width) 16-byte loads along W.
template <typename T, int CC, bool VEC>
struct ScalarTile {
  static constexpr int RUNS = kSTW / kRW;
  static constexpr int TH = kScalarThreads / (CC * RUNS);
  static constexpr int SW = kSTW + 2;                   // staged width
  static constexpr int ROW = SW * CC;                   // floats of a staged row
  static constexpr int PLANE = (TH + 2) * ROW;
  static constexpr int V = VEC ? 16 / (int)sizeof(T) : 1;
  static constexpr int UR = kSTW / V + 2;               // vector units a staged row
  static constexpr int UNITS = VEC ? (TH + 2) * UR : PLANE;
  static constexpr int K = (UNITS + kScalarThreads - 1) / kScalarThreads;  // units a thread
};

template <typename T, int CC, bool VEC>
__global__ void __launch_bounds__(kScalarThreads)
dw_scalar(const T* __restrict__ x, const float* __restrict__ wt, T* __restrict__ y, int D,
          int H, int W, int C, int tiles_w, int tiles_hw, int groups) {
  using L = ScalarTile<T, CC, VEC>;
  using lu::Vec;
  __shared__ __align__(16) float s[2 * L::PLANE];
  const int tid = threadIdx.x;
  const int tile = blockIdx.x % tiles_hw, bg = blockIdx.x / tiles_hw;
  const int b = bg / groups, c0 = (bg % groups) * CC;
  const int h0 = (tile / tiles_w) * L::TH, w0 = (tile % tiles_w) * kSTW;
  const long plane = (long)H * W * C;
  const T* xs = x + (long)b * D * plane;
  T* ys = y + (long)b * D * plane;
  const int ci = tid % CC, run = (tid / CC) % L::RUNS, r = tid / (CC * L::RUNS);
  const int c = c0 + ci;

  float tap[27];
#pragma unroll
  for (int i = 0; i < 27; ++i) tap[i] = c < C ? lu::round_to<T>(__ldg(wt + (long)c * 27 + i)) : 0.f;

  Vec<T, L::V> reg[L::K];  // plane d + 1 in flight while plane d computes
  auto load = [&](int d) {
    const T* xp = xs + (long)d * plane;
#pragma unroll
    for (int k = 0; k < L::K; ++k) {
      const int u = tid + k * kScalarThreads;
      bool in;
      long off;
      if (VEC) {
        const int hh = u / L::UR, w = w0 - L::V + (u % L::UR) * L::V, h = h0 - 1 + hh;
        in = u < L::UNITS && (unsigned)h < (unsigned)H && (unsigned)w < (unsigned)W;
        off = (long)h * W + w;
      } else {
        const int uc = u % CC, rest = u / CC, ww = rest % L::SW, hh = rest / L::SW;
        const int h = h0 - 1 + hh, w = w0 - 1 + ww;
        in = u < L::UNITS && (unsigned)h < (unsigned)H && (unsigned)w < (unsigned)W &&
             c0 + uc < C;
        off = (long)(h * W + w) * C + c0 + uc;
      }
      if (in) {
        reg[k] = *reinterpret_cast<const Vec<T, L::V>*>(xp + off);
      } else {
#pragma unroll
        for (int i = 0; i < L::V; ++i) reg[k].v[i] = lu::from_f<T>(0.f);
      }
    }
  };
  auto put = [&](float* buf) {
#pragma unroll
    for (int k = 0; k < L::K; ++k) {
      const int u = tid + k * kScalarThreads;
      if (u >= L::UNITS) continue;
      if (VEC) {  // keep the elements of columns w0 - 1 .. w0 + kSTW
        const int hh = u / L::UR, base = (u % L::UR - 1) * L::V + 1;
#pragma unroll
        for (int i = 0; i < L::V; ++i)
          if ((unsigned)(base + i) < (unsigned)L::SW) buf[hh * L::ROW + base + i] = lu::to_f<T>(reg[k].v[i]);
      } else {
        buf[u] = lu::to_f<T>(reg[k].v[0]);  // the staged layout [hh][ww][ci] is u's order
      }
    }
  };

  float acc[3][kRW];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < kRW; ++j) acc[k][j] = 0.f;

  auto store = [&](const float (&o)[kRW], int q) {
    const int h = h0 + r;
    if (h >= H || c >= C) return;
    const int w = w0 + run * kRW;
    T* out = ys + ((long)(q * H + h) * W + w) * C + c;
#pragma unroll
    for (int j = 0; j < kRW; ++j)
      if (w + j < W) out[(long)j * C] = lu::from_f<T>(o[j]);
  };

  auto step = [&](auto ph, int d) {
    constexpr int PH = decltype(ph)::value;
    if (d + 1 < D) load(d + 1);
    float(&prev)[kRW] = acc[(PH + 2) % 3];
    float(&cur)[kRW] = acc[PH];
    float(&next)[kRW] = acc[(PH + 1) % 3];
    const float* p = s + (d & 1) * L::PLANE + r * L::ROW + run * kRW * CC + ci;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      float v[kRW + 2];
#pragma unroll
      for (int i = 0; i < kRW + 2; ++i) v[i] = p[kh * L::ROW + i * CC];
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const float t0 = tap[kh * 3 + kw], t1 = tap[9 + kh * 3 + kw], t2 = tap[18 + kh * 3 + kw];
#pragma unroll
        for (int j = 0; j < kRW; ++j) {
          prev[j] = fmaf(v[j + kw], t2, prev[j]);
          cur[j] = fmaf(v[j + kw], t1, cur[j]);
          next[j] = fmaf(v[j + kw], t0, next[j]);
        }
      }
    }
    if (d >= 1) store(prev, d - 1);
#pragma unroll
    for (int j = 0; j < kRW; ++j) prev[j] = 0.f;
    if (d + 1 < D) put(s + ((d + 1) & 1) * L::PLANE);
    __syncthreads();
  };

  load(0);
  put(s);
  __syncthreads();
  for (int d = 0; d < D; d += 3) {
    step(Int<0>{}, d);
    if (d + 1 < D) step(Int<1>{}, d + 1);
    if (d + 2 < D) step(Int<2>{}, d + 2);
  }
  const int last = (D - 1) % 3;
  if (last == 0) store(acc[0], D - 1);
  else if (last == 1) store(acc[1], D - 1);
  else store(acc[2], D - 1);
}

long ceil_div(long a, long b) { return (a + b - 1) / b; }

template <typename K, typename T>
cudaError_t launch(K kern, long blocks, int threads, cudaStream_t s, const T* x, const float* w,
                   T* y, int D, int H, int W, int C, int tw, int thw, int groups) {
  if (blocks > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, threads, 0, s>>>(x, w, y, D, H, W, C, tw, thw, groups);
  return cudaGetLastError();
}

template <typename T, int CG, int TH>
cudaError_t run_vec(const T* x, const float* w, T* y, int B, int D, int H, int W, int C,
                    cudaStream_t s) {
  const int tw = (int)ceil_div(W, kTW), thw = (int)ceil_div(H, TH) * tw, groups = C / CG;
  return launch(&dw_vec<T, CG, TH>, (long)B * groups * thw, CG / 2 * TH, s, x, w, y, D, H, W,
                C, tw, thw, groups);
}

template <typename T, int CC, bool VEC>
cudaError_t run_scalar(const T* x, const float* w, T* y, int B, int D, int H, int W, int C,
                       cudaStream_t s) {
  using L = ScalarTile<T, CC, VEC>;
  const int tw = (int)ceil_div(W, kSTW), thw = (int)ceil_div(H, L::TH) * tw;
  const int groups = (int)ceil_div(C, CC);
  return launch(&dw_scalar<T, CC, VEC>, (long)B * groups * thw, kScalarThreads, s, x, w, y, D,
                H, W, C, tw, thw, groups);
}

// The plan, from the shape alone: the vector path where C % 16 == 0 (32
// channels a CTA in bf16 where C % 32 == 0, else 16 with rows of 16 where
// H is a multiple of 16 or above 32, else 8); else the scalar path, one
// channel a CTA with 16-byte loads along W for C == 1.
template <typename T>
cudaError_t run(const T* x, const float* w, T* y, int B, int D, int H, int W, int C,
                cudaStream_t s) {
  if (C % 16 == 0) {
    if constexpr (sizeof(T) == 2) {
      if (C % 32 == 0) return run_vec<T, 32, 8>(x, w, y, B, D, H, W, C, s);
    }
    if (H % 16 == 0 || H > 32) return run_vec<T, 16, 16>(x, w, y, B, D, H, W, C, s);
    return run_vec<T, 16, 8>(x, w, y, B, D, H, W, C, s);
  }
  if (C == 1) {
    if (W % (16 / (int)sizeof(T)) == 0) return run_scalar<T, 1, true>(x, w, y, B, D, H, W, C, s);
    return run_scalar<T, 1, false>(x, w, y, B, D, H, W, C, s);
  }
  return run_scalar<T, 8, false>(x, w, y, B, D, H, W, C, s);
}

// ---------------------------------------------------------------------------
// Depthwise 5x5x5 convolution with a per-channel bias, stride 1, zero edge
// (the block conv of MedNeXt, models/mednext.py):
//   y[b, d, h, w, c] = bias[c] + sum over kd, kh, kw in [0, 5) of
//                      x[b, d + kd - 2, h + kh - 2, w + kw - 2, c] * w[c][kd][kh][kw]
// f32 FMAs in the order (kd, kh, kw), the bias added last, the output rounded
// once to T; weights and bias arrive in float32 and are rounded to T on load:
// F.conv3d(groups=C) in float32 of the weight and bias rounded to T.  Replaces no TPU kernel
// (the JAX package has no MedNeXt); added because cuDNN's 3-D depthwise
// convolutions run far from either bound (see the 3x3x3 kernel above).
//
// Bound on the card: operations.  125 f32 FMAs an output on the CUDA cores
// (67 TFLOP/s) against 4 bytes an output in bf16 (3.35 TB/s): the FMA time is
// about 3x the byte time.  So the design keeps the FMA pipe fed and spends
// little on anything else:
//   - a thread owns one channel x 8 voxels along W of one row, its 125 taps
//     in registers, and marches along D with five rolling accumulators, the
//     outputs of planes d + 2 (kd = 0) .. d - 2 (kd = 4): each staged input
//     row (12 values) feeds 5 kw x 5 kd x 8 = 200 FMAs, so about 94 % of the
//     issued instructions are FMAs; after plane d the output d - 2 is
//     complete, stored, and the accumulators shift by one (40 moves a plane);
//   - lanes of a warp are consecutive channels, so a staged row's loads and
//     the output's stores are contiguous across the warp; a CTA owns CG
//     channels (32, 16 or 8, as C allows) x TH rows x 8 columns (TH * CG =
//     128 threads) and stages each input plane with its two-voxel halo in
//     shared memory by 16-byte cp.async copies along C, two planes ahead in
//     a ring of three (halo reads come from L2).
// Kernels are named dw5_* so that a trace tells them from the 3x3x3 ones.
// Nothing is allocated or summed across threads: every run gives the same bits.

constexpr int k5Taps = 125;
constexpr int k5Halo = 2;
constexpr int k5RW = 8;         // outputs along W a thread, and the tile's width
constexpr int k5Threads = 128;

template <typename T, int CG>
struct Dw5Tile {
  static constexpr int TH = k5Threads / CG;             // rows of the tile
  static constexpr int SH = TH + 2 * k5Halo;            // staged rows
  static constexpr int SW = k5RW + 2 * k5Halo;          // staged columns
  static constexpr int V = 16 / (int)sizeof(T);         // elements of one 16-byte copy
  static constexpr int Q = CG / V;                      // copies a staged voxel
  static constexpr int ROW = SW * CG;                   // elements of a staged row
  static constexpr int PLANE = SH * ROW;                // elements of a staged plane
  static constexpr int UNITS = SH * SW * Q;             // copies a plane
};

// grid: one CTA per (sample, channel group, tile of rows, tile of columns)
template <typename T, int CG>
__global__ void __launch_bounds__(k5Threads, 2)
dw5_vec(const T* __restrict__ x, const float* __restrict__ wt, const float* __restrict__ bias,
        T* __restrict__ y, int D, int H, int W, int C, int tiles_w, int tiles_hw, int groups) {
  using L = Dw5Tile<T, CG>;
  __shared__ __align__(16) unsigned char smem[kRing * L::PLANE * sizeof(T)];
  T* s = reinterpret_cast<T*>(smem);
  const int tid = threadIdx.x;
  const int tile = blockIdx.x % tiles_hw, bg = blockIdx.x / tiles_hw;
  const int b = bg / groups, c0 = (bg % groups) * CG;
  const int h0 = (tile / tiles_w) * L::TH, w0 = (tile % tiles_w) * k5RW;
  const long plane = (long)H * W * C;
  const T* xs = x + (long)b * D * plane;
  T* ys = y + (long)b * D * plane;
  const int ci = tid % CG, r = tid / CG;
  const int c = c0 + ci;

  float tap[k5Taps];  // tap kd*25 + kh*5 + kw of channel c, rounded to T
  {
    const float* wp = wt + (long)c * k5Taps;
#pragma unroll
    for (int i = 0; i < k5Taps; ++i) tap[i] = lu::round_to<T>(__ldg(wp + i));
  }
  const float b0 = bias ? lu::round_to<T>(__ldg(bias + c)) : 0.f;

  auto stage_plane = [&](int d) {  // plane d with its halo into slot d % kRing
    T* buf = s + (d % kRing) * L::PLANE;
    const T* xp = xs + (long)d * plane;
    for (int u = tid; u < L::UNITS; u += k5Threads) {
      const int q = u % L::Q, rest = u / L::Q;
      const int ww = rest % L::SW, hh = rest / L::SW;
      const int h = h0 - k5Halo + hh, w = w0 - k5Halo + ww;
      const bool in = (unsigned)h < (unsigned)H && (unsigned)w < (unsigned)W;
      const T* src = in ? xp + (long)(h * W + w) * C + c0 + q * L::V : xs;
      cp_async16(buf + hh * L::ROW + ww * CG + q * L::V, src, in ? 16 : 0);
    }
  };

  float acc[5][k5RW];  // acc[kd]: the output of plane d + 2 - kd
#pragma unroll
  for (int k = 0; k < 5; ++k)
#pragma unroll
    for (int j = 0; j < k5RW; ++j) acc[k][j] = 0.f;

  auto store_and_shift = [&](int q) {  // acc[4] is output q (stored if q >= 0)
    const int h = h0 + r;
    if (q >= 0 && h < H) {
      T* out = ys + ((long)(q * H + h) * W + w0) * C + c;
#pragma unroll
      for (int j = 0; j < k5RW; ++j)
        if (w0 + j < W) out[(long)j * C] = lu::from_f<T>(acc[4][j] + b0);
    }
#pragma unroll
    for (int j = 0; j < k5RW; ++j) {
      acc[4][j] = acc[3][j];
      acc[3][j] = acc[2][j];
      acc[2][j] = acc[1][j];
      acc[1][j] = acc[0][j];
      acc[0][j] = 0.f;
    }
  };

  stage_plane(0);
  cp_async_commit();
  if (D > 1) stage_plane(1);
  cp_async_commit();
  for (int d = 0; d < D; ++d) {
    if (d + 2 < D) stage_plane(d + 2);
    cp_async_commit();  // one group a plane, empty or not, so wait<2> finds plane d
    cp_async_wait<2>();
    __syncthreads();
    const T* p = s + (d % kRing) * L::PLANE + r * L::ROW + ci;
#pragma unroll
    for (int kh = 0; kh < 5; ++kh) {
      float v[k5RW + 2 * k5Halo];
#pragma unroll
      for (int i = 0; i < k5RW + 2 * k5Halo; ++i) v[i] = lu::to_f<T>(p[kh * L::ROW + i * CG]);
#pragma unroll
      for (int kw = 0; kw < 5; ++kw)
#pragma unroll
        for (int kd = 0; kd < 5; ++kd) {
          const float t = tap[kd * 25 + kh * 5 + kw];
#pragma unroll
          for (int j = 0; j < k5RW; ++j) acc[kd][j] = fmaf(v[j + kw], t, acc[kd][j]);
        }
    }
    store_and_shift(d - 2);  // plane d was output d - 2's last (kd = 4)
    __syncthreads();         // slot d % kRing is free for the copy of plane d + 3
  }
  store_and_shift(D - 2);  // planes D and D + 1 are zero: outputs D - 2, D - 1 are complete
  store_and_shift(D - 1);
}

template <typename T, int CG>
cudaError_t run5_vec(const T* x, const float* w, const float* bias, T* y, int B, int D, int H,
                     int W, int C, cudaStream_t s) {
  using L = Dw5Tile<T, CG>;
  const int tw = (int)ceil_div(W, k5RW), thw = (int)ceil_div(H, L::TH) * tw, groups = C / CG;
  const long blocks = (long)B * groups * thw;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  dw5_vec<T, CG><<<(unsigned)blocks, k5Threads, 0, s>>>(x, w, bias, y, D, H, W, C, tw, thw,
                                                        groups);
  return cudaGetLastError();
}

// The plan, from the shape alone: 32 channels a CTA where C % 32 == 0, else 16,
// else 8 (C % 8 == 0: a 16-byte copy holds whole channels of one voxel).
template <typename T>
cudaError_t run5(const T* x, const float* w, const float* bias, T* y, int B, int D, int H, int W,
                 int C, cudaStream_t s) {
  if (C % 32 == 0) return run5_vec<T, 32>(x, w, bias, y, B, D, H, W, C, s);
  if (C % 16 == 0) return run5_vec<T, 16>(x, w, bias, y, B, D, H, W, C, s);
  return run5_vec<T, 8>(x, w, bias, y, B, D, H, W, C, s);
}

}  // namespace

// x, y: [B, D, H, W, C] of dtype (x 16-byte aligned); w: float32 [C][27]
// (the parameter [C, 1, 3, 3, 3]).  Launches on stream; returns a
// cudaError_t.
extern "C" int depthwise_conv3d(const void* x, const void* w, void* y, int dtype, int B, int D,
                                int H, int W, int C, void* stream) {
  if (B < 1 || D < 1 || H < 1 || W < 1 || C < 1 || (long)H * W >= 0x7fffffffL ||
      (long)D * H >= 0x7fffffffL)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(y) % 16)
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  if (dtype == lu::kBF16)
    return run(static_cast<const __nv_bfloat16*>(x), wf, static_cast<__nv_bfloat16*>(y), B, D,
               H, W, C, s);
  if (dtype == lu::kF32)
    return run(static_cast<const float*>(x), wf, static_cast<float*>(y), B, D, H, W, C, s);
  return cudaErrorInvalidValue;
}

// x, y: [B, D, H, W, C] of dtype (x and y 16-byte aligned, C a multiple of
// 8); w: float32 [C][125] (the parameter [C, 1, 5, 5, 5]); bias: float32 [C]
// or null.  Launches on stream; returns a cudaError_t.
extern "C" int depthwise_conv3d_k5(const void* x, const void* w, const void* bias, void* y,
                                   int dtype, int B, int D, int H, int W, int C, void* stream) {
  if (B < 1 || D < 1 || H < 1 || W < 1 || C < 8 || C % 8 || (long)H * W >= 0x7fffffffL ||
      (long)D * H >= 0x7fffffffL)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(y) % 16)
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  if (dtype == lu::kBF16)
    return run5(static_cast<const __nv_bfloat16*>(x), wf, bf, static_cast<__nv_bfloat16*>(y), B,
                D, H, W, C, s);
  if (dtype == lu::kF32)
    return run5(static_cast<const float*>(x), wf, bf, static_cast<float*>(y), B, D, H, W, C, s);
  return cudaErrorInvalidValue;
}
