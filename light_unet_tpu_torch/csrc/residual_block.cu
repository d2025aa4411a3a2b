// One whole inference ResidualBlock of the U-Net over a channels-last
// [B, D, H, W, Cin] activation:
//   h  = pw1(dw1(x))                      depthwise 3x3x3 (zero edge), pointwise 1x1x1
//   g  = leaky(IN1(h), 0.01)
//   h2 = pw2(dw2(g))
//   out = leaky(IN2(h2) + residual, 0.01)  residual = x, or IN_s(sc(x)) (1x1x1 projection)
// f32 accumulation, every intermediate rounded to the compute dtype, norm
// statistics from the rounded values (biased variance, eps as given).
//
// Replaces the Pallas TPU kernel light_unet_tpu/ops/pallas_block.py:_block_kernel
// (launched by _fused_block_call).  That kernel kept a whole sample resident
// in VMEM; one 48^3 x 16 bf16 sample (3.5 MB) is far above an SM's 227 KB,
// so this design tiles space into TD x TH x 8 voxel tiles (one CTA each,
// 128 threads) and makes three launches per block:
//   conv1  h = pw1(dw1(x)) and the statistics of h (and of sc(x));
//   conv2  h2 = pw2(dw2(g)) and its statistics, where g = leaky(IN1(h)) is
//          applied while the halo is staged (norm1 fused into conv2's load:
//          the zero edge stays 0 in g-space, as the TPU kernel's rd_g);
//   out    leaky(IN2(h2) + residual), the shortcut product recomputed from x.
// Design of a conv launch on the tensor-core path (bf16, Cin and C in
// {16, 32, 64, 128}):
//   - the input tile and its one-voxel halo are staged in bf16, 16 channels
//     at a time, with 16-byte cp.async loads (zero-filled outside the
//     volume), double-buffered so chunk k+1 loads while chunk k computes
//     (one buffer when Cin is a single chunk);
//   - a depthwise job is one (d, h) row of 8 voxels x 2 channels: each halo
//     value loaded feeds its 3 kw taps from registers, f32 FMA, and no index
//     arithmetic runs inside the tap loops; halo rows are padded so a warp's
//     loads hit distinct banks;
//   - the rounded depthwise tile A [M][Cin] lands in shared memory in an XOR
//     swizzled layout, read by ldmatrix without bank conflicts; the pointwise
//     products (and the shortcut's) run as mma.sync.m16n8k16 bf16 with f32
//     accumulation (exact products, f32 sums: the lax path's rounding points),
//     the weights pre-packed in fragment order by the wrapper; the
//     shortcut's A is x itself, read by ldmatrix from the halo buffers when
//     Cin <= 32 (both chunks are still there), else copied beside A;
//   - the norm statistics come from the rounded accumulator fragments in
//     registers, a warp-shuffle reduction over voxels, shared memory across
//     the 4 warps, and one float64 atomicAdd per CTA and channel.
// Each conv launch picks its tile (TD x TH x 8) at launch from a cost model
// (plan_conv): thread slots of the depthwise jobs plus staged halo, over the
// CTAs that shared memory lets reside on an SM (up to 3 counted).
// Other shapes and float32 (where tensor cores would compute in TF32) take
// the CUDA-core path: the same tiles and launches, scalar halo staging,
// f32 FMA pointwise products, statistics in per-thread registers reduced
// through shared memory, one float64 atomicAdd per CTA and channel.
// Bound on the card: at the 48^3 blocks the depthwise taps on the CUDA cores
// (f32 FMA, 67 TFLOP/s); the function must read x and write out once, this
// design makes about 7 activation passes through device memory (x, h, g's
// source h, h2, x again, out).  Float sums across CTAs are taken with
// atomics, so their low bits depend on the CTAs' order from run to run.
#include "common.cuh"

namespace {

constexpr float kLeaky = 0.01f;
constexpr int kThreads = 128;                // 4 warps per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kTW = 8;                       // tile width along W = voxels per depthwise job
constexpr int kHW = kTW + 2;                 // halo width
constexpr int kCK = 16;                      // channels per halo chunk on the tensor-core path
constexpr int kRowBytes = kHW * kCK * 2 + 32;  // one halo row (10 voxels x 16 bf16), padded
constexpr int kOutRows = 64;                 // voxels per CTA of the output pass

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

// n / d for 0 <= n < 2^20 from a float reciprocal: (n + 0.5) / d lies at
// least 0.5 / d from an integer, far above the float error
__device__ __forceinline__ int div_small(int n, float inv_d) {
  return __float2int_rz((n + 0.5f) * inv_d);
}

__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float leaky(float v) { return v > 0.f ? v : kLeaky * v; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// D += A (16x16 bf16, row) * B (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// XOR swizzle of a [rows][Cin] bf16 tile at 16-byte granularity, so the 8
// rows an ldmatrix phase reads sit in 8 distinct bank groups.  Cin in
// {16, 32, 64, 128}: CC = Cin / 8 chunks per row.
struct Swizzle {
  int row_bytes, shift, mask;
  __device__ explicit Swizzle(int cin) {
    const int cc = cin / 8;
    row_bytes = cin * 2;
    mask = (cc < 8 ? cc : 8) - 1;
    shift = cc >= 8 ? 0 : (cc == 4 ? 1 : 2);
  }
  __device__ __forceinline__ int offset(int row, int ch) const {  // ch even
    return row * row_bytes + ((((ch >> 3) ^ ((row >> shift) & mask))) << 4) + ((ch & 7) << 1);
  }
};

struct ConvArgs {
  const void* x;         // [B, D, H, W, Cin], T
  const float* dw;       // [27][Cin] depthwise taps, tap = kd*9 + kh*3 + kw
  const void* pw;        // pointwise Cin -> C: mma fragments (bf16) or float [Cin][C]
  const void* sc;        // shortcut Cin -> C in the same layout, or null
  const double* st_in;   // conv2: statistics of h [B][Cin][2], for g = leaky(IN1(h))
  const float* n_scale;  // conv2: norm1 scale and bias [Cin]
  const float* n_bias;
  void* y;               // [B, D, H, W, C], T
  double* st;            // [B][C][2] (sum, sum of squares) of the rounded y
  double* st_sc;         // [B][C][2] of the rounded shortcut conv, or null
  int D, H, W, Cin, C, TD, TH;
  float eps;
};

struct TileOrigin {
  int b, d0, h0, w0;
};

__device__ __forceinline__ TileOrigin tile_origin(const ConvArgs& a) {
  const int ntw = (a.W + kTW - 1) / kTW, nth = (a.H + a.TH - 1) / a.TH;
  int t = blockIdx.x;
  TileOrigin o;
  o.b = blockIdx.y;
  o.w0 = (t % ntw) * kTW;
  t /= ntw;
  o.h0 = (t % nth) * a.TH;
  o.d0 = (t / nth) * a.TD;
  return o;
}

// is output voxel m = (d*TH + h)*8 + w of the tile inside the volume; its offset
__device__ __forceinline__ bool tile_voxel(const ConvArgs& a, const TileOrigin& o, int m,
                                           float inv_th, long* vox) {
  const int row = m >> 3, d = div_small(row, inv_th), h = row - d * a.TH;
  const int gd = o.d0 + d, gh = o.h0 + h, gw = o.w0 + (m & 7);
  *vox = (((long)o.b * a.D + gd) * a.H + gh) * a.W + gw;
  return gd < a.D && gh < a.H && gw < a.W;
}

// ---------------------------------------------------------------------------
// shared-memory layouts (host and device compute the same offsets)
// ---------------------------------------------------------------------------

// With at most two 16-channel chunks both stay in the halo buffers until
// the pointwise phase, so the shortcut product reads x there (no copy).
__host__ __device__ inline bool sc_from_halo(int cin) { return cin <= 2 * kCK; }

struct MmaLayout {
  size_t w, wsc, ab, halo, a, asc, red, total, halo_bytes;
};

__host__ __device__ inline MmaLayout mma_layout(int cin, int c, bool sc, bool apply, int td,
                                                int th) {
  MmaLayout L;
  const size_t m = (size_t)td * th * kTW;
  L.halo_bytes = (size_t)(td + 2) * (th + 2) * kRowBytes;
  L.w = 0;
  L.wsc = L.w + align16((size_t)cin * c * 2);
  L.ab = L.wsc + (sc ? align16((size_t)cin * c * 2) : 0);
  L.halo = L.ab + (apply ? align16((size_t)2 * cin * 4) : 0);
  L.a = L.halo + (cin > kCK ? 2 : 1) * L.halo_bytes;  // a second buffer only when chunks follow
  L.asc = L.a + m * cin * 2;
  L.red = L.asc + (sc && !sc_from_halo(cin) ? m * cin * 2 : 0);
  L.total = L.red + (size_t)2 * kWarps * 2 * c * 4;
  return L;
}

struct CoreLayout {
  size_t ab, halo, a, asc, red, total;
};

__host__ __device__ inline CoreLayout core_layout(int cin, int c, bool sc, bool apply, int td,
                                                  int th) {
  CoreLayout L;
  const size_t m = (size_t)td * th * kTW;
  const int ck = cin < kCK ? cin : kCK;
  L.ab = 0;
  L.halo = L.ab + (apply ? align16((size_t)2 * cin * 4) : 0);
  L.a = L.halo + align16((size_t)(td + 2) * (th + 2) * kHW * ck * 4);
  L.asc = L.a + align16(m * cin * 4);
  L.red = L.asc + (sc ? align16(m * cin * 4) : 0);
  L.total = L.red + (size_t)kThreads * 4 * 8 * 4;  // [kThreads][4][up to 8 channels]
  return L;
}

// (a, b) of y = x*a + b for norm1, per input channel, into s_ab [2][Cin]
__device__ __forceinline__ void norm1_coeffs(const ConvArgs& a, int b, float* s_ab) {
  const double n = (double)a.D * a.H * a.W;
  for (int c = threadIdx.x; c < a.Cin; c += kThreads)
    lu::norm_coeffs(a.st_in + ((long)b * a.Cin + c) * 2, a.n_scale[c], a.n_bias[c], n, a.eps,
                    &s_ab[c], &s_ab[a.Cin + c]);
}

// ---------------------------------------------------------------------------
// conv launch, tensor-core path (bf16)
// ---------------------------------------------------------------------------

// Calls f(byte offset in a halo buffer, x element offset, inside, first
// channel) for each 16-byte unit (8 channels of one halo voxel) of the chunk
// at channel c0, strided over the CTA's threads: a thread visits the same
// units in every chunk.  Outside the volume the x offset points at a valid
// element, and cp.async reads none of it.
template <typename F>
__device__ __forceinline__ void for_halo_units(const ConvArgs& a, const TileOrigin& o, int c0,
                                               F&& f) {
  const int hh2 = a.TH + 2;
  const float inv_hh2 = 1.f / hh2;
  const int units = (a.TD + 2) * hh2 * kHW * 2;
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const int half = u & 1, vox = u >> 1;
    const int rr = vox / kHW, hw = vox - rr * kHW;
    const int hd = div_small(rr, inv_hh2), hh = rr - hd * hh2;
    const int gd = o.d0 + hd - 1, gh = o.h0 + hh - 1, gw = o.w0 + hw - 1;
    const bool inside = (unsigned)gd < (unsigned)a.D && (unsigned)gh < (unsigned)a.H &&
                        (unsigned)gw < (unsigned)a.W;
    const long g = inside ? ((((long)o.b * a.D + gd) * a.H + gh) * a.W + gw) * a.Cin : 0;
    f(rr * kRowBytes + hw * (kCK * 2) + half * 16, g + c0 + half * 8, inside, c0 + half * 8);
  }
}

// acc = A[16 rows of m-tile mt][Cin] x W, A swizzled in shared memory at
// a_base, W as mma B fragments [Cin/16][NT][32 lanes] x (b0, b1)
template <int NT>
__device__ __forceinline__ void mma_rows(float (&acc)[NT][4], uint32_t a_base, const Swizzle& sw,
                                         const uint2* w, int mt, int ksteps, int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const int r = mt * 16 + (lane & 15);
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t fa[4];
    ldmatrix_x4(fa, a_base + sw.offset(r, ks * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint2 b = w[(ks * NT + nt) * 32 + lane];
      mma_bf16(acc[nt], fa, b.x, b.y);
    }
  }
}

// acc = X[16 rows of m-tile mt][Cin] x W, X the tile's own voxels read from
// the halo buffers (chunk ks in buffer ks), for the shortcut product
template <int NT>
__device__ __forceinline__ void mma_rows_halo(float (&acc)[NT][4], uint32_t halo_base,
                                              int halo_bytes, int hh2, int th, float inv_th,
                                              const uint2* w, int mt, int ksteps, int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const int m = mt * 16 + (lane & 15), row = m >> 3;
  const int d = div_small(row, inv_th), h = row - d * th;
  const uint32_t base = halo_base + ((d + 1) * hh2 + h + 1) * kRowBytes +
                        ((m & 7) + 1) * (kCK * 2) + (lane >> 4) * 16;
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t fa[4];
    ldmatrix_x4(fa, base + ks * halo_bytes);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint2 b = w[(ks * NT + nt) * 32 + lane];
      mma_bf16(acc[nt], fa, b.x, b.y);
    }
  }
}

// s[nt] = (sum, sum, sum of squares, sum of squares) of columns nt*8 + 2t
// and nt*8 + 2t + 1 over this thread's rows.  Shuffles reduce over the 8
// row groups of the warp, shared memory over the warps, then one float64
// atomicAdd per CTA and channel.
template <int NT>
__device__ __forceinline__ void flush_stats(float (&s)[NT][4], float* s_red, double* st, int b,
                                            int C, int lane, int warp) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = s[nt][i];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      s[nt][i] = v;
    }
  if (lane < 4) {
    float* r1 = s_red + (warp * 2) * C;
    float* r2 = r1 + C;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + 2 * lane;
      r1[col] = s[nt][0];
      r1[col + 1] = s[nt][1];
      r2[col] = s[nt][2];
      r2[col + 1] = s[nt][3];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      t1 += s_red[(w * 2) * C + c];
      t2 += s_red[(w * 2 + 1) * C + c];
    }
    double* p = st + ((long)b * C + c) * 2;
    atomicAdd(p, (double)t1);
    atomicAdd(p + 1, (double)t2);
  }
}

// round the fragment rows to bf16, store them (STORE) and add them to s
template <int NT, bool STORE>
__device__ __forceinline__ void conv_epilogue(const float (&acc)[NT][4], float (&s)[NT][4],
                                              const ConvArgs& a, const TileOrigin& o, int mt,
                                              int lane, float inv_th) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    long vox;
    if (!tile_voxel(a, o, mt * 16 + (lane >> 2) + 8 * r, inv_th, &vox)) continue;
    uint32_t* yp = reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(a.y) + vox * a.C +
                                               2 * (lane & 3));
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint32_t p = pack_bf16x2(acc[nt][2 * r], acc[nt][2 * r + 1]);
      if (STORE) yp[nt * 4] = p;
      const float f0 = bf_lo(p), f1 = bf_hi(p);
      s[nt][0] += f0;
      s[nt][1] += f1;
      s[nt][2] += f0 * f0;
      s[nt][3] += f1 * f1;
    }
  }
}

template <int NT, bool APPLY, bool SC>
__device__ __forceinline__ void conv_mma_body(const ConvArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const MmaLayout L = mma_layout(a.Cin, a.C, SC, APPLY, a.TD, a.TH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* s_ab = reinterpret_cast<float*>(smem + L.ab);
  unsigned char* s_halo = smem + L.halo;
  unsigned char* s_a = smem + L.a;
  unsigned char* s_asc = smem + L.asc;
  float* s_red = reinterpret_cast<float*>(smem + L.red);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const TileOrigin o = tile_origin(a);

  auto issue = [&](int chunk) {  // halo chunk -> buffer chunk & 1
    unsigned char* buf = s_halo + (chunk & 1) * L.halo_bytes;
    for_halo_units(a, o, chunk * kCK, [&](int soff, long g, bool inside, int) {
      cp_async16(buf + soff, x + g, inside ? 16 : 0);
    });
    cp_async_commit();
  };
  issue(0);
  // the weights and norm1's coefficients while the first chunk loads
  {
    const int n16 = a.Cin * a.C / 8;
    const uint4* src = static_cast<const uint4*>(a.pw);
    uint4* dst = reinterpret_cast<uint4*>(smem + L.w);
    for (int i = tid; i < n16; i += kThreads) dst[i] = src[i];
    if (SC) {
      src = static_cast<const uint4*>(a.sc);
      dst = reinterpret_cast<uint4*>(smem + L.wsc);
      for (int i = tid; i < n16; i += kThreads) dst[i] = src[i];
    }
    if (APPLY) norm1_coeffs(a, o.b, s_ab);
  }
  __syncthreads();

  const Swizzle sw(a.Cin);
  const int hh2 = a.TH + 2, rows = a.TD * a.TH, nchunks = a.Cin / kCK;
  const int mtiles = rows * kTW / 16;
  const float inv_th = 1.f / a.TH;
  const int wstride = a.Cin / 2;  // float2 taps
  const bool sc_tile = SC && !sc_from_halo(a.Cin);  // x copied to s_asc for the shortcut
  for (int k = 0; k < nchunks; ++k) {
    if (k + 1 < nchunks) {
      issue(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    unsigned char* buf = s_halo + (k & 1) * L.halo_bytes;
    const int c0 = k * kCK;
    if (APPLY) {
      // g = round(leaky(h * a1 + b1)) in place, on the units this thread loaded
      for_halo_units(a, o, c0, [&](int soff, long, bool inside, int ch) {
        if (!inside) return;  // the zero edge stays 0 in g-space
        uint4* p = reinterpret_cast<uint4*>(buf + soff);
        uint4 v = *p;
        uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = ch + 2 * i;
          w[i] = pack_bf16x2(leaky(bf_lo(w[i]) * s_ab[c] + s_ab[a.Cin + c]),
                             leaky(bf_hi(w[i]) * s_ab[c + 1] + s_ab[a.Cin + c + 1]));
        }
        *p = v;
      });
    }
    // depthwise: one job = one (d, h) row of 8 voxels x 2 channels; all jobs
    // of a thread share its channel pair (kThreads is a multiple of 8), so
    // the pair's 27 taps stay in registers
    const int pair = tid & 7;
    float2 taps[27];
    {
      const float2* wt = reinterpret_cast<const float2*>(a.dw + c0) + pair;
#pragma unroll
      for (int i = 0; i < 27; ++i) taps[i] = __ldg(wt + i * wstride);
    }
    __syncthreads();
    for (int job = tid; job < rows * 8; job += kThreads) {
      const int row = job >> 3;
      const int d = div_small(row, inv_th), h = row - d * a.TH;
      const unsigned char* hb = buf + (d * hh2 + h) * kRowBytes + pair * 4;
      float acc0[kTW], acc1[kTW];
      uint32_t center[kTW];
#pragma unroll
      for (int j = 0; j < kTW; ++j) acc0[j] = acc1[j] = 0.f;
#pragma unroll
      for (int kd = 0; kd < 3; ++kd)
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          const unsigned char* r = hb + (kd * hh2 + kh) * kRowBytes;
          float v0[kHW], v1[kHW];
#pragma unroll
          for (int i = 0; i < kHW; ++i) {
            const uint32_t u = *reinterpret_cast<const uint32_t*>(r + i * (kCK * 2));
            v0[i] = bf_lo(u);
            v1[i] = bf_hi(u);
            if (sc_tile && kd == 1 && kh == 1 && i >= 1 && i <= kTW) center[i - 1] = u;
          }
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            const float2 wv = taps[(kd * 3 + kh) * 3 + kw];
#pragma unroll
            for (int j = 0; j < kTW; ++j) {
              acc0[j] = fmaf(v0[j + kw], wv.x, acc0[j]);
              acc1[j] = fmaf(v1[j + kw], wv.y, acc1[j]);
            }
          }
        }
#pragma unroll
      for (int j = 0; j < kTW; ++j) {
        const int off = sw.offset(row * kTW + j, c0 + 2 * pair);
        *reinterpret_cast<uint32_t*>(s_a + off) = pack_bf16x2(acc0[j], acc1[j]);
        if (sc_tile) *reinterpret_cast<uint32_t*>(s_asc + off) = center[j];
      }
    }
    __syncthreads();
  }

  // pointwise products on the tensor cores, statistics from the fragments
  float acc[NT][4], s[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  for (int mt = warp; mt < mtiles; mt += kWarps) {
    mma_rows<NT>(acc, smem_addr(s_a), sw, reinterpret_cast<const uint2*>(smem + L.w), mt,
                 nchunks, lane);
    conv_epilogue<NT, true>(acc, s, a, o, mt, lane, inv_th);
  }
  flush_stats<NT>(s, s_red, a.st, o.b, a.C, lane, warp);
  if (SC) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    for (int mt = warp; mt < mtiles; mt += kWarps) {
      const uint2* wsc = reinterpret_cast<const uint2*>(smem + L.wsc);
      if (sc_tile)
        mma_rows<NT>(acc, smem_addr(s_asc), sw, wsc, mt, nchunks, lane);
      else
        mma_rows_halo<NT>(acc, smem_addr(s_halo), (int)L.halo_bytes, hh2, a.TH, inv_th, wsc, mt,
                          nchunks, lane);
      conv_epilogue<NT, false>(acc, s, a, o, mt, lane, inv_th);
    }
    flush_stats<NT>(s, s_red + kWarps * 2 * a.C, a.st_sc, o.b, a.C, lane, warp);
  }
}

template <int NT, bool SC>
__global__ void __launch_bounds__(kThreads) conv1_mma(ConvArgs a) {
  conv_mma_body<NT, false, SC>(a);
}

template <int NT>
__global__ void __launch_bounds__(kThreads) conv2_mma(ConvArgs a) {
  conv_mma_body<NT, true, false>(a);
}

// ---------------------------------------------------------------------------
// conv launch, CUDA-core path (float32, and bf16 shapes off the mma tile)
// ---------------------------------------------------------------------------

// Pointwise products of the CUDA-core path: a thread takes V consecutive
// output channels (one 16-byte access when C allows) of voxels strided over
// the CTA, keeps their statistics in registers, and the CTA reduces them
// through s_red [kThreads][4][V] to one float64 atomicAdd per channel.
template <typename T, int V, bool SC>
__device__ __forceinline__ void core_pointwise(const ConvArgs& a, const TileOrigin& o,
                                               const float* s_a, const float* s_asc,
                                               float* s_red, int m_count, float inv_th) {
  const int tid = threadIdx.x, groups = a.C / V;
  for (int gb = 0; gb < groups; gb += kThreads) {
    const int gn = min(kThreads, groups - gb);
    const int per = kThreads / gn, used = per * gn;
    const int co = (gb + tid % gn) * V;
    float s1[V], s2[V], q1[V], q2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) s1[j] = s2[j] = q1[j] = q2[j] = 0.f;
    if (tid < used) {
      const float* pw = static_cast<const float*>(a.pw) + co;
      const float* scw = SC ? static_cast<const float*>(a.sc) + co : nullptr;
      for (int m = tid / gn; m < m_count; m += per) {
        long vox;
        if (!tile_voxel(a, o, m, inv_th, &vox)) continue;
        const float* av = s_a + m * a.Cin;
        float acc[V];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = 0.f;
        for (int ci = 0; ci < a.Cin; ++ci) {
          const float v = av[ci];
          const float* wr = pw + (long)ci * a.C;
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] = fmaf(v, __ldg(wr + j), acc[j]);
        }
#pragma unroll
        for (int j = 0; j < V; ++j) {
          acc[j] = lu::round_to<T>(acc[j]);
          s1[j] += acc[j];
          s2[j] += acc[j] * acc[j];
        }
        lu::store_vec<T, V>(static_cast<T*>(a.y) + vox * a.C + co, acc);
        if (SC) {
          const float* xv = s_asc + m * a.Cin;
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] = 0.f;
          for (int ci = 0; ci < a.Cin; ++ci) {
            const float v = xv[ci];
            const float* wr = scw + (long)ci * a.C;
#pragma unroll
            for (int j = 0; j < V; ++j) acc[j] = fmaf(v, __ldg(wr + j), acc[j]);
          }
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float r = lu::round_to<T>(acc[j]);
            q1[j] += r;
            q2[j] += r * r;
          }
        }
      }
    }
    float* mine = s_red + tid * 4 * V;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mine[j] = s1[j];
      mine[V + j] = s2[j];
      mine[2 * V + j] = q1[j];
      mine[3 * V + j] = q2[j];
    }
    __syncthreads();
    for (int i = tid; i < gn * V; i += kThreads) {
      const int g = i / V, j = i - g * V;
      float t1 = 0.f, t2 = 0.f, t3 = 0.f, t4 = 0.f;
      for (int t = g; t < used; t += gn) {
        const float* r = s_red + t * 4 * V + j;
        t1 += r[0];
        t2 += r[V];
        t3 += r[2 * V];
        t4 += r[3 * V];
      }
      const long ch = (long)o.b * a.C + (gb + g) * V + j;
      atomicAdd(a.st + ch * 2, (double)t1);
      atomicAdd(a.st + ch * 2 + 1, (double)t2);
      if (SC) {
        atomicAdd(a.st_sc + ch * 2, (double)t3);
        atomicAdd(a.st_sc + ch * 2 + 1, (double)t4);
      }
    }
    __syncthreads();  // s_red is reused by the next channel group
  }
}

template <typename T, bool APPLY, bool SC>
__device__ __forceinline__ void conv_core_body(const ConvArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const CoreLayout L = core_layout(a.Cin, a.C, SC, APPLY, a.TD, a.TH);
  float* s_ab = reinterpret_cast<float*>(smem + L.ab);
  float* s_halo = reinterpret_cast<float*>(smem + L.halo);  // [halo row][10][ck]
  float* s_a = reinterpret_cast<float*>(smem + L.a);        // [M][Cin] rounded depthwise
  float* s_asc = reinterpret_cast<float*>(smem + L.asc);    // [M][Cin] x (projection only)
  float* s_red = reinterpret_cast<float*>(smem + L.red);    // [kThreads][4]
  const int tid = threadIdx.x;
  const TileOrigin o = tile_origin(a);
  const T* x = static_cast<const T*>(a.x);
  if (APPLY) norm1_coeffs(a, o.b, s_ab);
  __syncthreads();

  const int hh2 = a.TH + 2, rows = a.TD * a.TH, m_count = rows * kTW;
  const float inv_hh2 = 1.f / hh2, inv_th = 1.f / a.TH;
  for (int c0 = 0; c0 < a.Cin; c0 += kCK) {
    const int ck = min(kCK, a.Cin - c0);
    const int n = (a.TD + 2) * hh2 * kHW * ck;
    for (int u = tid; u < n; u += kThreads) {
      const int vox = u / ck, cc = u - vox * ck;
      const int rr = vox / kHW, hw = vox - rr * kHW;
      const int hd = div_small(rr, inv_hh2), hh = rr - hd * hh2;
      const int gd = o.d0 + hd - 1, gh = o.h0 + hh - 1, gw = o.w0 + hw - 1;
      float v = 0.f;  // the zero edge (in g-space for conv2)
      if ((unsigned)gd < (unsigned)a.D && (unsigned)gh < (unsigned)a.H &&
          (unsigned)gw < (unsigned)a.W) {
        v = lu::to_f<T>(x[((((long)o.b * a.D + gd) * a.H + gh) * a.W + gw) * a.Cin + c0 + cc]);
        if (APPLY) v = lu::round_to<T>(leaky(v * s_ab[c0 + cc] + s_ab[a.Cin + c0 + cc]));
      }
      s_halo[u] = v;
    }
    __syncthreads();
    for (int job = tid; job < rows * ck; job += kThreads) {
      const int row = job / ck, cc = job - row * ck;
      const int d = div_small(row, inv_th), h = row - d * a.TH;
      const float* hb = s_halo + (d * hh2 + h) * kHW * ck + cc;
      const float* wt = a.dw + c0 + cc;
      float acc[kTW], center[kTW];
#pragma unroll
      for (int j = 0; j < kTW; ++j) acc[j] = 0.f;
#pragma unroll
      for (int kd = 0; kd < 3; ++kd)
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          const float* r = hb + (kd * hh2 + kh) * kHW * ck;
          float v[kHW];
#pragma unroll
          for (int i = 0; i < kHW; ++i) {
            v[i] = r[i * ck];
            if (SC && kd == 1 && kh == 1 && i >= 1 && i <= kTW) center[i - 1] = v[i];
          }
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            const float w = __ldg(wt + ((kd * 3 + kh) * 3 + kw) * a.Cin);
#pragma unroll
            for (int j = 0; j < kTW; ++j) acc[j] = fmaf(v[j + kw], w, acc[j]);
          }
        }
#pragma unroll
      for (int j = 0; j < kTW; ++j) {
        const int i = (row * kTW + j) * a.Cin + c0 + cc;
        s_a[i] = lu::round_to<T>(acc[j]);
        if (SC) s_asc[i] = center[j];
      }
    }
    __syncthreads();
  }

  constexpr int VW = 16 / (int)sizeof(T);  // one 16-byte access
  if (a.C % VW == 0)
    core_pointwise<T, VW, SC>(a, o, s_a, s_asc, s_red, m_count, inv_th);
  else
    core_pointwise<T, 1, SC>(a, o, s_a, s_asc, s_red, m_count, inv_th);
}

template <typename T, bool SC>
__global__ void __launch_bounds__(kThreads) conv1_cuda_core(ConvArgs a) {
  conv_core_body<T, false, SC>(a);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) conv2_cuda_core(ConvArgs a) {
  conv_core_body<T, true, false>(a);
}

// ---------------------------------------------------------------------------
// output launch: out = leaky(round(IN2(h2)) + residual)
// ---------------------------------------------------------------------------

struct OutArgs {
  const void* h2;     // [B, S, C]
  const void* x;      // [B, S, Cin]
  const double* st2;  // [B][C][2]
  const float* n2s;
  const float* n2b;
  const void* sc;     // shortcut weights (mma fragments or float [Cin][C]), or null
  const double* st_s;
  const float* nss;
  const float* nsb;
  void* out;          // [B, S, C]
  long S;
  int Cin, C;
  float eps;
};

// (a2, b2) and, for a projection, (a_s, b_s) per channel into s_ab [4][C]
__device__ __forceinline__ void out_coeffs(const OutArgs& a, int b, float* s_ab, bool proj) {
  for (int c = threadIdx.x; c < a.C; c += blockDim.x) {
    lu::norm_coeffs(a.st2 + ((long)b * a.C + c) * 2, a.n2s[c], a.n2b[c], (double)a.S, a.eps,
                    &s_ab[c], &s_ab[a.C + c]);
    if (proj)
      lu::norm_coeffs(a.st_s + ((long)b * a.C + c) * 2, a.nss[c], a.nsb[c], (double)a.S, a.eps,
                      &s_ab[2 * a.C + c], &s_ab[3 * a.C + c]);
  }
}

// identity residual: elementwise, V channels per 16-byte (or scalar) access
template <typename T, int V>
__global__ void __launch_bounds__(256) block_out_identity(OutArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_ab = reinterpret_cast<float*>(smem);
  const int b = blockIdx.y;
  out_coeffs(a, b, s_ab, false);
  __syncthreads();
  const int cv = a.C / V;
  const long n = a.S * cv;
  const long base = (long)b * a.S * a.C;
  const T* h2 = static_cast<const T*>(a.h2) + base;
  const T* x = static_cast<const T*>(a.x) + base;
  T* out = static_cast<T*>(a.out) + base;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const int c = (int)(i % cv) * V;
    float hv[V], xv[V];
    lu::load_vec<T, V>(h2 + i * V, hv);
    lu::load_vec<T, V>(x + i * V, xv);
#pragma unroll
    for (int j = 0; j < V; ++j)
      hv[j] = leaky(lu::round_to<T>(hv[j] * s_ab[c + j] + s_ab[a.C + c + j]) + xv[j]);
    lu::store_vec<T, V>(out + i * V, hv);
  }
}

// projection residual on the tensor cores: one m-tile of 16 voxels per warp
template <int NT>
__global__ void __launch_bounds__(kThreads) block_out_mma(OutArgs a) {
  static_assert(kOutRows == 16 * kWarps, "one m-tile per warp");
  extern __shared__ __align__(16) unsigned char smem[];
  using bf16 = __nv_bfloat16;
  const int Cin = a.Cin, C = a.C;
  unsigned char* s_w = smem;
  unsigned char* s_x = smem + align16((size_t)Cin * C * 2);
  float* s_ab = reinterpret_cast<float*>(s_x + kOutRows * Cin * 2);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const long v0 = (long)blockIdx.x * kOutRows;
  const Swizzle sw(Cin);
  const bf16* x = static_cast<const bf16*>(a.x) + (long)b * a.S * Cin;
  const int cc = Cin / 8;
  for (int u = tid; u < kOutRows * cc; u += kThreads) {
    const int r = u / cc, ch = (u - r * cc) * 8;
    const bool in = v0 + r < a.S;
    cp_async16(s_x + sw.offset(r, ch), x + (in ? (v0 + r) * Cin + ch : 0), in ? 16 : 0);
  }
  cp_async_commit();
  const uint4* src = static_cast<const uint4*>(a.sc);
  for (int i = tid; i < Cin * C / 8; i += kThreads) reinterpret_cast<uint4*>(s_w)[i] = src[i];
  out_coeffs(a, b, s_ab, true);
  cp_async_wait<0>();
  __syncthreads();

  float acc[NT][4];
  mma_rows<NT>(acc, smem_addr(s_x), sw, reinterpret_cast<const uint2*>(s_w), warp, Cin / 16,
               lane);
  const bf16* h2 = static_cast<const bf16*>(a.h2) + (long)b * a.S * C;
  bf16* out = static_cast<bf16*>(a.out) + (long)b * a.S * C;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long s = v0 + warp * 16 + (lane >> 2) + 8 * r;
    if (s >= a.S) continue;
    const long o = s * C + 2 * (lane & 3);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + 2 * (lane & 3);
      const uint32_t hp = *reinterpret_cast<const uint32_t*>(h2 + o + nt * 8);
      float z[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float hv = e ? bf_hi(hp) : bf_lo(hp);
        const float y = lu::round_to<bf16>(hv * s_ab[c + e] + s_ab[C + c + e]);
        const float q = lu::round_to<bf16>(acc[nt][2 * r + e]);
        const float res = lu::round_to<bf16>(q * s_ab[2 * C + c + e] + s_ab[3 * C + c + e]);
        z[e] = leaky(y + res);
      }
      *reinterpret_cast<uint32_t*>(out + o + nt * 8) = pack_bf16x2(z[0], z[1]);
    }
  }
}

// projection residual on the CUDA cores, V consecutive channels per thread
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) block_out_cuda_core(OutArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Cin = a.Cin, C = a.C, cv = C / V;
  float* s_ab = reinterpret_cast<float*>(smem);
  float* s_x = s_ab + 4 * C;  // [kOutRows][Cin]
  const int tid = threadIdx.x, b = blockIdx.y;
  const long v0 = (long)blockIdx.x * kOutRows;
  const T* x = static_cast<const T*>(a.x) + (long)b * a.S * Cin;
  out_coeffs(a, b, s_ab, true);
  for (int i = tid; i < kOutRows * Cin; i += kThreads) {
    const long s = v0 + i / Cin;
    s_x[i] = s < a.S ? lu::to_f<T>(x[v0 * Cin + i]) : 0.f;
  }
  __syncthreads();
  const float* scw = static_cast<const float*>(a.sc);
  const T* h2 = static_cast<const T*>(a.h2) + (long)b * a.S * C;
  T* out = static_cast<T*>(a.out) + (long)b * a.S * C;
  for (int i = tid; i < kOutRows * cv; i += kThreads) {
    const int r = i / cv, co = (i - r * cv) * V;
    const long s = v0 + r;
    if (s >= a.S) continue;
    const float* xv = s_x + r * Cin;
    float acc[V], hv[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    for (int ci = 0; ci < Cin; ++ci) {
      const float v = xv[ci];
      const float* wr = scw + (long)ci * C + co;
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fmaf(v, __ldg(wr + j), acc[j]);
    }
    lu::load_vec<T, V>(h2 + s * C + co, hv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = co + j;
      const float y = lu::round_to<T>(hv[j] * s_ab[c] + s_ab[C + c]);
      const float res = lu::round_to<T>(lu::round_to<T>(acc[j]) * s_ab[2 * C + c] + s_ab[3 * C + c]);
      hv[j] = leaky(y + res);
    }
    lu::store_vec<T, V>(out + s * C + co, hv);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using ConvKernel = void (*)(ConvArgs);
using OutKernel = void (*)(OutArgs);

int max_smem_optin() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}

bool mma_width(int v) { return v == 16 || v == 32 || v == 64 || v == 128; }

// candidate (TD, TH) of a conv tile; W is tiled by 8
constexpr int kTiles[][2] = {{8, 8}, {4, 8}, {2, 8}, {4, 4}, {2, 4}, {1, 4}, {1, 2}};

struct Plan {
  int td, th;
  size_t smem;
  unsigned tiles;
};

// The tile with the least modelled time per volume: tiles x (thread slots
// of the depthwise jobs, at least one per thread, plus a quarter per halo
// voxel staged) / CTAs resident per SM (by shared memory, counted up to 3).
Plan plan_conv(bool mma, int cin, int c, bool sc, bool apply, int D, int H, int W) {
  const size_t limit = (size_t)max_smem_optin();
  constexpr size_t kSmemPerSm = 233472, kReservedPerCta = 1024;
  Plan best{0, 0, 0, 0};
  double best_cost = 0.0;
  for (const auto& t : kTiles) {
    const size_t nb = mma ? mma_layout(cin, c, sc, apply, t[0], t[1]).total
                          : core_layout(cin, c, sc, apply, t[0], t[1]).total;
    if (nb > limit) continue;
    const long tiles = (long)((D + t[0] - 1) / t[0]) * ((H + t[1] - 1) / t[1]) *
                       ((W + kTW - 1) / kTW);
    const int jobs = t[0] * t[1] * (mma ? 8 : (cin < kCK ? cin : kCK));
    const long resident = (long)(kSmemPerSm / (nb + kReservedPerCta));
    const double cost = (double)tiles *
                        ((jobs > kThreads ? jobs : kThreads) + 0.25 * (t[0] + 2) * (t[1] + 2) * kHW) /
                        (double)(resident < 3 ? resident : 3);
    if (!best.smem || cost < best_cost) {
      best = Plan{t[0], t[1], nb, (unsigned)tiles};
      best_cost = cost;
    }
  }
  return best;
}

template <typename K, typename A>
cudaError_t launch_kernel(K kern, dim3 grid, int threads, size_t smem, cudaStream_t s,
                          const A& args) {
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, threads, smem, s>>>(args);
  return cudaGetLastError();
}

template <int NT>
ConvKernel mma_conv(bool apply, bool sc) {
  return apply ? &conv2_mma<NT> : (sc ? &conv1_mma<NT, true> : &conv1_mma<NT, false>);
}

template <typename T>
cudaError_t launch_conv(ConvArgs a, int B, bool mma, bool apply, bool sc, cudaStream_t s) {
  const Plan p = plan_conv(mma, a.Cin, a.C, sc, apply, a.D, a.H, a.W);
  if (!p.smem) return cudaErrorInvalidConfiguration;
  a.TD = p.td;
  a.TH = p.th;
  ConvKernel k = nullptr;
  if (!mma) {
    k = apply ? &conv2_cuda_core<T>
              : (sc ? &conv1_cuda_core<T, true> : &conv1_cuda_core<T, false>);
  } else if (a.C == 16) {
    k = mma_conv<2>(apply, sc);
  } else if (a.C == 32) {
    k = mma_conv<4>(apply, sc);
  } else if (a.C == 64) {
    k = mma_conv<8>(apply, sc);
  } else if (a.C == 128) {
    k = mma_conv<16>(apply, sc);
  }
  if (!k) return cudaErrorInvalidValue;
  return launch_kernel(k, dim3(p.tiles, B), kThreads, p.smem, s, a);
}

template <typename T>
cudaError_t launch_out(const OutArgs& a, int B, bool mma, cudaStream_t s) {
  if (a.sc == nullptr) {
    constexpr int VW = lu::vec_width<T>();
    const bool vec = a.C % VW == 0;
    const long n = a.S * (vec ? a.C / VW : a.C);
    const unsigned blocks = (unsigned)((n + 1023) / 1024);  // about 4 accesses per thread
    OutKernel k = vec ? &block_out_identity<T, VW> : &block_out_identity<T, 1>;
    return launch_kernel(k, dim3(blocks, B), 256, (size_t)2 * a.C * 4, s, a);
  }
  const unsigned blocks = (unsigned)((a.S + kOutRows - 1) / kOutRows);
  size_t smem = (4 * (size_t)a.C + (size_t)kOutRows * a.Cin) * 4;
  constexpr int VW = lu::vec_width<T>();
  OutKernel k = a.C % VW == 0 ? &block_out_cuda_core<T, VW> : &block_out_cuda_core<T, 1>;
  if (mma) {
    smem = align16((size_t)a.Cin * a.C * 2) + (size_t)kOutRows * a.Cin * 2 + 4 * (size_t)a.C * 4;
    k = a.C == 16    ? &block_out_mma<2>
        : a.C == 32  ? &block_out_mma<4>
        : a.C == 64  ? &block_out_mma<8>
        : a.C == 128 ? &block_out_mma<16>
                     : nullptr;
  }
  if (!k) return cudaErrorInvalidValue;
  if (smem > (size_t)max_smem_optin()) return cudaErrorInvalidConfiguration;
  return launch_kernel(k, dim3(blocks, B), kThreads, smem, s, a);
}

template <typename T>
cudaError_t run(const ConvArgs& c1, const ConvArgs& c2, const OutArgs& o, int B, bool mma1,
                bool mma2, cudaStream_t s) {
  cudaError_t e = launch_conv<T>(c1, B, mma1, false, c1.sc != nullptr, s);
  if (e != cudaSuccess) return e;
  e = launch_conv<T>(c2, B, mma2, true, false, s);
  if (e != cudaSuccess) return e;
  return launch_out<T>(o, B, mma1, s);
}

}  // namespace

// Weights: dw [27][Cin] and [27][C] float32 holding compute-dtype values
// (tap kd*9 + kh*3 + kw); norm scale/bias [C] float32.  pw1 and sc (Cin ->
// C) are bf16 mma B fragments [Cin/16][C/8][32 lanes][4] when mma1, else
// float32 [Cin][C]; pw2 likewise with mma2.  mma1 needs bf16 and Cin, C in
// {16, 32, 64, 128}; mma2 needs bf16 and C in that set.  sc, nss, nsb are
// null for an identity block (Cin == C).  h, h2: [B, S, C] scratch; stats:
// [3][B][C][2] float64 scratch.
extern "C" int residual_block(const void* x, const void* dw1, const void* pw1, const void* n1s,
                              const void* n1b, const void* dw2, const void* pw2, const void* n2s,
                              const void* n2b, const void* sc, const void* nss, const void* nsb,
                              void* h, void* h2, void* out, void* stats, int dtype, int B, int D,
                              int H, int W, int Cin, int C, int mma1, int mma2, float eps,
                              void* stream) {
  if ((mma1 || mma2) && dtype != lu::kBF16) return cudaErrorInvalidValue;
  if ((mma1 && !(mma_width(Cin) && mma_width(C))) || (mma2 && !mma_width(C)))
    return cudaErrorInvalidValue;
  if (B < 1 || B > 65535 || D < 1 || H < 1 || W < 1 || Cin < 1 || C < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  double* st1 = static_cast<double*>(stats);
  double* st_s = st1 + 2L * B * C;
  double* st2 = st1 + 4L * B * C;
  cudaError_t e = cudaMemsetAsync(stats, 0, sizeof(double) * 6L * B * C, s);
  if (e != cudaSuccess) return e;
  const ConvArgs c1{x, f(dw1), pw1, sc, nullptr, nullptr, nullptr, h, st1,
                    sc ? st_s : nullptr, D, H, W, Cin, C, 0, 0, eps};
  const ConvArgs c2{h, f(dw2), pw2, nullptr, st1, f(n1s), f(n1b), h2, st2,
                    nullptr, D, H, W, C, C, 0, 0, eps};
  const OutArgs o{h2, x, st2, f(n2s), f(n2b), sc, st_s, f(nss), f(nsb), out,
                  (long)D * H * W, Cin, C, eps};
  if (dtype == lu::kBF16) return run<__nv_bfloat16>(c1, c2, o, B, mma1, mma2, s);
  if (dtype == lu::kF32) return run<float>(c1, c2, o, B, false, false, s);
  return cudaErrorInvalidValue;
}

// The tiles the two conv launches of a block take: plan = (TD, TH, shared
// bytes) of conv1, then of conv2 (W is tiled by 8).
extern "C" int residual_block_plan(int D, int H, int W, int Cin, int C, int projection,
                                   int mma1, int mma2, int* plan) {
  const Plan p1 = plan_conv(mma1, Cin, C, projection, false, D, H, W);
  const Plan p2 = plan_conv(mma2, C, C, false, true, D, H, W);
  const int v[6] = {p1.td, p1.th, (int)p1.smem, p2.td, p2.th, (int)p2.smem};
  for (int i = 0; i < 6; ++i) plan[i] = v[i];
  return p1.smem && p2.smem ? 0 : (int)cudaErrorInvalidConfiguration;
}
