// Fused affine InstanceNorm + LeakyReLU over a channels-last [B, S, C]
// activation: y = leaky((x - mean) * rsqrt(var + eps) * scale + bias, slope).
//
// Replaces the Pallas TPU kernel light_unet_tpu/ops/pallas_kernels.py:_kernel
// (launched by _fused_in_leaky_pallas).  That kernel held one whole sample
// in VMEM and read it once.  An SM's 227 KB holds a whole sample only at the
// small shapes (6^3 x 128 and 12^3 x 64 in bf16), but the card's SMs together
// hold about 30 MB, so here a sample is spread over k co-resident CTAs and
// is still read from device memory once, in one launch:
//   - plan (instance_norm_plan): k = 1 when a sample fits one CTA's shared
//     memory; else the sample's S rows are cut into k contiguous chunks sized
//     so that two CTAs fit on an SM.  The grid is G groups of k CTAs, with G
//     as many as can be resident at once (occupancy x SMs) / k, at most B,
//     launched by cudaLaunchCooperativeKernel, which guarantees that every
//     CTA is resident or refuses the launch.  Group g takes samples g, g + G,
//     g + 2G, ... (one per round); CTA q of the group takes chunk q.
//   - a CTA copies its chunk into shared memory with 16-byte cp.async (plain
//     loads when C * sizeof(T) is not a multiple of 16), each thread its own
//     vectors, and sums x and x^2 per channel in float32 registers; warp
//     shuffles and shared memory reduce them, in a fixed order and in
//     float64, to one partial per CTA.
//   - k > 1: the partial goes to slot [sample][chunk] of a workspace, the CTA
//     arrives at the sample's counter and waits for the sample's generation
//     word to move.  The last of the k CTAs to arrive resets the counter and
//     moves the word, so the workspace is zeroed once when it is allocated,
//     never per call.  Each CTA then sums the sample's k partials in float64
//     in one fixed order (R lanes per channel, then a shuffle tree).  No
//     atomics touch the data: the statistics, and so the output, are
//     bit-identical from run to run.
//   - the CTA applies y = leaky(x * a + b) to its chunk from shared memory and
//     writes y with 16-byte stores; as a thread frees a vector it issues the
//     copy of the same vector of the group's next sample, so the next round's
//     load overlaps this round's stores, and the other CTA on the SM covers
//     this one's reduction and wait.  (One CTA per SM holding two chunks, the
//     next loading during the whole round, measured slower: half the samples
//     a round, twice the waits.)
//   - a sample whose chunks cannot all be resident (over about 30 MB: a
//     96^3 x 48 bf16 window of SwinUNETR's first and last blocks, 85 MB, or
//     a 96^3 x 16 float32 patch) takes the streaming variant of the same
//     kernel: the whole grid (528 CTAs on an H100) is one group, chunks are
//     not held on chip, and x is read twice (sums, then apply).  Same
//     launch, same fixed-order statistics, but with so many chunks a
//     sample's partials are not summed by every CTA (that read k x C x 16
//     bytes of L2 a CTA, 0.2 GB a sample at 96^3 x 48): one warp a channel,
//     in the first ceil(C / warps) CTAs, sums them and publishes the
//     coefficients in the workspace's slot k, and the others wait for that
//     (a second, one-sided barrier).  The apply pass walks each chunk backwards with
//     evict-first loads and stores, so the chunk's tail, read last by the
//     sums, is read again from the 50 MB L2 and not from device memory.
// Bound on the card: memory bandwidth.  The function must read x once and
// write y once (about 6 flops per element), and this design moves exactly
// those bytes; what it adds is one wait per round for the k CTAs of a sample
// and the reduction of the chunk from shared memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;        // threads per CTA, unless C needs more lanes
constexpr int kMaxThreads = 1024;
constexpr int kCtasPerSmTarget = 2;  // chunk size when a sample needs k > 1

inline size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

// Threads of a CTA: lane = t % cv holds channels [lane * V, lane * V + V) of
// rows t / cv, t / cv + rows_in_flight, ...  When cv divides 32 the sums are
// first reduced over a warp by shuffles, and each warp leaves cv "holders";
// else every active thread is a holder.  nh = holder rows of the reduction
// buffer [nh][cv][2][V] float.
struct Shape {
  int V, cv, threads, nh;
};

inline Shape shape_of(int C, int elt) {
  Shape s;
  s.V = (C * elt) % 16 == 0 ? 16 / elt : 1;
  s.cv = C / s.V;
  s.threads = s.cv <= kThreads ? kThreads : (s.cv + 31) / 32 * 32;
  const bool shuffled = s.cv < 32 && 32 % s.cv == 0;  // as in_leaky decides it
  s.nh = shuffled ? s.threads / 32 : s.threads / s.cv;
  return s;
}

// Shared memory of a CTA: the chunk [rpc][C] in T, then the reduction
// buffer, then the coefficients (a, b) [2][C] float.
struct Smem {
  size_t red_off, total;
};

inline Smem smem_of(const Shape& sh, int C, int elt, long rpc, bool stream) {
  const size_t red_off = stream ? 0 : align16((size_t)rpc * C * elt);
  return {red_off, red_off + (size_t)sh.nh * sh.cv * 2 * sh.V * 4 + (size_t)2 * C * 4};
}

struct Args {
  const void* x;      // [B, S, C], T
  void* y;            // [B, S, C], T
  const float* scale;
  const float* bias;
  double* part;       // [B][k + 1][C][2] float64 (sum, sum of squares) of each chunk;
                      // streaming: slot k holds each channel's coefficients (a, b)
  unsigned* sync;     // [B][4] (arrivals, generation) twice, zeroed once when allocated
  long S, rpc;        // rows per sample, rows per chunk
  int B, C, k, G;
  int red_off;        // byte offset of the reduction buffer in shared memory
  float eps, slope;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// V elements with evict-first loads and stores where a vector is 16 bytes
template <typename T, int V>
__device__ __forceinline__ void load_vec_cs(const T* p, float* out) {
  if constexpr (V * sizeof(T) == 16) {
    lu::Vec<T, V> r;
    *reinterpret_cast<int4*>(&r) = __ldcs(reinterpret_cast<const int4*>(p));
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = lu::to_f<T>(r.v[j]);
  } else {
    lu::load_vec<T, V>(p, out);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec_cs(T* p, const float* in) {
  if constexpr (V * sizeof(T) == 16) {
    lu::Vec<T, V> r;
#pragma unroll
    for (int j = 0; j < V; ++j) r.v[j] = lu::from_f<T>(in[j]);
    __stcs(reinterpret_cast<int4*>(p), *reinterpret_cast<const int4*>(&r));
  } else {
    lu::store_vec<T, V>(p, in);
  }
}

// one vector global -> shared: cp.async when it is 16 bytes, else a plain copy
template <typename T, int V>
__device__ __forceinline__ void copy_in(T* dst, const T* src) {
  if constexpr (V * sizeof(T) == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) dst[j] = src[j];
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// One thread of one of k CTAs: arrive at sync = (arrivals, generation).  The
// last of the k to arrive resets the count and moves the generation.
__device__ void arrive(unsigned* sync, int k) {
  __threadfence();
  if (atomicAdd(sync, 1u) == static_cast<unsigned>(k - 1)) {
    atomicExch(sync, 0u);  // ready for the next call
    __threadfence();
    atomicAdd(sync + 1, 1u);
  }
}

// Return once the generation word has moved from gen.
__device__ void wait_moved(const unsigned* generation, unsigned gen) {
  while (ld_acquire(generation) == gen) __nanosleep(32);
  __threadfence();
}

// One thread of each of the k CTAs of a sample: arrive, and return once all
// k have arrived.  Every partial of the sample was written and fenced before
// its CTA arrived.
__device__ void arrive_and_wait(unsigned* sync, int k) {
  const unsigned gen = ld_acquire(sync + 1);  // read before arriving: it moves only after
  arrive(sync, k);
  wait_moved(sync + 1, gen);
}

// STREAM: the chunk is not held in shared memory; x is read again to apply
template <typename T, int V, bool STREAM>
__global__ void __launch_bounds__(kMaxThreads) in_leaky(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + a.red_off);
  const int C = a.C, cv = C / V, t = threadIdx.x;
  const bool shuffled = cv < 32 && 32 % cv == 0;
  const int nh = shuffled ? blockDim.x / 32 : blockDim.x / cv;
  const int active = blockDim.x / cv * cv;
  float* ab = red + (size_t)nh * cv * 2 * V;
  const int lane = t % cv;
  const int holder = shuffled ? ((t & 31) < cv ? t / 32 : -1) : (t < active ? t / cv : -1);
  const int g = blockIdx.x / a.k, q = blockIdx.x % a.k;
  const long r0 = (long)q * a.rpc;
  const long nv = (a.S - r0 < a.rpc ? a.S - r0 : a.rpc) * cv;  // vectors of this chunk
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);
  auto chunk = [&](int s) { return ((long)s * a.S + r0) * C; };  // first element

  if (!STREAM && t < active) {
    const T* src = x + chunk(g);
    for (long v = t; v < nv; v += active) copy_in<T, V>(buf + v * V, src + v * V);
  }
  cp_async_commit();

  for (int s = g; s < a.B; s += a.G) {
    unsigned* sync = a.sync + 4L * s;
    // streaming: the coefficients' generation, read before this CTA arrives
    // (it moves only after every CTA has)
    const unsigned coef_gen = STREAM && t == 0 ? ld_acquire(sync + 3) : 0u;
    cp_async_wait_all();  // this thread's own vectors: no barrier before the sums
    const T* in = STREAM ? x + chunk(s) : buf;
    float s1[V], s2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.f;
    if (t < active) {
#pragma unroll 4
      for (long v = t; v < nv; v += active) {
        float f[V];
        lu::load_vec<T, V>(in + v * V, f);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          s1[j] += f[j];
          s2[j] += f[j] * f[j];
        }
      }
    }
    if (shuffled) {
      for (int o = 16; o >= cv; o >>= 1) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], o);
          s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], o);
        }
      }
    }
    if (holder >= 0) {
      float* r = red + ((size_t)holder * cv + lane) * 2 * V;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        r[j] = s1[j];
        r[V + j] = s2[j];
      }
    }
    __syncthreads();

    // the chunk's per-channel sums, float64, holders in order
    double* part = a.part + (long)s * (a.k + 1) * C * 2;
    for (int c = t; c < C; c += blockDim.x) {
      const float* r = red + (size_t)(c / V) * 2 * V + c % V;
      double st[2] = {0.0, 0.0};
      for (int i = 0; i < nh; ++i) {
        st[0] += r[(size_t)i * cv * 2 * V];
        st[1] += r[(size_t)i * cv * 2 * V + V];
      }
      if (a.k == 1) {
        lu::norm_coeffs(st, a.scale[c], a.bias[c], (double)a.S, a.eps, &ab[c], &ab[C + c]);
      } else {
        part[((long)q * C + c) * 2] = st[0];
        part[((long)q * C + c) * 2 + 1] = st[1];
      }
    }
    if (STREAM && a.k > 1) {
      // one warp a channel sums the k partials (lanes in a fixed order, then
      // a shuffle tree) in the first nr CTAs and publishes (a, b) in slot k;
      // the other CTAs arrive without waiting and wait for the coefficients
      const int warps = blockDim.x / 32, w = t / 32, l = t & 31;
      const int nr = min(a.k, (C + warps - 1) / warps);
      double* coef = part + (long)a.k * C * 2;
      if (t < C) __threadfence();
      __syncthreads();
      if (q < nr) {
        if (t == 0) arrive_and_wait(sync, a.k);
        __syncthreads();
        for (int c = q * warps + w; c < C; c += nr * warps) {  // the same c across a warp
          double st[2] = {0.0, 0.0};
#pragma unroll 8
          for (int i = l; i < a.k; i += 32) {
            st[0] += __ldcg(part + ((long)i * C + c) * 2);
            st[1] += __ldcg(part + ((long)i * C + c) * 2 + 1);
          }
          for (int o = 16; o > 0; o >>= 1) {
            st[0] += __shfl_xor_sync(0xffffffffu, st[0], o);
            st[1] += __shfl_xor_sync(0xffffffffu, st[1], o);
          }
          if (l == 0) {
            float ca, cb;
            lu::norm_coeffs(st, a.scale[c], a.bias[c], (double)a.S, a.eps, &ca, &cb);
            coef[2 * c] = ca;
            coef[2 * c + 1] = cb;
            __threadfence();
          }
        }
        __syncthreads();
        if (t == 0) arrive_and_wait(sync + 2, nr);
      } else if (t == 0) {
        arrive(sync, a.k);
        wait_moved(sync + 3, coef_gen);
      }
      __syncthreads();
      for (int c = t; c < C; c += blockDim.x) {
        ab[c] = static_cast<float>(__ldcg(coef + 2 * c));
        ab[C + c] = static_cast<float>(__ldcg(coef + 2 * c + 1));
      }
    } else if (!STREAM && a.k > 1) {
      if (t < C) __threadfence();
      __syncthreads();
      if (t == 0) arrive_and_wait(sync, a.k);
      __syncthreads();
      // the sample's k partials in float64, in one fixed order for every CTA
      // and run: R lanes per channel each sum every R-th chunk (their loads
      // from L2 in flight together), then a shuffle tree over the R lanes
      int R = 1;
      while (R < 32 && 2 * R * C <= (int)blockDim.x) R *= 2;
      for (int base = 0; base < C * R; base += blockDim.x) {  // same trip count in every thread
        const int c = (base + t) / R, r = t % R;
        double st[2] = {0.0, 0.0};
        if (c < C) {
#pragma unroll 4
          for (int i = r; i < a.k; i += R) {
            st[0] += __ldcg(part + ((long)i * C + c) * 2);
            st[1] += __ldcg(part + ((long)i * C + c) * 2 + 1);
          }
        }
        for (int o = R / 2; o > 0; o >>= 1) {
          st[0] += __shfl_xor_sync(0xffffffffu, st[0], o);
          st[1] += __shfl_xor_sync(0xffffffffu, st[1], o);
        }
        if (c < C && r == 0)
          lu::norm_coeffs(st, a.scale[c], a.bias[c], (double)a.S, a.eps, &ab[c], &ab[C + c]);
      }
    }
    __syncthreads();

    // apply from shared memory; each freed vector takes the next sample's copy
    if (t < active) {
      float ca[V], cb[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        ca[j] = ab[lane * V + j];
        cb[j] = ab[C + lane * V + j];
      }
      T* dst = y + chunk(s);
      if constexpr (STREAM) {  // backwards from the chunk's end, the same lane
        for (long v = nv - active + t; v >= 0; v -= active) {
          float f[V];
          load_vec_cs<T, V>(in + v * V, f);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float u = f[j] * ca[j] + cb[j];
            f[j] = u > 0.f ? u : a.slope * u;
          }
          store_vec_cs<T, V>(dst + v * V, f);
        }
      } else {
        const bool next = s + a.G < a.B;
        const T* src = x + (next ? chunk(s + a.G) : 0);
        for (long v = t; v < nv; v += active) {
          float f[V];
          lu::load_vec<T, V>(in + v * V, f);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float u = f[j] * ca[j] + cb[j];
            f[j] = u > 0.f ? u : a.slope * u;
          }
          lu::store_vec<T, V>(dst + v * V, f);
          if (next) copy_in<T, V>(buf + v * V, src + v * V);
        }
      }
    }
    cp_async_commit();
  }
}

using Kernel = void (*)(Args);

template <typename T, bool STREAM>
Kernel kernel_for(int C) {
  constexpr int VW = lu::vec_width<T>();
  return C % VW == 0 ? &in_leaky<T, VW, STREAM> : &in_leaky<T, 1, STREAM>;
}

int element_size(int dtype) { return dtype == lu::kBF16 ? 2 : dtype == lu::kF32 ? 4 : 0; }

Kernel kernel_of(int dtype, int C, bool stream) {
  if (dtype == lu::kBF16)
    return stream ? kernel_for<__nv_bfloat16, true>(C) : kernel_for<__nv_bfloat16, false>(C);
  return stream ? kernel_for<float, true>(C) : kernel_for<float, false>(C);
}

// the kernel's limit set to the device's whole opt-in (one instantiation
// serves plans of many sizes); then the CTAs of it resident per SM
cudaError_t occupancy(Kernel kern, int threads, size_t smem, int smem_block, int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_block);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, threads, smem);
}

long ceil_div(long n, long d) { return (n + d - 1) / d; }

}  // namespace

// The plan of a call on the current device: plan = (k chunks per sample,
// rows per chunk, G samples per round, threads per CTA, shared bytes per CTA,
// CTAs resident per SM, SMs, streaming 0/1).  Sets the kernel's
// shared-memory limit, so a call's plan is made before its first launch on a
// device.
extern "C" int instance_norm_plan(int dtype, int B, int64_t S, int C, int64_t* plan) {
  const int elt = element_size(dtype);
  if (!elt || B < 1 || S < 1 || C < 1) return cudaErrorInvalidValue;
  const Shape sh = shape_of(C, elt);
  if (sh.threads > kMaxThreads) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, smem_sm = 0, smem_block = 0, reserved = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e != cudaSuccess) return e;
  const long row = (long)C * elt;
  const long fixed = (long)smem_of(sh, C, elt, 0, true).total;  // reduction buffer + coefficients
  long rpc = S, k = 1;
  if ((long)smem_of(sh, C, elt, S, false).total > smem_block) {
    const long cap = ((long)smem_sm / kCtasPerSmTarget - reserved - fixed) / 16 * 16;
    const long rows_cap = cap / row;
    if (rows_cap < 1) return cudaErrorInvalidConfiguration;
    k = ceil_div(S, rows_cap);
    rpc = ceil_div(S, k);
    k = ceil_div(S, rpc);
  }
  size_t smem = smem_of(sh, C, elt, rpc, false).total;
  int per_sm = 0;
  e = occupancy(kernel_of(dtype, C, false), sh.threads, smem, smem_block, &per_sm);
  if (e != cudaSuccess) return e;
  const bool stream = k > (long)per_sm * sms;
  if (stream) {  // the whole grid on one sample at a time
    smem = smem_of(sh, C, elt, 0, true).total;
    e = occupancy(kernel_of(dtype, C, true), sh.threads, smem, smem_block, &per_sm);
    if (e != cudaSuccess) return e;
    rpc = ceil_div(S, (long)per_sm * sms);
    k = ceil_div(S, rpc);
  }
  const long groups = (long)per_sm * sms / k < B ? (long)per_sm * sms / k : B;
  const int64_t v[8] = {k, rpc, groups, sh.threads, (int64_t)smem, per_sm, sms, stream};
  for (int i = 0; i < 8; ++i) plan[i] = v[i];
  return groups >= 1 ? 0 : (int)cudaErrorCooperativeLaunchTooLarge;
}

// x, y: [B, S, C] in dtype, 16-byte aligned when C * sizeof(T) is a multiple
// of 16; scale, bias: [C] float32; plan: from instance_norm_plan for the same
// (dtype, B, S, C) on this device; part: [B][k + 1][C][2] float64 scratch;
// sync: [B][4] uint32, zero when first used and left ready by every call.
// One cooperative launch, no memset.
extern "C" int instance_norm_leaky(const void* x, const void* scale, const void* bias, void* y,
                                   void* part, void* sync, int dtype, int B, int64_t S, int C,
                                   const int64_t* plan, float eps, float slope, void* stream) {
  const int elt = element_size(dtype);
  if (!elt || B < 1 || S < 1 || C < 1) return cudaErrorInvalidValue;
  const Shape sh = shape_of(C, elt);
  const long k = plan[0], rpc = plan[1], groups = plan[2];
  const bool streams = plan[7] != 0;
  const Smem sm = smem_of(sh, C, elt, rpc, streams);
  if (rpc < 1 || k != ceil_div(S, rpc) || groups < 1 || groups > B || plan[3] != sh.threads ||
      plan[4] != (int64_t)sm.total)
    return cudaErrorInvalidValue;
  if (sh.V > 1 && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15))
    return cudaErrorMisalignedAddress;
  Args a{x, y, static_cast<const float*>(scale), static_cast<const float*>(bias),
         static_cast<double*>(part), static_cast<unsigned*>(sync), (long)S, rpc, B, C,
         (int)k, (int)groups, (int)sm.red_off, eps, slope};
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel_of(dtype, C, streams)),
                                     dim3((unsigned)(groups * k)), dim3(sh.threads), args,
                                     sm.total, static_cast<cudaStream_t>(stream));
}
