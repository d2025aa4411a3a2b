// 6-connected component labelling of a [D, H, W] foreground mask: each
// component is labelled with the largest flat index of its voxels + 1, and
// the background with 0.
//
// Replaces the lax sweeps of light_unet_tpu/ops/ccl.py:label_propagate
// (a masked running max forward and backward along each axis, repeated in a
// lax.while_loop until a round changes nothing).  That loop is no Pallas TPU
// kernel; it is ported as a kernel because its round count depends on the
// data, so that on the card the loop either reads a device value on the host
// every round or cannot be captured in a CUDA graph.  This kernel gives the
// same labels in a fixed number of launches, and keeps its union-find forest
// in the label array itself: a foreground voxel's slot holds its parent's
// flat index + 1, a background voxel's 0, so that a root's slot already
// holds its label and no other array is read or written:
//   - init: one warp a row of the last axis, 32 voxels a step from the
//     row's end back to its start: a ballot of the foreground and the run
//     end carried from the step to the right give each voxel the last index
//     of its run, its parent.  Every run is then a star whose root is its
//     largest index (a link to the next voxel instead made chains as long
//     as the runs, and finds that walked them: 21 ms for a 144x144x288
//     body mask on an H100, against 0.09 ms for this design);
//   - merge: each foreground voxel unites its tree with that of its -y
//     (and -z) foreground neighbour, unless its -x neighbour and that one's
//     -y (-z) neighbour are both foreground: their runs are already united
//     through the voxel to the left, so one union a contact segment is
//     made.  A root is only ever hooked under a LARGER root, by atomicCAS on
//     the root's own slot, so every parent pointer points to a larger index,
//     whatever the order of the races, and the one root left of a component
//     is its largest flat index.  Finds halve their path as they go (a store
//     of a grandparent: a benign race, since any ancestor is a valid
//     parent); a stale read only finds an ancestor, and a failed CAS hands
//     back the root's new parent, so every retry climbs;
//   - finalize: each foreground voxel walks to its root without writing on
//     the way and stores root + 1 in its own slot.  Another voxel's walk
//     reads that slot before or after the store, the old parent or the root,
//     both ancestors; no store but a voxel's own touches its slot, so the
//     last value of every slot is its root + 1.
// The launch count is fixed (three) and no value is read on the host, so a
// graph captures it as it is.
// Bound on the card: memory bandwidth.  The function must read the mask
// (1 byte a voxel) and write the labels (4 bytes).  The merge's reads of
// the mask's neighbours and of the forest, the finds' pointer chases, the
// atomics on shared roots and finalize's read of the forest are what this
// design adds.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// the root of i's tree (forest slots hold parent + 1); halves the path on
// the way (parents only grow)
__device__ __forceinline__ int find_root(int* forest, int i) {
  int cur = forest[i] - 1;
  if (cur == i) return i;
  int prev = i, next;
  while ((next = forest[cur] - 1) > cur) {
    forest[prev] = next + 1;
    prev = cur;
    cur = next;
  }
  return cur;
}

// unite the trees of a and b: the smaller root is hooked under the larger
__device__ __forceinline__ void unite(int* forest, int a, int b) {
  a = find_root(forest, a);
  b = find_root(forest, b);
  while (a != b) {
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicCAS(forest + a, a + 1, b + 1);
    if (old == a + 1) return;
    a = find_root(forest, old - 1);  // a was hooked meanwhile: go on from its new root
  }
}

// one warp a row of W voxels: slot = the last index of the voxel's run + 1,
// 0 on the background
__global__ void __launch_bounds__(kThreads) ccl_init(const uint8_t* __restrict__ fg,
                                                     int* __restrict__ forest, int W, long rows) {
  const int lane = threadIdx.x & 31;
  const long warps = ((long)gridDim.x * blockDim.x) >> 5;
  for (long row = (blockIdx.x * (long)blockDim.x + threadIdx.x) >> 5; row < rows; row += warps) {
    const long base = row * W;
    int carry = -1;  // the run end of the voxel right of this step, -1 if background
    for (int x0 = ((W - 1) / 32) * 32; x0 >= 0; x0 -= 32) {
      const int x = x0 + lane;
      const bool on = x < W && fg[base + x];
      const unsigned mask = __ballot_sync(0xffffffffu, on);
      int end = -1;
      if (on) {
        const unsigned gaps = ~mask >> lane;  // bit k: voxel x + k is background
        end = gaps ? x + __ffs(gaps) - 2 : (carry >= 0 ? carry : x0 + 31);
      }
      if (x < W) forest[base + x] = on ? static_cast<int>(base + end) + 1 : 0;
      carry = __shfl_sync(0xffffffffu, end, 0);
    }
  }
}

__global__ void __launch_bounds__(kThreads) ccl_merge(const uint8_t* __restrict__ fg,
                                                      int* forest, int H, int W, long n) {
  const long hw = (long)H * W;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    if (!fg[i]) continue;
    const bool left = i % W > 0 && fg[i - 1];
    if ((i / W) % H > 0 && fg[i - W] && !(left && fg[i - 1 - W]))
      unite(forest, (int)i, (int)(i - W));
    if (i >= hw && fg[i - hw] && !(left && fg[i - 1 - hw]))
      unite(forest, (int)i, (int)(i - hw));
  }
}

__global__ void __launch_bounds__(kThreads) ccl_finalize(int* forest, long n) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const int slot = forest[i];
    if (slot == 0) continue;  // background
    int cur = slot - 1, next;
    while ((next = forest[cur] - 1) > cur) cur = next;
    if (cur + 1 != slot) forest[i] = cur + 1;
  }
}

}  // namespace

// fg: [D, H, W] uint8 {0, 1}; labels: [D, H, W] int32 out (no initial
// value needed).  D * H * W < 2^31 - 1.
extern "C" int ccl_label(const void* fg, void* labels, int D, int H, int W, void* stream) {
  const long n = (long)D * H * W;
  if (D < 1 || H < 1 || W < 1 || n >= 2147483647L) return cudaErrorInvalidValue;
  const long want = (n + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < 1048576L ? want : 1048576L);
  const long rows = (long)D * H;
  const long row_blocks = (rows * 32 + kThreads - 1) / kThreads;
  auto s = static_cast<cudaStream_t>(stream);
  auto m = static_cast<const uint8_t*>(fg);
  auto f = static_cast<int*>(labels);
  ccl_init<<<(unsigned)(row_blocks < 1048576L ? row_blocks : 1048576L), kThreads, 0, s>>>(
      m, f, W, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ccl_merge<<<blocks, kThreads, 0, s>>>(m, f, H, W, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ccl_finalize<<<blocks, kThreads, 0, s>>>(f, n);
  return cudaGetLastError();
}
