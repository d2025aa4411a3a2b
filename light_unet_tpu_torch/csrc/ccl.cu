// 6-connected component labelling of a [D, H, W] foreground mask: each
// component is labelled with the largest flat index of its voxels + 1, and
// the background with 0.
//
// Replaces the lax sweeps of light_unet_tpu/ops/ccl.py:label_propagate (:57)
// (a masked running max forward and backward along each axis, repeated in a
// lax.while_loop until a round changes nothing).  That loop is no Pallas TPU
// kernel; it is ported as a kernel because its round count depends on the
// data, so that on the card the loop either reads a device value on the host
// every round or cannot be captured in a CUDA graph.  This kernel gives the
// same labels in three launches, a count fixed by the shape, reads no value
// on the host and allocates nothing, so a graph captures it as it is.
//
// Bound on the card: memory bandwidth.  The function must read the mask
// (1 byte a voxel) and write the labels (4 bytes): 5 B a voxel.
//
// Design: a block-based union-find.  The volume is cut into tiles of
// kTZ x kTY x 32 voxels, 32 along the last axis so that a row of a tile is
// one warp and its loads and stores coalesce; the ragged edge of each axis
// counts as background.  The global forest is the label array itself: a
// foreground voxel's slot holds its parent's flat index + 1, a background
// voxel's 0, so that a root's slot already holds its label.
//   - ccl_tile, a block a tile, a warp a z-plane of it: each row's mask is a
//     ballot in shared memory, and the last voxel of each run of the row is
//     a node of a forest of local indices in shared memory.  Each warp
//     walks its plane's rows in order and unites, for each contact segment
//     with the row at -y, the two runs' nodes; the planes are then united
//     with the plane at -z, one union a contact segment; the lanes of a warp
//     that read the same pair of parents make one union (__match_any_sync).
//     Finds halve their paths, roots are hooked by shared atomicCAS, and
//     after each phase every node is pointed at its root.  A tile with no
//     foreground, or all foreground, takes none of this.  Each voxel's slot
//     gets its run's root as a flat index + 1.  Inside a tile the order of
//     (z, y, x) is the order of the flat index, so the local root, the
//     largest local index of its piece, is the piece's largest flat index;
//   - ccl_faces, a block a tile: only the voxels on the tile's low faces
//     (-x, -y, -z) with a foreground neighbour across the face unite, in
//     the global forest, their trees with the neighbour's.  A union already
//     made through the neighbouring voxel on the face is dropped (on the -y
//     and -z faces the voxel to the left, on the -x face the voxel at -y in
//     the tile), and a block unites each pair of slots it reads once (a
//     warp's lanes by __match_any_sync, the block's warps by a set in
//     shared memory);
//   - ccl_finalize: each foreground voxel resolves through its slot;
//     neighbouring lanes of a warp that share a slot (mostly their tile's
//     root) walk the chain once, and each voxel stores root + 1 in its own
//     slot.
// Why the labels cannot depend on the order of the races: a root is only
// ever hooked under a LARGER root, by atomicCAS on the root's own slot (in
// shared memory inside a tile, in the label array across tiles), so every
// parent points to a larger index, whatever the order, and the one root
// left of a component is its largest flat index.  Finds halve their path as
// they go (a store of a grandparent: a benign race, since any ancestor is a
// valid parent); a stale read only finds an ancestor, and a failed CAS hands
// back the root's new parent, so every retry climbs.  Outside the unions a
// tile's forest is only ever written with roots.  In ccl_finalize another
// voxel's walk reads a slot before or after its store, the old parent or
// the root, both ancestors; no store but a voxel's own touches its slot, so
// the last value of every slot is its root + 1.
// Contention: one union a contact segment of the whole volume, all in the
// global forest, chases and CASes along one growing tree on a percolating
// mask (7.5 ms for a random 0.6 mask of 144x144x288 on an H100).  Here the
// unions inside a tile stay in shared memory, and the global forest sees one
// union a distinct pair of slots a tile face: a few a face on such a mask,
// none on most faces of a closed body mask.
#include "common.cuh"

namespace {

constexpr int kTZ = 8, kTY = 8, kTX = 32;  // a tile: kTZ x kTY rows of 32 voxels
constexpr int kRows = kTZ * kTY;
constexpr int kTile = kRows * kTX;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
static_assert(kTY == kWarps && kTZ == kWarps, "a warp a z-plane of a tile, a row of each face");
static_assert(kTile <= 1 << 16, "two local indices make one 32-bit key");

// the last lane of lane's run of foreground in the row of ballot m
__device__ __forceinline__ int run_end(unsigned m, int lane) {
  const unsigned gaps = ~m >> lane;  // bit k: lane + k is background
  return gaps ? lane + __ffs(gaps) - 2 : kTX - 1;
}

// ---- the tile's forest in shared memory: its nodes are the runs' last
// voxels, parents local indices

__device__ __forceinline__ int find_local(volatile int* par, int i) {
  int p;
  while ((p = par[i]) != i) {
    const int gp = par[p];
    if (gp != p) par[i] = gp;  // halve: any ancestor is a valid parent
    i = p;
  }
  return i;
}

__device__ __forceinline__ void unite_local(int* par, int a, int b) {
  a = find_local(par, a);
  b = find_local(par, b);
  while (a != b) {
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicCAS(par + a, a, b);
    if (old == a) return;
    a = find_local(par, old);  // a was hooked meanwhile: go on from its new root
  }
}

// lanes with `want` unite nodes a and b through the parents they read
// first; lanes that read the same pair make one union.  Every lane calls.
__device__ __forceinline__ void unite_lanes(int* par, bool want, int a, int b) {
  const unsigned lanes = __ballot_sync(kAll, want);
  if (!want) return;
  a = par[a];
  b = par[b];
  const unsigned peers = __match_any_sync(lanes, static_cast<unsigned>(a) << 16 | b);
  if ((threadIdx.x & 31) == __ffs(peers) - 1) unite_local(par, a, b);
}

// ---- the global forest: the label array, slots hold parent + 1

// the root of i's tree; halves the path on the way (parents only grow)
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
    a = find_root(forest, old - 1);
  }
}

// a block's set of the pairs it has united (open addressing in shared memory)
constexpr int kPairs = 512;
constexpr unsigned long long kEmpty = ~0ull;

// true for the first caller of the block with `key`, and when the set is crowded
__device__ __forceinline__ bool first_in_block(unsigned long long* set, unsigned long long key) {
  const unsigned h = static_cast<unsigned>((key * 0x9E3779B97F4A7C15ull) >> 55);
  for (int probe = 0; probe < 8; ++probe) {
    const unsigned long long old = atomicCAS(set + ((h + probe) & (kPairs - 1)), kEmpty, key);
    if (old == kEmpty) return true;
    if (old == key) return false;
  }
  return true;
}

// lanes with `want` unite the trees of foreground voxels i and j; the pairs
// of slots they read are united once a block.  Every lane of the warp calls.
__device__ __forceinline__ void unite_face(int* forest, unsigned long long* pairs, bool want, int i,
                                           int j) {
  const unsigned lanes = __ballot_sync(kAll, want);
  if (!want) return;
  const int a = forest[i] - 1, b = forest[j] - 1;
  const unsigned long long key =
      (static_cast<unsigned long long>(static_cast<unsigned>(a)) << 32) | static_cast<unsigned>(b);
  const unsigned peers = __match_any_sync(lanes, key);
  if ((threadIdx.x & 31) == __ffs(peers) - 1 && first_in_block(pairs, key)) unite(forest, a, b);
}

// the root of node v (a walk that writes nothing), stored in v's slot and
// returned: every store into the tile's forest outside a union is a root
__device__ __forceinline__ int point_at_root(int* par, int v) {
  int root = v;
  while (par[root] != root) root = par[root];
  par[v] = root;
  return root;
}

__global__ void __launch_bounds__(kThreads) ccl_tile(const uint8_t* __restrict__ fg,
                                                     int* __restrict__ labels, int D, int H, int W) {
  __shared__ unsigned bits[kRows];  // a row's foreground, bit x - x0
  __shared__ int par[kTile];        // read and written at the runs' last voxels (nodes) only
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;  // a warp a z-plane of the tile
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY, z0 = blockIdx.z * kTZ;
  const int x = x0 + lane, z = z0 + warp, plane = warp * kTY;  // the plane's first row
  bool on[kTY];
#pragma unroll
  for (int k = 0; k < kTY; ++k) {  // every load in flight before the first ballot
    const int y = y0 + k;
    on[k] = x < W && y < H && z < D && fg[(z * H + y) * W + x];
  }
  bool any = false, full = true;
#pragma unroll
  for (int k = 0; k < kTY; ++k) {
    const unsigned m = __ballot_sync(kAll, on[k]);
    if (lane == 0) bits[plane + k] = m;
    if (on[k] && run_end(m, lane) == lane) par[(plane + k) * kTX + lane] = (plane + k) * kTX + lane;
    any |= m != 0;
    full &= m == kAll;
  }
  const bool some = __syncthreads_or(any), all = __syncthreads_and(full);
  if (some && !all) {
    // the plane's rows in order, in its own warp: each contact segment with
    // the row at -y unites the two runs' nodes; then every node of the plane
    // is pointed at its plane root (a plane without a union has only roots)
    unsigned starts = 0;  // the union of the rows' contact segment starts
#pragma unroll 1
    for (int k = 1; k < kTY; ++k) {
      const int r = plane + k;
      const unsigned m = bits[r], n = bits[r - 1], c = m & n;
      starts |= c & ~(c << 1);
      unite_lanes(par, (c & ~(c << 1)) >> lane & 1, r * kTX + run_end(m, lane),
                  (r - 1) * kTX + run_end(n, lane));
      __syncwarp();
    }
    unsigned roots = 0;  // bit k: this lane's voxel in row k is a plane root
#pragma unroll 1
    for (int k = 0; k < kTY; ++k) {
      const int v = (plane + k) * kTX + lane;
      if (bits[plane + k] >> lane & 1 && run_end(bits[plane + k], lane) == lane &&
          (!starts || point_at_root(par, v) == v))
        roots |= 1u << k;
    }
    __syncthreads();
    // the plane's rows against the plane at -z, each contact segment a union
    // of the two plane roots (the only slots its finds and hooks write); then
    // the plane roots are pointed at the tile's roots, so that a node's root
    // is its plane root's parent
    unsigned contacts = 0;
    if (warp > 0) {
#pragma unroll 1
      for (int k = 0; k < kTY; ++k) {
        const int r = plane + k;
        const unsigned m = bits[r], n = bits[r - kTY], c = m & n;
        contacts |= c;
        unite_lanes(par, (c & ~(c << 1)) >> lane & 1, r * kTX + run_end(m, lane),
                    (r - kTY) * kTX + run_end(n, lane));
      }
    }
    if (__syncthreads_or(contacts != 0)) {  // else the plane roots are the tile's roots
#pragma unroll 1
      for (int k = 0; k < kTY; ++k)
        if (roots >> k & 1) point_at_root(par, (plane + k) * kTX + lane);
      __syncthreads();
    }
  }
  // no foreground: 0; all foreground: the tile's last voxel is every voxel's root
#pragma unroll
  for (int k = 0; k < kTY; ++k) {
    const int y = y0 + k;
    if (z >= D || y >= H || x >= W) continue;
    const int r = plane + k;
    const int root = all ? kTile - 1 : on[k] ? par[par[r * kTX + run_end(bits[r], lane)]] : -1;
    labels[(z * H + y) * W + x] =
        on[k] ? ((z0 + root / (kTY * kTX)) * H + y0 + root / kTX % kTY) * W + x0 + root % kTX + 1
              : 0;
  }
}

// contacts across the tile's low faces, one union a contact segment: on the
// -z and -y faces one warp a row (a contact whose left neighbour is a contact
// too is united through it), on the -x face one lane a row (a contact whose
// -y neighbour in the tile is a contact too is united through it).  Every
// load is issued before the first union.
__global__ void __launch_bounds__(kThreads) ccl_faces(const uint8_t* __restrict__ fg, int* forest,
                                                      int D, int H, int W) {
  __shared__ unsigned long long pairs[kPairs];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY, z0 = blockIdx.z * kTZ;
  const int x = x0 + lane, hw = H * W;
  for (int k = threadIdx.x; k < kPairs; k += kThreads) pairs[k] = kEmpty;
  const bool in = x < W, left = lane == 0 && x0 > 0;
  const bool fz = z0 > 0 && y0 + warp < H, fy = y0 > 0 && z0 + warp < D;  // warp-uniform
  const int iz = (z0 * H + y0 + warp) * W + x, iy = ((z0 + warp) * H + y0) * W + x;
  const bool cz = fz && in && (fg[iz] & fg[iz - hw]);
  const bool lz = fz && left && (fg[iz - 1] & fg[iz - 1 - hw]);
  const bool cy = fy && in && (fg[iy] & fg[iy - W]);
  const bool ly = fy && left && (fg[iy - 1] & fg[iy - 1 - W]);
  const int r = warp * 32 + lane, zx = z0 + r / kTY, yx = y0 + r % kTY;
  const bool fx = x0 > 0 && r < kRows && zx < D && yx < H;
  const int ix = (zx * H + yx) * W + x0;
  const bool cx = fx && (fg[ix] & fg[ix - 1]);
  const bool ax = fx && r % kTY > 0 && (fg[ix - W] & fg[ix - W - 1]);
  __syncthreads();
  const unsigned mz = __ballot_sync(kAll, cz), my = __ballot_sync(kAll, cy);
  unite_face(forest, pairs, cz && !(lane ? mz >> (lane - 1) & 1 : lz), iz, iz - hw);
  unite_face(forest, pairs, cy && !(lane ? my >> (lane - 1) & 1 : ly), iy, iy - W);
  if (warp * 32 < kRows) unite_face(forest, pairs, cx && !ax, ix, ix - 1);
}

constexpr int kChunks = 8;  // rows of 32 voxels a warp finalizes, their loads in flight together

// each foreground voxel stores its root + 1; neighbouring lanes of a warp
// that share a slot (mostly their tile's root) walk the chain once
__global__ void __launch_bounds__(kThreads) ccl_finalize(const uint8_t* __restrict__ fg, int* forest,
                                                         int n) {
  const int lane = threadIdx.x & 31;
  const long base = ((blockIdx.x * (long)kThreads + threadIdx.x) >> 5) * (32 * kChunks) + lane;
  int slot[kChunks];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) slot[k] = base + 32 * k < n && fg[base + 32 * k];
#pragma unroll
  for (int k = 0; k < kChunks; ++k)
    if (slot[k]) slot[k] = forest[base + 32 * k];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    // a lane leads the lanes after it that hold its slot (a tile's row of
    // voxels mostly holds one)
    const int left = __shfl_up_sync(kAll, slot[k], 1);  // every lane: a collective
    const bool first = lane == 0 || left != slot[k];
    const int leader = 31 - __clz(__ballot_sync(kAll, first) & (2u << lane) - 1);
    int root = slot[k] - 1;
    if (slot[k] && lane == leader) {
      int next;
      while ((next = forest[root] - 1) > root) root = next;
    }
    root = __shfl_sync(kAll, root, leader);
    if (slot[k] && root + 1 != slot[k]) forest[base + 32 * k] = root + 1;
  }
}

}  // namespace

// fg: [D, H, W] uint8 {0, 1}; labels: [D, H, W] int32 out (no initial
// value needed).  D * H * W < 2^31 - 1.
extern "C" int ccl_label(const void* fg, void* labels, int D, int H, int W, void* stream) {
  const long n = (long)D * H * W;
  if (D < 1 || H < 1 || W < 1 || n >= 2147483647L || (D + kTZ - 1) / kTZ > 65535 ||
      (H + kTY - 1) / kTY > 65535)
    return cudaErrorInvalidValue;  // the grid's y and z extents
  const dim3 tiles((W + kTX - 1) / kTX, (H + kTY - 1) / kTY, (D + kTZ - 1) / kTZ);
  const unsigned blocks = (unsigned)((n + kThreads * kChunks - 1) / (kThreads * kChunks));
  auto s = static_cast<cudaStream_t>(stream);
  auto m = static_cast<const uint8_t*>(fg);
  auto f = static_cast<int*>(labels);
  ccl_tile<<<tiles, kThreads, 0, s>>>(m, f, D, H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ccl_faces<<<tiles, kThreads, 0, s>>>(m, f, D, H, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ccl_finalize<<<blocks, kThreads, 0, s>>>(m, f, (int)n);
  return cudaGetLastError();
}
