// The rank program's per-window sums in one fixed order: each row's
// live prefix summed by a pairwise tree whose shape depends on the
// row's length alone, never on its pad.
//
// Replaces the padded-axis sums of the set-up and the finish that JAX
// computes in XLA (microrank_tpu/rank_backends/jax_tpu.py:44
// `preference_vector`'s kind_sum and num_sum, :882 `_partition_finish`'s
// total; part of K6). In the port they were torch reductions over the
// padded last axis, whose order follows the tensor's shape: a stacked
// group ([B, T] at the group's widest pad) and a window's own program
// ([T] at its own pad) paired the same values differently, so a window's
// bits in a group were not its own program's.
//
// The order is the pairwise tree of tree_fold.cuh, shared with the
// set-up and epilogue kernels (rank_setup.cu, rank_epilogue.cu), which
// fold the same sums inside their own launches on the main path; this
// kernel is the tree as a launch of its own (off the main path since
// those kernels, kept as their yardstick and for its tests).
//
// What bounds it on the card: bytes. A row is read once (4 bytes an
// element, one add each), far below the card's float32 rate. Design:
// a grid of (tiles, rows); one block of 256 threads a tile of 4096
// elements, staged through shared memory by coalesced loads, each thread
// the subtree of 16 consecutive elements in registers, then the warp's
// 32 subtrees by shuffles at offsets 1, 2, 4, 8, 16 (adjacent pairs
// first, as the tree), then the block's 8 warps. A row of one tile is
// written by its block; a row of more stores each tile's subtree in
// `partial`, and the block that arrives last on the row's integer
// counter folds the row's tiles by the same tree and resets the counter
// (no float atomics). Rows up to 4096 tiles (16,777,216 elements).
// __fadd_rn keeps the adds exact IEEE adds.

#include <cstdint>

#include <cuda_runtime.h>

#include "tree_fold.cuh"

namespace {

using mr_tree::kMaxTiles;
using mr_tree::kThreads;
using mr_tree::kTile;
using mr_tree::kWarps;
using mr_tree::tile_tree;

struct FoldArgs {
  const float* x;        // [n_rows, width], row-major
  const int32_t* n;      // [n_rows] each row's live length, or null (width)
  int32_t width;
  int32_t tiles;         // ceil(width / kTile)
  float* partial;        // [n_rows, tiles] (tiles > 1)
  uint32_t* count;       // [n_rows] arrivals, 0 between launches (tiles > 1)
  float* out;            // [n_rows]
};

__global__ void __launch_bounds__(kThreads) fold_rows(FoldArgs a) {
  __shared__ float stage[kTile];
  __shared__ float warp_sums[kWarps];
  __shared__ bool last;
  const int row = blockIdx.y;
  const int tile = blockIdx.x;
  int n = a.n == nullptr ? a.width : __ldg(a.n + row);
  n = min(max(n, 0), a.width);
  const int count = min(kTile, n - tile * kTile);
  const float* src = a.x + static_cast<int64_t>(row) * a.width + static_cast<int64_t>(tile) * kTile;
  const float sum = tile_tree(src, max(count, 0), stage, warp_sums);
  if (a.tiles == 1) {
    if (threadIdx.x == 0) a.out[row] = sum;
    return;
  }
  if (threadIdx.x == 0) {
    a.partial[static_cast<int64_t>(row) * a.tiles + tile] = sum;
    __threadfence();  // release the partial before arriving
    last = atomicAdd(a.count + row, 1u) == static_cast<uint32_t>(a.tiles) - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // acquire every tile's partial
  const float total = mr_tree::fold_tiles(a.partial + static_cast<int64_t>(row) * a.tiles, n,
                                          stage, warp_sums);
  if (threadIdx.x == 0) {
    a.out[row] = total;
    a.count[row] = 0u;
  }
}

// This library links its own CUDA runtime, whose current device is not
// PyTorch's: make it `device` (a no-op after the first call).
cudaError_t use_device(int device) {
  int current = -1;
  const cudaError_t got = cudaGetDevice(&current);
  if (got == cudaSuccess && current == device) return cudaSuccess;
  return cudaSetDevice(device);
}

}  // namespace

extern "C" {

// One launch: out[r] = the tree sum of x[r, 0:n[r]] for r < n_rows
// (x row-major [n_rows, width]; n null: every row's width). With more
// than one tile a row (width > 4096), `partial` holds n_rows * tiles
// floats and `count` n_rows zeroed uint32 (left zeroed). Returns the
// CUDA error code of the launch (0 = launched); allocates nothing and
// does not synchronize.
int mr_fold_rows(const float* x, const int32_t* n, int32_t n_rows, int32_t width,
                 float* partial, uint32_t* count, float* out, int device, void* stream) {
  if (n_rows < 1 || n_rows > 65535 || width < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int32_t tiles = width > 0 ? (width + kTile - 1) / kTile : 1;
  if (tiles > kMaxTiles || (tiles > 1 && (partial == nullptr || count == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  FoldArgs a{x, n, width, tiles, partial, count, out};
  fold_rows<<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(n_rows)), kThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* mr_fold_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
