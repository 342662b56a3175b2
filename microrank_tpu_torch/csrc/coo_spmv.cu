// K1 on Hopper: the COO segment-sum SpMVs of the PageRank power
// iteration, all of one step in one launch.
//
// Replaces the TPU kernel microrank_tpu/ops/pallas_spmv.py:95
// `coo_segment_sum_pallas` (body `_spmv_kernel`, wrapper
// `coo_matvec_pallas`): y[r] = sum over entries e with rows[e] == r of
// vals[e] * x[cols[e]]. On the TPU that is an iota one-hot [1024, 2048]
// per block, multiplied on the MXU into a VMEM accumulator carried
// across a sequential grid. Nothing of that carries over: Hopper blocks
// run in parallel and in no order, and a one-hot product spends
// O(E * V) multiply-adds on an O(E) problem.
//
// What bounds it on the card: bytes, then row balance and launches.
// Each entry moves 8 bytes (col + val) plus a 4-byte gather of x for 2
// flops, far below the H100's ratio of float32 rate to memory rate, so
// tensor cores, TMA and wgmma do not apply. A power-iteration step is
// six small SpMVs (p_sr, p_ss, p_rs of two partitions) whose byte bound
// is a few microseconds in all; the first design (one warp per row, one
// launch per matrix, kept below as `coo_spmv_rows` for comparison) lost
// that to two things: an operation present in every trace makes a row
// of T entries that one warp walks in T / 32 dependent steps, and six
// launches each pay a fixed floor larger than the work of most of them.
//
// Design: the wrapper (ops/spmv.py) builds, once per window, a stable
// row sort of each matrix (one row's entries keep the graph build's
// order) and one work list for all six: every row is cut into chunks of
// at most kChunk = 256 entries at positions [j * kChunk, (j+1) * kChunk)
// of the row, and an empty row gets one empty item, so every output is
// written by the launch with no memset. One warp takes one item: lane l
// sums positions begin + l, + l + 32, ... in order (8 at most, loaded
// before any add so the loads overlap while the adds stay in order),
// then the fixed shuffle tree 16, 8, 4, 2, 1. A row of one chunk is
// written by lane 0. A row of several chunks stores each chunk's sum in
// `part`, and the warp that arrives last on the row's integer counter
// folds the row's partials left to right in chunk order,
// ((p0 + p1) + p2) ..., writes y and resets the counter for the next
// launch. There are no float atomics: every sum's order is a function of
// the row alone, so results are bitwise repeatable and two rows with
// the same value sequence give bitwise-equal sums (exact score ties
// survive, as the ranking's tie-broken top-k requires). __fmul_rn /
// __fadd_rn keep the compiler from contracting into FMAs, so the plain
// version in ops/spmv.py repeats this arithmetic exactly.
//
// What remains is latency: a warp's chain of dependent loads (work item
// -> cols/vals -> x) and the number of warps that can wait on it at
// once. So each item carries what its warp needs (x slot, output index,
// range, chunk), with no per-matrix table to read in between; the
// columns are checked against x once per window when the work list is
// built (ops/spmv.py), not per entry here, since a device assert inside
// the loop keeps the compiler from issuing the gathers ahead; and the
// launch bounds ask for eight blocks per SM (64 warps: 32 registers, no
// spills with CUDA 12.8). A step passes its x vectors (one per slot)
// and y by value in a kernel-argument struct: one launch, no
// host-to-device copy. x (a few to tens of KB) stays in L1/L2: staging
// it in shared memory per block would read more bytes than the matrices
// hold.
//
// The same launch computes the six SpMVs of the pcsr kernel (K9,
// microrank_tpu/rank_backends/jax_tpu.py:715), over a work list that
// rank_backends/torch_cuda.py builds from the partition-centric views and
// whose rows are those of the pallas work list. There the trace rows hold
// a few entries each, so a step of a giant window is millions of
// near-empty items, one warp each: the warp's fixed cost, not bytes, sets
// the time (PERF.md).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (ops/spmv.py build_command); bound with ctypes (plain C interface).

#include <cassert>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kMinBlocksPerSm = 8;
constexpr int kChunk = 256;  // ops/spmv.py CHUNK: it fixes the bits
constexpr int kPerLane = kChunk / kWarp;
constexpr int kMaxX = 8;     // ops/spmv.py MAX_X
constexpr unsigned kFull = 0xffffffffu;

// One step's vectors, passed by value: no host-to-device copy.
struct StepArgs {
  const float* x[kMaxX];
  float* y;
};

// Work item (ops/spmv.py ITEM_FIELDS): int32 x 6. `y` indexes the flat
// output of all matrices; [begin, end) the flat cols / vals.
enum { kSlot, kY, kBegin, kEnd, kChunkIdx, kNChunks, kItemInts };

__device__ __forceinline__ float warp_tree(float acc) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_down_sync(kFull, acc, off));
  }
  return acc;
}

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock, kMinBlocksPerSm)
coo_spmv_chunks(const int32_t* __restrict__ items, int32_t n_items,
                const int32_t* __restrict__ cols,
                const float* __restrict__ vals,
                float* __restrict__ part, int32_t* __restrict__ counters,
                StepArgs args) {
  const int32_t item =
      static_cast<int32_t>(blockIdx.x) * kWarpsPerBlock +
      static_cast<int32_t>(threadIdx.x) / kWarp;
  const int lane = static_cast<int>(threadIdx.x) % kWarp;
  // `item` is uniform across a warp, so whole warps leave together and
  // the full-mask shuffles below stay legal.
  if (item >= n_items) return;
  const int32_t* it = items + static_cast<int64_t>(item) * kItemInts;
  const int32_t slot = __ldg(it + kSlot);
  const int32_t yi = __ldg(it + kY);
  const int32_t begin = __ldg(it + kBegin);
  const int32_t end = __ldg(it + kEnd);
  const int32_t chunk = __ldg(it + kChunkIdx);
  const int32_t n_chunks = __ldg(it + kNChunks);
  // Select the slot's vector without indexing the parameter struct by
  // a register (which would copy it to local memory).
  const float* x = args.x[0];
#pragma unroll
  for (int s = 1; s < kMaxX; ++s) {
    if (slot == s) x = args.x[s];
  }

  // All loads first (independent), then the adds in position order.
  float prod[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int32_t p = begin + lane + k * kWarp;
    prod[k] = 0.0f;
    if (p < end) {
      prod[k] = __fmul_rn(__ldg(vals + p), __ldg(x + __ldg(cols + p)));
    }
  }
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    if (begin + lane + k * kWarp < end) acc = __fadd_rn(acc, prod[k]);
  }
  acc = warp_tree(acc);

  if (n_chunks == 1) {
    if (lane == 0) args.y[yi] = acc;
    return;
  }
  // Several chunks: publish this chunk's sum, then count the arrival.
  int last = 0;
  if (lane == 0) {
    __stcg(part + item, acc);
    __threadfence();
    last = atomicAdd(counters + yi, 1) == n_chunks - 1;
    if (last) __threadfence();  // acquire the other chunks' partials
  }
  last = __shfl_sync(kFull, last, 0);
  if (!last) return;
  __syncwarp();  // orders every lane's loads after lane 0's fence
  // The last arriver folds chunks 0 .. n_chunks-1 left to right. Lanes
  // load 32 partials at a time from L2 (L1 is not coherent across SMs,
  // so it is bypassed), and every lane walks them in order through
  // shuffles, so all lanes hold the same sum.
  const int32_t first = item - chunk;  // part slot of chunk 0
  float sum = 0.0f;
  for (int32_t base = 0; base < n_chunks; base += kWarp) {
    const float v =
        base + lane < n_chunks ? __ldcg(part + first + base + lane) : 0.0f;
    const int32_t m = min(kWarp, n_chunks - base);  // warp-uniform
    for (int32_t k = 0; k < m; ++k) {
      const float pk = __shfl_sync(kFull, v, k);
      sum = base + k == 0 ? pk : __fadd_rn(sum, pk);
    }
  }
  if (lane == 0) {
    args.y[yi] = sum;
    counters[yi] = 0;  // ready for the next launch on this work list
  }
}

// The first design, kept only so chip_smoke.py can time it beside the
// chunked kernel on the same card: one warp per row of one matrix.
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
coo_spmv_rows(const int32_t* __restrict__ indptr,
              const int32_t* __restrict__ cols,
              const float* __restrict__ vals,
              const float* __restrict__ x,
              float* __restrict__ y,
              int32_t n_rows,
              int32_t n_x) {
  const int32_t row =
      static_cast<int32_t>(blockIdx.x) * kWarpsPerBlock +
      static_cast<int32_t>(threadIdx.x) / kWarp;
  const int lane = static_cast<int>(threadIdx.x) % kWarp;
  if (row >= n_rows) return;
  const int32_t beg = indptr[row];
  const int32_t end = indptr[row + 1];
  float acc = 0.0f;
#pragma unroll 4
  for (int32_t p = beg + lane; p < end; p += kWarp) {
    const int32_t c = cols[p];
    // The graph build pads with col 0, so an out-of-range column is a
    // bug upstream: stop here instead of clamping it silently.
    assert(c >= 0 && c < n_x);
    acc = __fadd_rn(acc, __fmul_rn(vals[p], __ldg(x + c)));
  }
  acc = warp_tree(acc);
  if (lane == 0) y[row] = acc;
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

// One launch for a whole work list (all matrices of a step) on `stream`
// (PyTorch's current stream of `device`). `xs` is a host array of
// `n_xs` <= 8 device pointers, copied into the kernel's arguments.
// Returns the CUDA error code of the launch (0 = launched). Allocates
// nothing and does not synchronize. One work list must not be in
// flight on two streams at once: its counters and partials are shared.
int mr_coo_spmv_group(const int32_t* items, int32_t n_items,
                      const int32_t* cols, const float* vals, float* part,
                      int32_t* counters, const float* const* xs,
                      int32_t n_xs, float* y,
                      int device, void* stream) {
  if (n_items <= 0) return 0;
  if (n_xs < 1 || n_xs > kMaxX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  StepArgs args{};
  for (int s = 0; s < n_xs; ++s) args.x[s] = xs[s];
  args.y = y;
  const int blocks = (n_items + kWarpsPerBlock - 1) / kWarpsPerBlock;
  coo_spmv_chunks<<<blocks, kWarp * kWarpsPerBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      items, n_items, cols, vals, part, counters, args);
  return static_cast<int>(cudaGetLastError());
}

// The first design's warp-per-row launch of one matrix; only
// chip_smoke.py calls it.
int mr_coo_spmv_rows(const int32_t* indptr, const int32_t* cols,
                     const float* vals, const float* x, float* y,
                     int32_t n_rows, int32_t n_x, int device, void* stream) {
  if (n_rows <= 0) return 0;
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  coo_spmv_rows<<<blocks, kWarp * kWarpsPerBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      indptr, cols, vals, x, y, n_rows, n_x);
  return static_cast<int>(cudaGetLastError());
}

const char* mr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
