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
// Stacked windows (run(batch_windows=True), dispatch_batch_windows):
// the window axis lives in the work list, not in the kernel. Each matrix
// of a group of B windows is one block-diagonal matrix (ops/spmv.py
// row_layout of [B, E] entries): window b's rows follow window b - 1's,
// and its columns are offset by b times its x length, so an x slot is a
// [B, n] tensor read by row stride, no slot is spent on a window (kMaxX
// stays 8), and a step of the whole group is still one launch. A row
// keeps its entries in its window's order, its chunks and its fold, so
// a window's sums are bitwise those of the window launched alone.
//
// The pcsr kernel (K9, microrank_tpu/rank_backends/jax_tpu.py:715) is a
// second entry, `pcsr_step`: one launch per step for all six SpMVs. Its
// op-side matrices (p_sr, long rows over traces) and call edges (p_ss)
// go through the chunked items above, unchanged. Its trace side (p_rs)
// is where a giant window's rows are: millions of traces of a few ops
// each. As work items those cost a warp, 24 bytes of item and a chain of
// three dependent loads per row of 32 bytes (at bench.py's giant window,
// 2.62 M of 2.67 M items used 4 lanes of 32). So the trace side reads the
// backward ELL slab of the partition-centric views directly, with no
// work list: row t of [t_pad, W] (W a power of two) is the trace's ops in
// ascending order, which is the pallas row's order, its padding value 0
// (a live value never is) and its live entries a prefix (both checked
// once per window by the wrapper's caller). The output index is the row.
//
// Bits: K1 sums a row of n <= 256 entries as lane l = positions l, l + 32,
// ... in order, then the tree 16, 8, 4, 2, 1. A row of W slots in ELL form
// spans L = min(W, 32) of those "virtual lanes"; lanes past L hold +0 in
// K1's tree, and x + +0 = x for every sum here (a lane sum starts at +0,
// so it is never -0), so an L-lane tree over the same lanes gives K1's
// bits. Each thread takes S = min(L, 4) neighbouring virtual lanes (one
// 16-byte load of ops and one of values per column of 32 slots), so a
// row is g = L / S threads: at W = 4 one thread a row, 32 rows a warp,
// 512 contiguous bytes per warp per array. The tree's offsets of S and
// more are shuffles between the row's threads, the smaller ones adds
// inside a thread, in the same pairs as K1. A padding slot is skipped as
// K1 skips positions past `end`: no multiply, so a non-finite x[0]
// cannot leak in. ops/spmv.py `ell_spmv_plain` repeats this order.
//
// W is the partition's longest trace, so one long trace widens every row
// of its slab. A slab of W <= 32 is one column of slots and is read whole
// (kEllSlab). A wider one carries each row's live count (`lens`, counted
// once per window), and its rows read only the columns of 32 slots and
// the 256-slot chunks that hold live entries, so the bytes follow the
// live entries, not W. Two ways, picked per slab by the wrapper from
// the mean row length (ops/spmv.py `ell_mode`): rows of 32 entries or
// fewer on average as above, S = 4, 8 threads a row (kEllShort); longer
// rows one warp a row, which is K1's chunk sum with every load of the
// chunk in flight at once (kEllWarp). A row of more than 256 entries
// walks its chunks, n / 256 rounded up (K1's chunk count), and folds
// their sums left to right, K1's order, with no partials, counters or
// atomics.
//
// The grid's first blocks run the work items, the rest the ELL rows of
// each partition in turn; the branch is on blockIdx, so it is uniform.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (ops/spmv.py build_command); bound with ctypes (plain C interface).

#include <cassert>
#include <climits>
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

constexpr int kThreads = kWarp * kWarpsPerBlock;
constexpr int kMaxEll = 2;  // ops/spmv.py MAX_ELL: one slab per partition

// How the rows of one ELL slab are read (ops/spmv.py ELL_*).
enum { kEllSlab, kEllShort, kEllWarp };

// One ELL slab of a pcsr step (p_rs of one partition), by value.
struct EllPart {
  const int32_t* ops;   // [n_rows, width], 16-byte aligned
  const float* vals;    // [n_rows, width], 0 = padding
  const int32_t* lens;  // [n_rows] live entries of each row (kEllShort, kEllWarp)
  const float* x;
  float* y;             // n_rows outputs
  int32_t n_rows;
  int32_t width;        // a power of two
  int32_t mode;         // kEllSlab (width <= 32), kEllShort or kEllWarp
  int32_t first_block;  // this slab's first block of the grid
};

struct PcsrArgs {
  StepArgs step;  // the work items' x slots and flat y
  EllPart ell[kMaxEll];
  int32_t item_blocks;
  int32_t n_ell;
};

__device__ __forceinline__ float warp_tree(float acc) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_down_sync(kFull, acc, off));
  }
  return acc;
}

// One work item (one chunk of one row) on one warp; the body of
// `coo_spmv_chunks` and the first blocks of `pcsr_step`.
__device__ __forceinline__ void chunk_item(
    int32_t item, int32_t n_items, const int32_t* __restrict__ items,
    const int32_t* __restrict__ cols, const float* __restrict__ vals,
    float* __restrict__ part, int32_t* __restrict__ counters,
    StepArgs args) {
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

__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
coo_spmv_chunks(const int32_t* __restrict__ items, int32_t n_items,
                const int32_t* __restrict__ cols,
                const float* __restrict__ vals,
                float* __restrict__ part, int32_t* __restrict__ counters,
                StepArgs args) {
  chunk_item(static_cast<int32_t>(blockIdx.x) * kWarpsPerBlock +
                 static_cast<int32_t>(threadIdx.x) / kWarp,
             n_items, items, cols, vals, part, counters, args);
}

// S neighbouring slots of one row: one vector load of ops and of values.
template <int S>
__device__ __forceinline__ void load_slots(const int32_t* ops,
                                           const float* vals, int64_t pos,
                                           int32_t (&o)[S], float (&v)[S]) {
  if constexpr (S == 4) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(ops + pos));
    const float4 b = __ldg(reinterpret_cast<const float4*>(vals + pos));
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    v[0] = b.x; v[1] = b.y; v[2] = b.z; v[3] = b.w;
  } else if constexpr (S == 2) {
    const int2 a = __ldg(reinterpret_cast<const int2*>(ops + pos));
    const float2 b = __ldg(reinterpret_cast<const float2*>(vals + pos));
    o[0] = a.x; o[1] = a.y;
    v[0] = b.x; v[1] = b.y;
  } else {
    o[0] = __ldg(ops + pos);
    v[0] = __ldg(vals + pos);
  }
}

// K1's tree over a row's `lanes` lanes held S to a thread by g threads:
// offsets of S and more between the row's threads, then the smaller ones
// inside a thread, in K1's pairs. acc[0] of the row's first thread holds
// the sum.
template <int S>
__device__ __forceinline__ void row_tree(float (&acc)[S], int32_t lanes,
                                         int32_t g, unsigned mask) {
  for (int32_t off = lanes / 2; off >= S; off >>= 1) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      acc[j] = __fadd_rn(acc[j], __shfl_down_sync(mask, acc[j], off / S, g));
    }
  }
#pragma unroll
  for (int off = S / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < off; ++j) acc[j] = __fadd_rn(acc[j], acc[j + off]);
  }
}

// The rows of `block` (relative to the slab's first block) of a slab of
// width <= 32 (kEllSlab): one column of slots, read whole; g = width / S
// threads a row, each holding S virtual lanes of K1.
template <int S>
__device__ __forceinline__ void ell_slab_rows(EllPart e, int32_t block) {
  const int32_t g = e.width / S;  // threads per row: 1 .. 8
  const int32_t tid = static_cast<int32_t>(threadIdx.x);
  const int64_t row = static_cast<int64_t>(block) * (kThreads / g) + tid / g;
  // A row's threads are one group; rows past the end leave as a group.
  if (row >= e.n_rows) return;
  const int32_t t = tid % g;
  const int lane = tid % kWarp;
  const unsigned mask =
      g == kWarp ? kFull : ((1u << g) - 1u) << (lane / g * g);
  int32_t o[S];
  float v[S];
  load_slots<S>(e.ops, e.vals, row * e.width + t * S, o, v);
  float acc[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    acc[j] = 0.0f;
    if (v[j] != 0.0f) acc[j] = __fadd_rn(0.0f, __fmul_rn(v[j], __ldg(e.x + o[j])));
  }
  row_tree<S>(acc, e.width, g, mask);
  if (t == 0) e.y[row] = acc[0];
}

// The rows of `block` of a wider slab, 8 threads a row, 4 virtual lanes
// each (kEllShort): by the row's length, only the columns of 32 slots and
// the 256-slot chunks that hold live entries.
__device__ __forceinline__ void ell_short_rows(EllPart e, int32_t block) {
  constexpr int S = 4;
  constexpr int32_t g = kWarp / S;
  const int32_t tid = static_cast<int32_t>(threadIdx.x);
  const int64_t row = static_cast<int64_t>(block) * (kThreads / g) + tid / g;
  if (row >= e.n_rows) return;
  const int32_t t = tid % g;
  const int lane = tid % kWarp;
  const unsigned mask = ((1u << g) - 1u) << (lane / g * g);
  const int32_t n = __ldg(e.lens + row);
  const int64_t base = row * e.width;
  float sum = 0.0f;
  for (int32_t c = 0; c == 0 || c * kChunk < n; ++c) {
    const int64_t chunk0 = base + static_cast<int64_t>(c) * kChunk;
    const int32_t left = min(n - c * kChunk, kChunk);  // live slots
    float acc[S] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int32_t first = t * S; first < left; first += kWarp) {
      int32_t o[S];
      float v[S];
      load_slots<S>(e.ops, e.vals, chunk0 + first, o, v);
#pragma unroll
      for (int j = 0; j < S; ++j) {
        if (v[j] != 0.0f) {
          acc[j] = __fadd_rn(acc[j], __fmul_rn(v[j], __ldg(e.x + o[j])));
        }
      }
    }
    row_tree<S>(acc, kWarp, g, mask);
    sum = c == 0 ? acc[0] : __fadd_rn(sum, acc[0]);
  }
  if (t == 0) e.y[row] = sum;
}

// The rows of `block` of a wider slab one warp a row (kEllWarp): each
// chunk of the row's live prefix is summed as K1 sums a work item, all
// its loads in flight at once, and the chunks fold left to right.
__device__ __forceinline__ void ell_warp_rows(EllPart e, int32_t block) {
  const int64_t row = static_cast<int64_t>(block) * kWarpsPerBlock +
                      static_cast<int32_t>(threadIdx.x) / kWarp;
  if (row >= e.n_rows) return;  // warp-uniform
  const int lane = static_cast<int>(threadIdx.x) % kWarp;
  const int32_t n = __ldg(e.lens + row);
  const int64_t base = row * e.width;
  float sum = 0.0f;
  for (int32_t c = 0; c == 0 || c * kChunk < n; ++c) {
    const int32_t* ops = e.ops + base + static_cast<int64_t>(c) * kChunk;
    const float* vals = e.vals + base + static_cast<int64_t>(c) * kChunk;
    const int32_t left = min(n - c * kChunk, kChunk);
    float prod[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int32_t p = lane + k * kWarp;
      prod[k] = 0.0f;
      if (p < left) prod[k] = __fmul_rn(__ldg(vals + p), __ldg(e.x + __ldg(ops + p)));
    }
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      if (lane + k * kWarp < left) acc = __fadd_rn(acc, prod[k]);
    }
    acc = warp_tree(acc);
    sum = c == 0 ? acc : __fadd_rn(sum, acc);
  }
  if (lane == 0) e.y[row] = sum;
}

__device__ __forceinline__ void ell_block(EllPart e, int32_t block) {
  // The mode and the slot width are uniform over the slab, so over the
  // block.
  if (e.mode == kEllWarp) {
    ell_warp_rows(e, block);
  } else if (e.mode == kEllShort) {
    ell_short_rows(e, block);
  } else if (e.width >= 4) {
    ell_slab_rows<4>(e, block);
  } else if (e.width == 2) {
    ell_slab_rows<2>(e, block);
  } else {
    ell_slab_rows<1>(e, block);
  }
}

// One pcsr step: the work items (op side and call edges) on the first
// `item_blocks` blocks, then each partition's ELL slab (trace side).
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
pcsr_step(const int32_t* __restrict__ items, int32_t n_items,
          const int32_t* __restrict__ cols, const float* __restrict__ vals,
          float* __restrict__ part, int32_t* __restrict__ counters,
          PcsrArgs args) {
  const int32_t block = static_cast<int32_t>(blockIdx.x);
  if (block < args.item_blocks) {
    chunk_item(block * kWarpsPerBlock +
                   static_cast<int32_t>(threadIdx.x) / kWarp,
               n_items, items, cols, vals, part, counters, args.step);
  } else if (args.n_ell < 2 || block < args.ell[1].first_block) {
    ell_block(args.ell[0], block - args.ell[0].first_block);
  } else {
    ell_block(args.ell[1], block - args.ell[1].first_block);
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

// One launch of a pcsr step on `stream`: the work list `items` (as
// mr_coo_spmv_group, x slots `xs`, writing the flat `y`) and `n_ell` <= 2
// ELL slabs, slab i being `ell_ops[i]` / `ell_vals[i]` [ell_rows[i],
// ell_width[i]] (width a power of two, both 16-byte aligned) with row
// lengths `ell_lens[i]`, read in mode `ell_mode[i]` (kEllSlab only for
// a width <= 32, which does not read the lengths), reading x slot
// `ell_slot[i]` and writing y + ell_y[i]. Returns the CUDA error code
// of the launch. Allocates nothing and does not synchronize.
int mr_pcsr_step(const int32_t* items, int32_t n_items, const int32_t* cols,
                 const float* vals, float* part, int32_t* counters,
                 const float* const* xs, int32_t n_xs, float* y,
                 const int32_t* const* ell_ops, const float* const* ell_vals,
                 const int32_t* const* ell_lens, const int32_t* ell_mode,
                 const int32_t* ell_slot, const int32_t* ell_rows,
                 const int32_t* ell_width, const int64_t* ell_y,
                 int32_t n_ell, int device, void* stream) {
  if (n_xs < 1 || n_xs > kMaxX || n_ell < 0 || n_ell > kMaxEll ||
      n_items < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PcsrArgs args{};
  for (int s = 0; s < n_xs; ++s) args.step.x[s] = xs[s];
  args.step.y = y;
  args.item_blocks = (n_items + kWarpsPerBlock - 1) / kWarpsPerBlock;
  int64_t blocks = args.item_blocks;
  args.n_ell = n_ell;
  for (int i = 0; i < n_ell; ++i) {
    const int32_t w = ell_width[i];
    const int32_t mode = ell_mode[i];
    const uintptr_t align =
        reinterpret_cast<uintptr_t>(ell_ops[i]) |
        reinterpret_cast<uintptr_t>(ell_vals[i]);
    if (w < 1 || (w & (w - 1)) != 0 || ell_rows[i] < 0 ||
        ell_slot[i] < 0 || ell_slot[i] >= n_xs || align % 16 != 0 ||
        mode < kEllSlab || mode > kEllWarp || (mode == kEllSlab) != (w <= kWarp)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    EllPart& e = args.ell[i];
    e.ops = ell_ops[i];
    e.vals = ell_vals[i];
    e.lens = ell_lens[i];
    e.x = xs[ell_slot[i]];
    e.y = y + ell_y[i];
    e.n_rows = ell_rows[i];
    e.width = w;
    e.mode = mode;
    e.first_block = static_cast<int32_t>(blocks);
    const int32_t rows_per_block =
        mode == kEllWarp ? kWarpsPerBlock : kThreads * min(w, 4) / min(w, kWarp);
    blocks += (ell_rows[i] + rows_per_block - 1) / rows_per_block;
  }
  if (blocks == 0) return 0;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  pcsr_step<<<static_cast<unsigned>(blocks), kThreads, 0,
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
