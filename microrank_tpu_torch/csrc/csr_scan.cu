// K10 on Hopper: the csr route's products of a power-iteration step
// (p_sr @ rv, p_ss @ sv, p_rs @ sv of both partitions, every window of
// a stacked group) in JAX's order of sums.
//
// Replaces what XLA compiles for the TPU in
// microrank_tpu/rank_backends/jax_tpu.py:671-700 (kernel="csr",
// `csr_rowsum`): the entry products vals * x[cols] of a matrix in CSR
// order, their double-f32 inclusive prefix scan
// (microrank_tpu/ops/segment.py `compensated_cumsum`: lax.associative_
// scan with the TwoSum combine of `_two_sum`), then each row's
// (hi[b] - hi[a]) + (lo[b] - lo[a]) over its offsets [a, b) with a zero
// prepended to both scans.
//
// The order of every add is JAX's: lax.associative_scan's odd/even
// recursion (combine adjacent pairs, scan the half-length array, then
// the even positions as comb(scan of the pairs before them, element)).
// The value at position i depends on the elements 0..i and on i alone,
// not on the array's length, so a matrix is cut into aligned blocks of
// kBlock = 2048 entries (2^11), which are exactly the subtrees of the
// recursion's first 11 levels:
//
//   up(l)    a block reduces its 2048 level-l elements by the
//            recursion's pairs, level by level in shared memory, and
//            writes the block's total (its level-(l + 11) element);
//   top(D)   the last level fits one block a matrix: the block runs the
//            recursion whole (the reduce, then the down-sweep);
//   down(l)  a block reduces its elements again, then runs the
//            down-sweep from two scanned totals of the level above: its
//            own (the scan at its last position's parent) and the
//            previous block's (the scan before its first position);
//            level 0 writes the scan of every entry;
//   rows     one thread a row: the difference of the scans at its ends.
//
// A matrix of at most 2048 entries is top(0) and rows: two launches; up
// to 2048^2, four (up, top, down, rows); to 2048^3, six. Every matrix of
// the step (six a window) and every window of a group is a segment of
// the same launches (grid y). Each add rounds alone (__fadd_rn,
// __fsub_rn, __fmul_rn; built with -fmad=false): TwoSum is exact only
// without contraction. Positions past a matrix's live entries hold
// (0, 0) and no row reads them. No float atomics.
//
// What bounds it: a step moves each entry's column, value and x once
// and writes its scan pair once (20 bytes an entry, 28 with a second
// level), far below the card's arithmetic; the shared-memory tree is 11
// barriers a block. A one-pass (decoupled look-back) design would move
// half the bytes, but needs the recursion's tree at block edges, where
// the look-back's order is a chain; that is left for a later redesign.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kLog = 11;
constexpr int kBlock = 1 << kLog;      // elements a block, 2 a thread
constexpr int kShared = 2 * kBlock - 1;  // levels 0..11 of a block's tree
constexpr int kMaxLevels = 3;          // level buffers 1..3
constexpr int kMaxX = 4;

// A segment's words (ops/scan.py SEG_FIELDS): entries at entry_off, its
// live count, the x slot and offset, its scan's first slot in out (a
// zero pair), then each level's buffer offset and padded length.
enum Seg : int {
  kEntryOff = 0, kLen, kSlot, kXOff, kOutOff, kLvlOff, kLvlN = kLvlOff + kMaxLevels,
  kSegWords = kLvlN + kMaxLevels,
};

// The argument block's words (ops/scan.py ARGS).
enum Word : int {
  kCols = 0, kVals, kSegs, kNSeg, kX, kOut = kX + kMaxX, kLevels, kRows, kNRows, kY,
  kDepth, kBlocks, kDevice = kBlocks + kMaxLevels + 1, kStream, kWords,
};

struct Pair {
  float hi, lo;
};

// JAX's combine: TwoSum of the high parts, the low parts added after.
__device__ __forceinline__ Pair comb(Pair a, Pair b) {
  const float s = __fadd_rn(a.hi, b.hi);
  const float t = __fsub_rn(s, a.hi);
  const float e = __fadd_rn(__fsub_rn(a.hi, __fsub_rn(s, t)), __fsub_rn(b.hi, t));
  return {s, __fadd_rn(__fadd_rn(e, a.lo), b.lo)};
}

__device__ __forceinline__ int level_at(int l) { return 2 * kBlock - (2 * kBlock >> l); }

struct Args {
  const int32_t* cols;
  const float* vals;
  const int64_t* segs;
  const float* x[kMaxX];
  Pair* out;
  Pair* levels;
};

// Element i of a segment at level l: a product (level 0), a total of
// the level below, or (0, 0) past the segment.
__device__ __forceinline__ Pair load(const Args& a, const int64_t* s, int l, int64_t i) {
  if (l == 0) {
    if (i >= s[kLen]) return {0.f, 0.f};
    const int64_t e = s[kEntryOff] + i;
    const float* x = a.x[s[kSlot]];
    return {__fmul_rn(a.vals[e], x[s[kXOff] + a.cols[e]]), 0.f};
  }
  if (i >= s[kLvlN + l - 1]) return {0.f, 0.f};
  return a.levels[s[kLvlOff + l - 1] + i];
}

// kMode: 0 up (write the block's total to level l + 1), 1 top (the
// whole recursion in one block), 2 down (from the scanned totals of
// level l + 1).
template <int kMode>
__global__ void __launch_bounds__(kThreads) scan_pass(Args a, int l) {
  __shared__ Pair tree[kShared];
  const int64_t* s = a.segs + static_cast<int64_t>(blockIdx.y) * kSegWords;
  const int64_t n = l == 0 ? s[kLen] : s[kLvlN + l - 1];
  const int64_t blk = blockIdx.x;
  // up writes every total of the level above (its padded length); top
  // and down write the segment's elements at this level.
  if (kMode == 0 ? blk >= s[kLvlN + l] : blk * kBlock >= n) return;
  const int tid = threadIdx.x;
  const int64_t base = blk * kBlock;
  tree[tid] = load(a, s, l, base + tid);
  tree[tid + kThreads] = load(a, s, l, base + tid + kThreads);
  __syncthreads();
#pragma unroll 1
  for (int v = 1; v <= kLog; ++v) {
    const int width = kBlock >> v;
    const int below = level_at(v - 1), here = level_at(v);
    if (tid < width) tree[here + tid] = comb(tree[below + 2 * tid], tree[below + 2 * tid + 1]);
    __syncthreads();
  }
  if (kMode == 0) {
    if (tid == 0) a.levels[s[kLvlOff + l] + blk] = tree[kShared - 1];
    return;
  }
  // The down-sweep: the scan at the block's top, then level by level.
  const Pair* parent = a.levels + (kMode == 2 ? s[kLvlOff + l] : 0);
  Pair prev{0.f, 0.f};
  if (tid == 0) {
    if (kMode == 2) tree[kShared - 1] = parent[blk];
  }
  if (kMode == 2 && blk > 0) prev = parent[blk - 1];
  __syncthreads();
#pragma unroll 1
  for (int v = kLog - 1; v >= 0; --v) {
    const int width = kBlock >> v;
    const int here = level_at(v), above = level_at(v + 1);
    for (int j = tid; j < width; j += kThreads) {
      Pair r = tree[here + j];
      if (j & 1) {
        r = tree[above + (j >> 1)];
      } else if (j > 0) {
        r = comb(tree[above + (j >> 1) - 1], r);
      } else if (blk > 0) {
        r = comb(prev, r);
      }
      tree[here + j] = r;
    }
    __syncthreads();
  }
  for (int j = tid; j < kBlock; j += kThreads) {
    const int64_t i = base + j;
    if (i >= n) break;
    if (l == 0) {
      a.out[s[kOutOff] + 1 + i] = tree[j];
    } else {
      a.levels[s[kLvlOff + l - 1] + i] = tree[j];
    }
  }
}

__global__ void row_diff(const Pair* __restrict__ out, const int32_t* __restrict__ rows,
                         int64_t n_rows, float* __restrict__ y) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const Pair a = out[rows[2 * r]], b = out[rows[2 * r + 1]];
  y[r] = __fadd_rn(__fsub_rn(b.hi, a.hi), __fsub_rn(b.lo, a.lo));
}

}  // namespace

extern "C" {

// The words of an argument block (ops/scan.py checks its own against it).
int mr_csr_scan_words() { return kWords; }

// One step's products on `stream`: depth D levels of totals, then the
// launches of the note above (2 D + 2 in all). Returns the CUDA error
// code of the first failed launch (0 = launched); allocates nothing and
// does not synchronize.
int mr_csr_scan(const int64_t* w) {
  const auto ptr = [w](int i) { return reinterpret_cast<void*>(static_cast<uintptr_t>(w[i])); };
  const int64_t n_seg = w[kNSeg], depth = w[kDepth], n_rows = w[kNRows];
  if (n_seg < 1 || n_seg > 65535 || depth < 0 || depth > kMaxLevels || n_rows < 0
      || ptr(kSegs) == nullptr || ptr(kOut) == nullptr || (depth > 0 && ptr(kLevels) == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = 0; l <= depth; ++l) {
    if (w[kBlocks + l] < 1 || w[kBlocks + l] > INT32_MAX) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (cudaSetDevice(static_cast<int>(w[kDevice])) != cudaSuccess) {
    return static_cast<int>(cudaGetLastError());
  }
  Args a{};
  a.cols = static_cast<const int32_t*>(ptr(kCols));
  a.vals = static_cast<const float*>(ptr(kVals));
  a.segs = static_cast<const int64_t*>(ptr(kSegs));
  for (int i = 0; i < kMaxX; ++i) a.x[i] = static_cast<const float*>(ptr(kX + i));
  a.out = static_cast<Pair*>(ptr(kOut));
  a.levels = static_cast<Pair*>(ptr(kLevels));
  const auto stream = static_cast<cudaStream_t>(ptr(kStream));
  const auto grid = [&](int l) { return dim3(static_cast<unsigned>(w[kBlocks + l]),
                                             static_cast<unsigned>(n_seg)); };
  for (int l = 0; l < depth; ++l) {
    scan_pass<0><<<grid(l), kThreads, 0, stream>>>(a, l);
  }
  scan_pass<1><<<grid(static_cast<int>(depth)), kThreads, 0, stream>>>(a, static_cast<int>(depth));
  for (int l = static_cast<int>(depth) - 1; l >= 0; --l) {
    scan_pass<2><<<grid(l), kThreads, 0, stream>>>(a, l);
  }
  if (n_rows > 0) {
    const int threads = 256;
    row_diff<<<static_cast<unsigned>((n_rows + threads - 1) / threads), threads, 0, stream>>>(
        a.out, static_cast<const int32_t*>(ptr(kRows)), n_rows, static_cast<float*>(ptr(kY)));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* mr_csr_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
