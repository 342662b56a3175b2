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
// not on the array's length, so a matrix is cut into aligned tiles of
// kBlock = 2048 entries (2^11), which are exactly the subtrees of the
// recursion's first 11 levels. Each add rounds alone (__fadd_rn,
// __fsub_rn, __fmul_rn; built with -fmad=false): TwoSum is exact only
// without contraction. Positions past a matrix's live entries hold
// (0, 0) and no row reads them. No float atomics.
//
// What bounds it: bytes. A step reads each live entry's column and
// value and gathers its x once, and writes each row's sum once (about
// 12 bytes an entry); the arithmetic (two TwoSum combines an entry) is
// far below the card's rate.
//
// `scan_step`, the design (one cooperative launch a step for every
// matrix and window of the group, on a grid of one 1024-thread block an
// SM, planned on the host: ops/scan.py `step_plan`, checked here again):
//
//   1. each block takes its run of whole tiles; a warp takes 64 entries
//      of a tile (two a lane), computes their products once, and reduces
//      them by the recursion's levels 1-6 with shuffles; the tile's 32
//      warp totals are reduced by levels 7-11 in one warp, and the
//      tile's total is written. The products stay in shared memory
//      across the grid barrier (the plan's `held` tiles a block; a tile
//      past them computes its products again from the L2).
//   2. grid barrier. Each block scans the totals of every matrix its
//      tiles belong to, redundantly (at most 2048 totals, a matrix of up
//      to 2048^2 entries: two leaves a thread, the same warp and block
//      levels), keeping the scan at its tiles and at the tile before
//      each. Then each tile's down-sweep: levels 11-7 in one warp, 6-1
//      in each warp by shuffles, the leaves in registers. Only the scan
//      at a row's ends is written (its offsets in indptr, the tile's run
//      of them planned on the host), through a tile's stage in shared
//      memory.
//   3. grid barrier. Each row's difference of the scans at its ends, one
//      pass over the offsets.
//
// Only the levels above a warp take __syncthreads. Matrices past 2048^2
// entries, or a group past the plan's shared memory, take the first
// design, the level passes `scan_pass` (up / top / down passes of
// 2048-entry blocks over levels of totals in global memory, then
// `row_diff`), which also stay for comparison:
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
// the same launches (grid y).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kLog = 11;
constexpr int kBlock = 1 << kLog;      // elements a block, 2 a thread
constexpr int kShared = 2 * kBlock - 1;  // levels 0..11 of a block's tree
constexpr int kMaxLevels = 3;          // level buffers 1..3
constexpr int kMaxX = 4;

// A segment's words (ops/scan.py SEG_WORDS): entries at entry_off, its
// live count, the x slot and offset, its scan's first slot in out (a
// zero pair; the first design's); scan_step's first tile and tiles; then
// each level's buffer offset and padded length (the first design's).
enum Seg : int {
  kEntryOff = 0, kLen, kSlot, kXOff, kOutOff, kTileOff, kTiles,
  kLvlOff, kLvlN = kLvlOff + kMaxLevels, kSegWords = kLvlN + kMaxLevels,
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

// ------------------------------------------------------------ scan_step

constexpr int kStepThreads = 1024;  // a block: 32 warps, a tile's 2048 entries
constexpr int kWarps = kStepThreads / 32;
constexpr int kTopMax = kBlock;     // tile totals a segment: 2048^2 entries

// The dynamic shared memory of a plan (ops/scan.py tile_smem): two
// stages of a tile's scans, each tile's warp totals and their scans,
// the tiles' scans and the ones before, the held tiles' products.
constexpr int64_t step_smem(int64_t per, int64_t held) {
  return 2 * kBlock * 8 + per * (2 * kWarps * 8 + 2 * 8) + held * kBlock * 4;
}

// A tile's words in the tiles table (ops/scan.py TILE_WORDS): its
// segment, its index in the segment, its run of marks [first, end) (the
// row offsets whose scan position, offset - 1, lies in the tile; the
// segment's first tile also takes the offsets equal to 0).
enum TileWord : int { kTileSeg = 0, kTileIndex, kMarkFirst, kMarkEnd, kTileWords };

struct StepArgs {
  const int32_t* cols;
  const float* vals;
  const int64_t* segs;
  const float* x[kMaxX];
  const int32_t* tiles;   // [T, kTileWords]
  const int32_t* marks;   // every segment's row offsets, rows + 1 each
  const int32_t* rows;    // [marks] the row in y that starts at each mark (-1: a segment's last)
  Pair* totals;           // [T] the tiles' totals
  Pair* ends;             // [marks] the scan at each row offset (0 before the first entry)
  float* y;
  unsigned long long* stamps;  // [kStepStamps] the phases' global times, or null
  int32_t n_seg, n_tiles, n_marks, per, held;
};

// The phases a launch may stamp (ns of the global timer; a measurement):
// block 0's start, then the latest block's end of the products and tile
// totals, of the first grid barrier, of the top scans, of the
// down-sweeps and row offsets, of the second barrier, of the rows.
constexpr int kStepStamps = 7;

__device__ __forceinline__ void step_stamp(unsigned long long* stamps, int phase) {
  if (stamps == nullptr) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (phase == 0) {
      if (blockIdx.x == 0) stamps[0] = now;
    } else {
      atomicMax(stamps + phase, now);
    }
  }
}

__device__ __forceinline__ Pair shfl_xor(Pair p, int d) {
  return {__shfl_xor_sync(0xffffffffu, p.hi, d), __shfl_xor_sync(0xffffffffu, p.lo, d)};
}

__device__ __forceinline__ Pair shfl_up(Pair p, int d) {
  return {__shfl_up_sync(0xffffffffu, p.hi, d), __shfl_up_sync(0xffffffffu, p.lo, d)};
}

// The recursion's up-sweep over a warp's 32 nodes of one level L (a
// node a lane, `x`): r[v] the lane's node of level L + v (lanes sharing
// it hold it alike: both lanes of a pair combine the same two nodes in
// the same order); returns the warp's node of level L + 5.
__device__ __forceinline__ Pair warp_up(Pair x, Pair (&r)[5]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    r[v] = x;
    const Pair y = shfl_xor(x, 1 << v);
    const bool right = (lane >> v) & 1;  // the lane holds the pair's right node
    x = comb(right ? y : x, right ? x : y);
  }
  return x;
}

// The down-sweep: from `s`, the scan at the warp's node of level L + 5,
// `prev`, the scan before its first position, and `first` (its first
// position is the segment's: no prev), the scan at the lane's level-L
// node. Node j of level L + v: odd, the scan at its parent; even past 0,
// comb(the scan at its parent's left neighbour, its own value); 0,
// comb(prev, its value), or its value where `first`.
__device__ __forceinline__ Pair warp_down(Pair s, Pair prev, bool first, const Pair (&r)[5]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int v = 4; v >= 0; --v) {
    const Pair left = v < 4 ? shfl_up(s, 2 << v) : s;  // the lane 2^(v+1) below's parent scan
    const int j = lane >> v;
    const Pair c = comb(j > 0 ? left : prev, r[v]);
    if ((j & 1) == 0) s = j == 0 && first ? r[v] : c;
  }
  return s;
}

// The scans at a lane's two leaves (x0 at an even position, x1 after
// it), from s1, the scan at their level-1 node.
__device__ __forceinline__ void leaf_scans(Pair x0, Pair s1, Pair prev, bool first, Pair& e0,
                                           Pair& e1) {
  const Pair left = shfl_up(s1, 1);
  const bool lead = (threadIdx.x & 31) == 0;
  const Pair c = comb(lead ? prev : left, x0);
  e0 = lead && first ? x0 : c;
  e1 = s1;
}

__device__ __forceinline__ float product(const StepArgs& a, const int64_t* sg, int64_t i) {
  const int64_t e = sg[kEntryOff] + i;
  return __fmul_rn(a.vals[e], a.x[sg[kSlot]][sg[kXOff] + a.cols[e]]);
}

// Tile s of the block's run: a lane's two products (0 past the live
// entries), from shared memory where the tile is held.
__device__ __forceinline__ float2 tile_products(const StepArgs& a, const float* prod, int s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int at = 64 * warp + 2 * lane;
  if (s < a.held) return *reinterpret_cast<const float2*>(prod + s * kBlock + at);
  const int32_t* ti = a.tiles + kTileWords * (blockIdx.x * a.per + s);
  const int64_t* sg = a.segs + static_cast<int64_t>(ti[kTileSeg]) * kSegWords;
  const int64_t i = static_cast<int64_t>(ti[kTileIndex]) * kBlock + at;
  const int64_t len = sg[kLen];
  return make_float2(i < len ? product(a, sg, i) : 0.f, i + 1 < len ? product(a, sg, i + 1) : 0.f);
}

__global__ void __launch_bounds__(kStepThreads, 1) scan_step(StepArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Pair top_sums[kWarps], top_scans[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = a.per;
  const int t_lo = blockIdx.x * per;
  const int n = min(per, a.n_tiles - t_lo);  // the plan leaves no block empty
  Pair* stage = reinterpret_cast<Pair*>(smem);  // [2][kBlock] a tile's scans, two in turn
  Pair* wtot = stage + 2 * kBlock;              // [per][32] the warps' totals (level 6)
  Pair* s6 = wtot + per * kWarps;               // [per][32] the scans at them
  Pair* s11 = s6 + per * kWarps;                // [per] the scan at the tile (level 11)
  Pair* s11p = s11 + per;                       // [per] the scan at the tile before
  float* prod = reinterpret_cast<float*>(s11p + per);  // [held][kBlock] the products
  const Pair zero{0.f, 0.f};
  step_stamp(a.stamps, 0);

  // 1. The products of the held tiles, loads in flight together.
  const int held = min(n, a.held);
#pragma unroll 8
  for (int s = 0; s < held; ++s) {
    const int32_t* ti = a.tiles + kTileWords * (t_lo + s);
    const int64_t* sg = a.segs + static_cast<int64_t>(ti[kTileSeg]) * kSegWords;
    const int64_t i = static_cast<int64_t>(ti[kTileIndex]) * kBlock + 64 * warp + 2 * lane;
    const int64_t len = sg[kLen];
    *reinterpret_cast<float2*>(prod + s * kBlock + 64 * warp + 2 * lane) = make_float2(
        i < len ? product(a, sg, i) : 0.f, i + 1 < len ? product(a, sg, i + 1) : 0.f);
  }
  // Each warp's total (levels 1-6; a lane reads back its own products),
  // then each tile's (levels 7-11), written for every block.
#pragma unroll 2
  for (int s = 0; s < n; ++s) {
    const float2 p = tile_products(a, prod, s);
    Pair r[5];
    const Pair w = warp_up(comb({p.x, 0.f}, {p.y, 0.f}), r);
    if (lane == 0) wtot[s * kWarps + warp] = w;
  }
  __syncthreads();
  for (int s = warp; s < n; s += kWarps) {
    Pair r[5];
    const Pair total = warp_up(wtot[s * kWarps + lane], r);
    if (lane == 0) a.totals[t_lo + s] = total;
  }
  step_stamp(a.stamps, 1);
  cg::this_grid().sync();
  step_stamp(a.stamps, 2);

  // 2. The scan of each segment's tile totals that the block's tiles
  // belong to, whole, in this block: the scan at each tile and the one
  // before it.
  const int seg_lo = a.tiles[kTileWords * t_lo + kTileSeg];
  const int seg_hi = a.tiles[kTileWords * (t_lo + n - 1) + kTileSeg];
  for (int seg = seg_lo; seg <= seg_hi; ++seg) {
    const int64_t* sg = a.segs + static_cast<int64_t>(seg) * kSegWords;
    const int toff = static_cast<int>(sg[kTileOff]), nt = static_cast<int>(sg[kTiles]);
    const int a0 = max(t_lo, toff), a1 = min(t_lo + n, toff + nt);
    if (nt == 1) {  // its one total is its scan; no tile before it
      if (t == 0) s11[a0 - t_lo] = a.totals[toff];
      continue;
    }
    const int i0 = 64 * warp + 2 * lane;
    const Pair x0 = i0 < nt ? a.totals[toff + i0] : zero;
    const Pair x1 = i0 + 1 < nt ? a.totals[toff + i0 + 1] : zero;
    Pair r[5];
    const Pair w = warp_up(comb(x0, x1), r);
    __syncthreads();  // the previous segment's top_scans read
    if (lane == 0) top_sums[warp] = w;
    __syncthreads();
    if (warp == 0) {
      Pair q[5];
      const Pair root = warp_up(top_sums[lane], q);
      top_scans[lane] = warp_down(root, zero, true, q);
    }
    __syncthreads();
    const Pair prev = warp > 0 ? top_scans[warp - 1] : zero;
    Pair e0, e1;
    leaf_scans(x0, warp_down(top_scans[warp], prev, warp == 0, r), prev, warp == 0, e0, e1);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int g = toff + i0 + k;
      const Pair e = k == 0 ? e0 : e1;
      if (g >= a0 && g < a1) s11[g - t_lo] = e;
      if (g + 1 >= a0 && g + 1 < a1) s11p[g + 1 - t_lo] = e;
    }
  }
  __syncthreads();
  step_stamp(a.stamps, 3);
  // Each tile's levels 11-7: the scan at each warp's node (level 6).
  for (int s = warp; s < n; s += kWarps) {
    const int lt = a.tiles[kTileWords * (t_lo + s) + kTileIndex];
    Pair r[5];
    warp_up(wtot[s * kWarps + lane], r);
    s6[s * kWarps + lane] = warp_down(s11[s], s11p[s], lt == 0, r);
  }
  __syncthreads();
  // Levels 6-1 in each warp, the leaves; then the scan at every row
  // offset in the tile, from the tile's stage.
  for (int s = 0; s < n; ++s) {
    const int32_t* ti = a.tiles + kTileWords * (t_lo + s);
    const int lt = ti[kTileIndex];
    const int m0 = ti[kMarkFirst], m1 = ti[kMarkEnd];
    // The thread's first mark of the tile, in flight during the scan.
    const int off0 = m0 + t < m1 ? a.marks[m0 + t] : 0;
    const float2 p = tile_products(a, prod, s);
    const Pair x0{p.x, 0.f}, x1{p.y, 0.f};
    Pair r[5];
    warp_up(comb(x0, x1), r);
    const bool first = lt == 0 && warp == 0;
    const Pair prev = warp > 0 ? s6[s * kWarps + warp - 1] : s11p[s];
    Pair e0, e1;
    leaf_scans(x0, warp_down(s6[s * kWarps + warp], prev, first, r), prev, first, e0, e1);
    Pair* st = stage + (s & 1) * kBlock;
    st[64 * warp + 2 * lane] = e0;
    st[64 * warp + 2 * lane + 1] = e1;
    __syncthreads();  // the stage written; the one before the last read (its turn's barrier)
    const int base = lt * kBlock;
    for (int j = m0 + t; j < m1; j += kStepThreads) {
      const int off = j == m0 + t ? off0 : a.marks[j];
      a.ends[j] = off == 0 ? zero : st[off - 1 - base];
    }
  }
  step_stamp(a.stamps, 4);
  cg::this_grid().sync();
  step_stamp(a.stamps, 5);

  // 3. Each row's difference of the scans at its offsets (the plain
  // version's (hi[b] - hi[a]) + (lo[b] - lo[a])), one pass over the
  // marks of every segment: the row that starts at each.
  const int gn = gridDim.x * kStepThreads;
  for (int j = blockIdx.x * kStepThreads + t; j < a.n_marks; j += gn) {
    const int row = a.rows[j];
    if (row < 0) continue;
    const Pair lo = a.ends[j], hi = a.ends[j + 1];
    a.y[row] = __fadd_rn(__fsub_rn(hi.hi, lo.hi), __fsub_rn(hi.lo, lo.lo));
  }
  step_stamp(a.stamps, 6);
}

// scan_step's argument block (ops/scan.py STEP_ARGS): cols, vals, segs,
// n_seg, x[4], tiles, n_tiles, marks, n_marks, mark rows, totals, ends,
// y, grid, per, held, smem, stamps, device, stream.
enum StepWord : int {
  kSCols = 0, kSVals, kSSegs, kSNSeg, kSX, kSTiles = kSX + kMaxX, kSNTiles, kSMarks, kSNMarks,
  kSMarkRows, kSTotals, kSEnds, kSY, kSGrid, kSPer, kSHeld, kSSmem, kSStamps, kSDevice, kSStream,
  kStepWords,
};


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

// What scan_step gets on `device`: out[0] the SM count, out[1] the most
// dynamic shared memory a block may take (the card's opt-in limit less
// the kernel's static share), out[2] the words of its argument block,
// out[3] kBlock, out[4] the most tile totals a segment may have, out[5]
// kStepStamps. Returns the CUDA error code of the queries.
int mr_csr_scan_config(int device, int32_t* out) {
  int sms = 0, optin = 0;
  cudaFuncAttributes attr{};
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, scan_step);
  out[0] = sms;
  out[1] = optin - static_cast<int>(attr.sharedSizeBytes);
  out[2] = kStepWords;
  out[3] = kBlock;
  out[4] = kTopMax;
  out[5] = kStepStamps;
  return static_cast<int>(e);
}

// One step's products in one cooperative launch of scan_step, on the
// grid the host planned (ops/scan.py step_plan), checked here: every
// block resident at once, a run of `per` tiles each, none empty, the
// shared memory the plan's. Returns the CUDA error code (0 = launched);
// allocates nothing and does not synchronize.
int mr_csr_scan_step(const int64_t* w) {
  const auto ptr = [w](int i) { return reinterpret_cast<void*>(static_cast<uintptr_t>(w[i])); };
  const int64_t n_seg = w[kSNSeg], n_tiles = w[kSNTiles], grid = w[kSGrid], per = w[kSPer];
  const int64_t held = w[kSHeld], smem = w[kSSmem];
  if (n_seg < 1 || n_tiles < 1 || n_tiles > INT32_MAX || per < 1 || grid < 1
      || (grid - 1) * per >= n_tiles || grid * per < n_tiles || held < 0 || held > per
      || smem != step_smem(per, held) || ptr(kSSegs) == nullptr || ptr(kSTiles) == nullptr
      || ptr(kSMarks) == nullptr || ptr(kSMarkRows) == nullptr || w[kSNMarks] < 2
      || w[kSNMarks] > INT32_MAX || ptr(kSTotals) == nullptr || ptr(kSEnds) == nullptr
      || ptr(kSY) == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int device = static_cast<int>(w[kSDevice]);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  // The kernel's shared memory limit and the card's resident blocks at
  // this plan's share, asked once a (device, share).
  static int set_device = -1;
  static int64_t known_smem = -1;
  static int resident = 0;
  if (set_device != device || known_smem != smem) {
    e = cudaFuncSetAttribute(scan_step, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    int per_sm = 0, sms = 0;
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scan_step, kStepThreads,
                                                        static_cast<size_t>(smem));
    }
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(e);
    }
    set_device = device;
    known_smem = smem;
    resident = per_sm * sms;
  }
  if (grid > resident) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  StepArgs a{};
  a.cols = static_cast<const int32_t*>(ptr(kSCols));
  a.vals = static_cast<const float*>(ptr(kSVals));
  a.segs = static_cast<const int64_t*>(ptr(kSSegs));
  for (int i = 0; i < kMaxX; ++i) a.x[i] = static_cast<const float*>(ptr(kSX + i));
  a.tiles = static_cast<const int32_t*>(ptr(kSTiles));
  a.marks = static_cast<const int32_t*>(ptr(kSMarks));
  a.rows = static_cast<const int32_t*>(ptr(kSMarkRows));
  a.n_marks = static_cast<int32_t>(w[kSNMarks]);
  a.totals = static_cast<Pair*>(ptr(kSTotals));
  a.ends = static_cast<Pair*>(ptr(kSEnds));
  a.y = static_cast<float*>(ptr(kSY));
  a.stamps = static_cast<unsigned long long*>(ptr(kSStamps));
  a.n_seg = static_cast<int32_t>(n_seg);
  a.n_tiles = static_cast<int32_t>(n_tiles);
  a.per = static_cast<int32_t>(per);
  a.held = static_cast<int32_t>(held);
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(scan_step),
                                  dim3(static_cast<unsigned>(grid)), dim3(kStepThreads), args,
                                  static_cast<size_t>(smem),
                                  static_cast<cudaStream_t>(ptr(kSStream)));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* mr_csr_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
