// K15 on Hopper: the explained program's attribution epilogue.
//
// Replaces what XLA compiles for the TPU in
// microrank_tpu/explain/extract.py :212 `rank_window_explained_core`
// (and its blob twin :277) past the traced rank program: :59
// `_slot_map`, :74 `_contrib_rows`, :172 `_top_traces`, and the
// counters, terms and mass it gathers at the suspects. The port's plain
// version is ops/explain.py `explain_plain`, which these kernels repeat
// bit for bit. From K6's finished weights and ranking (top_idx) and the
// final rv of both partitions, for the Ke suspects sus = top_idx[:Ke]:
//
//   counters [4, Ke]   ef, nf, ep, np at the suspects (spectrum_counters,
//                      the only-in-normal branch included)
//   terms    [13, Ke]  every formula of spectrum/formulas.py METHODS on
//                      them (rank_common.cuh `formula`, the epilogue's code)
//   mass     [2, Ke]   n_weight, a_weight at the suspects
//   trace_idx, trace_val [2, Ke, J]
//                      per partition and suspect, the top-J columns of
//                      p_sr[v, t] * rv[t], by value descending and column
//                      ascending on exact ties, -inf past the partition's
//                      live columns, (-inf, 0) past its padded columns
//
// p_sr's row is read from the route's own staged representation, each
// contribution one product as JAX computes it:
// * kBitmap (kind, packed, packed_bf16, packed_blocked): bit(cov_bits[v],
//   t) * (rv[t] * inv_tracelen[t]);
// * kEll (pcsr): any live slab cell of row t naming v (pc_ell_rs > 0),
//   times rv[t] * mult[t] / tracelen[t] (mult the kind column's
//   multiplicity on a collapsed build, else 1);
// * kOpMajor (csr): 0 + sr_val_opmajor[e] * rv[t] over the entries e of
//   v's range of the op-major view (inc_indptr_op), t = inc_trace_opmajor[e];
// * kTraceMajor (coo, pallas, dense, dense_bf16): 0 + sr_val[e] * rv[t]
//   over the live trace-major entries e (e < n_inc) whose op (clamped to
//   [0, V]) is v.
// The sparse routes rely on the build's order (graph/structures.py):
// trace-major entries sorted by (trace, op), each op's op-major range by
// trace; a run of one (trace, op) is summed in entry order, as JAX's
// scatter-add sums it (the builds hold each pair once). The suspects are
// distinct (a top-k's indices).
//
// What bounds it: bytes. Each partition's rv and its per-column vectors
// are read once, and of the staged view what the suspects need: Ke bitmap
// rows, the slab's ops (and rs where an op is a suspect), the suspects'
// op-major ranges, or every live trace-major entry's op and column (and
// the value where the op is a suspect). At the 10M-span pcsr window that
// is some 70 MB.
//
// The design: the contribution matrix [2, Ke, T] (about 0.2 GB at the
// giant windows) is never written, and a shared view is read once for up
// to kSus = 32 suspects (one match word; more go in chunks of 32, grid y;
// the bitmap and op-major routes, whose rows read their own bitmap rows or
// ranges, a warp's row each, chunks of 8). Every block holds its chunk's
// suspects in shared memory: their ops in slot order, (op, slot) sorted,
// and a filter of up to 65,536 bits (op mod the filter's size), so that a
// cell or an entry finds its slot with one shared-memory bit test and, on
// a hit, a 5-step search of the sorted list. Each partition is planned on
// its own work (ops/explain.py `explain_plan`): grid x is the normal
// partition's units, then the abnormal one's, sized so that the fill has
// some 264 blocks (two an SM), and one more block that writes the chunk's
// counters, terms and mass, a (suspect, formula) a thread:
// * explain_cols (bitmap, ELL): a unit is a tile of columns. A column's
//   match word (bit r: suspect r's cell is 1) and its weight go to shared
//   memory; an ELL column is read by a group of lanes (a power of two up
//   to 32; 16-byte loads of its ops, its rs only at a quad whose op is a
//   suspect), the words ORed by shuffles. The tile's item columns (some
//   row's cell 1, or a weight that is not finite) are listed once.
// * explain_sparse (op-major, trace-major): a unit is a tile of columns
//   (op-major: a warp a row finds its range by one round of 32 probes and
//   two half-warp 16-ary searches, and streams it) or a chunk of entries
//   (trace-major: the chunk's first pass, twice its nominal entries, is
//   loaded 16 bytes at a time before anything waits; its edges move to
//   trace starts, read off that pass by block-wide minima, so that each
//   chunk owns the columns from its first trace to the next chunk's and
//   sums each run alone; a run's neighbours come by shuffles; the items,
//   runs whose op is a suspect, are compacted in entry order into shared
//   memory).
// A row's contributions are then a stream of (column, value) items in
// column order; every other live column of the unit is +0, so its least
// keys are its lowest-numbered columns, which the selection counts off
// between the items without storing them. Each row's J least sort keys
// (rank_common.cuh `sort_key`: descending value, ascending column): for J
// <= kWarpJ a warp a row keeps its least keys sorted across its lanes by
// shuffle networks, skipping any batch of 32 that holds no key below its
// current J-th; past kWarpJ the block sorts the row's items, its first J
// zero and dead columns in shared memory (bitonic) and keeps the first J.
// A unit writes its J candidates as keys; `explain_merge`, grid (rows,
// groups), stages each group of candidate lists in shared memory and
// takes its least J by the same selection, launched again until one list
// a row is left, which is decoded into trace_idx / trace_val. No atomics;
// every value is written by one thread.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstring>

#include "rank_common.cuh"

namespace {

using namespace mr_rank;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSus = 32;                     // suspects a fill block holds (a match word)
constexpr int kFillBlocksPerSm = 4;          // the warp-select fills' blocks an SM, at least
constexpr int kWarpJ = 32;                   // J up to this: the warp-select
constexpr int kJMax = 2048;                  // ops/explain.py J_MAX
constexpr int kMergeWarp = 8192;             // keys a warp-select merge block folds
constexpr int kSortMin = 1024;               // the bitonic merge's keys, at least
constexpr int kSortMax = 8192;               // the bitonic path's largest sort
constexpr int kFilterWords = 2048;           // the suspects' op filter: 65,536 bits
constexpr int kPer = 8;                      // trace-major entries a thread a pass
constexpr int kPass = kThreads * kPer;
constexpr uint64_t kNone = ~0ull;            // a slot past the padded columns

// The routes (ops/explain.py ROUTES).
enum Route { kBitmap = 0, kEll = 1, kOpMajor = 2, kTraceMajor = 3 };

// A unit's size by route, at least and at most: columns a tile (bitmap,
// ELL, op-major), entries a chunk (trace-major) (ops/explain.py UNITS).
constexpr int kUnitMin[4] = {128, 16, 128, 64};
constexpr int kUnitMax[4] = {2048, 2048, 2048, 1024};
// Suspects a fill block holds by route: a match word's 32 where a block
// reads a view its rows share (ELL, trace-major); a warp's row each where
// every row reads its own bitmap row or op-major range (ops/explain.py
// CHUNK_ROWS).
constexpr int kChunkRows[4] = {kWarps, kSus, kWarps, kSus};

// One partition's inputs; a route reads its own fields, the others are null.
struct Part {
  const float* rv;               // [T] the final rv
  const int32_t* n_cols;         // 0-d: -1, or the kind columns
  const int32_t* n_traces;       // 0-d
  const uint8_t* cov_bits;       // [V, row_bytes] big-endian bitmap (kBitmap)
  const float* inv_tracelen;     // [T] (kBitmap)
  const int32_t* ell_op;         // [T, width] (kEll)
  const float* ell_rs;           // [T, width] (kEll)
  const int32_t* kind;           // [T] (kEll)
  const int32_t* tracelen;       // [T] (kEll)
  const int32_t* indptr;         // [V + 1] (kOpMajor)
  const int32_t* trace_om;       // [E] (kOpMajor)
  const float* val_om;           // [E] (kOpMajor)
  const int32_t* inc_op;         // [e] (kTraceMajor)
  const int32_t* inc_trace;      // [e] (kTraceMajor)
  const float* sr_val;           // [e] (kTraceMajor)
  const int32_t* n_inc;          // 0-d (kTraceMajor)
  int64_t row_bytes;
  int64_t e;                     // the trace-major arrays' length
  int32_t width;
  int32_t t;                     // padded columns
  int32_t unit;                  // columns a tile, or entries a chunk
  int32_t units;                 // the partition's tiles or chunks
};

struct Args {
  Part part[2];                  // normal, abnormal
  const int32_t* top_idx;        // [k]; the suspects are its first ke
  const float* n_weight;         // [V]
  const float* a_weight;
  const uint8_t* n_present;      // [V] (bool)
  const uint8_t* a_present;
  const int32_t* n_cov;          // [V] cov_unique
  const int32_t* a_cov;
  float* counters;               // [4, ke]
  float* terms;                  // [kMethods, ke]
  float* mass;                   // [2, ke]
  int32_t* trace_idx;            // [2, ke, j]
  float* trace_val;              // [2, ke, j]
  uint64_t* keys;                // [2, ke, lists, j] the units' candidates (lists > 1)
  int32_t route, v, ke, j, lists;
  float eps;
};

struct MergeArgs {
  const uint64_t* in;            // [rows, stride_in, j]
  uint64_t* out;                 // [rows, stride_out, j] (not the last pass)
  int32_t* trace_idx;            // [rows, j] (the last pass)
  float* trace_val;
  int32_t lists_in[2];           // each partition's candidate lists
  int32_t stride_in, stride_out, group, j, ke, keys;
  bool last;
};

// A fill block's suspects (chunk blockIdx.y).
struct Suspects {
  int32_t op[kSus];              // in slot order
  uint64_t sorted[kSus];         // (op, slot), ascending; kNone past the chunk
  uint32_t filter[kFilterWords]; // bit op & mask: some suspect's op may be op
  uint32_t mask;                 // the filter's bits - 1
  int n;
};

// The value a key was made from (its canonical score), as the plain
// version's `-neg_sorted` gives it; a NaN comes back as the default NaN.
__device__ __forceinline__ float key_value(uint64_t key) {
  const uint32_t hi = static_cast<uint32_t>(key >> 32);
  if (hi == 0xFFFFFFFFu) return __int_as_float(0x7fc00000);
  const uint32_t u = (hi & 0x80000000u) ? (hi & 0x7FFFFFFFu) : ~hi;
  return -__uint_as_float(u);
}

// Slot j of a final list: the column and its value, or (0, -inf) past
// the padded columns (JAX's padding where J exceeds T).
__device__ __forceinline__ void write_final(int32_t* idx, float* val, int64_t at, uint64_t key) {
  if (key == kNone) {
    idx[at] = 0;
    val[at] = neg_inf();
  } else {
    idx[at] = static_cast<int32_t>(key & 0xFFFFFFFFu);
    val[at] = key_value(key);
  }
}

// The 32 least of two ascending lists across the lanes, ascending.
__device__ __forceinline__ uint64_t merge_sorted(uint64_t x, uint64_t y) {
  return warp_merge(key_min(x, __shfl_sync(0xffffffffu, y, 31 - (threadIdx.x & 31))));
}

// A batch of keys (one a lane) into the ascending list x, whose first j
// stay exact: the keys below x's j-th, a few inserted one at a time (a
// ballot and a shuffle each), many by a sort and a merge.
__device__ __forceinline__ uint64_t add_batch(uint64_t x, uint64_t key, int j) {
  const int lane = threadIdx.x & 31;
  uint32_t take = __ballot_sync(0xffffffffu, key < __shfl_sync(0xffffffffu, x, j - 1));
  if (__popc(take) > 8) return merge_sorted(x, warp_sort(key));
  while (take) {
    const uint64_t c = __shfl_sync(0xffffffffu, key, __ffs(take) - 1);
    take &= take - 1;
    const int pos = __popc(__ballot_sync(0xffffffffu, x < c));
    const uint64_t up = __shfl_up_sync(0xffffffffu, x, 1);
    x = lane < pos ? x : (lane == pos ? c : up);
  }
  return x;
}

// The warp's 32 least of key_at(0 .. n), ascending across the lanes
// (kNone where fewer), exact in its first j: a batch with no key below
// the j-th least so far is skipped.
template <typename KeyAt>
__device__ __forceinline__ uint64_t warp_least(KeyAt key_at, int n, int j) {
  const int lane = threadIdx.x & 31;
  uint64_t x = warp_sort(lane < n ? key_at(lane) : kNone);
  for (int base = 32; base < n; base += 32) {
    const int i = base + lane;
    x = add_batch(x, i < n ? key_at(i) : kNone, j);
  }
  return x;
}

// Sort keys[0, n) ascending (n a power of two) by the block; ends
// synchronized.
__device__ __forceinline__ void bitonic_sort(uint64_t* keys, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += kThreads) {
        const int lo = 2 * stride * (i / stride) + (i % stride);
        const int hi = lo + stride;
        const bool ascending = (lo & size) == 0;
        const uint64_t x = keys[lo], y = keys[hi];
        if ((x > y) == ascending) {
          keys[lo] = y;
          keys[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ int pow2_at_least(int n) {
  int p = 2;
  while (p < n) p <<= 1;
  return p;
}

// The first e in [lo, hi) with a[e] > prev, or hi (a ascending there),
// by the warp together: probes 32 entries apart by 8, 256, 8,192, ...
// until one lands past prev (a trace-major chunk's edge is most often
// within a trace's length), then 32-ary steps inside that bracket.
// Every lane returns it.
__device__ __forceinline__ int64_t first_past(const int32_t* a, int64_t lo, int64_t hi,
                                              int32_t prev) {
  const int lane = threadIdx.x & 31;
  int64_t step = 8;
  bool bracketed = false;
  for (;;) {
    const int64_t q = lo + lane * step;
    const bool past = q >= hi || a[q] > prev;
    const uint32_t b = __ballot_sync(0xffffffffu, past);
    const int m = b ? __ffs(b) - 1 : 32;  // the probes before it are not past
    if (m == 0) return lo;
    if (step == 1 && m < 32) return lo + m;
    if (m < 32) {
      hi = min(hi, lo + m * step);
      bracketed = true;
    }
    lo += (m - 1) * step + 1;
    step = bracketed ? max(static_cast<int64_t>(1), (hi - lo + 31) / 32) : step * 32;
  }
}

// The entries of [lo, hi) (a ascending there) whose value lies in [c0,
// c1), as [*lo_out, *hi_out), by the warp together: one round of 32
// probes brackets both edges, then each half-warp narrows one edge by
// 16-ary steps. Every lane returns them.
__device__ __forceinline__ void value_range(const int32_t* a, int64_t lo, int64_t hi, int32_t c0,
                                            int32_t c1, int64_t* lo_out, int64_t* hi_out) {
  const int lane = threadIdx.x & 31, half = lane >> 4, hl = lane & 15;
  // First round: both edges (the first entry >= c0, the first >= c1).
  const int64_t step0 = max(static_cast<int64_t>(1), (hi - lo + 31) / 32);
  const int64_t q0 = lo + lane * step0;
  const int32_t v0 = q0 < hi ? a[q0] : 0;
  const uint32_t b_lo = __ballot_sync(0xffffffffu, q0 >= hi || v0 >= c0);
  const uint32_t b_hi = __ballot_sync(0xffffffffu, q0 >= hi || v0 >= c1);
  // Each edge lies in [l, h] (h past it or the range's end).
  const auto bracket = [&](uint32_t b, int64_t& l, int64_t& h) {
    const int m = b ? __ffs(b) - 1 : 32;
    h = min(hi, lo + m * step0);
    l = m ? lo + (m - 1) * step0 + 1 : lo;
  };
  int64_t l, h;
  if (half == 0) {
    bracket(b_lo, l, h);
  } else {
    bracket(b_hi, l, h);
  }
  const int32_t key = half == 0 ? c0 : c1;
  while (__any_sync(0xffffffffu, l < h)) {
    const int64_t step = max(static_cast<int64_t>(1), (h - l + 15) / 16);
    const int64_t q = l + hl * step;
    const bool past = q >= h || a[q] >= key;
    const uint32_t mine = (__ballot_sync(0xffffffffu, past) >> (16 * half)) & 0xFFFFu;
    const int m = mine ? __ffs(mine) - 1 : 16;
    if (l < h) {
      const int64_t nh = m ? min(h, l + m * step) : l;
      l = m ? l + (m - 1) * step + 1 : l;
      h = nh;
    }
  }
  *lo_out = __shfl_sync(0xffffffffu, l, 0);
  *hi_out = __shfl_sync(0xffffffffu, l, 16);
}

// Suspect i's formula m (ops/epilogue.py `spectrum_counters` at one op,
// op for op, then the formula); m == 0 also writes its counters and mass.
__device__ __forceinline__ void suspect_term(const Args& a, int i, int m) {
  const int o = a.top_idx[i];
  const bool in_a = a.a_present[o] != 0, in_n = a.n_present[o] != 0;
  const float aw = a.a_weight[o], nw = a.n_weight[o];
  const float acov = static_cast<float>(a.a_cov[o]), ncov = static_cast<float>(a.n_cov[o]);
  const float alen = static_cast<float>(*a.part[1].n_traces);
  const float nlen = static_cast<float>(*a.part[0].n_traces);
  const float ef = in_a ? f_mul(aw, acov) : a.eps;
  const float nf = in_a ? f_mul(aw, f_sub(alen, acov)) : a.eps;
  const float ep = in_a ? (in_n ? f_mul(nw, ncov) : a.eps) : f_mul(f_add(1.0f, nw), ncov);
  const float np = in_a ? (in_n ? f_mul(nw, f_sub(nlen, ncov)) : a.eps) : f_sub(nlen, ncov);
  const int ke = a.ke;
  a.terms[m * ke + i] = formula(m, ef, nf, ep, np);
  if (m == 0) {
    a.counters[i] = ef;
    a.counters[ke + i] = nf;
    a.counters[2 * ke + i] = ep;
    a.counters[3 * ke + i] = np;
    a.mass[i] = nw;
    a.mass[ke + i] = aw;
  }
}

// The fill grid's last block of each suspect chunk writes the chunk's
// terms, a (suspect, formula) a thread, beside the units' blocks; true
// for it.
__device__ __forceinline__ bool terms_block(const Args& a, int chunk) {
  if (static_cast<int>(blockIdx.x) != a.part[0].units + a.part[1].units) return false;
  const int r0 = static_cast<int>(blockIdx.y) * chunk;
  const int rows = min(chunk, a.ke - r0);
  for (int q = threadIdx.x; q < rows * kMethods; q += kThreads) {
    suspect_term(a, r0 + q / kMethods, q % kMethods);
  }
  return true;
}

// The block's partition, unit and suspect chunk (`chunk` rows). Loads the
// suspects (and, with `filter`, their sorted list and op filter); ends
// synchronized.
__device__ __forceinline__ void block_start(const Args& a, Suspects& s, bool filter, int chunk,
                                            int& p, int& u, int& r0, int& rows) {
  p = static_cast<int>(blockIdx.x) >= a.part[0].units ? 1 : 0;
  u = static_cast<int>(blockIdx.x) - (p ? a.part[0].units : 0);
  r0 = static_cast<int>(blockIdx.y) * chunk;
  rows = min(chunk, a.ke - r0);
  int bits = 32;
  while (bits < a.v && bits < kFilterWords * 32) bits <<= 1;
  const int words = bits / 32;
  if (threadIdx.x < 32) {
    const int i = threadIdx.x;
    const int32_t o = i < rows ? a.top_idx[r0 + i] : 0;
    s.op[i] = o;
    if (filter) {
      const uint64_t key = i < rows
          ? (static_cast<uint64_t>(static_cast<uint32_t>(o)) << 32) | static_cast<uint32_t>(i)
          : kNone;
      s.sorted[i] = warp_sort(key);
    }
  }
  if (filter) {
    for (int i = threadIdx.x; i < words; i += kThreads) s.filter[i] = 0;
  }
  if (threadIdx.x == 0) {
    s.mask = static_cast<uint32_t>(bits - 1);
    s.n = rows;
  }
  __syncthreads();
  if (filter && threadIdx.x == 0) {
    for (int i = 0; i < rows; ++i) {
      const uint32_t b = static_cast<uint32_t>(s.op[i]) & s.mask;
      s.filter[b >> 5] |= 1u << (b & 31);
    }
  }
  __syncthreads();
}

// The first of the sorted suspects whose op is `op` (0 <= op < V), or -1.
__device__ __forceinline__ int find_sorted(const Suspects& s, int32_t op) {
  const uint32_t b = static_cast<uint32_t>(op) & s.mask;
  if (!((s.filter[b >> 5] >> (b & 31)) & 1u)) return -1;
  int lo = 0, hi = s.n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<int32_t>(s.sorted[mid] >> 32) < op) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < s.n && static_cast<int32_t>(s.sorted[lo] >> 32) == op ? lo : -1;
}

__device__ __forceinline__ int sorted_slot(const Suspects& s, int i) {
  return static_cast<int>(s.sorted[i] & 0xFFFFFFFFu);
}

// A candidate of row r (of the chunk) of unit u: the final list when the
// plan has one unit a partition, else the unit's list.
__device__ __forceinline__ void emit(const Args& a, int p, int u, int r, int jj, uint64_t key) {
  const int64_t row = static_cast<int64_t>(p) * a.ke + r;
  if (a.lists == 1) {
    write_final(a.trace_idx, a.trace_val, row * a.j + jj, key);
  } else {
    a.keys[(row * a.lists + u) * a.j + jj] = key;
  }
}

// ------------------------------------------------------ the selection

// A row's running selection over its items, a stream of (column, key)
// in ascending column order inside a unit whose live columns start at
// `cur`: the 32 least item keys across the lanes, and the first J live
// columns no item names (their value +0, so their keys order by column),
// lane i the i-th.
struct RowSel {
  uint64_t x;
  int cur;      // the next column a zero may take
  int found;    // zero columns found, at most 32
  int z;        // this lane's zero column (lane < found)
};

__device__ __forceinline__ RowSel sel_start(int lo) { return RowSel{kNone, lo, 0, 0}; }

// The zero columns [cur, end) (at most what fills the 32 slots).
__device__ __forceinline__ void sel_gap(RowSel& s, int end) {
  const int lane = threadIdx.x & 31;
  const int gap = end - s.cur;
  if (gap <= 0) return;
  if (lane >= s.found && lane - s.found < gap) s.z = s.cur + (lane - s.found);
  s.found = gap >= 32 - s.found ? 32 : s.found + gap;
}

// A batch of item keys (kNone where a lane holds none) into the least
// (exact in the first j: a batch with none below the j-th is skipped).
__device__ __forceinline__ void sel_items(RowSel& s, uint64_t key, int j) {
  s.x = add_batch(s.x, key, j);
}

// One batch of 32 positions of a sparse stream: the lane's key (kNone
// where it holds no item of the row) and the ballot of those that do;
// the columns between the items are its zeros (counted off one item at a
// time only where a batch leaves a gap while fewer than J are found).
__device__ __forceinline__ void sel_feed(RowSel& s, uint64_t key, uint32_t mine, int j) {
  if (!mine) return;
  const int col = static_cast<int>(key & 0xFFFFFFFFu);
  if (s.found < j) {
    const int last = __shfl_sync(0xffffffffu, col, 31 - __clz(mine));
    if (last + 1 - s.cur == __popc(mine)) {
      s.cur = last + 1;
    } else {
      while (mine && s.found < j) {
        const int src = __ffs(mine) - 1;
        mine &= mine - 1;
        const int c = __shfl_sync(0xffffffffu, col, src);
        sel_gap(s, c);
        s.cur = c + 1;
      }
    }
  }
  sel_items(s, key, j);
}

// The row's candidates: its items' least keys with its first zero
// columns up to hi_live and its first dead columns [dead_lo, hi).
__device__ __forceinline__ uint64_t sel_finish(RowSel& s, int hi_live, int dead_lo, int hi,
                                               int j) {
  const int lane = threadIdx.x & 31;
  if (s.found < j) sel_gap(s, hi_live);
  const uint64_t zero = lane < min(s.found, j) ? sort_key(0.0f, s.z) : kNone;
  const uint64_t dead = lane < j && dead_lo + lane < hi ? sort_key(neg_inf(), dead_lo + lane)
                                                        : kNone;
  return merge_sorted(merge_sorted(s.x, zero), dead);
}

// The bitonic path's candidates of one row: buf[0, n) its items' keys,
// columns ascending in [lo, hi_live); then its first J zero columns (the
// i-th is lo + i + #{k : d_k <= i}, d_k = col_k - lo - k the zeros below
// item k) and first J dead columns [dead_lo, hi), sorted. Ends
// synchronized with buf[0, J) the row's least keys.
__device__ __forceinline__ void sorted_finish(uint64_t* buf, int n, int lo, int hi_live,
                                              int dead_lo, int hi, int j) {
  for (int i = threadIdx.x; i < j; i += kThreads) {
    int l = 0, h = n;
    while (l < h) {
      const int mid = (l + h) >> 1;
      if (static_cast<int>(buf[mid] & 0xFFFFFFFFu) - lo - mid <= i) {
        l = mid + 1;
      } else {
        h = mid;
      }
    }
    const int z = lo + i + l;
    buf[n + i] = z < hi_live ? sort_key(0.0f, z) : kNone;
    buf[n + j + i] = dead_lo + i < hi ? sort_key(neg_inf(), dead_lo + i) : kNone;
  }
  const int m = pow2_at_least(n + 2 * j);
  for (int i = n + 2 * j + static_cast<int>(threadIdx.x); i < m; i += kThreads) buf[i] = kNone;
  __syncthreads();
  bitonic_sort(buf, m);
}

// This thread's first place among the block's `cnt`s in thread order;
// `total` their sum. Two barriers.
__device__ __forceinline__ int block_place(int cnt, int* warp_total, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int t = warp_total[w];
    before += w < warp ? t : 0;
    total += t;
  }
  __syncthreads();
  return before + incl - cnt;
}

// ------------------------------------------------------------ bitmap, ELL

// Four ints (or floats) from p[at ..], `left` of them in the row: one
// 16-byte load when aligned and whole (kVec), else one at a time, `pad`
// past it.
template <bool kVec, typename T, typename V4>
__device__ __forceinline__ V4 load_quad(const T* p, int64_t at, int left, T pad) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const V4*>(p + at));
  } else {
    V4 r;
    r.x = left > 0 ? p[at] : pad;
    r.y = left > 1 ? p[at + 1] : pad;
    r.z = left > 2 ? p[at + 2] : pad;
    r.w = left > 3 ? p[at + 3] : pad;
    return r;
  }
}

// The match bits of one ELL cell: every slot whose suspect is `op`, when
// the cell is live.
__device__ __forceinline__ uint32_t cell_match(const Suspects& s, int i, float rs) {
  uint32_t m = 0;
  if (i >= 0 && rs > 0.0f) {
    const int32_t op = static_cast<int32_t>(s.sorted[i] >> 32);
    for (; i < s.n && static_cast<int32_t>(s.sorted[i] >> 32) == op; ++i) {
      m |= 1u << sorted_slot(s, i);
    }
  }
  return m;
}

// The match bits of a quad of ELL cells (ops `op`, their rs read only
// where an op is a suspect).
template <bool kVec>
__device__ __forceinline__ uint32_t quad_match(const Suspects& s, int4 op, uint32_t v,
                                               const float* rs_p, int64_t at, int left) {
  const int i0 = static_cast<uint32_t>(op.x) < v ? find_sorted(s, op.x) : -1;
  const int i1 = static_cast<uint32_t>(op.y) < v ? find_sorted(s, op.y) : -1;
  const int i2 = static_cast<uint32_t>(op.z) < v ? find_sorted(s, op.z) : -1;
  const int i3 = static_cast<uint32_t>(op.w) < v ? find_sorted(s, op.w) : -1;
  if (max(max(i0, i1), max(i2, i3)) < 0) return 0u;
  const float4 rs = load_quad<kVec, float, float4>(rs_p, at, left, 0.0f);
  return cell_match(s, i0, rs.x) | cell_match(s, i1, rs.y) | cell_match(s, i2, rs.z)
         | cell_match(s, i3, rs.w);
}

// One tile's ELL columns [c0, c0 + C) (live below hi_live): each
// column's match word and weight. A column's cells are read by a group of
// `lanes` lanes (a power of two up to 32, at most the column's quads of 4
// cells: a group lies in one warp, and C, at least 16, is a multiple of a
// warp's columns whenever lanes > 1); every lane of a warp runs the same
// iterations, so the shuffles see the whole warp. A column's weight is
// loaded beside its cells; where a lane reads one quad a column, two
// columns' loads are in flight at once.
template <bool kVec>
__device__ __forceinline__ void ell_build(const Part& g, const Suspects& s, int32_t v_ops, int c0,
                                          int C, int hi_live, int32_t n_cols, uint32_t* match,
                                          float* weight) {
  const int width = g.width;
  const int quads = (width + 3) / 4;
  const int lanes = quads >= 32 ? 32 : 1 << (31 - __clz(quads));
  const int sub = threadIdx.x & (lanes - 1);
  const uint32_t v = static_cast<uint32_t>(v_ops);
  const int step = kThreads / lanes;
  if (quads == lanes) {
    constexpr int kRound = 2;  // columns a lane loads at once
    for (int jj0 = threadIdx.x / lanes; jj0 < C; jj0 += kRound * step) {
      int4 op[kRound];
      float x[kRound];
      int32_t len[kRound], kind[kRound];
#pragma unroll
      for (int k = 0; k < kRound; ++k) {
        const int jj = jj0 + k * step, col = c0 + jj;
        const bool live = jj < C && col < hi_live;
        const int64_t at = static_cast<int64_t>(col) * width + 4 * sub;
        op[k] = live ? load_quad<kVec, int32_t, int4>(g.ell_op, at, width - 4 * sub, -1)
                     : make_int4(-1, -1, -1, -1);
        const bool own = live && sub == 0;
        x[k] = own ? g.rv[col] : 0.0f;
        len[k] = own ? g.tracelen[col] : 1;
        kind[k] = own && n_cols >= 0 ? g.kind[col] : 1;
      }
#pragma unroll
      for (int k = 0; k < kRound; ++k) {
        const int jj = jj0 + k * step, col = c0 + jj;
        const bool live = jj < C && col < hi_live;
        const int64_t at = static_cast<int64_t>(col) * width + 4 * sub;
        uint32_t m = live ? quad_match<kVec>(s, op[k], v, g.ell_rs, at, width - 4 * sub) : 0u;
        for (int off = lanes >> 1; off > 0; off >>= 1) m |= __shfl_xor_sync(0xffffffffu, m, off);
        if (sub == 0 && live) {
          const float mult = n_cols < 0 ? 1.0f : static_cast<float>(kind[k]);
          match[jj] = m;
          weight[jj] = f_div(f_mul(x[k], mult), static_cast<float>(len[k]));
        }
      }
    }
  } else {
    for (int jj = threadIdx.x / lanes; jj < C; jj += step) {
      const int col = c0 + jj;
      const bool live = col < hi_live;
      const bool own = live && sub == 0;
      const float x = own ? g.rv[col] : 0.0f;
      const int32_t len = own ? g.tracelen[col] : 1;
      const int32_t kind = own && n_cols >= 0 ? g.kind[col] : 1;
      uint32_t m = 0;
      if (live) {
        const int64_t cell = static_cast<int64_t>(col) * width;
#pragma unroll 4
        for (int q = sub; q < quads; q += lanes) {
          const int left = width - 4 * q;
          const int4 op = load_quad<kVec, int32_t, int4>(g.ell_op, cell + 4 * q, left, -1);
          m |= quad_match<kVec>(s, op, v, g.ell_rs, cell + 4 * q, left);
        }
      }
      for (int off = lanes >> 1; off > 0; off >>= 1) m |= __shfl_xor_sync(0xffffffffu, m, off);
      if (sub == 0 && live) {
        const float mult = n_cols < 0 ? 1.0f : static_cast<float>(kind);
        match[jj] = m;
        weight[jj] = f_div(f_mul(x, mult), static_cast<float>(len));
      }
    }
  }
}

// One tile of columns of one partition for a chunk of suspects: a
// column's match word and weight in shared memory, then each row's J
// least keys over the tile. The warp-select lists the tile's item
// columns once (a column some row's cell is 1 in, or whose weight is not
// finite, where 0 * w is NaN: every row's item), then a warp a row
// streams the list: the row's items into its 32 least keys, the live
// columns between them (+0) counted off as zeros.
template <bool kWarpSelect>
__global__ void __launch_bounds__(kThreads, kWarpSelect ? kFillBlocksPerSm : 1)
    explain_cols(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Suspects s;
  __shared__ int warp_total[kWarps];
  const int chunk = a.route == kEll ? kSus : kWarps;
  if (terms_block(a, chunk)) return;
  int p, u, r0, rows;
  block_start(a, s, a.route == kEll, chunk, p, u, r0, rows);
  const Part g = a.part[p];
  const int C = g.unit;
  uint32_t* match = reinterpret_cast<uint32_t*>(smem);                 // [C]
  float* weight = reinterpret_cast<float*>(smem + 4 * C);              // [C]
  int* items = reinterpret_cast<int*>(smem + 8 * C);                   // [C] (warp-select)
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem + 8 * C);          // [C] (bitonic)
  const int c0 = u * C;
  const int t_pad = g.t;
  const int32_t n_cols = *g.n_cols;
  const int n_live = n_cols < 0 ? *g.n_traces : n_cols;
  const int hi = min(c0 + C, t_pad);
  const int hi_live = max(c0, min(hi, n_live));
  const int dead_lo = max(c0, n_live);

  if (a.route == kBitmap) {
    for (int jj = threadIdx.x; jj < hi_live - c0; jj += kThreads) {
      const int col = c0 + jj;
      const int shift = 7 - (col & 7);
      uint32_t m = 0;
#pragma unroll
      for (int r = 0; r < kWarps; ++r) {  // a chunk's rows, every load in flight
        if (r < rows) {
          m |= static_cast<uint32_t>((g.cov_bits[s.op[r] * g.row_bytes + (col >> 3)] >> shift) & 1)
               << r;
        }
      }
      match[jj] = m;
      weight[jj] = f_mul(g.rv[col], g.inv_tracelen[col]);
    }
  } else {
    const bool vec = (g.width & 3) == 0
        && ((reinterpret_cast<uintptr_t>(g.ell_op) | reinterpret_cast<uintptr_t>(g.ell_rs)) & 15)
               == 0;
    if (vec) {
      ell_build<true>(g, s, a.v, c0, C, hi_live, n_cols, match, weight);
    } else {
      ell_build<false>(g, s, a.v, c0, C, hi_live, n_cols, match, weight);
    }
  }
  __syncthreads();

  if constexpr (kWarpSelect) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    // The item columns, in order: a thread a run of `per` columns.
    const int n_live_tile = hi_live - c0;
    const int per = (n_live_tile + kThreads - 1) / kThreads;
    const int j0 = threadIdx.x * per;
    const auto is_item = [&](int jj) {
      return jj < n_live_tile && (match[jj] != 0u || !isfinite(weight[jj]));
    };
    int cnt = 0;
    for (int k = 0; k < per; ++k) cnt += is_item(j0 + k) ? 1 : 0;
    int n;
    int pos = block_place(cnt, warp_total, n);
    for (int k = 0; k < per; ++k) {
      if (is_item(j0 + k)) items[pos++] = j0 + k;
    }
    __syncthreads();
    for (int r = warp; r < rows; r += kWarps) {
      RowSel sel = sel_start(c0);
      for (int b = 0; b < n; b += 32) {
        const int k = b + lane;
        const int jj = k < n ? items[k] : 0;
        const float w = weight[jj];
        const bool bit = (match[jj] >> r) & 1u;
        const bool mine = k < n && (bit || !isfinite(w));
        const uint64_t key = mine ? sort_key(f_add(f_mul(bit ? 1.0f : 0.0f, w), 0.0f), c0 + jj)
                                  : kNone;
        sel_feed(sel, key, __ballot_sync(0xffffffffu, mine), a.j);
      }
      const uint64_t x = sel_finish(sel, hi_live, dead_lo, hi, a.j);
      if (lane < a.j) emit(a, p, u, r0 + r, lane, x);
    }
  } else {
    const auto key_of = [&](int r, int i) -> uint64_t {
      const int col = c0 + i;
      if (col >= hi) return kNone;
      if (col >= n_live) return sort_key(neg_inf(), col);
      const float x = f_mul((match[i] >> r) & 1u ? 1.0f : 0.0f, weight[i]);
      return sort_key(f_add(x, 0.0f), col);
    };
    for (int r = 0; r < rows; ++r) {
      for (int i = threadIdx.x; i < C; i += kThreads) keys[i] = key_of(r, i);
      __syncthreads();
      bitonic_sort(keys, C);
      for (int jj = threadIdx.x; jj < a.j; jj += kThreads) {
        emit(a, p, u, r0 + r, jj, jj < C ? keys[jj] : kNone);
      }
      __syncthreads();
    }
  }
}

// ------------------------------------------------ op-major, trace-major

__device__ __forceinline__ int32_t clamp_op(int32_t op, int32_t v) { return min(max(op, 0), v); }

// A thread's kPer trace-major entries of a pass, from e0 (0 / -1 past
// `end` or the arrays), their ops clamped to [0, V]: two 16-byte loads
// each of ops and traces.
struct Entries {
  int32_t tr[kPer];
  int32_t op[kPer];
};

__device__ __forceinline__ Entries load_entries(const Part& g, int64_t e0, int64_t end,
                                                int32_t v, bool fast) {
  Entries q;
  const int64_t stop = min(g.e, end);
#pragma unroll
  for (int h = 0; h < kPer / 4; ++h) {
    const int64_t at = e0 + 4 * h;
    int4 op4, tr4;
    if (fast) {
      op4 = load_quad<true, int32_t, int4>(g.inc_op, at, 4, 0);
      tr4 = load_quad<true, int32_t, int4>(g.inc_trace, at, 4, -1);
    } else {
      const int64_t rest = stop - at;
      const int left = rest <= 0 ? 0 : (rest >= 4 ? 4 : static_cast<int>(rest));
      op4 = load_quad<false, int32_t, int4>(g.inc_op, at, left, 0);
      tr4 = load_quad<false, int32_t, int4>(g.inc_trace, at, left, -1);
    }
    q.tr[4 * h] = tr4.x;
    q.tr[4 * h + 1] = tr4.y;
    q.tr[4 * h + 2] = tr4.z;
    q.tr[4 * h + 3] = tr4.w;
    q.op[4 * h] = clamp_op(op4.x, v);
    q.op[4 * h + 1] = clamp_op(op4.y, v);
    q.op[4 * h + 2] = clamp_op(op4.z, v);
    q.op[4 * h + 3] = clamp_op(op4.w, v);
  }
  return q;
}

// Whether a pass from `base` may load its entries 16 bytes at a time:
// aligned, and every entry inside the arrays (entries past n_inc are
// read, and none of them is taken).
__device__ __forceinline__ bool pass_fast(const Part& g, int64_t base) {
  return ((reinterpret_cast<uintptr_t>(g.inc_op) | reinterpret_cast<uintptr_t>(g.inc_trace)) & 15)
             == 0
      && base + kPass <= g.e;
}

// The entry at e, (-1, -1) outside [0, end).
__device__ __forceinline__ int2 entry_at(const Part& g, int64_t e, int64_t end, int32_t v) {
  return e >= 0 && e < end ? make_int2(g.inc_trace[e], clamp_op(g.inc_op[e], v))
                           : make_int2(-1, -1);
}

// A pass's neighbours: where a thread's first entry's previous entry and
// its last entry's next lie (the lanes beside it, other warps' through
// shared memory, `before` and `after` at the pass's ends). Two barriers.
struct Sides {
  int32_t prev_t, prev_o, next_t, next_o;
};

__device__ __forceinline__ Sides pass_sides(const Entries& q, int2 before, int2 after,
                                            int2* stage) {
  // stage[w]: warp w's first entry; stage[kWarps + 1 + w]: its last;
  // stage[kWarps]: `after`; stage[kWarps + 1 + kWarps]: unused.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Sides n;
  n.prev_t = __shfl_up_sync(0xffffffffu, q.tr[kPer - 1], 1);
  n.prev_o = __shfl_up_sync(0xffffffffu, q.op[kPer - 1], 1);
  n.next_t = __shfl_down_sync(0xffffffffu, q.tr[0], 1);
  n.next_o = __shfl_down_sync(0xffffffffu, q.op[0], 1);
  __syncthreads();  // the stage's previous readers are done
  if (lane == 0) stage[warp] = make_int2(q.tr[0], q.op[0]);
  if (lane == 31) stage[kWarps + 1 + warp] = make_int2(q.tr[kPer - 1], q.op[kPer - 1]);
  if (threadIdx.x == 0) stage[kWarps] = after;
  __syncthreads();
  if (lane == 0) {
    const int2 p = warp ? stage[kWarps + warp] : before;
    n.prev_t = p.x;
    n.prev_o = p.y;
  }
  if (lane == 31) {
    const int2 x = stage[warp + 1];
    n.next_t = x.x;
    n.next_o = x.y;
  }
  return n;
}

// One pass of a trace-major chunk [s_lo, s_hi) over the entries from
// `base` (a thread's kPer, loaded, beside `sides`): its items, the runs of
// one (trace, clamped op) that start in the pass, whose op is a suspect
// (`want` < 0: any of the chunk's, else slot `want`) and whose trace is
// live, compacted in entry order to key[at ..] (and slot[at ..] when
// given), at most `cap` of them. Returns their count (every thread).
__device__ __forceinline__ int trace_major_pass(const Args& a, const Part& g, const Suspects& s,
                                                const Entries& q, const Sides& sides, int64_t base,
                                                int64_t s_lo, int64_t s_hi, int n_live, int want,
                                                uint64_t* key_out, uint8_t* slot_out, int at,
                                                int cap, int* warp_total) {
  const int32_t v = a.v;
  const int64_t e0 = base + kPer * static_cast<int64_t>(threadIdx.x);
  // The slots of the runs that start here (a byte each, 0xFF for none):
  // placed first, their keys computed as they are written.
  uint64_t slots = ~0ull;
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int64_t e = e0 + k;
    const int32_t t = q.tr[k], o = q.op[k];
    const int32_t pt = k ? q.tr[k - 1] : sides.prev_t, po = k ? q.op[k - 1] : sides.prev_o;
    if (e >= s_lo && e < s_hi && t >= 0 && t < n_live && (e == s_lo || pt != t || po != o)) {
      const int i = o < v ? find_sorted(s, o) : -1;
      const int sl = i < 0 ? -1 : sorted_slot(s, i);
      if (sl >= 0 && (want < 0 || sl == want)) {
        slots &= ~(0xFFull << (8 * k));
        slots |= static_cast<uint64_t>(sl) << (8 * k);
        ++cnt;
      }
    }
  }
  int total;
  int pos = at + block_place(cnt, warp_total, total);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int sl = static_cast<int>((slots >> (8 * k)) & 0xFF);
    if (sl == 0xFF) continue;
    const int64_t e = e0 + k;
    const int32_t t = q.tr[k], o = q.op[k];
    const float x = g.rv[t];
    float acc = f_add(0.0f, f_mul(g.sr_val[e], x));
    bool open = true;
#pragma unroll
    for (int k2 = k + 1; k2 < kPer; ++k2) {
      open = open && e0 + k2 < s_hi && q.tr[k2] == t && q.op[k2] == o;
      if (open) acc = f_add(acc, f_mul(g.sr_val[e0 + k2], x));
    }
    open = open && e0 + kPer < s_hi && sides.next_t == t && sides.next_o == o;
    for (int64_t e2 = e0 + kPer; open; ++e2) {
      acc = f_add(acc, f_mul(g.sr_val[e2], x));
      open = e2 + 1 < s_hi && g.inc_trace[e2 + 1] == t && clamp_op(g.inc_op[e2 + 1], v) == o;
    }
    if (pos < cap) {
      key_out[pos] = sort_key(f_add(acc, 0.0f), t);
      if (slot_out != nullptr) slot_out[pos] = static_cast<uint8_t>(sl);
    }
    ++pos;
  }
  __syncthreads();
  return total;
}

// A trace-major chunk's edges (every thread; one barrier): the first
// trace starts at or past uK (0 for chunk 0) and at or past (u + 1)K
// (n_inc when none), read off the first pass's entries, searched for past
// them (a trace longer than the pass) by warp 0.
__device__ __forceinline__ void chunk_edges(const Part& g, const Entries& q, const Sides& sides,
                                            int64_t first, int64_t n_inc, int u, int64_t* edge) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t e0 = first + kPer * static_cast<int64_t>(threadIdx.x);
  const int64_t split = first + g.unit;
  uint32_t lo = ~0u, hi = ~0u;   // offsets past `first`
#pragma unroll
  for (int k = kPer - 1; k >= 0; --k) {
    const int64_t e = e0 + k;
    const int32_t pt = k ? q.tr[k - 1] : sides.prev_t;
    if (e < n_inc && (e == 0 || q.tr[k] != pt)) {
      lo = static_cast<uint32_t>(e - first);
      if (e >= split) hi = static_cast<uint32_t>(e - first);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_min_sync(0xffffffffu, hi);
  __shared__ uint32_t mins[2][kWarps];
  if (lane == 0) {
    mins[0][warp] = lo;
    mins[1][warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    uint32_t m[2];
    for (int i = 0; i < 2; ++i) {
      m[i] = lane < kWarps ? mins[i][lane] : ~0u;
      m[i] = __reduce_min_sync(0xffffffffu, m[i]);
    }
    const int64_t end = first + kPass;   // past the pass's entries
    int64_t at[2];
    for (int i = 0; i < 2; ++i) {
      const int64_t from = i ? split : first;
      if (i == 0 && u == 0) {
        at[i] = 0;
      } else if (from >= n_inc) {
        at[i] = n_inc;
      } else if (m[i] != ~0u) {
        at[i] = first + m[i];
      } else if (end >= n_inc) {
        at[i] = n_inc;
      } else {
        at[i] = first_past(g.inc_trace, end, n_inc, g.inc_trace[end - 1]);
      }
    }
    if (lane < 2) {
      const int64_t e = at[lane];
      edge[lane] = e;
      edge[2 + lane] = lane == 0 && u == 0 ? 0
          : (e < n_inc ? min(max(g.inc_trace[e], 0), g.t) : g.t);
    }
  }
  __syncthreads();
}

// One unit of one partition for a chunk of suspects, from a sparse view:
// each row's items (op-major: its tile range; trace-major: the chunk's
// entries) against its zero and dead columns, then its J least keys.
template <bool kWarpSelect>
__global__ void __launch_bounds__(kThreads, kWarpSelect ? kFillBlocksPerSm : 1)
    explain_sparse(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Suspects s;
  __shared__ uint64_t item_key[kWarpSelect ? kPass : 1];
  __shared__ uint8_t item_slot[kWarpSelect ? kPass : 1];
  __shared__ int warp_total[kWarps];
  __shared__ int64_t edge[4];   // trace-major: s_lo, s_hi, b_lo, b_hi; op-major: a row's range
  __shared__ int2 stage[2 * kWarps + 2];
  // The warp-select's rows between trace-major passes.
  __shared__ uint64_t sel_x[kWarpSelect ? kSus : 1][32];
  __shared__ int sel_z[kWarpSelect ? kSus : 1][32];
  __shared__ int sel_cur[kSus], sel_found[kSus];
  const bool trace_major = a.route == kTraceMajor;
  if (terms_block(a, trace_major ? kSus : kWarps)) return;
  const Part g = a.part[static_cast<int>(blockIdx.x) >= a.part[0].units ? 1 : 0];
  const int u0 = static_cast<int>(blockIdx.x) - (static_cast<int>(blockIdx.x) >= a.part[0].units
                                                  ? a.part[0].units : 0);
  const int32_t v = a.v;
  // Trace-major: the chunk's first pass (its nominal entries and past
  // them, where its last trace ends) and the entries around it are loaded
  // before anything waits.
  const int64_t first = static_cast<int64_t>(u0) * g.unit;
  Entries pass0{};
  int2 before = make_int2(-1, -1), after = make_int2(-1, -1);
  int64_t n_inc = 0;
  if (trace_major) {
    n_inc = min(static_cast<int64_t>(max(*g.n_inc, 0)), g.e);
    pass0 = load_entries(g, first + kPer * threadIdx.x, n_inc, v, pass_fast(g, first));
    if (threadIdx.x == 0) before = entry_at(g, first - 1, n_inc, v);
    if (threadIdx.x == 0) after = entry_at(g, first + kPass, n_inc, v);
  }
  int p, u, r0, rows;
  block_start(a, s, trace_major, trace_major ? kSus : kWarps, p, u, r0, rows);
  uint64_t* buf = reinterpret_cast<uint64_t*>(smem);  // the bitonic path's row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int J = a.j;
  const int t_pad = g.t;
  const int32_t n_cols = *g.n_cols;
  const int n_live = n_cols < 0 ? *g.n_traces : n_cols;

  if (trace_major) {
    const Sides sides0 = pass_sides(pass0, before, after, stage);
    chunk_edges(g, pass0, sides0, first, n_inc, u, edge);
    const int64_t s_lo = edge[0], s_hi = edge[1];
    const int b_lo = static_cast<int>(edge[2]), b_hi = static_cast<int>(edge[3]);
    const int hi_live = max(b_lo, min(b_hi, n_live));
    const int dead_lo = max(b_lo, n_live);
    // A pass past the first: its entries and sides, loaded.
    const auto pass_at = [&](int64_t base, Entries& q) {
      q = load_entries(g, base + kPer * threadIdx.x, s_hi, v, pass_fast(g, base));
      const int2 b = threadIdx.x == 0 ? entry_at(g, base - 1, s_hi, v) : make_int2(-1, -1);
      const int2 f = threadIdx.x == 0 ? entry_at(g, base + kPass, s_hi, v) : make_int2(-1, -1);
      return pass_sides(q, b, f, stage);
    };
    if constexpr (kWarpSelect) {
      // A row's selection lives in shared memory between passes (most
      // chunks take one), a warp's rows in turn.
      const auto feed = [&](int n) {
        for (int r = warp; r < rows; r += kWarps) {
          RowSel sel{sel_x[r][lane], sel_cur[r], sel_found[r], sel_z[r][lane]};
          for (int b = 0; b < n; b += 32) {
            const int k = b + lane;
            const bool mine = k < n && item_slot[k] == r;
            sel_feed(sel, mine ? item_key[k] : kNone, __ballot_sync(0xffffffffu, mine), J);
          }
          sel_x[r][lane] = sel.x;
          sel_z[r][lane] = sel.z;
          if (lane == 0) {
            sel_cur[r] = sel.cur;
            sel_found[r] = sel.found;
          }
        }
        __syncthreads();
      };
      for (int r = warp; r < rows; r += kWarps) {
        sel_x[r][lane] = kNone;
        sel_z[r][lane] = 0;
        if (lane == 0) {
          sel_cur[r] = b_lo;
          sel_found[r] = 0;
        }
      }
      feed(trace_major_pass(a, g, s, pass0, sides0, first, s_lo, s_hi, n_live, -1, item_key,
                            item_slot, 0, kPass, warp_total));
      for (int64_t base = first + kPass; base < s_hi; base += kPass) {
        Entries q;
        const Sides sides = pass_at(base, q);
        feed(trace_major_pass(a, g, s, q, sides, base, s_lo, s_hi, n_live, -1, item_key,
                              item_slot, 0, kPass, warp_total));
      }
      for (int r = warp; r < rows; r += kWarps) {
        RowSel sel{sel_x[r][lane], sel_cur[r], sel_found[r], sel_z[r][lane]};
        const uint64_t x = sel_finish(sel, hi_live, dead_lo, b_hi, J);
        if (lane < J) emit(a, p, u, r0 + r, lane, x);
      }
    } else {
      const int cap = g.unit;
      for (int r = 0; r < rows; ++r) {
        int n = 0;
        for (int64_t base = first; base < s_hi; base += kPass) {
          Entries q = pass0;
          const Sides sides = base == first ? sides0 : pass_at(base, q);
          n += trace_major_pass(a, g, s, q, sides, base, s_lo, s_hi, n_live, r, buf, nullptr, n,
                                cap, warp_total);
        }
        sorted_finish(buf, min(n, cap), b_lo, hi_live, dead_lo, b_hi, J);
        for (int jj = threadIdx.x; jj < J; jj += kThreads) emit(a, p, u, r0 + r, jj, buf[jj]);
        __syncthreads();
      }
    }
    return;
  }

  // Op-major: a tile of columns [c0, hi); a row's entries of its op inside
  // it, found by a warp-cooperative search.
  const int C = g.unit;
  const int c0 = u * C;
  const int hi = min(c0 + C, t_pad);
  const int hi_live = max(c0, min(hi, n_live));
  const int dead_lo = max(c0, n_live);
  const auto range = [&](int r, int64_t& lo_e, int64_t& hi_e) {
    const int o = s.op[r];
    value_range(g.trace_om, g.indptr[o], g.indptr[o + 1], c0, hi, &lo_e, &hi_e);
  };
  // The key of the run that starts at entry e (column t, its previous
  // entry's column pt, its next entry's column nt), or kNone.
  const auto item = [&](int64_t e, int64_t hi_e, int32_t t, int32_t pt, int32_t nt) -> uint64_t {
    if (e >= hi_e || t >= n_live || t == pt) return kNone;
    const float x = g.rv[t];
    float acc = f_add(0.0f, f_mul(g.val_om[e], x));
    for (int64_t e2 = e + 1; e2 < hi_e && (e2 == e + 1 ? nt : g.trace_om[e2]) == t; ++e2) {
      acc = f_add(acc, f_mul(g.val_om[e2], x));
    }
    return sort_key(f_add(acc, 0.0f), t);
  };
  if constexpr (kWarpSelect) {
    // A warp a row; four batches of 32 entries loaded at once.
    constexpr int kBatches = 4;
    for (int r = warp; r < rows; r += kWarps) {
      int64_t lo_e, hi_e;
      range(r, lo_e, hi_e);
      RowSel sel = sel_start(c0);
      int32_t carry = -1;   // the column before the batch (none before the range)
      for (int64_t base = lo_e; base < hi_e; base += 32 * kBatches) {
        int32_t t[kBatches];
#pragma unroll
        for (int k = 0; k < kBatches; ++k) {
          const int64_t e = base + 32 * k + lane;
          t[k] = e < hi_e ? g.trace_om[e] : -1;
        }
        const int64_t after = base + 32 * kBatches;
        const int32_t t_after = lane == 31 && after < hi_e ? g.trace_om[after] : -1;
        uint64_t key[kBatches];
#pragma unroll
        for (int k = 0; k < kBatches; ++k) {
          int32_t pt = __shfl_up_sync(0xffffffffu, t[k], 1);
          int32_t nt = __shfl_down_sync(0xffffffffu, t[k], 1);
          const int32_t last = k ? __shfl_sync(0xffffffffu, t[k - 1], 31) : carry;
          const int32_t next = k + 1 < kBatches ? __shfl_sync(0xffffffffu, t[k + 1], 0) : t_after;
          if (lane == 0) pt = last;
          if (lane == 31) nt = next;
          key[k] = item(base + 32 * k + lane, hi_e, t[k], pt, nt);
        }
#pragma unroll
        for (int k = 0; k < kBatches; ++k) {
          sel_feed(sel, key[k], __ballot_sync(0xffffffffu, key[k] != kNone), J);
        }
        carry = __shfl_sync(0xffffffffu, t[kBatches - 1], 31);
      }
      const uint64_t x = sel_finish(sel, hi_live, dead_lo, hi, J);
      if (lane < J) emit(a, p, u, r0 + r, lane, x);
    }
  } else {
    for (int r = 0; r < rows; ++r) {
      if (warp == 0) {
        int64_t lo_e, hi_e;
        range(r, lo_e, hi_e);
        if (lane == 0) {
          edge[0] = lo_e;
          edge[1] = hi_e;
        }
      }
      __syncthreads();
      const int64_t lo_e = edge[0], hi_e = edge[1];
      int n = 0;
      for (int64_t b = lo_e; b < hi_e; b += kThreads) {
        const int64_t e = b + threadIdx.x;
        const int32_t t = e < hi_e ? g.trace_om[e] : -1;
        const int32_t pt = e > lo_e && e < hi_e ? g.trace_om[e - 1] : -1;
        const int32_t nt = e + 1 < hi_e ? g.trace_om[e + 1] : -1;
        const uint64_t key = item(e, hi_e, t, pt, nt);
        int total;
        const int pos = n + block_place(key != kNone ? 1 : 0, warp_total, total);
        if (key != kNone && pos < C) buf[pos] = key;
        n += total;
      }
      __syncthreads();
      sorted_finish(buf, min(n, C), c0, hi_live, dead_lo, hi, J);
      for (int jj = threadIdx.x; jj < J; jj += kThreads) emit(a, p, u, r0 + r, jj, buf[jj]);
      __syncthreads();
    }
  }
}

// The least J keys of each group of `group` candidate lists of a row
// (grid x the row, y the group), by the fill's selection over the
// group's keys staged in shared memory (every load in flight at once);
// the last pass (one group a row) decodes them.
template <bool kWarpSelect>
__global__ void __launch_bounds__(kThreads) explain_merge(MergeArgs m) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t lists[kWarps][32];
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem);  // [m.keys]
  const int64_t row = blockIdx.x;
  const int lists_in = m.lists_in[row >= m.ke ? 1 : 0];
  const int first = static_cast<int>(blockIdx.y) * m.group;
  if (first >= lists_in) return;
  const int count = min(m.group, lists_in - first);
  const int n = count * m.j;
  const uint64_t* src = m.in + (row * m.stride_in + first) * m.j;
  const int padded = kWarpSelect ? n : m.keys;
  for (int i = threadIdx.x; i < padded; i += kThreads) keys[i] = i < n ? src[i] : kNone;
  __syncthreads();
  const auto emit_key = [&](int jj, uint64_t key) {
    if (m.last) {
      write_final(m.trace_idx, m.trace_val, row * m.j + jj, key);
    } else {
      m.out[(row * m.stride_out + blockIdx.y) * m.j + jj] = key;
    }
  };
  if constexpr (kWarpSelect) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int per = (n + kWarps - 1) / kWarps;
    const int lo = warp * per;
    const int len = max(0, min(per, n - lo));
    lists[warp][lane] = warp_least([&](int i) { return keys[lo + i]; }, len, m.j);
    __syncthreads();
    if (warp == 0) {
      uint64_t x = lists[0][lane];
      for (int w = 1; w < kWarps; ++w) x = merge_lists(x, lists[w]);
      if (lane < m.j) emit_key(lane, x);
    }
  } else {
    bitonic_sort(keys, m.keys);
    for (int jj = threadIdx.x; jj < m.j; jj += kThreads) emit_key(jj, keys[jj]);
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

constexpr int kDynSmemMax = 8 * kSortMax;  // the bitonic path's row, the most dynamic memory

cudaError_t allow_smem() {
  const void* kernels[] = {
      reinterpret_cast<const void*>(explain_cols<true>),
      reinterpret_cast<const void*>(explain_cols<false>),
      reinterpret_cast<const void*>(explain_sparse<true>),
      reinterpret_cast<const void*>(explain_sparse<false>),
      reinterpret_cast<const void*>(explain_merge<true>),
      reinterpret_cast<const void*>(explain_merge<false>),
  };
  for (const void* k : kernels) {
    const cudaError_t e =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kDynSmemMax);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

int64_t pow2_ge(int64_t n) {
  int64_t p = 2;
  while (p < n) p <<= 1;
  return p;
}

// The argument block of mr_explain_launch (int64 words; ops/explain.py
// ARGS packs it): for the normal then the abnormal partition the
// kPartWords fields of Part in its order (the integers last), then the
// fields below.
enum Word {
  kPartWords = 22,
  kTopIdx = 2 * kPartWords, kNWeight, kAWeight, kNPresent, kAPresent, kNCov, kACov,
  kCounters, kTerms, kMass, kTraceIdx, kTraceVal, kKeysA, kKeysB,
  kRoute, kV, kKe, kJ, kLists, kGroup, kMergeKeys, kEpsBits, kDevice, kStream,
  kWords
};

}  // namespace

extern "C" {

// The library's limits: out[0] kSus, out[1] kWarpJ, out[2] the words of
// an argument block, out[3] kThreads, out[4] kMergeWarp, out[5]
// kSortMin, out[6] kSortMax, out[7 ..] each route's (least, largest)
// unit, out[15 ..] each route's chunk rows.
int mr_explain_config(int32_t* out) {
  out[0] = kSus;
  out[1] = kWarpJ;
  out[2] = kWords;
  out[3] = kThreads;
  out[4] = kMergeWarp;
  out[5] = kSortMin;
  out[6] = kSortMax;
  for (int r = 0; r < 4; ++r) {
    out[7 + 2 * r] = kUnitMin[r];
    out[8 + 2 * r] = kUnitMax[r];
    out[15 + r] = kChunkRows[r];
  }
  return 0;
}

// K15 for one window, on the given stream: one launch of the route's fill
// (explain_cols or explain_sparse) over each partition's units, then
// explain_merge, each pass over groups of `group` lists, until one list a
// row is left (the plan of ops/explain.py `explain_plan`, checked here).
// Returns the CUDA error code of the launches (0 = launched); allocates
// nothing and does not synchronize.
int mr_explain_launch(const int64_t* w) {
  const auto ptr = [w](int i) { return reinterpret_cast<void*>(static_cast<uintptr_t>(w[i])); };
  const int64_t route = w[kRoute], v = w[kV], ke = w[kKe], j = w[kJ];
  const int64_t lists = w[kLists], group = w[kGroup], merge_keys = w[kMergeKeys];
  const bool warp = j <= kWarpJ;
  if (route < kBitmap || route > kTraceMajor || v < 1 || v > 0x7FFFFFFF || ke < 1 || j < 1
      || j > kJMax || 2 * ke > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t chunks = (ke + kChunkRows[route] - 1) / kChunkRows[route];
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t want_keys = warp ? kMergeWarp : std::max<int64_t>(kSortMin, pow2_ge(2 * j));
  if (merge_keys != want_keys || group != merge_keys / j) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  int64_t units_max = 0, units_sum = 0, unit_max = 0;
  for (int p = 0; p < 2; ++p) {
    const int o = kPartWords * p;
    Part& g = a.part[p];
    g.rv = static_cast<const float*>(ptr(o));
    g.n_cols = static_cast<const int32_t*>(ptr(o + 1));
    g.n_traces = static_cast<const int32_t*>(ptr(o + 2));
    g.cov_bits = static_cast<const uint8_t*>(ptr(o + 3));
    g.inv_tracelen = static_cast<const float*>(ptr(o + 4));
    g.ell_op = static_cast<const int32_t*>(ptr(o + 5));
    g.ell_rs = static_cast<const float*>(ptr(o + 6));
    g.kind = static_cast<const int32_t*>(ptr(o + 7));
    g.tracelen = static_cast<const int32_t*>(ptr(o + 8));
    g.indptr = static_cast<const int32_t*>(ptr(o + 9));
    g.trace_om = static_cast<const int32_t*>(ptr(o + 10));
    g.val_om = static_cast<const float*>(ptr(o + 11));
    g.inc_op = static_cast<const int32_t*>(ptr(o + 12));
    g.inc_trace = static_cast<const int32_t*>(ptr(o + 13));
    g.sr_val = static_cast<const float*>(ptr(o + 14));
    g.n_inc = static_cast<const int32_t*>(ptr(o + 15));
    g.row_bytes = w[o + 16];
    g.e = w[o + 17];
    const int64_t width = w[o + 18], t = w[o + 19], unit = w[o + 20], units = w[o + 21];
    const int64_t size = route == kTraceMajor ? g.e : t;
    const bool ok = g.rv != nullptr && g.n_cols != nullptr && g.n_traces != nullptr && t >= 1
        && t <= 0x7FFFFFFF && unit >= kUnitMin[route] && unit <= kUnitMax[route]
        && (unit & (unit - 1)) == 0 && size >= 1 && units == (size + unit - 1) / unit
        && (route != kBitmap || (g.cov_bits != nullptr && g.inv_tracelen != nullptr
                                 && g.row_bytes * 8 >= t))
        && (route != kEll || (g.ell_op != nullptr && g.ell_rs != nullptr && g.kind != nullptr
                              && g.tracelen != nullptr && width >= 1 && width <= 4096))
        && (route != kOpMajor || (g.indptr != nullptr && g.trace_om != nullptr
                                  && g.val_om != nullptr))
        && (route != kTraceMajor || (g.inc_op != nullptr && g.inc_trace != nullptr
                                     && g.sr_val != nullptr && g.n_inc != nullptr));
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    g.width = static_cast<int32_t>(width);
    g.t = static_cast<int32_t>(t);
    g.unit = static_cast<int32_t>(unit);
    g.units = static_cast<int32_t>(units);
    units_max = std::max(units_max, units);
    units_sum += units;
    unit_max = std::max(unit_max, unit);
  }
  const int64_t groups0 = (units_max + group - 1) / group;
  if (lists != units_max || units_sum >= 0x7FFFFFFF || groups0 > 65535
      || (lists > 1 && ptr(kKeysA) == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.top_idx = static_cast<const int32_t*>(ptr(kTopIdx));
  a.n_weight = static_cast<const float*>(ptr(kNWeight));
  a.a_weight = static_cast<const float*>(ptr(kAWeight));
  a.n_present = static_cast<const uint8_t*>(ptr(kNPresent));
  a.a_present = static_cast<const uint8_t*>(ptr(kAPresent));
  a.n_cov = static_cast<const int32_t*>(ptr(kNCov));
  a.a_cov = static_cast<const int32_t*>(ptr(kACov));
  a.counters = static_cast<float*>(ptr(kCounters));
  a.terms = static_cast<float*>(ptr(kTerms));
  a.mass = static_cast<float*>(ptr(kMass));
  a.trace_idx = static_cast<int32_t*>(ptr(kTraceIdx));
  a.trace_val = static_cast<float*>(ptr(kTraceVal));
  a.keys = static_cast<uint64_t*>(ptr(kKeysA));
  a.route = static_cast<int32_t>(route);
  a.v = static_cast<int32_t>(v);
  a.ke = static_cast<int32_t>(ke);
  a.j = static_cast<int32_t>(j);
  a.lists = static_cast<int32_t>(lists);
  const uint32_t eps_bits = static_cast<uint32_t>(w[kEpsBits]);
  std::memcpy(&a.eps, &eps_bits, sizeof(a.eps));
  const auto stream = static_cast<cudaStream_t>(ptr(kStream));
  const int device = static_cast<int>(w[kDevice]);
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  static int allowed = -1;  // the device whose attributes are set
  if (allowed != device) {
    e = allow_smem();
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = device;
  }
  const dim3 fill_grid(static_cast<unsigned>(units_sum + 1),
                       static_cast<unsigned>(chunks));
  if (route == kBitmap || route == kEll) {
    const size_t smem = static_cast<size_t>(unit_max * (warp ? 12 : 16));
    if (warp) {
      explain_cols<true><<<fill_grid, kThreads, smem, stream>>>(a);
    } else {
      explain_cols<false><<<fill_grid, kThreads, smem, stream>>>(a);
    }
  } else if (warp) {
    explain_sparse<true><<<fill_grid, kThreads, 0, stream>>>(a);
  } else {
    const size_t smem = static_cast<size_t>(8 * pow2_ge(unit_max + 2 * j));
    explain_sparse<false><<<fill_grid, kThreads, smem, stream>>>(a);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  MergeArgs m{};
  m.trace_idx = a.trace_idx;
  m.trace_val = a.trace_val;
  m.j = static_cast<int32_t>(j);
  m.ke = static_cast<int32_t>(ke);
  m.group = static_cast<int32_t>(group);
  int64_t n[2] = {a.part[0].units, a.part[1].units};
  int64_t stride = lists;
  uint64_t* src = a.keys;
  uint64_t* dst = static_cast<uint64_t*>(ptr(kKeysB));
  while (std::max(n[0], n[1]) > 1) {
    const int64_t out[2] = {(n[0] + group - 1) / group, (n[1] + group - 1) / group};
    const int64_t groups = std::max(out[0], out[1]);
    m.last = groups == 1;
    if (!m.last && dst == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    m.in = src;
    m.out = dst;
    m.lists_in[0] = static_cast<int32_t>(n[0]);
    m.lists_in[1] = static_cast<int32_t>(n[1]);
    m.stride_in = static_cast<int32_t>(stride);
    m.stride_out = static_cast<int32_t>(groups);
    const dim3 grid(static_cast<unsigned>(2 * ke), static_cast<unsigned>(groups));
    // A block's keys: its group's lists (the bitonic path sorts them in a
    // power of two), no more.
    const int64_t taken = std::min(group, std::max(n[0], n[1])) * j;
    m.keys = static_cast<int32_t>(warp ? taken : pow2_ge(taken));
    const size_t smem = static_cast<size_t>(m.keys) * 8;
    if (warp) {
      explain_merge<true><<<grid, kThreads, smem, stream>>>(m);
    } else {
      explain_merge<false><<<grid, kThreads, smem, stream>>>(m);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    n[0] = out[0];
    n[1] = out[1];
    stride = groups;
    uint64_t* t = src;
    src = dst;
    dst = t;
  }
  return 0;
}

const char* mr_explain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
