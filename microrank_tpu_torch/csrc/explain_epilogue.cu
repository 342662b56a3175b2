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
//   over the live trace-major entries e (e < n_inc) whose op is v.
// The sparse routes rely on the build's order (graph/structures.py):
// trace-major entries sorted by (trace, op), each op's op-major range by
// trace, so that a tile's entries are one binary search away; an (op,
// trace) pair held twice would be summed in entry order, as JAX's
// scatter-add sums it (the builds hold each pair once).
//
// What bounds it: bytes. Each partition's rv and its per-column vector
// are read once, and the suspects' rows of the staged view: Ke bitmap
// rows, the whole ELL slab, or the suspects' entries. At a config-5 kind
// window that is tens of kilobytes; at the 10M-span pcsr window the slab
// and rv, some 50 MB.
//
// The design: the contribution matrix [2, Ke, T] (about 0.2 GB at the
// giant windows) is never written. `explain_tiles`, grid (column tiles,
// suspect chunks, partition), builds one tile of up to kRows suspects'
// rows in shared memory from the route's view, then selects each row's J
// least sort keys (rank_common.cuh
// `sort_key`: descending value, ascending column): for J <= kWarpJ a warp
// a row keeps its 32 least keys sorted across its lanes by shuffle
// networks, skipping any batch of 32 that holds no key below its current
// 32nd; past kWarpJ the block sorts the row's keys in shared memory
// (bitonic) and keeps the first J. A tile writes its J candidates as
// keys; `explain_merge`, grid (groups, rows), takes the least J of each
// group of tile // J lists by the same selection, launched again until
// one list a row is left, which is decoded into trace_idx / trace_val.
// A tile is the widest of 2,048 down to 256 columns that still gives the
// fill some 256 blocks (ops/explain.py `explain_plan`): a window of few
// columns spreads its fill, whose blocks scan a slab row or a tile's
// entries, over more of the card; past kWarpJ at least 2J. An ELL column
// is read by a group of lanes, a power of two up to 32 that leaves each
// lane at least 4 of the slab's cells (one lane a column on a narrow
// slab), its match bits ORed by shuffles.
// Block (0, chunk, 0) of the fill also writes the chunk's counters,
// terms and mass. No atomics; every value is written by one thread.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "rank_common.cuh"

namespace {

using namespace mr_rank;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kWarps;      // suspect rows a fill block holds (a warp each)
constexpr int kWarpJ = 32;         // J up to this: the warp-select
constexpr int kTileMin = 256;      // columns a tile, at least (ops/explain.py TILE_MIN)
constexpr int kTileMax = 4096;     // the bitonic path's tile for J up to 2,048
constexpr uint64_t kNone = ~0ull;  // a slot past the padded columns
static_assert(kTileMin % kThreads == 0, "a tile is whole passes of the block");

// The routes (ops/explain.py ROUTES).
enum Route { kBitmap = 0, kEll = 1, kOpMajor = 2, kTraceMajor = 3 };

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
  const int32_t* inc_op;         // [E] (kTraceMajor)
  const int32_t* inc_trace;      // [E] (kTraceMajor)
  const float* sr_val;           // [E] (kTraceMajor)
  const int32_t* n_inc;          // 0-d (kTraceMajor)
  int64_t row_bytes;
  int32_t width;
  int32_t t;                     // padded columns
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
  uint64_t* keys;                // [2, ke, lists, j] the tiles' candidates (lists > 1)
  int32_t route, v, ke, j, tile, lists;
  float eps;
};

struct MergeArgs {
  const uint64_t* in;            // [rows, lists_in, j]
  uint64_t* out;                 // [rows, groups, j] (groups > 1)
  int32_t* trace_idx;            // [rows, j] (groups == 1)
  float* trace_val;
  int32_t lists_in, groups, group, j, tile;
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

// The warp's 32 least of key_at(0 .. n), ascending across the lanes
// (kNone where fewer).
template <typename KeyAt>
__device__ __forceinline__ uint64_t warp_least(KeyAt key_at, int n) {
  const int lane = threadIdx.x & 31;
  uint64_t x = warp_sort(lane < n ? key_at(lane) : kNone);
  for (int base = 32; base < n; base += 32) {
    const int i = base + lane;
    uint64_t y = i < n ? key_at(i) : kNone;
    const uint64_t bound = __shfl_sync(0xffffffffu, x, 31);
    if (!__any_sync(0xffffffffu, y < bound)) continue;
    y = warp_sort(y);
    x = warp_merge(key_min(x, __shfl_sync(0xffffffffu, y, 31 - lane)));
  }
  return x;
}

// Sort keys[0, n) ascending (n a power of two) by the block; ends
// synchronized.
__device__ void bitonic_sort(uint64_t* keys, int n) {
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

// The first e in [lo, hi) with a[e] >= key (a ascending there).
__device__ __forceinline__ int64_t lower_bound(const int32_t* a, int64_t lo, int64_t hi,
                                               int64_t key) {
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (a[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Suspect i's counters, formula terms and mass (ops/epilogue.py
// `spectrum_counters` at one op, op for op).
__device__ void suspect_terms(const Args& a, int i) {
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
  a.counters[i] = ef;
  a.counters[ke + i] = nf;
  a.counters[2 * ke + i] = ep;
  a.counters[3 * ke + i] = np;
  for (int m = 0; m < kMethods; ++m) a.terms[m * ke + i] = formula(m, ef, nf, ep, np);
  a.mass[i] = nw;
  a.mass[ke + i] = aw;
}

// One tile of one partition's contribution rows for a chunk of
// suspects, built in shared memory from the route's view, then each
// row's J least keys: written as the tile's candidates, or decoded when
// the tile is the whole row.
template <bool kWarpSelect>
__global__ void __launch_bounds__(kThreads) explain_tiles(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int32_t ops[kRows];
  __shared__ int64_t bounds[2 * kRows];
  const int C = a.tile;
  float* tile = reinterpret_cast<float*>(smem);                              // [kRows, C]
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem + sizeof(float) * kRows * C);  // [C]
  const int p = blockIdx.z;
  const Part g = a.part[p];
  const int r0 = blockIdx.y * kRows;
  const int rows = min(kRows, a.ke - r0);
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * C;
  const int64_t t_pad = g.t;
  if (threadIdx.x < rows) {
    ops[threadIdx.x] = a.top_idx[r0 + threadIdx.x];
    if (blockIdx.x == 0 && p == 0) suspect_terms(a, r0 + threadIdx.x);
  }
  const int32_t n_cols = *g.n_cols;
  const int64_t n_live = n_cols < 0 ? *g.n_traces : n_cols;
  __syncthreads();

  if (a.route == kBitmap) {
    for (int jj = threadIdx.x; jj < C; jj += kThreads) {
      const int64_t col = c0 + jj;
      if (col >= t_pad) break;
      if (col >= n_live) {
        for (int r = 0; r < rows; ++r) tile[r * C + jj] = neg_inf();
        continue;
      }
      const float w = f_mul(g.rv[col], g.inv_tracelen[col]);
      const int shift = 7 - static_cast<int>(col & 7);
      for (int r = 0; r < rows; ++r) {
        const int bit = (g.cov_bits[ops[r] * g.row_bytes + (col >> 3)] >> shift) & 1;
        tile[r * C + jj] = f_mul(bit ? 1.0f : 0.0f, w);
      }
    }
  } else if (a.route == kEll) {
    // A column a group of `lanes` lanes (a power of two up to 32, so that
    // a group lies in one warp and C, a multiple of kThreads, is a
    // multiple of the groups), at least 4 cells a lane; every lane runs
    // the same iterations, so the shuffles see the whole warp.
    const int width = g.width;
    const int lanes = width >= 128 ? 32 : (width < 8 ? 1 : 1 << (31 - __clz(width / 4)));
    const int sub = threadIdx.x & (lanes - 1);
    for (int jj = threadIdx.x / lanes; jj < C; jj += kThreads / lanes) {
      const int64_t col = c0 + jj;
      const bool live = col < t_pad && col < n_live;
      uint32_t match = 0;
      if (live) {
        const int64_t cell = col * width;
        // Both loads before the test, so that unrolled cells overlap.
#pragma unroll 4
        for (int s = sub; s < width; s += lanes) {
          const float rs = g.ell_rs[cell + s];
          const int32_t op = g.ell_op[cell + s];
          if (rs > 0.0f) {
            for (int r = 0; r < rows; ++r) match |= (op == ops[r] ? 1u : 0u) << r;
          }
        }
      }
      for (int off = lanes >> 1; off > 0; off >>= 1) {
        match |= __shfl_xor_sync(0xffffffffu, match, off);
      }
      if (sub != 0 || col >= t_pad) continue;
      if (!live) {
        for (int r = 0; r < rows; ++r) tile[r * C + jj] = neg_inf();
        continue;
      }
      const float mult = n_cols < 0 ? 1.0f : static_cast<float>(g.kind[col]);
      const float w = f_div(f_mul(g.rv[col], mult), static_cast<float>(g.tracelen[col]));
      for (int r = 0; r < rows; ++r) {
        tile[r * C + jj] = f_mul((match >> r) & 1u ? 1.0f : 0.0f, w);
      }
    }
  } else {
    // The sparse routes: every live cell +0 (the scatter's zeros), dead
    // ones -inf, then each suspect's entries in the tile.
    for (int jj = threadIdx.x; jj < C; jj += kThreads) {
      const float z = c0 + jj < n_live ? 0.0f : neg_inf();
      for (int r = 0; r < rows; ++r) tile[r * C + jj] = z;
    }
    if (threadIdx.x < (a.route == kOpMajor ? rows : 1)) {
      int64_t lo, hi;
      const int32_t* col_of;
      if (a.route == kOpMajor) {
        const int o = ops[threadIdx.x];
        lo = g.indptr[o];
        hi = g.indptr[o + 1];
        col_of = g.trace_om;
      } else {
        lo = 0;
        hi = *g.n_inc;
        col_of = g.inc_trace;
      }
      lo = lower_bound(col_of, lo, hi, c0);
      bounds[2 * threadIdx.x] = lo;
      bounds[2 * threadIdx.x + 1] = lower_bound(col_of, lo, hi, c0 + C);
    }
    __syncthreads();
    if (a.route == kOpMajor) {
      for (int r = 0; r < rows; ++r) {
        const int64_t lo = bounds[2 * r], hi = bounds[2 * r + 1];
        for (int64_t e = lo + threadIdx.x; e < hi; e += kThreads) {
          const int32_t t = g.trace_om[e];
          // Past the live columns (masked), or not the first of its run.
          if (t >= n_live || (e > lo && g.trace_om[e - 1] == t)) continue;
          const float x = g.rv[t];
          float acc = f_add(0.0f, f_mul(g.val_om[e], x));
          for (int64_t e2 = e + 1; e2 < hi && g.trace_om[e2] == t; ++e2) {
            acc = f_add(acc, f_mul(g.val_om[e2], x));
          }
          tile[r * C + (t - c0)] = acc;
        }
      }
    } else {
      const int64_t lo = bounds[0], hi = bounds[1];
      const int32_t v = a.v;
      for (int64_t e = lo + threadIdx.x; e < hi; e += kThreads) {
        const int32_t op = min(max(g.inc_op[e], 0), v);
        int r = 0;
        while (r < rows && ops[r] != op) ++r;
        if (r == rows) continue;
        const int32_t t = g.inc_trace[e];
        if (t >= n_live
            || (e > lo && g.inc_trace[e - 1] == t && min(max(g.inc_op[e - 1], 0), v) == op)) {
          continue;
        }
        const float x = g.rv[t];
        float acc = f_add(0.0f, f_mul(g.sr_val[e], x));
        for (int64_t e2 = e + 1;
             e2 < hi && g.inc_trace[e2] == t && min(max(g.inc_op[e2], 0), v) == op; ++e2) {
          acc = f_add(acc, f_mul(g.sr_val[e2], x));
        }
        tile[r * C + (t - c0)] = acc;
      }
    }
  }
  __syncthreads();

  const int J = a.j;
  const bool final_list = a.lists == 1;
  const auto key_of = [&](int r, int i) -> uint64_t {
    const int64_t col = c0 + i;
    return col < t_pad ? sort_key(f_add(tile[r * C + i], 0.0f), static_cast<int>(col)) : kNone;
  };
  const auto emit = [&](int r, int jj, uint64_t key) {
    const int64_t row = static_cast<int64_t>(p) * a.ke + r0 + r;
    if (final_list) {
      write_final(a.trace_idx, a.trace_val, row * J + jj, key);
    } else {
      a.keys[(row * a.lists + blockIdx.x) * J + jj] = key;
    }
  };
  if constexpr (kWarpSelect) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp < rows) {
      const uint64_t x = warp_least([&](int i) { return key_of(warp, i); }, C);
      if (lane < J) emit(warp, lane, x);
    }
  } else {
    for (int r = 0; r < rows; ++r) {
      for (int i = threadIdx.x; i < C; i += kThreads) keys[i] = key_of(r, i);
      __syncthreads();
      bitonic_sort(keys, C);
      for (int jj = threadIdx.x; jj < J; jj += kThreads) emit(r, jj, keys[jj]);
      __syncthreads();
    }
  }
}

// The least J keys of each group of `group` candidate lists of a row
// (grid x the group, y the row), by the fill's selection; the last pass
// (one group) decodes them.
template <bool kWarpSelect>
__global__ void __launch_bounds__(kThreads) explain_merge(MergeArgs m) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t lists[kWarps][32];
  const int64_t row = blockIdx.y;
  const int first = blockIdx.x * m.group;
  const int count = min(m.group, m.lists_in - first);
  const int n = count * m.j;
  const uint64_t* src = m.in + (row * m.lists_in + first) * m.j;
  const auto emit = [&](int jj, uint64_t key) {
    if (m.groups == 1) {
      write_final(m.trace_idx, m.trace_val, row * m.j + jj, key);
    } else {
      m.out[(row * m.groups + blockIdx.x) * m.j + jj] = key;
    }
  };
  if constexpr (kWarpSelect) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int per = (n + kWarps - 1) / kWarps;
    const int lo = warp * per;
    const int len = max(0, min(per, n - lo));
    lists[warp][lane] = warp_least([&](int i) { return src[lo + i]; }, len);
    __syncthreads();
    if (warp == 0) {
      uint64_t x = lists[0][lane];
      for (int w = 1; w < kWarps; ++w) x = merge_lists(x, lists[w]);
      if (lane < m.j) emit(lane, x);
    }
  } else {
    uint64_t* keys = reinterpret_cast<uint64_t*>(smem);  // [tile]
    for (int i = threadIdx.x; i < m.tile; i += kThreads) keys[i] = i < n ? src[i] : kNone;
    __syncthreads();
    bitonic_sort(keys, m.tile);
    for (int jj = threadIdx.x; jj < m.j; jj += kThreads) emit(jj, keys[jj]);
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

cudaError_t allow_smem() {
  const int bytes = kRows * kTileMax * 4 + kTileMax * 8;
  cudaError_t e = cudaFuncSetAttribute(reinterpret_cast<const void*>(explain_tiles<true>),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(reinterpret_cast<const void*>(explain_tiles<false>),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  return e;
}

// The argument block of mr_explain_launch (int64 words; ops/explain.py
// ARGS packs it): for the normal then the abnormal partition the
// kPartWords fields of Part in its order (row_bytes, width and t as
// integers), then the fields below.
enum Word {
  kPartWords = 19,
  kTopIdx = 2 * kPartWords, kNWeight, kAWeight, kNPresent, kAPresent, kNCov, kACov,
  kCounters, kTerms, kMass, kTraceIdx, kTraceVal, kKeysA, kKeysB,
  kRoute, kV, kKe, kJ, kTile, kLists, kGroup, kEpsBits, kDevice, kStream,
  kWords
};

}  // namespace

extern "C" {

// The library's limits: out[0] kTileMin, out[1] kTileMax, out[2] kRows,
// out[3] kWarpJ, out[4] the words of an argument block, out[5] kThreads.
int mr_explain_config(int32_t* out) {
  out[0] = kTileMin;
  out[1] = kTileMax;
  out[2] = kRows;
  out[3] = kWarpJ;
  out[4] = kWords;
  out[5] = kThreads;
  return 0;
}

// K15 for one window, on the given stream: one launch of explain_tiles
// over lists tiles of `tile` columns, then explain_merge, each pass over
// groups of `group` lists, until one list a row is left (the plan of
// ops/explain.py `explain_plan`, checked here). Returns the CUDA error
// code of the launches (0 = launched); allocates nothing and does not
// synchronize.
int mr_explain_launch(const int64_t* w) {
  const auto ptr = [w](int i) { return reinterpret_cast<void*>(static_cast<uintptr_t>(w[i])); };
  const int64_t route = w[kRoute], v = w[kV], ke = w[kKe], j = w[kJ], tile = w[kTile];
  const int64_t lists = w[kLists], group = w[kGroup];
  const bool warp = j <= kWarpJ;
  const int64_t t_max = w[kPartWords - 1] > w[2 * kPartWords - 1] ? w[kPartWords - 1]
                                                                   : w[2 * kPartWords - 1];
  if (route < kBitmap || route > kTraceMajor || v < 1 || ke < 1 || j < 1 || tile < kTileMin
      || tile > kTileMax || (tile & (tile - 1)) != 0 || tile < 2 * j || group != tile / j
      || lists != (t_max + tile - 1) / tile
      || lists < 1 || lists > 65535 || (ke + kRows - 1) / kRows > 65535
      || (lists > 1 && ptr(kKeysA) == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
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
    g.width = static_cast<int32_t>(w[o + 17]);
    g.t = static_cast<int32_t>(w[o + 18]);
    const bool ok = g.rv != nullptr && g.n_cols != nullptr && g.n_traces != nullptr && g.t >= 1
        && (route != kBitmap || (g.cov_bits != nullptr && g.inv_tracelen != nullptr
                                 && g.row_bytes * 8 >= g.t))
        && (route != kEll || (g.ell_op != nullptr && g.ell_rs != nullptr && g.kind != nullptr
                              && g.tracelen != nullptr && g.width >= 0 && g.width <= 4096))
        && (route != kOpMajor || (g.indptr != nullptr && g.trace_om != nullptr
                                  && g.val_om != nullptr))
        && (route != kTraceMajor || (g.inc_op != nullptr && g.inc_trace != nullptr
                                     && g.sr_val != nullptr && g.n_inc != nullptr));
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
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
  a.tile = static_cast<int32_t>(tile);
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
  const size_t fill_smem = static_cast<size_t>(kRows * tile * 4 + (warp ? 0 : tile * 8));
  const dim3 fill_grid(static_cast<unsigned>(lists), static_cast<unsigned>((ke + kRows - 1) / kRows),
                       2);
  if (warp) {
    explain_tiles<true><<<fill_grid, kThreads, fill_smem, stream>>>(a);
  } else {
    explain_tiles<false><<<fill_grid, kThreads, fill_smem, stream>>>(a);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  MergeArgs m{};
  m.trace_idx = a.trace_idx;
  m.trace_val = a.trace_val;
  m.j = static_cast<int32_t>(j);
  m.tile = static_cast<int32_t>(tile);
  m.group = static_cast<int32_t>(group);
  uint64_t* src = a.keys;
  uint64_t* dst = static_cast<uint64_t*>(ptr(kKeysB));
  for (int64_t n = lists; n > 1;) {
    const int64_t groups = (n + group - 1) / group;
    if (groups > 1 && dst == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    m.in = src;
    m.out = dst;
    m.lists_in = static_cast<int32_t>(n);
    m.groups = static_cast<int32_t>(groups);
    const dim3 grid(static_cast<unsigned>(groups), static_cast<unsigned>(2 * ke));
    if (warp) {
      explain_merge<true><<<grid, kThreads, 0, stream>>>(m);
    } else {
      explain_merge<false><<<grid, kThreads, static_cast<size_t>(tile * 8), stream>>>(m);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    n = groups;
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
