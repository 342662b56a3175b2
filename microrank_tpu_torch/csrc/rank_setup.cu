// K6's set-up on Hopper: a rank program's preference and initial
// vectors, both partitions and every window of a stacked group, in one
// launch.
//
// Replaces what XLA compiles for the TPU in
// microrank_tpu/rank_backends/jax_tpu.py:44 `preference_vector` and the
// initial vectors of :285 `_partition_setup`. The port had issued it as
// about 20 small PyTorch ops a partition and two launches of the
// fixed-order fold (ops/setup.py `rank_setup_plain`, which these kernels
// repeat bit for bit). For partition p of window b, with n the live
// columns (n_cols when kind-collapsed, else n_traces):
//
//   live = i < n,  mult = collapsed ? kind : 1
//   inv_kind = live ? 1 / kind : 0,  inv_len = live ? 1 / tracelen : 0
//   kind_sum = tree(mult * inv_kind),  num_sum = tree(mult * inv_len)
//   normal:    pref = inv_kind / kind_sum
//   abnormal:  pref = phi / num_sum / (kind / kind_sum * phi + inv_len)
//              (paper: phi * inv_len / num_sum + (1 - phi) * inv_kind / kind_sum)
//   pref = live ? pref : 0
//   sv0 = op_present ? 1 / (n_ops + n_traces) : 0,  rv0 = live ? the same : 0
//
// `tree` is the pairwise tree of tree_fold.cuh over the live prefix, so
// a window's sums are its own program's at any pad. Each torch op is
// its own IEEE operation (__fdiv_rn, __fmul_rn, __fadd_rn): no FMA.
//
// What bounds it: bytes. kind and tracelen are read and pref and rv0
// written once (16 bytes a trace column), op_present read and sv0
// written once (5 bytes an op); a handful of flops an element. At the
// giant 10M-span window that is 2 x 2^21 columns, ~42 MB; at a config-5
// kind window a few KB, where a launch's latency is all there is.
//
// The sums need a row's whole live prefix before any pref can be
// written. The host plans one of three forms (ops/setup.py
// `setup_plan`; `mr_rank_setup_launch` checks the plan again):
// * rows (a row of at most kClusterMax tiles of kTile columns): a
//   cluster of C blocks of 1024 threads a (partition, window) row, C the
//   least power of two that holds the widest row's tiles. Each block
//   loads its tile's columns by 16-byte loads into registers (4 a
//   thread), folds the two terms to the tile's level-12 nodes, and
//   after one cluster barrier reads the row's nodes from its peers'
//   shared memory and folds them as the tree's upper levels; then it
//   writes its pref and rv0 from the values still in registers, and
//   its share of the row's sv0. No grid barrier, nothing re-read. A row
//   of one tile (every config-5 window) is a cluster of one: a plain
//   launch, a block a row.
// * grid (longer rows, the giant windows): one cooperative launch on a
//   grid sized by occupancy, a block of 1024 threads an SM, the tiles
//   dealt to the blocks in turn. Phase 1 folds each live tile to its
//   nodes (to `partial`) and holds its kind and tracelen in shared
//   memory, up to kHoldMax tiles a block, and writes the tiles past the
//   live prefix (zeros, whatever the sums); sv0 is written by the whole
//   grid. After the grid barrier each block folds a row's nodes once
//   (not once a tile) and writes its live tiles' pref and rv0 from the
//   held values, re-reading past them (from L2, where the window fits).
// * first: the first design, kept for comparison only: a cooperative
//   grid of 256-thread blocks, a work item a tile, the row's nodes
//   folded again for every tile and its columns read again after the
//   barrier.
// No atomics: every sum is the tree.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>

#include "tree_fold.cuh"

namespace cg = cooperative_groups;

namespace {

using mr_tree::kPerThread;
using mr_tree::kThreads;
using mr_tree::kTile;
using mr_tree::kWarps;

constexpr int kParts = 2;  // normal (no anomaly), abnormal (anomaly)
constexpr int kWide = mr_tree::kWideThreads;    // threads a block of the rows and grid forms
constexpr int kQuad = mr_tree::kWidePerThread;  // columns a thread of a tile
constexpr int kClusterMax = 8;                  // tiles a row of the rows form (portable clusters)
constexpr int kHoldMax = 6;                     // tiles a block of the grid form holds
constexpr int kHoldBytes = 2 * kTile * static_cast<int>(sizeof(float));  // kind, tracelen

// The forms of a launch (ops/setup.py FORMS).
enum Form { kFormRows = 0, kFormGrid = 1, kFormFirst = 2 };

// The phases a launch may stamp (block 0, thread 0): the rows form its
// start, its columns in registers, its tile's nodes, the row's sums,
// its writes; the grid form its start, its phase-1 tiles, its sv0, the
// grid barrier, its phase-2 tiles.
constexpr int kStamps = 5;

struct Part {
  const int32_t* kind;       // [B, t_pad]
  const int32_t* tracelen;   // [B, t_pad]
  const int32_t* n_cols;     // [B] (-1: not collapsed)
  const int32_t* n_traces;   // [B]
  const int32_t* n_ops;      // [B]
  const uint8_t* op_present; // [B, v] (bool)
  float* pref;               // [B, t_pad]
  float* rv0;                // [B, t_pad]
  float* sv0;                // [B, v]
  int32_t t_pad;
  int32_t tiles;             // ceil(t_pad / kTile)
  int32_t v;
  int32_t v_tiles;           // ceil(v / kTile)
  int32_t first_item;        // its first tree item (and its rows' first node pair)
};

struct SetupArgs {
  Part part[kParts];
  int32_t windows;
  float phi;
  int32_t paper;             // the preference form: 0 reference, 1 paper
  int32_t tree_items;        // sum over parts of windows * tiles
  int32_t items;             // tree_items + the sv0 items
  float* partial;            // [tree_items, 2]: each tile's two level-12 nodes
  int64_t* stamps;           // [kStamps] SM cycles of the rows form's phases, or null
};

struct Item {
  int p, b, j;  // partition, window, tile
};

// A partition's fields by a runtime index, as selects of the two (no
// copy of the kernel's parameters to local memory).
__device__ __forceinline__ Part part_of(const SetupArgs& a, int p) {
  return p == 0 ? a.part[0] : a.part[1];
}

__device__ __forceinline__ Item tree_item(const SetupArgs& a, int item) {
  const int p = item >= a.part[1].first_item ? 1 : 0;
  const int first = p ? a.part[1].first_item : a.part[0].first_item;
  const int tiles = p ? a.part[1].tiles : a.part[0].tiles;
  return {p, (item - first) / tiles, (item - first) % tiles};
}

__device__ __forceinline__ int live_columns(const Part& q, int b) {
  const int n_cols = __ldg(q.n_cols + b);
  const int n = n_cols >= 0 ? n_cols : __ldg(q.n_traces + b);
  return min(max(n, 0), q.t_pad);
}

// The first design (the cooperative grid described above), kept for
// comparison with the block-a-row, cluster and held-grid forms.
__global__ void __launch_bounds__(kThreads) setup_first(SetupArgs a) {
  __shared__ float stage_kind[kTile];
  __shared__ float stage_len[kTile];
  __shared__ float warp_sums[kWarps];
  __shared__ float sums[2];
  const int t = threadIdx.x;

  // Phase 1: each tile's two level-12 nodes; then sv0.
  for (int item = blockIdx.x; item < a.items; item += gridDim.x) {
    if (item < a.tree_items) {
      const Item it = tree_item(a, item);
      const Part q = part_of(a, it.p);
      const int n = live_columns(q, it.b);
      const int lo = it.j * kTile;
      const int count = min(kTile, n - lo);
      if (count <= 0) continue;  // past the live prefix: never read by the tree
      const bool collapsed = __ldg(q.n_cols + it.b) >= 0;
      const int64_t row = static_cast<int64_t>(it.b) * q.t_pad + lo;
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int at = i * kThreads + t;
        float term_kind = 0.0f, term_len = 0.0f;
        if (at < count) {
          const float kind = __int2float_rn(__ldg(q.kind + row + at));
          const float len = __int2float_rn(__ldg(q.tracelen + row + at));
          const float mult = collapsed ? kind : 1.0f;
          term_kind = __fmul_rn(mult, __fdiv_rn(1.0f, kind));
          term_len = __fmul_rn(mult, __fdiv_rn(1.0f, len));
        }
        stage_kind[at] = term_kind;
        stage_len[at] = term_len;
      }
      __syncthreads();
      const float kind_node = mr_tree::stage_tree(stage_kind, count, warp_sums);
      const float len_node = mr_tree::stage_tree(stage_len, count, warp_sums);
      if (t == 0) {
        a.partial[2 * static_cast<int64_t>(item)] = kind_node;
        a.partial[2 * static_cast<int64_t>(item) + 1] = len_node;
      }
    } else {
      const int r = item - a.tree_items;
      const int per_part = a.windows * a.part[0].v_tiles;
      const int p = r / per_part;
      const Part q = part_of(a, p);
      const int b = (r % per_part) / q.v_tiles;
      const int lo = (r % q.v_tiles) * kTile;
      const int count = min(kTile, q.v - lo);
      const float init =
          __fdiv_rn(1.0f, __int2float_rn(__ldg(q.n_ops + b) + __ldg(q.n_traces + b)));
      const int64_t row = static_cast<int64_t>(b) * q.v + lo;
      for (int at = t; at < count; at += kThreads) {
        q.sv0[row + at] = q.op_present[row + at] ? init : 0.0f;
      }
    }
  }

  cg::this_grid().sync();

  // Phase 2: the row's sums from its tile nodes, then the tile's pref
  // and rv0.
  for (int item = blockIdx.x; item < a.tree_items; item += gridDim.x) {
    const Item it = tree_item(a, item);
    const Part q = part_of(a, it.p);
    const int n = live_columns(q, it.b);
    const float* nodes = a.partial + 2 * static_cast<int64_t>(q.first_item + it.b * q.tiles);
    // The nodes of one sum lie every other float: gather each to the
    // stage (tile_tree reads a dense run).
    const int used = (n + kTile - 1) / kTile;
    for (int k = 0; k < 2; ++k) {
      float* stage = k == 0 ? stage_kind : stage_len;
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int at = i * kThreads + t;
        stage[at] = at < used ? __ldcg(nodes + 2 * at + k) : 0.0f;
      }
    }
    __syncthreads();
    const float kind_sum = mr_tree::stage_tree(stage_kind, used, warp_sums);
    const float num_sum = mr_tree::stage_tree(stage_len, used, warp_sums);
    if (t == 0) {
      sums[0] = kind_sum;
      sums[1] = num_sum;
    }
    __syncthreads();
    const float ksum = sums[0], nsum = sums[1];
    const bool anomaly = it.p == 1;
    const float init =
        __fdiv_rn(1.0f, __int2float_rn(__ldg(q.n_ops + it.b) + __ldg(q.n_traces + it.b)));
    const float phi_over_num = __fdiv_rn(a.phi, nsum);
    const float one_minus_phi = __fsub_rn(1.0f, a.phi);
    const int lo = it.j * kTile;
    const int count = min(kTile, q.t_pad - lo);
    const int64_t row = static_cast<int64_t>(it.b) * q.t_pad + lo;
    for (int at = t; at < count; at += kThreads) {
      float pref = 0.0f, rv = 0.0f;
      if (lo + at < n) {
        const float kind = __int2float_rn(__ldg(q.kind + row + at));
        const float len = __int2float_rn(__ldg(q.tracelen + row + at));
        const float inv_kind = __fdiv_rn(1.0f, kind);
        const float inv_len = __fdiv_rn(1.0f, len);
        if (!anomaly) {
          pref = __fdiv_rn(inv_kind, ksum);
        } else if (!a.paper) {
          pref = __fdiv_rn(phi_over_num,
                           __fadd_rn(__fmul_rn(__fdiv_rn(kind, ksum), a.phi), inv_len));
        } else {
          pref = __fadd_rn(__fdiv_rn(__fmul_rn(a.phi, inv_len), nsum),
                           __fdiv_rn(__fmul_rn(one_minus_phi, inv_kind), ksum));
        }
        rv = init;
      }
      q.pref[row + at] = pref;
      q.rv0[row + at] = rv;
    }
    __syncthreads();  // sums[] is rewritten by the block's next item
  }
}


// ---------------------------------------------------------------- rows, grid

// Thread t's columns [4t, 4t + 4) of a tile whose first column is at
// kind / len, as floats; count: the tile's live columns (none read past
// it). 16-byte loads where the columns are aligned and all live.
__device__ __forceinline__ void load_quad(const int32_t* kind, const int32_t* len, int count,
                                          float (&k)[kQuad], float (&l)[kQuad]) {
  const int base = kQuad * threadIdx.x;
  if (base + kQuad <= count && ((reinterpret_cast<uintptr_t>(kind + base)
                                 | reinterpret_cast<uintptr_t>(len + base)) & 15) == 0) {
    const int4 kv = __ldg(reinterpret_cast<const int4*>(kind + base));
    const int4 lv = __ldg(reinterpret_cast<const int4*>(len + base));
    k[0] = __int2float_rn(kv.x); k[1] = __int2float_rn(kv.y);
    k[2] = __int2float_rn(kv.z); k[3] = __int2float_rn(kv.w);
    l[0] = __int2float_rn(lv.x); l[1] = __int2float_rn(lv.y);
    l[2] = __int2float_rn(lv.z); l[3] = __int2float_rn(lv.w);
    return;
  }
#pragma unroll
  for (int i = 0; i < kQuad; ++i) {
    const bool live = base + i < count;
    k[i] = live ? __int2float_rn(__ldg(kind + base + i)) : 0.0f;
    l[i] = live ? __int2float_rn(__ldg(len + base + i)) : 0.0f;
  }
}

// The two sums' terms of thread t's live columns (0 past count).
__device__ __forceinline__ void quad_terms(const float (&k)[kQuad], const float (&l)[kQuad],
                                           int count, bool collapsed, float (&tk)[kQuad],
                                           float (&tl)[kQuad]) {
  const int base = kQuad * threadIdx.x;
#pragma unroll
  for (int i = 0; i < kQuad; ++i) {
    tk[i] = tl[i] = 0.0f;
    if (base + i < count) {
      const float mult = collapsed ? k[i] : 1.0f;
      tk[i] = __fmul_rn(mult, __fdiv_rn(1.0f, k[i]));
      tl[i] = __fmul_rn(mult, __fdiv_rn(1.0f, l[i]));
    }
  }
}

// A row's sums and the values every column of it reads.
struct RowSums {
  float ksum, nsum, init;
};

// The preference of a live column (the first design's phase 2, op for op).
__device__ __forceinline__ float pref_of(float kind, float len, bool anomaly, int paper,
                                         float phi, const RowSums& s) {
  const float inv_kind = __fdiv_rn(1.0f, kind);
  const float inv_len = __fdiv_rn(1.0f, len);
  if (!anomaly) return __fdiv_rn(inv_kind, s.ksum);
  if (!paper) {
    return __fdiv_rn(__fdiv_rn(phi, s.nsum),
                     __fadd_rn(__fmul_rn(__fdiv_rn(kind, s.ksum), phi), inv_len));
  }
  return __fadd_rn(__fdiv_rn(__fmul_rn(phi, inv_len), s.nsum),
                   __fdiv_rn(__fmul_rn(__fsub_rn(1.0f, phi), inv_kind), s.ksum));
}

// Thread t's columns [4t, 4t + 4) of a tile of `width` columns (within
// the pad), `count` of them live: pref and rv0, by one 16-byte store
// each where aligned.
__device__ __forceinline__ void write_quad(float* pref, float* rv, int width, int count,
                                           const float (&k)[kQuad], const float (&l)[kQuad],
                                           bool anomaly, int paper, float phi,
                                           const RowSums& s) {
  const int base = kQuad * threadIdx.x;
  float pv[kQuad], rvv[kQuad];
#pragma unroll
  for (int i = 0; i < kQuad; ++i) {
    const bool live = base + i < count;
    pv[i] = live ? pref_of(k[i], l[i], anomaly, paper, phi, s) : 0.0f;
    rvv[i] = live ? s.init : 0.0f;
  }
  if (base + kQuad <= width && ((reinterpret_cast<uintptr_t>(pref + base)
                                 | reinterpret_cast<uintptr_t>(rv + base)) & 15) == 0) {
    *reinterpret_cast<float4*>(pref + base) = make_float4(pv[0], pv[1], pv[2], pv[3]);
    *reinterpret_cast<float4*>(rv + base) = make_float4(rvv[0], rvv[1], rvv[2], rvv[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < kQuad; ++i) {
    if (base + i < width) {
      pref[base + i] = pv[i];
      rv[base + i] = rvv[i];
    }
  }
}

__device__ __forceinline__ float init_of(const Part& q, int b) {
  return __fdiv_rn(1.0f, __int2float_rn(__ldg(q.n_ops + b) + __ldg(q.n_traces + b)));
}

// The rows form: block r of cluster `row` (row = p * windows + b) the
// tile r of that row. kClustered: the row's tiles exchange their nodes
// through distributed shared memory; else a block is the row's only
// tile (cluster == 1).
__device__ __forceinline__ void stamp(int64_t* stamps, int phase) {
  if (stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) stamps[phase] = clock64();
}

template <bool kClustered>
__global__ void __launch_bounds__(kWide, 1) setup_rows(SetupArgs a, int cluster) {
  __shared__ float warp_sums[2 * mr_tree::kWideWarps];
  __shared__ float nodes[2];  // this block's tile nodes: kind, len
  __shared__ float sums[2];
  constexpr int kOpsAhead = 4;  // ops a thread loads before the tree
  const int t = threadIdx.x;
  stamp(a.stamps, 0);
  const int row = blockIdx.x / cluster, r = blockIdx.x % cluster;
  const int p = row >= a.windows ? 1 : 0;
  const int b = row - p * a.windows;
  const Part q = part_of(a, p);
  // Every load the block needs is issued before any is used: the row's
  // counts, its tile's columns up to the pad (the live ones are their
  // prefix) and the thread's first ops.
  const int n_cols = __ldg(q.n_cols + b), n_traces = __ldg(q.n_traces + b);
  const int n_ops = __ldg(q.n_ops + b);
  const int lo = r * kTile;
  const int width = min(kTile, q.t_pad - lo);
  const int64_t at = static_cast<int64_t>(b) * q.t_pad + lo;
  float k[kQuad], l[kQuad], tk[kQuad], tl[kQuad];
  load_quad(q.kind + at, q.tracelen + at, width, k, l);
  const int64_t ops = static_cast<int64_t>(b) * q.v;
  const int op_step = cluster * kWide;
  bool present[kOpsAhead];
#pragma unroll
  for (int j = 0; j < kOpsAhead; ++j) {
    const int i = r * kWide + t + j * op_step;
    present[j] = i < q.v && q.op_present[ops + i];
  }
  const int n = min(max(n_cols >= 0 ? n_cols : n_traces, 0), q.t_pad);
  const int count = min(kTile, n - lo);
  quad_terms(k, l, count, n_cols >= 0, tk, tl);
  stamp(a.stamps, 1);
  float node_k = 0.0f, node_l = 0.0f;
  mr_tree::wide_tree2(tk, tl, count, warp_sums, node_k, node_l);
  stamp(a.stamps, 2);
  if constexpr (kClustered) {
    cg::cluster_group cl = cg::this_cluster();
    if (t == 0) {
      nodes[0] = node_k;
      nodes[1] = node_l;
    }
    cl.sync();
    if (t < 32) {
      // The row's tile nodes, one a lane (used <= the row's tiles <=
      // cluster), folded as the tree's upper levels.
      const int used = (n + kTile - 1) / kTile;
      float xk = 0.0f, xl = 0.0f;
      if (t < used) {
        const float* peer = cl.map_shared_rank(nodes, t);
        xk = peer[0];
        xl = peer[1];
      }
      xk = mr_tree::warp_tree(xk, used, 1);
      xl = mr_tree::warp_tree(xl, used, 1);
      if (t == 0) {
        sums[0] = xk;
        sums[1] = xl;
      }
    }
    cl.sync();  // every peer's nodes read before any block leaves; sums seen
  } else {
    if (t == 0) {  // one tile: its nodes are the row's sums
      sums[0] = node_k;
      sums[1] = node_l;
    }
    __syncthreads();
  }
  stamp(a.stamps, 3);
  const RowSums s{sums[0], sums[1], __fdiv_rn(1.0f, __int2float_rn(n_ops + n_traces))};
  if (width > 0) {
    write_quad(q.pref + at, q.rv0 + at, width, count, k, l, p == 1, a.paper, a.phi, s);
  }
#pragma unroll
  for (int j = 0; j < kOpsAhead; ++j) {
    const int i = r * kWide + t + j * op_step;
    if (i < q.v) q.sv0[ops + i] = present[j] ? s.init : 0.0f;
  }
  for (int i = r * kWide + t + kOpsAhead * op_step; i < q.v; i += op_step) {
    q.sv0[ops + i] = q.op_present[ops + i] ? s.init : 0.0f;
  }
  stamp(a.stamps, 4);
}

// The grid form: tiles dealt to the blocks in turn (block g the items
// g, g + grid, ...), the live ones' columns held in dynamic shared
// memory ([hold][2][kTile] floats) across the grid barrier.
__global__ void __launch_bounds__(kWide, 1) setup_grid(SetupArgs a, int hold) {
  extern __shared__ float4 held_words[];
  float* held = reinterpret_cast<float*>(held_words);
  __shared__ float warp_sums[2 * mr_tree::kWideWarps];
  __shared__ float sums[2];
  const int t = threadIdx.x;
  const int base = kQuad * t;
  stamp(a.stamps, 0);

  // Phase 1: each live tile's two level-12 nodes; its columns held.
  int n_held = 0;
  for (int item = blockIdx.x; item < a.tree_items; item += gridDim.x) {
    const Item it = tree_item(a, item);
    const Part q = part_of(a, it.p);
    const int lo = it.j * kTile;
    const int count = min(kTile, live_columns(q, it.b) - lo);
    const int64_t at = static_cast<int64_t>(it.b) * q.t_pad + lo;
    float k[kQuad], l[kQuad], tk[kQuad], tl[kQuad];
    if (count <= 0) {
      // Past the live prefix: never read by the tree, and its pref and
      // rv0 are 0 whatever the sums, so they are written now.
      write_quad(q.pref + at, q.rv0 + at, min(kTile, q.t_pad - lo), 0, k, l, false, 0, 0.0f,
                 RowSums{1.0f, 1.0f, 0.0f});
      continue;
    }
    load_quad(q.kind + at, q.tracelen + at, count, k, l);
    if (n_held < hold) {
      float* h = held + static_cast<int64_t>(n_held) * 2 * kTile;
      *reinterpret_cast<float4*>(h + base) = make_float4(k[0], k[1], k[2], k[3]);
      *reinterpret_cast<float4*>(h + kTile + base) = make_float4(l[0], l[1], l[2], l[3]);
    }
    ++n_held;
    quad_terms(k, l, count, __ldg(q.n_cols + it.b) >= 0, tk, tl);
    float node_k = 0.0f, node_l = 0.0f;
    mr_tree::wide_tree2(tk, tl, count, warp_sums, node_k, node_l);
    if (t == 0) {
      a.partial[2 * static_cast<int64_t>(item)] = node_k;
      a.partial[2 * static_cast<int64_t>(item) + 1] = node_l;
    }
  }
  stamp(a.stamps, 1);
  // sv0 of every (partition, window), spread over the whole grid.
  for (int p = 0; p < kParts; ++p) {
    const Part q = part_of(a, p);
    const int64_t total = static_cast<int64_t>(a.windows) * q.v;
    for (int64_t e = static_cast<int64_t>(blockIdx.x) * kWide + t; e < total;
         e += static_cast<int64_t>(gridDim.x) * kWide) {
      q.sv0[e] = q.op_present[e] ? init_of(q, static_cast<int>(e / q.v)) : 0.0f;
    }
  }

  stamp(a.stamps, 2);
  cg::this_grid().sync();
  stamp(a.stamps, 3);

  // Phase 2: a row's sums from its tile nodes (once a row a block), then
  // each live tile's pref and rv0 from the held columns.
  int last_row = -1;
  RowSums s{0.0f, 0.0f, 0.0f};
  n_held = 0;
  for (int item = blockIdx.x; item < a.tree_items; item += gridDim.x) {
    const Item it = tree_item(a, item);
    const Part q = part_of(a, it.p);
    const int n = live_columns(q, it.b);
    const int lo = it.j * kTile;
    const int count = min(kTile, n - lo);
    if (count <= 0) continue;  // written in phase 1
    const int row = it.p * a.windows + it.b;
    if (row != last_row) {
      last_row = row;
      const int used = (n + kTile - 1) / kTile;  // <= kMaxTiles = kTile nodes
      const float* nodes = a.partial + 2 * static_cast<int64_t>(q.first_item + it.b * q.tiles);
      float xk[kQuad], xl[kQuad];
#pragma unroll
      for (int i = 0; i < kQuad; ++i) {
        const bool in = base + i < used;
        xk[i] = in ? __ldcg(nodes + 2 * (base + i)) : 0.0f;
        xl[i] = in ? __ldcg(nodes + 2 * (base + i) + 1) : 0.0f;
      }
      float sk = 0.0f, sl = 0.0f;
      mr_tree::wide_tree2(xk, xl, used, warp_sums, sk, sl);
      if (t == 0) {
        sums[0] = sk;
        sums[1] = sl;
      }
      __syncthreads();
      s = RowSums{sums[0], sums[1], init_of(q, it.b)};
    }
    const int64_t at = static_cast<int64_t>(it.b) * q.t_pad + lo;
    float k[kQuad], l[kQuad];
    if (n_held < hold) {
      const float* h = held + static_cast<int64_t>(n_held) * 2 * kTile;
      const float4 kv = *reinterpret_cast<const float4*>(h + base);
      const float4 lv = *reinterpret_cast<const float4*>(h + kTile + base);
      k[0] = kv.x; k[1] = kv.y; k[2] = kv.z; k[3] = kv.w;
      l[0] = lv.x; l[1] = lv.y; l[2] = lv.z; l[3] = lv.w;
    } else {
      load_quad(q.kind + at, q.tracelen + at, count, k, l);
    }
    ++n_held;
    write_quad(q.pref + at, q.rv0 + at, min(kTile, q.t_pad - lo), count, k, l, it.p == 1,
               a.paper, a.phi, s);
  }
  stamp(a.stamps, 4);
}

// This library links its own CUDA runtime, whose current device is not
// PyTorch's: make it `device` (a no-op after the first call).
cudaError_t use_device(int device) {
  int current = -1;
  const cudaError_t got = cudaGetDevice(&current);
  if (got == cudaSuccess && current == device) return cudaSuccess;
  return cudaSetDevice(device);
}

// The grid form's dynamic shared memory, up to kHoldMax held tiles.
cudaError_t allow_held() {
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(setup_grid),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kHoldMax * kHoldBytes);
}

cudaError_t launch_cooperative(const void* fn, int grid, int threads, SetupArgs& a, void* extra,
                               size_t smem, cudaStream_t stream) {
  void* params[] = {&a, extra};
  return cudaLaunchCooperativeKernel(fn, dim3(static_cast<unsigned>(grid)), dim3(threads),
                                     params, smem, stream);
}

// The argument block of mr_rank_setup_launch (int64 words; ops/setup.py
// ARGS packs it): for the normal then the abnormal partition, kind,
// tracelen, n_cols, n_traces, n_ops, op_present, pref, rv0, sv0 and its
// trace pad; then the fields below (stamps: kStamps int64 for the rows
// form's phase cycles, or null).
enum Word {
  kPartWords = 10,
  kWindows = kParts * kPartWords, kV, kPhiBits, kPaper, kForm, kCluster, kGrid, kHold,
  kPartial, kStampsAt, kDevice, kStream, kWords
};

}  // namespace

extern "C" {

// What the set-up kernels get on `device`: out[0] 1 if the device takes
// a cooperative launch, out[1] the SM count, out[2] the first design's
// resident blocks an SM, out[3] the grid form's (its shared memory for
// kHoldMax tiles), out[4] kTile, out[5] kHoldMax, out[6] kClusterMax,
// out[7] the words of an argument block, out[8] kStamps. Returns the
// CUDA error code of the queries.
int mr_rank_setup_config(int device, int32_t* out) {
  cudaError_t e = use_device(device);
  int coop = 0, sms = 0, first_per_sm = 0, grid_per_sm = 0;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &first_per_sm, reinterpret_cast<const void*>(setup_first), kThreads, 0);
  }
  if (e == cudaSuccess) e = allow_held();
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &grid_per_sm, reinterpret_cast<const void*>(setup_grid), kWide, kHoldMax * kHoldBytes);
  }
  out[0] = coop;
  out[1] = sms;
  out[2] = e == cudaSuccess ? first_per_sm : 0;
  out[3] = e == cudaSuccess ? grid_per_sm : 0;
  out[4] = kTile;
  out[5] = kHoldMax;
  out[6] = kClusterMax;
  out[7] = kWords;
  out[8] = kStamps;
  return static_cast<int>(e);
}

// One launch of the set-up for both partitions of `windows` windows, in
// the form the host planned (ops/setup.py `setup_plan`), checked here
// again, on the block's stream. `partial` holds 2 floats a tile of each
// (partition, window) row (the grid and first forms). Returns the CUDA
// error code of the launch (0 = launched); allocates nothing and does
// not synchronize.
int mr_rank_setup_launch(const int64_t* w) {
  const auto ptr = [w](int i) { return reinterpret_cast<void*>(static_cast<uintptr_t>(w[i])); };
  const int64_t windows = w[kWindows], v = w[kV];
  if (windows < 1 || windows > INT_MAX / (2 * kClusterMax) || v < 0 || v > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SetupArgs a{};
  int64_t item = 0;
  int most_tiles = 0;
  for (int p = 0; p < kParts; ++p) {
    const int o = kPartWords * p;
    Part& part = a.part[p];
    part.kind = static_cast<const int32_t*>(ptr(o + 0));
    part.tracelen = static_cast<const int32_t*>(ptr(o + 1));
    part.n_cols = static_cast<const int32_t*>(ptr(o + 2));
    part.n_traces = static_cast<const int32_t*>(ptr(o + 3));
    part.n_ops = static_cast<const int32_t*>(ptr(o + 4));
    part.op_present = static_cast<const uint8_t*>(ptr(o + 5));
    part.pref = static_cast<float*>(ptr(o + 6));
    part.rv0 = static_cast<float*>(ptr(o + 7));
    part.sv0 = static_cast<float*>(ptr(o + 8));
    const int64_t t_pad = w[o + 9];
    if (t_pad < 0 || t_pad > static_cast<int64_t>(kTile) * mr_tree::kMaxTiles) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    part.t_pad = static_cast<int32_t>(t_pad);
    part.tiles = static_cast<int32_t>((t_pad + kTile - 1) / kTile);
    most_tiles = part.tiles > most_tiles ? part.tiles : most_tiles;
    part.v = static_cast<int32_t>(v);
    part.v_tiles = static_cast<int32_t>((v + kTile - 1) / kTile);
    part.first_item = static_cast<int32_t>(item);
    item += windows * part.tiles;
  }
  const int64_t sv_items = static_cast<int64_t>(kParts) * windows * a.part[0].v_tiles;
  if (item + sv_items > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  a.windows = static_cast<int32_t>(windows);
  const uint32_t phi_bits = static_cast<uint32_t>(w[kPhiBits]);
  std::memcpy(&a.phi, &phi_bits, sizeof(a.phi));
  a.paper = static_cast<int32_t>(w[kPaper]);
  a.tree_items = static_cast<int32_t>(item);
  a.items = static_cast<int32_t>(item + sv_items);
  a.partial = static_cast<float*>(ptr(kPartial));
  a.stamps = static_cast<int64_t*>(ptr(kStampsAt));
  const int64_t form = w[kForm], cluster = w[kCluster], grid = w[kGrid], hold = w[kHold];
  const auto stream = static_cast<cudaStream_t>(ptr(kStream));
  const cudaError_t set = use_device(static_cast<int>(w[kDevice]));
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaError_t launched = cudaSuccess;
  if (form == kFormRows) {
    // A block a tile of every row: the least power of two that holds the
    // widest row, at most kClusterMax.
    int want = 1;
    while (want < most_tiles) want *= 2;
    if (most_tiles > kClusterMax || cluster != want || grid != 2 * windows * cluster) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (cluster == 1) {
      setup_rows<false><<<static_cast<unsigned>(grid), kWide, 0, stream>>>(a, 1);
    } else {
      cudaLaunchConfig_t config{};
      config.gridDim = dim3(static_cast<unsigned>(grid));
      config.blockDim = dim3(kWide);
      config.stream = stream;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      config.attrs = attr;
      config.numAttrs = 1;
      launched = cudaLaunchKernelEx(&config, setup_rows<true>, a, static_cast<int>(cluster));
    }
  } else if (form == kFormGrid) {
    if (most_tiles <= kClusterMax || grid < 1 || grid > a.tree_items || hold < 0
        || hold > kHoldMax || a.partial == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    launched = allow_held();
    int held = static_cast<int>(hold);
    if (launched == cudaSuccess) {
      launched = launch_cooperative(reinterpret_cast<const void*>(setup_grid),
                                    static_cast<int>(grid), kWide, a, &held,
                                    static_cast<size_t>(held) * kHoldBytes, stream);
    }
  } else if (form == kFormFirst) {
    if (a.items == 0) return 0;
    if (grid < 1 || grid > a.items || (a.tree_items > 0 && a.partial == nullptr)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    void* params[] = {&a};
    launched = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(setup_first),
                                           dim3(static_cast<unsigned>(grid)), dim3(kThreads),
                                           params, 0, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (launched != cudaSuccess) {
    cudaGetLastError();  // clear the refusal; it is reported here
    return static_cast<int>(launched);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* mr_rank_setup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
