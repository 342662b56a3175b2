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
// kind window a few KB, where a launch's latency is all there is. K19's
// instances read the four init vectors once more (4 bytes a column and
// an op), the int8 instances the two weight vectors (4 bytes each) and
// write 16 bytes of scales a window.
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
//
// K19, the warm start (microrank_tpu/rank_backends/jax_tpu.py:1151
// `_warm_override`, reached by `rank_window_warm_core` :1578): the
// rows and grid forms' kWarm instances also take a mapped init (sv and
// rv of each partition, one window) and write it in place of the cold
// sv0 / rv0, per partition and side, when the side's masked init (sv on
// the present ops, rv on the live columns) has a maximum > 0; else the
// cold vector. And the first step's int8 scales (`quantize_i8` :96, as
// the int8 `cov_pair` :544 quantizes the start vectors): the kScales
// instances take the pattern group's weights and write, per partition,
// the scale of the fwd operand rv0 * w_len and of the bwd operand
// sv0 * w_cov, each over the whole pad (pattern_pair.cu
// `quantize_amax`'s function, which then need not launch).
//
// Both reduce a row to a few order keys, folded by integer max, which is
// exact and order-free (`Key`): a side's choice key (the max of its
// masked init in float order, NaN above all: JAX's max, whose NaN fails
// > 0, as does a subnormal max on XLA's CPU), and each operand's amax
// key (the bits of |x * w| with a subnormal product flushed:
// quantize_amax's), for the cold and, before the choice is known, the
// warm candidate. Every init value, weight and flag is read once, into
// registers beside the columns. The rows form reads a thread's ops as
// one quad (4 ops a load: the op loads, not the bytes, set its latency),
// folds its keys in the tree's own barriers (`wide_tree2_keyed`), a
// cluster's through distributed shared memory, and writes from the held
// values. The grid form keeps each warp's running maxima of a row in
// shared memory and writes each block's before the grid barrier
// (`flush_keys`: one word a block, row and key); it writes the warm
// candidates of rv0 and sv0 before the barrier (rv_init read beside its
// tile's kind and tracelen and written out at once: the output holds it
// across the barrier, so the held tiles keep their budget), the sv pass
// a chunk of a row's ops a block from the grid's last blocks (the fewest
// tiles); after it a quarter of each block folds a (partition, side)
// choice, a side that starts cold rewrites its cold vector, and the
// last block folds the scales after its phase 2. Where the live
// columns run out, nothing is folded. No scratch is left to reset. The
// cold instances without scales are the code they were. At 64
// registers a thread (1,024 threads) the grid form's keyed instances
// keep no key, flag or choice in registers across a phase: the warps'
// slots, the present flags and the choice are in shared memory.
//
// K19's first design, the flag design (`setup_rows_flags`,
// `setup_grid_flags`), is kept for comparison only: two flag bits a row
// ORed by __syncthreads_or, the ops' init read before the tree and again
// when written, and in the grid form a flag word a tile and two a block,
// rv_init read again after the barrier and sv0 in a pass of its own.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cfloat>
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
  const float* sv_init;      // [v] K19's mapped init (kWarm instances), else null
  const float* rv_init;      // [t_pad]
  const float* w_len;        // [B, t_pad] the int8 fwd operand's weight (kScales), else null
  const float* w_cov;        // [B, v] the bwd operand's
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
  int32_t* flags;            // the flag design's grid words: one a tree item, then 2 a block
  uint32_t* keys;            // the grid form's keyed words: [2 * windows][kKeys][grid]
  float* scales;             // [windows, 2 * kParts] the first step's int8 scales (kScales)
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
template <bool kWarm = false>
__device__ __forceinline__ void write_quad(float* pref, float* rv, int width, int count,
                                           const float (&k)[kQuad], const float (&l)[kQuad],
                                           bool anomaly, int paper, float phi,
                                           const RowSums& s, const float* rv_init = nullptr) {
  const int base = kQuad * threadIdx.x;
  float pv[kQuad], rvv[kQuad];
#pragma unroll
  for (int i = 0; i < kQuad; ++i) {
    const bool live = base + i < count;
    pv[i] = live ? pref_of(k[i], l[i], anomaly, paper, phi, s) : 0.0f;
    if constexpr (kWarm) {
      rvv[i] = live ? (rv_init != nullptr ? __ldg(rv_init + base + i) : s.init) : 0.0f;
    } else {
      rvv[i] = live ? s.init : 0.0f;
    }
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

__device__ __forceinline__ void stamp(int64_t* stamps, int phase) {
  if (stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) stamps[phase] = clock64();
}

// ------------------------------------------------------------ the keyed rows

// The order keys a keyed instance folds a row to (rv-side keys even,
// sv-side odd): each side's choice key (kWarm), the fwd and bwd
// operands' amax keys of the cold start (kScales) and of the warm
// candidate (both).
enum Key { kKeyRv, kKeySv, kKeyFwdCold, kKeyBwdCold, kKeyFwdWarm, kKeyBwdWarm, kKeys };

// Whether an instance folds key k.
template <bool kWarm, bool kScales>
__host__ __device__ constexpr bool key_used(int k) {
  return k < kKeyFwdCold ? kWarm : (k < kKeyFwdWarm ? kScales : kWarm && kScales);
}

// A float's order key: the unsigned order of keys is the float order,
// NaN above every number (JAX's max is NaN where a value is).
__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t u = __float_as_uint(x);
  return x != x ? 0xffffffffu : ((u & 0x80000000u) ? ~u : (u | 0x80000000u));
}

// A side starts warm when the max of its masked init (an order key; 0
// where nothing is live) is > 0 as XLA's CPU compares it, a subnormal
// max as 0: at least FLT_MIN (key 0x80800000), which a NaN max fails.
__device__ __forceinline__ bool warm_key(uint32_t key) {
  return key >= 0x80800000u && key != 0xffffffffu;
}

// An int8 operand's amax key (pattern_pair.cu quantize_amax): the bits
// of |x * w| with a subnormal product flushed to 0; non-negative floats
// order as their bits, and a NaN's exceed +inf's.
__device__ __forceinline__ uint32_t amax_key(float x, float w) {
  const float p = fabsf(__fmul_rn(x, w));
  return __float_as_uint(p < FLT_MIN ? 0.0f : p);
}

// JAX's `quantize_i8` scale of an amax key: amax / 127 (flushed when
// subnormal, as XLA's CPU) where amax > 0, else 1 (all zeros, or NaN).
__device__ __forceinline__ float scale_of(uint32_t key) {
  const float amax = __uint_as_float(key);
  if (!(amax > 0.0f)) return 1.0f;
  const float s = __fdiv_rn(amax, 127.0f);
  return fabsf(s) < FLT_MIN ? 0.0f : s;
}

// One trace column's keys: live or padding (within the width), its
// init value (masked off past the live columns) and fwd weight.
template <bool kWarm, bool kScales>
__device__ __forceinline__ void col_keys(bool live, float rv, float w, float init,
                                         uint32_t (&key)[kKeys]) {
  if constexpr (kWarm) {
    if (live) key[kKeyRv] = max(key[kKeyRv], order_key(rv));
  }
  if constexpr (kScales) {
    key[kKeyFwdCold] = max(key[kKeyFwdCold], amax_key(live ? init : 0.0f, w));
    if constexpr (kWarm) key[kKeyFwdWarm] = max(key[kKeyFwdWarm], amax_key(live ? rv : 0.0f, w));
  }
}

// One op's keys: present or not, its init value and bwd weight.
template <bool kWarm, bool kScales>
__device__ __forceinline__ void op_keys(bool present, float sv, float w, float init,
                                        uint32_t (&key)[kKeys]) {
  if constexpr (kWarm) {
    if (present) key[kKeySv] = max(key[kKeySv], order_key(sv));
  }
  if constexpr (kScales) {
    key[kKeyBwdCold] = max(key[kKeyBwdCold], amax_key(present ? init : 0.0f, w));
    if constexpr (kWarm) key[kKeyBwdWarm] = max(key[kKeyBwdWarm], amax_key(present ? sv : 0.0f, w));
  }
}

// Four floats x[0, 4), the first n of them (0 past n, none read there):
// one 16-byte load where aligned and all four are in.
__device__ __forceinline__ void load_four(const float* x, int n, float (&v)[kQuad]) {
  if (n >= kQuad && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(x));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < kQuad; ++i) v[i] = i < n ? __ldg(x + i) : 0.0f;
}

// Four flags of a bool row at x, the first n of them (false past n): one
// 4-byte load where aligned and all four are in.
__device__ __forceinline__ void load_four_flags(const uint8_t* x, int n, bool (&f)[kQuad]) {
  if (n >= kQuad && (reinterpret_cast<uintptr_t>(x) & 3) == 0) {
    const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(x));
#pragma unroll
    for (int i = 0; i < kQuad; ++i) f[i] = ((w >> (8 * i)) & 0xffu) != 0;
    return;
  }
#pragma unroll
  for (int i = 0; i < kQuad; ++i) f[i] = i < n && x[i] != 0;
}

// Four floats to x[0, min(n, 4)): one 16-byte store where aligned and all
// four are in.
__device__ __forceinline__ void store_four(float* x, int n, const float (&v)[kQuad]) {
  if (n >= kQuad && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    *reinterpret_cast<float4*>(x) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < kQuad; ++i) {
    if (i < n) x[i] = v[i];
  }
}

// Thread t's floats [4t, 4t + 4) of a row at x, the first `count` of the
// row's (0 past count, none read there).
__device__ __forceinline__ void load_floats(const float* x, int count, float (&v)[kQuad]) {
  const int base = kQuad * threadIdx.x;
  load_four(x + base, count - base, v);
}

// Thread t's floats [4t, 4t + 4) of a row at x, within `width`.
__device__ __forceinline__ void store_floats(float* x, int width, const float (&v)[kQuad]) {
  const int base = kQuad * threadIdx.x;
  store_four(x + base, width - base, v);
}

// Thread t's preferences of a tile (0 past its `count` live columns).
__device__ __forceinline__ void pref_quad(const float (&k)[kQuad], const float (&l)[kQuad],
                                          int count, bool anomaly, int paper, float phi,
                                          const RowSums& s, float (&pv)[kQuad]) {
  const int base = kQuad * threadIdx.x;
#pragma unroll
  for (int i = 0; i < kQuad; ++i) {
    pv[i] = base + i < count ? pref_of(k[i], l[i], anomaly, paper, phi, s) : 0.0f;
  }
}

// mr_tree::wide_tree2 with a keyed instance's block maximum of each of
// its keys, in the tree's two barriers: each warp's maximum stored with
// its nodes, warp 0 folding them with the upper levels. block_keys[k]
// holds the block's key k when it returns (every thread may read it).
template <bool kWarm, bool kScales>
__device__ __forceinline__ void wide_tree2_keyed(const float (&a)[kQuad], const float (&b)[kQuad],
                                                 int count, float* warp_sums, float& sum_a,
                                                 float& sum_b, const uint32_t (&key)[kKeys],
                                                 uint32_t* warp_keys, uint32_t* block_keys) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int in_warp = count - warp * mr_tree::kWarpSpan;
  const float node_a = mr_tree::warp_tree(mr_tree::quad_tree(a, count), in_warp, kQuad);
  const float node_b = mr_tree::warp_tree(mr_tree::quad_tree(b, count), in_warp, kQuad);
  uint32_t warp_key[kKeys];
#pragma unroll
  for (int k = 0; k < kKeys; ++k) {
    if (key_used<kWarm, kScales>(k)) warp_key[k] = __reduce_max_sync(0xffffffffu, key[k]);
  }
  if (lane == 0) {
    warp_sums[warp] = node_a;
    warp_sums[mr_tree::kWideWarps + warp] = node_b;
#pragma unroll
    for (int k = 0; k < kKeys; ++k) {
      if (key_used<kWarm, kScales>(k)) warp_keys[k * mr_tree::kWideWarps + warp] = warp_key[k];
    }
  }
  __syncthreads();
  if (warp == 0) {
    sum_a = mr_tree::warp_tree(warp_sums[lane], count, mr_tree::kWarpSpan);
    sum_b = mr_tree::warp_tree(warp_sums[mr_tree::kWideWarps + lane], count, mr_tree::kWarpSpan);
#pragma unroll
    for (int k = 0; k < kKeys; ++k) {
      if (!key_used<kWarm, kScales>(k)) continue;
      const uint32_t m = __reduce_max_sync(0xffffffffu, warp_keys[k * mr_tree::kWideWarps + lane]);
      if (lane == 0) block_keys[k] = m;
    }
  }
  __syncthreads();
}

// The rows form: block r of cluster `row` (row = p * windows + b) the
// tile r of that row. kClustered: the row's tiles exchange their nodes
// (and keys) through distributed shared memory; else a block is the
// row's only tile (cluster == 1). kWarm: K19's init in place of the
// cold start where its side's choice key says so; kScales: the first
// step's int8 scales of the row's partition and window.
template <bool kClustered, bool kWarm, bool kScales>
__global__ void __launch_bounds__(kWide, 1) setup_rows(SetupArgs a, int cluster) {
  constexpr bool kKeyed = kWarm || kScales;
  __shared__ float warp_sums[2 * mr_tree::kWideWarps];
  __shared__ float nodes[2];  // this block's tile nodes: kind, len
  __shared__ float sums[2];
  // kKeyed: the warps' keys; this block's keys, then (a cluster) the row's.
  __shared__ uint32_t warp_keys[kKeyed ? kKeys * mr_tree::kWideWarps : 1];
  __shared__ uint32_t keys[kKeyed ? 2 * kKeys : 1];
  constexpr int kOpsAhead = 4;  // ops a thread loads before the tree
  const int t = threadIdx.x;
  stamp(a.stamps, 0);
  const int row = blockIdx.x / cluster, r = blockIdx.x % cluster;
  const int p = row >= a.windows ? 1 : 0;
  const int b = row - p * a.windows;
  const Part q = part_of(a, p);
  // Every load the block needs is issued before any is used: the row's
  // counts, its tile's columns up to the pad (the live ones are their
  // prefix), the thread's first ops and, keyed, their init values and
  // weights.
  const int n_cols = __ldg(q.n_cols + b), n_traces = __ldg(q.n_traces + b);
  const int n_ops = __ldg(q.n_ops + b);
  const int lo = r * kTile;
  const int width = min(kTile, q.t_pad - lo);
  const int64_t at = static_cast<int64_t>(b) * q.t_pad + lo;
  float k[kQuad], l[kQuad], tk[kQuad], tl[kQuad];
  load_quad(q.kind + at, q.tracelen + at, width, k, l);
  float rv_in[kQuad] = {}, w_in[kQuad] = {};
  if constexpr (kWarm) load_floats(q.rv_init + at, width, rv_in);
  if constexpr (kScales) load_floats(q.w_len + at, width, w_in);
  const int64_t ops = static_cast<int64_t>(b) * q.v;
  const int op_step = cluster * kWide;
  // The thread's ops: the cold instance's, r * kWide + t + j * op_step
  // (j < kOpsAhead); a keyed one's, a quad [first, first + 4) and the
  // quads past it every kQuad * op_step (4 ops a load).
  const int first = kQuad * (r * kWide + t);
  bool present[kOpsAhead];
  float sv_in[kOpsAhead] = {}, wc_in[kOpsAhead] = {};
  if constexpr (kKeyed) {
    static_assert(kOpsAhead == kQuad, "a keyed thread holds one quad of ops");
    load_four_flags(q.op_present + ops + first, q.v - first, present);
    if constexpr (kWarm) load_four(q.sv_init + ops + first, q.v - first, sv_in);
    if constexpr (kScales) load_four(q.w_cov + ops + first, q.v - first, wc_in);
  } else {
#pragma unroll
    for (int j = 0; j < kOpsAhead; ++j) {
      const int i = r * kWide + t + j * op_step;
      present[j] = i < q.v && q.op_present[ops + i];
    }
  }
  const int n = min(max(n_cols >= 0 ? n_cols : n_traces, 0), q.t_pad);
  const int count = min(kTile, n - lo);
  const float init = __fdiv_rn(1.0f, __int2float_rn(n_ops + n_traces));
  uint32_t key[kKeys] = {};
  if constexpr (kKeyed) {
#pragma unroll
    for (int i = 0; i < kQuad; ++i) {
      const int c = kQuad * t + i;
      rv_in[i] = c < count ? rv_in[i] : 0.0f;  // the masked init
      if (c < width) col_keys<kWarm, kScales>(c < count, rv_in[i], w_in[i], init, key);
    }
#pragma unroll
    for (int j = 0; j < kQuad; ++j) {
      if (first + j < q.v) op_keys<kWarm, kScales>(present[j], sv_in[j], wc_in[j], init, key);
    }
    // Ops past the held quad (more than kQuad * cluster * kWide): read
    // here, and again when written.
    for (int i = first + kQuad * op_step; i < q.v; i += kQuad * op_step) {
      for (int j = i; j < min(i + kQuad, q.v); ++j) {
        op_keys<kWarm, kScales>(q.op_present[ops + j], kWarm ? __ldg(q.sv_init + ops + j) : 0.0f,
                                kScales ? __ldg(q.w_cov + ops + j) : 0.0f, init, key);
      }
    }
  }
  quad_terms(k, l, count, n_cols >= 0, tk, tl);
  stamp(a.stamps, 1);
  float node_k = 0.0f, node_l = 0.0f;
  if constexpr (kKeyed) {
    wide_tree2_keyed<kWarm, kScales>(tk, tl, count, warp_sums, node_k, node_l, key, warp_keys,
                                     keys);
  } else {
    mr_tree::wide_tree2(tk, tl, count, warp_sums, node_k, node_l);
  }
  stamp(a.stamps, 2);
  if constexpr (kClustered) {
    cg::cluster_group cl = cg::this_cluster();
    if (t == 0) {
      nodes[0] = node_k;
      nodes[1] = node_l;
    }
    cl.sync();
    if constexpr (kKeyed) {
      // Warp 1, a lane a key: the row's, from every block's.
      const int kk = t - 32;
      if (kk >= 0 && kk < kKeys && key_used<kWarm, kScales>(kk)) {
        uint32_t m = 0u;
        for (int c = 0; c < cluster; ++c) m = max(m, cl.map_shared_rank(keys, c)[kk]);
        keys[kKeys + kk] = m;
      }
    }
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
  const uint32_t* row_keys = keys + (kClustered ? kKeys : 0);
  const bool warm_rv = kWarm && warm_key(row_keys[kKeyRv]);
  const bool warm_sv = kWarm && warm_key(row_keys[kKeySv]);
  if constexpr (kScales) {
    if (r == 0 && t < 2) {  // the row's two operands: fwd (t 0), bwd (t 1)
      const bool warm = t == 0 ? warm_rv : warm_sv;
      a.scales[static_cast<int64_t>(b) * (2 * kParts) + 2 * p + t] =
          scale_of(row_keys[(warm ? kKeyFwdWarm : kKeyFwdCold) + t]);
    }
  }
  stamp(a.stamps, 3);
  const RowSums s{sums[0], sums[1], init};
  if (width > 0) {
    if constexpr (kWarm) {
      float pv[kQuad], rvv[kQuad];
      pref_quad(k, l, count, p == 1, a.paper, a.phi, s, pv);
#pragma unroll
      for (int i = 0; i < kQuad; ++i) {
        rvv[i] = kQuad * t + i < count ? (warm_rv ? rv_in[i] : init) : 0.0f;
      }
      store_floats(q.pref + at, width, pv);
      store_floats(q.rv0 + at, width, rvv);
    } else {
      write_quad(q.pref + at, q.rv0 + at, width, count, k, l, p == 1, a.paper, a.phi, s);
    }
  }
  if constexpr (kKeyed) {
    float svv[kQuad];
#pragma unroll
    for (int j = 0; j < kQuad; ++j) svv[j] = present[j] ? (warm_sv ? sv_in[j] : init) : 0.0f;
    if (first < q.v) store_four(q.sv0 + ops + first, q.v - first, svv);
    for (int i = first + kQuad * op_step; i < q.v; i += kQuad * op_step) {
      for (int j = i; j < min(i + kQuad, q.v); ++j) {
        q.sv0[ops + j] = q.op_present[ops + j]
                             ? (warm_sv ? __ldg(q.sv_init + ops + j) : init) : 0.0f;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kOpsAhead; ++j) {
      const int i = r * kWide + t + j * op_step;
      if (i < q.v) q.sv0[ops + i] = present[j] ? init : 0.0f;
    }
    for (int i = r * kWide + t + kOpsAhead * op_step; i < q.v; i += op_step) {
      q.sv0[ops + i] = q.op_present[ops + i] ? init : 0.0f;
    }
  }
  stamp(a.stamps, 4);
}

// ------------------------------------------------------------ the keyed grid

// The grid form keeps each warp's running maxima of the current row's
// keys in shared memory (warp_keys[k][warp], written by the warp's lane
// 0 alone), so no key is held in registers across a tile. This folds
// the warp's threads' keys of one side (kSide 0: the rv side's, 1: the
// sv side's) into its slots.
template <bool kWarm, bool kScales, int kSide>
__device__ __forceinline__ void warp_keys_max(const uint32_t (&key)[kKeys], uint32_t* warp_keys) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = kSide; k < kKeys; k += 2) {
    if (!key_used<kWarm, kScales>(k)) continue;
    const uint32_t m = __reduce_max_sync(0xffffffffu, key[k]);
    uint32_t* slot = warp_keys + k * mr_tree::kWideWarps + warp;
    if (lane == 0) *slot = max(*slot, m);
  }
}

// A block's maxima of one row's keys of one side, from its warps'
// slots, into the block's word of each (words [row][kKeys][grid]); the
// slots back to 0. Every thread of the block calls it.
template <bool kWarm, bool kScales, int kSide>
__device__ __forceinline__ void flush_keys(uint32_t* warp_keys, uint32_t* words, int row,
                                           int grid) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = kSide; k < kKeys; k += 2) {
      if (!key_used<kWarm, kScales>(k)) continue;
      uint32_t* slot = warp_keys + k * mr_tree::kWideWarps + lane;
      const uint32_t m = __reduce_max_sync(0xffffffffu, *slot);
      *slot = 0u;
      uint32_t* word = words + (static_cast<int64_t>(row) * kKeys + k) * grid + blockIdx.x;
      if (lane == 0) *word = max(*word, m);  // the block's own word: a row may flush twice
    }
  }
  __syncthreads();
}

// The max of a row's key over every block's word, by one warp (the
// result in every lane).
__device__ __forceinline__ uint32_t fold_words(const uint32_t* words, int row, int k, int grid) {
  const uint32_t* w = words + (static_cast<int64_t>(row) * kKeys + k) * grid;
  uint32_t m = 0u;
#pragma unroll 4
  for (int i = threadIdx.x & 31; i < grid; i += 32) m = max(m, __ldcg(w + i));
  return __reduce_max_sync(0xffffffffu, m);
}

// The grid form: tiles dealt to the blocks in turn (block g the items
// g, g + grid, ...), the live ones' columns held in dynamic shared
// memory ([hold][2][kTile] floats) across the grid barrier. kWarm and
// kScales as the rows form's.
template <bool kWarm, bool kScales>
__global__ void __launch_bounds__(kWide, 1) setup_grid(SetupArgs a, int hold) {
  constexpr bool kKeyed = kWarm || kScales;
  extern __shared__ float4 held_words[];
  float* held = reinterpret_cast<float*>(held_words);
  __shared__ float warp_sums[2 * mr_tree::kWideWarps];
  __shared__ float sums[2];
  __shared__ uint32_t warp_keys[kKeyed ? kKeys * mr_tree::kWideWarps : 1];
  __shared__ uint32_t choice[kWarm ? 2 * kParts : 1];  // each partition's rv and sv choice keys
  __shared__ uint32_t choice_warps[kWarm ? mr_tree::kWideWarps : 1];
  // kWarm: each thread's present flags of its first 32 op chunks.
  __shared__ uint32_t present_sh[kWarm ? kWide : 1];
  const int t = threadIdx.x;
  const int base = kQuad * t;
  const int grid = static_cast<int>(gridDim.x);
  const int warp = t >> 5, lane = t & 31;
  stamp(a.stamps, 0);
  if constexpr (kKeyed) {
    // This block's word of every row and key: 0 until a pass over the
    // row writes it; the warps' slots 0.
    for (int w = t; w < kParts * a.windows * kKeys; w += kWide) {
      a.keys[static_cast<int64_t>(w) * grid + blockIdx.x] = 0u;
    }
    if (t < kKeys * mr_tree::kWideWarps) warp_keys[t] = 0u;
    __syncthreads();
  }

  // Phase 1: each live tile's two level-12 nodes; its columns held.
  int n_held = 0, key_row = -1;
  for (int item = blockIdx.x; item < a.tree_items; item += grid) {
    const Item it = tree_item(a, item);
    const Part q = part_of(a, it.p);
    const int lo = it.j * kTile;
    const int width = min(kTile, q.t_pad - lo);
    const int count = min(kTile, live_columns(q, it.b) - lo);
    const int64_t at = static_cast<int64_t>(it.b) * q.t_pad + lo;
    float k[kQuad], l[kQuad], tk[kQuad], tl[kQuad];
    float rv_in[kQuad] = {};
    if constexpr (kKeyed) {
      const int row = it.p * a.windows + it.b;  // the block meets its rows in order
      if (row != key_row) {
        if (key_row >= 0) flush_keys<kWarm, kScales, 0>(warp_keys, a.keys, key_row, grid);
        key_row = row;
      }
      if (kScales || count > 0) {  // a tile past the live prefix has no init to fold
        float w_in[kQuad] = {};
        if constexpr (kWarm) load_floats(q.rv_init + at, count, rv_in);  // masked: 0 past count
        if constexpr (kScales) load_floats(q.w_len + at, width, w_in);
        const float init = kScales ? init_of(q, it.b) : 0.0f;
        uint32_t key[kKeys] = {};
#pragma unroll
        for (int i = 0; i < kQuad; ++i) {
          if (base + i < width) {
            col_keys<kWarm, kScales>(base + i < count, rv_in[i], w_in[i], init, key);
          }
        }
        warp_keys_max<kWarm, kScales, 0>(key, warp_keys);
      }
    }
    if (count <= 0) {
      // Past the live prefix: never read by the tree, and its pref and
      // rv0 are 0 whatever the sums, so they are written now.
      write_quad(q.pref + at, q.rv0 + at, width, 0, k, l, false, 0, 0.0f,
                 RowSums{1.0f, 1.0f, 0.0f});
      continue;
    }
    load_quad(q.kind + at, q.tracelen + at, count, k, l);
    if constexpr (kWarm) {
      // rv0's warm candidate, now; phase 2 writes the cold vector over it
      // where the side starts cold.
      store_floats(q.rv0 + at, width, rv_in);
    }
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
  if constexpr (kKeyed) {
    if (key_row >= 0) flush_keys<kWarm, kScales, 0>(warp_keys, a.keys, key_row, grid);
  }
  stamp(a.stamps, 1);
  // sv0 of every (partition, window). Keyed: a block a chunk of a row's
  // ops (its keys flushed a chunk), the warm instance's present flags kept
  // (a thread's first 32 chunks, in shared memory) for a side that starts
  // cold.
  if constexpr (kWarm) present_sh[t] = 0u;
  if constexpr (kKeyed) {
    // A block a chunk of kWide ops of one row, the grid's last blocks
    // (the fewest tiles) first.
    const int v = a.part[0].v;
    const int chunks = (v + kWide - 1) / kWide;
    const int pairs = kParts * a.windows * chunks;
    int j = 0;
#pragma unroll 1
    for (int pair = grid - 1 - static_cast<int>(blockIdx.x); pair < pairs; pair += grid, ++j) {
      const int row = pair / chunks;
      const int p = row >= a.windows ? 1 : 0, b = row - p * a.windows;
      const Part q = part_of(a, p);
      const int64_t i = static_cast<int64_t>(b) * v + (pair % chunks) * kWide + t;
      uint32_t key[kKeys] = {};
      if ((pair % chunks) * kWide + t < v) {
        const bool present = q.op_present[i];
        const float sv = kWarm ? __ldg(q.sv_init + i) : 0.0f;
        op_keys<kWarm, kScales>(present, sv, kScales ? __ldg(q.w_cov + i) : 0.0f,
                                init_of(q, b), key);
        if constexpr (kWarm) {
          q.sv0[i] = present ? sv : 0.0f;  // the warm candidate
          if (j < 32 && present) present_sh[t] |= 1u << j;
        } else {
          q.sv0[i] = present ? init_of(q, b) : 0.0f;
        }
      }
      warp_keys_max<kWarm, kScales, 1>(key, warp_keys);
      flush_keys<kWarm, kScales, 1>(warp_keys, a.keys, row, grid);
    }
  } else {
    // Spread over the whole grid.
    for (int p = 0; p < kParts; ++p) {
      const Part q = part_of(a, p);
      const int64_t total = static_cast<int64_t>(a.windows) * q.v;
      for (int64_t e = static_cast<int64_t>(blockIdx.x) * kWide + t; e < total;
           e += static_cast<int64_t>(grid) * kWide) {
        q.sv0[e] = q.op_present[e] ? init_of(q, static_cast<int>(e / q.v)) : 0.0f;
      }
    }
  }

  stamp(a.stamps, 2);
  cg::this_grid().sync();
  stamp(a.stamps, 3);

  // kWarm (one window: row p is partition p): each side's choice key over
  // every block's word, a quarter of the block a (partition, side) (one
  // load a thread up to 256 blocks), kept in shared memory and read where
  // it is used.
  if constexpr (kWarm) {
    const int side = t >> 8;  // kParts * 2 quarters: partition side >> 1
    const uint32_t* w =
        a.keys + (static_cast<int64_t>(side >> 1) * kKeys + kKeyRv + (side & 1)) * grid;
    uint32_t m = 0u;
    for (int i = t & 255; i < grid; i += 256) m = max(m, __ldcg(w + i));
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) choice_warps[warp] = m;
    __syncthreads();
    if (t < 2 * kParts) {
      uint32_t c = 0u;
#pragma unroll
      for (int i = 0; i < 8; ++i) c = max(c, choice_warps[8 * t + i]);
      choice[t] = c;
    }
    __syncthreads();
  }
  if constexpr (kWarm) {
    // A side that starts cold: the cold sv0 over the warm candidate
    // (before phase 2, so that nothing of it is live there).
    const int v = a.part[0].v;
    const int chunks = (v + kWide - 1) / kWide;
    const uint32_t present_bits = present_sh[t];
    int j = 0;
    for (int pair = grid - 1 - static_cast<int>(blockIdx.x); pair < kParts * chunks;
         pair += grid, ++j) {
      const int p = pair / chunks;  // one window: the row is the partition
      const int i = (pair % chunks) * kWide + t;
      if (warm_key(choice[2 * p + 1]) || i >= v) continue;
      const Part q = part_of(a, p);
      const bool present = j < 32 ? ((present_bits >> j) & 1u) != 0 : q.op_present[i];
      q.sv0[i] = present ? init_of(q, 0) : 0.0f;
    }
  }
  // Phase 2: a row's sums from its tile nodes (once a row a block), then
  // each live tile's pref and rv0 from the held columns (kWarm: pref
  // alone where the side starts warm, its rv0 written in phase 1).
  int last_row = -1;
  RowSums s{0.0f, 0.0f, 0.0f};
  n_held = 0;
  for (int item = blockIdx.x; item < a.tree_items; item += grid) {
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
    const int width = min(kTile, q.t_pad - lo);
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
    if (kWarm && warm_key(choice[2 * it.p])) {
      float pv[kQuad];
      pref_quad(k, l, count, it.p == 1, a.paper, a.phi, s, pv);
      store_floats(q.pref + at, width, pv);
    } else {
      write_quad(q.pref + at, q.rv0 + at, width, count, k, l, it.p == 1, a.paper, a.phi, s);
    }
  }
  if constexpr (kScales) {
    // The last block (the fewest tiles), after its phase 2: a warp a
    // (row, operand) folds the operand's key of the start its side took.
    if (blockIdx.x == gridDim.x - 1) {
      for (int w = warp; w < 2 * kParts * a.windows; w += kWide / 32) {
        const int row = w >> 1, side = w & 1;
        const int p = row >= a.windows ? 1 : 0, b = row - p * a.windows;
        const bool warm = kWarm && warm_key(choice[2 * p + side]);
        const int k = (warm ? kKeyFwdWarm : kKeyFwdCold) + side;
        const uint32_t m = fold_words(a.keys, row, k, grid);
        if (lane == 0) {
          a.scales[static_cast<int64_t>(b) * (2 * kParts) + 2 * p + side] = scale_of(m);
        }
      }
    }
  }

  stamp(a.stamps, 4);
}

// ------------------------------------------------- K19's first design (flags)

// K19's flag bits of one masked init value (0 where masked off): bit 0
// the value > 0 as XLA's CPU compares it (at least FLT_MIN), bit 1 the
// value NaN.
__device__ __forceinline__ int warm_bits(float x) {
  return (x >= FLT_MIN ? 1 : 0) | (x != x ? 2 : 0);
}

// A block's OR of its threads' flag bits (every thread of the block).
__device__ __forceinline__ int block_bits(int bits) {
  return (__syncthreads_or(bits & 1) ? 1 : 0) | (__syncthreads_or(bits & 2) ? 2 : 0);
}

// A side starts warm when its masked init's max is > 0: some value > 0
// and none NaN.
__device__ __forceinline__ bool warm_side(int bits) { return (bits & 3) == 1; }

// The rows form's warm instance of K19's first design, kept for
// comparison (setup_rows<kClustered, true, false> is the main path's).
template <bool kClustered>
__global__ void __launch_bounds__(kWide, 1) setup_rows_flags(SetupArgs a, int cluster) {
  __shared__ float warp_sums[2 * mr_tree::kWideWarps];
  __shared__ float nodes[2];  // this block's tile nodes: kind, len
  __shared__ float sums[2];
  __shared__ int flags[4];    // this block's rv, sv bits; the row's
  constexpr int kOpsAhead = 4;  // ops a thread loads before the tree
  const int t = threadIdx.x;
  stamp(a.stamps, 0);
  const int row = blockIdx.x / cluster, r = blockIdx.x % cluster;
  const int p = row >= a.windows ? 1 : 0;
  const int b = row - p * a.windows;
  const Part q = part_of(a, p);
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
  int rv_bits = 0, sv_bits = 0;
#pragma unroll
  for (int i = 0; i < kQuad; ++i) {
    if (kQuad * t + i < count) rv_bits |= warm_bits(__ldg(q.rv_init + at + kQuad * t + i));
  }
  for (int i = r * kWide + t; i < q.v; i += op_step) {
    if (q.op_present[ops + i]) sv_bits |= warm_bits(__ldg(q.sv_init + ops + i));
  }
  rv_bits = block_bits(rv_bits);
  sv_bits = block_bits(sv_bits);
  stamp(a.stamps, 1);
  float node_k = 0.0f, node_l = 0.0f;
  mr_tree::wide_tree2(tk, tl, count, warp_sums, node_k, node_l);
  stamp(a.stamps, 2);
  if constexpr (kClustered) {
    cg::cluster_group cl = cg::this_cluster();
    if (t == 0) {
      nodes[0] = node_k;
      nodes[1] = node_l;
      flags[0] = rv_bits;
      flags[1] = sv_bits;
    }
    cl.sync();
    if (t == 32) {  // the row's bits, from every block of the cluster
      int fr = 0, fs = 0;
      for (int c = 0; c < cluster; ++c) {
        const int* peer = cl.map_shared_rank(flags, c);
        fr |= peer[0];
        fs |= peer[1];
      }
      flags[2] = fr;
      flags[3] = fs;
    }
    if (t < 32) {
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
    cl.sync();
  } else {
    if (t == 0) {
      sums[0] = node_k;
      sums[1] = node_l;
      flags[2] = rv_bits;
      flags[3] = sv_bits;
    }
    __syncthreads();
  }
  const bool warm_rv = warm_side(flags[2]);
  const bool warm_sv = warm_side(flags[3]);
  stamp(a.stamps, 3);
  const RowSums s{sums[0], sums[1], __fdiv_rn(1.0f, __int2float_rn(n_ops + n_traces))};
  if (width > 0) {
    write_quad<true>(q.pref + at, q.rv0 + at, width, count, k, l, p == 1, a.paper, a.phi, s,
                     warm_rv ? q.rv_init + at : nullptr);
  }
#pragma unroll
  for (int j = 0; j < kOpsAhead; ++j) {
    const int i = r * kWide + t + j * op_step;
    if (i < q.v) {
      q.sv0[ops + i] = present[j] ? (warm_sv ? __ldg(q.sv_init + ops + i) : s.init) : 0.0f;
    }
  }
  for (int i = r * kWide + t + kOpsAhead * op_step; i < q.v; i += op_step) {
    q.sv0[ops + i] = q.op_present[ops + i] ? (warm_sv ? __ldg(q.sv_init + ops + i) : s.init)
                                           : 0.0f;
  }
  stamp(a.stamps, 4);
}

// The grid form's warm instance of K19's first design, kept for
// comparison (setup_grid<true, false> is the main path's).
__global__ void __launch_bounds__(kWide, 1) setup_grid_flags(SetupArgs a, int hold) {
  extern __shared__ float4 held_words[];
  float* held = reinterpret_cast<float*>(held_words);
  __shared__ float warp_sums[2 * mr_tree::kWideWarps];
  __shared__ float sums[2];
  __shared__ int sv_flags[kParts];  // this block's sv bits a partition
  const int t = threadIdx.x;
  const int base = kQuad * t;
  stamp(a.stamps, 0);
  if (t < kParts) sv_flags[t] = 0;

  int n_held = 0;
  for (int item = blockIdx.x; item < a.tree_items; item += gridDim.x) {
    const Item it = tree_item(a, item);
    const Part q = part_of(a, it.p);
    const int lo = it.j * kTile;
    const int count = min(kTile, live_columns(q, it.b) - lo);
    const int64_t at = static_cast<int64_t>(it.b) * q.t_pad + lo;
    float k[kQuad], l[kQuad], tk[kQuad], tl[kQuad];
    if (count <= 0) {
      write_quad(q.pref + at, q.rv0 + at, min(kTile, q.t_pad - lo), 0, k, l, false, 0, 0.0f,
                 RowSums{1.0f, 1.0f, 0.0f});
      if (t == 0) a.flags[item] = 0;
      continue;
    }
    load_quad(q.kind + at, q.tracelen + at, count, k, l);
    int bits = 0;
#pragma unroll
    for (int i = 0; i < kQuad; ++i) {
      if (base + i < count) bits |= warm_bits(__ldg(q.rv_init + at + base + i));
    }
    bits = block_bits(bits);
    if (t == 0) a.flags[item] = bits;
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
  for (int p = 0; p < kParts; ++p) {
    const Part q = part_of(a, p);
    const int64_t total = static_cast<int64_t>(a.windows) * q.v;
    for (int64_t e = static_cast<int64_t>(blockIdx.x) * kWide + t; e < total;
         e += static_cast<int64_t>(gridDim.x) * kWide) {
      if (q.op_present[e]) atomicOr(&sv_flags[p], warm_bits(__ldg(q.sv_init + e)));
    }
  }
  __syncthreads();
  if (t < kParts) a.flags[a.tree_items + kParts * blockIdx.x + t] = sv_flags[t];

  stamp(a.stamps, 2);
  cg::this_grid().sync();
  stamp(a.stamps, 3);

  bool warm_rv[kParts] = {false, false}, warm_sv[kParts] = {false, false};
  for (int p = 0; p < kParts; ++p) {
    const Part q = part_of(a, p);
    int fr = 0, fs = 0;
    for (int i = t; i < q.tiles; i += kWide) fr |= __ldcg(a.flags + q.first_item + i);
    for (int g = t; g < static_cast<int>(gridDim.x); g += kWide) {
      fs |= __ldcg(a.flags + a.tree_items + kParts * g + p);
    }
    warm_rv[p] = warm_side(block_bits(fr));
    warm_sv[p] = warm_side(block_bits(fs));
  }

  int last_row = -1;
  RowSums s{0.0f, 0.0f, 0.0f};
  n_held = 0;
  for (int item = blockIdx.x; item < a.tree_items; item += gridDim.x) {
    const Item it = tree_item(a, item);
    const Part q = part_of(a, it.p);
    const int n = live_columns(q, it.b);
    const int lo = it.j * kTile;
    const int count = min(kTile, n - lo);
    if (count <= 0) continue;
    const int row = it.p * a.windows + it.b;
    if (row != last_row) {
      last_row = row;
      const int used = (n + kTile - 1) / kTile;
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
    write_quad<true>(q.pref + at, q.rv0 + at, min(kTile, q.t_pad - lo), count, k, l,
                     it.p == 1, a.paper, a.phi, s, warm_rv[it.p] ? q.rv_init + at : nullptr);
  }
  for (int p = 0; p < kParts; ++p) {
    const Part q = part_of(a, p);
    const float init = init_of(q, 0);
    for (int64_t e = static_cast<int64_t>(blockIdx.x) * kWide + t; e < q.v;
         e += static_cast<int64_t>(gridDim.x) * kWide) {
      q.sv0[e] = q.op_present[e] ? (warm_sv[p] ? __ldg(q.sv_init + e) : init) : 0.0f;
    }
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

// The rows form's instance for a launch: K19's flag design, or the
// warm and scales instances (the cold one without scales).
template <bool kClustered>
const void* rows_kernel(bool warm, bool scaled, bool flag_design) {
  if (flag_design) return reinterpret_cast<const void*>(setup_rows_flags<kClustered>);
  if (warm) {
    return scaled ? reinterpret_cast<const void*>(setup_rows<kClustered, true, true>)
                  : reinterpret_cast<const void*>(setup_rows<kClustered, true, false>);
  }
  return scaled ? reinterpret_cast<const void*>(setup_rows<kClustered, false, true>)
                : reinterpret_cast<const void*>(setup_rows<kClustered, false, false>);
}

// The grid form's, the same way.
const void* grid_kernel(bool warm, bool scaled, bool flag_design) {
  if (flag_design) return reinterpret_cast<const void*>(setup_grid_flags);
  if (warm) {
    return scaled ? reinterpret_cast<const void*>(setup_grid<true, true>)
                  : reinterpret_cast<const void*>(setup_grid<true, false>);
  }
  return scaled ? reinterpret_cast<const void*>(setup_grid<false, true>)
                : reinterpret_cast<const void*>(setup_grid<false, false>);
}

// Every grid-form instance: the cold one first.
const void* const kGridKernels[] = {
    grid_kernel(false, false, false), grid_kernel(true, false, false),
    grid_kernel(false, true, false), grid_kernel(true, true, false),
    grid_kernel(true, false, true)};

// The grid form's dynamic shared memory, up to kHoldMax held tiles.
cudaError_t allow_held() {
  for (const void* fn : kGridKernels) {
    const cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kHoldMax * kHoldBytes);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
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
  kPartial, kStampsAt, kDevice, kStream,
  // K19's init: sv and rv of each partition (all four or none), and the
  // grid form's words (the keys [2 * windows][kKeys][grid], or the flag
  // design's flags).
  kSvInitN, kRvInitN, kSvInitA, kRvInitA, kFlags,
  // The first step's int8 scales: each partition's fwd and bwd weights
  // (all four or none) and the scales' [windows, 4] output.
  kWLenN, kWCovN, kWLenA, kWCovA, kScales,
  kFlagDesign,  // 1: K19's flag design (a comparison; warm, no scales)
  kWords
};

}  // namespace

extern "C" {

// What the set-up kernels get on `device`: out[0] 1 if the device takes
// a cooperative launch, out[1] the SM count, out[2] the first design's
// resident blocks an SM, out[3] the grid form's (its shared memory for
// kHoldMax tiles; the least over its instances), out[4] kTile, out[5]
// kHoldMax, out[6] kClusterMax, out[7] the words of an argument block,
// out[8] kStamps, out[9] kKeys. Returns the CUDA error code of the
// queries.
int mr_rank_setup_config(int device, int32_t* out) {
  cudaError_t e = use_device(device);
  int coop = 0, sms = 0, first_per_sm = 0, grid_per_sm = INT_MAX;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &first_per_sm, reinterpret_cast<const void*>(setup_first), kThreads, 0);
  }
  if (e == cudaSuccess) e = allow_held();
  for (const void* fn : kGridKernels) {  // every instance's grid is planned the same way
    int per_sm = 0;
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kWide,
                                                        kHoldMax * kHoldBytes);
    }
    grid_per_sm = per_sm < grid_per_sm ? per_sm : grid_per_sm;
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
  out[9] = kKeys;
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
  // K19: all four init vectors or none; one window. The scales: all four
  // weights and the output, or none. Either in the rows or grid form
  // (the grid form with its words); the flag design warm, no scales.
  const int n_init = (w[kSvInitN] != 0) + (w[kRvInitN] != 0) + (w[kSvInitA] != 0)
                     + (w[kRvInitA] != 0);
  const int n_weights = (w[kWLenN] != 0) + (w[kWCovN] != 0) + (w[kWLenA] != 0)
                        + (w[kWCovA] != 0);
  const bool warm = n_init == 4, scaled = n_weights == 4, flag_design = w[kFlagDesign] != 0;
  if ((n_init != 0 && !warm) || (warm && windows != 1) || (n_weights != 0 && !scaled)
      || scaled != (w[kScales] != 0) || ((warm || scaled) && form == kFormFirst)
      || (flag_design && (!warm || scaled))
      || ((warm || scaled) && form == kFormGrid && w[kFlags] == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.part[0].sv_init = static_cast<const float*>(ptr(kSvInitN));
  a.part[0].rv_init = static_cast<const float*>(ptr(kRvInitN));
  a.part[1].sv_init = static_cast<const float*>(ptr(kSvInitA));
  a.part[1].rv_init = static_cast<const float*>(ptr(kRvInitA));
  a.part[0].w_len = static_cast<const float*>(ptr(kWLenN));
  a.part[0].w_cov = static_cast<const float*>(ptr(kWCovN));
  a.part[1].w_len = static_cast<const float*>(ptr(kWLenA));
  a.part[1].w_cov = static_cast<const float*>(ptr(kWCovA));
  a.scales = static_cast<float*>(ptr(kScales));
  a.flags = static_cast<int32_t*>(ptr(kFlags));
  a.keys = static_cast<uint32_t*>(ptr(kFlags));
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
    config.numAttrs = cluster > 1 ? 1 : 0;  // a row of one tile: a plain launch
    int blocks = static_cast<int>(cluster);
    void* params[] = {&a, &blocks};
    launched = cudaLaunchKernelExC(&config,
                                   cluster > 1 ? rows_kernel<true>(warm, scaled, flag_design)
                                               : rows_kernel<false>(warm, scaled, flag_design),
                                   params);
  } else if (form == kFormGrid) {
    if (most_tiles <= kClusterMax || grid < 1 || grid > a.tree_items || hold < 0
        || hold > kHoldMax || a.partial == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    launched = allow_held();
    int held = static_cast<int>(hold);
    if (launched == cudaSuccess) {
      launched = launch_cooperative(grid_kernel(warm, scaled, flag_design),
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
