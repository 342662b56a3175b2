// K6's set-up on Hopper: a rank program's preference and initial
// vectors, both partitions and every window of a stacked group, in one
// cooperative launch.
//
// Replaces what XLA compiles for the TPU in
// microrank_tpu/rank_backends/jax_tpu.py:44 `preference_vector` and the
// initial vectors of :285 `_partition_setup`. The port had issued it as
// about 20 small PyTorch ops a partition and two launches of the
// fixed-order fold (ops/setup.py `rank_setup_plain`, which this kernel
// repeats bit for bit). For partition p of window b, with n the live
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
// giant 10M-span window that is 2 x 2^21 columns, ~67 MB.
//
// The design: the sums need the whole row before any pref can be
// written, and a row of the giant window spans some 320 tiles. So one
// cooperative launch on a grid sized by occupancy (every block
// resident), in two phases around one grid barrier:
// * phase 1: the blocks walk the work items, a tile of kTile columns of
//   one (partition, window) row each: a thread computes its 16 columns'
//   two terms (coalesced loads, skipped past the live prefix), the
//   block folds each to the tile's level-12 node (tree_fold.cuh) and
//   writes the two nodes to `partial`; then the sv0 items (a tile of
//   ops each, elementwise);
// * the grid barrier;
// * phase 2: for each of its tiles again, a block folds the row's tile
//   nodes (the tree's upper levels, at most kMaxTiles: 320 at the giant
//   window) into kind_sum and num_sum, redundantly in every block of the
//   row, and writes the tile's pref and rv0, reading kind and tracelen
//   again (from L2 where they fit).
// No atomics: every sum is the tree, written and read across the
// barrier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "tree_fold.cuh"

namespace cg = cooperative_groups;

namespace {

using mr_tree::kPerThread;
using mr_tree::kThreads;
using mr_tree::kTile;
using mr_tree::kWarps;

constexpr int kParts = 2;  // normal (no anomaly), abnormal (anomaly)

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

__global__ void __launch_bounds__(kThreads) rank_setup(SetupArgs a) {
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

// What the set-up kernel gets on `device`: out[0] 1 if the device takes
// a cooperative launch, out[1] the kernel's resident blocks an SM,
// out[2] the SM count, out[3] kThreads, out[4] kTile. Returns the CUDA
// error code of the queries.
int mr_rank_setup_config(int device, int32_t* out) {
  cudaError_t e = use_device(device);
  int coop = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void*>(rank_setup), kThreads, 0);
  }
  out[0] = coop;
  out[1] = e == cudaSuccess ? per_sm : 0;
  out[2] = sms;
  out[3] = kThreads;
  out[4] = kTile;
  return static_cast<int>(e);
}

// One cooperative launch of the set-up for both partitions of
// `windows` windows on `stream` (PyTorch's current stream of `device`).
// `ptrs` holds, for the normal then the abnormal partition: kind,
// tracelen, n_cols, n_traces, n_ops, op_present, pref, rv0, sv0 (each
// row-major [windows, n]); `t_pads` each partition's trace pad, `v` the
// op count; `paper` the preference form; `partial` 2 floats a tile of
// each (partition, window) row; `max_blocks` the grid's cap (the
// card's resident blocks). Returns the CUDA error code of the launch
// (0 = launched); allocates nothing and does not synchronize.
int mr_rank_setup(void* const* ptrs, const int32_t* t_pads, int32_t windows, int32_t v,
                  float phi, int32_t paper, float* partial, int64_t max_blocks, int device,
                  void* stream) {
  if (windows < 1 || v < 0 || max_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  SetupArgs a{};
  int64_t item = 0;
  for (int p = 0; p < kParts; ++p) {
    void* const* q = ptrs + 9 * p;
    Part& part = a.part[p];
    part.kind = static_cast<const int32_t*>(q[0]);
    part.tracelen = static_cast<const int32_t*>(q[1]);
    part.n_cols = static_cast<const int32_t*>(q[2]);
    part.n_traces = static_cast<const int32_t*>(q[3]);
    part.n_ops = static_cast<const int32_t*>(q[4]);
    part.op_present = static_cast<const uint8_t*>(q[5]);
    part.pref = static_cast<float*>(q[6]);
    part.rv0 = static_cast<float*>(q[7]);
    part.sv0 = static_cast<float*>(q[8]);
    if (t_pads[p] < 0) return static_cast<int>(cudaErrorInvalidValue);
    part.t_pad = t_pads[p];
    part.tiles = (t_pads[p] + kTile - 1) / kTile;
    if (part.tiles > mr_tree::kMaxTiles) return static_cast<int>(cudaErrorInvalidValue);
    part.v = v;
    part.v_tiles = (v + kTile - 1) / kTile;
    part.first_item = static_cast<int32_t>(item);
    item += static_cast<int64_t>(windows) * part.tiles;
  }
  const int64_t sv_items = static_cast<int64_t>(kParts) * windows * a.part[0].v_tiles;
  if (item + sv_items > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  a.windows = windows;
  a.phi = phi;
  a.paper = paper;
  a.tree_items = static_cast<int32_t>(item);
  a.items = static_cast<int32_t>(item + sv_items);
  a.partial = partial;
  if (a.items == 0) return 0;
  if (a.tree_items > 0 && partial == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int64_t grid = a.items < max_blocks ? a.items : max_blocks;
  void* params[] = {&a};
  const cudaError_t launched = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(rank_setup), dim3(static_cast<unsigned>(grid)),
      dim3(kThreads), params, 0, static_cast<cudaStream_t>(stream));
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
