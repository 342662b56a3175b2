// The rank program's fixed-order sum: one copy of the tree that every
// kernel summing over a padded axis uses (row_fold.cu `fold_rows`,
// rank_setup.cu's preference sums, rank_epilogue.cu's finish total), so
// that the three give the same bits for the same values and length.
//
// The order: element i of a row is leaf i of a binary tree whose node
// at level L covers [j * 2^L, (j + 1) * 2^L); a node's value is its left
// child's plus its right child's, or its left child's alone where the
// right child starts at or past the row's length n (so padding is never
// read, and a wider pad only adds levels that pass the left child up).
// The value at the root of the smallest subtree holding [0, n) is the
// sum; n = 0 gives +0. The plain version (ops/fold.py `fold_rows_plain`)
// computes the same tree level by level.
//
// A block of kThreads threads folds one tile of kTile elements to the
// tree's level-12 node: each thread the subtree of kPerThread
// consecutive elements in registers, then the warp's 32 subtrees by
// shuffles at offsets 1, 2, 4, 8, 16 (adjacent pairs first, as the
// tree), then the block's 8 warps. A row of several tiles folds its
// tiles' nodes by the same function: they are the upper levels.
// __fadd_rn keeps every add an exact IEEE add (no contraction).

#pragma once

#include <cstdint>

namespace mr_tree {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;  // 4096 elements a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTiles = kTile;              // tile nodes one block folds

// The tree over stage[0, count) (count <= kTile), which the block has
// filled, +0 at and past count, and synchronized; the result in thread
// 0. Ends synchronized: stage and warp_sums may be reused.
__device__ __forceinline__ float stage_tree(const float* stage, int count, float* warp_sums) {
  const int t = threadIdx.x;
  const int base = t * kPerThread;
  float v[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) v[i] = stage[base + i];
#pragma unroll
  for (int s = 1; s < kPerThread; s *= 2) {
#pragma unroll
    for (int i = 0; i < kPerThread; i += 2 * s) {
      if (base + i + s < count) v[i] = __fadd_rn(v[i], v[i + s]);
    }
  }
  float acc = v[0];
  const int lane = t & 31;
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    const float other = __shfl_down_sync(0xffffffffu, acc, o);
    if ((lane & (2 * o - 1)) == 0 && base + o * kPerThread < count) {
      acc = __fadd_rn(acc, other);
    }
  }
  if (lane == 0) warp_sums[t >> 5] = acc;
  __syncthreads();
  float sum = 0.0f;
  if (t == 0) {
    constexpr int kWarpSpan = 32 * kPerThread;
#pragma unroll
    for (int s = 1; s < kWarps; s *= 2) {
#pragma unroll
      for (int w = 0; w < kWarps; w += 2 * s) {
        if ((w + s) * kWarpSpan < count) warp_sums[w] = __fadd_rn(warp_sums[w], warp_sums[w + s]);
      }
    }
    sum = warp_sums[0];
  }
  __syncthreads();
  return sum;
}

// The tree over src[0, count) (count <= kTile), read through L2 (the
// values may have been written by other blocks), staged through `stage`
// by coalesced loads; the result in thread 0.
__device__ __forceinline__ float tile_tree(const float* src, int count, float* stage,
                                           float* warp_sums) {
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int at = i * kThreads + threadIdx.x;  // coalesced
    stage[at] = at < count ? __ldcg(src + at) : 0.0f;
  }
  __syncthreads();
  return stage_tree(stage, count, warp_sums);
}

// The tree over a row of n values whose tile nodes (level 12: node j
// covers [j * kTile, (j + 1) * kTile)) lie in nodes[0, tiles): the
// tiles that hold [0, n) folded as the tree's upper levels; n = 0 gives
// +0. The result in thread 0.
__device__ __forceinline__ float fold_tiles(const float* nodes, int n, float* stage,
                                            float* warp_sums) {
  return tile_tree(nodes, (n + kTile - 1) / kTile, stage, warp_sums);
}

}  // namespace mr_tree
