// K6's epilogue on Hopper: a rank program's finish, spectrum and
// tie-aware top-k, every window of a stacked group, in one launch.
//
// Replaces what XLA compiles for the TPU in
// microrank_tpu/rank_backends/jax_tpu.py: :882 `_partition_finish`,
// :971 `spectrum_counters`, :1006 `window_spectrum` with the 13 formulas
// of microrank_tpu/spectrum/formulas.py, :1046 `top_k_tiebroken` and
// :1068 `_finish_topk`. The port had issued them as about 50 small
// PyTorch ops a window, two launches of the fixed-order fold and a
// stable torch.sort (ops/epilogue.py `rank_epilogue_plain`, which these
// kernels repeat bit for bit). For window b, from each partition's
// final carry sv:
//
//   score = sv / max(sv)                      (max propagates NaN, as torch.amax)
//   total = tree(op_present ? score : 0)      (tree_fold.cuh, over all V)
//   weight = score * total / n_ops
//   ef, nf, ep, np = the spectrum counters (the only-in-normal branch
//                    included), the configured formula, -inf where no
//                    partition holds the op
//   n_valid = min(#valid, k)
//   top-k: the first k of a stable ascending sort of -(score + 0)
//
// Each torch op is its own IEEE operation (__fdiv_rn, __fmul_rn,
// __fadd_rn, __fsub_rn, __fsqrt_rn) in the plain formulas' order: no FMA.
//
// The top-k. torch.sort(-(s + 0), stable=True) orders by score
// descending, then index ascending; +0 makes -0.0 and +0.0 one key;
// -inf follows every finite score and NaN (of either sign) every other
// value, by index. One unsigned 64-bit key a score gives that order as
// one integer compare: the high word the order bits of -(s + 0) (sign
// flipped to sort as unsigned; every NaN one value above +inf's), the
// low word the index. The keys are unique, so the first k keys are the
// k smallest, and the scores written are the bits of s + 0, which is
// what -(-(s + 0)) gives.
//
// What bounds it: bytes, and at these sizes a block's latency. Each
// partition's sv, op_present and cov_unique are read and its weight and
// score written once (17 bytes an op): 105 KB at a config-5 window.
//
// The design (`epilogue_window`): a block of 1024 threads a window, or
// for a vocabulary past kSliceMax ops a cluster of up to kClusterMax
// blocks, each holding a slice of kTile-multiple ops. At its start a
// block takes its slice of the six input vectors into shared memory by
// TMA bulk copies onto one mbarrier (the 16-byte-aligned interior of
// each row; the threads copy the few bytes either side), and every pass
// after reads them there: the maxima, the scores and their tree (a
// block's tile nodes exchanged through distributed shared memory and
// folded as the tree's upper levels), the weights and the spectrum (the
// canonical scores overwrite sv_n), and the selection:
// * k <= kWarpK (what users run: top_max + extra_rows = 11): each warp
//   keeps its 32 least keys sorted across its lanes by shuffle bitonic
//   networks: its first batch of 32 keys sorted, then, past a bound that
//   no key of the top-k exceeds (the least of the warps' k-th keys of
//   their first batches), only the keys at or below it, staged and
//   merged 32 at a time; the 32 warps' lists merge pairwise in shared
//   memory (one barrier a round), and block 0 of a cluster merges the
//   blocks' lists through distributed shared memory. No histogram, no
//   atomics.
// * k > kWarpK: a radix select over the keys of the slices in shared
//   memory, 8 bits a pass from the top (warp-aggregated histograms,
//   summed over the cluster's blocks), then the k keys gathered to
//   block 0 and sorted by a bitonic sort (in shared memory up to
//   kSmemKeys keys, else in the window's scratch).
// `epilogue_first`, the first design, stays for comparison, and runs
// the vocabularies past kClusterMax * kSliceMax ops.
//
// K13, every formula at once (jax_tpu.py:1373
// `rank_window_all_methods_core`, reached by `cli eval --all-methods`):
// the launch takes a methods axis, grid y (the window kernel's
// kAllMethods instances; the one-formula instances are compiled apart
// and unchanged). With `methods` = kMethods,
// block (x, m) does what the one-method launch's block x does, with
// formula m (the order of spectrum/formulas.py METHODS, which is the
// Method enum's), and writes row m of the window's [M, k] top-k; only
// the blocks of row 0 write the weights, the scores and n_valid, so no
// two blocks write one word. Each row is the one-method launch's output
// for its formula bit for bit: the same counters, the same tree, the
// same formula code, the same selection. A row's radix keys past
// kSmemKeys take a slice of the scratch each, and the first design's
// scratch (canonical scores, tile nodes) is a row's own; its blocks past
// row 0 recompute score = sv / max where row 0 reads back what it wrote.
// One launch a program; with `methods` = 1 it is the launch it was.
//
// K14, the checked program (jax_tpu.py:1415 `rank_window_checked_core`,
// :1450 `rank_window_checked_traced_core`): with a check word asked for
// (a non-null `check`, a flag argument: an unchecked launch runs the
// same instructions as before), both forms end with JAX's checkify
// checks of the window as bits of one int32 (`check_window`): bit 0 a
// live top score (rank < n_valid) not finite, bit 1 n_valid outside
// [0, k], bit 2, given the residual trace [2, I] and n_iters the steps
// wrote, a live residual (step < n_iters) not finite. The word rides the
// window's one result copy; the host raises on it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "tree_fold.cuh"

namespace cg = cooperative_groups;

namespace {

using mr_tree::kPerThread;
using mr_tree::kThreads;
using mr_tree::kTile;
using mr_tree::kWarps;

constexpr int kParts = 2;        // normal, abnormal
constexpr int kBins = 256;       // a radix digit of 8 bits
constexpr int kSmemKeys = 1024;  // top-k keys sorted in shared memory
static_assert(kThreads == kBins, "one thread a histogram bin");

// The 13 formulas, in the order of ops/epilogue.py METHOD_IDS.
enum Method {
  kDstar2, kOchiai, kJaccard, kSorensendice, kM1, kM2, kGoodman, kTarantula, kRussellrao,
  kHamann, kDice, kSimplematching, kRogers, kMethods
};

struct Part {
  const float* sv;             // [B, v] the final carry
  const uint8_t* op_present;   // [B, v] (bool)
  const int32_t* cov_unique;   // [B, v]
  const int32_t* n_traces;     // [B]
  const int32_t* n_ops;        // [B]
  float* weight;               // [B, v]
  float* score;                // [B, v]
};

struct EpilogueArgs {
  Part part[kParts];
  int32_t v, k, k_pad, method, methods, tiles;
  float eps;
  float* scores;               // [B, M, v] scratch: score + 0, -inf where not valid
  float* nodes;                // [B, M, 2, tiles] scratch (tiles > 1)
  uint64_t* keys;              // [B, M, k_pad] scratch (k_pad > kSmemKeys)
  int32_t* top_idx;            // [B, M, k]
  float* top_scores;           // [B, M, k]
  int32_t* n_valid;            // [B]
  int32_t* check;              // [B] K14's check words, or null (unchecked)
  const float* residuals;      // [B, 2, iters] with `check`: the residual trace, or null
  const int32_t* n_iters;      // [B]
  int32_t iters;
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }
__device__ __forceinline__ float f_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float f_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float f_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float f_div(float a, float b) { return __fdiv_rn(a, b); }

// spectrum/formulas.py, op for op (Python evaluates left to right).
__device__ __forceinline__ float formula(int m, float ef, float nf, float ep, float np) {
  switch (m) {
    case kDstar2: return f_div(f_mul(ef, ef), f_add(ep, nf));
    case kOchiai: return f_div(ef, __fsqrt_rn(f_mul(f_add(ep, ef), f_add(ef, nf))));
    case kJaccard: return f_div(ef, f_add(f_add(ef, ep), nf));
    case kSorensendice: return f_div(f_mul(2.0f, ef), f_add(f_add(f_mul(2.0f, ef), ep), nf));
    case kM1: return f_div(f_add(ef, np), f_add(ep, nf));
    case kM2:
      return f_div(ef, f_add(f_add(f_add(f_mul(2.0f, ep), f_mul(2.0f, nf)), ef), np));
    case kGoodman:
      return f_div(f_sub(f_sub(f_mul(2.0f, ef), nf), ep), f_add(f_add(f_mul(2.0f, ef), nf), ep));
    case kTarantula: {
      const float fail = f_div(ef, f_add(ef, nf));
      return f_div(fail, f_add(fail, f_div(ep, f_add(ep, np))));
    }
    case kRussellrao: return f_div(ef, f_add(f_add(f_add(ef, nf), ep), np));
    case kHamann:
      return f_div(f_sub(f_sub(f_add(ef, np), ep), nf), f_add(f_add(f_add(ef, nf), ep), np));
    case kDice: return f_div(f_mul(2.0f, ef), f_add(f_add(ef, nf), ep));
    case kSimplematching: return f_div(f_add(ef, np), f_add(f_add(f_add(ef, np), nf), ep));
    default:  // kRogers
      return f_div(f_add(ef, np), f_add(f_add(f_add(ef, np), f_mul(2.0f, nf)), f_mul(2.0f, ep)));
  }
}

// max as torch.amax takes it: a NaN anywhere wins.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// The sort key of op i with canonical score s (= score + 0): ascending
// keys are descending scores, ties by index, NaN last.
__device__ __forceinline__ uint64_t sort_key(float s, int i) {
  uint32_t hi;
  if (s != s) {
    hi = 0xFFFFFFFFu;
  } else {
    const uint32_t u = __float_as_uint(-s);
    hi = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  return (static_cast<uint64_t>(hi) << 32) | static_cast<uint32_t>(i);
}

__device__ float block_max(float m, float* warp_vals) {
  for (int o = 16; o > 0; o >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_vals[threadIdx.x >> 5] = m;
  __syncthreads();
  float r = warp_vals[0];
  for (int w = 1; w < kWarps; ++w) r = nan_max(r, warp_vals[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ bool is_finite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) != 0x7f800000u;
}

// K14: window b's check word (the note at the top), by one warp, once
// the block's writes of its top-k and n_valid are visible to it.
__device__ __noinline__ void check_window(int32_t* check, const float* top_scores,
                                          const int32_t* n_valid, const float* residuals,
                                          const int32_t* n_iters, int iters, int b, int k) {
  const int lane = threadIdx.x & 31;
  const int nv = n_valid[b];
  bool bad = false;
  for (int j = lane; j < k; j += 32) {
    bad |= j < nv && !is_finite(top_scores[static_cast<int64_t>(b) * k + j]);
  }
  int32_t word = __any_sync(0xffffffffu, bad) ? 1 : 0;
  if (nv < 0 || nv > k) word |= 2;
  if (residuals != nullptr) {
    const int n = n_iters[b];
    bad = false;
    for (int i = lane; i < 2 * iters; i += 32) {
      bad |= i % iters < n && !is_finite(residuals[static_cast<int64_t>(b) * 2 * iters + i]);
    }
    if (__any_sync(0xffffffffu, bad)) word |= 4;
  }
  if (lane == 0) check[b] = word;
}

// Sort keys[0, n) ascending (n a power of two) by the block.
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

// The first design (a block of 256 threads a window, every pass over the
// window's vectors in global memory), kept for comparison and for
// vocabularies past what a cluster holds.
__global__ void __launch_bounds__(kThreads) epilogue_first(EpilogueArgs a) {
  __shared__ float stage[kTile];
  __shared__ float warp_vals[kWarps];
  __shared__ uint32_t warp_counts[kWarps];
  __shared__ float bcast[2 * kParts];  // the maxima, then the totals
  __shared__ uint32_t hist[kBins];
  __shared__ uint64_t smem_keys[kSmemKeys];
  __shared__ int n_valid, n_gathered, need, done;
  __shared__ uint64_t prefix;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int v = a.v;
  const int64_t row = static_cast<int64_t>(b) * v;
  // Grid y is the formula (K13, `methods` rows, or 1): row 0's blocks
  // alone write the weights, the scores and n_valid; each block has its
  // row's scratch and writes its row of the window's [M, k] top-k.
  const int method = a.methods == 1 ? a.method : static_cast<int>(blockIdx.y);
  const bool lead = blockIdx.y == 0;
  const int64_t mrow = static_cast<int64_t>(b) * a.methods + blockIdx.y;
  float* scores = a.scores + mrow * v;

  // The finish of each partition: its maximum, its scores and the tree
  // of its present scores.
  for (int p = 0; p < kParts; ++p) {
    const Part q = p == 0 ? a.part[0] : a.part[1];
    float m = neg_inf();
    for (int i = t; i < v; i += kThreads) m = nan_max(m, q.sv[row + i]);
    m = block_max(m, warp_vals);
    if (t == 0) bcast[p] = m;
    float* nodes = a.tiles > 1 ? a.nodes + (mrow * kParts + p) * a.tiles : nullptr;
    float total = 0.0f;
    for (int j = 0; j < a.tiles; ++j) {
      const int lo = j * kTile;
      const int count = min(kTile, v - lo);
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int at = i * kThreads + t;
        float present = 0.0f;
        if (at < count) {
          const float s = f_div(q.sv[row + lo + at], m);
          if (lead) q.score[row + lo + at] = s;
          present = q.op_present[row + lo + at] ? s : 0.0f;
        }
        stage[at] = present;
      }
      __syncthreads();
      const float node = mr_tree::stage_tree(stage, count, warp_vals);
      if (t == 0) {
        if (a.tiles == 1) {
          total = node;
        } else {
          nodes[j] = node;
        }
      }
    }
    if (a.tiles > 1) {
      __syncthreads();  // the tile nodes, written by thread 0
      total = mr_tree::fold_tiles(nodes, v, stage, warp_vals);
    }
    if (t == 0) bcast[kParts + p] = total;
  }
  if (t == 0) n_valid = 0;
  __syncthreads();

  // Weights, counters, the formula; each op's canonical score.
  const Part nq = a.part[0], aq = a.part[1];
  const float total_n = bcast[kParts], total_a = bcast[kParts + 1];
  const float max_n = bcast[0], max_a = bcast[1];
  const float ops_n = __int2float_rn(nq.n_ops[b]), ops_a = __int2float_rn(aq.n_ops[b]);
  const float len_n = __int2float_rn(nq.n_traces[b]), len_a = __int2float_rn(aq.n_traces[b]);
  const float eps = a.eps;
  int valid_here = 0;
  for (int i = t; i < v; i += kThreads) {
    const int64_t at = row + i;
    // The scores again (the division the finish wrote them by).
    const float w_n = f_div(f_mul(f_div(nq.sv[at], max_n), total_n), ops_n);
    const float w_a = f_div(f_mul(f_div(aq.sv[at], max_a), total_a), ops_a);
    if (lead) {
      nq.weight[at] = w_n;
      aq.weight[at] = w_a;
    }
    const bool in_a = aq.op_present[at], in_n = nq.op_present[at];
    const float cov_a = __int2float_rn(aq.cov_unique[at]);
    const float cov_n = __int2float_rn(nq.cov_unique[at]);
    const float ef = in_a ? f_mul(w_a, cov_a) : eps;
    const float nf = in_a ? f_mul(w_a, f_sub(len_a, cov_a)) : eps;
    const float ep =
        in_a ? (in_n ? f_mul(w_n, cov_n) : eps) : f_mul(f_add(1.0f, w_n), cov_n);
    const float np = in_a ? (in_n ? f_mul(w_n, f_sub(len_n, cov_n)) : eps) : f_sub(len_n, cov_n);
    const bool valid = in_a || in_n;
    const float s = valid ? formula(method, ef, nf, ep, np) : neg_inf();
    scores[i] = f_add(s, 0.0f);
    valid_here += valid;
  }
  atomicAdd(&n_valid, valid_here);
  if (t == 0) {
    prefix = 0;
    need = a.k;
    done = 0;
  }
  __syncthreads();
  if (t == 0 && lead) a.n_valid[b] = min(n_valid, a.k);

  // Radix select: the prefix of the keys that holds exactly the k
  // smallest, 8 bits a pass from the top.
  int shift = 56;
  for (;; shift -= 8) {
    hist[t] = 0;
    __syncthreads();
    const uint64_t pre = prefix;
    for (int i = t; i < v; i += kThreads) {
      const uint64_t key = sort_key(scores[i], i);
      if (shift == 56 || (key >> (shift + 8)) == (pre >> (shift + 8))) {
        atomicAdd(&hist[(key >> shift) & (kBins - 1)], 1u);
      }
    }
    __syncthreads();
    // Inclusive scan of the histogram, a bin a thread.
    const uint32_t h = hist[t];
    uint32_t incl = h;
    const int lane = t & 31;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    if (lane == 31) warp_counts[t >> 5] = incl;
    __syncthreads();
    for (int w = 0; w < (t >> 5); ++w) incl += warp_counts[w];
    const uint32_t excl = incl - h;
    const uint32_t want = static_cast<uint32_t>(need);
    __syncthreads();  // every thread has read `need`
    if (excl < want && want <= incl) {  // the bin that holds the k-th key
      prefix = pre | (static_cast<uint64_t>(t) << shift);
      need = static_cast<int>(want - excl);
      done = h == want - excl;  // the whole bin is wanted
    }
    __syncthreads();
    if (done || shift == 0) break;
  }

  // Gather the k keys at or below the prefix, sort them, write them out.
  uint64_t* keys = a.k_pad <= kSmemKeys ? smem_keys : a.keys + mrow * a.k_pad;
  const uint64_t top = prefix >> shift;
  if (t == 0) n_gathered = 0;
  __syncthreads();
  for (int i = t; i < v; i += kThreads) {
    const uint64_t key = sort_key(scores[i], i);
    if ((key >> shift) <= top) keys[atomicAdd(&n_gathered, 1)] = key;
  }
  for (int j = a.k + t; j < a.k_pad; j += kThreads) keys[j] = ~0ull;
  __syncthreads();
  bitonic_sort(keys, a.k_pad);
  for (int j = t; j < a.k; j += kThreads) {
    const int idx = static_cast<int>(static_cast<uint32_t>(keys[j]));
    a.top_idx[mrow * a.k + j] = idx;
    a.top_scores[mrow * a.k + j] = scores[idx];
  }
  if (a.check != nullptr) {
    __syncthreads();  // the top-k and n_valid written
    if (t < 32) {
      check_window(a.check, a.top_scores, a.n_valid, a.residuals, a.n_iters, a.iters, b, a.k);
    }
  }
}

// ---------------------------------------------------------------- window

constexpr int kWide = mr_tree::kWideThreads;      // threads a block
constexpr int kWideWarps = mr_tree::kWideWarps;   // 32
constexpr int kQuad = mr_tree::kWidePerThread;    // leaves a thread of a tile
constexpr int kSliceMax = 2 * kTile;              // ops a block holds
constexpr int kSliceTiles = kSliceMax / kTile;
constexpr int kClusterMax = 8;                    // blocks a window (portable clusters)
constexpr int kWarpK = 32;                        // k up to this: the warp-select
constexpr int kInputs = 6;                        // sv, cov_unique, op_present of each part

// The forms of a launch (ops/epilogue.py FORMS).
enum Form { kFormBlock = 0, kFormCluster = 1, kFormFirst = 2 };

// Shared memory of a slice: each input row with 16 bytes of room for
// its alignment, after the key lists.
__host__ __device__ constexpr int64_t row_bytes(int64_t slice, int64_t elt) {
  return (slice * elt + 16 + 15) / 16 * 16;
}
__host__ __device__ constexpr int64_t window_smem(int64_t slice) {
  return kSmemKeys * 8 + 4 * row_bytes(slice, 4) + 2 * row_bytes(slice, 1);
}

struct WindowArgs {
  Part part[kParts];
  int32_t v, k, k_pad, method, slice, cluster;
  float eps;
  uint64_t* keys;              // [B, M, k_pad] scratch (k_pad > kSmemKeys)
  int32_t* top_idx;            // [B, M, k]
  float* top_scores;           // [B, M, k]
  int32_t* n_valid;            // [B]
  int64_t* stamps;             // [kStamps] SM cycles of window 0's phases, or null
  int32_t* check;              // [B] K14's check words, or null (unchecked)
  const float* residuals;      // [B, 2, iters] with `check`: the residual trace, or null
  const int32_t* n_iters;      // [B]
  int32_t iters;
};

// The phases a launch may stamp (block 0, thread 0): its start, the
// slice loaded, the maxima, the scores and their tile nodes, the
// totals, the spectrum, the block's selection, the window's top-k
// written.
constexpr int kStamps = 8;

__device__ __forceinline__ void stamp(int64_t* stamps, int phase) {
  if (stamps != nullptr && blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    stamps[phase] = clock64();
  }
}

template <bool kClustered>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (kClustered) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// `p` in the shared memory of the cluster's block `rank` (the block's
// own without a cluster).
template <bool kClustered, typename T>
__device__ __forceinline__ T* peer(T* p, int rank) {
  if constexpr (kClustered) {
    return cg::this_cluster().map_shared_rank(p, rank);
  } else {
    return p;
  }
}

__device__ __forceinline__ uint64_t key_min(uint64_t x, uint64_t y) { return x < y ? x : y; }
__device__ __forceinline__ uint64_t key_max(uint64_t x, uint64_t y) { return x < y ? y : x; }

// A warp's 32 keys (one a lane) sorted ascending across the lanes.
__device__ __forceinline__ uint64_t warp_sort(uint64_t x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const uint64_t y = __shfl_xor_sync(0xffffffffu, x, stride);
      const bool ascending = (lane & size) == 0;
      const bool lower = (lane & stride) == 0;
      x = lower == ascending ? key_min(x, y) : key_max(x, y);
    }
  }
  return x;
}

// A bitonic sequence across the lanes sorted ascending.
__device__ __forceinline__ uint64_t warp_merge(uint64_t x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const uint64_t y = __shfl_xor_sync(0xffffffffu, x, stride);
    x = (lane & stride) == 0 ? key_min(x, y) : key_max(x, y);
  }
  return x;
}

// The 32 least of two ascending lists (a lane's entry of `x`, and `y`
// read reversed), ascending.
__device__ __forceinline__ uint64_t merge_lists(uint64_t x, const uint64_t* y) {
  return warp_merge(key_min(x, y[31 - (threadIdx.x & 31)]));
}

// Sort keys[0, n) ascending (n a power of two) by the block of kWide threads.
__device__ void bitonic_sort_wide(uint64_t* keys, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += kWide) {
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

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One input row of n elements of `elt` bytes: where it lies in shared
// memory (its region plus the source's offset in 16 bytes, so that the
// interior is 16-byte aligned on both sides) and its interior
// [first, first + bytes) in bytes from the row's start.
struct Row {
  const unsigned char* src;
  unsigned char* at;
  int n, elt;
  uint32_t first, bytes;
};

__device__ __forceinline__ Row row_of(const void* src, int n, int elt, unsigned char* region) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a = (s + 15) & ~static_cast<uintptr_t>(15);
  const uintptr_t e = (s + static_cast<uintptr_t>(n) * elt) & ~static_cast<uintptr_t>(15);
  Row r{static_cast<const unsigned char*>(src), region + (s & 15), n, elt, 0, 0};
  if (n > 0 && e > a) {
    r.first = static_cast<uint32_t>(a - s);
    r.bytes = static_cast<uint32_t>(e - a);
  }
  return r;
}

__device__ __forceinline__ void copy_element(const Row& r, int i) {
  if (r.elt == 4) {
    reinterpret_cast<uint32_t*>(r.at)[i] = __ldg(reinterpret_cast<const uint32_t*>(r.src) + i);
  } else {
    r.at[i] = __ldg(r.src + i);
  }
}

// The row's elements outside its interior, copied by the block's threads.
__device__ __forceinline__ void copy_edges(const Row& r) {
  const int head = r.bytes ? static_cast<int>(r.first) / r.elt : r.n;
  const int tail = r.bytes ? static_cast<int>(r.first + r.bytes) / r.elt : r.n;
  for (int i = threadIdx.x; i < head; i += kWide) copy_element(r, i);
  for (int i = tail + threadIdx.x; i < r.n; i += kWide) copy_element(r, i);
}

// K13's row of the grid (the formula), read where it is used: a
// volatile read is not hoisted, so that it holds no register across the
// passes (the window kernels run at their 64-register bound).
__device__ __forceinline__ int grid_row() {
  unsigned y;
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(y));
  return static_cast<int>(y);
}

// kAllMethods (K13): grid y is the formula, kMethods rows; without it
// the launch is the one-formula kernel it was (its own instance, so
// that its code and registers are untouched).
template <bool kClustered, bool kAllMethods>
__global__ void __launch_bounds__(kWide, 1) epilogue_window(WindowArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bar;
  __shared__ float red[2 * kWideWarps];        // warp partials, two at a time
  __shared__ float part_max[kParts];           // this block's maxima
  __shared__ float tile_nodes[kParts][kSliceTiles];
  __shared__ float bcast[2 * kParts];          // the maxima, then the totals
  __shared__ int valid_count, block_keys, n_gathered, gather_at, need, done;
  __shared__ uint64_t prefix;
  __shared__ uint32_t hist[kBins];
  __shared__ uint32_t scan_sums[kBins / 32];
  __shared__ uint64_t spare[kWideWarps / 2 * 32];  // the merge rounds' other buffer
  __shared__ uint64_t red_keys[kWideWarps];          // the warps' k-th keys
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int cs = kClustered ? a.cluster : 1;
  const int b = blockIdx.x / cs, r = blockIdx.x % cs;
  const int v = a.v, slice = a.slice;
  const int lo = r * slice;
  const int len = max(0, min(slice, v - lo));
  const int64_t row = static_cast<int64_t>(b) * v + lo;
  const Part qn = a.part[0], qa = a.part[1];
  // K13: row 0's blocks alone write the weights, the scores and n_valid
  // (`leads`); each block writes its row of the window's [M, k] top-k
  // (`out_row`).
  const auto leads = [] { return !kAllMethods || grid_row() == 0; };
  const auto out_row = [b] {
    return kAllMethods ? static_cast<int64_t>(b) * kMethods + grid_row() : static_cast<int64_t>(b);
  };
  stamp(a.stamps, 0);
  // The window's counts, loaded while the slice arrives.
  const int ops_n_i = __ldg(qn.n_ops + b), ops_a_i = __ldg(qa.n_ops + b);
  const int len_n_i = __ldg(qn.n_traces + b), len_a_i = __ldg(qa.n_traces + b);
  uint64_t* lists = reinterpret_cast<uint64_t*>(smem);  // kSmemKeys keys
  unsigned char* region = smem + kSmemKeys * 8;
  const int64_t rb4 = row_bytes(slice, 4), rb1 = row_bytes(slice, 1);
  const Row rows[kInputs] = {
      row_of(qn.sv + row, len, 4, region),
      row_of(qa.sv + row, len, 4, region + rb4),
      row_of(qn.cov_unique + row, len, 4, region + 2 * rb4),
      row_of(qa.cov_unique + row, len, 4, region + 3 * rb4),
      row_of(qn.op_present + row, len, 1, region + 4 * rb4),
      row_of(qa.op_present + row, len, 1, region + 4 * rb4 + rb1),
  };
  float* sv_n = reinterpret_cast<float*>(rows[0].at);  // sv, then score, then the canonical scores
  float* sv_a = reinterpret_cast<float*>(rows[1].at);  // sv, then score
  const int32_t* cov_n = reinterpret_cast<const int32_t*>(rows[2].at);
  const int32_t* cov_a = reinterpret_cast<const int32_t*>(rows[3].at);
  const uint8_t* pres_n = rows[4].at;
  const uint8_t* pres_a = rows[5].at;

  // The slice into shared memory: the interiors by bulk copies on one
  // mbarrier (thread 0), the edges by the threads.
  const uint32_t bar_at = static_cast<uint32_t>(__cvta_generic_to_shared(&bar));
  if (t == 0) {
    bar_init(bar_at);
    valid_count = block_keys = n_gathered = 0;
  }
  __syncthreads();
  if (t == 0) {
    uint32_t total = 0;
#pragma unroll
    for (int i = 0; i < kInputs; ++i) total += rows[i].bytes;
    bar_expect(bar_at, total);
#pragma unroll
    for (int i = 0; i < kInputs; ++i) {
      if (rows[i].bytes) {
        bulk_copy(static_cast<uint32_t>(__cvta_generic_to_shared(rows[i].at + rows[i].first)),
                  rows[i].src + rows[i].first, rows[i].bytes, bar_at);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kInputs; ++i) copy_edges(rows[i]);
  bar_wait(bar_at, 0);
  __syncthreads();
  stamp(a.stamps, 1);

  // The maxima of both partitions over the window (NaN wins).
  float mn = neg_inf(), ma = neg_inf();
  for (int i = t; i < len; i += kWide) {
    mn = nan_max(mn, sv_n[i]);
    ma = nan_max(ma, sv_a[i]);
  }
  for (int o = 16; o > 0; o >>= 1) {
    mn = nan_max(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    ma = nan_max(ma, __shfl_xor_sync(0xffffffffu, ma, o));
  }
  if (lane == 0) {
    red[warp] = mn;
    red[kWideWarps + warp] = ma;
  }
  __syncthreads();
  if (warp == 0) {
    mn = red[lane];
    ma = red[kWideWarps + lane];
    for (int o = 16; o > 0; o >>= 1) {
      mn = nan_max(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      ma = nan_max(ma, __shfl_xor_sync(0xffffffffu, ma, o));
    }
    if (lane == 0) {
      part_max[0] = mn;
      part_max[1] = ma;
    }
  }
  cluster_sync<kClustered>();
  if (t < kParts) {
    float m = neg_inf();
    for (int rank = 0; rank < cs; ++rank) m = nan_max(m, peer<kClustered>(part_max, rank)[t]);
    bcast[t] = m;
  }
  __syncthreads();
  stamp(a.stamps, 2);

  // The scores (kept in place of sv, and written out), then the tree of
  // the present scores: this block's tile nodes, then the window's.
  const float m_n = bcast[0], m_a = bcast[1];
  for (int i = t; i < len; i += kWide) {
    const float s_n = f_div(sv_n[i], m_n), s_a = f_div(sv_a[i], m_a);
    sv_n[i] = s_n;
    sv_a[i] = s_a;
    if (leads()) {
      qn.score[row + i] = s_n;
      qa.score[row + i] = s_a;
    }
  }
  __syncthreads();
  const int tiles_here = (len + kTile - 1) / kTile;
  for (int j = 0; j < tiles_here; ++j) {
    const int count = min(kTile, len - j * kTile);
    float xn[kQuad], xa[kQuad];
#pragma unroll
    for (int i = 0; i < kQuad; ++i) {
      const int e = j * kTile + kQuad * t + i;
      const bool in = kQuad * t + i < count;
      xn[i] = in && pres_n[e] ? sv_n[e] : 0.0f;
      xa[i] = in && pres_a[e] ? sv_a[e] : 0.0f;
    }
    float node_n = 0.0f, node_a = 0.0f;
    mr_tree::wide_tree2(xn, xa, count, red, node_n, node_a);
    if (t == 0) {
      tile_nodes[0][j] = node_n;
      tile_nodes[1][j] = node_a;
    }
  }
  stamp(a.stamps, 3);
  cluster_sync<kClustered>();
  if (warp < kParts) {
    // Tile g of the window is tile g % per of block g / per.
    const int used = (v + kTile - 1) / kTile;
    const int per = (slice + kTile - 1) / kTile;
    float x = 0.0f;
    if (lane < used) x = peer<kClustered>(&tile_nodes[warp][0], lane / per)[lane % per];
    x = mr_tree::warp_tree(x, used, 1);
    if (lane == 0) bcast[kParts + warp] = x;
  }
  __syncthreads();
  stamp(a.stamps, 4);

  // Weights, counters, the formula; each op's canonical score, in place
  // of its normal score.
  const float total_n = bcast[kParts], total_a = bcast[kParts + 1];
  const float ops_n = __int2float_rn(ops_n_i), ops_a = __int2float_rn(ops_a_i);
  const float len_n = __int2float_rn(len_n_i), len_a = __int2float_rn(len_a_i);
  const float eps = a.eps;
  int valid_here = 0;
  for (int i = t; i < len; i += kWide) {
    const float w_n = f_div(f_mul(sv_n[i], total_n), ops_n);
    const float w_a = f_div(f_mul(sv_a[i], total_a), ops_a);
    if (leads()) {
      qn.weight[row + i] = w_n;
      qa.weight[row + i] = w_a;
    }
    const bool in_a = pres_a[i], in_n = pres_n[i];
    const float c_a = __int2float_rn(cov_a[i]);
    const float c_n = __int2float_rn(cov_n[i]);
    const float ef = in_a ? f_mul(w_a, c_a) : eps;
    const float nf = in_a ? f_mul(w_a, f_sub(len_a, c_a)) : eps;
    const float ep = in_a ? (in_n ? f_mul(w_n, c_n) : eps) : f_mul(f_add(1.0f, w_n), c_n);
    const float np = in_a ? (in_n ? f_mul(w_n, f_sub(len_n, c_n)) : eps) : f_sub(len_n, c_n);
    const bool valid = in_a || in_n;
    const float s = valid ? formula(kAllMethods ? grid_row() : a.method, ef, nf, ep, np)
                          : neg_inf();
    sv_n[i] = f_add(s, 0.0f);
    valid_here += valid;
  }
  valid_here = __reduce_add_sync(0xffffffffu, valid_here);
  if (lane == 0 && valid_here) atomicAdd(&valid_count, valid_here);
  __syncthreads();
  stamp(a.stamps, 5);
  float* scores = sv_n;

  if (a.k <= kWarpK) {
    // Each warp's 32 least keys, sorted across its lanes: first its
    // first batch (a key a thread), sorted.
    uint64_t mine = warp_sort(t < len ? sort_key(scores[t], lo + t) : ~0ull);
    // The block's bound: the least of the warps' k-th keys. Some warp
    // holds k keys at or below it, so no key above it is among the k
    // least; the other batches' keys at or below it (and below the
    // warp's own k-th) are staged, 32 at a time, in the warp's slots of
    // `lists` and merged into its list.
    const uint64_t warp_kth = __shfl_sync(0xffffffffu, mine, a.k - 1);
    if (lane == 0) red_keys[warp] = warp_kth;
    __syncthreads();
    uint64_t bound = red_keys[lane];
    for (int o = 16; o > 0; o >>= 1) bound = key_min(bound, __shfl_xor_sync(0xffffffffu, bound, o));
    uint64_t* stage = lists + warp * 32;
    int staged = 0;
    for (int base = kWide; base < len; base += kWide) {
      const int i = base + t;
      const uint64_t key = i < len ? sort_key(scores[i], lo + i) : ~0ull;
      const uint64_t below = key_min(bound, __shfl_sync(0xffffffffu, mine, a.k - 1));
      const bool keep = i < len && key <= below;
      const uint32_t kept = __ballot_sync(0xffffffffu, keep);
      const int at = staged + __popc(kept & ((1u << lane) - 1));
      if (keep && at < 32) stage[at] = key;
      staged += __popc(kept);
      if (staged >= 32) {
        __syncwarp();
        const uint64_t batch = warp_sort(stage[lane]);
        mine = warp_merge(key_min(mine, __shfl_sync(0xffffffffu, batch, 31 - lane)));
        __syncwarp();
        if (keep && at >= 32) stage[at - 32] = key;
        staged -= 32;
        __syncwarp();
      }
    }
    if (staged > 0) {
      __syncwarp();
      const uint64_t batch = warp_sort(lane < staged ? stage[lane] : ~0ull);
      mine = warp_merge(key_min(mine, __shfl_sync(0xffffffffu, batch, 31 - lane)));
      __syncwarp();
    }
    lists[warp * 32 + lane] = mine;
    __syncthreads();
    // The warps' lists merged pairwise, each round into the other buffer
    // (a round reads only lists the round before wrote): the block's 32
    // least in from[0, 32).
    uint64_t* from = lists;
    uint64_t* to = spare;
    for (int n = kWideWarps / 2; n >= 1; n /= 2) {
      if (warp < n) {
        to[warp * 32 + lane] = merge_lists(from[2 * warp * 32 + lane], from + (2 * warp + 1) * 32);
      }
      __syncthreads();
      uint64_t* done_round = to;
      to = from;
      from = done_round;
    }
    stamp(a.stamps, 6);
    cluster_sync<kClustered>();
    if (r == 0 && warp == 0) {
      uint64_t best = from[lane];
      for (int rank = 1; rank < cs; ++rank) best = merge_lists(best, peer<kClustered>(from, rank));
      if (lane < a.k) {
        const int idx = static_cast<int>(static_cast<uint32_t>(best));
        const int64_t out = out_row() * a.k;
        a.top_idx[out + lane] = idx;
        a.top_scores[out + lane] = peer<kClustered>(scores, idx / slice)[idx % slice];
      }
    }
  } else {
    // Radix select: the prefix of the keys that holds exactly the k
    // smallest, 8 bits a pass from the top, over the cluster's slices.
    uint64_t pre = 0;
    int want = a.k, shift = 56;
    for (;; shift -= 8) {
      if (t < kBins) hist[t] = 0;
      __syncthreads();
      for (int base = 0; base < len; base += kWide) {
        const int i = base + t;
        bool in = false;
        uint32_t digit = 0;
        if (i < len) {
          const uint64_t key = sort_key(scores[i], lo + i);
          in = shift == 56 || (key >> (shift + 8)) == (pre >> (shift + 8));
          digit = static_cast<uint32_t>(key >> shift) & (kBins - 1);
        }
        // The warp's lanes of one digit add once (a lane left out
        // matches no other).
        const uint32_t peers = __match_any_sync(0xffffffffu, in ? digit : kBins + lane);
        if (in && __ffs(peers) - 1 == lane) atomicAdd(&hist[digit], __popc(peers));
      }
      cluster_sync<kClustered>();
      uint32_t h = 0, incl = 0;
      if (t < kBins) {
        for (int rank = 0; rank < cs; ++rank) h += peer<kClustered>(hist, rank)[t];
        incl = h;
        for (int o = 1; o < 32; o <<= 1) {
          const uint32_t up = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += up;
        }
        if (lane == 31) scan_sums[warp] = incl;
      }
      __syncthreads();
      if (t < kBins) {
        for (int w = 0; w < warp; ++w) incl += scan_sums[w];
        const uint32_t excl = incl - h;
        const uint32_t wanted = static_cast<uint32_t>(want);
        if (excl < wanted && wanted <= incl) {  // the bin that holds the k-th key
          prefix = pre | (static_cast<uint64_t>(t) << shift);
          need = static_cast<int>(wanted - excl);
          done = h == wanted - excl;  // the whole bin is wanted
        }
      }
      cluster_sync<kClustered>();  // every peer's histogram read; the bin seen
      pre = prefix;
      want = need;
      if (done || shift == 0) break;
    }
    // The k keys at or below the prefix, gathered to block 0 (its shared
    // memory, or the window's scratch), each block at its own offset.
    stamp(a.stamps, 6);
    const uint64_t top = pre >> shift;
    int mine = 0;
    for (int i = t; i < len; i += kWide) mine += (sort_key(scores[i], lo + i) >> shift) <= top;
    mine = __reduce_add_sync(0xffffffffu, mine);
    if (lane == 0 && mine) atomicAdd(&block_keys, mine);
    cluster_sync<kClustered>();
    if (t == 0) {
      int at = 0;
      for (int rank = 0; rank < r; ++rank) at += *peer<kClustered>(&block_keys, rank);
      gather_at = at;
    }
    __syncthreads();
    const bool in_smem = a.k_pad <= kSmemKeys;
    uint64_t* keys = in_smem ? peer<kClustered>(lists, 0) : a.keys + out_row() * a.k_pad;
    for (int i = t; i < len; i += kWide) {
      const uint64_t key = sort_key(scores[i], lo + i);
      if ((key >> shift) <= top) keys[gather_at + atomicAdd(&n_gathered, 1)] = key;
    }
    cluster_sync<kClustered>();
    if (r == 0) {
      if (in_smem) keys = lists;
      for (int j = a.k + t; j < a.k_pad; j += kWide) keys[j] = ~0ull;
      __syncthreads();
      bitonic_sort_wide(keys, a.k_pad);
      const int64_t out = out_row() * a.k;
      for (int j = t; j < a.k; j += kWide) {
        const int idx = static_cast<int>(static_cast<uint32_t>(keys[j]));
        a.top_idx[out + j] = idx;
        a.top_scores[out + j] = peer<kClustered>(scores, idx / slice)[idx % slice];
      }
    }
  }
  if (r == 0 && t == 0) {
    int total = 0;
    for (int rank = 0; rank < cs; ++rank) total += *peer<kClustered>(&valid_count, rank);
    if (leads()) a.n_valid[b] = min(total, a.k);
    stamp(a.stamps, 7);
  }
  if constexpr (kClustered) cg::this_cluster().sync();  // block 0 is done reading its peers
  if (a.check != nullptr && r == 0) {
    __syncthreads();  // the top-k and n_valid written
    if (warp == 0) {
      check_window(a.check, a.top_scores, a.n_valid, a.residuals, a.n_iters, a.iters, b, a.k);
    }
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

template <bool kClustered, bool kAllMethods>
cudaError_t allow_slice(int bytes) {
  return cudaFuncSetAttribute(
      reinterpret_cast<const void*>(epilogue_window<kClustered, kAllMethods>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Every window kernel may take a full slice's shared memory.
cudaError_t allow_slices() {
  const int bytes = static_cast<int>(window_smem(kSliceMax));
  cudaError_t e = allow_slice<false, false>(bytes);
  if (e == cudaSuccess) e = allow_slice<true, false>(bytes);
  if (e == cudaSuccess) e = allow_slice<false, true>(bytes);
  if (e == cudaSuccess) e = allow_slice<true, true>(bytes);
  return e;
}

// The argument block of mr_rank_epilogue_launch (int64 words;
// ops/epilogue.py ARGS packs it): for the normal then the abnormal
// partition, sv, op_present, cov_unique, n_traces, n_ops, weight, score;
// then the fields below (scores and nodes: the first design's scratch;
// stamps: kStamps int64 for the window form's phase cycles, or null;
// check, residuals, n_iters and iters: K14's check words, or null, and
// the residual trace it checks, or null; method_rows: 1, the formula
// `method`, or kMethods, every formula (K13; unchecked only)).
enum Word {
  kPartWords = 7,
  kScores = kParts * kPartWords, kNodes, kKeys, kTopIdx, kTopScores, kNValid, kStampsAt,
  kCheckAt, kResidualsAt, kNItersAt, kIters,
  kWindows, kV, kK, kKPad, kMethod, kMethodRows, kEpsBits, kForm, kCluster, kSlice, kSmem,
  kDevice, kStream,
  kWords
};

}  // namespace

extern "C" {

// What the epilogue kernels get on `device`: out[0] the SM count,
// out[1] kSliceMax, out[2] the most blocks a window's cluster may have
// (the largest of 8, 4, 2 of which the card holds one cluster at a full
// slice's shared memory, else 1), out[3] kWarpK, out[4] kSmemKeys,
// out[5] kTile, out[6] the words of an argument block, out[7] kStamps.
// Returns the CUDA
// error code of the queries.
int mr_rank_epilogue_config(int device, int32_t* out) {
  cudaError_t e = use_device(device);
  int sms = 0, cluster_max = 1;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) e = allow_slices();
  for (int c = kClusterMax; e == cudaSuccess && c > 1 && cluster_max == 1; c /= 2) {
    cudaLaunchConfig_t config{};
    config.gridDim = dim3(c);
    config.blockDim = dim3(kWide);
    config.dynamicSmemBytes = static_cast<size_t>(window_smem(kSliceMax));
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, epilogue_window<true, false>, &config);
    if (e == cudaSuccess && clusters > 0) cluster_max = c;
  }
  out[0] = sms;
  out[1] = kSliceMax;
  out[2] = cluster_max;
  out[3] = kWarpK;
  out[4] = kSmemKeys;
  out[5] = kTile;
  out[6] = kWords;
  out[7] = kStamps;
  return static_cast<int>(e);
}

// One launch of the epilogue for `windows` windows in the form the host
// planned (ops/epilogue.py `epilogue_plan`), checked here again, on the
// block's stream. `k_pad` is the least power of two >= k; 1 <= k <= v.
// Returns the CUDA error code of the launch (0 = launched); allocates
// nothing and does not synchronize.
int mr_rank_epilogue_launch(const int64_t* w) {
  const auto ptr = [w](int i) { return reinterpret_cast<void*>(static_cast<uintptr_t>(w[i])); };
  const int64_t windows = w[kWindows], v = w[kV], k = w[kK], k_pad = w[kKPad];
  const int64_t method = w[kMethod], methods = w[kMethodRows], form = w[kForm];
  const int64_t cluster = w[kCluster];
  const int64_t slice = w[kSlice], smem = w[kSmem];
  const int64_t tiles = (v + kTile - 1) / kTile;
  if (windows < 1 || windows > 65535 || v < 1 || tiles > mr_tree::kMaxTiles || k < 1 || k > v
      || k_pad < k || (k_pad & (k_pad - 1)) != 0 || method < 0 || method >= kMethods
      || (k_pad > kSmemKeys && ptr(kKeys) == nullptr) || w[kIters] < 0
      || (ptr(kResidualsAt) != nullptr && (ptr(kCheckAt) == nullptr || ptr(kNItersAt) == nullptr))
      || (methods != 1 && methods != kMethods) || (methods != 1 && ptr(kCheckAt) != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Part parts[kParts];
  for (int p = 0; p < kParts; ++p) {
    const int o = kPartWords * p;
    parts[p] = Part{static_cast<const float*>(ptr(o)), static_cast<const uint8_t*>(ptr(o + 1)),
                    static_cast<const int32_t*>(ptr(o + 2)), static_cast<const int32_t*>(ptr(o + 3)),
                    static_cast<const int32_t*>(ptr(o + 4)), static_cast<float*>(ptr(o + 5)),
                    static_cast<float*>(ptr(o + 6))};
  }
  const uint32_t eps_bits = static_cast<uint32_t>(w[kEpsBits]);
  float eps;
  std::memcpy(&eps, &eps_bits, sizeof(eps));
  const auto stream = static_cast<cudaStream_t>(ptr(kStream));
  const cudaError_t set = use_device(static_cast<int>(w[kDevice]));
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaError_t launched = cudaSuccess;
  if (form == kFormFirst) {
    if ((tiles > 1 && ptr(kNodes) == nullptr) || ptr(kScores) == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    EpilogueArgs a{};
    a.part[0] = parts[0];
    a.part[1] = parts[1];
    a.v = static_cast<int32_t>(v);
    a.k = static_cast<int32_t>(k);
    a.k_pad = static_cast<int32_t>(k_pad);
    a.method = static_cast<int32_t>(method);
    a.methods = static_cast<int32_t>(methods);
    a.tiles = static_cast<int32_t>(tiles);
    a.eps = eps;
    a.scores = static_cast<float*>(ptr(kScores));
    a.nodes = static_cast<float*>(ptr(kNodes));
    a.keys = static_cast<uint64_t*>(ptr(kKeys));
    a.top_idx = static_cast<int32_t*>(ptr(kTopIdx));
    a.top_scores = static_cast<float*>(ptr(kTopScores));
    a.n_valid = static_cast<int32_t*>(ptr(kNValid));
    a.check = static_cast<int32_t*>(ptr(kCheckAt));
    a.residuals = static_cast<const float*>(ptr(kResidualsAt));
    a.n_iters = static_cast<const int32_t*>(ptr(kNItersAt));
    a.iters = static_cast<int32_t>(w[kIters]);
    epilogue_first<<<dim3(static_cast<unsigned>(windows), static_cast<unsigned>(methods)), kThreads,
                     0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  // A block a window holds the whole vocabulary; a cluster of a power of
  // two blocks holds slices of whole tiles that cover it (its last
  // blocks may hold none).
  const bool block = form == kFormBlock && cluster == 1 && slice == v;
  const bool clustered = form == kFormCluster && cluster >= 2 && cluster <= kClusterMax
                         && (cluster & (cluster - 1)) == 0 && slice % kTile == 0
                         && slice * cluster >= v && v > kSliceMax;
  if ((!block && !clustered) || slice > kSliceMax || smem != window_smem(slice)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  WindowArgs a{};
  a.part[0] = parts[0];
  a.part[1] = parts[1];
  a.v = static_cast<int32_t>(v);
  a.k = static_cast<int32_t>(k);
  a.k_pad = static_cast<int32_t>(k_pad);
  a.method = static_cast<int32_t>(method);
  a.slice = static_cast<int32_t>(slice);
  a.cluster = static_cast<int32_t>(cluster);
  a.eps = eps;
  a.keys = static_cast<uint64_t*>(ptr(kKeys));
  a.top_idx = static_cast<int32_t*>(ptr(kTopIdx));
  a.top_scores = static_cast<float*>(ptr(kTopScores));
  a.n_valid = static_cast<int32_t*>(ptr(kNValid));
  a.stamps = static_cast<int64_t*>(ptr(kStampsAt));
  a.check = static_cast<int32_t*>(ptr(kCheckAt));
  a.residuals = static_cast<const float*>(ptr(kResidualsAt));
  a.n_iters = static_cast<const int32_t*>(ptr(kNItersAt));
  a.iters = static_cast<int32_t>(w[kIters]);
  if (smem > 48 * 1024) {
    static int allowed = -1;  // the device whose attributes are set
    const int device = static_cast<int>(w[kDevice]);
    if (allowed != device) {
      launched = allow_slices();
      if (launched != cudaSuccess) return static_cast<int>(launched);
      allowed = device;
    }
  }
  const dim3 grid(static_cast<unsigned>(windows * cluster), static_cast<unsigned>(methods));
  const bool all = methods == kMethods;
  if (block) {
    if (all) {
      epilogue_window<false, true><<<grid, kWide, static_cast<size_t>(smem), stream>>>(a);
    } else {
      epilogue_window<false, false><<<grid, kWide, static_cast<size_t>(smem), stream>>>(a);
    }
  } else {
    cudaLaunchConfig_t config{};
    config.gridDim = grid;
    config.blockDim = dim3(kWide);
    config.dynamicSmemBytes = static_cast<size_t>(smem);
    config.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    launched = all ? cudaLaunchKernelEx(&config, epilogue_window<true, true>, a)
                   : cudaLaunchKernelEx(&config, epilogue_window<true, false>, a);
  }
  if (launched != cudaSuccess) {
    cudaGetLastError();  // clear the refusal; it is reported here
    return static_cast<int>(launched);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* mr_rank_epilogue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
