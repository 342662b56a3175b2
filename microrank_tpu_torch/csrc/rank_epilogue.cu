// K6's epilogue on Hopper: a rank program's finish, spectrum and
// tie-aware top-k, one block a window, in one launch.
//
// Replaces what XLA compiles for the TPU in
// microrank_tpu/rank_backends/jax_tpu.py: :882 `_partition_finish`,
// :971 `spectrum_counters`, :1006 `window_spectrum` with the 13 formulas
// of microrank_tpu/spectrum/formulas.py, :1046 `top_k_tiebroken` and
// :1068 `_finish_topk`. The port had issued them as about 50 small
// PyTorch ops a window, two launches of the fixed-order fold and a
// stable torch.sort (ops/epilogue.py `rank_epilogue_plain`, which this
// kernel repeats bit for bit). For window b, from each partition's
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
// k smallest: a block-wide radix select (256-bin histograms in shared
// memory, 8 bits a pass from the top, integer atomics) finds the
// prefix that holds exactly k keys, usually after one to three passes;
// those keys are gathered and sorted by a bitonic sort (in shared
// memory up to kSmemKeys, else in the window's scratch), and the
// scores written are the bits of s + 0, which is what -(-(s + 0))
// gives.
//
// What bounds it: bytes, and at these sizes a block's latency. Each
// partition's sv, op_present and cov_unique are read and its weight and
// score written once (17 bytes an op). One block a window holds a
// window's order and its sums without a grid barrier; a vocabulary is
// streamed through shared memory in tiles of kTile (the finish's tree)
// and through L2 (the scores), so any V up to kTile * kMaxTiles runs.

#include <cuda_runtime.h>

#include <cstdint>

#include "tree_fold.cuh"

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
  int32_t v, k, k_pad, method, tiles;
  float eps;
  float* scores;               // [B, v] scratch: score + 0, -inf where not valid
  float* nodes;                // [B, 2, tiles] scratch (tiles > 1)
  uint64_t* keys;              // [B, k_pad] scratch (k_pad > kSmemKeys)
  int32_t* top_idx;            // [B, k]
  float* top_scores;           // [B, k]
  int32_t* n_valid;            // [B]
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

__global__ void __launch_bounds__(kThreads) rank_epilogue(EpilogueArgs a) {
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

  // The finish of each partition: its maximum, its scores and the tree
  // of its present scores.
  for (int p = 0; p < kParts; ++p) {
    const Part q = p == 0 ? a.part[0] : a.part[1];
    float m = neg_inf();
    for (int i = t; i < v; i += kThreads) m = nan_max(m, q.sv[row + i]);
    m = block_max(m, warp_vals);
    float* nodes =
        a.tiles > 1 ? a.nodes + (static_cast<int64_t>(b) * kParts + p) * a.tiles : nullptr;
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
          q.score[row + lo + at] = s;
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
  const float ops_n = __int2float_rn(nq.n_ops[b]), ops_a = __int2float_rn(aq.n_ops[b]);
  const float len_n = __int2float_rn(nq.n_traces[b]), len_a = __int2float_rn(aq.n_traces[b]);
  const float eps = a.eps;
  int valid_here = 0;
  for (int i = t; i < v; i += kThreads) {
    const int64_t at = row + i;
    const float w_n = f_div(f_mul(nq.score[at], total_n), ops_n);
    const float w_a = f_div(f_mul(aq.score[at], total_a), ops_a);
    nq.weight[at] = w_n;
    aq.weight[at] = w_a;
    const bool in_a = aq.op_present[at], in_n = nq.op_present[at];
    const float cov_a = __int2float_rn(aq.cov_unique[at]);
    const float cov_n = __int2float_rn(nq.cov_unique[at]);
    const float ef = in_a ? f_mul(w_a, cov_a) : eps;
    const float nf = in_a ? f_mul(w_a, f_sub(len_a, cov_a)) : eps;
    const float ep =
        in_a ? (in_n ? f_mul(w_n, cov_n) : eps) : f_mul(f_add(1.0f, w_n), cov_n);
    const float np = in_a ? (in_n ? f_mul(w_n, f_sub(len_n, cov_n)) : eps) : f_sub(len_n, cov_n);
    const bool valid = in_a || in_n;
    const float s = valid ? formula(a.method, ef, nf, ep, np) : neg_inf();
    a.scores[at] = f_add(s, 0.0f);
    valid_here += valid;
  }
  atomicAdd(&n_valid, valid_here);
  if (t == 0) {
    prefix = 0;
    need = a.k;
    done = 0;
  }
  __syncthreads();
  if (t == 0) a.n_valid[b] = min(n_valid, a.k);

  // Radix select: the prefix of the keys that holds exactly the k
  // smallest, 8 bits a pass from the top.
  int shift = 56;
  for (;; shift -= 8) {
    hist[t] = 0;
    __syncthreads();
    const uint64_t pre = prefix;
    for (int i = t; i < v; i += kThreads) {
      const uint64_t key = sort_key(a.scores[row + i], i);
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
  uint64_t* keys = a.k_pad <= kSmemKeys ? smem_keys : a.keys + static_cast<int64_t>(b) * a.k_pad;
  const uint64_t top = prefix >> shift;
  if (t == 0) n_gathered = 0;
  __syncthreads();
  for (int i = t; i < v; i += kThreads) {
    const uint64_t key = sort_key(a.scores[row + i], i);
    if ((key >> shift) <= top) keys[atomicAdd(&n_gathered, 1)] = key;
  }
  for (int j = a.k + t; j < a.k_pad; j += kThreads) keys[j] = ~0ull;
  __syncthreads();
  bitonic_sort(keys, a.k_pad);
  for (int j = t; j < a.k; j += kThreads) {
    const int idx = static_cast<int>(static_cast<uint32_t>(keys[j]));
    a.top_idx[static_cast<int64_t>(b) * a.k + j] = idx;
    a.top_scores[static_cast<int64_t>(b) * a.k + j] = a.scores[row + idx];
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

// One launch of the epilogue for `windows` windows (a block each) on
// `stream` (PyTorch's current stream of `device`). `ptrs` holds, for the
// normal then the abnormal partition: sv, op_present, cov_unique,
// n_traces, n_ops, weight, score (row-major [windows, v] or [windows]);
// then scores ([windows, v]), nodes ([windows, 2, tiles] where v > 4096,
// else null), keys ([windows, k_pad] uint64 where k_pad > 1024, else
// null), top_idx, top_scores ([windows, k]) and n_valid ([windows]).
// `k_pad` is the least power of two >= k; 1 <= k <= v. Returns the CUDA
// error code of the launch (0 = launched); allocates nothing and does
// not synchronize.
int mr_rank_epilogue(void* const* ptrs, int32_t windows, int32_t v, int32_t k, int32_t k_pad,
                     int32_t method, float eps, int device, void* stream) {
  const int32_t tiles = (v + kTile - 1) / kTile;
  if (windows < 1 || windows > 65535 || v < 1 || k < 1 || k > v || k_pad < k
      || (k_pad & (k_pad - 1)) != 0 || method < 0 || method >= kMethods
      || tiles > mr_tree::kMaxTiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* const* tail = ptrs + 7 * kParts;
  if ((tiles > 1 && tail[1] == nullptr) || (k_pad > kSmemKeys && tail[2] == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  EpilogueArgs a{};
  for (int p = 0; p < kParts; ++p) {
    void* const* q = ptrs + 7 * p;
    a.part[p] = Part{static_cast<const float*>(q[0]), static_cast<const uint8_t*>(q[1]),
                     static_cast<const int32_t*>(q[2]), static_cast<const int32_t*>(q[3]),
                     static_cast<const int32_t*>(q[4]), static_cast<float*>(q[5]),
                     static_cast<float*>(q[6])};
  }
  a.v = v;
  a.k = k;
  a.k_pad = k_pad;
  a.method = method;
  a.tiles = tiles;
  a.eps = eps;
  a.scores = static_cast<float*>(tail[0]);
  a.nodes = static_cast<float*>(tail[1]);
  a.keys = static_cast<uint64_t*>(tail[2]);
  a.top_idx = static_cast<int32_t*>(tail[3]);
  a.top_scores = static_cast<float*>(tail[4]);
  a.n_valid = static_cast<int32_t*>(tail[5]);
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  rank_epilogue<<<static_cast<unsigned>(windows), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* mr_rank_epilogue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
