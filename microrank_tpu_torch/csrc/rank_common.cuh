// What the rank program's epilogue (rank_epilogue.cu: K6, K13, K14) and
// the explained program's attribution epilogue (explain_epilogue.cu:
// K15) share, so that the two give the same bits: the 13 spectrum
// formulas of spectrum/formulas.py op for op, each op one IEEE operation
// (no contraction), the 64-bit sort key of the tie-aware top-k, and the
// warp's shuffle networks over such keys.

#pragma once

#include <cstdint>

namespace mr_rank {

// The 13 formulas, in the order of ops/epilogue.py METHOD_IDS (which is
// spectrum/formulas.py METHODS).
enum Method {
  kDstar2, kOchiai, kJaccard, kSorensendice, kM1, kM2, kGoodman, kTarantula, kRussellrao,
  kHamann, kDice, kSimplematching, kRogers, kMethods
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

}  // namespace mr_rank
