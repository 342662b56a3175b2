// K5 on Hopper: the elementwise tail of one power-iteration step, both
// partitions in one cooperative launch.
//
// Replaces the body of the iteration driver that XLA compiled for the
// TPU in microrank_tpu/rank_backends/jax_tpu.py: `_partition_step`
// (859) and the step / `part_delta` / residual body of
// `window_weights_full` (1260), with the `tol` freeze of its while_loop.
// There XLA fused the whole loop into one program; the port had issued
// it as about 38 small PyTorch ops per step (ops/step.py
// `power_step_plain`, which this kernel repeats bit for bit). Per
// partition p, from the step's products y_sr = p_sr @ rv, y_ss = p_ss @
// sv, y_rs = p_rs @ sv (K1, the pcsr kernel, or the pattern pair and K1):
//
//   sv' = d * (y_sr + alpha * y_ss)
//   rv' = d * y_rs + (1 - d) * pref
//   sv' /= max(sv'), rv' /= max(rv')          (normalize, the default)
//   residual[p, step] = max(max|sv' - sv|, max|rv' - rv|)
//
// and, with tol, the freeze of JAX's while_loop as the port runs it
// (every step issued, none branching on a device value): carry =
// running ? new : old, the residual 0 when not running, n_iters +=
// running, running &= max(residual[:, step]) > tol. On the kind route
// with int8 operands it also takes the next step's four quantization
// scales from the vectors it writes (`amax` below).
//
// The design (`step_grid<S>`, one launch a step):
// * The grid is sized to the card, not to the data: at most the blocks
//   that fit on every SM at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
//   times the SM count), fewer where the window is small. It is
//   launched with cudaLaunchCooperativeKernel, so every block is
//   resident and a grid-wide barrier is safe. Each vector (rv_n, sv_n,
//   rv_a, sv_a) owns a run of blocks, each block a contiguous chunk of
//   `per_thread` x kThreads elements, each thread the elements first +
//   k * kThreads of its block's chunk.
// * The kernel is instantiated for the slots a thread uses, S of 1, 2,
//   4, 8 and kSlots (12), the least that holds per_thread: no thread
//   runs a slot it does not hold (the config-5 windows take S = 1, the
//   2M-span giant window 4, the 10M-span one 12 of its 20 elements).
// * Phase 1: each thread computes the unnormalized sv' / rv' of its
//   first S elements into registers (`u`), every load issued before any
//   is used (predicated, no branch between them), and folds the block's
//   maximum into the vector's slot by an integer atomicMax on an
//   order-preserving key of the float (`key`). Up to
//   kRegisterCarrySlots slots it loads the carry in (`old`, for the
//   residual and the freeze) and the int8 weights into registers in the
//   same pass; past them it stages the carry in into shared memory by
//   cp.async, in flight through phase 1 and the barrier.
// * One grid barrier (cooperative_groups' grid sync), when normalizing;
//   then the divisions, apart.
// * Phase 2: the same threads write the carry and fold the residual
//   (and the int8 operands' amax): they read neither the products nor
//   pref again. Each block's thread 0 folds its maxima and arrives by
//   one acq_rel add; the last to arrive reads every slot at once,
//   writes residual[:, step], n_iters, running and the scales, and
//   resets the slots.
// * A window whose elements exceed the slots of the grid (per_thread >
//   kSlots) runs in the same kernel and launch: past the slots, each
//   phase recomputes its elements from the products (read again from
//   the L2). The 10M-span giant window (2,625,536 elements, 20 a thread
//   on an H100's 528 blocks) keeps 12 in registers and recomputes 8.
//
// * A group of B stacked windows (run(batch_windows=True),
//   dispatch_batch_windows) is 2B partitions on one cooperative grid, a
//   kernel of its own (`step_grid_group`): each vector is [B, n], cut
//   into units of 256 elements window by window, and the blocks walk
//   the units, recomputing each from the products in both phases (no
//   value held across the barrier: a group's windows are small, so its
//   step is latency, not bytes; and the single window's kernel keeps
//   its registers, which a window axis in it made spill). The scratch
//   holds a maximum per vector and window and a residual per partition
//   and window, 2B of each kind (`vec_slot`, `res_slot`), and on the int8
//   route an amax per vector and window (`amax_slot`). Each window has
//   its own running flag and n_iters, so with tol a window freezes on
//   its own step while its group-mates go on, as JAX's vmapped
//   while_loop gives it; the last block finishes the windows, a thread
//   a window, each window's four int8 scales from its own maxima (JAX's
//   `quantize_i8` under vmap: one scale per vector and window, so one
//   window's NaN never reaches another's scale). Every maximum is an
//   integer atomicMax and every value the same arithmetic, so a window's
//   bits do not depend on its group.
//
// The previous design stays beside it for comparison (`step_max`, then
// `step_apply`: two launches a step on a grid sized to the data, the
// products read in both; `mr_power_step_two_launch`). Nothing on the
// main path calls it.
//
// Bitwise to the plain step on the card:
// * rounding: each torch op rounds on its own, so each operation here
//   is a separate __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn in
//   torch's order (1 - d in f32, as torch's rsub of a 0-d f32 tensor;
//   a true division, as torch divides by a 0-d CUDA tensor), never an
//   FMA. alpha, d and tol come by value as the f32 values of the
//   0-d tensors the plain step uses.
// * maxima: the key maps a float to an unsigned integer in its order
//   (-inf lowest, +inf highest) and every NaN to the top, so a NaN
//   anywhere gives NaN (torch.max propagates NaN) and comes back as the
//   canonical NaN, the NaN this card's arithmetic makes. integer
//   atomicMax is exact and order-free: no float atomics feed a score.
// * signs: values may be negative (a user call weight below 0 makes sv'
//   negative). The key orders -0 below +0; torch.max returns either
//   zero when a vector's largest entries are a -0 and +0 tie, by its
//   reduction order. So the kernel is bitwise the plain step wherever
//   a maximum is not such a tie: always with alpha >= 0 (every value is
//   then +0 or above) and for every residual (an absolute value).
// * an empty partition: all its products and pref are 0, the max is 0
//   and 0 / 0 gives NaN everywhere, as the plain step does.
// * int8 scales: scale = amax > 0 ? amax / 127 : 1 with amax = max |x *
//   w| over the carry x the kernel wrote, its product with the weight
//   flushed to 0 when subnormal, as pattern_pair.cu's quantize_amax and
//   ops/pattern.py quantize_scales_plain compute it.
//
// What bounds it: bytes and latency. Per partition it reads y_sr, y_ss,
// sv (V floats each), y_rs, pref, rv (T each) and writes sv', rv': 16
// bytes an element: 99,968 bytes at the collapsed config-5 kind window
// (V = 3,072, T = 96 and 8; 30 ns at 3.35 TB/s) and 42,008,576 bytes at
// the 10M-span giant window (V = 2,048, T = 1,310,720; 12.5 us). The
// fused kernel moves those bytes once (the two-launch design read them twice)
// and pays one launch and one barrier a step, where a small window is
// all latency (times in PERF.md, K5).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (ops/step.py build_command; no --use_fast_math, nvcc's default
// -prec-div=true, no -ftz); bound with ctypes (plain C interface).

#include <cfloat>
#include <climits>
#include <cstdint>
#include <initializer_list>
#include <new>

#include <cooperative_groups.h>
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
// Register slots a thread of the fused kernel holds across the barrier
// (its largest instantiation), and the blocks an SM must hold
// (__launch_bounds__: at most 64 registers a thread at 4). The most
// slots that do not spill at 4 blocks an SM (ptxas, sm_90a): 16, 20 and
// 24 spill 28-32 bytes, and at 5 blocks (48 registers) 12 spill 44.
// step_design_probe.py times the alternatives (PERF.md, K5): at the
// 10M-span window 16, 20 or 24 slots, which hold more of its elements,
// are 4-12% slower a step than 12, and 5 blocks an SM 12% slower.
constexpr int kSlots = 12;
constexpr int kMinBlocksPerSm = 4;
static_assert(kSlots > 8, "grid_kernel's instantiations: 1, 2, 4, 8, kSlots");
// Up to this many slots a thread holds the carry in (and the int8
// weights) in registers too, loaded before the barrier; past it the
// carry in is staged in shared memory by cp.async, so that the slots'
// registers hold the values alone. Both beat reading the carry in by
// __ldg after the barrier (step_design_probe.py: the registers by 3% a
// step at the config-5 kind window, the staging by 18% at the 10M-span
// window).
constexpr int kRegisterCarrySlots = 8;
// The two-launch kernels: elements a thread takes per vector slice, about.
constexpr int kItems = 4;
constexpr int kMaxBlocksPerVec = 1024;
constexpr int kParts = 2;
constexpr int kVecs = 2 * kParts;      // rv_n, sv_n, rv_a, sv_a (ops/step.py order)
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNanKey = 0xffffffffu;

// The scratch, uint32 (ops/step.py STEP_SCRATCH), 0 between steps: the
// four vectors' maxima (keys), the two partitions' residuals (keys),
// the four int8 operands' amax (f32 bits of |x * w|), the arrivals.
enum { kVecMax = 0, kResMax = kVecs, kAmax = kResMax + kParts, kArrivals = kAmax + kVecs,
       kScratch };

// One carried vector: vec 2p is partition p's rv, vec 2p + 1 its sv;
// in a group of B windows each pointer is a [B, n] array, window by
// window.
struct Vec {
  const float* y0;   // rv: y_rs;  sv: y_sr
  const float* y1;   // rv: pref;  sv: y_ss
  const float* old;  // the carry in
  float* out;        // the carry out
  const float* w;    // int8: the next operand's weight (rv: w_len, sv: w_cov), or null
  int64_t n;         // elements of one window
  int32_t first_block;  // the vector's first block (fused kernel: its first unit)
  int32_t blocks;       // its blocks (fused kernel: units of one window)
};

struct StepArgs {
  Vec v[kVecs];
  float alpha;
  float d;
  float tol;
  int32_t normalize;
  int32_t step;
  int32_t n_steps;
  int32_t per_thread;  // the fused kernel: elements a thread takes
  int32_t windows;     // B: the windows of a group (1 for the two-launch kernels)
  int32_t n_units;     // the fused kernel: units of all vectors and windows
  uint32_t* scratch;   // [(2 kVecs + kParts) * B + 1]; kScratch at B = 1
  float* residuals;    // [B, kParts, n_steps]
  int32_t* n_iters;    // [B] with tol, else null
  uint8_t* running;    // bool [B], with tol, else null
  float* scales;       // int8: [B, kVecs] the next step's scales, else null
};

// A float's order as an unsigned integer: negative values by their
// inverted bits, others with the sign bit set; every NaN on top.
__device__ __forceinline__ uint32_t key(float x) {
  const uint32_t b = __float_as_uint(x);
  if (x != x) return kNanKey;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float unkey(uint32_t k) {
  if (k == kNanKey) return __uint_as_float(0x7fffffffu);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ float flush_subnormal(float p) {
  return fabsf(p) < FLT_MIN ? 0.0f : p;
}

// The amax key of a carried value against its int8 weight: the f32
// bits of |x * w|, its subnormal product flushed to 0.
__device__ __forceinline__ uint32_t amax_key(float carry, float w) {
  return __float_as_uint(fabsf(flush_subnormal(__fmul_rn(carry, w))));
}

// The next step's int8 scale from its operand's amax.
__device__ __forceinline__ float scale_of(float am) {
  return am > 0.0f ? __fdiv_rn(am, 127.0f) : 1.0f;
}

// The block's (or unit's) vector: the last whose first block is at or
// before it.
__device__ __forceinline__ int vec_of(const StepArgs& a, int32_t b) {
  int v = 0;
#pragma unroll
  for (int i = 1; i < kVecs; ++i) {
    if (b >= a.v[i].first_block) v = i;
  }
  return v;
}

// A field of vector `vi` by static indices (no local copy of the array).
template <typename T>
__device__ __forceinline__ T field(const StepArgs& a, int vi, T Vec::*f) {
  T r = a.v[0].*f;
#pragma unroll
  for (int i = 1; i < kVecs; ++i) {
    if (vi == i) r = a.v[i].*f;
  }
  return r;
}

// sv' or rv' unnormalized, in the plain step's order of operations.
__device__ __forceinline__ float combine(float y0, float y1, bool is_sv, float alpha, float d,
                                         float one_minus_d) {
  if (is_sv) return __fmul_rn(d, __fadd_rn(y0, __fmul_rn(alpha, y1)));
  return __fadd_rn(__fmul_rn(d, y0), __fmul_rn(one_minus_d, y1));
}

__device__ __forceinline__ float unnormalized(const Vec& v, bool is_sv, float alpha, float d,
                                              float one_minus_d, int64_t i) {
  return combine(__ldg(v.y0 + i), __ldg(v.y1 + i), is_sv, alpha, d, one_minus_d);
}

// The block's maximum of `m` into thread 0's return value.
__device__ __forceinline__ uint32_t block_max(uint32_t m, uint32_t* warp_max) {
  const int t = static_cast<int>(threadIdx.x);
  m = __reduce_max_sync(kFull, m);
  if (t % kWarp == 0) warp_max[t / kWarp] = m;
  __syncthreads();
  uint32_t out = 0u;
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < kWarps; ++i) out = max(out, warp_max[i]);
  }
  return out;
}

// ------------------------------------------------------ fused: the grid

// An asynchronous 4-byte copy from device memory into shared memory
// (cp.async; no register holds it), and the wait for this thread's.
__device__ __forceinline__ void stage(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void staged() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// The scratch slots of a group of B windows (uint32, 0 between steps):
// the vectors' maxima by window, the partitions' residuals by window,
// the int8 operands' amax by window, the arrivals. At B = 1 these are
// the enum's kVecMax, kResMax, kAmax and kArrivals.
__device__ __forceinline__ int vec_slot(int vi, int w) { return w * kVecs + vi; }
__device__ __forceinline__ int res_slot(int p, int w, int n_win) {
  return kVecs * n_win + w * kParts + p;
}
__device__ __forceinline__ int amax_slot(int i, int w, int n_win) {
  return (kVecs + kParts) * n_win + w * kVecs + i;
}
__device__ __forceinline__ int arrivals_slot(int n_win) { return (2 * kVecs + kParts) * n_win; }

// One unit of work: a run of per_thread x kThreads elements of one
// window's vector. Unit u's vector is the last whose first unit is at or
// before u; the vector's units go window by window.
struct Unit {
  int vi;         // the vector
  int w;          // the window
  int64_t first;  // this thread's first element in the vector's [B, n] storage
  int64_t end;    // its elements: first + k * kThreads while k * kThreads < end
};

__device__ __forceinline__ Unit unit_of(const StepArgs& a, int32_t u, int t) {
  Unit U;
  U.vi = vec_of(a, u);
  // 32-bit: the units fit an int32 (mr_step_window_create checks), and a
  // 64-bit division is a call that takes a stack frame.
  const int32_t rel = u - field(a, U.vi, &Vec::first_block);
  const int32_t per_window = field(a, U.vi, &Vec::blocks);
  const int64_t n = field(a, U.vi, &Vec::n);
  U.w = rel / per_window;
  const int64_t all = int64_t{a.per_thread} * kThreads;
  const int64_t start = static_cast<int64_t>(rel - U.w * per_window) * all + t;  // in the window
  const int64_t left = n - start;
  U.end = left < all ? left : all;
  U.first = U.w * n + start;
  return U;
}

// A unit of a group, phase 1: the maximum of its unnormalized values.
__device__ __forceinline__ uint32_t unit_max(const StepArgs& a, const Unit& U,
                                             float one_minus_d) {
  const bool is_sv = U.vi & 1;
  const float* y0 = field(a, U.vi, &Vec::y0) + U.first;
  const float* y1 = field(a, U.vi, &Vec::y1) + U.first;
  uint32_t m = 0u;
  for (int64_t i = 0; i < U.end; i += kThreads) {
    m = max(m, key(combine(__ldg(y0 + i), __ldg(y1 + i), is_sv, a.alpha, a.d, one_minus_d)));
  }
  return m;
}

// A unit of a group, phase 2: its carry written from values recomputed
// from the products, its residual and amax into `res` and `amax`.
__device__ __forceinline__ void unit_apply(const StepArgs& a, const Unit& U, float one_minus_d,
                                           uint32_t& res, uint32_t& amax) {
  const bool is_sv = U.vi & 1;
  const bool run = a.running == nullptr || a.running[U.w] != 0;
  const float mx = a.normalize ? unkey(__ldcg(a.scratch + vec_slot(U.vi, U.w))) : 1.0f;
  const float* y0 = field(a, U.vi, &Vec::y0) + U.first;
  const float* y1 = field(a, U.vi, &Vec::y1) + U.first;
  const float* old = field(a, U.vi, &Vec::old) + U.first;
  float* out = field(a, U.vi, &Vec::out) + U.first;
  const bool scaled = a.scales != nullptr;
  const float* w = scaled ? field(a, U.vi, &Vec::w) + U.first : old;
  for (int64_t i = 0; i < U.end; i += kThreads) {
    const float uu = combine(__ldg(y0 + i), __ldg(y1 + i), is_sv, a.alpha, a.d, one_minus_d);
    const float x = a.normalize ? __fdiv_rn(uu, mx) : uu;
    const float ov = __ldg(old + i);
    res = max(res, key(fabsf(__fsub_rn(x, ov))));
    const float carry = run ? x : ov;
    out[i] = carry;
    if (scaled) amax = max(amax, amax_key(carry, __ldg(w + i)));
  }
}

// The last block's work for window w of n_win: its residuals, n_iters
// and running, its int8 scales (when asked), and its slots reset.
__device__ __forceinline__ void finish_window(const StepArgs& a, int w, int n_win) {
  const bool run = a.running == nullptr || a.running[w] != 0;
  uint32_t rk[kParts];
#pragma unroll
  for (int p = 0; p < kParts; ++p) rk[p] = __ldcg(a.scratch + res_slot(p, w, n_win));
  float r[kParts];
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    r[p] = unkey(rk[p]);
    a.residuals[(static_cast<int64_t>(w) * kParts + p) * a.n_steps + a.step] = run ? r[p] : 0.0f;
  }
  if (a.running != nullptr) {
    const bool nan = r[0] != r[0] || r[1] != r[1];
    a.n_iters[w] += run ? 1 : 0;
    a.running[w] = run && !nan && fmaxf(r[0], r[1]) > a.tol;
  }
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    if (a.scales != nullptr) {
      a.scales[static_cast<int64_t>(w) * kVecs + i] =
          scale_of(__uint_as_float(__ldcg(a.scratch + amax_slot(i, w, n_win))));
    }
    a.scratch[vec_slot(i, w)] = 0u;
    a.scratch[amax_slot(i, w, n_win)] = 0u;
  }
#pragma unroll
  for (int p = 0; p < kParts; ++p) a.scratch[res_slot(p, w, n_win)] = 0u;
}

// The fused step, S slots a thread (the least of 1, 2, 4, 8, kSlots
// that holds per_thread, else kSlots): each vector a run of blocks, each
// thread the elements first + k * kThreads (k < per_thread) of its
// block's chunk.
template <int S>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm) step_grid(StepArgs a) {
  constexpr bool kStaged = S > kRegisterCarrySlots;
  __shared__ float old_s[kStaged ? S * kThreads : 1];
  __shared__ uint32_t warp_max[kWarps];
  const int t = static_cast<int>(threadIdx.x);
  const int b = static_cast<int>(blockIdx.x);
  const int vi = vec_of(a, b);
  const bool is_sv = vi & 1;
  const float one_minus_d = __fsub_rn(1.0f, a.d);
  // Read before this block arrives; the last block rewrites it only
  // after every block has arrived.
  const bool run = a.running == nullptr || *a.running != 0;
  const int per_thread = a.per_thread;
  const int64_t first =
      static_cast<int64_t>(b - field(a, vi, &Vec::first_block)) * kThreads * per_thread + t;
  // This thread's elements: first + k * kThreads while k * kThreads <
  // end; `lim` of them in the slots.
  const int64_t left = field(a, vi, &Vec::n) - first;
  const int64_t all = int64_t{per_thread} * kThreads;
  const int64_t end = left < all ? left : all;
  const int lim = end <= 0 ? 0 : static_cast<int>(end < S * kThreads ? end : S * kThreads);
  const float* y0 = field(a, vi, &Vec::y0) + first;
  const float* y1 = field(a, vi, &Vec::y1) + first;
  const float* old = field(a, vi, &Vec::old) + first;
  float* out = field(a, vi, &Vec::out) + first;
  const bool scaled = a.scales != nullptr;
  const float* w = scaled ? field(a, vi, &Vec::w) + first : old;

  if constexpr (kStaged) {
    // The carry in into shared memory, in flight through phase 1 and
    // the barrier.
#pragma unroll
    for (int k = 0; k < S; ++k) {
      if (k * kThreads < lim) stage(old_s + k * kThreads + t, old + k * kThreads);
    }
  }
  // Phase 1: the unnormalized values into registers (up to
  // kRegisterCarrySlots slots, the carry in and the weights too), every
  // load issued before any is used (predicated, no branch between
  // them), and their maximum.
  float u[S];
  float o[kStaged ? 1 : S];
  float wv[kStaged ? 1 : S];
  uint32_t m = 0u;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const bool ok = k * kThreads < lim;
    const float v0 = ok ? __ldg(y0 + k * kThreads) : 0.0f;
    const float v1 = ok ? __ldg(y1 + k * kThreads) : 0.0f;
    if constexpr (!kStaged) {
      o[k] = ok ? __ldg(old + k * kThreads) : 0.0f;
      wv[k] = ok && scaled ? __ldg(w + k * kThreads) : 0.0f;
    }
    u[k] = combine(v0, v1, is_sv, a.alpha, a.d, one_minus_d);
    m = ok ? max(m, key(u[k])) : m;
  }
  float mx = 1.0f;
  if (a.normalize) {
    // Past the slots: recomputed here and again in phase 2.
    for (int64_t i = int64_t{S} * kThreads; i < end; i += kThreads) {
      m = max(m, key(combine(__ldg(y0 + i), __ldg(y1 + i), is_sv, a.alpha, a.d, one_minus_d)));
    }
    m = block_max(m, warp_max);
    if (t == 0) atomicMax(a.scratch + kVecMax + vi, m);
    cg::this_grid().sync();
    mx = unkey(__ldcg(a.scratch + kVecMax + vi));
    // The divisions apart: phase 2's loads have no branch between them.
#pragma unroll
    for (int k = 0; k < S; ++k) {
      if (k * kThreads < lim) u[k] = __fdiv_rn(u[k], mx);
    }
  }
  if constexpr (kStaged) staged();

  // Phase 2: write the carry, fold the residual and the amax; neither
  // the products nor pref again.
  uint32_t res = 0u;
  uint32_t amax = 0u;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const bool ok = k * kThreads < lim;
    float ok_old, ok_w;
    if constexpr (kStaged) {
      ok_old = ok ? old_s[k * kThreads + t] : 0.0f;
      ok_w = ok && scaled ? __ldg(w + k * kThreads) : 0.0f;
    } else {
      ok_old = o[k];
      ok_w = wv[k];
    }
    res = ok ? max(res, key(fabsf(__fsub_rn(u[k], ok_old)))) : res;
    const float carry = run ? u[k] : ok_old;
    if (ok) out[k * kThreads] = carry;
    amax = ok && scaled ? max(amax, amax_key(carry, ok_w)) : amax;
  }
  for (int64_t i = int64_t{S} * kThreads; i < end; i += kThreads) {
    const float uu = combine(__ldg(y0 + i), __ldg(y1 + i), is_sv, a.alpha, a.d, one_minus_d);
    const float x = a.normalize ? __fdiv_rn(uu, mx) : uu;
    const float ov = __ldg(old + i);
    res = max(res, key(fabsf(__fsub_rn(x, ov))));
    const float carry = run ? x : ov;
    out[i] = carry;
    if (scaled) amax = max(amax, amax_key(carry, __ldg(w + i)));
  }
  __syncthreads();  // warp_max is reused
  res = block_max(res, warp_max);
  __syncthreads();
  amax = block_max(amax, warp_max);
  if (t != 0) return;
  // The block's maxima, then its arrival: one acq_rel add (release of
  // the maxima, and for the last block the acquire of everyone's).
  atomicMax(a.scratch + kResMax + vi / 2, res);
  if (scaled) atomicMax(a.scratch + kAmax + vi, amax);
  cuda::atomic_ref<uint32_t, cuda::thread_scope_device> arrivals(a.scratch[kArrivals]);
  if (arrivals.fetch_add(1u, cuda::memory_order_acq_rel) != gridDim.x - 1) return;
  // The last block: every slot read at once, then written and reset.
  uint32_t rk[kParts];
  uint32_t ak[kVecs];
#pragma unroll
  for (int p = 0; p < kParts; ++p) rk[p] = __ldcg(a.scratch + kResMax + p);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) ak[i] = __ldcg(a.scratch + kAmax + i);
  float r[kParts];
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    r[p] = unkey(rk[p]);
    a.residuals[static_cast<int64_t>(p) * a.n_steps + a.step] = run ? r[p] : 0.0f;
  }
  if (a.running != nullptr) {
    const bool nan = r[0] != r[0] || r[1] != r[1];
    *a.n_iters += run ? 1 : 0;
    *a.running = run && !nan && fmaxf(r[0], r[1]) > a.tol;
  }
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    if (scaled) a.scales[i] = scale_of(__uint_as_float(ak[i]));
    a.scratch[kVecMax + i] = 0u;
    a.scratch[kAmax + i] = 0u;
  }
#pragma unroll
  for (int p = 0; p < kParts; ++p) a.scratch[kResMax + p] = 0u;
  a.scratch[kArrivals] = 0u;
}

// A group of B windows (B > 1): every unit of every window recomputed
// from the products in each phase, no slot held across the barrier (a
// group's windows are small: their step is latency, not bytes). Block b
// runs units b, b + grid, ...: phase 1 their maxima, one grid barrier,
// phase 2 their carry, residuals and amax; the last block to arrive
// finishes the windows, a thread a window.
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm) step_grid_group(StepArgs a) {
  __shared__ uint32_t warp_max[kWarps];
  __shared__ int last;
  const int t = static_cast<int>(threadIdx.x);
  const int32_t b = static_cast<int32_t>(blockIdx.x);
  const int32_t n_blocks = static_cast<int32_t>(gridDim.x);
  const int n_win = a.windows;
  const float one_minus_d = __fsub_rn(1.0f, a.d);
  if (a.normalize) {
    for (int32_t u = b; u < a.n_units; u += n_blocks) {
      const Unit U = unit_of(a, u, t);
      const uint32_t m = block_max(unit_max(a, U, one_minus_d), warp_max);
      if (t == 0) atomicMax(a.scratch + vec_slot(U.vi, U.w), m);
      __syncthreads();  // warp_max is reused
    }
    cg::this_grid().sync();
  }
  const bool scaled = a.scales != nullptr;
  for (int32_t u = b; u < a.n_units; u += n_blocks) {
    const Unit U = unit_of(a, u, t);
    uint32_t res = 0u, amax = 0u;
    unit_apply(a, U, one_minus_d, res, amax);
    res = block_max(res, warp_max);
    __syncthreads();
    amax = block_max(amax, warp_max);
    __syncthreads();
    if (t == 0) {
      atomicMax(a.scratch + res_slot(U.vi / 2, U.w, n_win), res);
      if (scaled) atomicMax(a.scratch + amax_slot(U.vi, U.w, n_win), amax);
    }
  }
  // The block's arrival: one acq_rel add by thread 0 (release of the
  // block's maxima, and for the last block the acquire of everyone's).
  if (t == 0) {
    cuda::atomic_ref<uint32_t, cuda::thread_scope_device> arrivals(
        a.scratch[arrivals_slot(n_win)]);
    last = arrivals.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // the acquire, for the block's other threads too
  for (int w = t; w < n_win; w += kThreads) finish_window(a, w, n_win);
  if (t == 0) a.scratch[arrivals_slot(n_win)] = 0u;
}

// ------------------------------- the previous design: two launches

__global__ void __launch_bounds__(kThreads) step_max(StepArgs a) {
  __shared__ uint32_t warp_max[kWarps];
  const int b = static_cast<int>(blockIdx.x);
  const int vi = vec_of(a, b);
  // The vector's fields by a static index (no local copy of the array).
  Vec v = a.v[0];
#pragma unroll
  for (int i = 1; i < kVecs; ++i) {
    if (vi == i) v = a.v[i];
  }
  const bool is_sv = vi & 1;
  const float one_minus_d = __fsub_rn(1.0f, a.d);
  uint32_t m = 0u;
  const int64_t stride = static_cast<int64_t>(v.blocks) * kThreads;
  for (int64_t i = static_cast<int64_t>(b - v.first_block) * kThreads + threadIdx.x; i < v.n;
       i += stride) {
    m = max(m, key(unnormalized(v, is_sv, a.alpha, a.d, one_minus_d, i)));
  }
  m = block_max(m, warp_max);
  if (threadIdx.x == 0) atomicMax(a.scratch + kVecMax + vi, m);
}

__global__ void __launch_bounds__(kThreads) step_apply(StepArgs a) {
  __shared__ uint32_t warp_max[kWarps];
  __shared__ int last;
  const int t = static_cast<int>(threadIdx.x);
  const int b = static_cast<int>(blockIdx.x);
  const int vi = vec_of(a, b);
  Vec v = a.v[0];
#pragma unroll
  for (int i = 1; i < kVecs; ++i) {
    if (vi == i) v = a.v[i];
  }
  const bool is_sv = vi & 1;
  const float one_minus_d = __fsub_rn(1.0f, a.d);
  // Read before this block arrives; the last block rewrites them only
  // after every block has arrived.
  const bool run = a.running == nullptr || *a.running != 0;
  const float m = unkey(a.scratch[kVecMax + vi]);
  uint32_t res = 0u;
  uint32_t amax = 0u;
  const int64_t stride = static_cast<int64_t>(v.blocks) * kThreads;
  for (int64_t i = static_cast<int64_t>(b - v.first_block) * kThreads + t; i < v.n;
       i += stride) {
    const float u = unnormalized(v, is_sv, a.alpha, a.d, one_minus_d, i);
    const float x = a.normalize ? __fdiv_rn(u, m) : u;
    const float old = __ldg(v.old + i);
    res = max(res, key(fabsf(__fsub_rn(x, old))));
    const float carry = run ? x : old;
    v.out[i] = carry;
    if (v.w != nullptr) {
      amax = max(amax, __float_as_uint(fabsf(flush_subnormal(__fmul_rn(carry, __ldg(v.w + i))))));
    }
  }
  res = block_max(res, warp_max);
  __syncthreads();  // warp_max is reused
  amax = block_max(amax, warp_max);
  if (t == 0) {
    atomicMax(a.scratch + kResMax + vi / 2, res);
    if (v.w != nullptr) atomicMax(a.scratch + kAmax + vi, amax);
    __threadfence();  // release this block's maxima before arriving
    last = atomicAdd(a.scratch + kArrivals, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || t != 0) return;
  __threadfence();  // acquire every block's maxima
  float r[kParts];
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    r[p] = unkey(atomicExch(a.scratch + kResMax + p, 0u));
    a.residuals[static_cast<int64_t>(p) * a.n_steps + a.step] = run ? r[p] : 0.0f;
  }
  if (a.running != nullptr) {
    const bool nan = r[0] != r[0] || r[1] != r[1];
    *a.n_iters += run ? 1 : 0;
    *a.running = run && !nan && fmaxf(r[0], r[1]) > a.tol;
  }
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    a.scratch[kVecMax + i] = 0u;
    const float am = __uint_as_float(atomicExch(a.scratch + kAmax + i, 0u));
    if (a.scales != nullptr) a.scales[i] = am > 0.0f ? __fdiv_rn(am, 127.0f) : 1.0f;
  }
  a.scratch[kArrivals] = 0u;
}


// This library links its own CUDA runtime, whose current device is not
// PyTorch's: make it `device` (a no-op after the first call).
cudaError_t use_device(int device) {
  int current = -1;
  const cudaError_t got = cudaGetDevice(&current);
  if (got == cudaSuccess && current == device) return cudaSuccess;
  return cudaSetDevice(device);
}

// The scalar fields of a step's arguments, checked.
bool fill_scalars(StepArgs& args, float alpha, float d, float tol, int32_t normalize,
                  int32_t n_steps, void* scratch, void* residuals, void* n_iters, void* running) {
  if (scratch == nullptr || residuals == nullptr || n_steps < 1 ||
      (n_iters == nullptr) != (running == nullptr)) {
    return false;
  }
  args.alpha = alpha;
  args.d = d;
  args.tol = tol;
  args.normalize = normalize;
  args.n_steps = n_steps;
  args.scratch = static_cast<uint32_t*>(scratch);
  args.residuals = static_cast<float*>(residuals);
  args.n_iters = static_cast<int32_t*>(n_iters);
  args.running = static_cast<uint8_t*>(running);
  args.windows = 1;
  return true;
}

// The instantiation for per_thread elements a thread: the least S of
// the set that holds them, else kSlots.
template <int S>
const void* grid_fn() {
  return reinterpret_cast<const void*>(step_grid<S>);
}

// A group's kernel (slots 0), or a window's instantiation.
const void* grid_kernel(int64_t per_thread, bool group, int* slots) {
  if (group) return *slots = 0, reinterpret_cast<const void*>(step_grid_group);
  if (per_thread <= 1) return *slots = 1, grid_fn<1>();
  if (per_thread <= 2) return *slots = 2, grid_fn<2>();
  if (per_thread <= 4) return *slots = 4, grid_fn<4>();
  if (per_thread <= 8) return *slots = 8, grid_fn<8>();
  return *slots = kSlots, grid_fn<kSlots>();
}

// One window's step state (ops/step.py StepWindow): the arguments that
// stay, the three carries (0: the window's first, 1 and 2: the two
// buffers the steps alternate between), the kernel's instantiation and
// grid, and the stream.
struct Window {
  StepArgs args;
  float* carry[3][kVecs];
  float* scales;
  const void* kernel;
  int32_t grid;
  int device;
  cudaStream_t stream;
};

enum { kY0, kY1, kOld, kOut, kW, kVecPtrs };                 // mr_power_step_two_launch
enum { kWinPref, kWinCarry0, kWinCarry1, kWinCarry2, kWinW, kWinPtrs };  // mr_step_window_create

}  // namespace

extern "C" {

// What the fused kernel gets on `device`, after setting the carveout of
// its instantiations that stage the carry in shared memory at its
// largest (their occupancy is then what their registers allow): out[0]
// 1 if the device takes a cooperative launch, out[1] the resident
// blocks an SM (kThreads threads each; the least over the
// instantiations and the group's kernel), out[2] the SM count, out[3]
// the register slots a thread (kSlots), out[4] kThreads. Returns the
// CUDA error code of the calls.
int mr_power_step_config(int device, int32_t* out) {
  cudaError_t e = use_device(device);
  int coop = 0, sms = 0, per_sm = INT_MAX;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  for (int64_t per : {int64_t{0}, int64_t{1}, int64_t{2}, int64_t{4}, int64_t{8},
                      int64_t{kSlots}}) {
    int slots = 0, n = 0;
    const void* fn = grid_kernel(per, per == 0, &slots);  // 0: the group's kernel
    if (e == cudaSuccess && slots > kRegisterCarrySlots) {
      e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    }
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads, 0);
    if (n < per_sm) per_sm = n;
  }
  out[0] = coop;
  out[1] = e == cudaSuccess ? per_sm : 0;
  out[2] = sms;
  out[3] = kSlots;
  out[4] = kThreads;
  return static_cast<int>(e);
}

// Set up one window's steps, or a group's of `n_windows` windows of the
// same shapes, once: `ptrs` holds kWinPtrs pointers for each of the four
// vectors in the order rv_n, sv_n, rv_a, sv_a (pref for rv, null for sv;
// the window's first carry; the two carry buffers; the int8 weight,
// null unless `scales` is given), `ns` their lengths in one window
// (>= 1); in a group each is a [n_windows, n] array. `scratch` holds
// (2 kVecs + kParts) * n_windows + 1 uint32 (kScratch for one window),
// zero before the first step; `residuals` [n_windows, kParts, n_steps],
// `n_iters` and `running` [n_windows] (with tol), and `scales`
// [n_windows, kVecs] (the window's or the group's buffer, written by the
// steps that ask for it). The grid takes at
// most `max_blocks` blocks (the caller's cooperative limit; at least one
// a vector). One window: each vector its run of blocks, each thread the
// least per_thread that fits, the instantiation of `step_grid` the least
// slots that hold it. A group: `step_grid_group`, one element a thread,
// each vector its units window by window, the blocks walking them. The
// steps launch on `stream` of `device`. Writes the state's handle to
// `out`; grid, per_thread, the instantiation's slots (0: the group's
// kernel) and the units to `out_grid`. Returns a CUDA error code (0 =
// set up).
int mr_step_window_create(const void* const* ptrs, const int64_t* ns, float alpha, float d,
                          float tol, int32_t normalize, int32_t n_steps, int32_t n_windows,
                          void* scratch, void* residuals, void* n_iters, void* running,
                          void* scales, int device, void* stream, int64_t max_blocks,
                          void** out, int32_t* out_grid) {
  *out = nullptr;
  Window win{};
  if (!fill_scalars(win.args, alpha, d, tol, normalize, n_steps, scratch, residuals, n_iters,
                    running) ||
      max_blocks < kVecs || max_blocks > INT_MAX || n_windows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int64_t total = 0;
  for (int i = 0; i < kVecs; ++i) {
    const void* const* p = ptrs + i * kWinPtrs;
    const bool is_sv = i & 1;
    if (ns[i] < 1 || (p[kWinPref] == nullptr) != is_sv || p[kWinCarry0] == nullptr ||
        p[kWinCarry1] == nullptr || p[kWinCarry2] == nullptr ||
        ((scales != nullptr) != (p[kWinW] != nullptr))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    Vec& v = win.args.v[i];
    v.y1 = static_cast<const float*>(p[kWinPref]);
    v.w = static_cast<const float*>(p[kWinW]);
    v.n = ns[i];
    for (int s = 0; s < 3; ++s) {
      win.carry[s][i] = static_cast<float*>(const_cast<void*>(p[kWinCarry0 + s]));
    }
    total += ns[i] * n_windows;
  }
  auto units_at = [&](int64_t per) {
    int64_t units = 0;
    for (int i = 0; i < kVecs; ++i) units += (ns[i] + kThreads * per - 1) / (kThreads * per);
    return units * n_windows;
  };
  // One window: the least per_thread whose blocks fit the grid. A group:
  // one element a thread, its blocks walking the units.
  int64_t per = 1;
  if (n_windows == 1) {
    const int64_t chunk0 = int64_t{kThreads} * max_blocks;
    per = total / chunk0 > 1 ? total / chunk0 : 1;
    while (units_at(per) > max_blocks) ++per;
  }
  const int64_t units = units_at(per);
  if (per > INT_MAX / kThreads || units > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int32_t first = 0;
  for (int i = 0; i < kVecs; ++i) {
    Vec& v = win.args.v[i];
    v.first_block = first;
    v.blocks = static_cast<int32_t>((v.n + kThreads * per - 1) / (kThreads * per));
    first += v.blocks * n_windows;
  }
  int slots = 0;
  win.kernel = grid_kernel(per, n_windows > 1, &slots);
  win.args.per_thread = static_cast<int32_t>(per);
  win.args.windows = n_windows;
  win.args.n_units = static_cast<int32_t>(units);
  win.scales = static_cast<float*>(scales);
  win.grid = static_cast<int32_t>(units < max_blocks ? units : max_blocks);
  win.device = device;
  win.stream = static_cast<cudaStream_t>(stream);
  Window* h = new (std::nothrow) Window(win);
  if (h == nullptr) return static_cast<int>(cudaErrorMemoryAllocation);
  *out = h;
  out_grid[0] = win.grid;
  out_grid[1] = static_cast<int32_t>(per);
  out_grid[2] = slots;
  out_grid[3] = static_cast<int32_t>(units);
  return 0;
}

void mr_step_window_free(void* handle) { delete static_cast<Window*>(handle); }

// Step `step` of a window set up by mr_step_window_create: one
// cooperative launch of the fused kernel from the step's products of
// both partitions, the carry in `in_slot` (0, 1 or 2) into `out_slot`
// (1 or 2, never in_slot); with `want_scales` the next step's int8
// scales into the window's buffer. Returns the CUDA error code of the
// launch (0 = launched; a grid the card cannot hold resident is
// cudaErrorCooperativeLaunchTooLarge and never runs). Allocates nothing
// and does not synchronize. One window's scratch must not be in flight
// on two streams at once.
int mr_step_window_run(void* handle, const void* y_sr_n, const void* y_ss_n, const void* y_rs_n,
                       const void* y_sr_a, const void* y_ss_a, const void* y_rs_a,
                       int32_t in_slot, int32_t out_slot, int32_t step, int32_t want_scales) {
  const Window* win = static_cast<const Window*>(handle);
  if (win == nullptr || in_slot < 0 || in_slot > 2 || out_slot < 1 || out_slot > 2 ||
      in_slot == out_slot || step < 0 || step >= win->args.n_steps ||
      y_sr_n == nullptr || y_ss_n == nullptr || y_rs_n == nullptr || y_sr_a == nullptr ||
      y_ss_a == nullptr || y_rs_a == nullptr || (want_scales && win->scales == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StepArgs a = win->args;
  a.v[0].y0 = static_cast<const float*>(y_rs_n);
  a.v[1].y0 = static_cast<const float*>(y_sr_n);
  a.v[1].y1 = static_cast<const float*>(y_ss_n);
  a.v[2].y0 = static_cast<const float*>(y_rs_a);
  a.v[3].y0 = static_cast<const float*>(y_sr_a);
  a.v[3].y1 = static_cast<const float*>(y_ss_a);
  for (int i = 0; i < kVecs; ++i) {
    a.v[i].old = win->carry[in_slot][i];
    a.v[i].out = win->carry[out_slot][i];
  }
  a.step = step;
  a.scales = want_scales ? win->scales : nullptr;
  const cudaError_t set = use_device(win->device);
  if (set != cudaSuccess) return static_cast<int>(set);
  void* params[] = {&a};
  const cudaError_t launched = cudaLaunchCooperativeKernel(
      win->kernel, dim3(static_cast<unsigned>(win->grid)), dim3(kThreads), params, 0,
      win->stream);
  if (launched != cudaSuccess) {
    cudaGetLastError();  // clear the refusal; it is reported here
    return static_cast<int>(launched);
  }
  return static_cast<int>(cudaGetLastError());
}

// The previous design, kept for comparison: one step's tail for both
// partitions on `stream` (PyTorch's current stream of `device`): launch
// A (`step_max`) when `normalize`, then launch B (`step_apply`).
// `vec_ptrs` holds kVecPtrs device pointers for each of the four
// vectors in the order rv_n, sv_n, rv_a, sv_a (y0, y1, old, out, w; w
// null unless `scales` is given), `ns` their lengths (>= 1). `scratch`
// is kScratch uint32, zero before the first step; B's last block leaves
// it zero again. `residuals` is float32 [2, n_steps], of which column
// `step` is written; `n_iters` (int32) and `running` (bool) are updated
// in place when given (with tol), both or neither. `scales`, when given,
// receives the next step's four int8 scales. Returns the CUDA error code
// of the launches (0 = launched). Allocates nothing and does not
// synchronize.
int mr_power_step_two_launch(const void* const* vec_ptrs, const int64_t* ns, float alpha,
                             float d, float tol, int32_t normalize, int32_t step,
                             int32_t n_steps, void* scratch, void* residuals, void* n_iters,
                             void* running, void* scales, int device, void* stream) {
  StepArgs args{};
  if (!fill_scalars(args, alpha, d, tol, normalize, n_steps, scratch, residuals, n_iters,
                    running) ||
      step < 0 || step >= n_steps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int32_t blocks = 0;
  for (int i = 0; i < kVecs; ++i) {
    const void* const* p = vec_ptrs + i * kVecPtrs;
    if (ns[i] < 1 || p[kY0] == nullptr || p[kY1] == nullptr || p[kOld] == nullptr ||
        p[kOut] == nullptr || ((scales != nullptr) != (p[kW] != nullptr))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    Vec& v = args.v[i];
    v.y0 = static_cast<const float*>(p[kY0]);
    v.y1 = static_cast<const float*>(p[kY1]);
    v.old = static_cast<const float*>(p[kOld]);
    v.out = static_cast<float*>(const_cast<void*>(p[kOut]));
    v.w = static_cast<const float*>(p[kW]);
    v.n = ns[i];
    const int64_t want = (ns[i] + int64_t{kThreads} * kItems - 1) / (int64_t{kThreads} * kItems);
    v.blocks = static_cast<int32_t>(want > kMaxBlocksPerVec ? kMaxBlocksPerVec : want);
    v.first_block = blocks;
    blocks += v.blocks;
  }
  args.step = step;
  args.scales = static_cast<float*>(scales);
  const cudaError_t set = use_device(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (normalize) {
    step_max<<<grid, kThreads, 0, s>>>(args);
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return static_cast<int>(launched);
  }
  step_apply<<<grid, kThreads, 0, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}

const char* mr_power_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
