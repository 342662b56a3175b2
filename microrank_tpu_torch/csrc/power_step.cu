// K5 on Hopper: the elementwise tail of one power-iteration step, both
// partitions in two launches.
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
// Launch A (`step_max`, only when normalizing): each block recomputes
// sv' / rv' for a slice of one vector and folds its maximum into that
// vector's slot by an integer atomicMax on an order-preserving key of
// the float (`key`). Launch B (`step_apply`): each block recomputes the
// same values, divides by the maximum, writes the carry, and folds the
// residual (and the int8 operands' amax) the same way; the last block
// to arrive (the block-level last-arriver pattern of quantize_amax in
// pattern_pair.cu) writes residual[:, step], n_iters, running and the
// scales, and resets every slot and the arrival count for the next
// step. B recomputes the unnormalized vectors from the products instead
// of reading them back from scratch: the same bytes (A would have
// written them, B read them) and no buffer. A cooperative launch with a
// grid-wide barrier would make it one launch; two plain launches need
// no co-residency limit on the grid and were chosen as the simple
// kernel that is right.
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
// bytes an element at least: 99,968 bytes at the collapsed config-5
// kind window (V = 3,072, T = 96 and 8; 30 ns at 3.35 TB/s) and
// 42,008,576 bytes at the 10M-span giant window (V = 2,048, T =
// 1,310,720; 12.5 us). A re-reads the products that B reads again (half
// again the bytes, partly from L2), and the two launches and the last
// arriver's round trip are microseconds of latency that a small window
// cannot hide (times in PERF.md, K5).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (ops/step.py build_command; no --use_fast_math, nvcc's default
// -prec-div=true, no -ftz); bound with ctypes (plain C interface).

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kItems = 4;              // elements a thread takes per vector slice, about
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

// One carried vector: vec 2p is partition p's rv, vec 2p + 1 its sv.
struct Vec {
  const float* y0;   // rv: y_rs;  sv: y_sr
  const float* y1;   // rv: pref;  sv: y_ss
  const float* old;  // the carry in
  float* out;        // the carry out
  const float* w;    // int8: the next operand's weight (rv: w_len, sv: w_cov), or null
  int64_t n;
  int32_t first_block;
  int32_t blocks;
};

struct StepArgs {
  Vec v[kVecs];
  float alpha;
  float d;
  float tol;
  int32_t normalize;
  int32_t step;
  int32_t n_steps;
  uint32_t* scratch;   // [kScratch]
  float* residuals;    // [kParts, n_steps]
  int32_t* n_iters;    // with tol, else null
  uint8_t* running;    // bool, with tol, else null
  float* scales;       // int8: [kVecs] the next step's scales, else null
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

// The block's vector: the last whose first block is at or before it.
__device__ __forceinline__ int vec_of(const StepArgs& a, int b) {
  int v = 0;
#pragma unroll
  for (int i = 1; i < kVecs; ++i) {
    if (b >= a.v[i].first_block) v = i;
  }
  return v;
}

// sv' or rv' unnormalized, in the plain step's order of operations.
__device__ __forceinline__ float unnormalized(const Vec& v, bool is_sv, float alpha, float d,
                                              float one_minus_d, int64_t i) {
  const float y0 = __ldg(v.y0 + i);
  const float y1 = __ldg(v.y1 + i);
  if (is_sv) return __fmul_rn(d, __fadd_rn(y0, __fmul_rn(alpha, y1)));
  return __fadd_rn(__fmul_rn(d, y0), __fmul_rn(one_minus_d, y1));
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

enum { kY0, kY1, kOld, kOut, kW, kVecPtrs };

}  // namespace

extern "C" {

// One power-iteration step's tail for both partitions on `stream`
// (PyTorch's current stream of `device`): launch A when `normalize`,
// then launch B. `vec_ptrs` holds kVecPtrs device pointers for each of
// the four vectors in the order rv_n, sv_n, rv_a, sv_a (y0, y1, old,
// out, w; w null unless `scales` is given), `ns` their lengths (>= 1).
// `scratch` is kScratch uint32, zero before the first step; B's last
// block leaves it zero again. `residuals` is float32 [2, n_steps], of
// which column `step` is written; `n_iters` (int32) and `running`
// (bool) are updated in place when given (with tol), both or neither.
// `scales`, when given, receives the next step's four int8 scales.
// Returns the CUDA error code of the launches (0 = launched). Allocates
// nothing and does not synchronize. One scratch must not be in flight
// on two streams at once.
int mr_power_step(const void* const* vec_ptrs, const int64_t* ns, float alpha, float d,
                  float tol, int32_t normalize, int32_t step, int32_t n_steps, void* scratch,
                  void* residuals, void* n_iters, void* running, void* scales, int device,
                  void* stream) {
  if (scratch == nullptr || residuals == nullptr || step < 0 || step >= n_steps ||
      (n_iters == nullptr) != (running == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StepArgs args{};
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
  args.alpha = alpha;
  args.d = d;
  args.tol = tol;
  args.normalize = normalize;
  args.step = step;
  args.n_steps = n_steps;
  args.scratch = static_cast<uint32_t*>(scratch);
  args.residuals = static_cast<float*>(residuals);
  args.n_iters = static_cast<int32_t*>(n_iters);
  args.running = static_cast<uint8_t*>(running);
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
