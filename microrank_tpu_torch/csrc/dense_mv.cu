// K12 on Hopper: the dense kernel family's products, all six of a
// power-iteration step (p_sr @ rv, p_ss @ sv, p_rs @ sv of both
// partitions, every window of a stacked group) in one launch.
//
// Replaces what XLA compiles for the TPU in
// microrank_tpu/rank_backends/jax_tpu.py:361-403 (kernel="dense" and
// "dense_bf16"): `jnp.dot` of the densified transition matrices
// (`densify` :262, which the port keeps as tensor ops once a window,
// ops/dense.py) with the ranking vectors, on the MXU. "dense_bf16"
// stores the matrices in bf16, rounds the vector to bf16 each step and
// accumulates in f32 (`preferred_element_type=jnp.float32`).
//
// What bounds it on the card: bytes. A row of n columns moves 4n bytes
// (2n in bf16) of matrix for 2n flops against a vector that stays in
// L1 / L2, far below the H100's ratio of flops to bytes; at the
// uncollapsed config-5 window the six matrices are gigabytes, read once
// a step. So the design is a stream: one warp a row, every lane a
// 16-byte load a step of the row (4 f32 or 8 bf16 columns), loaded
// with the streaming hint (__ldcs: read once, not kept in L2, which
// holds the vectors), several loads in flight a lane (the loop is
// unrolled 4 deep; the loads do not depend on the sums).
//
// The order of every sum is a function of the column index alone, so
// two equal rows give bitwise-equal sums (exact score ties survive, as
// the ranking's tie-broken top-k requires) and the plain version in
// ops/dense.py repeats the bits: lane l holds kVec sums, sum j adding
// the products of columns (32 i + l) * kVec + j for i = 0, 1, ... in
// order; the lane then adds its sums 0 + 1 + ... + kVec-1 left to
// right, and the warp folds the lanes by K1's fixed shuffle tree
// (16, 8, 4, 2, 1; csrc/coo_spmv.cu `warp_tree`). No float atomics.
// Each multiply and add rounds alone (__fmul_rn, __fadd_rn: no FMA). A
// row's stride is padded with zero columns to a multiple of 32 * kVec
// (ops/dense.py), so every load is whole and aligned; a column past
// the vector's length reads x as 0. In bf16 the product of two bf16
// values is exact in f32, so only the order of the sums differs from
// XLA's.
//
// Stacked windows: the window is blockIdx.y, each matrix a [B, rows,
// ld] tensor and each vector a [B, n] one; a row's sum is the same
// whatever the group. wgmma and TMA (a matrix-vector product has no
// reuse for the tensor cores) are for a later redesign.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;  // rows a block
constexpr int kMaxMats = 6;
constexpr int kMaxX = 4;
constexpr unsigned kFull = 0xffffffffu;

struct Mat {
  const void* m;        // [B, rows, ld], f32 or bf16
  int64_t win_stride;   // elements from one window's matrix to the next
  int64_t y_off;        // window 0's first output in y
  int32_t rows, cols, ld, x_slot;
};

struct DenseArgs {
  Mat mat[kMaxMats];
  int64_t row_end[kMaxMats];  // a window's rows of matrices 0..m
  const float* x[kMaxX];      // [B, n] each
  int64_t x_stride[kMaxX];    // floats from one window's vector to the next
  float* y;                   // matrix-major: matrix m's [B, rows] at y_off
  int32_t n_mats;
};

__device__ __forceinline__ float warp_tree(float acc) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_down_sync(kFull, acc, off));
  }
  return acc;
}

// torch's float -> bfloat16 (round to nearest even, NaN to 0x7FC0), back
// to float.
__device__ __forceinline__ float round_bf16(float f) {
  if (f != f) return __uint_as_float(0x7FC00000u);
  uint32_t u = __float_as_uint(f);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xFFFF0000u);
}

// x[col, col + kVec), 0 past `cols`: one or two 16-byte loads where the
// whole run is in range and aligned, else one float at a time.
template <int kVec>
__device__ __forceinline__ void load_x(const float* __restrict__ x, int col, int cols,
                                       float* out) {
  if (col + kVec <= cols && (reinterpret_cast<uintptr_t>(x + col) & 15u) == 0) {
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(x + col) + q);
      out[4 * q] = v.x;
      out[4 * q + 1] = v.y;
      out[4 * q + 2] = v.z;
      out[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) out[j] = col + j < cols ? __ldg(x + col + j) : 0.0f;
  }
}

// The kVec matrix values of one 16-byte load.
template <bool kBf16>
__device__ __forceinline__ void unpack(const uint4 raw, float* out) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (kBf16) {
      out[2 * k] = __uint_as_float(w[k] << 16);
      out[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
    } else {
      out[k] = __uint_as_float(w[k]);
    }
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads) dense_mv(DenseArgs a) {
  constexpr int kVec = kBf16 ? 8 : 4;
  constexpr int kElt = kBf16 ? 2 : 4;
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  // This warp's matrix and row (selected by unrolled compares, so the
  // argument block is never indexed at run time).
  Mat mat = a.mat[0];
  int64_t first = 0, end = a.row_end[0];
#pragma unroll
  for (int i = 1; i < kMaxMats; ++i) {
    if (i < a.n_mats && g >= end) {
      mat = a.mat[i];
      first = end;
      end = a.row_end[i];
    }
  }
  if (g >= end) return;
  const int64_t r = g - first;
  const int64_t b = blockIdx.y;
  const float* x = a.x[0];
  int64_t x_stride = a.x_stride[0];
#pragma unroll
  for (int s = 1; s < kMaxX; ++s) {
    if (s == mat.x_slot) {
      x = a.x[s];
      x_stride = a.x_stride[s];
    }
  }
  x += b * x_stride;
  const uint4* row = reinterpret_cast<const uint4*>(
      static_cast<const char*>(mat.m) + (b * mat.win_stride + r * mat.ld) * kElt);
  const int n_iter = mat.ld / (kWarp * kVec);

  float acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
#pragma unroll 4
  for (int it = 0; it < n_iter; ++it) {
    const int at = it * kWarp + lane;
    const uint4 raw = __ldcs(row + at);
    float xv[kVec], mv[kVec];
    load_x<kVec>(x, at * kVec, mat.cols, xv);
    unpack<kBf16>(raw, mv);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float xj = kBf16 ? round_bf16(xv[j]) : xv[j];
      acc[j] = __fadd_rn(acc[j], __fmul_rn(mv[j], xj));
    }
  }
  float sum = acc[0];
#pragma unroll
  for (int j = 1; j < kVec; ++j) sum = __fadd_rn(sum, acc[j]);
  sum = warp_tree(sum);
  if (lane == 0) a.y[mat.y_off + b * mat.rows + r] = sum;
}

// This library links its own CUDA runtime, whose current device is not
// PyTorch's: make it `device` (a no-op after the first call).
cudaError_t use_device(int device) {
  int current = -1;
  const cudaError_t got = cudaGetDevice(&current);
  if (got == cudaSuccess && current == device) return cudaSuccess;
  return cudaSetDevice(device);
}

// The argument block of mr_dense_mv (int64 words; ops/dense.py ARGS
// packs it): for each of kMaxMats matrices its pointer, window stride,
// y offset, rows, columns, row stride (ld) and x slot; the kMaxX x
// pointers and their window strides; then y, the matrices, the
// windows, bf16, the device and the stream.
enum Word {
  kMatWords = 7,
  kXPtrs = kMaxMats * kMatWords,
  kXStrides = kXPtrs + kMaxX,
  kY = kXStrides + kMaxX, kNMats, kWindows, kBf16, kDevice, kStream,
  kWords
};

}  // namespace

extern "C" {

// The words of an argument block (ops/dense.py checks its own against
// it).
int mr_dense_mv_words() { return kWords; }

// One launch of the step's products on `stream`, every window of the
// group: matrix m's row r of window b into y[y_off + b * rows + r].
// Checks the block (each row stride a multiple of 32 x 4 floats or 32
// x 8 bf16, columns within it, 16-byte aligned matrices, x slots in
// range). Returns the CUDA error code of the launch (0 = launched);
// allocates nothing and does not synchronize.
int mr_dense_mv(const int64_t* w) {
  const auto ptr = [w](int i) { return reinterpret_cast<void*>(static_cast<uintptr_t>(w[i])); };
  const int64_t n_mats = w[kNMats], windows = w[kWindows];
  const bool bf16 = w[kBf16] != 0;
  const int64_t vec = bf16 ? 8 : 4, elt = bf16 ? 2 : 4;
  if (n_mats < 1 || n_mats > kMaxMats || windows < 1 || windows > 65535 || ptr(kY) == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DenseArgs a{};
  int64_t total = 0;
  for (int m = 0; m < n_mats; ++m) {
    const int64_t* d = w + kMatWords * m;
    const int64_t rows = d[3], cols = d[4], ld = d[5], slot = d[6];
    if (rows < 0 || rows > INT32_MAX || cols < 0 || ld <= 0 || ld > INT32_MAX || cols > ld
        || ld % (kWarp * vec) != 0 || slot < 0 || slot >= kMaxX
        || (rows > 0 && (ptr(kMatWords * m) == nullptr || ptr(kXPtrs + slot) == nullptr))
        || d[0] % 16 != 0 || (d[1] * elt) % 16 != 0 || d[1] < rows * ld || d[2] < 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.mat[m] = Mat{ptr(kMatWords * m), d[1], d[2], static_cast<int32_t>(rows),
                   static_cast<int32_t>(cols), static_cast<int32_t>(ld),
                   static_cast<int32_t>(slot)};
    total += rows;
    a.row_end[m] = total;
  }
  for (int s = 0; s < kMaxX; ++s) {
    a.x[s] = static_cast<const float*>(ptr(kXPtrs + s));
    a.x_stride[s] = w[kXStrides + s];
  }
  a.y = static_cast<float*>(ptr(kY));
  a.n_mats = static_cast<int32_t>(n_mats);
  if (total == 0) return 0;
  const int64_t blocks = (total + kWarps - 1) / kWarps;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = use_device(static_cast<int>(w[kDevice]));
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(windows));
  const auto stream = static_cast<cudaStream_t>(ptr(kStream));
  if (bf16) {
    dense_mv<true><<<grid, kThreads, 0, stream>>>(a);
  } else {
    dense_mv<false><<<grid, kThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* mr_dense_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
