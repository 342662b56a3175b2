// K1 on Hopper: the COO segment-sum SpMV of the PageRank power iteration.
//
// Replaces the TPU kernel microrank_tpu/ops/pallas_spmv.py
// `coo_segment_sum_pallas` (body `_spmv_kernel`, wrapper
// `coo_matvec_pallas`): y[r] = sum over entries e with rows[e] == r of
// vals[e] * x[cols[e]]. On the TPU that is an iota one-hot [1024, 2048]
// per block, multiplied on the MXU into a VMEM accumulator carried
// across a sequential grid. Nothing of that carries over: Hopper blocks
// run in parallel and in no order, and a one-hot product spends
// O(E * V) multiply-adds on an O(E) problem.
//
// Design: the wrapper (ops/spmv.py) builds a row-sorted layout once per
// window — a stable sort of the entries by row, so one row's entries
// keep the graph build's order, plus indptr[n_rows + 1] — and every
// power-iteration step launches this kernel on it. One warp owns one
// output row: lane l accumulates positions indptr[r] + l, + l + 32, ...
// in order (the gather vals[p] * x[cols[p]] fused into the loop), then
// a fixed shuffle tree folds the 32 lane sums and lane 0 writes y[r]
// once. There are no atomics, so the sum order is a function of the row
// alone: results are bitwise identical from run to run, and two rows
// with the same value sequence give bitwise-equal sums — exact score
// ties survive, as the ranking's tie-broken top-k requires.
// __fmul_rn / __fadd_rn keep the compiler from contracting the product
// into an FMA, so the plain version in ops/spmv.py can repeat this
// arithmetic exactly.
//
// What bounds it on the card: bytes. Each entry moves 8 bytes (col +
// val) plus a 4-byte gather of x, for 2 flops, far below the ratio of
// the H100's float32 rate to its memory rate. The layout makes the col / val
// reads coalesced (consecutive lanes read consecutive positions) and x
// is small (V or T floats) and stays in L2. What this first design does
// NOT fix: a row of length L takes ceil(L / 32) dependent steps of one
// warp, so an operation present in every trace (a row of length T in
// p_sr) serializes; PERF.md records the resulting time against the
// byte bound.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (ops/spmv.py build_command); bound with ctypes (plain C interface).

#include <cassert>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
coo_spmv_rows(const int32_t* __restrict__ indptr,
              const int32_t* __restrict__ cols,
              const float* __restrict__ vals,
              const float* __restrict__ x,
              float* __restrict__ y,
              int32_t n_rows,
              int32_t n_x) {
  const int32_t row =
      static_cast<int32_t>(blockIdx.x) * kWarpsPerBlock +
      static_cast<int32_t>(threadIdx.x) / kWarp;
  const int lane = static_cast<int>(threadIdx.x) % kWarp;
  // `row` is uniform across a warp, so whole warps leave together and
  // the full-mask shuffles below stay legal.
  if (row >= n_rows) return;
  const int32_t beg = indptr[row];
  const int32_t end = indptr[row + 1];
  float acc = 0.0f;
#pragma unroll 4
  for (int32_t p = beg + lane; p < end; p += kWarp) {
    const int32_t c = cols[p];
    // The graph build pads with col 0, so an out-of-range column is a
    // bug upstream: stop here instead of clamping it silently.
    assert(c >= 0 && c < n_x);
    acc = __fadd_rn(acc, __fmul_rn(vals[p], __ldg(x + c)));
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  }
  if (lane == 0) y[row] = acc;
}

}  // namespace

extern "C" {

// Launches on `stream` (PyTorch's current stream of `device`) and
// returns the CUDA error code of the launch (0 = launched). Allocates
// nothing and does not synchronize. This library links its own CUDA
// runtime, whose current device is not PyTorch's, so it is set here.
int mr_coo_spmv(const int32_t* indptr, const int32_t* cols,
                const float* vals, const float* x, float* y,
                int32_t n_rows, int32_t n_x, int device, void* stream) {
  if (n_rows <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  coo_spmv_rows<<<blocks, kWarp * kWarpsPerBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      indptr, cols, vals, x, y, n_rows, n_x);
  return static_cast<int>(cudaGetLastError());
}

const char* mr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
