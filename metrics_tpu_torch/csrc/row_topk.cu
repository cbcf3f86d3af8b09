// Per-row top-k with payload and validity gathered, for Hopper (sm_90a),
// bound with ctypes.
//
// Replaces: metrics_tpu/ops/topk_pallas.py::row_topk_tiled (body
// _make_topk_kernel, network _row_bitonic_desc), the TPU's VMEM-resident
// bitonic network over 8-row tiles. For [R, N] float32 preds, payload and
// valid it writes three [R, k] outputs, k <= N:
//
//   keys     the row's keys where(valid > 0, preds, -inf), in the order of
//            a stable descending sort: ties to the lower column, -0.0 tied
//            with +0.0, every NaN (whatever its sign) after -inf, NaNs in
//            column order -- the permutation of argsort(-key, stable=True)
//            and of the JAX package's _row_topk_jnp;
//   payload  payload[r, col] of each selected column;
//   valid    valid[r, col] likewise (an invalid slot keeps its own payload
//            and validity value).
//
// A key is written as it was read, so its bits (NaN payloads, the sign of
// zero) are those of the input.
//
// `rows` (optional, [R] bytes) masks whole rows: a block whose row is not
// set writes (-inf, 0, 0) and returns. The retrieval table passes its
// overflowing rows, so that the few rows that compact sort and the others
// cost one read of a byte.
//
// What bounds it on this card: the bytes are the active rows' three [N]
// inputs read once and three [k] outputs written once (at the table's
// insert, [2048, 2176] with about 7 active rows, under a tenth of a
// microsecond), but a bitonic network is a chain of log2(n)^2/2 dependent
// stages. The design (the network and the key map are bitonic.cuh's):
//  * Keys only. Each key becomes an order-preserving uint32 (descending:
//    the complement of the ascending map), packed with its column into a
//    unique uint64, so the network needs no stability and moves 8 bytes a
//    slot; payload and validity are gathered by column at the end. Pad
//    columns (n <= c < n_pad) pack after every real column, NaN included.
//  * n_pad <= 16384 (128 KB of dynamic shared memory): one block per row
//    sorts its keys in shared memory and writes its k outputs.
//  * Wider rows: blocks sort 16384-key runs of a row the same way into a
//    global scratch [R, n_pad] uint64, the network's remaining stages run
//    as global compare-exchange passes (strides >= 16384) and in-block
//    merges (strides < 16384), and a last pass gathers the outputs. Any N
//    takes the kernel; there is no shape route.
// The kernels launch on the caller's stream and allocate nothing; the Python
// wrapper allocates outputs and scratch and checks devices, dtypes, shapes.

#include <cuda_runtime.h>

#include "bitonic.cuh"

namespace {

using bitonic::kRun;
using bitonic::kThreads;

// Descending-order key of one slot: smaller sorts first.
__device__ __forceinline__ unsigned long long slot_key(const float* __restrict__ preds,
                                                       const float* __restrict__ valid, long long row, long long n,
                                                       long long c) {
  unsigned int desc = 0xffffffffu;  // NaN keys and pad columns: last
  if (c < n) {
    const long long at = row * n + c;
    const float key = valid[at] > 0.0f ? preds[at] : -__int_as_float(0x7f800000);
    // never 0xffffffff for a number: that would be a NaN's bits
    if (key == key) desc = ~bitonic::ascending_bits(key);
  }
  return ((unsigned long long)desc << 32) | (unsigned long long)(unsigned int)c;
}

__device__ __forceinline__ bool row_active(const unsigned char* __restrict__ rows, long long row) {
  return rows == nullptr || rows[row] != 0;
}

// Output t of a row from its sorted packed key.
__device__ __forceinline__ void write_output(const float* __restrict__ preds, const float* __restrict__ payload,
                                             const float* __restrict__ valid, long long row, long long n, long long k,
                                             long long t, unsigned long long packed, float* __restrict__ out_k,
                                             float* __restrict__ out_p, float* __restrict__ out_v) {
  const long long at = row * n + (long long)(unsigned int)(packed & 0xffffffffull);
  const float v = valid[at];
  out_k[row * k + t] = v > 0.0f ? preds[at] : -__int_as_float(0x7f800000);
  out_p[row * k + t] = payload[at];
  out_v[row * k + t] = v;
}

__device__ __forceinline__ void write_empty(long long row, long long k, float* __restrict__ out_k,
                                            float* __restrict__ out_p, float* __restrict__ out_v) {
  for (long long t = threadIdx.x; t < k; t += blockDim.x) {
    out_k[row * k + t] = -__int_as_float(0x7f800000);
    out_p[row * k + t] = 0.0f;
    out_v[row * k + t] = 0.0f;
  }
}

// n_pad <= kRun: one block per row, the whole sort in shared memory.
__global__ void __launch_bounds__(kThreads)
    topk_block_kernel(const float* __restrict__ preds, const float* __restrict__ payload,
                      const float* __restrict__ valid, const unsigned char* __restrict__ rows, long long n,
                      long long k, int n_pad, float* __restrict__ out_k, float* __restrict__ out_p,
                      float* __restrict__ out_v) {
  extern __shared__ unsigned long long s[];
  const long long row = blockIdx.x;
  if (!row_active(rows, row)) {
    write_empty(row, k, out_k, out_p, out_v);
    return;
  }
  for (int t = threadIdx.x; t < n_pad; t += blockDim.x) s[t] = slot_key(preds, valid, row, n, t);
  __syncthreads();
  bitonic::sort_run(s, n_pad, 0);
  for (long long t = threadIdx.x; t < k; t += blockDim.x) write_output(preds, payload, valid, row, n, k, t, s[t], out_k, out_p, out_v);
}

// Wide rows, step 1: each block sorts one run of one row (grid: rows x runs).
__global__ void __launch_bounds__(kThreads)
    sort_runs_kernel(const float* __restrict__ preds, const float* __restrict__ valid,
                     const unsigned char* __restrict__ rows, long long n, long long n_pad,
                     unsigned long long* __restrict__ keys) {
  extern __shared__ unsigned long long s[];
  const long long row = blockIdx.x;
  if (!row_active(rows, row)) return;
  const long long base = (long long)blockIdx.y * kRun;
  for (int t = threadIdx.x; t < kRun; t += blockDim.x) s[t] = slot_key(preds, valid, row, n, base + t);
  __syncthreads();
  bitonic::sort_run(s, kRun, base);
  unsigned long long* out = keys + row * n_pad + base;
  for (int t = threadIdx.x; t < kRun; t += blockDim.x) out[t] = s[t];
}

// Step 2a: one compare-exchange pass of stage k at a stride j >= kRun, over
// every active row (grid: rows x blocks over the row's pairs).
__global__ void merge_global_kernel(const unsigned char* __restrict__ rows, long long n_pad, long long k, long long j,
                                    unsigned long long* __restrict__ keys) {
  const long long row = blockIdx.x;
  if (!row_active(rows, row)) return;
  bitonic::global_pass(keys + row * n_pad, n_pad, k, j, (long long)blockIdx.y * blockDim.x + threadIdx.x,
                       (long long)gridDim.y * blockDim.x);
}

// Step 2b: the strides j < kRun of stage k > kRun, inside each run.
__global__ void __launch_bounds__(kThreads)
    merge_runs_kernel(const unsigned char* __restrict__ rows, long long n_pad, long long k,
                      unsigned long long* __restrict__ keys) {
  extern __shared__ unsigned long long s[];
  const long long row = blockIdx.x;
  if (!row_active(rows, row)) return;
  const long long base = (long long)blockIdx.y * kRun;
  bitonic::merge_run(keys + row * n_pad + base, s, kRun, base, k);
}

// Step 3: the first k sorted slots of each row (inactive rows: empty).
__global__ void gather_kernel(const float* __restrict__ preds, const float* __restrict__ payload,
                              const float* __restrict__ valid, const unsigned char* __restrict__ rows, long long n,
                              long long k, long long n_pad, const unsigned long long* __restrict__ keys,
                              float* __restrict__ out_k, float* __restrict__ out_p, float* __restrict__ out_v) {
  const long long row = blockIdx.x;
  if (!row_active(rows, row)) {
    write_empty(row, k, out_k, out_p, out_v);
    return;
  }
  for (long long t = threadIdx.x; t < k; t += blockDim.x) {
    write_output(preds, payload, valid, row, n, k, t, keys[row * n_pad + t], out_k, out_p, out_v);
  }
}

}  // namespace

extern "C" {

// preds, payload, valid: [r, n] float32; rows: [r] bytes or NULL (every row);
// out_k, out_p, out_v: [r, k] float32 with 1 <= k <= n. n_pad is the next
// power of two >= max(n, 2); scratch holds r * n_pad uint64 when
// n_pad > 16384 and may be NULL otherwise.
int row_topk_f32(const void* preds, const void* payload, const void* valid, const void* rows, long long r, long long n,
                 long long k, long long n_pad, void* scratch, void* out_k, void* out_p, void* out_v, void* stream) {
  if (r < 1 || r > 0x7fffffffLL || n < 1 || k < 1 || k > n || n_pad < 2 || n_pad < n ||
      (n_pad & (n_pad - 1)) != 0 || n > 0x7fffffffLL || (n_pad > kRun && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const float* p = (const float*)preds;
  const float* pay = (const float*)payload;
  const float* v = (const float*)valid;
  const unsigned char* mask = (const unsigned char*)rows;
  float* ok = (float*)out_k;
  float* op = (float*)out_p;
  float* ov = (float*)out_v;
  cudaError_t err;
  if (n_pad <= kRun) {
    const size_t smem = (size_t)n_pad * sizeof(unsigned long long);
    err = cudaFuncSetAttribute(topk_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int threads = n_pad / 2 < kThreads ? (int)(n_pad / 2 < 32 ? 32 : n_pad / 2) : kThreads;
    topk_block_kernel<<<(unsigned)r, threads, smem, st>>>(p, pay, v, mask, n, k, (int)n_pad, ok, op, ov);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)kRun * sizeof(unsigned long long);
  err = cudaFuncSetAttribute(sort_runs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(merge_runs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  unsigned long long* keys = (unsigned long long*)scratch;
  const long long runs = n_pad / kRun;
  if (runs > 65535) return (int)cudaErrorInvalidValue;
  const dim3 run_grid((unsigned)r, (unsigned)runs);
  sort_runs_kernel<<<run_grid, kThreads, smem, st>>>(p, v, mask, n, n_pad, keys);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long pair_blocks = (n_pad / 2 + 255) / 256 < 1024 ? (n_pad / 2 + 255) / 256 : 1024;
  const dim3 pass_grid((unsigned)r, (unsigned)pair_blocks);
  for (long long k_stage = 2LL * kRun; k_stage <= n_pad; k_stage <<= 1) {
    for (long long j = k_stage >> 1; j >= kRun; j >>= 1) {
      merge_global_kernel<<<pass_grid, 256, 0, st>>>(mask, n_pad, k_stage, j, keys);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    merge_runs_kernel<<<run_grid, kThreads, smem, st>>>(mask, n_pad, k_stage, keys);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int threads = k < kThreads ? (int)(k < 32 ? 32 : k) : kThreads;
  gather_kernel<<<(unsigned)r, threads, 0, st>>>(p, pay, v, mask, n, k, n_pad, keys, ok, op, ov);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
