// Quantile-sketch compaction, sort -> prefix sum -> bucket, for Hopper
// (sm_90a), bound with ctypes.
//
// Replaces: metrics_tpu/ops/qsketch_pallas.py::_make_sort_bucket_kernel
// (driven by qsketch_sort_bucket_tiled), the TPU's VMEM-resident bitonic
// network, Hillis-Steele prefix sum and k1 bucket map. For [n, cols] sketch
// rows (column 0 the weight, column 1 the key, the rest payload), padded with
// zero rows to n_pad = the next power of two, it computes:
//
//   order   the stable ascending sort of the keys, rows of weight <= 0 (or
//           NaN) keyed +inf, ties broken by row index; -0.0 sorts as +0.0
//           and every NaN key after +inf (the order of jnp.lexsort);
//   cum     the inclusive prefix sum of the sorted weights sw, total its last;
//   bucket  clip(floor(scale * asin(2q - 1)) + capacity/4 + 1, 0,
//           capacity/2 + 3) with q = clip((cum - sw/2) / max(total, 1e-30),
//           0, 1) and scale = capacity / 2pi (passed in, rounded to float);
//   wvals   the weighted rows [sw, sw * row[1:]] of the sorted rows;
//   perm    the sorted rows' original indices (pad rows have index >= n).
//
// K1 (segment_sum.cu) then merges wvals by bucket into centroids.
//
// Every float operation is one correctly rounded IEEE operation in the
// order of the plain version (metrics_tpu_torch/ops/qsketch.py), written
// with the _rn intrinsics so that nvcc contracts nothing into an FMA; asin
// is evaluated in double and rounded to float, as the plain version does,
// so the card and the CPU give the same bucket ids. With integer weights
// (a sketch's weights are counts) every prefix sum is exact below 2**24,
// and wvals, bucket and perm are bit-identical to the plain version's.
//
// What bounds it on this card: at the sketch's shapes ([16384, 3] for the
// binary default, [16384, 2002] for 1000 classes) bytes would take 0.1 us
// and 80 us, but the sort is a chain of dependent steps. The design:
//  * Keys only. Each row's key becomes an order-preserving uint32 (sign
//    flipped for positives, all bits for negatives), packed with the row
//    index into a unique uint64, so the sort is on 8 bytes a row and needs
//    no stability. The payload moves once, by gather, at the end. The
//    network and the key map are bitonic.cuh's, shared with row_topk.cu.
//  * Up to 16384 rows (the binary default: n_pad = 2 * 8192): one block of
//    1024 threads sorts all keys with a bitonic network in 128 KB of dynamic
//    shared memory. Beyond that, blocks sort 16384-row runs the same way and
//    the network's remaining stages run as global compare-exchange passes
//    (strides >= 16384) and in-block merges (strides < 16384): any n_pad a
//    sketch produces takes the kernel.
//  * Prefix sum and bucket map: one block; each thread sums a contiguous
//    slice in order, a Hillis-Steele scan over the 1024 slice sums gives each
//    slice its offset, then each thread walks its slice again. A sketch holds
//    at most capacity rows, so one block suffices for what this path sees.
//  * The gather runs over (row, column) pairs, so 3 columns and 2002 columns
//    are the same kernel.
// The kernels launch on the caller's stream and allocate nothing; the Python
// wrapper allocates outputs and scratch and checks devices, dtypes, shapes.

#include <cuda_runtime.h>
#include <math.h>

#include "bitonic.cuh"

namespace {

using bitonic::kRun;
using bitonic::kThreads;
constexpr unsigned int kPlusInf = 0xff800000u;  // the ordered form of +inf

__device__ __forceinline__ unsigned long long sort_key(const float* __restrict__ rows, long long n, int cols,
                                                       long long i) {
  unsigned int ord = kPlusInf;  // pad rows have weight 0: key +inf
  if (i < n) {
    const float w = rows[i * cols];
    const float key = rows[i * cols + 1];
    if (!(w > 0.0f)) {
      ord = kPlusInf;
    } else if (key != key) {
      ord = 0xffffffffu;  // every NaN after +inf
    } else {
      ord = bitonic::ascending_bits(key);
    }
  }
  return ((unsigned long long)ord << 32) | (unsigned long long)(unsigned int)i;
}

// Stages k = 2 .. run of the bitonic network over one run of `run` keys;
// the direction of each pair follows the global index, so the runs come out
// sorted in the alternating directions the later stages expect.
__global__ void __launch_bounds__(kThreads)
    sort_runs_kernel(const float* __restrict__ rows, long long n, int cols, unsigned long long* __restrict__ keys,
                     int run) {
  extern __shared__ unsigned long long s[];
  const long long base = (long long)blockIdx.x * run;
  for (int t = threadIdx.x; t < run; t += blockDim.x) s[t] = sort_key(rows, n, cols, base + t);
  __syncthreads();
  bitonic::sort_run(s, run, base);
  for (int t = threadIdx.x; t < run; t += blockDim.x) keys[base + t] = s[t];
}

// One compare-exchange pass of stage k at a stride j >= run, over all keys.
__global__ void merge_global_kernel(unsigned long long* __restrict__ keys, long long n_pad, long long k, long long j) {
  bitonic::global_pass(keys, n_pad, k, j, (long long)blockIdx.x * blockDim.x + threadIdx.x,
                       (long long)gridDim.x * blockDim.x);
}

// The strides j < run of stage k > run, inside each run.
__global__ void __launch_bounds__(kThreads)
    merge_runs_kernel(unsigned long long* __restrict__ keys, int run, long long k) {
  extern __shared__ unsigned long long s[];
  const long long base = (long long)blockIdx.x * run;
  bitonic::merge_run(keys + base, s, run, base, k);
}

// Sorted weights, their prefix sum and the bucket of each sorted row; one
// block. Writes perm and column 0 of wvals (the sorted weights).
__global__ void __launch_bounds__(kThreads)
    scan_bucket_kernel(const float* __restrict__ rows, long long n, int cols,
                       const unsigned long long* __restrict__ keys, long long n_pad, int capacity, float scale,
                       int* __restrict__ perm, float* __restrict__ wvals, int* __restrict__ bucket) {
  __shared__ float part[kThreads];
  const long long per = (n_pad + kThreads - 1) / kThreads;
  const long long lo = (long long)threadIdx.x * per;
  const long long hi = lo + per < n_pad ? lo + per : n_pad;

  float sum = 0.0f;
  for (long long r = lo; r < hi; ++r) {
    const long long idx = (long long)(unsigned int)(keys[r] & 0xffffffffull);
    const float w = idx < n ? rows[idx * cols] : 0.0f;
    perm[r] = (int)idx;
    wvals[r * cols] = w;
    sum = __fadd_rn(sum, w);
  }
  part[threadIdx.x] = sum;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {  // inclusive scan of the slice sums
    const float left = threadIdx.x >= off ? part[threadIdx.x - off] : 0.0f;
    __syncthreads();
    if (threadIdx.x >= off) part[threadIdx.x] = __fadd_rn(left, part[threadIdx.x]);
    __syncthreads();
  }
  float total = part[kThreads - 1];
  total = total < 1e-30f ? 1e-30f : total;  // NaN stays NaN, as torch.clamp keeps it
  const int n_seg = capacity / 2 + 4;
  const int shift = capacity / 4 + 1;
  float cum = threadIdx.x > 0 ? part[threadIdx.x - 1] : 0.0f;
  for (long long r = lo; r < hi; ++r) {
    const float w = wvals[r * cols];
    cum = __fadd_rn(cum, w);
    float q = __fdiv_rn(__fsub_rn(cum, __fmul_rn(w, 0.5f)), total);
    q = q < 0.0f ? 0.0f : (q > 1.0f ? 1.0f : q);
    const float s = __double2float_rn(asin((double)__fsub_rn(__fmul_rn(2.0f, q), 1.0f)));
    int b = (int)floorf(__fmul_rn(scale, s)) + shift;
    b = b < 0 ? 0 : (b > n_seg - 1 ? n_seg - 1 : b);
    bucket[r] = b;
  }
}

// wvals[r, c] = sw[r] * rows[perm[r], c] for the payload columns c >= 1.
__global__ void gather_rows_kernel(const float* __restrict__ rows, long long n, int cols, const int* __restrict__ perm,
                                   long long n_pad, float* __restrict__ wvals) {
  const int width = cols - 1;
  const long long count = n_pad * width;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < count; e += stride) {
    const long long r = e / width;
    const int c = 1 + (int)(e - r * width);
    const long long idx = perm[r];
    const float v = idx < n ? rows[idx * cols + c] : 0.0f;
    wvals[r * cols + c] = __fmul_rn(wvals[r * cols], v);
  }
}

int grid_for(long long work, int threads) {
  long long blocks = (work + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond 32 blocks per SM
  return (int)blocks;
}

}  // namespace

extern "C" {

// keys: n_pad uint64 of scratch; perm: n_pad int32; wvals: [n_pad, cols]
// float32; bucket: n_pad int32. n_pad is a power of two >= max(n, 2).
int qsketch_sort_bucket_f32(const void* rows, long long n, int cols, long long n_pad, int capacity, float scale,
                            void* keys, void* perm, void* wvals, void* bucket, void* stream) {
  if (n < 0 || cols < 2 || capacity < 1 || n_pad < 2 || n_pad < n || (n_pad & (n_pad - 1)) != 0 ||
      n_pad > (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const float* r = (const float*)rows;
  unsigned long long* k64 = (unsigned long long*)keys;
  const int run = n_pad < kRun ? (int)n_pad : kRun;
  const size_t smem = (size_t)run * sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(sort_runs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(merge_runs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;

  const unsigned runs = (unsigned)(n_pad / run);
  sort_runs_kernel<<<runs, kThreads, smem, st>>>(r, n, cols, k64, run);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (long long k = 2LL * run; k <= n_pad; k <<= 1) {
    for (long long j = k >> 1; j >= run; j >>= 1) {
      merge_global_kernel<<<grid_for(n_pad / 2, 256), 256, 0, st>>>(k64, n_pad, k, j);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    merge_runs_kernel<<<runs, kThreads, smem, st>>>(k64, run, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  scan_bucket_kernel<<<1, kThreads, 0, st>>>(r, n, cols, k64, n_pad, capacity, scale, (int*)perm, (float*)wvals,
                                              (int*)bucket);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  gather_rows_kernel<<<grid_for(n_pad * (cols - 1), 256), 256, 0, st>>>(r, n, cols, (const int*)perm, n_pad,
                                                                         (float*)wvals);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
