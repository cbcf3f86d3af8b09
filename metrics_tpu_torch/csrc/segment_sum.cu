// Segment-sum and bincount kernels for Hopper (sm_90a), bound with ctypes.
//
// Replaces: metrics_tpu/ops/scatter_pallas.py::_segment_sum_kernel (driven by
// segment_sum_tiled), the TPU's tiled one-hot matrix product. It computes
// out[s, :] = sum of vals[i, :] over rows i with ids[i] == s; ids outside
// [0, S), negatives included, drop. Its bincount use (unit weights, int32
// counts) is every ConfusionMatrix update.
//
// What bounds it on this card: bytes. Neither function does arithmetic worth
// counting (one add per matched value); the least time is the ids and values
// read once and the output written once over HBM's 3.35 TB/s. At the
// ConfusionMatrix shape (4096 ids, 10^6 bins) that is 4 MB of output, about
// 1.3 us, so a launch (a few us) costs more than the work.
//
// What the design does about it:
//  * bincount_i32: a grid-stride loop over the ids with one int32 atomicAdd
//    per id into the zeroed output. Collisions are rare at 4096 ids over 10^6
//    bins, and integer atomics are exact, so every run gives the same counts.
//    The TPU's one-hot product would touch all B * S (id, bin) pairs; this
//    touches B.
//  * segment_sum_f32: no float atomics, because the JAX package's fused,
//    sliced and windowed bit-parity tests assume runs repeat bit for bit. It is
//    the row-order segment tile of segment_fold.cuh (shared with K2 in
//    segment_extremum.cu): each (segment, column) is summed by one lane in row
//    order, so the result is deterministic and equal bit for bit to a
//    sequential index_add_ on the CPU. The values of a block's rows are
//    staged in shared memory first and a warp folds 32 of them into a
//    register per step, so a segment of many rows (the sketch's pad bucket
//    takes about 4k of 16,384) costs an add a row, not a load.
//  * segment_sum_i32: the same tile over int32 values, for the integer leaves
//    of SlicedMetric (row counters, PSNR's and MSE's `total`). The JAX package
//    sends integer payloads to XLA's exact scatter; its int32 adds wrap modulo
//    2**32, so this kernel adds the bits as uint32. Wrapping adds are
//    associative and commutative, so with few segments its rows split over
//    blocks into partial tiles, which segment_sum_i32_combine_kernel folds.
// The kernels launch on the caller's stream and allocate nothing; the Python
// wrappers allocate outputs (and the partials' scratch) and check devices,
// dtypes and shapes.

#include <cuda_runtime.h>

#include "segment_fold.cuh"

namespace {

template <typename Id>
__global__ void bincount_i32_kernel(const Id* __restrict__ ids, long long n, int* __restrict__ out,
                                    long long minlength) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const long long v = (long long)ids[i];
    if (v >= 0 && v < minlength) atomicAdd(out + v, 1);
  }
}

template <typename Id>
__global__ void __launch_bounds__(segfold::kThreads)
    segment_sum_f32_kernel(const float* __restrict__ vals, const Id* __restrict__ ids, long long b, int d,
                           float* __restrict__ out, long long s, int dc, int sw, long long rows_per_split) {
  segfold::fold_tile<segfold::SumF32, Id>(vals, ids, b, d, out, s, dc, sw, rows_per_split);
}

template <typename Id>
__global__ void __launch_bounds__(segfold::kThreads)
    segment_sum_i32_kernel(const unsigned* __restrict__ vals, const Id* __restrict__ ids, long long b, int d,
                           unsigned* __restrict__ out, long long s, int dc, int sw, long long rows_per_split) {
  segfold::fold_tile<segfold::SumU32, Id>(vals, ids, b, d, out, s, dc, sw, rows_per_split);
}

__global__ void __launch_bounds__(segfold::kThreads)
    segment_sum_i32_combine_kernel(const unsigned* __restrict__ partial, long long cells, int splits,
                                   int lanes, unsigned* __restrict__ out) {
  segfold::combine_splits<segfold::SumU32>(partial, cells, splits, lanes, out);
}

template <typename Id>
int launch_bincount(const void* ids, long long n, void* out, long long minlength, void* stream) {
  if (n < 0 || minlength <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 blocks per SM
  bincount_i32_kernel<Id><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const Id*)ids, n, (int*)out, minlength);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bincount_i32_ids32(const void* ids, long long n, void* out, long long minlength, void* stream) {
  return launch_bincount<int>(ids, n, out, minlength, stream);
}

int bincount_i32_ids64(const void* ids, long long n, void* out, long long minlength, void* stream) {
  return launch_bincount<long long>(ids, n, out, minlength, stream);
}

int segment_sum_f32_ids32(const void* vals, const void* ids, long long b, int d, void* out, long long s, int dc,
                          int sw, long long seg_tiles, int col_chunks, int splits, long long rows_per_split,
                          void* scratch, void* stream) {
  return segfold::launch_fold<segfold::SumF32, int, segment_sum_f32_kernel<int>>(
      nullptr, vals, ids, b, d, out, s, dc, sw, seg_tiles, col_chunks, splits,
      rows_per_split, scratch, stream);
}

int segment_sum_f32_ids64(const void* vals, const void* ids, long long b, int d, void* out, long long s, int dc,
                          int sw, long long seg_tiles, int col_chunks, int splits, long long rows_per_split,
                          void* scratch, void* stream) {
  return segfold::launch_fold<segfold::SumF32, long long, segment_sum_f32_kernel<long long>>(
      nullptr, vals, ids, b, d, out, s, dc, sw, seg_tiles, col_chunks, splits,
      rows_per_split, scratch, stream);
}

int segment_sum_i32_ids32(const void* vals, const void* ids, long long b, int d, void* out, long long s, int dc,
                          int sw, long long seg_tiles, int col_chunks, int splits, long long rows_per_split,
                          void* scratch, void* stream) {
  return segfold::launch_fold<segfold::SumU32, int, segment_sum_i32_kernel<int>>(
      segment_sum_i32_combine_kernel, vals, ids, b, d, out, s, dc, sw, seg_tiles, col_chunks, splits,
      rows_per_split, scratch, stream);
}

int segment_sum_i32_ids64(const void* vals, const void* ids, long long b, int d, void* out, long long s, int dc,
                          int sw, long long seg_tiles, int col_chunks, int splits, long long rows_per_split,
                          void* scratch, void* stream) {
  return segfold::launch_fold<segfold::SumU32, long long, segment_sum_i32_kernel<long long>>(
      segment_sum_i32_combine_kernel, vals, ids, b, d, out, s, dc, sw, seg_tiles, col_chunks, splits,
      rows_per_split, scratch, stream);
}

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
