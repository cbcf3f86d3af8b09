// Segment max and min (K2) for Hopper (sm_90a), bound with ctypes.
//
// Replaces: metrics_tpu/ops/scatter_pallas.py::segment_extremum_tiled (its
// kernel body _make_segment_ext_kernel), the TPU's masked-select fold. It
// computes out[s, :] = max (or min) of vals[i, :] over rows i with
// ids[i] == s, as jax.ops.segment_max/min do: a NaN of either sign anywhere in
// a segment makes that segment NaN; max gives +0.0 over -0.0 and min -0.0 over
// +0.0, in either order; empty segments hold -inf (max) or +inf (min); ids
// outside [0, S), negatives included, drop. Values are float32, ids int32 or
// int64. SlicedMetric folds its max/min leaves (PSNR's max_target and
// min_target) through it, two launches per update.
//
// What bounds it on this card: bytes. A fold is one compare per matched
// value; the least time is the ids and values read once and the output
// written once over HBM's 3.35 TB/s.
//
// What the design does about it: it is the row-order segment tile of
// segment_fold.cuh, the design of segment_sum_f32, with the extremum fold in
// place of the add. A block owns a tile of segments and up to 32 columns in
// shared memory, filled with -inf or +inf; it stages its rows' ids and values
// in shared memory, its warps ballot-scan them, and one lane per column folds
// the matched rows in a register. There are no atomics, so runs repeat bit
// for bit, and the fold is an explicit compare (segfold::MaxF32/MinF32):
// fmaxf/fminf would drop NaN, and a float atomicMax on a totalOrder key would
// rank -NaN lowest. The fold is associative and commutative on the bits, so
// when the segments alone give few blocks (64 segments give 8) the rows split over blocks into partial tiles, which
// segment_max_f32_combine_kernel / segment_min_f32_combine_kernel fold into
// the output: one wrapper call, two launches. The TPU kernel's
// [8, 128, D] masked-select temporary was a workaround for its vector unit
// and is not carried over; the TPU route's limits (D <= 256, S >= 64,
// B >= 256) are gone too: any shape launches.

#include <cuda_runtime.h>

#include "segment_fold.cuh"

namespace {

template <typename Id>
__global__ void __launch_bounds__(segfold::kThreads)
    segment_max_f32_kernel(const float* __restrict__ vals, const Id* __restrict__ ids, long long b, int d,
                           float* __restrict__ out, long long s, int dc, int sw, long long rows_per_split) {
  segfold::fold_tile<segfold::MaxF32, Id>(vals, ids, b, d, out, s, dc, sw, rows_per_split);
}

__global__ void __launch_bounds__(segfold::kThreads)
    segment_max_f32_combine_kernel(const float* __restrict__ partial, long long cells, int splits,
                                   int lanes, float* __restrict__ out) {
  segfold::combine_splits<segfold::MaxF32>(partial, cells, splits, lanes, out);
}

template <typename Id>
__global__ void __launch_bounds__(segfold::kThreads)
    segment_min_f32_kernel(const float* __restrict__ vals, const Id* __restrict__ ids, long long b, int d,
                           float* __restrict__ out, long long s, int dc, int sw, long long rows_per_split) {
  segfold::fold_tile<segfold::MinF32, Id>(vals, ids, b, d, out, s, dc, sw, rows_per_split);
}

__global__ void __launch_bounds__(segfold::kThreads)
    segment_min_f32_combine_kernel(const float* __restrict__ partial, long long cells, int splits,
                                   int lanes, float* __restrict__ out) {
  segfold::combine_splits<segfold::MinF32>(partial, cells, splits, lanes, out);
}

}  // namespace

extern "C" {

int segment_max_f32_ids32(const void* vals, const void* ids, long long b, int d, void* out, long long s, int dc,
                          int sw, long long seg_tiles, int col_chunks, int splits, long long rows_per_split,
                          void* scratch, void* stream) {
  return segfold::launch_fold<segfold::MaxF32, int, segment_max_f32_kernel<int>>(
      segment_max_f32_combine_kernel, vals, ids, b, d, out, s, dc, sw, seg_tiles, col_chunks, splits,
      rows_per_split, scratch, stream);
}

int segment_max_f32_ids64(const void* vals, const void* ids, long long b, int d, void* out, long long s, int dc,
                          int sw, long long seg_tiles, int col_chunks, int splits, long long rows_per_split,
                          void* scratch, void* stream) {
  return segfold::launch_fold<segfold::MaxF32, long long, segment_max_f32_kernel<long long>>(
      segment_max_f32_combine_kernel, vals, ids, b, d, out, s, dc, sw, seg_tiles, col_chunks, splits,
      rows_per_split, scratch, stream);
}

int segment_min_f32_ids32(const void* vals, const void* ids, long long b, int d, void* out, long long s, int dc,
                          int sw, long long seg_tiles, int col_chunks, int splits, long long rows_per_split,
                          void* scratch, void* stream) {
  return segfold::launch_fold<segfold::MinF32, int, segment_min_f32_kernel<int>>(
      segment_min_f32_combine_kernel, vals, ids, b, d, out, s, dc, sw, seg_tiles, col_chunks, splits,
      rows_per_split, scratch, stream);
}

int segment_min_f32_ids64(const void* vals, const void* ids, long long b, int d, void* out, long long s, int dc,
                          int sw, long long seg_tiles, int col_chunks, int splits, long long rows_per_split,
                          void* scratch, void* stream) {
  return segfold::launch_fold<segfold::MinF32, long long, segment_min_f32_kernel<long long>>(
      segment_min_f32_combine_kernel, vals, ids, b, d, out, s, dc, sw, seg_tiles, col_chunks, splits,
      rows_per_split, scratch, stream);
}

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
