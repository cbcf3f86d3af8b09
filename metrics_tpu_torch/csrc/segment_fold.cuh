// The row-order segment tile shared by segment_sum.cu (K1's float and int32
// sums) and segment_extremum.cu (K2's max and min).
//
// out[s, c] = fold over the rows i with ids[i] == s, in row order, of
// vals[i, c], starting from the fold's identity; ids outside [0, S),
// negatives included, drop. A block owns a tile of segments and up to 32
// columns in shared memory; each of its 8 warps owns a slice of that tile.
// The block stages the ids in chunks; each warp scans them 32 at a time with
// a ballot and, in row order, its lanes (one per column) fold the matched rows
// into its slice. Each (segment, column) is thus folded by one lane in row
// order, with no atomics: runs repeat bit for bit, and a sum equals a
// sequential index_add_ on the CPU. The tile is written out once, so the
// output needs no initialising. The Python wrappers choose the tile
// (ops/segment_sum.py: segment_sum_geometry) so that about two blocks per SM
// stay in flight when S is small.
#pragma once

#include <cuda_runtime.h>

namespace segfold {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileWords = 10240;  // 40 KB of segment tile (4-byte values)
constexpr int kIdChunk = 1024;     // 4 KB of staged tile-local ids
constexpr unsigned kFullMask = 0xffffffffu;

struct SumF32 {
  using T = float;
  static __device__ __forceinline__ T identity() { return 0.0f; }
  static __device__ __forceinline__ T fold(T acc, T v) { return acc + v; }
};

// int32 sums wrap modulo 2**32, as XLA's int32 scatter-add does: the adds
// are done on the bits as uint32, where overflow is defined.
struct SumU32 {
  using T = unsigned;
  static __device__ __forceinline__ T identity() { return 0u; }
  static __device__ __forceinline__ T fold(T acc, T v) { return acc + v; }
};

// The extremum folds of jax.ops.segment_max/min: a NaN of either sign makes
// the result NaN (the canonical quiet NaN, as torch writes it); max prefers
// +0.0 over -0.0 and min -0.0 over +0.0, in either order. fmaxf/fminf would
// drop NaN, and a float atomicMax on a totalOrder key would rank -NaN lowest.
__device__ __forceinline__ float canonical_nan() { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ bool is_nan(float x) { return (__float_as_uint(x) & 0x7fffffffu) > 0x7f800000u; }
__device__ __forceinline__ bool sign_bit(float x) { return (__float_as_uint(x) >> 31) != 0u; }

struct MaxF32 {
  using T = float;
  static __device__ __forceinline__ T identity() { return -__int_as_float(0x7f800000); }
  static __device__ __forceinline__ T fold(T a, T b) {
    if (is_nan(a) || is_nan(b)) return canonical_nan();
    return (a > b || (a == b && !sign_bit(a))) ? a : b;
  }
};

struct MinF32 {
  using T = float;
  static __device__ __forceinline__ T identity() { return __int_as_float(0x7f800000); }
  static __device__ __forceinline__ T fold(T a, T b) {
    if (is_nan(a) || is_nan(b)) return canonical_nan();
    return (a < b || (a == b && sign_bit(a))) ? a : b;
  }
};

// One block's tile: segments [blockIdx.x * 8 * sw, ...) and columns
// [blockIdx.y * dc, ...). Called by each source's __global__ kernel, so that
// every kernel keeps a name of its own in a profile.
template <typename Op, typename Id>
__device__ __forceinline__ void fold_tile(const typename Op::T* __restrict__ vals, const Id* __restrict__ ids,
                                          long long b, int d, typename Op::T* __restrict__ out, long long s,
                                          int dc, int sw) {
  using T = typename Op::T;
  __shared__ T tile[kTileWords];
  __shared__ int local[kIdChunk];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int seg_tile = kWarps * sw;  // segments owned by this block
  const long long lo = (long long)blockIdx.x * seg_tile;
  const int c0 = blockIdx.y * dc;
  const int cols = min(dc, d - c0);
  const int wlo = warp * sw;  // this warp's slice of the tile: [wlo, wlo + sw)
  const int whi = wlo + sw;

  for (int i = threadIdx.x; i < seg_tile * dc; i += kThreads) tile[i] = Op::identity();

  for (long long base = 0; base < b; base += kIdChunk) {
    const int n = (int)min((long long)kIdChunk, b - base);
    __syncthreads();  // the previous chunk is consumed (and the tile set)
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const long long t = (long long)ids[base + i] - lo;
      local[i] = (t >= 0 && t < seg_tile && lo + t < s) ? (int)t : -1;
    }
    __syncthreads();
    for (int r0 = 0; r0 < n; r0 += 32) {
      const int t = (r0 + lane < n) ? local[r0 + lane] : -1;
      unsigned mine = __ballot_sync(kFullMask, t >= wlo && t < whi);
      while (mine) {  // matched rows in ascending row order
        const int k = __ffs(mine) - 1;
        mine &= mine - 1;
        const int tk = __shfl_sync(kFullMask, t, k);
        if (lane < cols) {
          T* cell = tile + tk * dc + lane;
          *cell = Op::fold(*cell, vals[(base + r0 + k) * d + c0 + lane]);
        }
      }
    }
  }
  __syncthreads();

  const long long left = s - lo;
  const int segs = (int)(left < seg_tile ? left : seg_tile);
  for (int i = threadIdx.x; i < segs * cols; i += kThreads) {
    const int sg = i / cols;
    const int c = i - sg * cols;
    out[(lo + sg) * d + c0 + c] = tile[sg * dc + c];
  }
}

template <typename T, typename Id>
using FoldKernel = void (*)(const T*, const Id*, long long, int, T*, long long, int, int);

// Check the launch geometry the wrapper computed and launch on its stream;
// returns the CUDA error code (0 on success).
template <typename T, typename Id>
int launch_fold(FoldKernel<T, Id> kernel, const void* vals, const void* ids, long long b, int d, void* out,
                long long s, int dc, int sw, long long seg_tiles, int col_chunks, void* stream) {
  if (b < 0 || d < 1 || s < 1 || dc < 1 || dc > 32 || sw < 1 || (long long)kWarps * sw * dc > kTileWords ||
      seg_tiles < 1 || seg_tiles > 0x7fffffffLL || seg_tiles * kWarps * sw < s || col_chunks < 1 ||
      col_chunks > 65535 || (long long)col_chunks * dc < d) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)seg_tiles, (unsigned)col_chunks);
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>((const T*)vals, (const Id*)ids, b, d, (T*)out, s, dc, sw);
  return (int)cudaGetLastError();
}

}  // namespace segfold
