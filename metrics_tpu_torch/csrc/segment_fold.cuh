// The row-order segment tile shared by segment_sum.cu (K1's float and int32
// sums) and segment_extremum.cu (K2's max and min).
//
// out[s, c] = fold over the rows i with ids[i] == s of vals[i, c], starting
// from the fold's identity; ids outside [0, S), negatives included, drop. No
// float atomics: runs repeat bit for bit, and a float sum equals a
// sequential index_add_ on the CPU.
//
// The grid is (segment tiles, column chunks, row splits). A block owns a tile
// of segments and up to 32 columns in shared memory, and a range of rows.
// Two block bodies share the tile:
//
// * The float sum (fold_tile_ordered) must add each (segment, column) in row
//   order, so it takes one row split, and each of the block's 8 warps owns a
//   slice of the tile, one lane per column (at most 16). The block walks its
//   rows in chunks of 1024: it turns their ids into tile-local segments (the
//   next chunk's ids already loading), lists the rows that are its own,
//   marks which warps have rows in each 32-row group, and stages the listed
//   rows' values in shared memory, all threads loading. Each warp then
//   visits only its groups, in row order, and folds its rows into a
//   register per lane, which goes back to the tile
//   only when the segment changes. A group whose rows of this warp are all
//   of the register's segment (a long run: the sketch's pad bucket, a
//   query's documents) is 32 adds of values read ahead, the other rows
//   added as -0.0, which changes no bit; other groups fold row by row.
//
// * The other folds (uint32 add, and the max and min below) are associative
//   and commutative on the bits (fold_tile_unordered). Each fold maps a
//   value to an integer key whose integer add, max or min is the fold, so
//   every thread folds any row of its range into the tile with a shared-
//   memory integer atomic, in whatever order; a thread keeps a run of rows of
//   one cell in a register and issues one atomic per run. The rows split
//   over blocks when the segment tiles alone give few (64 segments over a
//   million rows): each split folds into a partial tile of a scratch buffer,
//   and a second kernel folds the partials (combine_splits).
//
// The Python wrappers choose the geometry (ops/segment_sum.py:
// segment_fold_geometry).
#pragma once

#include <cuda_runtime.h>

namespace segfold {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileWords = 10240;  // at most 40 KB of segment tile (4-byte values)
constexpr int kIdChunk = 1024;     // rows per chunk of the float sum
constexpr int kIdsPerThread = kIdChunk / kThreads;
constexpr int kGroups = kIdChunk / 32;  // 32-row ballot groups per chunk
constexpr int kOrderedMaxCols = 16;     // the float sum's widest column chunk
static_assert(kGroups == 32, "one ballot covers a chunk's groups");

// The float sum's shared memory, carved at run time: the block's tile
// (8 sw dc words), a chunk's values ((kIdChunk + 1) dc, an odd column
// stride), its tile-local ids and the list of its rows that are the
// block's (kIdChunk each), its groups' owner bits (kGroups) and the list's
// length: at most 112 KB, and two blocks fit an SM when the tile is small.
constexpr int ordered_smem_bytes(int dc, int sw) {
  return (kWarps * sw * dc + (kIdChunk + 1) * dc + 2 * kIdChunk + kGroups + 1) * 4;
}
constexpr int kOrderedSmemMax = (kTileWords + (kIdChunk + 1) * kOrderedMaxCols + 2 * kIdChunk + kGroups + 1) * 4;
constexpr int kUnrolled = 8;  // rows a thread loads ahead (value staging, the unordered body)
constexpr unsigned kFullMask = 0xffffffffu;

struct SumF32 {
  using T = float;
  static constexpr bool kOrdered = true;
  static __device__ __forceinline__ T identity() { return 0.0f; }
  // x + -0.0 is x, bit for bit, for every float x (+0.0 is not: -0.0 + +0.0
  // is +0.0), so a row that is not folded can be added as -0.0
  static __device__ __forceinline__ T neutral() { return -0.0f; }
  static __device__ __forceinline__ T fold(T acc, T v) { return acc + v; }
};

// int32 sums wrap modulo 2**32, as XLA's int32 scatter-add does: the adds
// are done on the bits as uint32, where overflow is defined.
struct SumU32 {
  using T = unsigned;
  using Key = unsigned;
  static constexpr bool kOrdered = false;
  static __device__ __forceinline__ T identity() { return 0u; }
  static __device__ __forceinline__ T fold(T acc, T v) { return acc + v; }
  static __device__ __forceinline__ Key key(T v) { return v; }
  static __device__ __forceinline__ T value(Key k) { return k; }
  static __device__ __forceinline__ Key fold_keys(Key a, Key b) { return a + b; }
  static __device__ __forceinline__ void atomic_fold(Key* cell, Key k) { atomicAdd(cell, k); }
};

// The extremum folds of jax.ops.segment_max/min: a NaN of either sign makes
// the result NaN (the canonical quiet NaN, as torch writes it); max prefers
// +0.0 over -0.0 and min -0.0 over +0.0, in either order. fmaxf/fminf would
// drop NaN, and a float atomicMax on a totalOrder key would rank -NaN lowest.
// The key is the IEEE totalOrder of the float as a signed int (-0.0 below
// +0.0), with every NaN mapped to INT_MAX for max and INT_MIN for min: both
// are the keys of NaNs only, so an integer max (min) of keys is the fold, and
// a NaN key comes back as the canonical NaN.
__device__ __forceinline__ float canonical_nan() { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ bool is_nan(float x) { return (__float_as_uint(x) & 0x7fffffffu) > 0x7f800000u; }
__device__ __forceinline__ bool sign_bit(float x) { return (__float_as_uint(x) >> 31) != 0u; }
__device__ __forceinline__ int order_key(float x) {
  const int bits = __float_as_int(x);
  return bits ^ ((bits >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float from_order_key(int k) { return __int_as_float(k ^ ((k >> 31) & 0x7fffffff)); }

struct MaxF32 {
  using T = float;
  using Key = int;
  static constexpr bool kOrdered = false;
  static __device__ __forceinline__ T identity() { return -__int_as_float(0x7f800000); }
  static __device__ __forceinline__ T fold(T a, T b) {
    if (is_nan(a) || is_nan(b)) return canonical_nan();
    return (a > b || (a == b && !sign_bit(a))) ? a : b;
  }
  static __device__ __forceinline__ Key key(T v) { return is_nan(v) ? 0x7fffffff : order_key(v); }
  static __device__ __forceinline__ T value(Key k) { return k == 0x7fffffff ? canonical_nan() : from_order_key(k); }
  static __device__ __forceinline__ Key fold_keys(Key a, Key b) { return max(a, b); }
  static __device__ __forceinline__ void atomic_fold(Key* cell, Key k) { atomicMax(cell, k); }
};

struct MinF32 {
  using T = float;
  using Key = int;
  static constexpr bool kOrdered = false;
  static __device__ __forceinline__ T identity() { return __int_as_float(0x7f800000); }
  static __device__ __forceinline__ T fold(T a, T b) {
    if (is_nan(a) || is_nan(b)) return canonical_nan();
    return (a < b || (a == b && sign_bit(a))) ? a : b;
  }
  static __device__ __forceinline__ Key key(T v) { return is_nan(v) ? (int)0x80000000 : order_key(v); }
  static __device__ __forceinline__ T value(Key k) { return k == (int)0x80000000 ? canonical_nan() : from_order_key(k); }
  static __device__ __forceinline__ Key fold_keys(Key a, Key b) { return min(a, b); }
  static __device__ __forceinline__ void atomic_fold(Key* cell, Key k) { atomicMin(cell, k); }
};

// Tile-local segment of row id ``v`` for the tile at ``lo``, or -1.
template <typename Id>
__device__ __forceinline__ int tile_local(Id v, long long lo, int seg_tile, long long s) {
  const long long t = (long long)v - lo;
  return (t >= 0 && t < seg_tile && lo + t < s) ? (int)t : -1;
}

// The float sum's block body (see the header): one row split, rows folded
// in row order by the warp that owns their segment. A chunk's values are
// staged column by column (a lane reads the rows of its own column), with an
// odd column stride, so the lanes' columns fall in distinct banks.
template <typename Op, typename Id>
__device__ __forceinline__ void fold_tile_ordered(const float* __restrict__ vals, const Id* __restrict__ ids,
                                                  long long b, int d, float* __restrict__ out, long long s, int dc,
                                                  int sw) {
  static_assert(sizeof(typename Op::T) == sizeof(float), "the ordered body stages float words");
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);
  constexpr int chunk = kIdChunk;
  constexpr int stride = chunk + 1;  // a column's rows; odd, so the lanes' columns fall in distinct banks
  float* stage = tile + kWarps * sw * dc;  // [column][row of the chunk]
  int* local = reinterpret_cast<int*>(stage + stride * dc);
  int* rows = local + kIdChunk;  // the chunk's rows of this block, in no order
  unsigned* owners = reinterpret_cast<unsigned*>(rows + kIdChunk);  // per group: bit w if warp w has rows
  int* count = reinterpret_cast<int*>(owners + kGroups);  // rows listed

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int seg_tile = kWarps * sw;  // segments owned by this block
  const long long lo = (long long)blockIdx.x * seg_tile;
  const int c0 = blockIdx.y * dc;
  const int cols = min(dc, d - c0);
  const int col = min(lane, cols - 1);  // lanes past the columns read a real cell and drop it
  const int wlo = warp * sw;  // this warp's slice of the tile: [wlo, wlo + sw)
  const int whi = wlo + sw;

  // value staging: thread (slot, c) stages column c of listed rows slot, slot + per, ...
  const int per = kThreads / cols;
  const int slot = threadIdx.x / cols;
  const int sc = threadIdx.x - slot * cols;

  for (int i = threadIdx.x; i < seg_tile * dc; i += kThreads) tile[i] = Op::identity();
  if (threadIdx.x == 0) *count = 0;

  Id next[kIdsPerThread];  // the next chunk's ids, loading ahead
#pragma unroll
  for (int k = 0; k < kIdsPerThread; ++k) {
    const int i = threadIdx.x + k * kThreads;
    next[k] = i < b ? ids[i] : (Id)-1;
  }

  int cur = -1;  // the tile-local segment whose running fold is in acc
  float acc = Op::identity();
  for (long long base = 0; base < b; base += chunk) {
    const int n = (int)min((long long)chunk, b - base);
    __syncthreads();  // the previous chunk is consumed (and the tile set)
    unsigned hit[kIdsPerThread];  // this warp's rows of the block, per k
    int listed_here = 0;
#pragma unroll
    for (int k = 0; k < kIdsPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;  // warp w, k: group w + 8 k
      const int t = i < n ? tile_local(next[k], lo, seg_tile, s) : -1;
      if (i < n) local[i] = t;
      const unsigned bits = __reduce_or_sync(kFullMask, t >= 0 ? 1u << (t / sw) : 0u);
      if (lane == 0) owners[i >> 5] = bits;
      hit[k] = __ballot_sync(kFullMask, t >= 0);
      listed_here += __popc(hit[k]);
    }
    if (listed_here) {  // one atomic per warp: its place in the list
      int at = 0;
      if (lane == 0) at = atomicAdd(count, listed_here);
      at = __shfl_sync(kFullMask, at, 0);
#pragma unroll
      for (int k = 0; k < kIdsPerThread; ++k) {
        if ((hit[k] >> lane) & 1u) rows[at + __popc(hit[k] & ((1u << lane) - 1u))] = threadIdx.x + k * kThreads;
        at += __popc(hit[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kIdsPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      next[k] = base + chunk + i < b ? ids[base + chunk + i] : (Id)-1;
    }
    __syncthreads();
    const int listed = *count;
    if (listed == 0) continue;  // no row of this block in the chunk
    if (slot < per) {
      // the listed rows' values, kUnrolled rows at a time: indices, then
      // loads, then stores, so the loads are in flight together
      for (int j = slot; j < listed; j += kUnrolled * per) {
        int r[kUnrolled];
        float v[kUnrolled];
#pragma unroll
        for (int k = 0; k < kUnrolled; ++k) r[k] = j + k * per < listed ? rows[j + k * per] : -1;
#pragma unroll
        for (int k = 0; k < kUnrolled; ++k) v[k] = r[k] >= 0 ? vals[(base + r[k]) * d + c0 + sc] : 0.0f;
#pragma unroll
        for (int k = 0; k < kUnrolled; ++k) {
          if (r[k] >= 0) stage[sc * stride + r[k]] = v[k];
        }
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) *count = 0;  // every thread read it before the sync above
    const float* column = stage + col * stride;
    // this warp's groups of 32 rows (a chunk has 32), in row order
    unsigned groups = __ballot_sync(kFullMask, lane * 32 < n && ((owners[lane] >> warp) & 1u));
    while (groups) {
      const int r0 = (__ffs(groups) - 1) * 32;
      groups &= groups - 1;
      const int t = (r0 + lane < n) ? local[r0 + lane] : -1;
      unsigned mine = __ballot_sync(kFullMask, t >= wlo && t < whi);
      if (__all_sync(kFullMask, t == cur || t < wlo || t >= whi)) {
        // every row of the warp's here is of the register's segment: 32
        // values read ahead, then 32 adds in row order (-0.0 for the others)
        float v[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) v[j] = column[r0 + j];
#pragma unroll
        for (int j = 0; j < 32; ++j) acc = Op::fold(acc, ((mine >> j) & 1u) ? v[j] : Op::neutral());
        continue;
      }
      while (mine) {  // matched rows in ascending row order
        const int k = __ffs(mine) - 1;
        mine &= mine - 1;
        const int tk = __shfl_sync(kFullMask, t, k);
        const float v = column[r0 + k];
        if (tk != cur) {
          if (cur >= 0 && lane < cols) tile[cur * dc + lane] = acc;
          cur = tk;
          acc = tile[cur * dc + col];
        }
        acc = Op::fold(acc, v);
      }
    }
  }
  if (cur >= 0 && lane < cols) tile[cur * dc + lane] = acc;
  __syncthreads();

  const long long left = s - lo;
  const int segs = (int)(left < seg_tile ? left : seg_tile);
  for (int i = threadIdx.x; i < segs * cols; i += kThreads) {
    const int sg = i / cols;
    const int c = i - sg * cols;
    out[(lo + sg) * d + c0 + c] = tile[sg * dc + c];
  }
}

// The order-free folds' block body (see the header): rows [blockIdx.z *
// rows_per_split, ...) folded into the tile's integer keys with shared-memory
// atomics, then written to out + blockIdx.z * s * d (the output itself when
// there is one split, else the block's partial).
template <typename Op, typename Id>
__device__ __forceinline__ void fold_tile_unordered(const typename Op::T* __restrict__ vals,
                                                    const Id* __restrict__ ids, long long b, int d,
                                                    typename Op::T* __restrict__ out, long long s, int dc, int sw,
                                                    long long rows_per_split) {
  using T = typename Op::T;
  using Key = typename Op::Key;
  __shared__ Key tile[kTileWords];

  const int seg_tile = kWarps * sw;
  const long long lo = (long long)blockIdx.x * seg_tile;
  const int c0 = blockIdx.y * dc;
  const int cols = min(dc, d - c0);
  const long long r_lo = min(b, (long long)blockIdx.z * rows_per_split);
  const long long r_hi = min(b, r_lo + rows_per_split);
  out += (long long)blockIdx.z * s * d;

  const Key none = Op::key(Op::identity());
  for (int i = threadIdx.x; i < seg_tile * dc; i += kThreads) tile[i] = none;
  __syncthreads();

  // thread (slot, c) folds column c of rows r_lo + slot, + per, + 2 per, ...
  const int per = kThreads / cols;
  const int slot = threadIdx.x / cols;
  const int c = threadIdx.x - slot * cols;
  if (slot < per) {
    int cell = -1;  // the tile cell whose run of keys is in acc
    Key acc = none;
    for (long long r = r_lo + slot; r < r_hi; r += (long long)kUnrolled * per) {
      int t[kUnrolled];
      T v[kUnrolled];
#pragma unroll
      for (int k = 0; k < kUnrolled; ++k) {
        const long long rk = r + (long long)k * per;
        t[k] = rk < r_hi ? tile_local(ids[rk], lo, seg_tile, s) : -1;
      }
#pragma unroll
      for (int k = 0; k < kUnrolled; ++k) {
        v[k] = t[k] >= 0 ? vals[(r + (long long)k * per) * d + c0 + c] : Op::identity();
      }
#pragma unroll
      for (int k = 0; k < kUnrolled; ++k) {
        if (t[k] < 0) continue;
        const int here = t[k] * dc + c;
        const Key key = Op::key(v[k]);
        if (here == cell) {
          acc = Op::fold_keys(acc, key);
        } else {
          if (cell >= 0) Op::atomic_fold(tile + cell, acc);
          cell = here;
          acc = key;
        }
      }
    }
    if (cell >= 0) Op::atomic_fold(tile + cell, acc);
  }
  __syncthreads();

  const long long left = s - lo;
  const int segs = (int)(left < seg_tile ? left : seg_tile);
  for (int i = threadIdx.x; i < segs * cols; i += kThreads) {
    const int sg = i / cols;
    const int cc = i - sg * cols;
    out[(lo + sg) * d + c0 + cc] = Op::value(tile[sg * dc + cc]);
  }
}

// One block of a fold: segments [blockIdx.x * 8 * sw, ...), columns
// [blockIdx.y * dc, ...), rows [blockIdx.z * rows_per_split, ...). Called by
// each source's __global__ kernel, so that every kernel keeps a name of its
// own in a profile.
template <typename Op, typename Id>
__device__ __forceinline__ void fold_tile(const typename Op::T* __restrict__ vals, const Id* __restrict__ ids,
                                          long long b, int d, typename Op::T* __restrict__ out, long long s,
                                          int dc, int sw, long long rows_per_split) {
  if constexpr (Op::kOrdered) {
    fold_tile_ordered<Op, Id>(vals, ids, b, d, out, s, dc, sw);  // the float sum: T is float
  } else {
    fold_tile_unordered<Op, Id>(vals, ids, b, d, out, s, dc, sw, rows_per_split);
  }
}

// out[cell] = fold over the splits z of partial[z * cells + cell], for the
// order-free folds. ``lanes`` threads share a cell: 1 (a thread a cell, for
// few splits) or 32 (a warp a cell, its lanes striding over the splits, then
// a shuffle tree, for many).
template <typename Op>
__device__ __forceinline__ void combine_splits(const typename Op::T* __restrict__ partial, long long cells,
                                               int splits, int lanes, typename Op::T* __restrict__ out) {
  using T = typename Op::T;
  const long long thread = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long cell = thread / lanes;
  if (cell >= cells) return;  // warp-uniform when lanes == 32
  const int lane = (int)(thread - cell * lanes);
  T acc = Op::identity();
  for (int z = lane; z < splits; z += lanes) acc = Op::fold(acc, partial[(long long)z * cells + cell]);
  if (lanes == 32) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc = Op::fold(acc, __shfl_xor_sync(kFullMask, acc, off));
  }
  if (lane == 0) out[cell] = acc;
}

template <typename T, typename Id>
using FoldKernel = void (*)(const T*, const Id*, long long, int, T*, long long, int, int, long long);
template <typename T>
using CombineKernel = void (*)(const T*, long long, int, int, T*);

// Check the launch geometry the wrapper computed and launch ``kernel`` (the
// fold ``Op``) on its stream, and with more than one row split the combine,
// whose partials go to ``scratch`` (splits * s * d values); ``combine`` is
// null for the float sum, which takes one split. Returns the CUDA error code
// (0 on success).
template <typename Op, typename Id, FoldKernel<typename Op::T, Id> kernel>
int launch_fold(CombineKernel<typename Op::T> combine, const void* vals, const void* ids, long long b, int d,
                void* out, long long s, int dc, int sw, long long seg_tiles, int col_chunks, int splits,
                long long rows_per_split, void* scratch, void* stream) {
  using T = typename Op::T;
  if (b < 0 || d < 1 || s < 1 || dc < 1 || dc > 32 || sw < 1 || (long long)kWarps * sw * dc > kTileWords ||
      seg_tiles < 1 || seg_tiles > 0x7fffffffLL || seg_tiles * kWarps * sw < s || col_chunks < 1 ||
      col_chunks > 65535 || (long long)col_chunks * dc < d || splits < 1 || splits > 65535 || rows_per_split < 0 ||
      (long long)splits * rows_per_split < b || (Op::kOrdered && (splits != 1 || dc > kOrderedMaxCols)) ||
      (splits > 1 && (combine == nullptr || scratch == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  int smem = 0;
  if constexpr (Op::kOrdered) {
    smem = ordered_smem_bytes(dc, sw);
    static bool configured = false;  // one flag per kernel; setting the attribute twice is harmless
    if (!configured) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kOrderedSmemMax);
      if (err != cudaSuccess) return (int)err;
      configured = true;
    }
  }
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)seg_tiles, (unsigned)col_chunks, (unsigned)splits);
  kernel<<<grid, kThreads, smem, st>>>((const T*)vals, (const Id*)ids, b, d, (T*)(splits > 1 ? scratch : out), s,
                                       dc, sw, rows_per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long cells = s * d;
  const int lanes = splits > 16 ? 32 : 1;
  const long long blocks = (cells * lanes + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  combine<<<(unsigned)blocks, kThreads, 0, st>>>((const T*)scratch, cells, splits, lanes, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace segfold
