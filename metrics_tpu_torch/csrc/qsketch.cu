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
//   cum     the inclusive prefix sum of the sorted weights sw, total their
//           sum;
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
// binary default, [16384, 2002] for 1000 classes) bytes would take 0.16 us
// and 80 us; the sort is a chain of dependent steps, so the design spreads
// each step over the card and keeps the chain short:
//  * Keys only. Each row's key becomes an order-preserving uint32 (sign
//    flipped for positives, all bits for negatives), packed with the row
//    index into a unique uint64, so the sort is on 8 bytes a row and needs
//    no stability. The payload moves once, by gather, at the end. The key
//    map, the tile sort and the merge are bitonic.cuh's, shared with
//    row_topk.cu.
//  * Sort: blocks sort tiles of 1024 keys in shared memory, then merge
//    passes by rank place every key straight into its sorted position (4
//    runs a pass): at n_pad 16384 that is 16 blocks and two 4-way passes of
//    16384 threads, at 131072 four passes. Any n_pad takes the same kernels.
//  * Prefix sum and bucket map over scan tiles of 256 sorted rows (at most
//    1024 tiles, so a tile grows past 256 rows only beyond 262,144 rows):
//    one kernel sums each tile's weights in a fixed order; the next gives
//    each tile its offset (a fixed-order sum of the tile sums before it),
//    scans its rows a warp at a time with shuffles (coalesced), maps each
//    to its bucket and writes perm, bucket and, for rows up to 16 columns,
//    the whole weighted row. asin is taken in double, one row a thread.
//  * Wider rows (2002 columns) are weighted by a gather over (row, column)
//    pairs.
// Five launches at the binary default (tile sort, two merges, tile sums,
// scan), no atomics: every output is the same from run to run.
// The kernels launch on the caller's stream and allocate nothing; the Python
// wrapper allocates outputs and scratch (both key buffers and the tile
// sums), computes the plan (ops/qsketch.py: qsketch_plan) and checks devices,
// dtypes and shapes.

#include <cuda_runtime.h>
#include <math.h>

#include "bitonic.cuh"

namespace {

using bitonic::kTile;
using bitonic::kTileThreads;
constexpr unsigned int kPlusInf = 0xff800000u;  // the ordered form of +inf
constexpr int kScanThreads = 256;
constexpr int kMaxScanTiles = 1024;  // so one block sums the tile sums
constexpr int kNarrowCols = 16;      // rows this wide are weighted by the scan

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

// The row index a sorted key carries, and that row's weight (0 past n).
__device__ __forceinline__ float weight_of(const float* __restrict__ rows, long long n, int cols,
                                           unsigned long long key, long long& idx) {
  idx = (long long)(unsigned int)(key & 0xffffffffull);
  return idx < n ? rows[idx * cols] : 0.0f;
}

// Each block sorts one tile of min(n_pad, kTile) keys, ascending.
__global__ void __launch_bounds__(kTileThreads)
    sort_tiles_kernel(const float* __restrict__ rows, long long n, int cols, long long n_pad,
                      unsigned long long* __restrict__ keys) {
  __shared__ unsigned long long s[kTile];
  const int len = n_pad < kTile ? (int)n_pad : kTile;
  const long long base = (long long)blockIdx.x * len;
  for (int t = threadIdx.x; t < len; t += blockDim.x) s[t] = sort_key(rows, n, cols, base + t);
  bitonic::sort_shared(s, len);
  for (int t = threadIdx.x; t < len; t += blockDim.x) keys[base + t] = s[t];
}

// The block's sum of v in a fixed order (a shuffle tree in each warp, then
// over the warp sums), returned to every thread.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
  const int lane = threadIdx.x & 31;
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  __syncthreads();  // warp_sums may still be read by an earlier call
  if (lane == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.0f;
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
  return __shfl_sync(0xffffffffu, s, 0);
}

// The sorted weights' sum of each scan tile.
__global__ void __launch_bounds__(kScanThreads)
    tile_sums_kernel(const float* __restrict__ rows, long long n, int cols, const unsigned long long* __restrict__ keys,
                     long long tile, float* __restrict__ part) {
  __shared__ float warp_sums[32];
  const long long base = (long long)blockIdx.x * tile;
  float sum = 0.0f;
  long long idx;
  for (long long r = base + threadIdx.x; r < base + tile; r += blockDim.x) {
    sum = __fadd_rn(sum, weight_of(rows, n, cols, keys[r], idx));
  }
  sum = block_sum(sum, warp_sums);
  if (threadIdx.x == 0) part[blockIdx.x] = sum;
}

// One scan tile: its offset (the tile sums before it) and the total, the
// inclusive prefix sum of its sorted weights a chunk of blockDim rows at a
// time, each row's bucket; writes perm, bucket and the weighted row (column
// 0 only when the rows are wider than kNarrowCols).
__global__ void __launch_bounds__(kScanThreads)
    scan_bucket_kernel(const float* __restrict__ rows, long long n, int cols,
                       const unsigned long long* __restrict__ keys, long long tile, int tiles,
                       const float* __restrict__ part, int capacity, float scale, int* __restrict__ perm,
                       float* __restrict__ wvals, int* __restrict__ bucket) {
  __shared__ float warp_sums[32];
  __shared__ float warp_scan[32];
  float before = 0.0f, all = 0.0f;
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
    const float p = part[t];
    if (t < (int)blockIdx.x) before = __fadd_rn(before, p);
    all = __fadd_rn(all, p);
  }
  float carry = block_sum(before, warp_sums);
  float total = block_sum(all, warp_sums);
  total = total < 1e-30f ? 1e-30f : total;  // NaN stays NaN, as torch.clamp keeps it
  const int n_seg = capacity / 2 + 4;
  const int shift = capacity / 4 + 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long base = (long long)blockIdx.x * tile;
  for (long long chunk = base; chunk < base + tile; chunk += blockDim.x) {
    const long long r = chunk + threadIdx.x;
    const bool in = r < base + tile;
    long long idx = 0;
    const float w = in ? weight_of(rows, n, cols, keys[r], idx) : 0.0f;
    float x = w;  // inclusive scan of the warp's weights
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x = __fadd_rn(y, x);
    }
    if (lane == 31) warp_scan[warp] = x;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warp totals
      float v = lane < warps ? warp_scan[lane] : 0.0f;
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v = __fadd_rn(y, v);
      }
      if (lane < warps) warp_scan[lane] = v;
    }
    __syncthreads();
    const float cum = __fadd_rn(carry, warp > 0 ? __fadd_rn(warp_scan[warp - 1], x) : x);
    carry = __fadd_rn(carry, warp_scan[warps - 1]);
    __syncthreads();  // warp_scan is rewritten by the next chunk
    if (!in) continue;
    float q = __fdiv_rn(__fsub_rn(cum, __fmul_rn(w, 0.5f)), total);
    q = q < 0.0f ? 0.0f : (q > 1.0f ? 1.0f : q);
    const float s = __double2float_rn(asin((double)__fsub_rn(__fmul_rn(2.0f, q), 1.0f)));
    int b = (int)floorf(__fmul_rn(scale, s)) + shift;
    b = b < 0 ? 0 : (b > n_seg - 1 ? n_seg - 1 : b);
    perm[r] = (int)idx;
    bucket[r] = b;
    float* out = wvals + r * cols;
    out[0] = w;
    if (cols <= kNarrowCols) {
      for (int c = 1; c < cols; ++c) out[c] = __fmul_rn(w, idx < n ? rows[idx * cols + c] : 0.0f);
    }
  }
}

// wvals[r, c] = sw[r] * rows[perm[r], c] for the payload columns c >= 1 of
// rows wider than kNarrowCols.
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

// The plan (ops/qsketch.py: qsketch_plan): n_pad a power of two >= max(n,
// 2); tile = min(n_pad, 1024) keys a block sorts; way = 4 runs a merge pass
// merges; scan_tile the sorted rows of a scan block (n_pad below 256, else
// max(256, n_pad / 1024)). scratch: 2 * n_pad uint64 (the sorted keys and
// the merge's second buffer), then n_pad / scan_tile float32 tile sums.
// perm: n_pad int32; wvals: [n_pad, cols] float32; bucket: n_pad int32.
int qsketch_sort_bucket_f32(const void* rows, long long n, int cols, long long n_pad, int capacity, float scale,
                            int tile, int way, long long scan_tile, void* scratch, void* perm, void* wvals,
                            void* bucket, void* stream) {
  const long long want_scan = n_pad < kScanThreads ? n_pad
                              : (n_pad / kMaxScanTiles > kScanThreads ? n_pad / kMaxScanTiles : kScanThreads);
  if (n < 0 || cols < 2 || capacity < 1 || n_pad < 2 || n_pad < n || (n_pad & (n_pad - 1)) != 0 ||
      n_pad > (1LL << 31) || tile != (n_pad < kTile ? n_pad : kTile) || way != bitonic::kMaxWay ||
      scan_tile != want_scan) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const float* r = (const float*)rows;
  unsigned long long* a = (unsigned long long*)scratch;
  unsigned long long* b = a + n_pad;
  float* part = (float*)(b + n_pad);
  const int tiles = (int)(n_pad / scan_tile);

  sort_tiles_kernel<<<(unsigned)(n_pad / tile), kTileThreads, 0, st>>>(r, n, cols, n_pad, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned long long* sorted = bitonic::merge_runs(a, b, n_pad, n_pad, 1, tile, nullptr, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tile_sums_kernel<<<tiles, kScanThreads, 0, st>>>(r, n, cols, sorted, scan_tile, part);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scan_bucket_kernel<<<tiles, kScanThreads, 0, st>>>(r, n, cols, sorted, scan_tile, tiles, part, capacity, scale,
                                                     (int*)perm, (float*)wvals, (int*)bucket);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (cols > kNarrowCols) {
    gather_rows_kernel<<<grid_for(n_pad * (cols - 1), 256), 256, 0, st>>>(r, n, cols, (const int*)perm, n_pad,
                                                                           (float*)wvals);
  }
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
