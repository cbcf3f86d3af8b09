// Sorting blocks shared by qsketch.cu (K3) and row_topk.cu (K4): the
// order-preserving float key map, a block's bitonic sort of packed uint64
// keys in shared memory, and the merge-by-rank pass that merges sorted runs
// in global memory.
//
// Each source packs an order-preserving uint32 of its float key with an
// index into one uint64, unique within what it sorts, so no sort here needs
// stability. A sequence of n keys (a power of two) sorts in two steps:
//  * tiles: a block sorts each tile of min(n, kTile) keys in shared memory
//    (sort_shared: the strides >= 32 of the bitonic network as shared-memory
//    passes of two strides each, the strides < 32 inside a warp by shuffles,
//    so a 1024-key tile takes 15 block barriers instead of 55);
//  * merges by rank: each pass merges every `way` consecutive sorted runs
//    into one, up to kMaxWay runs at a time, each key written straight to
//    its place: its index in its own run plus its rank in each other run of
//    its group (a lockstep binary search, one independent load per run and
//    step). Ranks count equal keys of earlier runs and not of later ones, so
//    the places form a permutation even where keys repeat. The search is
//    bound by its probes (way x log2(run) a key): two 4-way passes cost less
//    than one 16-way pass (11 against 24 us at 16,384 keys on an H100).
// A 16,384-key sequence is 16 tiles and two 4-way merges; 131,072 keys take
// four passes (4, 4, 4 and 2 runs).
//
// ops/build.py hashes this header into every library's name, so editing it
// rebuilds both sources.
#pragma once

#include <cuda_runtime.h>

namespace bitonic {

constexpr int kTile = 1024;        // keys one block sorts in shared memory (8 KB)
constexpr int kTileThreads = 1024;  // threads of a tile-sorting block: a warp per 32 keys
constexpr int kMaxWay = 4;  // sorted runs one merge pass merges into one (4 probes a search step)
constexpr int kMergeThreads = 256;

// uint32 whose unsigned order is the ascending order of a non-NaN float key,
// -0.0 mapped as +0.0 (sign flipped for positives, all bits for negatives).
// Where NaN goes is the caller's choice.
__device__ __forceinline__ unsigned int ascending_bits(float key) {
  const unsigned int bits = key == 0.0f ? 0u : __float_as_uint(key);
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ void order_pair(unsigned long long& lo, unsigned long long& hi, bool ascending) {
  if ((lo > hi) == ascending) {
    const unsigned long long t = lo;
    lo = hi;
    hi = t;
  }
}

// Strides j and j/2 (both >= 32) of stage k over s[0, len): each thread takes
// the four keys i, i + j/2, i + j, i + 3j/2.
__device__ __forceinline__ void shared_pass2(unsigned long long* s, int len, int k, int j) {
  const int h = j >> 1;
  for (int t = threadIdx.x; t < len / 4; t += blockDim.x) {
    const int i = ((t & ~(h - 1)) << 2) | (t & (h - 1));
    const bool up = (i & k) == 0;
    unsigned long long a = s[i], b = s[i + h], c = s[i + j], d = s[i + j + h];
    order_pair(a, c, up);
    order_pair(b, d, up);
    order_pair(a, b, up);
    order_pair(c, d, up);
    s[i] = a;
    s[i + h] = b;
    s[i + j] = c;
    s[i + j + h] = d;
  }
  __syncthreads();
}

// Stride j (>= 32) of stage k over s[0, len).
__device__ __forceinline__ void shared_pass1(unsigned long long* s, int len, int k, int j) {
  for (int t = threadIdx.x; t < len / 2; t += blockDim.x) {
    const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
    unsigned long long a = s[i], b = s[i + j];
    order_pair(a, b, (i & k) == 0);
    s[i] = a;
    s[i + j] = b;
  }
  __syncthreads();
}

// One compare-exchange at stride j (< 32) of stage k between lanes: the key
// kept by the lane whose key has index i.
__device__ __forceinline__ unsigned long long lane_exchange(unsigned long long v, int i, int j, int k) {
  const unsigned long long other = __shfl_xor_sync(0xffffffffu, v, j);
  const bool keep_min = ((i & j) == 0) == ((i & k) == 0);
  return (other < v) == keep_min ? other : v;
}

// The strides < 32 inside each 32-key chunk of s[0, len), one key a lane,
// by shuffles: all of stages 2 .. 32 (`first`), or strides 16 .. 1 of stage
// k. A chunk past len (len < 32) is padded with keys above every key, which
// stage 32 leaves at its end.
__device__ __forceinline__ void warp_pass(unsigned long long* s, int len, bool first, int k) {
  const int lane = threadIdx.x & 31;
  for (int chunk = (threadIdx.x >> 5) * 32; chunk < len; chunk += blockDim.x) {
    const int i = chunk + lane;
    unsigned long long v = i < len ? s[i] : ~0ull;
    if (first) {
#pragma unroll
      for (int kk = 2; kk <= 32; kk <<= 1) {
#pragma unroll
        for (int j = kk >> 1; j > 0; j >>= 1) v = lane_exchange(v, i, j, kk);
      }
    } else {
#pragma unroll
      for (int j = 16; j > 0; j >>= 1) v = lane_exchange(v, i, j, k);
    }
    if (i < len) s[i] = v;
  }
  __syncthreads();
}

// Sort s[0, len) ascending (len a power of two, keys unique or not), with
// every thread of the block taking part; ends with a barrier.
__device__ __forceinline__ void sort_shared(unsigned long long* s, int len) {
  __syncthreads();
  warp_pass(s, len, true, 0);  // stages 2 .. 32: strides < 32 only
  for (int k = 64; k <= len; k <<= 1) {
    int j = k >> 1;
    for (; j >= 64; j >>= 2) shared_pass2(s, len, k, j);
    if (j == 32) shared_pass1(s, len, k, 32);
    warp_pass(s, len, false, k);
  }
}

// One merge-by-rank pass over `len` keys per row (row = blockIdx.y, rows
// `stride` keys apart): each group of kWay consecutive sorted runs of `run`
// keys in `in` becomes one sorted run in `out`. `active` (optional, a byte
// per row) skips rows that are not set. Every probe of a search step is an
// unconditional load (its own run's probe is read and ignored), so the kWay
// loads of a step are in flight together.
template <int kWay>
__global__ void __launch_bounds__(kMergeThreads)
    merge_pass_kernel(const unsigned long long* __restrict__ in, unsigned long long* __restrict__ out, long long len,
                      long long stride, long long run, const unsigned char* __restrict__ active) {
  if (active != nullptr && active[blockIdx.y] == 0) return;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  in += (long long)blockIdx.y * stride;
  out += (long long)blockIdx.y * stride;
  const unsigned long long key = in[i];
  const int lg = __ffsll(run) - 1;  // run is a power of two
  const long long r = i >> lg;
  const long long first = r & ~(long long)(kWay - 1);  // the group's first run
  const int own = (int)(r - first);
  const unsigned long long* group = in + (first << lg);
  // lockstep binary search in every run of the group: at[u] counts its keys
  // below `key` (at or below it for the runs before `own`)
  long long at[kWay];
#pragma unroll
  for (int u = 0; u < kWay; ++u) at[u] = 0;
  for (long long step = run >> 1; step > 0; step >>= 1) {
    unsigned long long probe[kWay];
#pragma unroll
    for (int u = 0; u < kWay; ++u) probe[u] = group[((long long)u << lg) + at[u] + step - 1];
#pragma unroll
    for (int u = 0; u < kWay; ++u) {
      if (probe[u] < key || (u < own && probe[u] == key)) at[u] += step;
    }
  }
  long long place = (first << lg) + (i - (r << lg));
#pragma unroll
  for (int u = 0; u < kWay; ++u) {
    const unsigned long long probe = group[((long long)u << lg) + at[u]];
    if (u != own) place += at[u] + ((probe < key || (u < own && probe == key)) ? 1 : 0);
  }
  out[place] = key;
}

// The merge passes after tiles of `tile` keys over `len` keys per row, in
// `a` (sorted tiles) and `b` (scratch of the same size); returns the buffer
// that holds the sorted rows, or nullptr after a launch error (left in
// cudaGetLastError).
inline unsigned long long* merge_runs(unsigned long long* a, unsigned long long* b, long long len, long long stride,
                                      unsigned rows, long long tile, const unsigned char* active, cudaStream_t st) {
  const dim3 grid((unsigned)((len + kMergeThreads - 1) / kMergeThreads), rows);
  for (long long run = tile; run < len;) {
    const long long runs = len / run;
    const int way = runs < kMaxWay ? (int)runs : kMaxWay;
    static_assert(kMaxWay == 4, "a pass merges 4 runs, or 2 where only 2 are left");
    if (way == kMaxWay) {
      merge_pass_kernel<kMaxWay><<<grid, kMergeThreads, 0, st>>>(a, b, len, stride, run, active);
    } else {
      merge_pass_kernel<2><<<grid, kMergeThreads, 0, st>>>(a, b, len, stride, run, active);
    }
    if (cudaPeekAtLastError() != cudaSuccess) return nullptr;
    unsigned long long* t = a;
    a = b;
    b = t;
    run *= way;
  }
  return a;
}

}  // namespace bitonic
