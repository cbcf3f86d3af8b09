// Bitonic sorting network over packed uint64 keys, and the order-preserving
// float key map, shared by qsketch.cu (K3) and row_topk.cu (K4).
//
// Each source packs an order-preserving uint32 of its float key with a
// unique index into one uint64, so the network needs no stability. A block
// sorts up to kRun keys in dynamic shared memory; wider sequences sort in
// kRun-key runs and finish with global compare-exchange passes (strides >=
// kRun) and in-block merges (strides < kRun). Every pair's direction
// follows the key's index in the whole sequence, so runs come out sorted in
// the alternating directions the later stages expect, and the whole
// sequence ascending.
//
// ops/build.py hashes this header into every library's name, so editing it
// rebuilds both sources.
#pragma once

#include <cuda_runtime.h>

namespace bitonic {

constexpr int kThreads = 1024;
constexpr int kRun = 16384;  // keys one block sorts in shared memory (128 KB)

// uint32 whose unsigned order is the ascending order of a non-NaN float key,
// -0.0 mapped as +0.0 (sign flipped for positives, all bits for negatives).
// Where NaN goes is the caller's choice.
__device__ __forceinline__ unsigned int ascending_bits(float key) {
  const unsigned int bits = key == 0.0f ? 0u : __float_as_uint(key);
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

// lower index of the t-th compare-exchange pair at stride j (a power of two)
__device__ __forceinline__ long long pair_low(long long t, long long j) { return ((t & ~(j - 1)) << 1) | (t & (j - 1)); }

__device__ __forceinline__ void compare_exchange(unsigned long long* s, long long i, long long l, bool ascending) {
  const unsigned long long a = s[i];
  const unsigned long long b = s[l];
  if ((a > b) == ascending) {
    s[i] = b;
    s[l] = a;
  }
}

// Strides top, top/2, ..., 1 of stage k over the keys s[0, run) (in shared
// memory, one block) whose first key has index `base` in the sequence.
__device__ __forceinline__ void merge_strides(unsigned long long* s, int run, long long base, long long k, int top) {
  for (int j = top; j > 0; j >>= 1) {
    for (int t = threadIdx.x; t < run / 2; t += blockDim.x) {
      const long long i = pair_low(t, j);
      compare_exchange(s, i, i + j, ((base + i) & k) == 0);
    }
    __syncthreads();
  }
}

// Stages k = 2 .. run over s[0, run): the run sorted in the direction the
// stages after it expect (ascending when it is the whole sequence).
__device__ __forceinline__ void sort_run(unsigned long long* s, int run, long long base) {
  for (int k = 2; k <= run; k <<= 1) merge_strides(s, run, base, k, k >> 1);
}

// The strides j < kRun of stage k > kRun, inside one run of the keys g[0,
// run) (global memory) whose first key has index `base`; s is the block's
// shared memory.
__device__ __forceinline__ void merge_run(unsigned long long* g, unsigned long long* s, int run, long long base,
                                          long long k) {
  for (int t = threadIdx.x; t < run; t += blockDim.x) s[t] = g[t];
  __syncthreads();
  merge_strides(s, run, base, k, run >> 1);
  for (int t = threadIdx.x; t < run; t += blockDim.x) g[t] = s[t];
}

// One compare-exchange pass of stage k at a stride j >= kRun over keys[0,
// n_pad), pairs first, first + stride, ...
__device__ __forceinline__ void global_pass(unsigned long long* keys, long long n_pad, long long k, long long j,
                                            long long first, long long stride) {
  for (long long t = first; t < n_pad / 2; t += stride) {
    const long long i = pair_low(t, j);
    compare_exchange(keys, i, i + j, (i & k) == 0);
  }
}

}  // namespace bitonic
