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
// `rows` (optional, [R] bytes) masks whole rows: a row it does not set is
// written (-inf, 0, 0). The retrieval table passes its overflowing rows, so
// that the few rows that compact select and sort and the others cost a
// byte read and their fill.
//
// What bounds it on this card: the bytes are the active rows' three [N]
// inputs read once and three [k] outputs written once (at the table's
// insert, [2048, 2176] with about 7 active rows, under a tenth of a
// microsecond); what costs is the chain of dependent steps in a row and
// keeping the card busy when few rows are set. The design selects k, then
// sorts only k:
//  * Keys. Each slot's key becomes an order-preserving uint32 (descending:
//    the complement of bitonic.cuh's ascending map; NaN all ones), so the
//    k-th key is found on 32 bits and the survivors sort on the key packed
//    with their column into a unique uint64; payload and validity are
//    gathered by column at the end.
//  * Select: one block per active row (rows up to 16384 wide keep their
//    keys in shared memory, loaded 16 columns a thread at a time) runs a
//    radix select over the key, 8 bits a pass with a shared histogram, and
//    stops at the first digit whose keys all survive, or that at most 64
//    keys share (those are ranked against each other directly): at most
//    four passes, one or two on the retrieval table's rows.
//  * Survivors: every key below the threshold's prefix, and `need` of the
//    keys that share it (all of them; the first `need` columns when all 32
//    bits are fixed, since they are then equal; or the `need` lowest packed
//    keys when at most 64 share it), placed by one block-wide prefix count
//    over each thread's own run of columns: exactly k.
//  * Order only the k survivors: up to 128 of them, each thread counts the
//    survivors below its own and writes its output there; up to 8192 they
//    sort in shared memory (bitonic.cuh's sort_shared); past that in a
//    global scratch by bitonic.cuh's tiles and merge passes, then a gather
//    launch. Any N and k take the kernel.
//  * Rows. A launch has at most as many blocks as the SMs hold (1056 of 256
//    threads on an H100; rows up to 1024 wide take blocks of 64, so more
//    rows are in flight); block b takes rows b, b + grid, ... and selects
//    those the mask sets, so the ~7 set rows of a 2048-row insert run on ~7
//    SMs at once (two share a block only when they are a grid apart), and
//    the rows not set cost a byte read and their (-inf, 0, 0) fill.
// The kernels launch on the caller's stream and allocate nothing; the Python
// wrapper allocates outputs and scratch, computes the plan (ops/row_topk.py:
// row_topk_plan) and checks devices, dtypes and shapes.

#include <cuda_runtime.h>

#include "bitonic.cuh"

namespace {

constexpr int kThreads = 256;             // threads of a select block (64 for rows up to 1024 wide)
constexpr long long kCacheKeys = 16384;   // rows this wide keep their keys in shared memory (64 KB)
constexpr long long kSharedSort = 8192;   // survivors (padded) this many sort in shared memory (64 KB)
constexpr unsigned long long kPad = ~0ull;  // the survivor list's padding: after every packed key
constexpr int kBatch = 16;                // columns a thread loads at once
constexpr int kRankMax = 64;    // candidates at the threshold ranked by counting (each against all), at most
constexpr int kRankOut = 128;   // survivors ordered by counting, at most (more sort in shared memory)

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// Descending-order key of one slot: smaller sorts first; NaN all ones (a
// number never is: that would be a NaN's complement).
__device__ __forceinline__ unsigned int slot_key(const float* __restrict__ preds, const float* __restrict__ valid,
                                                 long long at) {
  const float p = preds[at];  // both loads unconditional: in flight together
  const float key = valid[at] > 0.0f ? p : neg_inf();
  return key == key ? ~bitonic::ascending_bits(key) : 0xffffffffu;
}

// Output t of a row from its sorted packed key.
__device__ __forceinline__ void write_output(const float* __restrict__ preds, const float* __restrict__ payload,
                                             const float* __restrict__ valid, long long row, long long n, long long k,
                                             long long t, unsigned long long packed, float* __restrict__ out_k,
                                             float* __restrict__ out_p, float* __restrict__ out_v) {
  const long long at = row * n + (long long)(unsigned int)(packed & 0xffffffffull);
  const float v = valid[at];
  out_k[row * k + t] = v > 0.0f ? preds[at] : neg_inf();
  out_p[row * k + t] = payload[at];
  out_v[row * k + t] = v;
}

__device__ __forceinline__ void write_empty(long long row, long long k, float* __restrict__ out_k,
                                            float* __restrict__ out_p, float* __restrict__ out_v) {
  for (long long t = threadIdx.x; t < k; t += blockDim.x) {
    out_k[row * k + t] = neg_inf();
    out_p[row * k + t] = 0.0f;
    out_v[row * k + t] = 0.0f;
  }
}

// Block-wide exclusive prefix counts of (a, b) in thread order; totals too
// (each below 2**31: a row's columns, a chunk's rows).
__device__ __forceinline__ void block_scan2(int a, int b, int& a_before, int& b_before, int& a_total, int& b_total,
                                            int* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int x = a, y = b;
  for (int off = 1; off < 32; off <<= 1) {
    const int xu = __shfl_up_sync(0xffffffffu, x, off);
    const int yu = __shfl_up_sync(0xffffffffu, y, off);
    if (lane >= off) {
      x += xu;
      y += yu;
    }
  }
  if (lane == 31) {
    warp_tot[warp] = x;
    warp_tot[32 + warp] = y;
  }
  __syncthreads();
  a_before = x - a;
  b_before = y - b;
  a_total = 0;
  b_total = 0;
  for (int w = 0; w < warps; ++w) {
    if (w < warp) {
      a_before += warp_tot[w];
      b_before += warp_tot[32 + w];
    }
    a_total += warp_tot[w];
    b_total += warp_tot[32 + w];
  }
  __syncthreads();  // warp_tot is reused by the next scan
}

struct SelectShared {
  int hist[256];
  unsigned long long cand[kRankMax];  // keys that share the threshold's prefix, ranked directly
  int warp_tot[64];
  int digit;
  long long below;
  long long count;
};

// The top k of one row: radix select of the threshold, the survivors in
// column order, their order (in shared memory, or left in `scratch` for the
// global sort), and the outputs. kCache: the row's keys are read once into
// shared memory (`keys`), else from global memory at every pass.
template <bool kCache>
__device__ void select_row(const float* __restrict__ preds, const float* __restrict__ payload,
                           const float* __restrict__ valid, long long row, long long n, long long k, long long k_pad,
                           unsigned long long* __restrict__ scratch, unsigned long long* list, unsigned int* keys,
                           SelectShared& sh, float* __restrict__ out_k, float* __restrict__ out_p,
                           float* __restrict__ out_v) {
  const long long base = row * n;
  auto key_at = [&](long long c) { return kCache ? keys[c] : slot_key(preds, valid, base + c); };
  if (kCache) {  // kBatch columns a thread in flight at once: the loads are
                // unconditional (a column past n reads column n - 1), so
                // none waits for another
    for (long long first = 0; first < n; first += (long long)kBatch * blockDim.x) {
      unsigned int d[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const long long c = first + (long long)j * blockDim.x + threadIdx.x;
        d[j] = slot_key(preds, valid, base + (c < n ? c : n - 1));
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const long long c = first + (long long)j * blockDim.x + threadIdx.x;
        if (c < n) keys[c] = d[j];
      }
    }
    __syncthreads();
  }
  // radix select: the prefix of the k-th key, `fixed` its bits, `need` the
  // keys to take among the `count` that share it; it stops once they all
  // survive or are few enough (kRankMax) to rank directly
  unsigned int prefix = 0, fixed = 0;
  long long need = k, count = n;
  const int lane = threadIdx.x & 31;
  for (int shift = 24; shift >= 0 && need < count && count > kRankMax; shift -= 8) {
    for (int b = threadIdx.x; b < 256; b += blockDim.x) sh.hist[b] = 0;
    __syncthreads();
#pragma unroll 4
    for (long long c = threadIdx.x; c < n; c += blockDim.x) {
      const unsigned int d = key_at(c);
      if ((d & fixed) == prefix) atomicAdd(&sh.hist[(d >> shift) & 255u], 1);
    }
    __syncthreads();
    if (threadIdx.x < 32) {  // the digit where the running count reaches `need`
      int sum = 0;
      for (int j = 0; j < 8; ++j) sum += sh.hist[lane * 8 + j];
      int incl = sum;
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      long long before = incl - sum;
      for (int j = 0; j < 8; ++j) {
        const int h = sh.hist[lane * 8 + j];
        if (before < need && before + h >= need) {
          sh.digit = lane * 8 + j;
          sh.below = before;
          sh.count = h;
        }
        before += h;
      }
    }
    __syncthreads();
    prefix |= (unsigned int)sh.digit << shift;
    fixed |= 0xffu << shift;
    need -= sh.below;
    count = sh.count;
  }
  // survivors: the keys below the prefix, and `need` of the `count` that
  // share it: all of them, the first `need` in column order (every bit
  // fixed: they are equal), or the `need` lowest of their packed keys,
  // ranked directly (at most kRankMax of them). Each thread owns an
  // odd-length run of columns, so the cached keys are read without bank
  // conflicts.
  const bool rank_shared = need < count && count <= kRankMax;
  const long long per = ((n + blockDim.x - 1) / blockDim.x) | 1;
  const long long lo = (long long)threadIdx.x * per;
  const long long hi = lo + per < n ? lo + per : n;
  int less = 0, eq = 0;
#pragma unroll 4
  for (long long c = lo; c < hi; ++c) {
    const unsigned int d = key_at(c) & fixed;
    less += d < prefix;
    eq += d == prefix;
  }
  int less_before, eq_before, less_total, eq_total;
  block_scan2(less, eq, less_before, eq_before, less_total, eq_total, sh.warp_tot);
  long long at = less_before + (rank_shared ? 0 : (eq_before < need ? eq_before : need));
  long long eq_rank = eq_before;
  unsigned long long* dst = scratch != nullptr ? scratch + row * k_pad : list;
  for (long long c = lo; c < hi; ++c) {
    const unsigned int full = key_at(c);
    const unsigned int d = full & fixed;
    const unsigned long long packed = ((unsigned long long)full << 32) | (unsigned long long)(unsigned int)c;
    if (d < prefix) {
      dst[at++] = packed;
    } else if (d == prefix) {
      if (rank_shared) {
        sh.cand[eq_rank++] = packed;
      } else if (eq_rank++ < need) {
        dst[at++] = packed;
      }
    }
  }
  if (rank_shared) {  // the candidates' places among themselves, after the keys below
    __syncthreads();
    if (threadIdx.x < count) {
      const unsigned long long mine = sh.cand[threadIdx.x];
      int place = 0;
      for (int j = 0; j < (int)count; ++j) place += sh.cand[j] < mine;
      if (place < need) dst[less_total + place] = mine;
    }
  }
  for (long long t = k + threadIdx.x; t < k_pad; t += blockDim.x) dst[t] = kPad;
  if (scratch != nullptr) {
    __syncthreads();  // the keys may be rewritten by this block's next row
    return;
  }
  if (k <= kRankOut && k <= blockDim.x) {  // each survivor's place is the count of survivors below it
    __syncthreads();
    if (threadIdx.x < k) {
      const unsigned long long mine = list[threadIdx.x];
      int place = 0;
      for (int j = 0; j < (int)k; ++j) place += list[j] < mine;
      write_output(preds, payload, valid, row, n, k, place, mine, out_k, out_p, out_v);
    }
  } else {
    bitonic::sort_shared(list, (int)k_pad);
    for (long long t = threadIdx.x; t < k; t += blockDim.x) {
      write_output(preds, payload, valid, row, n, k, t, list[t], out_k, out_p, out_v);
    }
  }
  __syncthreads();  // the list and keys are rewritten by this block's next row
}

// Block b takes rows b, b + grid, b + 2 * grid, ...: it selects those the
// mask sets (every row without a mask) and writes (-inf, 0, 0) to the
// others. No block holds more than ceil(r / grid) rows, set or not.
__global__ void __launch_bounds__(kThreads)
    topk_select_kernel(const float* __restrict__ preds, const float* __restrict__ payload,
                       const float* __restrict__ valid, const unsigned char* __restrict__ rows, long long r,
                       long long n, long long k, long long k_pad, int cache, unsigned long long* __restrict__ scratch,
                       float* __restrict__ out_k, float* __restrict__ out_p, float* __restrict__ out_v) {
  extern __shared__ unsigned long long dyn[];
  __shared__ SelectShared sh;
  unsigned long long* list = dyn;
  unsigned int* keys = (unsigned int*)(dyn + (scratch == nullptr ? k_pad : 0));
  for (long long row = blockIdx.x; row < r; row += gridDim.x) {
    if (rows != nullptr && rows[row] == 0) {
      write_empty(row, k, out_k, out_p, out_v);
    } else if (cache) {
      select_row<true>(preds, payload, valid, row, n, k, k_pad, scratch, list, keys, sh, out_k, out_p, out_v);
    } else {
      select_row<false>(preds, payload, valid, row, n, k, k_pad, scratch, list, keys, sh, out_k, out_p, out_v);
    }
  }
}

// Survivors past kSharedSort, step 1: each block sorts one tile of one
// row's survivors in place (grid: tiles x rows).
__global__ void __launch_bounds__(bitonic::kTileThreads)
    sort_survivor_tiles_kernel(const unsigned char* __restrict__ rows, long long k_pad,
                               unsigned long long* __restrict__ scratch) {
  __shared__ unsigned long long s[bitonic::kTile];
  if (rows != nullptr && rows[blockIdx.y] == 0) return;
  unsigned long long* tile = scratch + (long long)blockIdx.y * k_pad + (long long)blockIdx.x * bitonic::kTile;
  for (int t = threadIdx.x; t < bitonic::kTile; t += blockDim.x) s[t] = tile[t];
  bitonic::sort_shared(s, bitonic::kTile);
  for (int t = threadIdx.x; t < bitonic::kTile; t += blockDim.x) tile[t] = s[t];
}

// Step 3 (after bitonic.cuh's merge passes): the first k sorted survivors
// of each active row.
__global__ void gather_kernel(const float* __restrict__ preds, const float* __restrict__ payload,
                              const float* __restrict__ valid, const unsigned char* __restrict__ rows, long long n,
                              long long k, long long k_pad, const unsigned long long* __restrict__ sorted,
                              float* __restrict__ out_k, float* __restrict__ out_p, float* __restrict__ out_v) {
  const long long row = blockIdx.x;
  if (rows != nullptr && rows[row] == 0) return;  // filled by the select kernel
  for (long long t = threadIdx.x; t < k; t += blockDim.x) {
    write_output(preds, payload, valid, row, n, k, t, sorted[row * k_pad + t], out_k, out_p, out_v);
  }
}

}  // namespace

extern "C" {

// preds, payload, valid: [r, n] float32; rows: [r] bytes or NULL (every row);
// out_k, out_p, out_v: [r, k] float32 with 1 <= k <= n. The plan
// (ops/row_topk.py: row_topk_plan): k_pad the next power of two >= k;
// blocks the select grid of `threads` each (64 for n <= 1024, else 256:
// narrow rows keep more rows in flight an SM); cache 1 when n <= 16384 (keys
// in shared memory).
// scratch holds 2 * r * k_pad uint64 when k_pad > 8192 (r <= 65535) and is
// NULL otherwise.
int row_topk_f32(const void* preds, const void* payload, const void* valid, const void* rows, long long r, long long n,
                 long long k, long long k_pad, int blocks, int threads, int cache, void* scratch, void* out_k,
                 void* out_p, void* out_v, void* stream) {
  const bool global_sort = k_pad > kSharedSort;
  if (r < 1 || r > 0x7fffffffLL || n < 1 || n > 0x7fffffffLL || k < 1 || k > n || k_pad < k || k_pad >= 2 * k ||
      (k_pad & (k_pad - 1)) != 0 || blocks < 1 || blocks > r || threads != (n <= 1024 ? 64 : kThreads) ||
      cache != (n <= kCacheKeys ? 1 : 0) ||
      global_sort != (scratch != nullptr) || (global_sort && r > 65535)) {
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
  unsigned long long* sc = (unsigned long long*)scratch;
  const size_t smem = (global_sort ? 0 : (size_t)k_pad * sizeof(unsigned long long)) +
                      (cache ? (size_t)n * sizeof(unsigned int) : 0);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(topk_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  topk_select_kernel<<<blocks, threads, smem, st>>>(p, pay, v, mask, r, n, k, k_pad, cache, sc, ok, op, ov);
  if ((err = cudaGetLastError()) != cudaSuccess || !global_sort) return (int)err;
  const dim3 tiles((unsigned)(k_pad / bitonic::kTile), (unsigned)r);
  sort_survivor_tiles_kernel<<<tiles, bitonic::kTileThreads, 0, st>>>(mask, k_pad, sc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const unsigned long long* sorted =
      bitonic::merge_runs(sc, sc + r * k_pad, k_pad, k_pad, (unsigned)r, bitonic::kTile, mask, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  gather_kernel<<<(unsigned)r, 256, 0, st>>>(p, pay, v, mask, n, k, k_pad, sorted, ok, op, ov);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
