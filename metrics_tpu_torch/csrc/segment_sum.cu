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
//    sliced and windowed bit-parity tests assume runs repeat bit for bit. A
//    block owns a tile of segments (and up to 32 columns) in shared memory;
//    each of its 8 warps owns a slice of that tile. The block stages the ids
//    in chunks; each warp scans them 32 at a time with a ballot and, in row
//    order, its lanes (one per column) add the matched rows into its slice.
//    Each (segment, column) is thus summed by one lane in row order: the
//    result is deterministic and equal bit for bit to a sequential
//    index_add_ on the CPU. The tile is written out once, so the output
//    needs no zeroing. The segment tile shrinks when S is small so that about
//    two blocks per SM stay in flight.
// Both kernels launch on the caller's stream and allocate nothing; the Python
// wrappers allocate outputs and check devices, dtypes and shapes.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileFloats = 10240;  // 40 KB of segment tile
constexpr int kIdChunk = 1024;      // 4 KB of staged tile-local ids
constexpr unsigned kFullMask = 0xffffffffu;

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
__global__ void __launch_bounds__(kThreads)
    segment_sum_f32_kernel(const float* __restrict__ vals, const Id* __restrict__ ids, long long b, int d,
                           float* __restrict__ out, long long s, int dc, int sw) {
  __shared__ float tile[kTileFloats];
  __shared__ int local[kIdChunk];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int seg_tile = kWarps * sw;  // segments owned by this block
  const long long lo = (long long)blockIdx.x * seg_tile;
  const int c0 = blockIdx.y * dc;
  const int cols = min(dc, d - c0);
  const int wlo = warp * sw;  // this warp's slice of the tile: [wlo, wlo + sw)
  const int whi = wlo + sw;

  for (int i = threadIdx.x; i < seg_tile * dc; i += kThreads) tile[i] = 0.0f;

  for (long long base = 0; base < b; base += kIdChunk) {
    const int n = (int)min((long long)kIdChunk, b - base);
    __syncthreads();  // the previous chunk is consumed (and the tile zeroed)
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
        if (lane < cols) tile[tk * dc + lane] += vals[(base + r0 + k) * d + c0 + lane];
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

template <typename Id>
int launch_segment_sum(const void* vals, const void* ids, long long b, int d, void* out, long long s, int dc,
                       int sw, long long seg_tiles, int col_chunks, void* stream) {
  if (b < 0 || d < 1 || s < 1 || dc < 1 || dc > 32 || sw < 1 || (long long)kWarps * sw * dc > kTileFloats ||
      seg_tiles < 1 || seg_tiles > 0x7fffffffLL || seg_tiles * kWarps * sw < s || col_chunks < 1 ||
      col_chunks > 65535 || (long long)col_chunks * dc < d) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)seg_tiles, (unsigned)col_chunks);
  segment_sum_f32_kernel<Id><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)vals, (const Id*)ids, b, d, (float*)out, s, dc, sw);
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
                          int sw, long long seg_tiles, int col_chunks, void* stream) {
  return launch_segment_sum<int>(vals, ids, b, d, out, s, dc, sw, seg_tiles, col_chunks, stream);
}

int segment_sum_f32_ids64(const void* vals, const void* ids, long long b, int d, void* out, long long s, int dc,
                          int sw, long long seg_tiles, int col_chunks, void* stream) {
  return launch_segment_sum<long long>(vals, ids, b, d, out, s, dc, sw, seg_tiles, col_chunks, stream);
}

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
