// Pairwise and batched box IoU for Hopper (sm_90a), bound with ctypes.
//
// Replaces: metrics_tpu/ops/box_iou_pallas.py::_iou_tile_kernel (driven by
// box_iou_tiled, [N,4] x [M,4] -> [N,M]) and ::_iou_unit_kernel (driven by
// box_iou_batched_tiled, [U,D,4] x [U,G,4] -> [U,D,G], the mAP matcher's
// shape). Both compute the IoU of xyxy boxes; a union that is not > 0
// (zero-area or padded pairs, NaN) gives 0.
//
// One kernel serves both: the pairwise case is the batched one with U = 1.
// Rows r = u * D + d of boxes1 ([U*D, 4]) pair with the G boxes of unit
// u = r / D of boxes2 ([U*G, 4]); out is [U*D, G].
//
// What bounds it on this card: bytes. Each output costs about 20 floating
// point operations and writes 4 bytes (8 in float64): 5 flops per byte, far
// below the 20 flops per byte at which the H100's 67 TFLOP/s of float32
// would bind. The least time is the boxes read once and the output written
// once over HBM's 3.35 TB/s: 10 us for the [65536, 8, 8] chunk of the COCO
// fixture (16.8 MB each way), 20 us for [4096, 4096] (67 MB of output).
//
// What the design does about it: one thread per output element, the threads
// of a warp on consecutive output addresses, so every store is coalesced. A
// block is gx x by threads: gx = G rounded up to a power of two (at most 32)
// lanes walk g, and by = 256 / gx rows share the block, so at G = 8 a warp
// writes 4 whole output rows, 128 contiguous bytes. The boxes are read
// through the read-only cache: each boxes2 row is read by D threads, each
// boxes1 row by G, and both stay in L1. Rows beyond the grid's 65535 y
// blocks are walked by a grid-stride loop.
//
// The arithmetic is that of the JAX package's jnp broadcast
// (metrics_tpu/functional/detection/box_ops.py:box_iou), in its order:
//   area = (x2 - x1) * (y2 - y1)
//   w, h = max(min(rb) - max(lt), 0)      (NaN propagates, -0 becomes +0)
//   inter = w * h
//   union = (area1 + area2) - inter
//   iou = union > 0 ? inter / union : 0
// with every step an _rn intrinsic, so nvcc contracts nothing into an FMA
// (no --use_fast_math). The result is then equal bit for bit to the plain
// PyTorch version and to the jnp broadcast on the CPU. The interpret-mode
// Pallas kernel is not: XLA fuses area1 + area2 into
// fma(x22 - x21, y22 - y21, area1) there, which differs by up to 4 ulp on
// about 1% of pairs.
//
// Templated over float and double, so a float64 call keeps float64. The
// kernel launches on the caller's stream and allocates nothing; the Python
// wrapper (metrics_tpu_torch/ops/box_iou.py) allocates the output and checks
// devices, dtypes and shapes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxGridY = 65535;

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// torch.maximum / torch.minimum: a NaN operand gives NaN (fmax/fmin would
// drop it). The sign of a zero result is irrelevant: it only reaches clip0.
template <typename T>
__device__ __forceinline__ T max_nan(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}
// XLA's max(x, 0): NaN stays NaN, -0 and negatives become +0
template <typename T>
__device__ __forceinline__ T clip0(T x) {
  return (x > T(0) || x != x) ? x : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    box_iou_kernel(const T* __restrict__ boxes1, const T* __restrict__ boxes2, T* __restrict__ out, long long rows,
                   long long d, long long g) {
  const long long gi = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gi >= g) return;
  const long long row_stride = (long long)gridDim.y * blockDim.y;
  for (long long r = (long long)blockIdx.y * blockDim.y + threadIdx.y; r < rows; r += row_stride) {
    const T* b1 = boxes1 + r * 4;
    const T* b2 = boxes2 + ((r / d) * g + gi) * 4;
    const T x11 = __ldg(b1), y11 = __ldg(b1 + 1), x12 = __ldg(b1 + 2), y12 = __ldg(b1 + 3);
    const T x21 = __ldg(b2), y21 = __ldg(b2 + 1), x22 = __ldg(b2 + 2), y22 = __ldg(b2 + 3);
    const T area1 = mul_rn(sub_rn(x12, x11), sub_rn(y12, y11));
    const T area2 = mul_rn(sub_rn(x22, x21), sub_rn(y22, y21));
    const T w = clip0(sub_rn(min_nan(x12, x22), max_nan(x11, x21)));
    const T h = clip0(sub_rn(min_nan(y12, y22), max_nan(y11, y21)));
    const T inter = mul_rn(w, h);
    const T uni = sub_rn(add_rn(area1, area2), inter);
    out[r * g + gi] = (uni > T(0)) ? div_rn(inter, uni) : T(0);
  }
}

template <typename T>
int launch_box_iou(const void* boxes1, const void* boxes2, void* out, long long units, long long d, long long g,
                   int gx, void* stream) {
  if (units < 1 || d < 1 || g < 1 || gx < 1 || gx > 32 || (gx & (gx - 1)) != 0) return (int)cudaErrorInvalidValue;
  const int by = kThreads / gx;
  const long long rows = units * d;
  const long long gblocks = (g + gx - 1) / gx;
  long long rblocks = (rows + by - 1) / by;
  if (rblocks > kMaxGridY) rblocks = kMaxGridY;  // the kernel walks the rest
  if (gblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gblocks, (unsigned)rblocks);
  const dim3 block((unsigned)gx, (unsigned)by);
  box_iou_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>((const T*)boxes1, (const T*)boxes2, (T*)out, rows, d, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// boxes1: [units * d, 4]; boxes2: [units * g, 4]; out: [units * d, g], all
// contiguous, of one dtype. gx: lanes per block along g (a power of two <= 32).
int box_iou_f32(const void* boxes1, const void* boxes2, void* out, long long units, long long d, long long g, int gx,
                void* stream) {
  return launch_box_iou<float>(boxes1, boxes2, out, units, d, g, gx, stream);
}

int box_iou_f64(const void* boxes1, const void* boxes2, void* out, long long units, long long d, long long g, int gx,
                void* stream) {
  return launch_box_iou<double>(boxes1, boxes2, out, units, d, g, gx, stream);
}

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
