// Pairwise and batched box IoU for Hopper (sm_90a), bound with ctypes.
//
// Replaces: metrics_tpu/ops/box_iou_pallas.py::_iou_tile_kernel (driven by
// box_iou_tiled, [N,4] x [M,4] -> [N,M]) and ::_iou_unit_kernel (driven by
// box_iou_batched_tiled, [U,D,4] x [U,G,4] -> [U,D,G], the mAP matcher's
// shape). Both compute the IoU of xyxy boxes; a union that is not > 0
// (zero-area or padded pairs, NaN) gives 0.
//
// One kernel serves both: the pairwise case is the batched one with U = 1.
// Rows r = u * D + d of boxes1 ([U*D, 4]) pair with the G boxes of unit u
// of boxes2 ([U*G, 4]); out is [U*D, G].
//
// What bounds it on this card: the least time is bytes, the boxes read once
// and the output written once over HBM's 3.35 TB/s: 10 us for the
// [65536, 8, 8] chunk of the COCO fixture (16.8 MB each way), 20 us for
// [4096, 4096] (67 MB of output). Each output costs about 20 floating point
// operations on 4 bytes written, far below the 67 TFLOP/s of float32. But
// the byte bound leaves about 30 thread instructions per output at the
// card's issue rate (132 SMs x 4 x 32 lanes x 1.75 GHz), so what a design
// must save is instructions. In float64 the FP64 pipe (half float32's
// rate, and a division of about twenty operations) binds instead.
//
// What the design does about it: the work that does not depend on the pair
// is done once per thread, not once per output.
//   * A thread owns V consecutive columns c..c+V-1 of one unit (float32:
//     V = 4, 2 or 1, the widest that divides G and leaves the launch
//     threads enough; float64: V = 1, as its pipe wants threads more than
//     loads saved): it loads those V boxes of boxes2 once (one 16-byte load
//     each, two in float64) and computes their areas once, in registers.
//   * It then walks rows d = r0, r0 + RT, r0 + 2 RT, ... of its unit (RT
//     row threads per unit; a walk of up to 8 rows, as the wrapper
//     chooses): per row one load of the boxes1 box (the same address across
//     the lanes that share the row), one area, V IoUs, and one vector store
//     of the V results, with the streaming hint (the output is written once
//     and should not evict the boxes from L2). The lanes of a unit write
//     consecutive runs, so the warp's stores are coalesced.
//   * The division, the costliest step, is taken only where the pair
//     intersects and the union is positive: an IEEE division of a zero
//     dividend leaves the hardware's fast path for a slow subroutine, and
//     most pairs do not intersect.
//   * Thread, unit, row and column come from the flat index with two 32-bit
//     divisions by multiply-high (divisors fixed per launch, magic numbers
//     computed on the host), once per thread. 64-bit offsets and plain
//     division are used only when the output or the boxes hold 2**31
//     elements or more, as the wrapper chooses.
//   * A 1-D grid of 256-thread blocks covers every (unit, row thread,
//     column run) once.
//
// The arithmetic is that of the JAX package's jnp broadcast
// (metrics_tpu/functional/detection/box_ops.py:box_iou), in its order:
//   area = (x2 - x1) * (y2 - y1)
//   w, h = max(min(rb) - max(lt), 0)      (NaN propagates, -0 becomes +0)
//   inter = w * h
//   union = (area1 + area2) - inter
//   iou = union > 0 ? inter / union : 0
// with every step an _rn intrinsic, so nvcc contracts nothing into an FMA
// (no --use_fast_math). Hoisting an area out of the per-output path
// changes no rounding: each area is the same two subtractions and one
// product. The result is then equal bit for bit to the plain PyTorch
// version and to the jnp broadcast on the CPU. The interpret-mode Pallas
// kernel is not: XLA fuses area1 + area2 into fma(x22 - x21, y22 - y21,
// area1) there, which differs by up to 4 ulp on about 1% of pairs.
//
// Templated over float and double, so a float64 call keeps float64. The
// kernel launches on the caller's stream and allocates nothing; the Python
// wrapper (metrics_tpu_torch/ops/box_iou.py) allocates the output, checks
// devices, dtypes, shapes and alignment and chooses the geometry (V, RT,
// offset width).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// torch.maximum / torch.minimum: a NaN operand gives NaN (fmax/fmin would
// drop it). In float32 one instruction, PTX max.NaN / min.NaN (sm_80+),
// which gives the canonical NaN where the select chain below gives the NaN
// operand: the NaN only ever reaches a subtraction, which canonicalises it
// on the card either way. The sign of a zero result is irrelevant too: it
// only reaches a subtraction and clip0, which give +0 for every sign.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ double max_nan(double a, double b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
__device__ __forceinline__ double min_nan(double a, double b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}
// XLA's max(x, 0): NaN stays NaN, -0 and negatives become +0
template <typename T>
__device__ __forceinline__ T clip0(T x) {
  return (x > T(0) || x != x) ? x : T(0);
}

template <typename T>
struct Box {
  T x1, y1, x2, y2;
};

// one box: one 16-byte load (two in float64), through the read-only cache
__device__ __forceinline__ Box<float> load_box(const float* p) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  return {v.x, v.y, v.z, v.w};
}
__device__ __forceinline__ Box<double> load_box(const double* p) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  return {a.x, a.y, b.x, b.y};
}

template <typename T>
__device__ __forceinline__ T area(const Box<T>& b) {
  return mul_rn(sub_rn(b.x2, b.x1), sub_rn(b.y2, b.y1));
}

template <typename T>
__device__ __forceinline__ T iou(const Box<T>& a, T area1, const Box<T>& b, T area2) {
  const T w = clip0(sub_rn(min_nan(a.x2, b.x2), max_nan(a.x1, b.x1)));
  const T h = clip0(sub_rn(min_nan(a.y2, b.y2), max_nan(a.y1, b.y1)));
  const T inter = mul_rn(w, h);
  const T uni = sub_rn(add_rn(area1, area2), inter);
  // uni > 0 ? inter / uni : 0, dividing only where inter > 0 too: inter is
  // +0 or NaN otherwise (w, h >= +0), 0 / uni is +0 and a NaN inter makes
  // uni NaN, so the bits are the same. 1 / 1 stays on the fast path.
  const bool live = inter > T(0) && uni > T(0);
  const T q = div_rn(live ? inter : T(1), live ? uni : T(1));
  return live ? q : T(0);
}

// one run of V results: one vector store, with the streaming hint
// (st.global.cs)
__device__ __forceinline__ void store_run(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store_run(float* p, const float (&v)[2]) {
  __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
}
__device__ __forceinline__ void store_run(float* p, const float (&v)[1]) { __stcs(p, v[0]); }
__device__ __forceinline__ void store_run(double* p, const double (&v)[1]) { __stcs(p, v[0]); }

// n / d for n < 2**31 by multiply-high (the divisor's magic number from the
// host): (umulhi(n, m) + n) >> s with s = ceil(log2 d), m = floor(2**32 (2**s
// - d) / d) + 1. A power of two gives m = 1 and a shift.
struct Div32 {
  unsigned d, m, s;
  __device__ __forceinline__ unsigned div(unsigned n) const { return (__umulhi(n, m) + n) >> s; }
};
Div32 make_div32(unsigned d) {
  unsigned s = 0;
  while ((1ull << s) < d) ++s;
  const unsigned m = (unsigned)(((1ull << 32) * ((1ull << s) - d)) / d + 1);
  return {d, m, s};
}
// past 2**31 elements: 64-bit offsets and plain division, once per thread
struct Div64 {
  unsigned long long d;
  __device__ __forceinline__ unsigned long long div(unsigned long long n) const { return n / d; }
};

template <typename T, int V, typename I, typename Div>
__global__ void __launch_bounds__(kThreads)
    box_iou_kernel(const T* __restrict__ boxes1, const T* __restrict__ boxes2, T* __restrict__ out, I threads, I d,
                   I g, Div runs, Div row_threads) {
  const I t = (I)blockIdx.x * kThreads + threadIdx.x;
  if (t >= threads) return;
  const I q = runs.div(t);  // (unit, row thread)
  const I c = (t - q * runs.d) * V;
  const I u = row_threads.div(q);
  const I r0 = q - u * row_threads.d;

  Box<T> col[V];
  T area2[V];
  const T* b2 = boxes2 + (u * g + c) * 4;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    col[v] = load_box(b2 + 4 * v);
    area2[v] = area(col[v]);
  }
  const T* b1 = boxes1 + u * d * 4;
  T* o = out + u * d * g + c;
  for (I r = r0; r < d; r += row_threads.d) {
    const Box<T> a = load_box(b1 + r * 4);
    const T area1 = area(a);
    T res[V];
#pragma unroll
    for (int v = 0; v < V; ++v) res[v] = iou(a, area1, col[v], area2[v]);
    store_run(o + r * g, res);
  }
}

template <typename T, int V>
int launch_vec(const T* boxes1, const T* boxes2, T* out, long long units, long long d, long long g,
               long long row_threads, int wide, cudaStream_t stream) {
  const long long runs = g / V;
  const long long threads = units * row_threads * runs;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (wide) {
    box_iou_kernel<T, V, unsigned long long, Div64><<<(unsigned)blocks, kThreads, 0, stream>>>(
        boxes1, boxes2, out, (unsigned long long)threads, (unsigned long long)d, (unsigned long long)g,
        Div64{(unsigned long long)runs}, Div64{(unsigned long long)row_threads});
  } else {
    box_iou_kernel<T, V, unsigned, Div32><<<(unsigned)blocks, kThreads, 0, stream>>>(
        boxes1, boxes2, out, (unsigned)threads, (unsigned)d, (unsigned)g, make_div32((unsigned)runs),
        make_div32((unsigned)row_threads));
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_box_iou(const void* boxes1, const void* boxes2, void* out, long long units, long long d, long long g,
                   int vec, long long row_threads, int wide, void* stream) {
  if (units < 1 || d < 1 || g < 1 || row_threads < 1 || row_threads > d) return (int)cudaErrorInvalidValue;
  const bool vec_ok = sizeof(T) == 4 ? (vec == 1 || vec == 2 || vec == 4) : vec == 1;
  if (!vec_ok || g % vec != 0) return (int)cudaErrorInvalidValue;
  // 32-bit offsets only where every element offset (and the thread count)
  // stays below 2**31
  const long long outputs = units * d * g;
  const long long coords = 4 * units * (d > g ? d : g);
  if (!wide && (outputs > 0x7fffffffLL || coords > 0x7fffffffLL)) return (int)cudaErrorInvalidValue;
  // the boxes are read 16 bytes at a time, the runs stored as vectors
  if ((((unsigned long long)boxes1 | (unsigned long long)boxes2 | (unsigned long long)out) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  const T* b1 = (const T*)boxes1;
  const T* b2 = (const T*)boxes2;
  T* o = (T*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  if constexpr (sizeof(T) == 4) {
    if (vec == 4) return launch_vec<T, 4>(b1, b2, o, units, d, g, row_threads, wide, s);
    if (vec == 2) return launch_vec<T, 2>(b1, b2, o, units, d, g, row_threads, wide, s);
  }
  return launch_vec<T, 1>(b1, b2, o, units, d, g, row_threads, wide, s);
}

}  // namespace

extern "C" {

// boxes1: [units * d, 4]; boxes2: [units * g, 4]; out: [units * d, g], all
// contiguous, 16-byte aligned, of one dtype. vec: columns a thread owns (4,
// 2 or 1 in float32, 1 in float64, dividing g); row_threads: threads per
// unit along d, each walking every row_threads-th row (1 <= row_threads <=
// d); wide: 64-bit offsets (required when the output or the boxes hold
// 2**31 elements or more).
int box_iou_f32(const void* boxes1, const void* boxes2, void* out, long long units, long long d, long long g, int vec,
                long long row_threads, int wide, void* stream) {
  return launch_box_iou<float>(boxes1, boxes2, out, units, d, g, vec, row_threads, wide, stream);
}

int box_iou_f64(const void* boxes1, const void* boxes2, void* out, long long units, long long d, long long g, int vec,
                long long row_threads, int wide, void* stream) {
  return launch_box_iou<double>(boxes1, boxes2, out, units, d, g, vec, row_threads, wide, stream);
}

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
