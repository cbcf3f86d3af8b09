"""Box IoU: the CUDA kernels, their plain versions, and the device-routed
entry point.

Counterpart of ``metrics_tpu/ops/box_iou_pallas.py`` (``box_iou_tiled``,
``box_iou_batched_tiled`` and their ``box_iou_dispatch`` entry). Both kernels
are one CUDA kernel template in ``csrc/box_iou.cu`` (see its header for the
design), counted under two names:

* :func:`box_iou_pairwise` -- ``[N, 4] x [M, 4] -> [N, M]`` (K5);
* :func:`box_iou_batched` -- ``[U, D, 4] x [U, G, 4] -> [U, D, G]``, one
  (image, class) unit per leading index: the mAP matcher's shape (K6).

The kernel computes in the jnp broadcast's order with no FMA contraction,
so it equals its plain version, :func:`box_iou_reference` (the broadcast
:func:`box_iou_broadcast` in the same order), bit for bit; CPU tensors take
the plain version. :func:`box_iou` routes by the tensors'
device only: there is no shape route (the JAX package's route thresholds
were measured on a TPU). Integer boxes compute in float32 and float64
boxes in float64 on both routes, so the result's dtype and values never
depend on the route.
"""
import ctypes
import functools
from typing import Tuple

import torch

from metrics_tpu_torch.ops.build import load
from metrics_tpu_torch.ops.dispatch import check_cuda, launch, route

Tensor = torch.Tensor

SOURCE = "box_iou.cu"

#: the CUDA kernels one call may launch (a profiler sums them per call):
#: one template, instantiated per dtype, run width and offset width
CUDA_KERNELS = ("box_iou_kernel",)

#: rows of its unit a thread walks at most; while the walk lengthens, the
#: threads a launch keeps at least (a wave of 1024 threads an SM on 132 SMs)
#: and the lanes a unit keeps per row step (a float32 warp's stores then
#: stay runs of whole 128-byte lines)
MAX_ROWS = 8
MIN_THREADS = 1 << 17
MIN_UNIT_LANES = 8

_PTR, _LL, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
#: (boxes1, boxes2, out, units, d, g, vec, row_threads, wide, stream)
_SIGNATURES = {
    "box_iou_f32": [_PTR, _PTR, _PTR, _LL, _LL, _LL, _I32, _LL, _I32, _PTR],
    "box_iou_f64": [_PTR, _PTR, _PTR, _LL, _LL, _LL, _I32, _LL, _I32, _PTR],
}


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    return load(SOURCE, _SIGNATURES)


def result_dtype(boxes1: Tensor, boxes2: Tensor) -> torch.dtype:
    """The JAX package's ``result_type(boxes1, boxes2, float32)``: float64
    stays float64, every other input (integers, bool, half) gives float32."""
    dtype = torch.promote_types(torch.promote_types(boxes1.dtype, boxes2.dtype), torch.float32)
    return dtype if dtype in (torch.float32, torch.float64) else torch.float32


def _check_boxes(name: str, boxes1: Tensor, boxes2: Tensor, ndim: int) -> None:
    if boxes1.ndim != ndim or boxes2.ndim != ndim or boxes1.shape[-1] != 4 or boxes2.shape[-1] != 4:
        raise ValueError(
            f"{name} takes two {'[N, 4]' if ndim == 2 else '[U, D, 4] and [U, G, 4]'} box tensors,"
            f" got shapes {tuple(boxes1.shape)} and {tuple(boxes2.shape)}"
        )
    if ndim == 3 and boxes1.shape[0] != boxes2.shape[0]:
        raise ValueError(f"{name}: the leading (unit) dims differ, {boxes1.shape[0]} and {boxes2.shape[0]}")


@functools.lru_cache(maxsize=1024)
def box_iou_geometry(units: int, d: int, g: int, dtype: torch.dtype = torch.float32) -> Tuple[int, int, bool]:
    """The kernel's launch geometry for ``[units, d, 4] x [units, g, 4]``
    in ``dtype``: ``(vec, row_threads, wide)``.

    ``vec`` columns a thread owns: in float32 the widest of 4 and 2 that
    divides ``g`` and leaves the launch :data:`MIN_THREADS` threads, else 1,
    so each run is one aligned vector store; in float64 1 (its FP64 pipe
    binds, and more threads beat fewer loads).
    ``row_threads`` threads per unit along ``d``, each walking every
    ``row_threads``-th row: the walk doubles up to :data:`MAX_ROWS` rows
    while the launch keeps :data:`MIN_THREADS` threads and each unit
    :data:`MIN_UNIT_LANES` lanes a row step. ``wide``: 64-bit offsets, once
    the output or the boxes hold ``2**31`` elements or more.
    """
    vec = 1
    if dtype != torch.float64:
        vec = next((v for v in (4, 2) if g % v == 0 and units * d * (g // v) >= MIN_THREADS), 1)
    runs = g // vec
    rows = 1
    while rows < MAX_ROWS and 2 * rows <= d:
        row_threads = -(-d // (2 * rows))
        if units * row_threads * runs < MIN_THREADS or row_threads * runs < MIN_UNIT_LANES:
            break
        rows *= 2
    wide = max(units * d * g, 4 * units * max(d, g)) >= 2**31
    return vec, -(-d // rows), wide


def _aligned(boxes: Tensor, dtype: torch.dtype) -> Tensor:
    """``boxes`` in ``dtype``, contiguous and 16-byte aligned (the kernel
    reads a box with 16-byte loads; a view may start mid-box)."""
    boxes = boxes.to(dtype).contiguous()
    return boxes if boxes.data_ptr() % 16 == 0 else boxes.clone()


def _launch(kernel: str, boxes1: Tensor, boxes2: Tensor, units: int, d: int, g: int) -> Tensor:
    dtype = result_dtype(boxes1, boxes2)
    out = torch.empty((units, d, g), dtype=dtype, device=boxes1.device)
    if out.numel() == 0:  # nothing to compute: no launch
        return out
    b1, b2 = _aligned(boxes1, dtype), _aligned(boxes2, dtype)
    lib = load_library()
    fn = lib.box_iou_f64 if dtype == torch.float64 else lib.box_iou_f32
    vec, row_threads, wide = box_iou_geometry(units, d, g, dtype)
    launch(kernel, lib, b1.device, fn, b1.data_ptr(), b2.data_ptr(), out.data_ptr(), units, d, g, vec, row_threads, int(wide))
    return out


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def box_iou_pairwise(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """IoU of every pair of ``[N, 4]`` and ``[M, 4]`` xyxy boxes on the card: ``[N, M]``."""
    check_cuda("box_iou_pairwise", boxes1, boxes2)
    _check_boxes("box_iou_pairwise", boxes1, boxes2, 2)
    return _launch("box_iou_pairwise", boxes1, boxes2, 1, boxes1.shape[0], boxes2.shape[0])[0]


def box_iou_batched(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """IoU per unit of ``[U, D, 4]`` and ``[U, G, 4]`` xyxy boxes on the card: ``[U, D, G]``."""
    check_cuda("box_iou_batched", boxes1, boxes2)
    _check_boxes("box_iou_batched", boxes1, boxes2, 3)
    return _launch("box_iou_batched", boxes1, boxes2, boxes1.shape[0], boxes1.shape[1], boxes2.shape[1])


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def box_iou_broadcast(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Pairwise IoU of xyxy boxes by broadcasting, ``[..., N, 4] x [..., M, 4]
    -> [..., N, M]``, in the inputs' dtype; 0 where the union is not
    positive. The JAX package's jnp broadcast (``functional/detection/
    box_ops.py:box_iou``) in its operation order, equal to it bit for bit."""
    area1 = (boxes1[..., 2] - boxes1[..., 0]) * (boxes1[..., 3] - boxes1[..., 1])  # [..., N]
    area2 = (boxes2[..., 2] - boxes2[..., 0]) * (boxes2[..., 3] - boxes2[..., 1])  # [..., M]
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])  # [..., N, M, 2]
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    # XLA's max(x, 0) gives +0.0 for -0.0 where torch.clamp keeps -0.0;
    # adding 0 makes it +0.0 and leaves every other value (NaN included, and
    # integer dtypes) as it is
    wh = torch.clamp(rb - lt, min=0) + 0
    inter = wh[..., 0] * wh[..., 1]  # [..., N, M]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0), 0.0)


def box_iou_reference(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """The kernels' plain version: the boxes cast to :func:`result_dtype`,
    then :func:`box_iou_broadcast` (the kernel's arithmetic, in its order)."""
    dtype = result_dtype(boxes1, boxes2)
    return box_iou_broadcast(boxes1.to(dtype), boxes2.to(dtype))


# ---------------------------------------------------------------------------
# device-routed entry point
# ---------------------------------------------------------------------------


def box_iou(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Box IoU of xyxy boxes: ``[N, 4] x [M, 4] -> [N, M]`` (K5 on the card)
    or ``[U, D, 4] x [U, G, 4] -> [U, D, G]`` (K6 on the card); the plain
    version for CPU tensors. Other shapes raise ``ValueError``."""
    pairwise = boxes1.ndim == 2 and boxes2.ndim == 2
    _check_boxes("box_iou", boxes1, boxes2, 2 if pairwise else 3)
    if not route("box_iou", boxes1, boxes2):
        return box_iou_reference(boxes1, boxes2)
    return box_iou_pairwise(boxes1, boxes2) if pairwise else box_iou_batched(boxes1, boxes2)
