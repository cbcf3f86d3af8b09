"""Segment max and min (K2): the CUDA kernel, its plain version and the
device-routed entry points.

Counterpart of ``metrics_tpu/ops/scatter_pallas.py``'s
``segment_extremum_tiled`` and its ``segment_max_dispatch`` /
``segment_min_dispatch`` entries. The kernel lives in
``csrc/segment_extremum.cu`` (see its header for the design); it is the
row-order segment tile of ``segment_sum_f32`` with an extremum fold (an
integer max or min of totalOrder keys, split over blocks and combined when
S is small), counted as two kernels:

* :func:`segment_max_f32` / :func:`segment_min_f32` -- ``[B, D] x [B] ->
  [S, D]`` float32 max / min with the semantics of ``jax.ops.segment_max``
  / ``segment_min``: a NaN of either sign anywhere in a segment makes it NaN
  (the canonical quiet NaN); max gives +0.0 over -0.0 and min -0.0 over
  +0.0, in either order; empty segments hold -inf (max) or +inf (min); ids
  outside ``[0, S)``, negatives included, drop. Ids are int32 or int64.

:func:`segment_extremum_reference` computes the same function in plain
PyTorch over integer totalOrder keys (``scatter_reduce_`` of floats keeps
whichever zero it meets first); :func:`segment_max` / :func:`segment_min`
take it for CPU tensors only, and launch the kernel for CUDA tensors at any
B, S and D (the TPU's shape route is gone) or raise. Both kernels are
custom ops with the segment fold's vmap rule, as the segment sums are.
"""
import ctypes

import torch

from metrics_tpu_torch.ops.build import load
from metrics_tpu_torch.ops.dispatch import route
from metrics_tpu_torch.ops.segment_sum import FOLD_ARGS, define_fold_op
from metrics_tpu_torch.utils.data import _is_integer, _total_order_key

Tensor = torch.Tensor

SOURCE = "segment_extremum.cu"

_SIGNATURES = {
    "segment_max_f32_ids32": FOLD_ARGS,
    "segment_max_f32_ids64": FOLD_ARGS,
    "segment_min_f32_ids32": FOLD_ARGS,
    "segment_min_f32_ids64": FOLD_ARGS,
}


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    return load(SOURCE, _SIGNATURES)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def segment_max_f32(vals: Tensor, ids: Tensor, num_segments: int) -> Tensor:
    """Float32 ``[B, D]`` (or ``[B]``) rows folded by id into their max on
    the card. Under ``torch.func.vmap`` one launch folds every row."""
    return _SEGMENT_MAX(vals, ids, num_segments)


def segment_min_f32(vals: Tensor, ids: Tensor, num_segments: int) -> Tensor:
    """Float32 ``[B, D]`` (or ``[B]``) rows folded by id into their min on the card."""
    return _SEGMENT_MIN(vals, ids, num_segments)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _from_total_order_key(key: Tensor, dtype: torch.dtype) -> Tensor:
    """Inverse of ``_total_order_key`` (the map is its own inverse on the bits)."""
    flip = 0x7FFFFFFFFFFFFFFF if key.dtype == torch.int64 else 0x7FFFFFFF
    bits = torch.where(key < 0, key ^ flip, key)
    return bits.view(torch.float64 if key.dtype == torch.int64 else torch.float32).to(dtype)


def segment_extremum_reference(vals: Tensor, ids: Tensor, num_segments: int, is_max: bool) -> Tensor:
    """Plain segment max (``is_max``) or min over the leading axis, in the
    values' dtype, with ``jax.ops.segment_max/min``'s semantics (see the
    module docstring). Floats reduce over integer totalOrder keys, which
    order -0.0 below +0.0 and never round; a segment that saw a NaN is then
    set to NaN (totalOrder would rank -NaN lowest). Integers fill empty
    segments with their dtype's lowest (max) or highest (min) value.
    Out-of-range ids go to an extra row, which is then cut off."""
    ids = ids.reshape(-1).to(torch.int64)
    keep = (ids >= 0) & (ids < num_segments)
    index = torch.where(keep, ids, num_segments).reshape((-1,) + (1,) * (vals.ndim - 1)).expand(vals.shape)
    shape = (num_segments + 1,) + tuple(vals.shape[1:])
    mode = "amax" if is_max else "amin"
    if _is_integer(vals.dtype):
        info = torch.iinfo(vals.dtype)
        out = torch.full(shape, info.min if is_max else info.max, dtype=vals.dtype, device=vals.device)
        return out.scatter_reduce_(0, index, vals, mode, include_self=True)[:num_segments]
    if not vals.is_floating_point():
        raise TypeError(f"segment max/min takes integer or floating values, got {vals.dtype}")
    keys = _total_order_key(vals)
    # the empty segment's identity, made on the device (no host read)
    out = _total_order_key(torch.full(shape, -torch.inf if is_max else torch.inf, dtype=vals.dtype, device=vals.device))
    out.scatter_reduce_(0, index, keys, mode, include_self=True)
    nan_seen = torch.zeros(shape, dtype=torch.int32, device=vals.device)
    nan_seen.scatter_reduce_(0, index, torch.isnan(vals).to(torch.int32), "amax", include_self=True)
    values = _from_total_order_key(out, vals.dtype)
    values = torch.where(nan_seen > 0, torch.full_like(values, float("nan")), values)
    return values[:num_segments]


# the custom ops ``metrics_tpu_torch::segment_max_f32``/``segment_min_f32``:
# the launch on the card, the plain version on the CPU, a fake and the fold's
# vmap rule (see :mod:`metrics_tpu_torch.ops.segment_sum`)
_SEGMENT_MAX = define_fold_op(
    "segment_max_f32", load_library, torch.float32, True, -torch.inf, lambda vals, ids, s: segment_extremum_reference(vals, ids, s, True)
)
_SEGMENT_MIN = define_fold_op(
    "segment_min_f32", load_library, torch.float32, True, torch.inf, lambda vals, ids, s: segment_extremum_reference(vals, ids, s, False)
)


# ---------------------------------------------------------------------------
# device-routed entry points
# ---------------------------------------------------------------------------


def _segment_extremum(vals: Tensor, ids: Tensor, num_segments: int, is_max: bool) -> Tensor:
    if not route("segment_extremum", vals, ids):
        if ids.is_floating_point():
            raise TypeError(f"segment ids must be integer-typed, got dtype {ids.dtype}")
        return segment_extremum_reference(vals, ids, num_segments, is_max)
    return (segment_max_f32 if is_max else segment_min_f32)(vals, ids, num_segments)


def segment_max(vals: Tensor, ids: Tensor, num_segments: int) -> Tensor:
    """Segment max of ``[B]`` / ``[B, D]`` values: the kernel for CUDA
    tensors (float32 only; other dtypes raise), the plain version for CPU
    tensors (any integer or floating dtype)."""
    return _segment_extremum(vals, ids, num_segments, True)


def segment_min(vals: Tensor, ids: Tensor, num_segments: int) -> Tensor:
    """Segment min (see :func:`segment_max`)."""
    return _segment_extremum(vals, ids, num_segments, False)


def _dispatch(vals: Tensor, ids: Tensor, num_segments: int, is_max: bool) -> Tensor:
    # trailing dims flatten through the 2-D kernel and restore: exact for an
    # elementwise extremum
    lead = vals.shape[0] if vals.ndim else 0
    flat = vals.reshape(lead, -1) if vals.ndim > 2 else vals
    out = _segment_extremum(flat, ids, num_segments, is_max)
    if vals.ndim > 2:
        out = out.reshape((num_segments,) + tuple(vals.shape[1:]))
    return out


def segment_max_dispatch(vals: Tensor, ids: Tensor, num_segments: int) -> Tensor:
    """Segment max over the LEADING axis: ``[B, ...]`` rows fold into
    ``[num_segments, ...]``; trailing dims are flattened through the kernel
    and restored."""
    return _dispatch(vals, ids, num_segments, True)


def segment_min_dispatch(vals: Tensor, ids: Tensor, num_segments: int) -> Tensor:
    """Segment min over the LEADING axis (see :func:`segment_max_dispatch`)."""
    return _dispatch(vals, ids, num_segments, False)
