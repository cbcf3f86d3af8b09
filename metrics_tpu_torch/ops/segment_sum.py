"""Segment-sum and bincount: the CUDA kernels, their plain versions, and
the device-routed entry points.

Counterpart of ``metrics_tpu/ops/scatter_pallas.py`` (``segment_sum_tiled``
and its ``bincount_dispatch`` / ``segment_sum_dispatch`` entries). The
kernels live in ``csrc/segment_sum.cu`` (see its header for the design):

* :func:`bincount_i32` -- int32 counts of int32/int64 ids, out-of-range
  and negative ids dropped in the kernel;
* :func:`segment_sum_f32` -- ``[B, D] x [B] -> [S, D]`` float32 sums,
  deterministic, each (segment, column) summed in row order;
* :func:`segment_sum_i32` -- the same over int32 values, wrapping modulo
  2**32 as XLA's int32 scatter-add does (the integer leaves of
  ``SlicedMetric``).

Each wrapper takes CUDA tensors only, launches on the current stream and
counts its launch (:mod:`metrics_tpu_torch.ops.dispatch`). The plain
versions, :func:`bincount_reference` and :func:`segment_sum_reference`,
compute the same functions with ``torch.bincount`` / ``index_add_``; the
entry points use them for CPU tensors only. The segment sums share their
row-order tile with K2's segment max/min (``csrc/segment_fold.cuh``,
:mod:`metrics_tpu_torch.ops.segment_extremum`); :func:`segment_fold_launch`
launches it for all four, with the geometry of :func:`segment_fold_geometry`
(cached per shape) and each C launcher bound once. A fold whose rows split
over blocks (the int32 sum, max and min, when S is small) launches a
second kernel that combines the partial tiles; the call still counts as
one launch.

**Under ``torch.func.vmap`` and CUDA-graph capture.** The five wrappers of
this family (``bincount_i32``, ``segment_sum_f32`` and ``segment_sum_i32``
here, ``segment_max_f32``/``segment_min_f32`` in
:mod:`metrics_tpu_torch.ops.segment_extremum`) call ``torch.library``
custom ops in the ``metrics_tpu_torch`` namespace: a CUDA implementation
(the launch), a CPU implementation (the plain version), a fake one (the
output's static shape) and a vmap rule. A vmapped call (a sliced metric's
per-row update reaching a kernel) is one launch over the flattened batch:
``V`` bincounts over ``minlength`` bins become one over ``V * minlength``
bins at ``ids + v * minlength``, ``V`` folds over ``S`` segments one over
``V * S`` segments. An id out of its row's range is masked to ``-1``
before the offset, so it drops in the kernel and never lands in a
neighbouring row; each segment keeps its rows in order, so the float sum's
bits are those of ``V`` separate calls. The Python wrappers stay the entry
points and take CUDA tensors only: a tensor that ``torch.func`` wraps takes
the op, a plain one launches directly (the op's CUDA implementation without
the dispatcher, which costs 20-25 us of host time a call on an H100 host).
"""
import ctypes
import functools
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch._C._functorch import is_functorch_wrapped_tensor

from metrics_tpu_torch.ops.build import load
from metrics_tpu_torch.ops.dispatch import check_cuda, launch, route
from metrics_tpu_torch.utils.data import _as_tensor, _is_integer

Tensor = torch.Tensor

SOURCE = "segment_sum.cu"

#: launch geometry of the row-order segment tile (must match the constants
#: of ``csrc/segment_fold.cuh``)
_WARPS = 8
_TILE_FLOATS = 10240
#: blocks to aim for when S is small: about two per SM of an H100 (132 SMs)
_TARGET_BLOCKS = 264
#: the float sum's widest column chunk (``kOrderedMaxCols`` of the tile): a
#: block stages 1024 rows of it at a time in 64 KB
_ORDERED_MAX_DC = 16
#: the fewest values (rows x columns of a block) a row split of an
#: order-free fold takes
_MIN_SPLIT_VALUES = 4096

_PTR, _LL, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
#: the C launchers of the row-order segment tile (segment_sum.cu and
#: segment_extremum.cu): vals, ids, B, D, out, S, dc, sw, segment tiles,
#: column chunks, row splits, rows per split, scratch, stream
FOLD_ARGS = [_PTR, _PTR, _LL, _I32, _PTR, _LL, _I32, _I32, _LL, _I32, _I32, _LL, _PTR, _PTR]
_SIGNATURES = {
    "bincount_i32_ids32": [_PTR, _LL, _PTR, _LL, _PTR],
    "bincount_i32_ids64": [_PTR, _LL, _PTR, _LL, _PTR],
    "segment_sum_f32_ids32": FOLD_ARGS,
    "segment_sum_f32_ids64": FOLD_ARGS,
    "segment_sum_i32_ids32": FOLD_ARGS,
    "segment_sum_i32_ids64": FOLD_ARGS,
}


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' shared library."""
    return load(SOURCE, _SIGNATURES)


def _ids_for_kernel(ids: Tensor) -> Tensor:
    """Kernel ids are int32 or int64; narrower integers are promoted (never
    narrowed: a downcast could wrap a huge label into range)."""
    if not _is_integer(ids.dtype):
        raise TypeError(f"segment ids must be integer-typed, got dtype {ids.dtype}")
    if ids.dtype not in (torch.int32, torch.int64):
        ids = ids.to(torch.int32)
    return ids.reshape(-1).contiguous()


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def bincount_i32(ids: Tensor, minlength: int) -> Tensor:
    """int32 counts of ``ids`` over ``[0, minlength)`` on the card; other
    ids drop. Under ``torch.func.vmap`` one launch counts every row."""
    check_cuda("bincount_i32", ids)
    if _wrapped(ids):
        return _BINCOUNT_OP(ids, minlength, False)
    return _bincount_launch(ids, minlength)


def _bincount_launch(ids: Tensor, minlength: int, batched: bool = False) -> Tensor:
    """The ``bincount_i32`` op's CUDA implementation: one launch
    (``batched`` when it counts every row of a vmap)."""
    ids = _ids_for_kernel(ids)
    lib = load_library()
    out = torch.zeros(minlength, dtype=torch.int32, device=ids.device)
    fn = lib.bincount_i32_ids64 if ids.dtype == torch.int64 else lib.bincount_i32_ids32
    launch("bincount_i32", lib, ids.device, fn, ids.data_ptr(), ids.numel(), out.data_ptr(), minlength, batched=batched)
    return out


def segment_sum_geometry(d: int, num_segments: int, max_dc: int = 32) -> Tuple[int, int, int, int]:
    """``(dc, sw, seg_tiles, col_chunks)`` of the row-order segment tile:
    ``dc`` columns per block (at most ``max_dc``, at most one warp's 32
    lanes), ``sw`` segments per warp, and the grid's segment tiles and column
    chunks. The tile (8 warps x ``sw`` segments x ``dc`` columns) fits the
    kernel's 40 KB of segment tile; ``sw`` shrinks when S is small so that
    about ``_TARGET_BLOCKS`` blocks are in flight."""
    dc = min(d, max_dc)
    col_chunks = -(-d // dc)
    sw_max = _TILE_FLOATS // (_WARPS * dc)
    sw = max(1, min(sw_max, math.ceil(num_segments * col_chunks / (_WARPS * _TARGET_BLOCKS))))
    seg_tiles = -(-num_segments // (_WARPS * sw))
    return dc, sw, seg_tiles, col_chunks


class FoldGeometry(NamedTuple):
    """A launch of the row-order segment tile: the grid is ``(seg_tiles,
    col_chunks, splits)``; block ``(x, y, z)`` folds segments ``[x * 8 * sw,
    (x + 1) * 8 * sw)``, columns ``[y * dc, (y + 1) * dc)`` and rows ``[z *
    rows_per_split, (z + 1) * rows_per_split)``, each cut at S, D and B."""

    dc: int
    sw: int
    seg_tiles: int
    col_chunks: int
    splits: int
    rows_per_split: int


@functools.lru_cache(maxsize=4096)
def segment_fold_geometry(b: int, d: int, num_segments: int, order_free: bool) -> FoldGeometry:
    """The launch of a ``[b, d] -> [num_segments, d]`` fold. The float sum
    (not ``order_free``) keeps one row split, so each output is added in row
    order, and takes :func:`segment_sum_geometry` at up to 16 columns a
    block. A fold that is associative and commutative on the bits
    (``order_free``: the int32 sum, max, min) first splits its rows over
    blocks, each split folding at least ``_MIN_SPLIT_VALUES`` values in a
    block, and then cuts the segments into as few tiles as bring the grid to
    about ``_TARGET_BLOCKS`` blocks: a block reads every id of its split, so
    fewer tiles read the ids fewer times."""
    if not order_free:
        dc, sw, seg_tiles, col_chunks = segment_sum_geometry(d, num_segments, _ORDERED_MAX_DC)
        return FoldGeometry(dc, sw, seg_tiles, col_chunks, 1, b)
    dc, sw, seg_tiles, col_chunks = segment_sum_geometry(d, num_segments)
    splits = max(1, min(b * dc // _MIN_SPLIT_VALUES, -(-_TARGET_BLOCKS // col_chunks)))
    sw_max = _TILE_FLOATS // (_WARPS * dc)
    sw = max(1, min(sw_max, math.ceil(num_segments * col_chunks * splits / (_WARPS * _TARGET_BLOCKS))))
    seg_tiles = -(-num_segments // (_WARPS * sw))
    return FoldGeometry(dc, sw, seg_tiles, col_chunks, splits, -(-b // splits))


#: (kernel, id dtype) -> (library, C launcher), bound at first use
_LAUNCHERS: Dict[Tuple[str, torch.dtype], Tuple[ctypes.CDLL, Any]] = {}


def _bound_launcher(kernel: str, load_library: Callable[[], ctypes.CDLL], ids_dtype: torch.dtype):
    bound = _LAUNCHERS.get((kernel, ids_dtype))
    if bound is None:
        lib = load_library()
        bound = (lib, getattr(lib, f"{kernel}_ids64" if ids_dtype == torch.int64 else f"{kernel}_ids32"))
        _LAUNCHERS[(kernel, ids_dtype)] = bound
    return bound


def segment_fold_launch(
    kernel: str,
    load_library: Callable[[], ctypes.CDLL],
    dtype: torch.dtype,
    order_free: bool,
    vals: Tensor,
    ids: Tensor,
    num_segments: int,
    empty_fill: Any,
    batched: bool = False,
) -> Tensor:
    """Launch the row-order segment tile ``kernel`` (``segment_sum_f32``,
    ``segment_sum_i32``, ``segment_max_f32`` or ``segment_min_f32``: the C
    launchers ``<kernel>_ids32``/``_ids64`` of the library ``load_library``
    gives) on ``[B, D]`` (or ``[B]``) card values of ``dtype``; the output is
    ``[num_segments, D]`` (or ``[num_segments]``). ``order_free`` folds may
    split their rows over blocks (a scratch buffer of partials and a combine
    launch). ``empty_fill`` fills an output without columns."""
    check_cuda(kernel, vals, ids)
    if vals.dtype != dtype:
        raise TypeError(f"{kernel} takes {dtype} values, got {vals.dtype}")
    ndim = vals.dim()
    if ndim == 1:
        b, d = vals.shape[0], 1
    elif ndim == 2:
        b, d = vals.shape
    else:
        raise ValueError(f"{kernel} takes [B] or [B, D] values, got shape {tuple(vals.shape)}")
    if not vals.is_contiguous():
        vals = vals.contiguous()
    if ids.dtype not in (torch.int32, torch.int64) or ids.dim() != 1 or not ids.is_contiguous():
        ids = _ids_for_kernel(ids)
    if ids.shape[0] != b:
        raise ValueError(f"expected {b} segment ids, got {ids.numel()}")
    device = vals.device
    if d == 0:  # nothing to fold: no launch
        return torch.full((num_segments, 0), empty_fill, dtype=dtype, device=device)
    g = segment_fold_geometry(b, d, num_segments, order_free)
    out = torch.empty((num_segments, d) if ndim == 2 else (num_segments,), dtype=dtype, device=device)
    scratch = torch.empty(g.splits * num_segments * d, dtype=dtype, device=device) if g.splits > 1 else None
    lib, fn = _bound_launcher(kernel, load_library, ids.dtype)
    launch(
        kernel,
        lib,
        device,
        fn,
        vals.data_ptr(), ids.data_ptr(), b, d, out.data_ptr(), num_segments, g.dc, g.sw, g.seg_tiles, g.col_chunks,
        g.splits, g.rows_per_split, None if scratch is None else scratch.data_ptr(),
        batched=batched,
    )
    return out


def segment_sum_f32(vals: Tensor, ids: Tensor, num_segments: int) -> Tensor:
    """``[B, D]`` (or ``[B]``) float32 rows summed by id into
    ``[num_segments, D]`` (or ``[num_segments]``) on the card; out-of-range
    ids drop. Deterministic: each output is summed in row order."""
    return _SEGMENT_SUM_F32(vals, ids, num_segments)


def segment_sum_i32(vals: Tensor, ids: Tensor, num_segments: int) -> Tensor:
    """int32 ``[B, D]`` (or ``[B]``) rows summed by id on the card, wrapping
    modulo 2**32; out-of-range ids drop."""
    return _SEGMENT_SUM_I32(vals, ids, num_segments)


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def bincount_reference(ids: Tensor, minlength: int) -> Tensor:
    """Plain bincount: out-of-range ids are masked to an extra bin first
    (``torch.bincount`` raises on negatives), which is then cut off."""
    ids = ids.reshape(-1).to(torch.int64)
    keep = (ids >= 0) & (ids < minlength)
    counts = torch.bincount(torch.where(keep, ids, minlength), minlength=minlength + 1)
    return counts[:minlength].to(torch.int32)


def segment_sum_reference(vals: Tensor, ids: Tensor, num_segments: int) -> Tensor:
    """Plain segment-sum over the leading axis with ``index_add_``, in the
    values' dtype; out-of-range ids go to an extra row (``index_add_``
    asserts on them), which is then cut off. int32 values are summed in
    int64 and wrapped modulo 2**32, as XLA's int32 scatter-add wraps."""
    ids = ids.reshape(-1).to(torch.int64)
    keep = (ids >= 0) & (ids < num_segments)
    wide = vals.to(torch.int64) if vals.dtype == torch.int32 else vals
    out = wide.new_zeros((num_segments + 1,) + tuple(vals.shape[1:]))
    out.index_add_(0, torch.where(keep, ids, num_segments), wide)
    out = out[:num_segments]
    if vals.dtype == torch.int32:
        low = out & 0xFFFFFFFF
        out = torch.where(low >= 1 << 31, low - (1 << 32), low).to(torch.int32)
    return out


# ---------------------------------------------------------------------------
# the custom ops: CUDA launch, plain CPU version, fake, vmap rule
# ---------------------------------------------------------------------------

#: the ``torch.library`` namespace of the port's kernels
OP_NAMESPACE = "metrics_tpu_torch"


def _wrapped(*tensors: Tensor) -> bool:
    """Whether ``torch.func`` wraps any of ``tensors`` (a vmapped row): such
    a call takes the custom op, whose vmap rule launches once for the batch."""
    return any(is_functorch_wrapped_tensor(t) for t in tensors)


def _check_values(kernel: str, vals: Tensor, dtype: torch.dtype) -> None:
    """Raise unless ``vals`` have the kernel's value dtype (the launch and
    the op's CPU implementation take the same values)."""
    if vals.dtype != dtype:
        raise TypeError(f"{kernel} takes {dtype} values, got {vals.dtype}")


def _flat_ids(ids: Tensor, v: int, width: int) -> Tensor:
    """``[V, n]`` per-row ids in ``[0, width)`` as one ``[V * n]`` id vector
    over ``V * width``: row ``v``'s ids shifted by ``v * width``; an id out
    of its row's range becomes -1, which the kernels drop."""
    ids = ids.reshape(v, -1)
    wide = v * width >= 2**31 or ids.dtype == torch.int64
    offsets = torch.arange(v, dtype=torch.int64 if wide else torch.int32, device=ids.device)[:, None] * width
    keep = (ids >= 0) & (ids < width)
    return torch.where(keep, ids.to(offsets.dtype) + offsets, -1).reshape(-1)


def _bincount_vmap(info: Any, in_dims: Tuple[Optional[int], ...], ids: Tensor, minlength: int, batched: bool = False) -> Tuple[Tensor, Any]:
    """A vmapped ``bincount_i32``: ``V`` rows of ids, one launch over
    ``V * minlength`` bins."""
    if in_dims[0] is None:
        return _BINCOUNT_OP(ids, minlength, batched), None
    v = info.batch_size
    counts = _BINCOUNT_OP(_flat_ids(ids.movedim(in_dims[0], 0), v, minlength), v * minlength, True)
    return counts.reshape(v, minlength), 0


def fold_vmap(op: Any) -> Callable[..., Tuple[Tensor, Any]]:
    """The vmap rule of a row-order segment fold op ``op(vals, ids, S,
    batched)``: ``V`` folds of ``[B]``/``[B, D]`` rows over ``S`` segments
    are one fold of the ``V * B`` rows over ``V * S`` segments (an
    unbatched argument is expanded to the batch first)."""

    def rule(info: Any, in_dims: Tuple[Optional[int], ...], vals: Tensor, ids: Tensor, num_segments: int, batched: bool = False):
        vals_dim, ids_dim = in_dims[0], in_dims[1]
        if vals_dim is None and ids_dim is None:
            return op(vals, ids, num_segments, batched), None
        v = info.batch_size
        vals = vals.movedim(vals_dim, 0) if vals_dim is not None else vals.expand((v,) + tuple(vals.shape))
        ids = ids.movedim(ids_dim, 0) if ids_dim is not None else ids.expand((v,) + tuple(ids.shape))
        rows = vals.reshape((-1,) + tuple(vals.shape[2:]))
        out = op(rows, _flat_ids(ids, v, num_segments), v * num_segments, True)
        return out.reshape((v, num_segments) + tuple(out.shape[1:])), 0

    return rule


def define_fold_op(
    kernel: str,
    load_library: Callable[[], ctypes.CDLL],
    dtype: torch.dtype,
    order_free: bool,
    empty_fill: Any,
    plain_fn: Callable[[Tensor, Tensor, int], Tensor],
) -> Callable[[Tensor, Tensor, int], Tensor]:
    """Register the row-order segment fold ``kernel`` (the arguments of
    :func:`segment_fold_launch`) as the custom op
    ``metrics_tpu_torch::<kernel>(vals, ids, S, batched=False)``: the launch
    on the card, ``plain_fn`` on the CPU, a fake of the ``[S]``/``[S, D]``
    output in the values' dtype and :func:`fold_vmap`. Returns the
    wrapper's body: the op for tensors that ``torch.func`` wraps (their
    values detached: the kernels have no gradient), the launch for plain
    ones."""

    def cuda_impl(vals: Tensor, ids: Tensor, num_segments: int, batched: bool = False) -> Tensor:
        return segment_fold_launch(kernel, load_library, dtype, order_free, vals, ids, num_segments, empty_fill, batched)

    op = torch.library.custom_op(f"{OP_NAMESPACE}::{kernel}", cuda_impl, mutates_args=(), device_types="cuda")

    @op.register_kernel("cpu")
    def _(vals: Tensor, ids: Tensor, num_segments: int, batched: bool = False) -> Tensor:
        _check_values(kernel, vals, dtype)
        return plain_fn(vals, ids, num_segments)

    @op.register_fake
    def _(vals: Tensor, ids: Tensor, num_segments: int, batched: bool = False) -> Tensor:
        return vals.new_empty((num_segments,) + tuple(vals.shape[1:2]))

    overload = op._opoverload
    op.register_vmap(fold_vmap(overload))

    def call(vals: Tensor, ids: Tensor, num_segments: int) -> Tensor:
        if _wrapped(vals, ids):
            check_cuda(kernel, vals, ids)
            return overload(vals.detach(), ids, num_segments, False)
        return segment_fold_launch(kernel, load_library, dtype, order_free, vals, ids, num_segments, empty_fill)

    return call


@torch.library.custom_op(f"{OP_NAMESPACE}::bincount_i32", mutates_args=(), device_types="cuda")
def _bincount_op(ids: Tensor, minlength: int, batched: bool = False) -> Tensor:
    return _bincount_launch(ids, minlength, batched)


@_bincount_op.register_kernel("cpu")
def _(ids: Tensor, minlength: int, batched: bool = False) -> Tensor:
    return bincount_reference(ids, minlength)


@_bincount_op.register_fake
def _(ids: Tensor, minlength: int, batched: bool = False) -> Tensor:
    return ids.new_empty(minlength, dtype=torch.int32)


_bincount_op.register_vmap(_bincount_vmap)
_BINCOUNT_OP = _bincount_op._opoverload

_SEGMENT_SUM_F32 = define_fold_op("segment_sum_f32", load_library, torch.float32, False, 0.0, segment_sum_reference)
_SEGMENT_SUM_I32 = define_fold_op("segment_sum_i32", load_library, torch.int32, True, 0, segment_sum_reference)


# ---------------------------------------------------------------------------
# device-routed entry points
# ---------------------------------------------------------------------------


def segment_sum(vals: Tensor, ids: Tensor, num_segments: int) -> Tensor:
    """Segment-sum of ``[B]`` / ``[B, D]`` values: a kernel for CUDA
    tensors (``segment_sum_f32`` for float32, ``segment_sum_i32`` for int32;
    other dtypes raise), the plain version for CPU tensors (any dtype,
    result in the values' dtype)."""
    if not route("segment_sum", vals, ids):
        if ids.is_floating_point():
            raise TypeError(f"segment ids must be integer-typed, got dtype {ids.dtype}")
        return segment_sum_reference(vals, ids, num_segments)
    if vals.dtype == torch.int32:
        return segment_sum_i32(vals, ids, num_segments)
    return segment_sum_f32(vals, ids, num_segments)


def segment_sum_dispatch(vals: Tensor, ids: Tensor, num_segments: int) -> Tensor:
    """Segment-sum over the LEADING axis: ``[B, ...]`` rows add into
    ``[num_segments, ...]``. Trailing dims are flattened through the kernel
    and restored. Out-of-range ids (negative included) drop."""
    lead = vals.shape[0] if vals.ndim else 0
    flat = vals.reshape(lead, -1) if vals.ndim > 2 else vals
    out = segment_sum(flat, ids, num_segments)
    if vals.ndim > 2:
        out = out.reshape((num_segments,) + tuple(vals.shape[1:]))
    return out


def bincount_dispatch(x: Any, minlength: int, device: Optional[Any] = None) -> Tensor:
    """Static-length int32 bincount with hardened inputs, as the JAX
    package's ``bincount_dispatch``:

    * ``minlength`` must be a positive Python int;
    * ``x`` must be integer-typed: floats (and bools) raise ``TypeError``;
    * negative ids raise ``ValueError`` when they are already on the host
      (numpy arrays, lists, tuples), a free check. Tensor ids are never read
      back for validation: their negatives drop, like ids past
      ``minlength``, on both the card and the CPU.

    Host ids go to ``device`` (the card unless ``device="cpu"``); tensors
    count where they lie.
    """
    if not isinstance(minlength, int) or isinstance(minlength, bool) or minlength <= 0:
        raise ValueError(f"`minlength` must be a positive int, got {minlength!r}")
    host_vals = np.asarray(x) if isinstance(x, (np.ndarray, list, tuple)) else None
    if host_vals is not None and not np.issubdtype(host_vals.dtype, np.integer):
        raise TypeError(
            f"bincount indices must be integer-typed, got dtype {host_vals.dtype};"
            " cast labels to an integer dtype at the call site"
        )
    if host_vals is not None and host_vals.size and host_vals.min() < 0:
        raise ValueError(f"bincount indices must be non-negative, got min {int(host_vals.min())}")
    x = _as_tensor(x if host_vals is None else host_vals, device).reshape(-1)
    if not _is_integer(x.dtype):
        raise TypeError(
            f"bincount indices must be integer-typed, got dtype {x.dtype};"
            " cast labels to an integer dtype at the call site"
        )
    if route("bincount", x):
        return bincount_i32(x, minlength)
    return bincount_reference(x, minlength)
