"""Mergeable weighted quantile sketch with a fixed-shape state.

Counterpart of ``metrics_tpu/sketches/quantile.py``. The sketch is one
packed ``[capacity, 2 + payload_cols]`` float32 tensor:

    column 0: weight (``> 0`` means an occupied slot)
    column 1: key (the value the sketch orders and quantiles by)
    columns 2..: payload riding with each key (labels, one-hot rows, ...)

Inserts append into the first free slots (a stable pack), so while the
inserted rows fit in ``capacity`` the sketch IS the stream, in arrival
order: the lossless window. On overflow the rows compact by one
merging-t-digest pass (:func:`metrics_tpu_torch.ops.qsketch_compact_dispatch`:
the sort/bucket kernel and the segment-sum kernel on the card; the stable
pack, the epilogue and the plain compaction live beside it in
``ops/qsketch.py``), which keeps
every first moment of the payload exactly. Merges concatenate and take the
same step.

**The overflow branch without a host read.** The JAX package compacts
under ``lax.cond(n_occupied > capacity)``, on the device. Here each sketch
tensor carries a host-side upper bound on its occupied rows (an attribute
set by :func:`qsketch_insert`/:func:`qsketch_merge`; a tensor without one,
such as a state carried over from elsewhere, has the bound ``capacity``).
An absorb whose bound plus the incoming rows fits in ``capacity`` cannot
overflow: it packs and launches no kernel. Otherwise it compacts and keeps
the compacted or the packed rows by ``torch.where`` on the device's
``n_occupied > capacity``, so the result is exactly the JAX package's
either way, and its bound becomes ``capacity``. The port never writes a
state in place; a bound also records the tensor's in-place write counter,
so a caller's in-place write voids it instead of making it false.
"""
from typing import Any, Optional, Sequence

import torch

from metrics_tpu_torch.ops.qsketch import pack_rows, qsketch_compact_dispatch
from metrics_tpu_torch.ops.segment_sum import segment_sum_dispatch
from metrics_tpu_torch.utils.data import _as_tensor, _resolve_device

Tensor = torch.Tensor

#: empirical compaction constant of :func:`rank_error_bound`
QSKETCH_RANK_EPS = 4.0

#: the attribute of a sketch tensor holding its host-side occupancy bound
_FILL_BOUND = "_qsketch_fill_bound"


def rank_error_bound(n: int, capacity: int) -> float:
    """Advertised ABSOLUTE rank-error bound after ``n`` unit-weight inserts:
    0 inside the lossless window, else ``QSKETCH_RANK_EPS * n / capacity + 2``."""
    if n <= capacity:
        return 0.0
    return QSKETCH_RANK_EPS * float(n) / float(capacity) + 2.0


def _version(tensor: Tensor) -> Optional[int]:
    """The tensor's in-place write counter (None for an inference tensor,
    which keeps none)."""
    try:
        return tensor._version
    except RuntimeError:
        return None


def with_fill_bound(sketch: Tensor, bound: int) -> Tensor:
    """Attach the host-side bound ``bound`` on the occupied rows of
    ``sketch`` (a quantile sketch or a reservoir), stamped with the tensor's
    write counter; returns ``sketch``."""
    setattr(sketch, _FILL_BOUND, (int(bound), _version(sketch)))
    return sketch


def fill_bound(sketch: Tensor) -> int:
    """Host-side upper bound on the occupied rows of ``sketch``: its
    capacity when nothing better is known, or when the tensor was written
    in place since the bound was set (or keeps no write counter)."""
    bound, version = getattr(sketch, _FILL_BOUND, (sketch.shape[0], None))
    if version is None or version != _version(sketch):
        return sketch.shape[0]
    return bound


#: the attribute of a stacked per-rank tensor holding each rank's bound
_RANK_FILL_BOUNDS = "_qsketch_rank_fill_bounds"


def with_rank_fill_bounds(stacked: Tensor, bounds: Sequence[Optional[int]]) -> Tensor:
    """Attach the occupancy bound of each rank's slice of ``stacked`` (None
    where a rank's is unknown) for :func:`rank_slice`; returns ``stacked``."""
    if any(b is not None for b in bounds):
        setattr(stacked, _RANK_FILL_BOUNDS, (list(bounds), _version(stacked)))
    return stacked


def stack_with_fill_bounds(tensors: Sequence[Tensor]) -> Tensor:
    """``torch.stack(tensors)`` that keeps each tensor's occupancy bound
    (those that carry one) for :func:`rank_slice`: the per-rank stack a
    sync hands to a merge reducer."""
    bounds = [fill_bound(t) if hasattr(t, _FILL_BOUND) else None for t in tensors]
    return with_rank_fill_bounds(torch.stack(list(tensors)), bounds)


def rank_slice(stacked: Tensor, i: int) -> Tensor:
    """``stacked[i]``, stamped with rank ``i``'s occupancy bound where
    :func:`stack_with_fill_bounds` recorded one (and the stack was not
    written in place since)."""
    out = stacked[i]
    bounds, version = getattr(stacked, _RANK_FILL_BOUNDS, (None, None))
    if bounds is not None and bounds[i] is not None and version is not None and version == _version(stacked):
        with_fill_bound(out, bounds[i])
    return out


def qsketch_init(capacity: int, payload_cols: int = 0, device: Optional[Any] = None) -> Tensor:
    """Fresh empty sketch ``[capacity, 2 + payload_cols]`` on ``device``
    (the card unless ``device="cpu"``)."""
    if not (isinstance(capacity, int) and capacity > 0):
        raise ValueError(f"sketch `capacity` must be a positive int, got {capacity}")
    if not (isinstance(payload_cols, int) and payload_cols >= 0):
        raise ValueError(f"`payload_cols` must be a non-negative int, got {payload_cols}")
    empty = torch.zeros((capacity, 2 + payload_cols), dtype=torch.float32, device=_resolve_device(device))
    return with_fill_bound(empty, 0)


def _absorb(sketch: Tensor, new_rows: Tensor, new_bound: Optional[int] = None) -> Tensor:
    """Shared insert/merge core: concatenate, pack, and compact where the
    occupied rows overflow ``capacity`` (see the module docstring for how
    the overflow is decided). ``new_bound`` bounds the occupied rows of
    ``new_rows`` (default: all of them)."""
    capacity = sketch.shape[0]
    if new_rows.shape[0] > capacity:
        raise ValueError(
            f"cannot absorb {new_rows.shape[0]} rows into a capacity-{capacity} sketch in one"
            " pass; chunk the batch to at most `capacity` rows"
        )
    if capacity < 8:
        raise ValueError(f"sketch capacity must be at least 8, got {capacity}")
    rows = torch.cat([sketch, new_rows.to(sketch.dtype)], dim=0)
    incoming = new_rows.shape[0] if new_bound is None else min(new_bound, new_rows.shape[0])
    bound = fill_bound(sketch) + incoming
    if bound <= capacity:
        return with_fill_bound(pack_rows(rows, keep=capacity), bound)
    packed = pack_rows(rows)
    overflow = (packed[:, 0] > 0).sum() > capacity
    compacted = qsketch_compact_dispatch(packed, capacity)
    return with_fill_bound(torch.where(overflow, compacted[:capacity], packed[:capacity]), capacity)


def qsketch_insert(
    sketch: Tensor,
    key: Any,
    payload: Optional[Any] = None,
    weights: Optional[Any] = None,
    n_valid: Optional[Any] = None,
) -> Tensor:
    """Insert a batch of keyed rows; pure (``sketch`` is not modified).

    ``key`` is ``[B]``; ``payload`` is ``[B, payload_cols]`` (or None for a
    payload-less sketch); ``weights`` default to 1. ``n_valid`` masks
    trailing rows to weight 0 (the pad-and-mask contract of bucketed
    updates); given as a Python int it also bounds the rows the insert can
    occupy, so a padded chunk whose valid rows fit packs without a
    compaction. Batches larger than ``capacity`` are absorbed in
    capacity-sized chunks. Host inputs go to the sketch's device.
    """
    device = sketch.device
    key = _as_tensor(key, device).to(torch.float32).reshape(-1)
    b = key.shape[0]
    w = torch.ones((b,), dtype=torch.float32, device=device) if weights is None else _as_tensor(weights, device).to(torch.float32).reshape(-1)
    if n_valid is not None:
        w = w * (torch.arange(b, device=device) < _as_tensor(n_valid, device))
    expect = sketch.shape[1] - 2
    if payload is None:
        if expect != 0:
            raise ValueError(f"payload has 0 column(s) but the sketch was initialized with {expect}")
        rows = torch.stack([w, key], dim=1)
    else:
        payload = _as_tensor(payload, device).to(torch.float32).reshape(b, -1)
        if payload.shape[1] != expect:
            raise ValueError(
                f"payload has {payload.shape[1]} column(s) but the sketch was initialized with {expect}"
            )
        rows = torch.cat([w[:, None], key[:, None], payload], dim=1)
    capacity = sketch.shape[0]
    valid = n_valid if isinstance(n_valid, int) else None
    for lo in range(0, b, capacity):
        bound = None if valid is None else max(0, min(capacity, valid - lo))
        sketch = _absorb(sketch, rows[lo : lo + capacity], new_bound=bound)
    return sketch


def qsketch_merge(a: Tensor, b: Tensor) -> Tensor:
    """Merge two sketches into one of ``a``'s capacity (pure; exact while
    the combined occupancy fits; commutative as a row multiset)."""
    if a.ndim != 2 or a.shape[1:] != b.shape[1:]:
        raise ValueError(f"cannot merge sketches with layouts {tuple(a.shape)} and {tuple(b.shape)}")
    out = a
    for lo in range(0, b.shape[0], a.shape[0]):
        out = _absorb(out, b[lo : lo + a.shape[0]], new_bound=fill_bound(b))
    return out


def qsketch_merge_into(dst: Tensor, *others: Tensor) -> Tensor:
    """Fold any number of sketches into ``dst``'s capacity (a left fold of
    :func:`qsketch_merge`)."""
    for other in others:
        dst = qsketch_merge(dst, other)
    return dst


def qsketch_absorb_rows(sketch: Tensor, rows: Any) -> Tensor:
    """Fold serialized occupied rows (a ``[n, cols]`` host array or tensor;
    ``n`` may exceed the capacity) into ``sketch``."""
    rows = _as_tensor(rows, sketch.device).to(sketch.dtype)
    if rows.ndim != 2 or rows.shape[1] != sketch.shape[1]:
        raise ValueError(
            f"serialized rows layout {tuple(rows.shape)} does not match sketch layout {tuple(sketch.shape)}"
        )
    incoming = rows.new_zeros((max(sketch.shape[0], rows.shape[0]), sketch.shape[1]))
    incoming[: rows.shape[0]] = rows
    return qsketch_merge(sketch, with_fill_bound(incoming, rows.shape[0]))


class _QSketchReduce:
    """``dist_reduce_fx`` of quantile-sketch states: takes the stacked
    per-rank sketches ``[world, capacity, cols]`` and folds
    :func:`qsketch_merge` across them in rank order (inside the lossless
    window this is the concatenation in rank order). A module-level class,
    so metrics holding it pickle and deepcopy; tagged ``merge_like`` so
    ``Metric.merge_states`` recognises sketch states. A stack made by
    :func:`stack_with_fill_bounds` lends each rank its occupancy bound, so a
    union that fits concatenates without a compaction."""

    merge_like = True
    sketch_kind = "quantile"
    __name__ = "qsketch_reduce"

    def __call__(self, stacked: Tensor) -> Tensor:
        if stacked.ndim == 2:  # a single rank passes through
            return stacked
        out = rank_slice(stacked, 0)
        for i in range(1, stacked.shape[0]):
            out = qsketch_merge(out, rank_slice(stacked, i))
        return out


_QSKETCH_REDUCE = _QSketchReduce()


def sketch_merge_fx() -> _QSketchReduce:
    """The shared quantile-sketch ``dist_reduce_fx``."""
    return _QSKETCH_REDUCE


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------


def qsketch_fill(sketch: Tensor) -> Tensor:
    """Number of occupied slots (int32 scalar)."""
    return (sketch[:, 0] > 0).sum().to(torch.int32)


def qsketch_total_weight(sketch: Tensor) -> Tensor:
    """Total inserted weight surviving in the sketch."""
    return sketch[:, 0].sum()


def qsketch_rank(sketch: Tensor, xs: Any) -> Tensor:
    """Estimated rank (weighted count of keys ``<= x``) per query point."""
    w, key = sketch[:, 0], sketch[:, 1]
    xs = _as_tensor(xs, sketch.device).to(torch.float32).reshape(-1)
    return (w[None, :] * (key[None, :] <= xs[:, None])).sum(dim=1)


def qsketch_cdf(sketch: Tensor, xs: Any) -> Tensor:
    """Estimated CDF at each query point; ``NaN`` for an empty sketch."""
    total = qsketch_total_weight(sketch)
    cdf = qsketch_rank(sketch, xs) / torch.clamp(total, min=1e-12)
    return torch.where(total > 0, cdf, torch.nan)


def qsketch_quantile(sketch: Tensor, q: Any) -> Tensor:
    """Estimated quantile(s): the smallest key whose cumulative weight
    reaches ``q`` of the total; ``NaN`` for an empty sketch."""
    w, key = sketch[:, 0], sketch[:, 1]
    order = torch.sort(torch.where(w > 0, key, torch.inf), stable=True).indices
    sk, sw = key[order], w[order]
    cum = torch.cumsum(sw, dim=0)
    total = cum[-1]
    q = _as_tensor(q, sketch.device).to(torch.float32).reshape(-1)
    idx = torch.clamp(torch.searchsorted(cum / torch.clamp(total, min=1e-12), q, side="left"), 0, sk.shape[0] - 1)
    return torch.where(total > 0, sk[idx], torch.nan)


def qsketch_histogram(sketch: Tensor, edges: Any) -> Tensor:
    """Weighted histogram of the keys over ``len(edges) - 1`` bins (left
    ``searchsorted``, as the calibration binning does)."""
    w, key = sketch[:, 0], sketch[:, 1]
    edges = _as_tensor(edges, sketch.device).to(torch.float32).contiguous()
    n_bins = edges.shape[0] - 1
    idx = torch.clamp(torch.searchsorted(edges, key.contiguous(), side="left") - 1, 0, n_bins - 1)
    return segment_sum_dispatch(w, idx, n_bins)
