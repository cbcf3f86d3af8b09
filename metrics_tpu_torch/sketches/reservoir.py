"""Reservoir of priority-keyed rows with a fixed-shape state.

Counterpart of ``metrics_tpu/sketches/reservoir.py``. A reservoir is one
packed ``[k, 1 + payload_cols]`` float32 tensor:

    column 0: priority (``-inf`` means an empty slot)
    columns 1..: the payload row

It always holds the ``k`` rows of highest priority seen. While every row
fits, it holds them all in arrival order (a stable pack): the lossless
window. Past ``k`` it keeps the top ``k`` by priority, ties to the earlier
row. :func:`reservoir_insert` draws each row's priority as a Gumbel key,
``g + log(w)``, from the JAX package's counter-seeded random stream
(``fold_in(PRNGKey(seed), seen)``, reproduced in
:mod:`metrics_tpu_torch.utils.prng`), so the reservoir is a uniform (or
weighted) sample; :func:`reservoir_insert_keyed` takes priorities from the
caller, such as :func:`reservoir_key`, a hash of a row's global id into
``(0, 1]``, which makes the admitted set a pure function of the ids,
whatever the batching.

**The branch without a host read.** The JAX package picks pack or top-``k``
under ``lax.cond(n_occupied > k)`` on the device. Here a reservoir tensor
carries a host-side upper bound on its occupied rows, as the quantile
sketch does (:func:`metrics_tpu_torch.sketches.quantile.fill_bound`). An
insert whose bound plus the incoming rows fits in ``k`` can only pack;
otherwise both orders are computed and ``torch.where`` on the device's
``n_occupied > k`` picks one, before one gather of the rows. No insert
reads the card.
"""
from typing import Any, Optional

import torch

from metrics_tpu_torch.sketches.quantile import fill_bound, rank_slice, with_fill_bound
from metrics_tpu_torch.utils import prng
from metrics_tpu_torch.utils.data import _as_tensor, _resolve_device

Tensor = torch.Tensor

_EMPTY = -float("inf")
_U32 = 0xFFFFFFFF


def reservoir_init(k: int, payload_cols: int, device: Optional[Any] = None) -> Tensor:
    """Fresh empty reservoir ``[k, 1 + payload_cols]`` on ``device`` (the
    card unless ``device="cpu"``)."""
    if not (isinstance(k, int) and k > 0):
        raise ValueError(f"reservoir size `k` must be a positive int, got {k}")
    if not (isinstance(payload_cols, int) and payload_cols > 0):
        raise ValueError(f"`payload_cols` must be a positive int, got {payload_cols}")
    device = _resolve_device(device)
    # built without an in-place write, so the bound's write counter is 0 in
    # every copy the metric makes of this default
    leaf = torch.cat(
        [
            torch.full((k, 1), _EMPTY, dtype=torch.float32, device=device),
            torch.zeros((k, payload_cols), dtype=torch.float32, device=device),
        ],
        dim=1,
    )
    return with_fill_bound(leaf, 0)


def _select(rows: Tensor, k: int, bound: int) -> Tensor:
    """The JAX package's ``_select``: the top ``k`` rows by priority (ties
    to the lower row) when more than ``k`` are occupied, else the occupied
    rows first in row order (a stable pack), cut to ``k``. ``bound`` is a
    host upper bound on the occupied rows; the result carries
    ``min(bound, k)``."""
    n = rows.shape[0]
    pri = rows[:, 0]
    occ = pri > _EMPTY
    index = torch.arange(n, device=rows.device)
    # stable pack: occupied rows first, each group in row order
    order = torch.argsort((~occ).to(torch.int64) * n + index)
    if bound > k:
        # a stable sort of -pri is jnp.lexsort((arange, -pri)): priority
        # descending, ties to the lower row, empty (-inf) rows last
        top = torch.sort(-pri, stable=True).indices
        order = torch.where(occ.sum() > k, top, order)
    return with_fill_bound(rows[order[:k]], min(bound, k))


def _absorb(reservoir: Tensor, rows: Tensor, incoming: int) -> Tensor:
    """Fold ``rows`` into ``reservoir`` (``incoming`` bounds their occupied
    rows). The JAX package folds them in chunks of ``k`` rows, one top
    ``k`` each; one stable top ``k`` over all ``k + B`` rows keeps the same
    rows in the same order (priority descending, ties to the earlier row),
    with one sort instead of ``B / k``."""
    return _select(torch.cat([reservoir, rows], dim=0), reservoir.shape[0], fill_bound(reservoir) + incoming)


def _payload(reservoir: Tensor, payload: Any) -> Tensor:
    """``payload`` as float32 ``[B, payload_cols]`` rows on the reservoir's
    device, checked against its layout."""
    payload = _as_tensor(payload, reservoir.device).to(torch.float32)
    payload = payload.flatten(1) if payload.ndim > 1 else payload[:, None]
    if payload.shape[1] != reservoir.shape[1] - 1:
        raise ValueError(
            f"payload has {payload.shape[1]} column(s) but the reservoir was initialized"
            f" with {reservoir.shape[1] - 1}"
        )
    return payload


def _insert(reservoir: Tensor, payload: Tensor, pri: Tensor, n_valid: Optional[Any]) -> Tensor:
    """Insert rows of priority ``pri``; ``n_valid`` masks trailing rows to
    ``-inf`` (the pad-and-mask contract of bucketed updates)."""
    b = payload.shape[0]
    if n_valid is not None:
        pri = torch.where(torch.arange(b, device=pri.device) < _as_tensor(n_valid, pri.device), pri, _EMPTY)
    return _absorb(reservoir, torch.cat([pri[:, None], payload], dim=1), b)


def reservoir_key(ids: Any, device: Optional[Any] = None) -> Tensor:
    """Deterministic hash priority in ``(0, 1]`` (float32) from integer ids.

    The JAX package's uint32 avalanche mix, in int64 with the product taken
    modulo 2**32 (torch has no uint32 arithmetic): the priority is a pure
    function of the id modulo 2**32, so the admitted set under any batching
    of the stream is exactly the top ``k`` ids by hash. Host ids go to
    ``device`` (the card unless ``device="cpu"``)."""
    x = _as_tensor(ids, device).to(torch.int64) & _U32
    x = _mul_u32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul_u32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    # top 24 bits -> (0, 1]: exact in float32, never -inf or 0
    return ((x >> 8).to(torch.float32) + 1.0) / float(1 << 24)


def _mul_u32(x: Tensor, c: int) -> Tensor:
    """``x * c mod 2**32`` for ``0 <= x < 2**32``, with no int64 overflow:
    the product is split at 16 bits of ``c``."""
    low = x * (c & 0xFFFF)
    high = ((x * (c >> 16)) & 0xFFFF) << 16
    return (low + high) & _U32


def reservoir_insert(
    reservoir: Tensor,
    payload: Any,
    seen: Any,
    seed: int = 0,
    weights: Optional[Any] = None,
    n_valid: Optional[Any] = None,
) -> Tensor:
    """Insert ``[B, payload_cols]`` rows with Gumbel priorities; pure
    (``reservoir`` is not modified). ``seen`` is the caller's count of rows
    inserted before this batch (an int or an integer tensor, which may stay
    on the card): the draw is ``gumbel(fold_in(PRNGKey(seed), seen), (B,))``,
    so replays repeat it and successive batches never reuse priorities.
    ``weights`` bias inclusion (``priority = gumbel + log(w)``, A-ExpJ; a
    weight of 0 or less never enters); ``n_valid`` masks trailing rows out
    (the pad-and-mask contract of bucketed updates), and the first
    ``n_valid`` draws of a padded batch are the unpadded batch's. Host
    inputs go to the reservoir's device."""
    device = reservoir.device
    payload = _payload(reservoir, payload)
    b = payload.shape[0]
    if b == 0:
        return reservoir
    seen = seen.to(device) if isinstance(seen, Tensor) else torch.full((), int(seen), dtype=torch.int64, device=device)
    pri = prng.gumbel(prng.fold_in(prng.prng_key(seed), seen), b, device)
    if weights is not None:
        w = _as_tensor(weights, device).to(torch.float32).reshape(-1)
        log_w = torch.log(torch.clamp(w, min=1e-30).double()).to(torch.float32)
        pri = pri + torch.where(w > 0, log_w, _EMPTY)
    return _insert(reservoir, payload, pri, n_valid)


def reservoir_insert_keyed(reservoir: Tensor, payload: Any, keys: Any, n_valid: Optional[Any] = None) -> Tensor:
    """Insert ``[B, payload_cols]`` rows with caller-supplied priorities;
    pure (``reservoir`` is not modified). ``n_valid`` masks trailing rows to
    ``-inf`` priority (the pad-and-mask contract of bucketed updates).
    Host inputs go to the reservoir's device."""
    payload = _payload(reservoir, payload)
    b = payload.shape[0]
    if b == 0:
        return reservoir
    pri = _as_tensor(keys, reservoir.device).to(torch.float32).reshape(-1)
    if pri.shape[0] != b:
        raise ValueError(f"got {pri.shape[0]} key(s) for {b} payload row(s)")
    return _insert(reservoir, payload, pri, n_valid)


def reservoir_merge(a: Tensor, b: Tensor) -> Tensor:
    """Merge two reservoirs into one of ``a``'s size (the top ``k`` of the
    union by priority); exact while the combined occupancy fits."""
    if a.ndim != 2 or a.shape[1:] != b.shape[1:]:
        raise ValueError(f"cannot merge reservoirs with layouts {tuple(a.shape)} and {tuple(b.shape)}")
    return _absorb(a, b, fill_bound(b))


class _ReservoirReduce:
    """``dist_reduce_fx`` folding :func:`reservoir_merge` over the stacked
    per-rank reservoirs ``[world, k, cols]`` in rank order. A module-level
    class, so metrics holding it pickle; tagged ``merge_like`` for
    ``Metric.merge_states``."""

    merge_like = True
    sketch_kind = "reservoir"
    __name__ = "reservoir_reduce"

    def __call__(self, stacked: Tensor) -> Tensor:
        if stacked.ndim == 2:  # a single rank passes through
            return stacked
        out = rank_slice(stacked, 0)
        for i in range(1, stacked.shape[0]):
            out = reservoir_merge(out, rank_slice(stacked, i))
        return out


_RESERVOIR_REDUCE = _ReservoirReduce()


def reservoir_merge_fx() -> _ReservoirReduce:
    """The shared reservoir ``dist_reduce_fx``."""
    return _RESERVOIR_REDUCE


def detection_table_init(max_images: int, row_cols: int, device: Optional[Any] = None) -> Tensor:
    """The mAP metric's per-image table: a reservoir of ``max_images`` rows
    of ``row_cols`` payload columns (``detection/mean_ap.py`` packs each
    image's detections and ground truths into one row)."""
    return reservoir_init(max_images, row_cols, device)


def reservoir_fill(reservoir: Tensor) -> Tensor:
    """Number of occupied slots (int32 scalar)."""
    return (reservoir[:, 0] > _EMPTY).sum().to(torch.int32)


def reservoir_rows(reservoir: Tensor) -> Tensor:
    """The payload rows ``[k, payload_cols]``, occupied rows first."""
    return reservoir[:, 1:]
