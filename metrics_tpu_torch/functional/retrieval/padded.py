"""Padded per-query retrieval kernels: the batched compute path.

Counterpart of ``metrics_tpu/functional/retrieval/padded.py``. The ragged
``(query, documents)`` structure is packed into static ``[Q, D]`` buffers
on the metric's device (padding slots carry ``preds=-inf``, ``target=0``,
``mask=False``), every row is sorted once by descending score, and each
metric's per-row math, the empty-query policy and the final mean run as
batched tensor code over ``[Q, D]`` (the JAX package vmaps a per-row
kernel; here each kernel works on the last axis).

**Sums in a fixed order.** Every sum over documents or queries is taken by
:func:`_tree_sum`, a pairwise tree over the axis padded to a power of two,
made of elementwise additions. Each addition is one IEEE operation, so a
sum comes out bit for bit the same on the card and on the CPU, which the
card-against-CPU checks of ``chip_smoke.py`` rely on (``torch.sum`` adds in
an order that depends on the device). Against the JAX package, whose XLA
reductions add in their own order, results are equal where the sums are
exact (binary targets, dyadic values) and within float32 rounding
otherwise. NDCG's discount ``log2(position + 1)`` is correctly rounded
(computed in float64 on the host); XLA's float32 ``log2`` is
``log(x) * (1 / ln 2)`` with its own ``log`` and differs from it by an ulp
on about a quarter of the positions.
"""
import functools
import weakref
from collections import OrderedDict
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.utils.data import _tree_sum, dim_zero_cat, stable_sort_with_payloads

Tensor = torch.Tensor


def _segment_layout(indexes: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Stable sort by query id -> (order, dense row id, within-row column).
    The stable sort keeps each query's documents in arrival order."""
    order = torch.sort(indexes, stable=True).indices
    sorted_idx = indexes[order]
    change = torch.cat([torch.zeros(1, dtype=torch.bool, device=indexes.device), sorted_idx[1:] != sorted_idx[:-1]])
    row = torch.cumsum(change.to(torch.int64), dim=0)
    pos = torch.arange(sorted_idx.shape[0], device=indexes.device)
    seg_start = torch.cummax(torch.where(change, pos, 0), dim=0).values
    return order, row, pos - seg_start


def _scatter_pack(
    preds: Tensor, target: Tensor, order: Tensor, row: Tensor, col: Tensor, num_queries: int, max_docs: int
) -> Tuple[Tensor, Tensor, Tensor]:
    device = preds.device
    padded_preds = torch.full((num_queries, max_docs), -torch.inf, dtype=torch.float32, device=device)
    padded_preds[row, col] = preds[order].to(torch.float32)
    padded_target = torch.zeros((num_queries, max_docs), dtype=torch.float32, device=device)
    padded_target[row, col] = target[order].to(torch.float32)
    mask = torch.zeros((num_queries, max_docs), dtype=torch.bool, device=device)
    mask[row, col] = True
    return padded_preds, padded_target, mask


def pack_queries(
    indexes: Tensor, preds: Tensor, target: Tensor, max_expand: Optional[int] = None
) -> Optional[Tuple[Tensor, Tensor, Tensor]]:
    """Pack ragged ``(indexes, preds, target)`` into padded ``[Q, Dmax]``
    buffers on their device. The sort, the layout and the scatter stay on
    the device; only two scalars (the number of queries and the most
    documents of one query, the buffers' shape) are read back, in one read.

    Returns None (before allocating the buffers) when the padded layout
    would exceed ``max_expand`` times the raw element count."""
    indexes, preds, target = (x.reshape(-1) for x in (indexes, preds, target))
    if indexes.numel() == 0:
        raise ValueError(
            "`indexes` is empty — the retrieval metric has no accumulated samples;"
            " call `update` before `compute`."
        )
    order, row, col = _segment_layout(indexes)
    num_queries, max_docs = (int(v) + 1 for v in torch.stack([row[-1], col.max()]).tolist())
    if max_expand is not None and num_queries * max_docs > max_expand * indexes.numel():
        return None
    return _scatter_pack(preds, target, order, row, col, num_queries, max_docs)


# ---------------------------------------------------------------------------
# identity-keyed memos: one pack and one row sort for every metric over the
# same state
# ---------------------------------------------------------------------------

_PACK_CACHE: "OrderedDict[tuple, object]" = OrderedDict()
_PACK_CACHE_MAX = 4
_NO_PACK = object()  # cached "pack_queries returned None" (skew fallback)


def _memoized(
    cache: "OrderedDict", key_arrays: tuple, compute: Callable, extra_key: tuple = (), max_entries: int = 4
):
    """Memoize ``compute()`` on the identity of every tensor in
    ``key_arrays`` (plus the hashable ``extra_key``). States are replaced,
    never written in place, so identity is equality; a weakref finalizer
    on every keyed tensor drops the entry when any of them is collected, so
    a recycled ``id`` can never give a stale hit. Every eviction (LRU cap,
    collection) detaches the entry's finalizers."""
    key = tuple(map(id, key_arrays)) + extra_key
    hit = cache.get(key)
    if hit is not None:
        cache.move_to_end(key)
        return hit[0]
    result = compute()
    finalizers = []
    try:
        for a in key_arrays:
            finalizers.append(weakref.finalize(a, _evict, cache, key))
    except TypeError:
        for f in finalizers:
            f.detach()
        return result
    cache[key] = (result, finalizers)
    while len(cache) > max_entries:
        _, (_, old_fins) = cache.popitem(last=False)
        for f in old_fins:
            f.detach()
    return result


def _evict(cache: "OrderedDict", key: tuple) -> None:
    """Finalizer callback: drop the entry and detach its sibling finalizers."""
    entry = cache.pop(key, None)
    if entry is not None:
        for f in entry[1]:
            f.detach()


def pack_queries_cached(
    indexes_list: List[Tensor],
    preds_list: List[Tensor],
    target_list: List[Tensor],
    max_expand: Optional[int] = None,
) -> Optional[Tuple[Tensor, Tensor, Tensor]]:
    """:func:`pack_queries` over list states, memoized on tensor identity
    (the skew fallback ``None`` is cached too)."""
    if not indexes_list:
        raise ValueError(
            "`indexes` is empty — the retrieval metric has no accumulated samples;"
            " call `update` before `compute`."
        )

    def compute():
        packed = pack_queries(
            dim_zero_cat(indexes_list), dim_zero_cat(preds_list), dim_zero_cat(target_list), max_expand=max_expand
        )
        return _NO_PACK if packed is None else packed

    result = _memoized(
        _PACK_CACHE,
        (*indexes_list, *preds_list, *target_list),
        compute,
        # list lengths tell which list each id belongs to
        extra_key=(len(indexes_list), len(preds_list), max_expand),
        max_entries=_PACK_CACHE_MAX,
    )
    return None if result is _NO_PACK else result


def _row_sort(preds: Tensor, target: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    """Target and mask reordered by descending preds (padding sorts last):
    one stable sort of each row."""
    _, st, sm = stable_sort_with_payloads(preds, target, mask, descending=True)
    return st, sm


def _positions(d: int, device: torch.device) -> Tensor:
    return torch.arange(1, d + 1, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=16)
def _discount_host(d: int) -> np.ndarray:
    """``log2(position + 1)`` for positions ``1..d``, correctly rounded to float32."""
    return np.log2(np.arange(2, d + 2, dtype=np.float64)).astype(np.float32)


def _discount(d: int, device: torch.device) -> Tensor:
    return torch.from_numpy(_discount_host(d)).to(device)


# ---------------------------------------------------------------------------
# sorted-row kernels: the math after the shared per-row sort, over the last
# axis. `st` = target by descending score, `sm` = mask likewise, `ideal` =
# target sorted descending by itself (NDCG's ideal ranking).
# ---------------------------------------------------------------------------


def _in_top(st: Tensor, k: Optional[int]) -> Tensor:
    d = st.shape[-1]
    return _positions(d, st.device) <= (k if k is not None else d)


def _ap_sorted(st: Tensor, sm: Tensor, ideal: Tensor, k: Optional[int] = None) -> Tensor:
    num_pos = _tree_sum(st)
    terms = st * torch.cumsum(st, dim=-1) / _positions(st.shape[-1], st.device)
    return torch.where(num_pos > 0, _tree_sum(terms) / torch.clamp(num_pos, min=1.0), 0.0)


def _rr_sorted(st: Tensor, sm: Tensor, ideal: Tensor, k: Optional[int] = None) -> Tensor:
    num_pos = _tree_sum(st)
    first = (st > 0).to(torch.int32).argmax(dim=-1)
    return torch.where(num_pos > 0, 1.0 / (first.to(torch.float32) + 1.0), 0.0)


def _precision_sorted(st: Tensor, sm: Tensor, ideal: Tensor, k: Optional[int] = None) -> Tensor:
    num_pos = _tree_sum(st)
    if k is None:
        # k defaults to the query's document count
        n_docs = _tree_sum(sm.to(torch.float32))
        return torch.where(num_pos > 0, num_pos / torch.clamp(n_docs, min=1.0), 0.0)
    return torch.where(num_pos > 0, _tree_sum(st * _in_top(st, k)) / k, 0.0)


def _recall_sorted(st: Tensor, sm: Tensor, ideal: Tensor, k: Optional[int] = None) -> Tensor:
    num_pos = _tree_sum(st)
    return torch.where(num_pos > 0, _tree_sum(st * _in_top(st, k)) / torch.clamp(num_pos, min=1.0), 0.0)


def _r_precision_sorted(st: Tensor, sm: Tensor, ideal: Tensor, k: Optional[int] = None) -> Tensor:
    num_pos = _tree_sum(st)
    in_r = _positions(st.shape[-1], st.device) <= num_pos[..., None]
    return torch.where(num_pos > 0, _tree_sum(st * in_r) / torch.clamp(num_pos, min=1.0), 0.0)


def _hit_rate_sorted(st: Tensor, sm: Tensor, ideal: Tensor, k: Optional[int] = None) -> Tensor:
    return (_tree_sum(st * _in_top(st, k)) > 0).to(torch.float32)


def _fall_out_sorted(st: Tensor, sm: Tensor, ideal: Tensor, k: Optional[int] = None) -> Tensor:
    neg = (1.0 - st) * sm
    num_neg = _tree_sum(neg)
    return torch.where(num_neg > 0, _tree_sum(neg * _in_top(st, k)) / torch.clamp(num_neg, min=1.0), 0.0)


def _ndcg_sorted(st: Tensor, sm: Tensor, ideal: Tensor, k: Optional[int] = None) -> Tensor:
    in_k = _in_top(st, k)
    discount = _discount(st.shape[-1], st.device)
    target_dcg = _tree_sum(st * in_k / discount)
    ideal_dcg = _tree_sum(ideal * in_k / discount)
    return torch.where(ideal_dcg > 0, target_dcg / torch.clamp(ideal_dcg, min=1e-38), 0.0)


_ndcg_sorted.needs_ideal = True  # the only kernel consuming the ideal ranking


def _ideal(padded_target: Tensor) -> Tensor:
    return -torch.sort(-padded_target, dim=-1).values


def _make_row_kernel(name: str, sorted_fn: Callable, doc: str) -> Callable:
    needs_ideal = getattr(sorted_fn, "needs_ideal", False)

    def kernel(preds: Tensor, target: Tensor, mask: Tensor, k: Optional[int] = None) -> Tensor:
        st, sm = _row_sort(preds, target, mask)
        return sorted_fn(st, sm, _ideal(target) if needs_ideal else st, k)

    kernel.__name__ = kernel.__qualname__ = name
    kernel.__doc__ = doc
    kernel.sorted_fn = sorted_fn  # the shared-sort path dispatches on this
    return kernel


average_precision_row = _make_row_kernel(
    "average_precision_row", _ap_sorted, "Average precision of padded rows (last axis)."
)
reciprocal_rank_row = _make_row_kernel("reciprocal_rank_row", _rr_sorted, "Reciprocal rank of padded rows.")
precision_row = _make_row_kernel("precision_row", _precision_sorted, "Precision@k of padded rows.")
recall_row = _make_row_kernel("recall_row", _recall_sorted, "Recall@k of padded rows.")
r_precision_row = _make_row_kernel("r_precision_row", _r_precision_sorted, "R-precision of padded rows.")
hit_rate_row = _make_row_kernel("hit_rate_row", _hit_rate_sorted, "HitRate@k of padded rows.")
fall_out_row = _make_row_kernel(
    "fall_out_row",
    _fall_out_sorted,
    "Top-k fraction of the NON-relevant docs of padded rows; padding does not count as negative.",
)
ndcg_row = _make_row_kernel("ndcg_row", _ndcg_sorted, "Graded-target nDCG@k of padded rows.")


#: (identity of every input tensor) -> the sorted layout; entries die with
#: their tensors (weakref finalizers), as in _PACK_CACHE
_SORT_CACHE: "OrderedDict[tuple, Tuple[Tensor, Tensor]]" = OrderedDict()


def _sorted_layout(padded_preds: Tensor, padded_target: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    return _row_sort(padded_preds, padded_target, mask)


def sorted_row_layout(padded_preds: Tensor, padded_target: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    """``(sorted_target, sorted_mask)``: the one per-row sort every retrieval
    kernel shares, memoized on the identity of all three layout tensors, so
    metrics over the same layout (a compute group) sort once."""
    return _memoized(
        _SORT_CACHE,
        (padded_preds, padded_target, mask),
        lambda: _sorted_layout(padded_preds, padded_target, mask),
    )


def _padded_compute_fn(kernel: Callable, k: Optional[int], empty_target_action: str):
    """``run(st, sm, padded_target, empty, row_w=None)``: the kernel's sorted
    form over every row, the empty-query policy and the mean, over the
    shared sorted layout. NDCG derives its ideal ranking here from the raw
    padded target. ``row_w`` is the table-state entry's: the layout has
    ``max_queries`` rows, and ``row_w`` (0 for unoccupied rows) multiplies
    into the policy's weights."""
    sorted_fn = kernel.sorted_fn
    needs_ideal = getattr(sorted_fn, "needs_ideal", False)

    def run(st: Tensor, sm: Tensor, padded_target: Tensor, empty: Tensor, row_w: Optional[Tensor] = None) -> Tensor:
        vals = sorted_fn(st, sm, _ideal(padded_target) if needs_ideal else st, k)
        return _reduce_with_empty_policy(vals, empty, empty_target_action, row_w)

    return run


def _padded_compute_fn_raw(kernel: Callable, k: Optional[int], empty_target_action: str):
    """For row kernels without a sorted form: ``kernel(padded_preds,
    padded_target, mask, k)`` over every row (a kernel works on the last
    axis), then the policy and the mean (``row_w`` as above)."""

    def run(
        padded_preds: Tensor, padded_target: Tensor, mask: Tensor, empty: Tensor, row_w: Optional[Tensor] = None
    ) -> Tensor:
        vals = kernel(padded_preds, padded_target, mask, k)
        return _reduce_with_empty_policy(vals, empty, empty_target_action, row_w)

    return run


def _reduce_with_empty_policy(
    vals: Tensor, empty: Tensor, empty_target_action: str, row_valid: Optional[Tensor] = None
) -> Tensor:
    """Empty-query policy and mean. ``row_valid`` (the table-state path)
    zero-weights the unoccupied rows of the fixed ``[max_queries]`` layout
    before the policy's weights apply."""
    if empty_target_action == "pos":
        vals = torch.where(empty, 1.0, vals)
        weights = torch.ones_like(vals)
    elif empty_target_action == "neg":
        vals = torch.where(empty, 0.0, vals)
        weights = torch.ones_like(vals)
    elif empty_target_action == "skip":
        weights = (~empty).to(vals.dtype)
    else:  # "error" is raised on the host before this runs
        weights = torch.ones_like(vals)
    if row_valid is not None:
        weights = weights * row_valid.to(vals.dtype)
    total = _tree_sum(weights)
    return torch.where(total > 0, _tree_sum(vals * weights) / torch.clamp(total, min=1.0), 0.0)
