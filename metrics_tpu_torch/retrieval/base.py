"""RetrievalMetric base: the grouped-by-query mean of a per-query metric.

Counterpart of ``metrics_tpu/retrieval/base.py``: compute groups the
documents by query id, evaluates the per-query metric and averages it, with
``empty_target_action`` in neg/pos/skip/error for queries without a
positive target (without a negative one for FallOut).

**Default state: the fixed-capacity per-query table**
(:mod:`metrics_tpu_torch.retrieval.table`). ``update(preds, target,
indexes=...)`` scatters each document into its query's row of a packed
``[max_queries, 7 + 2*max_docs]`` tensor, with exact per-query counters, a
deterministic hash-key reservoir over query rows and the top-k compaction
of document slots past capacity. An update reads the card once (its value
checks). Inside the lossless window (distinct queries ``<= max_queries``,
documents per query ``<= max_docs``) the results equal the exact mode's;
past it, metrics become their depth-truncated (top-k-pooled) variants while
the empty-query policy stays exact through the counters.

**``exact=True``** keeps the reference's unbounded ``indexes/preds/target``
list states and computes over the packed ``[num_queries, max_docs]`` layout
(or a host group loop for heavily skewed query sizes).

Subclasses name their padded row kernel in ``_padded_metric``
(``functional/retrieval/padded.py``); both state modes share those kernels.
A subclass that only implements ``_metric`` falls back to a host group loop
in either mode.

**The read plane.** ``compute()`` memoizes the table's padded unpack per
owner and write epoch (a compute group's members share one), at most
``_LAYOUT_CACHE_MAX`` entries, each dropped with its table (a weakref
finalizer) or by LRU overflow; :func:`layout_cache_totals` gives the
memo's entries, bytes and lifetime evictions, its bytes are the
``retrieval_layout`` memory plane, and each eviction records a
``cache_plane`` event (never raising out of a finalizer).
``table_rows_layout`` pads its host row ids to a bucket and reads through
the ``table_subset`` reader of a
:class:`~metrics_tpu_torch.core.readers.ReaderCache` (on the card a CUDA
graph of the unpack over gathered rows). With the default telemetry
recorder enabled, ``compute()``'s read event carries the table rows
unpacked, whether the layout memo served it (``cache_hit``), the memo's
size and its evictions (``_read_extras``), and ``table_rows_layout``
records a ``table`` read event. The table default runs inside the fused update
(``core/fused.py``): its insert has fixed shapes and reads nothing under
the capture rule of ``utils/checks.py``.
"""
import time
import weakref
from abc import ABC, abstractmethod
from collections import OrderedDict
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.core.readers import ReaderCache, pad_ids, round_up_bucket
from metrics_tpu_torch.observability.memory import register_cache_plane
from metrics_tpu_torch.observability.recorder import _DEFAULT_RECORDER as _TELEMETRY
from metrics_tpu_torch.functional.retrieval.padded import (
    _padded_compute_fn,
    _padded_compute_fn_raw,
    pack_queries_cached,
    sorted_row_layout,
)
from metrics_tpu_torch.retrieval.table import (
    retrieval_table_fill,
    retrieval_table_init,
    retrieval_table_insert,
    retrieval_table_layout,
    retrieval_table_layout_rows,
    retrieval_table_merge_fx,
    _layout_of,
)
from metrics_tpu_torch.sketches.compat import register_exact_list_states, warn_exact_buffer
from metrics_tpu_torch.utils.checks import _check_retrieval_inputs, _check_retrieval_inputs_static
from metrics_tpu_torch.utils.data import dim_zero_cat, get_group_indexes

Tensor = torch.Tensor

#: bound on the layout memo: a process computes a handful of retrieval
#: metrics over one or two tables, so entries past this are leaks
_LAYOUT_CACHE_MAX = 8

#: (owner id, write epoch) -> (table id and write counter, unpacked layout,
#: weakref finalizer). The epoch key makes repeated reads of an unwritten
#: metric hits; the table's id and in-place write counter guard the entry
#: (a fused update's replay rewrites the same table tensor and bumps the
#: counter). A compute group's members borrow ONE qtable tensor,
#: so a sibling's entry for the same table is aliased instead of unpacked
#: again, and, being the same tensors, shares one row sort through
#: sorted_row_layout's identity memo. Entries die with their table
#: (finalizers) or by LRU eviction.
_LAYOUT_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()

#: lifetime eviction totals of the layout memo (process-wide, like the
#: memo): count and bytes dropped
_LAYOUT_EVICTIONS = 0
_LAYOUT_EVICTED_BYTES = 0


def _layout_nbytes(layout: tuple) -> int:
    """Bytes of one memoized layout (its tensors)."""
    return sum(x.numel() * x.element_size() for x in layout if isinstance(x, Tensor))


def _layout_cache_nbytes() -> int:
    """Bytes in the layout memo, each layout counted once (a compute-group
    sibling's entry aliases the same tensors)."""
    seen: set = set()
    total = 0
    for _tid, layout, _fin in list(_LAYOUT_CACHE.values()):
        if id(layout) not in seen:
            seen.add(id(layout))
            total += _layout_nbytes(layout)
    return total


def layout_cache_totals() -> dict:
    """The layout memo's inventory and lifetime eviction totals:
    ``{"entries", "nbytes", "evictions", "evicted_bytes"}``."""
    return {
        "entries": len(_LAYOUT_CACHE),
        "nbytes": _layout_cache_nbytes(),
        "evictions": _LAYOUT_EVICTIONS,
        "evicted_bytes": _LAYOUT_EVICTED_BYTES,
    }


def _layout_cache_evict(key: tuple) -> None:
    """Drop one entry and count it. Runs from the LRU overflow and from
    weakref finalizers (at collection time): nothing may raise out of it."""
    global _LAYOUT_EVICTIONS, _LAYOUT_EVICTED_BYTES
    entry = _LAYOUT_CACHE.pop(key, None)
    if entry is None:
        return
    entry[2].detach()
    dropped = _layout_nbytes(entry[1])
    _LAYOUT_EVICTIONS += 1
    _LAYOUT_EVICTED_BYTES += dropped
    if _TELEMETRY.enabled:
        try:
            _TELEMETRY.record_cache_plane(
                "retrieval_layout",
                entries=len(_LAYOUT_CACHE),
                nbytes=_layout_cache_nbytes(),
                evictions=1,
                evicted_bytes=dropped,
            )
        except Exception:  # noqa: BLE001 — never out of a finalizer
            pass


def _layout_cache_store(key: tuple, qtable: Tensor, layout: tuple) -> None:
    old = _LAYOUT_CACHE.pop(key, None)
    if old is not None:
        old[2].detach()
    _LAYOUT_CACHE[key] = (_table_id(qtable), layout, weakref.finalize(qtable, _layout_cache_evict, key))
    while len(_LAYOUT_CACHE) > _LAYOUT_CACHE_MAX:
        _layout_cache_evict(next(iter(_LAYOUT_CACHE)))


# process-wide memory plane of the layout memo (one memo, one plane)
register_cache_plane("retrieval_layout", _layout_cache_nbytes)


def _table_id(qtable: Tensor) -> tuple:
    return (id(qtable), qtable._version)


def _table_layout_cached(qtable: Tensor, epoch_key: tuple):
    """The memoized padded unpack of ``qtable`` and whether the memo served
    it: reused when the owner's epoch key matches (same write clock, same
    table) or a sibling's entry holds the same table, unpacked otherwise."""
    tid = _table_id(qtable)
    hit = _LAYOUT_CACHE.get(epoch_key)
    if hit is not None and hit[0] == tid:
        _LAYOUT_CACHE.move_to_end(epoch_key)
        return hit[1], True
    for key, (tid2, layout2, _) in _LAYOUT_CACHE.items():
        if tid2 == tid:
            _LAYOUT_CACHE.move_to_end(key)
            _layout_cache_store(epoch_key, qtable, layout2)
            return layout2, True
    layout = retrieval_table_layout(qtable)
    _layout_cache_store(epoch_key, qtable, layout)
    return layout, False


class RetrievalMetric(Metric, ABC):
    """Base class for retrieval metrics over ``(indexes, preds, target)``
    triples. ``device=None`` means the card (see :class:`Metric`)."""

    higher_is_better = True
    __jit_unsafe__ = False  # table-state default: fixed-shape update, fusible
    #: the static analysis classifies the default mode: branches on
    #: ``self._exact`` belong to the opt-in exact (list-state) mode
    __exact_mode_attr__ = "_exact"
    # bucketed pads: the insert masks rows past n_valid out of the table
    __fused_mask_valid__ = True

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        exact: bool = False,
        max_queries: int = 1024,
        max_docs: int = 128,
        device: Optional[Union[str, torch.device]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(device=device, **kwargs)
        self.allow_non_binary_target = False

        empty_target_action_options = ("error", "skip", "neg", "pos")
        if empty_target_action not in empty_target_action_options:
            raise ValueError(f"Argument `empty_target_action` received a wrong value `{empty_target_action}`.")
        self.empty_target_action = empty_target_action

        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError("Argument `ignore_index` must be an integer or None.")
        self.ignore_index = ignore_index

        self._exact = bool(exact)
        if self._exact:
            register_exact_list_states(self, ("indexes", "preds", "target"), dist_reduce_fx=None)
            warn_exact_buffer(type(self).__name__, "indexes, targets and predictions")
        else:
            self.max_queries = max_queries
            self.max_docs = max_docs
            self.add_state(
                "qtable",
                default=retrieval_table_init(max_queries, max_docs, self.device),
                dist_reduce_fx=retrieval_table_merge_fx(),
            )
        # the subset-unpack readers (table-state reads)
        self._readers = ReaderCache()

    def _update(self, preds: Tensor, target: Tensor, indexes: Tensor, n_valid: Optional[Any] = None) -> None:
        if indexes is None:
            raise ValueError("Argument `indexes` cannot be None")

        if self._exact:
            indexes, preds, target = _check_retrieval_inputs(
                indexes,
                preds,
                target,
                allow_non_binary_target=self.allow_non_binary_target,
                ignore_index=self.ignore_index,
            )
            self.indexes.append(indexes)
            self.preds.append(preds)
            self.target.append(target)
            return

        indexes, preds, target, valid = _check_retrieval_inputs_static(
            indexes,
            preds,
            target,
            allow_non_binary_target=self.allow_non_binary_target,
            ignore_index=self.ignore_index,
        )
        self.qtable = retrieval_table_insert(self.qtable, indexes, preds, target, valid=valid, n_valid=n_valid)

    #: padded per-query row kernel ``(preds, target, mask, k) -> value`` from
    #: functional/retrieval/padded.py; None falls back to the host group loop
    _padded_metric: Optional[Callable] = None
    #: the top-k forwarded to the padded kernel (subclasses with a ``k``
    #: argument override it with a property)
    _padded_k: Optional[int] = None

    def _group_empty(self, mini_target: Tensor) -> bool:
        """True if this query has no positive target (override to invert)."""
        return not bool(torch.sum(mini_target))

    def _empty_rows(self, padded_target: Tensor, mask: Tensor) -> Tensor:
        """Vectorized ``_group_empty`` over the padded layout (override to invert)."""
        return (padded_target * mask).sum(-1) == 0

    def _table_empty_rows(self, pos_mass: Tensor, neg_count: Tensor) -> Tensor:
        """``_empty_rows`` from the table's EXACT counters, which document
        truncation never degrades (override to invert, see FallOut)."""
        return pos_mass <= 0

    def _empty_error_message(self) -> str:
        return "`compute` method was provided with a query with no positive target."

    def _compute(self) -> Tensor:
        if not self._exact:
            return self._compute_table()
        if self._padded_metric is not None:
            return self._compute_padded()
        return self._compute_host_loop()

    def set_dtype(self, dst_type: torch.dtype) -> "RetrievalMetric":
        # the readers were captured for the old dtype's table
        out = super().set_dtype(dst_type)
        self._readers.clear()
        return out

    def to_device(self, device: Any) -> "RetrievalMetric":
        self._readers.clear()
        return super().to_device(device)

    def _read_extras(self) -> dict:
        # on the read event of Metric.compute: the table rows unpacked and
        # whether the layout memo served them
        return {
            "table_rows": getattr(self, "_last_table_rows", 0),
            "cache_hit": getattr(self, "_last_layout_cache_hit", False),
            "layout_entries": len(_LAYOUT_CACHE),
            "layout_evictions": _LAYOUT_EVICTIONS,
        }

    def table_rows_layout(self, rows: Any):
        """Subset unpack: the padded layout of just the given TABLE rows, in
        the caller's order (no cross-row qid sort): ``(padded_preds,
        padded_target, mask, row_valid, pos_mass, neg_count, n_seen, qid)``,
        each leading with ``len(rows)``. Table-state mode only.

        Host row ids are padded to a bucket (repeating the last row) and
        read through the ``table_subset`` reader, one per bucket; the pad
        rows are cut off, and the result is a copy (the reader's next replay
        overwrites its outputs). Row ids already on the card are a plain
        gather."""
        if self._exact:
            raise ValueError(
                "table_rows_layout() reads the fixed-capacity table state; exact=True metrics keep cat-state lists"
            )
        if isinstance(rows, Tensor) and rows.device.type != "cpu":
            if rows.numel() == 0:
                raise ValueError("table_rows_layout() needs at least one row id")
            return retrieval_table_layout_rows(self.qtable, rows)
        rows = np.asarray(rows.numpy() if isinstance(rows, Tensor) else rows, dtype=np.int32).reshape(-1)
        if rows.size == 0:
            raise ValueError("table_rows_layout() needs at least one row id")
        t0 = time.perf_counter() if _TELEMETRY.enabled else 0.0
        n = rows.size
        bucket = round_up_bucket(n, self.max_queries)
        index = torch.as_tensor(pad_ids(rows, bucket), dtype=torch.long).to(self.qtable.device)
        reader = self._readers.fast("table_subset", bucket)
        if reader is None:
            reader = self._readers.get("table_subset", lambda: _layout_of, self.qtable.index_select(0, index), bucket=bucket)
        out = tuple(x[:n].clone() for x in reader.gather([self.qtable], index))
        if _TELEMETRY.enabled:
            _TELEMETRY.record_read("table", self, duration_s=time.perf_counter() - t0, table_rows=n, fanin=n)
        return out

    # ------------------------------------------------------------------
    # table-state compute (the fixed-capacity default)
    # ------------------------------------------------------------------
    def _compute_table(self) -> Tensor:
        """Compute over the table: rows unpack to the exact path's padded
        layout (query-id order), empty flags come from the exact counters,
        and unoccupied rows weigh nothing in the mean."""
        qtable = self.qtable
        if int(retrieval_table_fill(qtable)) == 0:
            raise ValueError(
                "`indexes` is empty — the retrieval metric has no accumulated samples;"
                " call `update` before `compute`."
            )
        # keyed on this metric's write epoch: repeated reads of an unwritten
        # table are hits whatever its identity
        layout, self._last_layout_cache_hit = _table_layout_cached(qtable, (id(self), self._write_epoch))
        padded_preds, padded_target, mask, row_valid, pos_mass, neg_count, _ = layout
        if _TELEMETRY.enabled:
            self._last_table_rows = int(row_valid.sum())
        empty = self._table_empty_rows(pos_mass, neg_count)
        if self.empty_target_action == "error" and bool((empty & row_valid).any()):
            raise ValueError(self._empty_error_message())

        kernel = type(self)._padded_metric
        if kernel is None:
            return self._compute_table_host_loop(padded_preds, padded_target, mask, row_valid, empty)
        weights = row_valid.to(torch.float32)
        if getattr(kernel, "sorted_fn", None) is not None:
            st, sm = sorted_row_layout(padded_preds, padded_target, mask)
            run = _padded_compute_fn(kernel, self._padded_k, self.empty_target_action)
            return run(st, sm, padded_target, empty, weights)
        run = _padded_compute_fn_raw(kernel, self._padded_k, self.empty_target_action)
        return run(padded_preds, padded_target, mask, empty, weights)

    def _compute_table_host_loop(
        self, padded_preds: Tensor, padded_target: Tensor, mask: Tensor, row_valid: Tensor, empty: Tensor
    ) -> Tensor:
        res = []
        fills = mask.sum(-1).tolist()
        rv = row_valid.tolist()
        emp = empty.tolist()
        for r in range(padded_preds.shape[0]):
            if not rv[r]:
                continue
            if emp[r]:
                if self.empty_target_action == "error":
                    raise ValueError(self._empty_error_message())
                if self.empty_target_action == "pos":
                    res.append(1.0)
                elif self.empty_target_action == "neg":
                    res.append(0.0)
            else:
                n = int(fills[r])
                res.append(self._metric(padded_preds[r, :n], padded_target[r, :n]))
        return self._mean(res, torch.float32)

    def _mean(self, res: list, dtype: torch.dtype) -> Tensor:
        if res:
            return torch.mean(torch.stack([torch.as_tensor(x, dtype=dtype, device=self.device) for x in res]))
        return torch.zeros((), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    # exact-mode (cat-state) compute paths
    # ------------------------------------------------------------------
    def _compute_padded(self) -> Tensor:
        """Compute over the packed ``[num_queries, max_docs]`` layout on the
        metric's device: two shape scalars (and the error flag when
        ``empty_target_action='error'``) are read back. The pack and the
        row sort are memoized on the state tensors' identity, so metrics
        that share states pack and sort once."""
        as_list = lambda s: s if isinstance(s, list) else [s]
        # heavily skewed query sizes make the [Q, Dmax] padding blow up; past
        # 16x expansion over the raw data the host loop wins
        packed = pack_queries_cached(as_list(self.indexes), as_list(self.preds), as_list(self.target), max_expand=16)
        if packed is None:
            return self._compute_host_loop()
        padded_preds, padded_target, mask = packed
        empty = self._empty_rows(padded_target, mask)
        if self.empty_target_action == "error" and bool(empty.any()):
            raise ValueError(self._empty_error_message())

        kernel = type(self)._padded_metric
        if getattr(kernel, "sorted_fn", None) is not None:
            st, sm = sorted_row_layout(padded_preds, padded_target, mask)
            run = _padded_compute_fn(kernel, self._padded_k, self.empty_target_action)
            return run(st, sm, padded_target, empty)
        run = _padded_compute_fn_raw(kernel, self._padded_k, self.empty_target_action)
        return run(padded_preds, padded_target, mask, empty)

    def _compute_host_loop(self) -> Tensor:
        indexes = dim_zero_cat(self.indexes)
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)

        res = []
        for group in get_group_indexes(indexes):
            mini_preds = preds[group]
            mini_target = target[group]
            if self._group_empty(mini_target):
                if self.empty_target_action == "error":
                    raise ValueError(self._empty_error_message())
                if self.empty_target_action == "pos":
                    res.append(1.0)
                elif self.empty_target_action == "neg":
                    res.append(0.0)
            else:
                res.append(self._metric(mini_preds, mini_target))
        return self._mean(res, preds.dtype)

    @abstractmethod
    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        """The metric of a single query's documents."""
