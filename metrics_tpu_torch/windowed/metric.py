"""``WindowedMetric`` -- sliding-window or exponential-decay state for a
metric whose leaves are sum, max or min states.

Counterpart of ``metrics_tpu/windowed/metric.py``, with two state layouts:

* **Ring mode** (default) -- every wrapped state leaf gets a leading
  ``[R]`` ring axis, one row per *bucket* of ``updates_per_bucket``
  consecutive updates. Each update folds into its slot, ``(count // k) %
  R`` from the ``_ring_count`` state, computed on the device (no host read
  per update); the first update of a bucket starts the slot from the
  defaults, so an expired bucket evicts itself. ``compute()`` folds the
  in-window rows oldest first through the wrapped metric's own
  ``merge_states`` (sum leaves add, max/min leaves fold), then runs the
  wrapped compute; ``compute(window=w, before=b)`` narrows to the last
  ``w`` buckets ending ``b`` buckets back, and raises where that reaches
  past the ring.
* **Decay mode** (``mode="decay"``) -- every (necessarily sum-reduced)
  leaf becomes the exponentially decayed sum ``alpha * state + delta``,
  with the effective weight ``sum_i alpha**i`` beside it.

Per-tenant windows are ``WindowedMetric(SlicedMetric(...))``: the leaves
become ``[R, S, ...]`` and each update runs the sliced scatter (and its
kernels) on the live slot. A synced read folds the synced rows the same
way, cold; the ring clock syncs by ``"max"`` (the furthest clock wins) and
same-bucket rows add.

**Fold memos** (the incremental read plane). A local read of buckets
``[lo, cur]`` splits at the live bucket: the completed buckets ``[lo,
cur-1]`` cannot change until the ring wraps past them (a window never
reaches that far), so their oldest-first prefix fold is memoized per
window start (``_fold_memo``, at most ``_FOLD_MEMO_MAX`` starts) and
extended only by newly completed buckets, and the live bucket merges on
top at each read. A repeat read at an idle clock returns the memoized
state (``_wstate_memo``: fan-in 0, ``cache_hit`` true, no host read). The
memos key on the host mirror of the ring clock (read from the card once
after an out-of-band write such as a fused replay), keep copies (never
views of the ring), and are cleared by ``reset``, ``set_dtype``,
``load_state_dict`` and ``sync``; a fused update keeps them (it rotates
the ring exactly as the eager update does). The merge sequence is the cold
fold's, so every read is bit-equal to it. A pure sum/max/min template
refolds two or more completed buckets at once through the ``window_fold``
reader (one CUDA graph of the unrolled fold over the gathered rows); sketch
leaves fold through ``merge_states`` one bucket at a time. The memos'
bytes are the ``windowed_fold_memo`` memory plane.

**The pad-and-mask contract** of a bucketed fused update
(``core/fused.py``): the wrapper declares ``__fused_mask_valid__``, takes
``n_valid`` and removes the edge-pad rows' contribution itself, as
``k_pad * delta(last_row)`` subtracted from the template's sum leaves in
the live ring slot (the fused update's generic correction would probe from
the default state, whose slot is another).

**The ring of sketches.** A sketch (``merge_like``) leaf of the wrapped
metric, such as a sketched curve metric's quantile sketch or
``SpearmanCorrCoef``'s reservoir, gets ``[R, capacity, cols]`` ring rows
under :func:`~metrics_tpu_torch.windowed.reducers.ring_merge_fx`. Each
bucket absorbs its batches through the wrapped metric's own insert, and a
read folds the window's rows oldest first with the wrapped merge (the
quantile sketch's compaction, K3 and K1 on the card, or the reservoir's
top ``k``). Inside each sketch's lossless window a read equals a fresh
metric fed the window's batches bit for bit. Decay mode refuses sketch
leaves: their weights must not be scaled.

**Telemetry.** With the default recorder enabled, an eager ring update
stamps its bucket's first-write wall time (from a host mirror of the ring
clock, read once from the card after an out-of-band write such as a fused
update), so ``freshness_stamp()`` reports the live ring's reach
(``ring_span_s``); ``window_state()`` records a ``window`` read event with
the buckets it folded, whether a memo served it (``cache_hit``) and the
buckets merged (``fanin``), and ``compute()``'s read event carries them too.
"""
import time
import weakref
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import torch
from torch.utils._pytree import tree_flatten

from metrics_tpu_torch.core.fused import pad_correct
from metrics_tpu_torch.core.metric import _AUTO_COUNT, Metric
from metrics_tpu_torch.core.readers import ReaderCache
from metrics_tpu_torch.observability.freshness import FreshnessStamp
from metrics_tpu_torch.observability.memory import register_cache_plane
from metrics_tpu_torch.observability.recorder import _DEFAULT_RECORDER as _TELEMETRY
from metrics_tpu_torch.sliced.metric import _reducer_name, _template_of, _wrapper_device
from metrics_tpu_torch.utils.checks import checks_read_nothing
from metrics_tpu_torch.utils.data import (
    _squeeze_if_scalar,
    dim_zero_max,
    dim_zero_min,
    dim_zero_sum,
    maximum_ieee,
    minimum_ieee,
)
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from metrics_tpu_torch.windowed.reducers import ring_merge_fx

Tensor = torch.Tensor

#: per-bucket update counter, ``[R]`` int32 ("ring"-reduced)
RING_ROWS = "_ring_rows"
#: total updates since reset, int32 scalar, the clock the ring slot derives
#: from ("max"-reduced)
RING_COUNT = "_ring_count"
#: decayed effective sample weight ``sum_i alpha**i``, float32 scalar
DECAY_WEIGHT = "_decay_weight"
#: key prefix of this wrapper's states in ``state_footprint``
WINDOWED_FOOTPRINT_PREFIX = "windowed/"

_RESERVED = (RING_ROWS, RING_COUNT, DECAY_WEIGHT)
_MODES = ("ring", "decay")

#: LRU bound on each fold memo: one entry per distinct (window, before)
#: read pattern or window start; serving loops use one or two
_FOLD_MEMO_MAX = 8

#: every live WindowedMetric (weak); the ``windowed_fold_memo`` memory
#: plane sums both memos' tensors over this set
_LIVE_WINDOWED: "weakref.WeakSet" = weakref.WeakSet()


def _fold_memo_nbytes() -> int:
    total = 0
    for m in list(_LIVE_WINDOWED):
        for memo in (getattr(m, "_fold_memo", None), getattr(m, "_wstate_memo", None)):
            for entry in list((memo or {}).values()):
                leaves = tree_flatten(entry)[0]
                total += sum(x.numel() * x.element_size() for x in leaves if isinstance(x, torch.Tensor))
    return total


register_cache_plane("windowed_fold_memo", _fold_memo_nbytes)


class WindowedMetric(Metric):
    """Track ``metric`` over a sliding window (ring) or with exponential decay.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanSquaredError
        >>> from metrics_tpu_torch.windowed import WindowedMetric
        >>> recent = WindowedMetric(MeanSquaredError(device="cpu"), window=3, updates_per_bucket=1)
        >>> for err in (9.0, 9.0, 0.0, 0.0, 0.0):  # old errors age out
        ...     recent.update(torch.tensor([err]), torch.tensor([0.0]))
        >>> float(recent.compute())  # only the last 3 buckets remain
        0.0

    Ring mode: ``window`` buckets of ``updates_per_bucket`` updates each;
    ``compute()`` covers the whole ring, ``compute(window=w)`` the last
    ``w`` buckets. Decay mode: ``WindowedMetric(m, mode="decay",
    decay=0.99)``. Reset, ``state_dict`` and ``merge_states`` are the
    ordinary :class:`Metric` ones. The metric runs on the wrapped metric's
    device; a ``device=`` must name that device (:class:`MetricsUserError`
    otherwise).
    """

    higher_is_better = None
    is_differentiable = False

    def __init__(
        self,
        metric: Metric,
        *,
        window: Optional[int] = None,
        updates_per_bucket: Optional[int] = None,
        mode: str = "ring",
        decay: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        if not isinstance(metric, Metric):
            raise MetricsUserError(f"WindowedMetric wraps a Metric instance, got {type(metric).__name__}")
        if isinstance(metric, WindowedMetric):
            raise MetricsUserError("WindowedMetric cannot wrap another WindowedMetric")
        if mode not in _MODES:
            raise MetricsUserError(f"`mode` must be one of {_MODES}, got {mode!r}")
        if mode == "ring":
            window = 8 if window is None else window
            updates_per_bucket = 1 if updates_per_bucket is None else updates_per_bucket
            if not isinstance(window, int) or window < 2:
                raise MetricsUserError(f"`window` must be an int >= 2, got {window!r}")
            if not isinstance(updates_per_bucket, int) or updates_per_bucket < 1:
                raise MetricsUserError(f"`updates_per_bucket` must be a positive int, got {updates_per_bucket!r}")
            if decay is not None:
                raise MetricsUserError("`decay` only applies to mode='decay'")
        else:
            if window is not None or updates_per_bucket is not None:
                raise MetricsUserError("`window`/`updates_per_bucket` only apply to mode='ring'")
            window, updates_per_bucket = 0, 0
            decay = 0.99 if decay is None else decay
            if not isinstance(decay, (int, float)) or not 0.0 < float(decay) < 1.0:
                raise MetricsUserError(f"`decay` must be a float in (0, 1), got {decay!r}")
        self._validate_windowable(metric, mode)
        super().__init__(device=_wrapper_device(metric, kwargs, "WindowedMetric"), **kwargs)
        self.mode = mode
        self.window = int(window)
        self.updates_per_bucket = int(updates_per_bucket)
        self._alpha = float(decay) if decay is not None else None
        # set past the child registry: the template is not a child (a child
        # would send this metric to a fused update's eager leg, and its
        # placeholder states would count in the footprint)
        object.__setattr__(self, "_template", _template_of(metric))
        m = self._template
        if mode == "ring":
            for name, red in m._reductions.items():
                default = m._defaults[name]
                if red is dim_zero_sum:
                    fx: Any = "ring"
                elif red in (dim_zero_max, dim_zero_min):
                    fx = "max" if red is dim_zero_max else "min"
                else:  # a sketch (merge_like), validated
                    fx = ring_merge_fx(red)
                self.add_state(name, default=default.expand((self.window,) + tuple(default.shape)), dist_reduce_fx=fx)
            self.add_state(RING_ROWS, default=torch.zeros(self.window, dtype=torch.int32), dist_reduce_fx="ring")
            self.add_state(RING_COUNT, default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="max")
        else:
            for name in m._reductions:
                default = m._defaults[name]
                # a decayed count is fractional: an integer leaf would
                # truncate alpha * count
                self.add_state(name, default=default if default.is_floating_point() else default.to(torch.float32), dist_reduce_fx="decay")
            self.add_state(DECAY_WEIGHT, default=torch.tensor(0.0), dist_reduce_fx="decay")
        # the pad-and-mask contract: this wrapper takes `n_valid` and
        # corrects the pad rows in the live slot itself (_pad_correct)
        self.__fused_mask_valid__ = True
        # host-side ring clock for freshness stamps (telemetry-enabled eager
        # updates only): each live bucket's first-write wall time, and a
        # host mirror of the ring count (None: read it from the card once)
        self._bucket_wall: List[Optional[float]] = [None] * max(self.window, 1)
        self._host_count: Optional[int] = 0
        self._last_fold_buckets = 0
        self._last_fold_oldest_wall: Optional[float] = None
        self._last_fold_fanin = 0
        self._last_read_cache_hit = False
        # the fold memos: window start -> (last completed bucket folded,
        # prefix state); (window, before) -> (ring clock, state, buckets,
        # oldest wall)
        self._fold_memo: "OrderedDict[int, tuple]" = OrderedDict()
        self._wstate_memo: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._readers = ReaderCache()
        _LIVE_WINDOWED.add(self)

    @staticmethod
    def _validate_windowable(metric: Metric, mode: str) -> None:
        cls_name = type(metric).__name__
        if getattr(metric, "__jit_unsafe__", False):
            raise MetricsUserError(
                f"`{cls_name}` declares `__jit_unsafe__` — its update cannot trace, so it"
                " cannot run inside the windowed ring/decay kernel."
            )
        if metric._children:
            raise MetricsUserError(
                f"`{cls_name}` is a wrapper metric (child registry"
                f" {sorted(dict(metric._iter_child_metrics()))}); window the inner"
                " metric directly instead of the wrapper."
            )
        for name, red in metric._reductions.items():
            if isinstance(metric._defaults[name], list):
                raise MetricsUserError(
                    f"`{cls_name}` state `{name}` is a list ('cat') state; unbounded"
                    " concatenation has no fixed-shape ring row. Use the metric's"
                    " sketched mode (fixed-capacity merge leaves window exactly)."
                )
            if name in _RESERVED:
                raise MetricsUserError(f"`{cls_name}` state `{name}` collides with a reserved windowed state name")
            merge_like = bool(getattr(red, "merge_like", False))
            if mode == "decay":
                if red is not dim_zero_sum:
                    hint = (
                        " (extrema cannot forget and sketch weights must not be scaled — use mode='ring')"
                        if red in (dim_zero_max, dim_zero_min) or merge_like
                        else ""
                    )
                    raise MetricsUserError(
                        f"`{cls_name}` state `{name}` has reducer"
                        f" `{_reducer_name(red)}`; exponential decay is only exact for"
                        f" sum-reduced leaves{hint}. A mean-style metric should"
                        " accumulate sum-reduced numerator/denominator leaves."
                    )
            elif red not in (dim_zero_sum, dim_zero_max, dim_zero_min) and not merge_like:
                hint = " (the auto mean-merge counter has no per-bucket fold)" if name == _AUTO_COUNT else ""
                raise MetricsUserError(
                    f"`{cls_name}` state `{name}` has reducer"
                    f" `{_reducer_name(red)}`; only sum/max/min/merge-reduced array"
                    f" states have an exact per-bucket ring fold{hint}. A mean-style"
                    " metric should accumulate sum-reduced numerator/denominator"
                    " leaves."
                )

    # ------------------------------------------------------------------
    # update
    # ------------------------------------------------------------------
    @property
    def wrapped(self) -> Metric:
        """The wrapped template metric (its states are placeholders)."""
        return self._template

    @property
    def bucket_counts(self) -> Tensor:
        """Updates absorbed per ring bucket, ``[R]`` int32 (ring mode)."""
        if self.mode != "ring":
            raise MetricsUserError("`bucket_counts` is a ring-mode query")
        return getattr(self, RING_ROWS)

    @property
    def decay_weight(self) -> Tensor:
        """Effective decayed sample weight ``sum_i alpha**i`` (decay mode)."""
        if self.mode != "decay":
            raise MetricsUserError("`decay_weight` is a decay-mode query")
        return getattr(self, DECAY_WEIGHT)

    @staticmethod
    def _pad_correct(
        new: Dict[str, Tensor], args: Any, fkw: Dict[str, Any], n_valid: Optional[Any], m: Metric
    ) -> Dict[str, Tensor]:
        """Remove the edge-pad rows' contribution from the template's sum
        leaves (the fused bucketing contract, :func:`~metrics_tpu_torch.core.fused.pad_correct`),
        here where the live slot is known."""
        if n_valid is None:
            return new
        b = next((int(x.shape[0]) for x in tree_flatten((args, fkw))[0] if isinstance(x, Tensor) and x.ndim >= 1), None)
        if b is None:
            return new
        device = next(iter(new.values())).device
        n_valid = torch.as_tensor(n_valid, dtype=torch.int32, device=device)
        k_pad = torch.full((), b, dtype=torch.int32, device=device) - n_valid
        return pad_correct(m, new, args, fkw, k_pad)

    def _update(self, *args: Any, **kwargs: Any) -> None:
        m = self._template
        n_valid = kwargs.pop("n_valid", None)
        fkw = m._filter_kwargs(**kwargs)
        call_kw = fkw
        if n_valid is not None and getattr(m, "__fused_mask_valid__", False):
            # a masking template takes n_valid itself; its sum leaves still
            # count the padded batch, so the correction below applies too
            call_kw = {**fkw, "n_valid": n_valid}
        if self.mode == "decay":
            base = {}
            for name in m._defaults:
                leaf = getattr(self, name)
                base[name] = torch.full((), self._alpha, dtype=leaf.dtype, device=leaf.device) * leaf
            new = self._pad_correct(m.update_state(base, *args, **call_kw), args, fkw, n_valid, m)
            for name in m._defaults:
                # keep the registered (float-promoted) dtype
                setattr(self, name, new[name].to(self._defaults[name].dtype))
            w = getattr(self, DECAY_WEIGHT)
            setattr(self, DECAY_WEIGHT, torch.full((), self._alpha, dtype=w.dtype, device=w.device) * w + 1.0)
            return

        count = getattr(self, RING_COUNT)
        k, r = self.updates_per_bucket, self.window
        if not checks_read_nothing():
            self._advance_clock(count)
        # the slot and the bucket's start, on the device: no host read
        slot = ((count // k) % r).reshape(1).long()
        fresh = (count % k) == 0
        if k == 1:
            # every update starts a bucket: the defaults themselves, with a
            # sketch default's empty-occupancy bound (no compaction while
            # the batch fits)
            base = dict(m._defaults)
        else:
            # the first update of a bucket starts from the defaults, so a
            # wrapped (expired) bucket evicts itself
            base = {name: torch.where(fresh, m._defaults[name], getattr(self, name).index_select(0, slot)[0]) for name in m._defaults}
        new = self._pad_correct(m.update_state(base, *args, **call_kw), args, fkw, n_valid, m)
        for name in m._defaults:
            leaf = getattr(self, name)
            setattr(self, name, leaf.index_copy(0, slot, new[name].to(leaf.dtype).unsqueeze(0)))
        rows = getattr(self, RING_ROWS)
        filled = torch.where(fresh, torch.zeros_like(rows[:1]), rows.index_select(0, slot)) + 1
        setattr(self, RING_ROWS, rows.index_copy(0, slot, filled))
        setattr(self, RING_COUNT, count + 1)

    def _advance_clock(self, count: Tensor) -> None:
        """Advance the host mirror of the ring clock by an eager update and,
        with telemetry on, stamp the live bucket's first write. An unknown
        mirror (after an out-of-band write) is read from the card only when
        telemetry needs the bucket now; otherwise the next read reads it."""
        c = self._host_count
        if _TELEMETRY.enabled:
            if c is None:
                c = int(count)
            k, r = self.updates_per_bucket, self.window
            s = (c // k) % r
            if c % k == 0 or self._bucket_wall[s] is None:
                self._bucket_wall[s] = time.time()
        self._host_count = None if c is None else c + 1

    def _ring_clock(self) -> int:
        """The ring clock from its host mirror (one read of the card after
        an out-of-band write)."""
        if self._host_count is None:
            self._host_count = int(getattr(self, RING_COUNT))
        return self._host_count

    def update_state(self, state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        # a pure update writes another state: this metric's ring clock and
        # bucket stamps stay as they are
        saved = (self._host_count, list(self._bucket_wall))
        try:
            return super().update_state(state, *args, **kwargs)
        finally:
            self._host_count, self._bucket_wall = saved

    def _clear_memos(self) -> None:
        memo = getattr(self, "_fold_memo", None)
        if memo is not None:
            memo.clear()
            self._wstate_memo.clear()

    def _mark_state_written(self) -> None:
        # an install (a restore, a load, a group borrow) moves the ring
        # clock without the host seeing it, and replaces the rows the memos
        # describe
        super()._mark_state_written()
        self._host_count = None
        self._clear_memos()

    def _mark_fused_written(self, donated: bool) -> None:
        # a fused update rotates the ring exactly as the eager update does:
        # completed buckets stay as they were, so the memos stay (they hold
        # copies, not the buffers); the clock's mirror lapses
        self._update_called = True
        self._states_donated = donated
        self._write_epoch += 1
        self._computed = None
        self._host_count = None

    def sync(self, *args: Any, **kwargs: Any) -> None:
        # synced rows describe another stream than the local memos
        self._clear_memos()
        super().sync(*args, **kwargs)

    def set_dtype(self, dst_type: torch.dtype) -> "WindowedMetric":
        out = super().set_dtype(dst_type)
        self._clear_memos()
        self._readers.clear()
        return out

    def to_device(self, device: Any) -> "WindowedMetric":
        self._readers.clear()
        return super().to_device(device)

    def reset(self) -> None:
        super().reset()
        self._bucket_wall = [None] * max(self.window, 1)
        self._host_count = 0
        self._last_fold_buckets = 0
        self._last_fold_oldest_wall = None

    # ------------------------------------------------------------------
    # window folds / compute
    # ------------------------------------------------------------------
    def _window_rows(self, window: int, before: int) -> List[Dict[str, Tensor]]:
        """The row states of the last ``window`` buckets ending ``before``
        buckets back, oldest first (buckets never filled are skipped). Reads
        the (synced) ring clock and bucket counts to the host."""
        m = self._template
        count = int(getattr(self, RING_COUNT))
        k, r = self.updates_per_bucket, self.window
        cur = (count - 1) // k - before
        if count == 0 or cur < 0:
            return []
        lo = max(cur - window + 1, 0)
        if (count - 1) // k - lo >= r:
            raise MetricsUserError(
                f"window of {window} bucket(s) ending {before} back reaches past the"
                f" ring span ({r} buckets); those buckets were already evicted"
            )
        counts = getattr(self, RING_ROWS).tolist()
        live = [b for b in range(lo, cur + 1) if counts[b % r] > 0]
        # read-event side channel: the buckets this fold covered and how
        # far back (wall clock) the oldest one reaches
        walls = [self._bucket_wall[b % r] for b in live if self._bucket_wall[b % r] is not None]
        self._last_fold_buckets = len(live)
        self._last_fold_oldest_wall = min(walls) if walls else None
        return [{name: getattr(self, name)[b % r] for name in m._defaults} for b in live]

    def window_state(self, window: Optional[int] = None, *, before: int = 0) -> Dict[str, Tensor]:
        """The wrapped metric's state folded over the last ``window`` buckets
        (default: the whole ring) ending ``before`` buckets back: rows fold
        oldest first through the wrapped ``merge_states``. With telemetry
        enabled, a ``window`` read event."""
        if not _TELEMETRY.enabled:  # the disabled read path stays ONE bool check
            return self._window_state_impl(window, before=before)
        t0 = time.perf_counter()
        state = self._window_state_impl(window, before=before)
        _TELEMETRY.record_read(
            "window",
            self,
            duration_s=time.perf_counter() - t0,
            ring_buckets=self._last_fold_buckets,
            cache_hit=self._last_read_cache_hit,
            fanin=self._last_fold_fanin,
            freshness=self._window_freshness(),
        )
        return state

    def _window_state_impl(self, window: Optional[int] = None, *, before: int = 0) -> Dict[str, Tensor]:
        if self.mode != "ring":
            raise MetricsUserError("window_state() is a ring-mode query; decay mode keeps one decayed state")
        w = self.window if window is None else window
        if not isinstance(w, int) or isinstance(w, bool) or w < 1:
            raise MetricsUserError(f"`window` must be a positive int, got {w!r}")
        if w > self.window:
            raise MetricsUserError(
                f"`window` of {w} bucket(s) exceeds the ring span ({self.window});"
                " construct the metric with a larger `window` to query it"
            )
        if not isinstance(before, int) or isinstance(before, bool) or before < 0:
            raise MetricsUserError(f"`before` must be a non-negative int, got {before!r}")
        m = self._template
        if not self._is_synced:
            return self._window_state_incremental(w, before)
        # synced rows describe another stream than the local memos: fold
        # cold, reading and writing neither
        rows = self._window_rows(w, before)
        self._last_fold_fanin = len(rows)
        self._last_read_cache_hit = False
        if not rows:
            return m.init_state()
        state = rows[0]
        for row in rows[1:]:
            state = m.merge_states(state, row)
        return state

    def _row(self, slot: int) -> Dict[str, Tensor]:
        return {name: getattr(self, name)[slot] for name in self._template._defaults}

    def _window_state_incremental(self, w: int, before: int) -> Dict[str, Tensor]:
        """The memoized window fold of the local states (see the module
        docstring): the same merges, in the same order, as the cold fold."""
        m = self._template
        count = self._ring_clock()
        k, r = self.updates_per_bucket, self.window
        cur = (count - 1) // k - before
        self._last_read_cache_hit = False
        if count == 0 or cur < 0:
            self._last_fold_buckets, self._last_fold_oldest_wall, self._last_fold_fanin = 0, None, 0
            return m.init_state()
        lo = max(cur - w + 1, 0)
        if (count - 1) // k - lo >= r:
            raise MetricsUserError(
                f"window of {w} bucket(s) ending {before} back reaches past the"
                f" ring span ({r} buckets); those buckets were already evicted"
            )
        # a repeat read at an idle clock: the same rows, the same fold
        hit = self._wstate_memo.get((w, before))
        if hit is not None and hit[0] == count:
            self._wstate_memo.move_to_end((w, before))
            _, state, self._last_fold_buckets, self._last_fold_oldest_wall = hit
            self._last_fold_fanin = 0
            self._last_read_cache_hit = True
            return dict(state)
        counts = getattr(self, RING_ROWS).tolist()
        live = [b for b in range(lo, cur + 1) if counts[b % r] > 0]
        walls = [self._bucket_wall[b % r] for b in live if self._bucket_wall[b % r] is not None]
        self._last_fold_buckets = len(live)
        self._last_fold_oldest_wall = min(walls) if walls else None
        if not live:
            self._last_fold_fanin = 0
            return m.init_state()
        # the prefix fold over the completed buckets [lo, cur-1]
        stored = self._fold_memo.get(lo)
        if stored is not None and stored[0] <= cur - 1:
            prev_hi, prefix = stored
        else:
            # no memo for this start, or a `before`-shifted read that ends
            # before the stored prefix does: fold this read from scratch
            prev_hi, prefix = lo - 1, None
        fold = [b for b in live if prev_hi < b <= cur - 1]
        fanin = len(fold)
        if fold:
            if prefix is None and len(fold) >= 2 and self._aot_foldable():
                prefix = self._fold_rows_aot([b % r for b in fold])
            else:
                for b in fold:
                    row = self._row(b % r)
                    # a lone row is a view of the ring: the memo keeps a copy
                    prefix = _copied(row) if prefix is None else m.merge_states(prefix, row)
        if cur - 1 >= lo and (stored is None or stored[0] < cur - 1):
            self._fold_memo[lo] = (cur - 1, prefix)
            self._fold_memo.move_to_end(lo)
            while len(self._fold_memo) > _FOLD_MEMO_MAX:
                self._fold_memo.popitem(last=False)
        state = prefix
        if counts[cur % r] > 0:
            row = self._row(cur % r)
            state = _copied(row) if state is None else m.merge_states(state, row)
            fanin += 1
        self._last_fold_fanin = fanin
        self._wstate_memo[(w, before)] = (count, state, self._last_fold_buckets, self._last_fold_oldest_wall)
        self._wstate_memo.move_to_end((w, before))
        while len(self._wstate_memo) > _FOLD_MEMO_MAX:
            self._wstate_memo.popitem(last=False)
        # the caller's dict is its own; the memoized tensors are never
        # written in place
        return dict(state)

    def _aot_foldable(self) -> bool:
        """Pure sum/max/min templates refold through one reader; sketch
        leaves (and the mean counter's merge rule) fold through
        ``merge_states``."""
        m = self._template
        return _AUTO_COUNT not in m._reductions and all(
            red in (dim_zero_sum, dim_zero_max, dim_zero_min) for red in m._reductions.values()
        )

    def _fold_rows_aot(self, slots: List[int]) -> Dict[str, Tensor]:
        """Fold ``n`` completed buckets oldest first through the
        ``window_fold`` reader: the left-associated per-leaf merges of
        ``merge_states`` unrolled over the gathered rows (on the card one
        CUDA graph per ``n``, at most the ring span), bit-equal to the
        eager loop. Returns copies."""
        m = self._template
        n = len(slots)
        names = list(m._defaults)
        index = torch.as_tensor(slots, dtype=torch.long).to(self.device)
        reader = self._readers.fast("window_fold", n)
        if reader is None:
            reds = dict(m._reductions)

            def build():
                def fold(stacked: Dict[str, Tensor]) -> Dict[str, Tensor]:
                    state = {name: v[0] for name, v in stacked.items()}
                    for i in range(1, n):
                        for name, red in reds.items():
                            a, b = state[name], stacked[name][i]
                            if red is dim_zero_sum:
                                state[name] = a + b
                            elif red is dim_zero_max:
                                state[name] = maximum_ieee(a, b)
                            else:
                                state[name] = minimum_ieee(a, b)
                    return state

                return fold

            stacked = {name: getattr(self, name).index_select(0, index) for name in names}
            reader = self._readers.get("window_fold", build, stacked, bucket=n)
        # a copy: the reader's next replay overwrites its outputs
        return _copied(reader.gather([getattr(self, name) for name in names], index))

    def _compute(self) -> Any:
        m = self._template
        if self.mode == "decay":
            return m.compute_state({name: getattr(self, name) for name in m._defaults})
        # the un-instrumented fold: Metric.compute() records the read and
        # takes the fold size from _read_extras()
        return m.compute_state(self._window_state_impl())

    def compute(self, *, window: Optional[int] = None, before: Optional[int] = None) -> Any:
        """The wrapped metric over the window.

        With no arguments: the whole ring (or the decayed state) through the
        ordinary :meth:`Metric.compute` cycle. ``window=w`` evaluates the last
        ``w`` buckets only, ``before=b`` shifts the window's end ``b`` buckets
        back (ring mode only; neither is cached)."""
        if window is None and before is None:
            return super().compute()
        if self.mode != "ring":
            raise MetricsUserError("compute(window=...) is a ring-mode query")
        return self._undonated(
            _squeeze_if_scalar(self._template.compute_state(self.window_state(window, before=before or 0)))
        )

    def _window_freshness(self, now: Optional[float] = None) -> FreshnessStamp:
        """Stamp of the last window fold: the oldest folded bucket's first
        write bounds the window's reach (``ring_span_s``)."""
        now = time.time() if now is None else now
        oldest = self._last_fold_oldest_wall
        return FreshnessStamp(
            min_event_t=oldest,
            max_event_t=self._ingest_last_t,
            ring_span_s=max(0.0, now - oldest) if oldest is not None else 0.0,
        )

    def freshness_stamp(self, now: Optional[float] = None) -> FreshnessStamp:
        """Ring-aware stamp: data older than the live ring was evicted, so
        ``min_event_t`` is the oldest live bucket's first write and
        ``ring_span_s`` the ring's wall-clock reach."""
        base = super().freshness_stamp(now)
        if self.mode != "ring":
            return base
        walls = [w for w in self._bucket_wall if w is not None]
        if not walls:
            return base
        oldest = min(walls)
        now = time.time() if now is None else now
        return FreshnessStamp(
            min_event_t=oldest if base.min_event_t is None else max(base.min_event_t, oldest),
            max_event_t=base.max_event_t,
            ring_span_s=max(0.0, now - oldest),
        )

    def _read_extras(self) -> Dict[str, Any]:
        if self.mode != "ring":
            return {}
        return {
            "ring_buckets": self._last_fold_buckets,
            "cache_hit": self._last_read_cache_hit,
            "fanin": self._last_fold_fanin,
        }

    def state_footprint(self, include_children: bool = True) -> Dict[str, int]:
        """Bytes per state, every key under ``"windowed/"``."""
        base = super().state_footprint(include_children=include_children)
        return {f"{WINDOWED_FOOTPRINT_PREFIX}{k}": v for k, v in base.items()}

    def __repr__(self) -> str:
        inner = type(self._template).__name__
        if self.mode == "decay":
            return f"{type(self).__name__}({inner}(), mode='decay', decay={self._alpha})"
        return f"{type(self).__name__}({inner}(), window={self.window}, updates_per_bucket={self.updates_per_bucket})"


def _copied(state: Dict[str, Tensor]) -> Dict[str, Tensor]:
    return {name: v.clone() for name, v in state.items()}
