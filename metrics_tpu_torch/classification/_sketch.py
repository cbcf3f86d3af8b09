"""Sketch-backed streaming mode for the curve metric classes.

Counterpart of ``metrics_tpu/classification/_sketch.py``: the DEFAULT mode
of ``AUROC``, ``ROC``, ``PrecisionRecallCurve`` and ``AveragePrecision``
(the last three share their constructor and update through
``CurveModesMixin``, which also routes ``exact=True`` and ``capacity=N``).
Canonicalised batches stream into one packed quantile-sketch
state (:mod:`metrics_tpu_torch.sketches.quantile`): O(capacity) memory, a
fixed-shape update, and a ``merge`` reducer. Row layouts (column 0 is the
weight):

* binary:    ``[capacity, 3]``       (w, score, y)
* per-class: ``[capacity, 2 + 2C]``  (w, max-score key, C scores, C one-hot
  or indicator columns)

**Lossless window.** Until the first compaction (fill == rows seen) the
sketch holds the exact canonicalised stream in arrival order; compute
rebuilds the arrays and runs the exact curve kernels, as ``exact=True``
would. Past capacity the weighted kernels
(``functional/classification/sketch_curve.py``) take over, within the
sketch's rank-error bound. The update reads nothing back from the card
(beyond the input checks' one read); compute reads the fill count once.
``AUROC``'s weighted read goes through a
:class:`~metrics_tpu_torch.core.readers.ReaderCache` (``_readers``): one
reader per shape bucket of the padded rows, a CUDA graph on the card.
"""
from typing import Any, Mapping, Optional, Tuple

import torch

from metrics_tpu_torch.classification._capacity import CapacityCurveMixin
from metrics_tpu_torch.core.readers import ReaderCache, round_up_bucket
from metrics_tpu_torch.sketches.compat import register_exact_list_states, warn_exact_buffer
from metrics_tpu_torch.sketches.quantile import qsketch_fill, qsketch_init, qsketch_insert, sketch_merge_fx
from metrics_tpu_torch.utils.checks import checks_read_nothing
from metrics_tpu_torch.utils.data import _refuse_bool_labels, dim_zero_cat

Tensor = torch.Tensor

#: default quantile-sketch capacity of the curve family: 3 float32 columns
#: at 8192 rows is 96 KiB (binary case) for < 0.05% relative rank error, and
#: every stream that fits stays exact
DEFAULT_SKETCH_CAPACITY = 8192

_MODE_CHANGED = "The mode of data (binary, multi-label, multi-class) should be constant, but changed between batches"


class SketchCurveMixin:
    """Adds the sketch-backed default mode. Call ``_init_sketch_curve`` in
    ``__init__`` for the default configuration; route ``_update`` and
    ``_compute`` on ``self._sketch_capacity``."""

    _sketch_capacity: Optional[int] = None
    _sketch_cols: Optional[int] = None  # None = binary; C = per-class rows
    _sketch_tgt_kind: Optional[str] = None  # "int" (one-hot) | "indicator"
    _sketch_case_locked: bool = False
    _shape_stable_reads: bool = False

    def _init_sketch_curve(self, sketch_capacity: int, num_classes: Optional[int], shape_stable_reads: bool = False) -> None:
        if not (isinstance(sketch_capacity, int) and sketch_capacity > 0):
            raise ValueError(f"Argument `sketch_capacity` must be a positive int, got {sketch_capacity}")
        self._sketch_capacity = sketch_capacity
        self._shape_stable_reads = bool(shape_stable_reads)
        # the weighted compute's readers, one per shape bucket
        self._readers = ReaderCache()
        self._sketch_cols = num_classes if (num_classes is not None and num_classes >= 2) else None
        payload = 1 if self._sketch_cols is None else 2 * self._sketch_cols
        self.add_state(
            "csketch",
            default=qsketch_init(sketch_capacity, payload_cols=payload, device=self.device),
            dist_reduce_fx=sketch_merge_fx(),
        )
        self.add_state("n_seen", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def _register_sketch(self, num_cols: Optional[int]) -> None:
        """(Re-)register the sketch state for binary rows (``None``) or
        ``num_cols`` per-class rows."""
        self._sketch_cols = num_cols
        payload = 1 if num_cols is None else 2 * num_cols
        default = qsketch_init(self._sketch_capacity, payload_cols=payload, device=self.device)
        self.add_state("csketch", default=default, dist_reduce_fx=sketch_merge_fx())

    def _rebuild_sketch_case(self, num_cols: Optional[int]) -> None:
        """Re-register the sketch for the case the first batch has. Legal
        only before any row landed: the case lock (set by the first insert)
        refuses afterwards, and so does a non-empty sketch (one restored
        from a checkpoint, say), which costs one host read; under the
        capture rule of ``utils/checks.py`` that read is skipped, as the
        JAX package skips it on a tracer."""
        if self._sketch_case_locked or (not checks_read_nothing() and int(qsketch_fill(self.csketch)) > 0):
            raise ValueError(_MODE_CHANGED)
        self._register_sketch(num_cols)
        self._sketch_tgt_kind = None

    def _set_host_state(self, values: Mapping[str, Any]) -> None:
        """Adopt host-side attributes; a changed row layout re-registers the
        sketch state, so that its default matches the carried state."""
        values = dict(values)
        if self._sketch_capacity is not None and "_sketch_cols" in values:
            cols = values.pop("_sketch_cols")
            if cols != self._sketch_cols:
                self._register_sketch(cols)
        super()._set_host_state(values)

    # ------------------------------------------------------------------
    # update
    # ------------------------------------------------------------------
    def _sketch_insert_canonical(
        self, preds: Tensor, target: Tensor, pos_label: Optional[int], n_valid: Optional[Any] = None
    ) -> None:
        """Insert one canonicalised batch (flat binary scores with integer
        targets, or ``[N, C]`` score rows with integer labels or indicator
        rows)."""
        if preds.ndim == 1:
            if self._sketch_cols is not None:
                self._rebuild_sketch_case(None)
            pl = 1 if pos_label is None else pos_label
            y = (target == pl).to(torch.float32)
            self.csketch = qsketch_insert(self.csketch, preds, payload=y[:, None], n_valid=n_valid)
        else:
            c = preds.shape[1]
            if self._sketch_cols != c:
                self._rebuild_sketch_case(c)
            if target.ndim == 1:
                tgt_kind = "int"
                _refuse_bool_labels(target)
                classes = torch.arange(c, dtype=target.dtype, device=target.device)
                ytab = (target[:, None] == classes[None, :]).to(torch.float32)
            else:
                tgt_kind = "indicator"
                ytab = target.to(torch.float32)
            if self._sketch_tgt_kind is not None and self._sketch_tgt_kind != tgt_kind:
                raise ValueError(_MODE_CHANGED)
            self._sketch_tgt_kind = tgt_kind
            scores = preds.to(torch.float32)
            payload = torch.cat([scores, ytab], dim=1)
            self.csketch = qsketch_insert(self.csketch, scores.amax(dim=1), payload=payload, n_valid=n_valid)
        self.n_seen = self.n_seen + preds.shape[0]
        # later batches of another case raise the mode-change error
        self._sketch_case_locked = True

    # ------------------------------------------------------------------
    # compute-side views (host reads the update path never pays)
    # ------------------------------------------------------------------
    def _sketch_fill_and_seen(self) -> Tuple[int, int]:
        fill, seen = torch.stack([qsketch_fill(self.csketch), self.n_seen.to(torch.int32)]).tolist()
        return fill, seen

    def _sketch_reads_exact(self, fill: int, seen: int) -> bool:
        """Should this read take the exact kernels? Yes inside the lossless
        window (no compaction ever dropped a row: the sketch IS the stream),
        unless ``shape_stable_reads`` is on, where only the empty sketch
        does and every other read takes the weighted kernels."""
        if fill != seen:
            return False
        return not self._shape_stable_reads or seen == 0

    def _sketch_exact_arrays(self, fill: int) -> Tuple[Tensor, Tensor, Optional[int]]:
        """The canonicalised stream inside the lossless window:
        ``(preds, target, pos_label_for_compute)`` as the unbounded path would
        have accumulated them (targets come back as the stored indicators, so
        the positive class is 1)."""
        rows = self.csketch[:fill]
        key, payload = rows[:, 1], rows[:, 2:]
        if self._sketch_cols is None:
            return key, payload[:, 0].to(torch.int32), 1
        c = self._sketch_cols
        scores, ytab = payload[:, :c], payload[:, c:]
        if self._sketch_tgt_kind == "indicator":
            return scores, ytab.to(torch.int32), 1
        return scores, ytab.argmax(dim=1).to(torch.int32), None

    def _sketch_weighted_arrays(self, fill: int) -> Tuple[Tensor, Tensor, Tensor]:
        """Past the window: ``(scores, y, w)`` with ``y`` the (possibly
        fractional) positive mass; ``([n, C], [n, C], [n])`` per class. Rows
        are padded up to a shape bucket with the sketch's own zero-weight
        rows (it packs occupied rows first), which the weighted kernels sort
        last and weigh zero, as the JAX package does."""
        rows = self.csketch[: round_up_bucket(max(fill, 1), self.csketch.shape[0])]
        w, key, payload = rows[:, 0], rows[:, 1], rows[:, 2:]
        if self._sketch_cols is None:
            return key, payload[:, 0], w
        c = self._sketch_cols
        return payload[:, :c], payload[:, c:], w


class CurveModesMixin(SketchCurveMixin, CapacityCurveMixin):
    """The constructor and update shared by ``ROC``,
    ``PrecisionRecallCurve`` and ``AveragePrecision``: pick the state mode,
    canonicalise each batch with ``_curve_update`` and route it."""

    _exact: bool = False
    # what a first update fixes (carried by ``state_from_jax``)
    _host_state = ("num_classes", "pos_label", "_sketch_cols", "_sketch_tgt_kind", "_sketch_case_locked")

    def _init_curve_modes(
        self,
        name: str,
        num_classes: Optional[int],
        capacity: Optional[int],
        multilabel: bool,
        exact: bool,
        sketch_capacity: int,
        shape_stable_reads: bool,
    ) -> None:
        if exact and capacity is not None:
            raise ValueError("`exact=True` and `capacity` are mutually exclusive state modes")
        self._exact = bool(exact)
        self._init_capacity_case(capacity, num_classes, multilabel)
        if capacity is None:
            if self._exact:
                register_exact_list_states(self, ("preds", "target"))
                warn_exact_buffer(name)
            else:
                self._init_sketch_curve(sketch_capacity, num_classes, shape_stable_reads=shape_stable_reads)

    def _curve_update(self, preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, int, Optional[int]]:
        raise NotImplementedError

    def _update(self, preds: Tensor, target: Tensor, n_valid: Optional[Any] = None) -> None:
        if self._capacity is not None:
            self._capacity_update(preds, target, pos_label=self.pos_label)
            return
        preds, target, num_classes, pos_label = self._curve_update(preds, target)
        if self._exact:
            self.preds.append(preds)
            self.target.append(target)
        else:
            self._sketch_insert_canonical(preds, target, pos_label if preds.ndim == 1 else 1, n_valid=n_valid)
        self.num_classes = num_classes
        self.pos_label = pos_label

    def _curve_arrays(self) -> Tuple[bool, Tuple[Tensor, Tensor, Any]]:
        """``(True, (preds, target, pos_label))`` for the exact compute, from
        the list states or, inside the lossless window, from the sketch; past
        the window ``(False, (scores, y, w))``, the sketch's weighted rows
        class-major (``[C, n]``, weights expanded) for the one-vs-rest
        kernels. Reads the sketch's fill once."""
        if self._exact:
            return True, (dim_zero_cat(self.preds), dim_zero_cat(self.target), self.pos_label)
        fill, seen = self._sketch_fill_and_seen()
        if self._sketch_reads_exact(fill, seen):
            return True, self._sketch_exact_arrays(fill)
        scores, y, w = self._sketch_weighted_arrays(fill)
        if self._sketch_cols is None:
            return False, (scores, y, w)
        return False, (scores.T, y.T, w[None, :].expand(scores.shape[1], -1))
