"""Fixed-capacity exact mode for the curve metric classes.

Counterpart of ``metrics_tpu/classification/_capacity.py``: ``capacity=N``
replaces the unbounded list states with a static buffer triple (preds,
target, valid) plus an overflow tally, in the binary layout (``[N]``
scores, 0/1 targets), the multiclass one (``[N, C]`` score rows with
integer labels) or the multilabel one (``[N, C]`` score rows with ``[N, C]``
0/1 indicators). ``_init_capacity_case`` picks the layout for the curve
classes (``ROC``, ``PrecisionRecallCurve``, ``AveragePrecision``).

Each update reads the batch's label range and the buffer's fill count in
one host read, raises on a label out of range or on overflow, and writes
the batch into the first free slots (a merged or restored buffer may have
holes). The buffers are replaced, not written in place, so the pure-state
API never modifies a state it was given. Under the capture rule of
``utils/checks.py`` (a fused update) the update reads nothing, as the JAX
package's traced update: samples past the capacity drop and count in the
``overflow`` tally, which ``compute`` raises on.
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utils.checks import checks_read_nothing
from metrics_tpu_torch.utils.exceptions import MetricsUserError

Tensor = torch.Tensor


class CapacityCurveMixin:
    """Adds ``capacity`` handling. Call ``_init_capacity`` in ``__init__``
    instead of registering list states; route ``_update``/``_compute`` on
    ``self._capacity is not None``."""

    _capacity: Optional[int] = None
    _capacity_cols: Optional[int] = None
    _capacity_multilabel: bool = False

    def _init_capacity(self, capacity: int, num_cols: Optional[int] = None, multilabel: bool = False) -> None:
        """Register the buffer triple: ``[capacity]`` scores (binary) or
        ``[capacity, num_cols]`` score rows (multiclass); ``multilabel``
        widens the target buffer to ``[capacity, num_cols]`` indicators."""
        if not (isinstance(capacity, int) and capacity > 0):
            raise ValueError(f"Argument `capacity` must be a positive int, got {capacity}")
        if multilabel and num_cols is None:
            raise ValueError("`multilabel` capacity mode requires `num_cols`")
        self._capacity = capacity
        self._capacity_cols = num_cols
        self._capacity_multilabel = multilabel
        device = self.device
        preds_shape = (capacity,) if num_cols is None else (capacity, num_cols)
        target_shape = (capacity, num_cols) if multilabel else (capacity,)
        self.add_state("preds", default=torch.zeros(preds_shape, dtype=torch.float32, device=device), dist_reduce_fx="cat")
        self.add_state("target", default=torch.zeros(target_shape, dtype=torch.int32, device=device), dist_reduce_fx="cat")
        self.add_state("valid", default=torch.zeros((capacity,), dtype=torch.bool, device=device), dist_reduce_fx="cat")
        # samples dropped past capacity; compute raises when it is non-zero
        self.add_state("overflow", default=torch.zeros((), dtype=torch.int32, device=device), dist_reduce_fx="sum")
        # fixed-shape states: the update fuses (an exact=True instance's
        # list states make it jit-unsafe)
        self.__dict__["__jit_unsafe__"] = False

    def _init_capacity_case(self, capacity: Optional[int], num_classes: Optional[int], multilabel: bool) -> None:
        """The curve classes' shared constructor step: binary buffers by
        default, ``[capacity, C]`` rows when ``num_classes >= 2``, indicator
        targets with ``multilabel``. Registers nothing when ``capacity`` is
        None (the caller keeps its sketched or list states)."""
        if capacity is None:
            if multilabel:
                raise ValueError("`multilabel` is a capacity-mode argument; pass `capacity` as well")
            return
        if num_classes is not None and num_classes >= 2:
            self._init_capacity(capacity, num_cols=num_classes, multilabel=multilabel)
        elif multilabel:
            raise ValueError("`multilabel` capacity mode requires `num_classes >= 2`")
        else:
            self._init_capacity(capacity)

    def _capacity_update(self, preds: Tensor, target: Tensor, pos_label: Optional[int] = None) -> None:
        num_cols = self._capacity_cols
        multilabel = self._capacity_multilabel
        if not multilabel:
            target = target.reshape(-1)
        if num_cols is None:
            preds = preds.reshape(-1)
            if preds.shape != target.shape:
                raise ValueError("preds and target must have the same shape in capacity mode")
        else:
            if preds.ndim != 2 or preds.shape[1] != num_cols:
                raise ValueError(
                    f"Expected `preds` of shape [N, {num_cols}] in multiclass capacity mode, got {tuple(preds.shape)}"
                )
            if multilabel and preds.shape != target.shape:
                raise ValueError(
                    f"Expected `target` of shape [N, {num_cols}] in multilabel capacity mode, got {tuple(target.shape)}"
                )
            if preds.shape[0] != target.shape[0]:
                raise ValueError("preds and target must agree on the batch dimension")
        if not preds.is_floating_point():
            raise ValueError("preds must be float scores/probabilities in capacity mode")
        if target.is_floating_point():
            raise ValueError("target must be integer labels in capacity mode")

        n = preds.shape[0]
        count_t = self.valid.sum().to(torch.int64)
        check_range = pos_label is None or num_cols is not None
        if pos_label is not None and num_cols is None:
            target = (target == pos_label).to(torch.int32)
        if checks_read_nothing():
            self._capacity_update_dropping(preds, target, count_t.to(torch.int32))
            return
        if check_range and target.numel():
            tmin, tmax, count = torch.stack([target.min().to(torch.int64), target.max().to(torch.int64), count_t]).tolist()
            upper = 1 if (num_cols is None or multilabel) else num_cols - 1
            if tmin < 0 or tmax > upper:
                hint = (
                    "target must be binary (0/1); pass `pos_label` to select the positive class"
                    if num_cols is None
                    else ("multilabel indicators must be 0/1" if multilabel else f"labels must be in [0, {upper}]")
                )
                raise ValueError(f"target out of range in capacity mode; {hint}")
        else:
            count = int(count_t)
        if count + n > self._capacity:
            raise MetricsUserError(
                f"Exact-curve capacity overflow: buffer holds {count} of"
                f" {self._capacity} samples and the batch adds {n}."
                " Construct the metric with a larger `capacity`."
            )
        # the first n free slots, in index order (a stable sort puts the
        # free slots, False, first)
        idx = torch.argsort(self.valid.to(torch.uint8), stable=True)[:n]
        # float32 scores, then the buffer's dtype (another after set_dtype)
        self.preds = self.preds.index_copy(0, idx, preds.to(torch.float32).to(self.preds.dtype))
        self.target = self.target.index_copy(0, idx, target.to(torch.int32))
        self.valid = self.valid.index_fill(0, idx, True)

    def _capacity_update_dropping(self, preds: Tensor, target: Tensor, count: Tensor) -> None:
        """The update without a host read: the batch fills the first free
        slots (a permutation, so no slot twice); a sample whose slot is
        already occupied is dropped, as by the JAX package's ``mode="drop"``
        scatter (it writes the slot's own value back), and counts in
        ``overflow``."""
        cap, b = self._capacity, preds.shape[0]
        n = min(b, cap)
        idx = torch.argsort(self.valid.to(torch.uint8), stable=True)[:n]
        taken = self.valid[idx]

        def write(buf: Tensor, rows: Tensor) -> Tensor:
            keep = taken.reshape((n,) + (1,) * (buf.ndim - 1))
            return buf.index_copy(0, idx, torch.where(keep, buf[idx], rows[:n].to(buf.dtype)))

        self.preds = write(self.preds, preds)
        self.target = write(self.target, target)
        self.valid = self.valid.index_fill(0, idx, True)
        self.overflow = self.overflow + torch.clamp(count + b - cap, min=0).to(torch.int32)

    def _capacity_guard(self) -> Tensor:
        """Overflow-checked flat valid mask: a non-zero overflow tally raises."""
        overflow = int(self.overflow.sum())
        if overflow > 0:
            raise MetricsUserError(
                f"Exact-curve capacity overflow: {overflow} sample(s) were dropped beyond"
                f" the declared capacity ({self._capacity}). Construct the metric with a larger `capacity`."
            )
        return self.valid.reshape(-1)

    def _capacity_buffers(self) -> Tuple[Tensor, Tensor, Tensor]:
        """Flat (preds, target, valid) for the binary kernels."""
        valid = self._capacity_guard()
        return self.preds.reshape(-1), self.target.reshape(-1), valid

    def _capacity_buffers_2d(self) -> Tuple[Tensor, Tensor, Tensor]:
        """Row-flattened (preds ``[N, C]``, target, valid) for the multiclass
        and multilabel kernels."""
        num_cols = self._capacity_cols
        valid = self._capacity_guard()
        target = self.target.reshape(-1, num_cols) if self._capacity_multilabel else self.target.reshape(-1)
        return self.preds.reshape(-1, num_cols), target, valid
