"""Modular AUROC: the sketched streaming default and the capacity modes.

Counterpart of ``metrics_tpu/classification/auroc.py``, with the same state
modes, mode locking and errors:

* **default**: the quantile-sketch streaming state
  (``classification/_sketch.py``): O(``sketch_capacity``) memory and a
  ``merge`` reducer. Exact for every stream that fits the capacity (the
  lossless window); past it, weighted kernels within the sketch's
  rank-error bound. Once the stream may overflow, every update compacts on
  the card (the sort/bucket and segment-sum kernels).
* ``exact=True``: the reference's unbounded list states (and its
  memory-footprint warning), computed by the exact curve on ``compute()``.
* ``capacity=N``: fixed exact buffers, binary (``[N]`` scores) or, with
  ``num_classes >= 2``, ``[N, C]`` score rows and the masked rank AUROC.
"""
from typing import Any, Mapping, Optional

import torch

from metrics_tpu_torch.classification._capacity import CapacityCurveMixin
from metrics_tpu_torch.classification._sketch import DEFAULT_SKETCH_CAPACITY, SketchCurveMixin
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.auroc import (
    _auroc_compute,
    _auroc_update,
    auroc_rank_multiclass_masked,
)
from metrics_tpu_torch.functional.classification.exact_curve import binary_auroc_fixed
from metrics_tpu_torch.functional.classification.sketch_curve import (
    average_class_scores,
    binary_auroc_max_fpr_weighted,
    binary_auroc_weighted,
    weighted_class_supports,
)
from metrics_tpu_torch.sketches.compat import register_exact_list_states, warn_exact_buffer
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.enums import AverageMethod, DataType

Tensor = torch.Tensor


class AUROC(SketchCurveMixin, CapacityCurveMixin, Metric):
    """Area under the ROC curve.

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.13, 0.26, 0.08, 0.19, 0.34])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> auroc = AUROC(pos_label=1, device="cpu")
        >>> auroc(preds, target)
        tensor(0.5000)
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.2, 0.5, 0.3], [0.1, 0.2, 0.7], [0.3, 0.4, 0.3]])
        >>> target = torch.tensor([0, 1, 2, 1])
        >>> auroc = AUROC(num_classes=3, capacity=8, device="cpu")
        >>> auroc.update(preds, target)
        >>> auroc.compute()
        tensor(1.)
    """

    is_differentiable = False
    higher_is_better = True
    _host_state = ("mode", "_sketch_cols", "_sketch_tgt_kind", "_sketch_case_locked")

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        average: Optional[str] = "macro",
        max_fpr: Optional[float] = None,
        capacity: Optional[int] = None,
        exact: bool = False,
        sketch_capacity: int = DEFAULT_SKETCH_CAPACITY,
        shape_stable_reads: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.pos_label = pos_label
        self.average = average
        self.max_fpr = max_fpr

        allowed_average = (None, AverageMethod.MACRO, AverageMethod.WEIGHTED, AverageMethod.MICRO, AverageMethod.NONE)
        if average not in allowed_average:
            raise ValueError(
                f"Argument `average` expected to be one of the following: {allowed_average} but got {average}"
            )
        if max_fpr is not None and (not isinstance(max_fpr, float) or not 0 < max_fpr <= 1):
            raise ValueError(f"`max_fpr` should be a float in range (0, 1], got: {max_fpr}")
        if exact and capacity is not None:
            raise ValueError("`exact=True` and `capacity` are mutually exclusive state modes")

        self.mode: Optional[DataType] = None
        self._exact = bool(exact)
        self._multiclass_capacity = False
        if capacity is not None:
            if max_fpr is not None:
                raise ValueError("`capacity` mode does not support `max_fpr`")
            if num_classes is not None and num_classes >= 2:
                if average == AverageMethod.MICRO:
                    raise ValueError(
                        "`capacity` multiclass mode supports average in ('macro', 'weighted', 'none'); 'micro' is"
                        " not defined for the one-vs-rest rank kernel"
                    )
                self._init_capacity(capacity, num_cols=num_classes)
                self._multiclass_capacity = True
            else:
                self._init_capacity(capacity)
        elif self._exact:
            register_exact_list_states(self, ("preds", "target"))
            warn_exact_buffer("AUROC")
        else:
            self._init_sketch_curve(sketch_capacity, num_classes, shape_stable_reads=shape_stable_reads)

    def _set_host_state(self, values: Mapping[str, Any]) -> None:
        values = dict(values)
        if values.get("mode") is not None:
            values["mode"] = DataType(values["mode"])
        super()._set_host_state(values)

    def _update(self, preds: Tensor, target: Tensor, n_valid: Optional[Any] = None) -> None:
        if self._capacity is not None:
            self._capacity_update(preds, target, pos_label=None if self._multiclass_capacity else self.pos_label)
            return
        preds, target, mode = _auroc_update(preds, target)
        if self.mode and self.mode != mode:
            raise ValueError(
                "The mode of data (binary, multi-label, multi-class) should be constant, but changed"
                f" between batches from {self.mode} to {mode}"
            )
        if self._exact:
            self.preds.append(preds)
            self.target.append(target)
        else:
            self._sketch_insert_canonical(
                preds, target, self.pos_label if mode == DataType.BINARY else 1, n_valid=n_valid
            )
        self.mode = mode

    def _compute(self) -> Tensor:
        if self._capacity is not None:
            if self._multiclass_capacity:
                preds, target, valid = self._capacity_buffers_2d()
                return auroc_rank_multiclass_masked(preds, target, valid, self.num_classes, average=self.average)
            return binary_auroc_fixed(*self._capacity_buffers())
        if not self.mode:
            raise RuntimeError("You have to have determined mode.")
        if self._exact:
            preds, target = dim_zero_cat(self.preds), dim_zero_cat(self.target)
            return _auroc_compute(preds, target, self.mode, self.num_classes, self.pos_label, self.average, self.max_fpr)
        fill, seen = self._sketch_fill_and_seen()
        if self._sketch_reads_exact(fill, seen):
            preds, target, pos_label = self._sketch_exact_arrays(fill)
            return _auroc_compute(preds, target, self.mode, self.num_classes, pos_label, self.average, self.max_fpr)
        return self._sketch_approx_compute(fill)

    def _sketch_approx_compute(self, fill: int) -> Tensor:
        """Weighted AUROC from the (bucket-padded) sketch rows, past the
        lossless window or on every read under ``shape_stable_reads``."""
        scores, y, w = self._sketch_weighted_arrays(fill)
        if self.max_fpr is not None and self.mode != DataType.BINARY:
            # the exact path raises this inside _auroc_compute; the
            # misconfiguration stays loud past the window too
            raise ValueError(
                "Partial AUC computation not available in multilabel/multiclass setting,"
                f" 'max_fpr' must be set to `None`, received `{self.max_fpr}`."
            )
        if self.mode == DataType.BINARY:
            if self.max_fpr is not None and self.max_fpr < 1:
                return binary_auroc_max_fpr_weighted(scores, y, w, self.max_fpr)
            return binary_auroc_weighted(scores, y, w)
        if self.mode == DataType.MULTILABEL and self.average == AverageMethod.MICRO:
            flat_w = w[:, None].expand(y.shape).reshape(-1)
            return binary_auroc_weighted(scores.reshape(-1), y.reshape(-1), flat_w)
        per_class = binary_auroc_weighted(scores.T, y.T, w[None, :].expand(y.shape[1], -1))
        supports = weighted_class_supports(y, w)
        average = None if self.average == AverageMethod.NONE else self.average
        return average_class_scores(per_class, supports, average)
