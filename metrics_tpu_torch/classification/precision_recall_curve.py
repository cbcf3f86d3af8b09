"""Modular PrecisionRecallCurve: the sketched default, ``exact=True`` and ``capacity=N``.

Counterpart of ``metrics_tpu/classification/precision_recall_curve.py``,
with the state modes of ``roc.py``. The capacity mode's ``compute()``
returns the fixed-shape ``(precision, recall, thresholds, point_mask,
last_point)`` of ``exact_curve.binary_precision_recall_curve_fixed``.
"""
from typing import Any, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.classification._sketch import DEFAULT_SKETCH_CAPACITY, CurveModesMixin
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.exact_curve import (
    binary_precision_recall_curve_fixed,
    multiclass_precision_recall_curve_fixed,
)
from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    _precision_recall_curve_compute,
    _precision_recall_curve_update,
)
from metrics_tpu_torch.functional.classification.sketch_curve import binary_prc_weighted

Tensor = torch.Tensor


class PrecisionRecallCurve(CurveModesMixin, Metric):
    """Precision-recall pairs at every distinct threshold.

    Example:
        >>> import torch
        >>> pred = torch.tensor([0., 1., 2., 3.])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> pr_curve = PrecisionRecallCurve(pos_label=1, device="cpu")
        >>> precision, recall, thresholds = pr_curve(pred, target)
        >>> precision
        tensor([0.6667, 0.5000, 0.0000, 1.0000])
        >>> recall
        tensor([1.0000, 0.5000, 0.0000, 0.0000])
        >>> thresholds
        tensor([1., 2., 3.])
    """

    is_differentiable = False

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        capacity: Optional[int] = None,
        multilabel: bool = False,
        exact: bool = False,
        sketch_capacity: int = DEFAULT_SKETCH_CAPACITY,
        shape_stable_reads: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.pos_label = pos_label
        self._init_curve_modes(
            "PrecisionRecallCurve", num_classes, capacity, multilabel, exact, sketch_capacity, shape_stable_reads
        )

    def _curve_update(self, preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, int, Optional[int]]:
        return _precision_recall_curve_update(preds, target, self.num_classes, self.pos_label)

    def _compute(
        self,
    ) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]], Tuple[Tensor, ...]]:
        if self._capacity is not None:
            if self._capacity_cols is not None:
                return multiclass_precision_recall_curve_fixed(
                    *self._capacity_buffers_2d(), self.num_classes, multilabel=self._capacity_multilabel
                )
            return binary_precision_recall_curve_fixed(*self._capacity_buffers())
        exact, arrays = self._curve_arrays()
        if exact:
            preds, target, pos_label = arrays
            return _precision_recall_curve_compute(preds, target, self.num_classes, pos_label)
        # past the window: weighted points, reversed and closed with (1, 0)
        # as the exact curve is
        precision, recall, thresholds, mask = binary_prc_weighted(*arrays)
        if self._sketch_cols is None:
            return _close_curve(precision, recall, thresholds, mask)
        curves = [_close_curve(p, r, t, m) for p, r, t, m in zip(precision, recall, thresholds, mask)]
        return [c[0] for c in curves], [c[1] for c in curves], [c[2] for c in curves]


def _close_curve(precision: Tensor, recall: Tensor, thresholds: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    return (
        torch.cat([precision[mask].flip(0), precision.new_ones(1)]),
        torch.cat([recall[mask].flip(0), recall.new_zeros(1)]),
        thresholds[mask].flip(0),
    )
