"""Modular ROC: the sketched streaming default, ``exact=True`` and ``capacity=N``.

Counterpart of ``metrics_tpu/classification/roc.py``, with the state modes
of ``auroc.py``: the quantile sketch by default (bit-equal to
``exact=True`` while the stream fits ``sketch_capacity``, weighted curve
points past it), ``exact=True`` for the unbounded list states, and
``capacity=N`` for the fixed exact buffers, whose ``compute()`` returns the
fixed-shape ``(fpr, tpr, thresholds, point_mask)``.
"""
from typing import Any, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.classification._sketch import DEFAULT_SKETCH_CAPACITY, CurveModesMixin
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.exact_curve import binary_roc_fixed, multiclass_roc_fixed
from metrics_tpu_torch.functional.classification.roc import _roc_compute, _roc_update
from metrics_tpu_torch.functional.classification.sketch_curve import binary_roc_weighted

Tensor = torch.Tensor

class ROC(CurveModesMixin, Metric):
    """Receiver Operating Characteristic curve.

    Example:
        >>> import torch
        >>> pred = torch.tensor([0., 1., 2., 3.])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> roc = ROC(pos_label=1, device="cpu")
        >>> fpr, tpr, thresholds = roc(pred, target)
        >>> fpr
        tensor([0., 0., 0., 0., 1.])
        >>> tpr
        tensor([0.0000, 0.3333, 0.6667, 1.0000, 1.0000])
        >>> thresholds
        tensor([4., 3., 2., 1., 0.])
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
        self._init_curve_modes("ROC", num_classes, capacity, multilabel, exact, sketch_capacity, shape_stable_reads)

    def _curve_update(self, preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, int, Optional[int]]:
        return _roc_update(preds, target, self.num_classes, self.pos_label)

    def _compute(
        self,
    ) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]], Tuple[Tensor, ...]]:
        if self._capacity is not None:
            # fixed shapes: (fpr, tpr, thresholds, point_mask), per class
            # rows for multiclass and multilabel buffers
            if self._capacity_cols is not None:
                return multiclass_roc_fixed(
                    *self._capacity_buffers_2d(), self.num_classes, multilabel=self._capacity_multilabel
                )
            return binary_roc_fixed(*self._capacity_buffers())
        exact, arrays = self._curve_arrays()
        if exact:
            preds, target, pos_label = arrays
            return _roc_compute(preds, target, self.num_classes, pos_label)
        # past the window: weighted points, cut to the exact output's form
        fpr, tpr, thresholds, mask = binary_roc_weighted(*arrays)
        if self._sketch_cols is None:
            return fpr[mask], tpr[mask], thresholds[mask]
        return [f[m] for f, m in zip(fpr, mask)], [t[m] for t, m in zip(tpr, mask)], [h[m] for h, m in zip(thresholds, mask)]
