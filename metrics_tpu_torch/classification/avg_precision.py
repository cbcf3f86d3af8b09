"""Modular AveragePrecision: the sketched default, ``exact=True`` and ``capacity=N``.

Counterpart of ``metrics_tpu/classification/avg_precision.py``, with the
state modes of ``roc.py``. Inside the sketch's lossless window the value
is bit-equal to ``exact=True``; past it the weighted step sum runs over
the sketch's rows.
"""
from typing import Any, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.classification._sketch import DEFAULT_SKETCH_CAPACITY, CurveModesMixin
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.average_precision import (
    _average_precision_compute,
    _average_precision_update,
)
from metrics_tpu_torch.functional.classification.exact_curve import (
    binary_average_precision_fixed,
    multiclass_average_precision_fixed,
)
from metrics_tpu_torch.functional.classification.sketch_curve import (
    average_class_scores,
    binary_average_precision_weighted,
    weighted_class_supports,
)

Tensor = torch.Tensor


class AveragePrecision(CurveModesMixin, Metric):
    """Average precision score.

    Example:
        >>> import torch
        >>> pred = torch.tensor([0., 1., 2., 3.])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> average_precision = AveragePrecision(pos_label=1, device="cpu")
        >>> average_precision(pred, target)
        tensor(1.)
        >>> pred = torch.tensor([[0.75, 0.05, 0.05, 0.05], [0.05, 0.75, 0.05, 0.05],
        ...                      [0.05, 0.05, 0.75, 0.05], [0.05, 0.05, 0.05, 0.75]])
        >>> target = torch.tensor([0, 1, 3, 2])
        >>> average_precision = AveragePrecision(num_classes=4, capacity=16, device="cpu")
        >>> average_precision.update(pred, target)
        >>> average_precision.compute()
        tensor(0.6250)
    """

    is_differentiable = False
    higher_is_better = True
    __jit_unsafe__ = False  # sketch default: fixed-shape update, fusible
    #: the static analysis classifies the default mode: branches on
    #: ``self._exact`` belong to the opt-in exact (list-state) mode
    __exact_mode_attr__ = "_exact"
    __fused_mask_valid__ = True  # bucketed pads mask out via n_valid

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        average: Optional[str] = "macro",
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
        allowed_average = ("micro", "macro", "weighted", "none", None)
        if average not in allowed_average:
            raise ValueError(f"Expected argument `average` to be one of {allowed_average} but got {average}")
        self.average = average
        if capacity is not None and num_classes is not None and num_classes >= 2 and not multilabel and average == "micro":
            # as the unbounded path raises for micro on multiclass input
            raise ValueError("Cannot use `micro` average with multi-class input")
        self._init_curve_modes(
            "AveragePrecision", num_classes, capacity, multilabel, exact, sketch_capacity, shape_stable_reads
        )

    def _curve_update(self, preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, int, Optional[int]]:
        return _average_precision_update(preds, target, self.num_classes, self.pos_label, self.average)

    def _compute(self) -> Union[Tensor, List[Tensor]]:
        if self._capacity is not None:
            if self._capacity_cols is not None:
                return multiclass_average_precision_fixed(
                    *self._capacity_buffers_2d(),
                    self.num_classes,
                    average="none" if self.average is None else self.average,
                    multilabel=self._capacity_multilabel,
                )
            return binary_average_precision_fixed(*self._capacity_buffers())
        exact, arrays = self._curve_arrays()
        if exact:
            preds, target, pos_label = arrays
            return _average_precision_compute(preds, target, self.num_classes, pos_label, self.average)
        scores, y, w = arrays
        if self._sketch_cols is None:
            return binary_average_precision_weighted(scores, y, w)
        if self.average == "micro":
            # flattened row by row, as the JAX package flattens its [n, C] rows
            return binary_average_precision_weighted(scores.T.reshape(-1), y.T.reshape(-1), w.T.reshape(-1))
        per_class = binary_average_precision_weighted(scores, y, w)
        return average_class_scores(per_class, weighted_class_supports(y.T, w[0]), self.average)
