"""Modular MeanAbsolutePercentageError.

Counterpart of ``metrics_tpu/regression/mape.py``: a float32 sum and a float32
count, both sum-reduced, so the metric slices (``SlicedMetric``) and
windows (``WindowedMetric``).
"""
from typing import Any

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.mape import _mean_absolute_percentage_error_compute, _mean_absolute_percentage_error_update

Tensor = torch.Tensor


class MeanAbsolutePercentageError(Metric):
    """Computes mean absolute percentage error.

    Example:
        >>> import torch
        >>> target = torch.tensor([1., 10., 1e6])
        >>> preds = torch.tensor([0.9, 15., 1.2e6])
        >>> metric = MeanAbsolutePercentageError(device="cpu")
        >>> metric(preds, target)
        tensor(0.2667)
    """

    is_differentiable = True
    higher_is_better = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_per_error", default=0.0, dist_reduce_fx="sum")
        self.add_state("total", default=0.0, dist_reduce_fx="sum")

    def _update(self, preds: Tensor, target: Tensor) -> None:
        value, n_obs = _mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_per_error = self.sum_abs_per_error + value
        self.total = self.total + n_obs

    def _compute(self) -> Tensor:
        return _mean_absolute_percentage_error_compute(self.sum_abs_per_error, self.total)
