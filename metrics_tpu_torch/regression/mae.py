"""Modular MeanAbsoluteError.

Counterpart of ``metrics_tpu/regression/mae.py``: a float32 sum and a
count, both sum-reduced, so the metric slices (``SlicedMetric``) and
windows (``WindowedMetric``).
"""
from typing import Any

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.mae import _mean_absolute_error_compute, _mean_absolute_error_update

Tensor = torch.Tensor


class MeanAbsoluteError(Metric):
    """Computes mean absolute error.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> metric = MeanAbsoluteError(device="cpu")
        >>> metric(preds, target)
        tensor(0.5000)
    """

    is_differentiable = True
    higher_is_better = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_error", default=0.0, dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")

    def _update(self, preds: Tensor, target: Tensor) -> None:
        value, n_obs = _mean_absolute_error_update(preds, target)
        self.sum_abs_error = self.sum_abs_error + value
        self.total = self.total + n_obs

    def _compute(self) -> Tensor:
        return _mean_absolute_error_compute(self.sum_abs_error, self.total)
