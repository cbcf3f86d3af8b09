"""Modular MeanSquaredError.

Counterpart of ``metrics_tpu/regression/mse.py``: a float32 sum of squared
error and an int32 count, both sum-reduced, so the metric slices
(``SlicedMetric``) and windows (``WindowedMetric``).
"""
from typing import Any

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.mse import _mean_squared_error_compute, _mean_squared_error_update

Tensor = torch.Tensor


class MeanSquaredError(Metric):
    """Computes mean squared error (or RMSE with ``squared=False``).

    Example:
        >>> import torch
        >>> target = torch.tensor([2.5, 5.0, 4.0, 8.0])
        >>> preds = torch.tensor([3.0, 5.0, 2.5, 7.0])
        >>> mean_squared_error = MeanSquaredError(device="cpu")
        >>> mean_squared_error(preds, target)
        tensor(0.8750)
    """

    is_differentiable = True
    higher_is_better = False

    def __init__(self, squared: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_squared_error", default=0.0, dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")
        self.squared = squared

    def _update(self, preds: Tensor, target: Tensor) -> None:
        sum_squared_error, n_obs = _mean_squared_error_update(preds, target)
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.total = self.total + n_obs

    def _compute(self) -> Tensor:
        return _mean_squared_error_compute(self.sum_squared_error, self.total, squared=self.squared)
