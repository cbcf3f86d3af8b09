"""Modular MeanSquaredLogError.

Counterpart of ``metrics_tpu/regression/log_mse.py``: a float32 sum and a
count, both sum-reduced, so the metric slices (``SlicedMetric``) and
windows (``WindowedMetric``).
"""
from typing import Any

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.log_mse import _mean_squared_log_error_compute, _mean_squared_log_error_update

Tensor = torch.Tensor


class MeanSquaredLogError(Metric):
    """Computes mean squared log error.

    Example:
        >>> import torch
        >>> target = torch.tensor([2.5, 5.0, 4.0, 8.0])
        >>> preds = torch.tensor([3.0, 5.0, 2.5, 7.0])
        >>> metric = MeanSquaredLogError(device="cpu")
        >>> metric(preds, target)
        tensor(0.0397)
    """

    is_differentiable = True
    higher_is_better = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_squared_log_error", default=0.0, dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")

    def _update(self, preds: Tensor, target: Tensor) -> None:
        value, n_obs = _mean_squared_log_error_update(preds, target)
        self.sum_squared_log_error = self.sum_squared_log_error + value
        self.total = self.total + n_obs

    def _compute(self) -> Tensor:
        return _mean_squared_log_error_compute(self.sum_squared_log_error, self.total)
