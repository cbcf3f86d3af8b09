"""Modular ExplainedVariance.

Counterpart of ``metrics_tpu/regression/explained_variance.py``: five
float32 moment sums, all sum-reduced.
"""
from typing import Any

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.explained_variance import (
    _explained_variance_compute,
    _explained_variance_update,
)

Tensor = torch.Tensor


class ExplainedVariance(Metric):
    """Computes explained variance.

    Example:
        >>> import torch
        >>> target = torch.tensor([3., -0.5, 2., 7.])
        >>> preds = torch.tensor([2.5, 0.0, 2., 8.])
        >>> explained_variance = ExplainedVariance(device="cpu")
        >>> explained_variance(preds, target)
        tensor(0.9572)
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(self, multioutput: str = "uniform_average", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        allowed_multioutput = ("raw_values", "uniform_average", "variance_weighted")
        if multioutput not in allowed_multioutput:
            raise ValueError(
                f"Invalid input to argument `multioutput`. Choose one of the following: {allowed_multioutput}"
            )
        self.multioutput = multioutput
        for name in ("sum_error", "sum_squared_error", "sum_target", "sum_squared_target", "n_obs"):
            self.add_state(name, default=0.0, dist_reduce_fx="sum")

    def _update(self, preds: Tensor, target: Tensor) -> None:
        n_obs, sum_error, sum_squared_error, sum_target, sum_squared_target = _explained_variance_update(preds, target)
        self.n_obs = self.n_obs + n_obs
        self.sum_error = self.sum_error + sum_error
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.sum_target = self.sum_target + sum_target
        self.sum_squared_target = self.sum_squared_target + sum_squared_target

    def _compute(self) -> Tensor:
        return _explained_variance_compute(
            self.n_obs, self.sum_error, self.sum_squared_error, self.sum_target, self.sum_squared_target, self.multioutput
        )
