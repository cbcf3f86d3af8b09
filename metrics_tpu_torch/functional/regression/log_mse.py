"""Mean squared log error.

Counterpart of ``metrics_tpu/functional/regression/log_mse.py``. The
squared log differences are summed in a fixed order (``_tree_sum``);
half-precision inputs are widened to float32 first.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import _tree_sum, _widen_half

Tensor = torch.Tensor


def _mean_squared_log_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    diff = torch.log1p(_widen_half(preds)) - torch.log1p(_widen_half(target))
    return _tree_sum((diff * diff).reshape(-1)), target.numel()


def _mean_squared_log_error_compute(sum_squared_log_error: Tensor, n_obs: Tensor) -> Tensor:
    return sum_squared_log_error / n_obs


def mean_squared_log_error(preds: Tensor, target: Tensor) -> Tensor:
    """Computes mean squared log error.

    Example:
        >>> import torch
        >>> x = torch.tensor([0., 1., 2., 3.])
        >>> y = torch.tensor([0., 1., 2., 2.])
        >>> mean_squared_log_error(x, y)
        tensor(0.0207)
    """
    sum_squared_log_error, n_obs = _mean_squared_log_error_update(preds, target)
    return _mean_squared_log_error_compute(sum_squared_log_error, n_obs)
