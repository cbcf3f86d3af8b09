"""Symmetric mean absolute percentage error.

Counterpart of ``metrics_tpu/functional/regression/symmetric_mape.py``
(epsilon = 1.17e-06). Sums are fixed-order (``_tree_sum``); half-precision
inputs are widened to float32 first.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import _tree_sum, _widen_half, _x64_off

Tensor = torch.Tensor


def _symmetric_mean_absolute_percentage_error_update(
    preds: Tensor, target: Tensor, epsilon: float = 1.17e-06
) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    preds, target = _widen_half(_x64_off(preds)), _widen_half(_x64_off(target))
    abs_per_error = torch.abs(preds - target) / torch.clamp(torch.abs(target) + torch.abs(preds), min=epsilon)
    return 2 * _tree_sum(abs_per_error.reshape(-1)), target.numel()


def _symmetric_mean_absolute_percentage_error_compute(sum_abs_per_error: Tensor, num_obs: Tensor) -> Tensor:
    return sum_abs_per_error / num_obs


def symmetric_mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """Computes symmetric mean absolute percentage error.

    Example:
        >>> import torch
        >>> target = torch.tensor([1., 10., 1e6])
        >>> preds = torch.tensor([0.9, 15., 1.2e6])
        >>> symmetric_mean_absolute_percentage_error(preds, target)
        tensor(0.2290)
    """
    sum_abs_per_error, num_obs = _symmetric_mean_absolute_percentage_error_update(preds, target)
    return _symmetric_mean_absolute_percentage_error_compute(sum_abs_per_error, num_obs)
