"""Explained variance.

Counterpart of ``metrics_tpu/functional/regression/explained_variance.py``:
four moment sums along the first axis (fixed-order, ``_tree_sum``) and
the reference's score with its zero-numerator and zero-denominator cases
as selects. Half-precision inputs are widened to float32 first.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import _tree_sum, _widen_half, _x64_off

Tensor = torch.Tensor


def _sum0(x: Tensor) -> Tensor:
    """Fixed-order sum along the first axis."""
    return _tree_sum(x.movedim(0, -1))


def _explained_variance_update(preds: Tensor, target: Tensor) -> Tuple[int, Tensor, Tensor, Tensor, Tensor]:
    _check_same_shape(preds, target)
    preds, target = _widen_half(_x64_off(preds)), _widen_half(_x64_off(target))
    n_obs = preds.shape[0]
    diff = target - preds
    return n_obs, _sum0(diff), _sum0(diff * diff), _sum0(target), _sum0(target * target)


def _explained_variance_compute(
    n_obs: Tensor,
    sum_error: Tensor,
    sum_squared_error: Tensor,
    sum_target: Tensor,
    sum_squared_target: Tensor,
    multioutput: str = "uniform_average",
) -> Tensor:
    diff_avg = sum_error / n_obs
    numerator = sum_squared_error / n_obs - diff_avg * diff_avg
    target_avg = sum_target / n_obs
    denominator = sum_squared_target / n_obs - target_avg * target_avg

    nonzero_numerator = numerator != 0
    nonzero_denominator = denominator != 0
    valid_score = nonzero_numerator & nonzero_denominator
    safe_denominator = torch.where(valid_score, denominator, 1.0)
    output_scores = torch.ones_like(diff_avg)
    output_scores = torch.where(valid_score, 1.0 - numerator / safe_denominator, output_scores)
    output_scores = torch.where(nonzero_numerator & ~nonzero_denominator, 0.0, output_scores)

    if multioutput == "raw_values":
        return output_scores
    if multioutput == "uniform_average":
        return torch.mean(output_scores)
    if multioutput == "variance_weighted":
        return torch.sum(denominator / torch.sum(denominator) * output_scores)
    raise ValueError(
        "Argument `multioutput` must be either `raw_values`,"
        f" `uniform_average` or `variance_weighted`. Received {multioutput}."
    )


def explained_variance(preds: Tensor, target: Tensor, multioutput: str = "uniform_average") -> Tensor:
    """Computes explained variance.

    Example:
        >>> import torch
        >>> target = torch.tensor([3., -0.5, 2., 7.])
        >>> preds = torch.tensor([2.5, 0.0, 2., 8.])
        >>> explained_variance(preds, target)
        tensor(0.9572)
    """
    n_obs, sum_error, sum_squared_error, sum_target, sum_squared_target = _explained_variance_update(preds, target)
    return _explained_variance_compute(n_obs, sum_error, sum_squared_error, sum_target, sum_squared_target, multioutput)
