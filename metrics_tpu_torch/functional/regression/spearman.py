"""Spearman rank correlation.

Counterpart of ``metrics_tpu/functional/regression/spearman.py``. Ranks
are tie-averaged from sorted runs: after one stable sort, a run of equal
values from sorted position ``s`` to ``e`` ranks ``(s + e) / 2 + 1``, taken
in float64 and rounded once to the data's dtype (the JAX package sums each
run's float32 ranks by segment, which equals this where the ranks are
exact; past 2**24 values it can differ in the last bit). The means are
fixed-order sums (``_tree_sum``), so the card and the CPU give the same
bits.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape, _same_dtype_x64_off
from metrics_tpu_torch.utils.data import _tie_runs, _tree_sum

Tensor = torch.Tensor


def _rank_data(data: Tensor) -> Tensor:
    """Ranks (1-based) of a 1-D tensor; ties get the mean of their ranks."""
    sorted_x, order = torch.sort(data, stable=True)
    start, end = _tie_runs(sorted_x)
    mean_rank = ((start + end).to(torch.float64) / 2 + 1).to(data.dtype)
    return torch.zeros_like(data).scatter(0, order, mean_rank)


def _spearman_corrcoef_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    preds, target = _same_dtype_x64_off(preds, target)
    _check_same_shape(preds, target)
    preds = torch.squeeze(preds)
    target = torch.squeeze(target)
    if preds.ndim > 1 or target.ndim > 1:
        raise ValueError("Expected both predictions and target to be 1 dimensional tensors.")
    return preds, target


def _mean(x: Tensor) -> Tensor:
    return _tree_sum(x.reshape(-1)) / x.numel()


def _spearman_corrcoef_compute(preds: Tensor, target: Tensor, eps: float = 1e-6) -> Tensor:
    rank_preds = _rank_data(preds.reshape(-1))
    rank_target = _rank_data(target.reshape(-1))

    preds_diff = rank_preds - _mean(rank_preds)
    target_diff = rank_target - _mean(rank_target)

    cov = _mean(preds_diff * target_diff)
    preds_std = torch.sqrt(_mean(preds_diff * preds_diff))
    target_std = torch.sqrt(_mean(target_diff * target_diff))

    corrcoef = cov / (preds_std * target_std + eps)
    return torch.clamp(corrcoef, -1.0, 1.0)


def spearman_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Computes the Spearman rank correlation coefficient.

    Example:
        >>> import torch
        >>> target = torch.tensor([3., -0.5, 2., 7.])
        >>> preds = torch.tensor([2.5, 0.0, 2., 8.])
        >>> spearman_corrcoef(preds, target)
        tensor(1.0000)
    """
    preds, target = _spearman_corrcoef_update(preds, target)
    return _spearman_corrcoef_compute(preds, target)
