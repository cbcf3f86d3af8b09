"""R² (coefficient of determination).

Counterpart of ``metrics_tpu/functional/regression/r2.py``, with the
reference's ``adjusted`` fall-back warnings. The sums along the first axis
are fixed-order (``_tree_sum``); half-precision inputs are widened to
float32 first. The compute reads the observation count with one host read
(its ``n_obs < 2`` error and the ``adjusted`` fall-backs), and reads
nothing under the capture rule of ``utils/checks.py``, where the
fall-backs are selects, as the JAX package's traced form.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape, checks_read_nothing
from metrics_tpu_torch.utils.data import _tree_sum, _widen_half
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _r2_score_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    _check_same_shape(preds, target)
    if preds.ndim > 2:
        raise ValueError(
            "Expected both prediction and target to be 1D or 2D tensors,"
            f" but received tensors with dimension {preds.shape}"
        )
    preds, target = _widen_half(preds), _widen_half(target)
    residual = target - preds
    sums = _tree_sum(torch.stack([target, target * target, residual * residual]).movedim(1, -1))
    n_obs = torch.full((), target.shape[0], dtype=torch.int32, device=target.device)
    return sums[1], sums[0], sums[2], n_obs


def _r2_score_compute(
    sum_squared_obs: Tensor,
    sum_obs: Tensor,
    rss: Tensor,
    n_obs: Tensor,
    adjusted: int = 0,
    multioutput: str = "uniform_average",
) -> Tensor:
    n = None if checks_read_nothing() else int(n_obs)
    if n is not None and n < 2:
        raise ValueError("Needs at least two samples to calculate r2 score.")

    mean_obs = sum_obs / n_obs
    tss = sum_squared_obs - sum_obs * mean_obs
    raw_scores = 1 - (rss / tss)

    if multioutput == "raw_values":
        r2 = raw_scores
    elif multioutput == "uniform_average":
        r2 = torch.mean(raw_scores)
    elif multioutput == "variance_weighted":
        r2 = torch.sum(tss / torch.sum(tss) * raw_scores)
    else:
        raise ValueError(
            "Argument `multioutput` must be either `raw_values`,"
            f" `uniform_average` or `variance_weighted`. Received {multioutput}."
        )

    if adjusted < 0 or not isinstance(adjusted, int):
        raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")

    if adjusted != 0:
        if n is None:
            adj = 1 - (1 - r2) * (n_obs - 1) / (n_obs - adjusted - 1)
            r2 = torch.where(adjusted >= n_obs - 1, r2, adj)
        elif adjusted > n - 1:
            rank_zero_warn(
                "More independent regressions than data points in"
                " adjusted r2 score. Falls back to standard r2 score.",
                UserWarning,
            )
        elif adjusted == n - 1:
            rank_zero_warn("Division by zero in adjusted r2 score. Falls back to standard r2 score.", UserWarning)
        else:
            r2 = 1 - (1 - r2) * (n_obs - 1) / (n_obs - adjusted - 1)
    return r2


def r2_score(preds: Tensor, target: Tensor, adjusted: int = 0, multioutput: str = "uniform_average") -> Tensor:
    """Computes the R² score.

    Example:
        >>> import torch
        >>> target = torch.tensor([3., -0.5, 2., 7.])
        >>> preds = torch.tensor([2.5, 0.0, 2., 8.])
        >>> r2_score(preds, target)
        tensor(0.9486)
    """
    sum_squared_obs, sum_obs, rss, n_obs = _r2_score_update(preds, target)
    return _r2_score_compute(sum_squared_obs, sum_obs, rss, n_obs, adjusted, multioutput)
