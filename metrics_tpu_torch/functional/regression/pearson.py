"""Pearson correlation coefficient: streaming moment accumulators.

Counterpart of ``metrics_tpu/functional/regression/pearson.py``: the
streaming (mean, centred sums) update, the clipped compute, and the exact
parallel merge of two processes' moments (``_final_aggregation``, Chan et
al.). Sums are fixed-order (``_tree_sum``); half-precision inputs are
widened to float32 first.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import _tree_sum, _widen_half

Tensor = torch.Tensor


def _pearson_corrcoef_update(
    preds: Tensor,
    target: Tensor,
    mean_x: Tensor,
    mean_y: Tensor,
    var_x: Tensor,
    var_y: Tensor,
    corr_xy: Tensor,
    n_prior: Tensor,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Streaming update of the six moment accumulators."""
    _check_same_shape(preds, target)
    preds = _widen_half(preds).squeeze()
    target = _widen_half(target).squeeze()
    if preds.ndim > 1 or target.ndim > 1:
        raise ValueError("Expected both predictions and target to be 1 dimensional tensors.")
    preds, target = preds.reshape(-1), target.reshape(-1)
    n_obs = preds.numel()
    mx_new = (n_prior * mean_x + _tree_sum(preds) / n_obs * n_obs) / (n_prior + n_obs)
    my_new = (n_prior * mean_y + _tree_sum(target) / n_obs * n_obs) / (n_prior + n_obs)
    n_new = n_prior + n_obs
    sums = _tree_sum(torch.stack([(preds - mx_new) * (preds - mean_x), (target - my_new) * (target - mean_y), (preds - mx_new) * (target - mean_y)]))
    return mx_new, my_new, var_x + sums[0], var_y + sums[1], corr_xy + sums[2], n_new


def _pearson_corrcoef_compute(var_x: Tensor, var_y: Tensor, corr_xy: Tensor, nb: Tensor) -> Tensor:
    var_x = var_x / (nb - 1)
    var_y = var_y / (nb - 1)
    corr_xy = corr_xy / (nb - 1)
    corrcoef = torch.squeeze(corr_xy / torch.sqrt(var_x * var_y))
    return torch.clamp(corrcoef, -1.0, 1.0)


def _final_aggregation(
    means_x: Tensor, means_y: Tensor, vars_x: Tensor, vars_y: Tensor, corrs_xy: Tensor, nbs: Tensor
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Merge stacked per-process moment accumulators (leading axis) with the
    parallel variance and covariance formula, as the JAX package does:

        S = S1 + S2 + n1*n2/(n1+n2) * (m1 - m2)^2           (variance sums)
        C = C1 + C2 + n1*n2/(n1+n2) * (mx1-mx2)*(my1-my2)   (covariance sum)
    """
    mx1, my1, vx1, vy1, cxy1, n1 = means_x[0], means_y[0], vars_x[0], vars_y[0], corrs_xy[0], nbs[0]
    for i in range(1, means_x.shape[0]):
        mx2, my2, vx2, vy2, cxy2, n2 = means_x[i], means_y[i], vars_x[i], vars_y[i], corrs_xy[i], nbs[i]
        nb = n1 + n2
        mean_x = (n1 * mx1 + n2 * mx2) / nb
        mean_y = (n1 * my1 + n2 * my2) / nb
        w = (n1 * n2) / nb
        var_x = vx1 + vx2 + w * (mx1 - mx2) ** 2
        var_y = vy1 + vy2 + w * (my1 - my2) ** 2
        corr_xy = cxy1 + cxy2 + w * (mx1 - mx2) * (my1 - my2)
        mx1, my1, vx1, vy1, cxy1, n1 = mean_x, mean_y, var_x, var_y, corr_xy, nb
    return vx1, vy1, cxy1, n1


def pearson_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Computes the Pearson correlation coefficient.

    Example:
        >>> import torch
        >>> target = torch.tensor([3., -0.5, 2., 7.])
        >>> preds = torch.tensor([2.5, 0.0, 2., 8.])
        >>> pearson_corrcoef(preds, target)
        tensor(0.9849)
    """
    zero = torch.zeros((), dtype=torch.float32, device=preds.device)
    _, _, var_x, var_y, corr_xy, nb = _pearson_corrcoef_update(preds, target, zero, zero, zero, zero, zero, zero)
    return _pearson_corrcoef_compute(var_x, var_y, corr_xy, nb)
