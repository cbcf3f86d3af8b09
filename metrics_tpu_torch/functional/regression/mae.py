"""Mean absolute error.

Counterpart of ``metrics_tpu/functional/regression/mae.py``. The absolute
error is summed by a fixed pairwise tree (``_tree_sum``), so the card and
the CPU give the same bits (within float32 rounding of the JAX package's
``jnp.sum``); half-precision inputs are widened to float32 first.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import _tree_sum, _widen_half

Tensor = torch.Tensor


def _mean_absolute_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    return _tree_sum(torch.abs(_widen_half(preds) - _widen_half(target)).reshape(-1)), target.numel()


def _mean_absolute_error_compute(sum_abs_error: Tensor, n_obs: Tensor) -> Tensor:
    return sum_abs_error / n_obs


def mean_absolute_error(preds: Tensor, target: Tensor) -> Tensor:
    """Computes mean absolute error.

    Example:
        >>> import torch
        >>> x = torch.tensor([0., 1., 2., 3.])
        >>> y = torch.tensor([0., 1., 2., 1.])
        >>> mean_absolute_error(x, y)
        tensor(0.5000)
    """
    sum_abs_error, n_obs = _mean_absolute_error_update(preds, target)
    return _mean_absolute_error_compute(sum_abs_error, n_obs)
