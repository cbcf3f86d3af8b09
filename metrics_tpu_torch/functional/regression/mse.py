"""Mean squared error.

Counterpart of ``metrics_tpu/functional/regression/mse.py``. The squared
error is summed by a fixed pairwise tree (``_tree_sum``), so the card and
the CPU give the same bits; against the JAX package's ``jnp.sum`` it is
equal where the sum is exact and within float32 rounding otherwise.
bfloat16 and float16 inputs are widened to float32 before the difference.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import _tree_sum, _widen_half

Tensor = torch.Tensor


def _mean_squared_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    diff = _widen_half(preds) - _widen_half(target)
    return _tree_sum((diff * diff).reshape(-1)), target.numel()


def _mean_squared_error_compute(sum_squared_error: Tensor, n_obs: Tensor, squared: bool = True) -> Tensor:
    mse = sum_squared_error / n_obs
    return mse if squared else torch.sqrt(mse)


def mean_squared_error(preds: Tensor, target: Tensor, squared: bool = True) -> Tensor:
    """Computes mean squared error (or RMSE with ``squared=False``).

    Example:
        >>> import torch
        >>> x = torch.tensor([0., 1., 2., 3.])
        >>> y = torch.tensor([0., 1., 2., 2.])
        >>> mean_squared_error(x, y)
        tensor(0.2500)
    """
    sum_squared_error, n_obs = _mean_squared_error_update(preds, target)
    return _mean_squared_error_compute(sum_squared_error, n_obs, squared=squared)
