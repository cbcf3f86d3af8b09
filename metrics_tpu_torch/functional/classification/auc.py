"""Area under a curve by the trapezoidal rule.

Counterpart of ``metrics_tpu/functional/classification/auc.py``.
"""
from typing import Any, Optional, Tuple, Union

import torch

from metrics_tpu_torch.utils.data import _as_tensor, _x64_off

Tensor = torch.Tensor


def _auc_update(x: Tensor, y: Tensor) -> Tuple[Tensor, Tensor]:
    if x.ndim > 1:
        x = x.squeeze()
    if y.ndim > 1:
        y = y.squeeze()
    if x.ndim > 1 or y.ndim > 1:
        raise ValueError(
            f"Expected both `x` and `y` tensor to be 1d, but got tensors with dimension {x.ndim} and {y.ndim}"
        )
    if x.numel() != y.numel():
        raise ValueError(
            f"Expected the same number of elements in `x` and `y` tensor but received {x.numel()} and {y.numel()}"
        )
    # the x64-off dtypes, then one dtype for both: ``jnp.trapezoid`` promotes
    # first, where ``torch.trapezoid`` would average ``y`` in its own dtype
    x, y = _x64_off(x), _x64_off(y)
    dtype = torch.promote_types(x.dtype, y.dtype)
    if not dtype.is_floating_point:
        dtype = torch.float32
    return x.to(dtype), y.to(dtype)


def _auc_compute_without_check(x: Tensor, y: Tensor, direction: Any) -> Tensor:
    return torch.trapezoid(y, x) * direction


def _auc_compute(x: Tensor, y: Tensor, reorder: bool = False) -> Tensor:
    if reorder:
        idx = torch.sort(x, stable=True).indices
        x, y = x[idx], y[idx]

    dx = x[1:] - x[:-1]
    any_down, never_up = torch.stack([(dx < 0).any(), (dx <= 0).all()]).tolist()
    if any_down and not never_up:
        raise ValueError(
            "The `x` tensor is neither increasing or decreasing. Try setting the reorder argument to `True`."
        )
    return _auc_compute_without_check(x, y, -1.0 if any_down and never_up else 1.0)


def auc(x: Any, y: Any, reorder: bool = False, device: Optional[Union[str, torch.device]] = None) -> Tensor:
    """Computes the area under the curve (x, y) by the trapezoidal rule.

    Example:
        >>> import torch
        >>> x = torch.tensor([0., 1., 2., 3.])
        >>> y = torch.tensor([0., 1., 2., 2.])
        >>> auc(x, y)
        tensor(4.)
    """
    x, y = _auc_update(_as_tensor(x, device), _as_tensor(y, device))
    return _auc_compute(x, y, reorder=reorder)
