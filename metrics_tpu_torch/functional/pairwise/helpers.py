"""Input checks, the matrix product and the reduction of the pairwise
functionals.

Counterpart of ``metrics_tpu/functional/pairwise/helpers.py``. The JAX
package asks for ``precision=HIGHEST`` in its matrix products (a TPU
otherwise multiplies in bfloat16 passes). Here the product of float
inputs is taken in float64 and rounded once to the inputs' dtype
(:func:`_matmul_t`): TF32 (``torch.backends.cuda.matmul.allow_tf32``,
``torch.set_float32_matmul_precision``) applies to float32 products only,
so the result does not depend on the caller's setting, and it is at least
as accurate as a float32 product. Inputs take the JAX package's x64-off
dtypes first (float64 as float32, int64 as int32).
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utils.data import _x64_off

Tensor = torch.Tensor


def _check_input(x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None) -> Tuple[Tensor, Tensor, bool]:
    x = _x64_off(x)
    if x.ndim != 2:
        raise ValueError(f"Expected argument `x` to be a 2D tensor of shape `[N, d]` but got {x.shape}")

    if y is not None:
        y = _x64_off(y)
        if y.ndim != 2 or y.shape[1] != x.shape[1]:
            raise ValueError(
                "Expected argument `y` to be a 2D tensor of shape `[M, d]` where"
                " `d` should be same as the last dimension of `x`"
            )
        zero_diagonal = False if zero_diagonal is None else zero_diagonal
    else:
        y = x
        zero_diagonal = True if zero_diagonal is None else zero_diagonal
    return x, y, zero_diagonal


def _matmul_t(x: Tensor, y: Tensor) -> Tensor:
    """``x @ y.T``; for float inputs taken in float64 and rounded once."""
    if not (x.is_floating_point() or y.is_floating_point()):
        return torch.matmul(x, y.T)
    dtype = torch.promote_types(x.dtype, y.dtype)
    return torch.matmul(x.to(torch.float64), y.to(torch.float64).T).to(dtype)


def _zero_diagonal(distance: Tensor, zero_diagonal: bool) -> Tensor:
    """``distance`` with its diagonal set to 0, out of place."""
    if zero_diagonal:
        n = min(distance.shape)
        idx = torch.arange(n, device=distance.device)
        distance = distance.index_put((idx, idx), torch.zeros((), dtype=distance.dtype, device=distance.device))
    return distance


def _reduce_distance_matrix(distmat: Tensor, reduction: Optional[str] = None) -> Tensor:
    if reduction == "mean":
        return distmat.mean(dim=-1)
    if reduction == "sum":
        return distmat.sum(dim=-1)
    if reduction is None or reduction == "none":
        return distmat
    raise ValueError(f"Expected reduction to be one of `['mean', 'sum', None]` but got {reduction}")
