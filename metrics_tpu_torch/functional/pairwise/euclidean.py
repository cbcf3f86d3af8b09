"""Pairwise euclidean distance.

Counterpart of ``metrics_tpu/functional/pairwise/euclidean.py``: the
expansion ``|x|^2 + |y|^2 - 2 x.y``, clamped at 0 before the root.
"""
from typing import Optional

import torch

from metrics_tpu_torch.functional.pairwise.helpers import _check_input, _matmul_t, _reduce_distance_matrix, _zero_diagonal

Tensor = torch.Tensor


def _pairwise_euclidean_distance_update(x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None) -> Tensor:
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    x_norm = (x * x).sum(dim=1, keepdim=True)
    y_norm = (y * y).sum(dim=1)[None, :]
    distance = x_norm + y_norm - 2 * _matmul_t(x, y)
    distance = _zero_diagonal(distance, zero_diagonal)
    return torch.sqrt(torch.clamp(distance, min=0.0))


def pairwise_euclidean_distance(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Pairwise euclidean distance between the rows of ``x`` and of ``y``.

    Example:
        >>> import torch
        >>> x = torch.tensor([[2., 3.], [3., 5.], [5., 8.]])
        >>> y = torch.tensor([[1., 0.], [2., 1.]])
        >>> pairwise_euclidean_distance(x, y)
        tensor([[3.1623, 2.0000],
                [5.3852, 4.1231],
                [8.9443, 7.6158]])
    """
    return _reduce_distance_matrix(_pairwise_euclidean_distance_update(x, y, zero_diagonal), reduction)
