"""Pairwise linear (dot-product) similarity.

Counterpart of ``metrics_tpu/functional/pairwise/linear.py``.
"""
from typing import Optional

import torch

from metrics_tpu_torch.functional.pairwise.helpers import _check_input, _matmul_t, _reduce_distance_matrix, _zero_diagonal

Tensor = torch.Tensor


def _pairwise_linear_similarity_update(x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None) -> Tensor:
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    return _zero_diagonal(_matmul_t(x, y), zero_diagonal)


def pairwise_linear_similarity(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Pairwise dot-product similarity between the rows of ``x`` and of ``y``.

    Example:
        >>> import torch
        >>> x = torch.tensor([[2., 3.], [3., 5.], [5., 8.]])
        >>> y = torch.tensor([[1., 0.], [2., 1.]])
        >>> pairwise_linear_similarity(x, y)
        tensor([[ 2.,  7.],
                [ 3., 11.],
                [ 5., 18.]])
    """
    return _reduce_distance_matrix(_pairwise_linear_similarity_update(x, y, zero_diagonal), reduction)
