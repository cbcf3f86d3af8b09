"""Pairwise cosine similarity.

Counterpart of ``metrics_tpu/functional/pairwise/cosine.py``.
"""
from typing import Optional

import torch

from metrics_tpu_torch.functional.pairwise.helpers import _check_input, _matmul_t, _reduce_distance_matrix, _zero_diagonal

Tensor = torch.Tensor


def _pairwise_cosine_similarity_update(x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None) -> Tensor:
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    # integer rows divide into float32, as jnp's norm and division promote
    x, y = (v if v.is_floating_point() else v.to(torch.float32) for v in (x, y))
    x = x / torch.linalg.norm(x, dim=1, keepdim=True)
    y = y / torch.linalg.norm(y, dim=1, keepdim=True)
    return _zero_diagonal(_matmul_t(x, y), zero_diagonal)


def pairwise_cosine_similarity(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Pairwise cosine similarity between the rows of ``x`` and of ``y``
    (``x`` with itself and a zero diagonal when ``y`` is None).

    Example:
        >>> import torch
        >>> x = torch.tensor([[2., 3.], [3., 5.], [5., 8.]])
        >>> y = torch.tensor([[1., 0.], [2., 1.]])
        >>> pairwise_cosine_similarity(x, y)
        tensor([[0.5547, 0.8682],
                [0.5145, 0.8437],
                [0.5300, 0.8533]])
    """
    return _reduce_distance_matrix(_pairwise_cosine_similarity_update(x, y, zero_diagonal), reduction)
