"""Pairwise manhattan (L1) distance.

Counterpart of ``metrics_tpu/functional/pairwise/manhattan.py``, which
materialises the ``[N, M, d]`` differences at once (34 GB at 8192 x 8192 x
512 in float32). Here the rows of ``x`` go in chunks whose differences
fit a fixed byte budget (:data:`CHUNK_BYTES`), and each distance is the
same sequence of IEEE operations in any chunk: the absolute differences
summed over ``d`` in a fixed pairwise order (``_tree_sum``). So the chunked
result is bit-equal to the unchunked one, and the card gives the CPU's
bits.
"""
from typing import Optional

import torch

from metrics_tpu_torch.functional.pairwise.helpers import _check_input, _reduce_distance_matrix, _zero_diagonal
from metrics_tpu_torch.utils.data import _tree_sum

Tensor = torch.Tensor

#: bytes of ``[rows, M, d]`` differences that one chunk may hold
CHUNK_BYTES = 1 << 28


def _pairwise_manhattan_distance_update(
    x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None, chunk_bytes: int = CHUNK_BYTES
) -> Tensor:
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    per_row = max(1, y.shape[0] * y.shape[1] * torch.promote_types(x.dtype, y.dtype).itemsize)
    rows = max(1, chunk_bytes // per_row)
    parts = [_tree_sum(torch.abs(x[i : i + rows, None, :] - y[None, :, :])) for i in range(0, x.shape[0], rows)]
    distance = torch.cat(parts) if parts else x.new_zeros((0, y.shape[0]))
    return _zero_diagonal(distance, zero_diagonal)


def pairwise_manhattan_distance(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Pairwise manhattan (L1) distance between the rows of ``x`` and of ``y``.

    Example:
        >>> import torch
        >>> x = torch.tensor([[2., 3.], [3., 5.], [5., 8.]])
        >>> y = torch.tensor([[1., 0.], [2., 1.]])
        >>> pairwise_manhattan_distance(x, y)
        tensor([[ 4.,  2.],
                [ 7.,  5.],
                [12., 10.]])
    """
    return _reduce_distance_matrix(_pairwise_manhattan_distance_update(x, y, zero_diagonal), reduction)
