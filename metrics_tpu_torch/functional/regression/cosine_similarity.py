"""Cosine similarity.

Counterpart of ``metrics_tpu/functional/regression/cosine_similarity.py``:
rows of ``preds`` and ``target`` as float32, the dot product and the norms
summed along the last axis in a fixed order (``_tree_sum``).
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import _tree_sum

Tensor = torch.Tensor


def _cosine_similarity_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    return preds.to(torch.float32), target.to(torch.float32)


def _cosine_similarity_compute(preds: Tensor, target: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    dot_product = _tree_sum(preds * target)
    preds_norm = torch.sqrt(_tree_sum(preds * preds))
    target_norm = torch.sqrt(_tree_sum(target * target))
    similarity = dot_product / (preds_norm * target_norm)
    if reduction == "sum":
        return _tree_sum(similarity.reshape(-1))
    if reduction == "mean":
        return _tree_sum(similarity.reshape(-1)) / similarity.numel()
    if reduction in ("none", None):
        return similarity
    raise ValueError(f"Expected reduction to be one of ['sum', 'mean', 'none', None] but got {reduction}")


def cosine_similarity(preds: Tensor, target: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    """Computes cosine similarity between rows of preds and target.

    Example:
        >>> import torch
        >>> target = torch.tensor([[1., 2., 3., 4.], [1., 2., 3., 4.]])
        >>> preds = torch.tensor([[1., 2., 3., 4.], [-1., -2., -3., -4.]])
        >>> cosine_similarity(preds, target, 'none')
        tensor([ 1.0000, -1.0000])
    """
    preds, target = _cosine_similarity_update(preds, target)
    return _cosine_similarity_compute(preds, target, reduction)
