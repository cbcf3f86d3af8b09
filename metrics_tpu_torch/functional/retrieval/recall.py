"""Retrieval recall.

Counterpart of ``metrics_tpu/functional/retrieval/recall.py``.
"""
from typing import Any, Optional, Union

import torch

from metrics_tpu_torch.functional.retrieval._common import _descending, _inputs, _zero
from metrics_tpu_torch.utils.checks import _check_retrieval_k

Tensor = torch.Tensor


def retrieval_recall(
    preds: Any, target: Any, k: Optional[int] = None, device: Optional[Union[str, torch.device]] = None
) -> Tensor:
    """Fraction of the relevant documents retrieved in the top k.

    Example:
        >>> import torch
        >>> retrieval_recall(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]), k=2)
        tensor(0.5000)
    """
    preds, target = _inputs(preds, target, device)
    if k is None:
        k = preds.shape[-1]
    _check_retrieval_k(k)
    if not bool(target.sum()):
        return _zero(preds)
    relevant = target[_descending(preds)][:k].sum().to(torch.float32)
    return relevant / target.sum()
