"""Retrieval precision.

Counterpart of ``metrics_tpu/functional/retrieval/precision.py``.
"""
from typing import Any, Optional, Union

import torch

from metrics_tpu_torch.functional.retrieval._common import _descending, _inputs, _zero
from metrics_tpu_torch.utils.checks import _check_retrieval_k

Tensor = torch.Tensor


def retrieval_precision(
    preds: Any, target: Any, k: Optional[int] = None, device: Optional[Union[str, torch.device]] = None
) -> Tensor:
    """Fraction of the top k retrieved documents that are relevant.

    Example:
        >>> import torch
        >>> retrieval_precision(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]), k=2)
        tensor(0.5000)
    """
    preds, target = _inputs(preds, target, device)
    if k is None:
        k = preds.shape[-1]
    _check_retrieval_k(k)
    if not bool(target.sum()):
        return _zero(preds)
    relevant = target[_descending(preds)[: min(k, preds.shape[-1])]].sum().to(torch.float32)
    return relevant / k
