"""Retrieval hit rate.

Counterpart of ``metrics_tpu/functional/retrieval/hit_rate.py``.
"""
from typing import Any, Optional, Union

import torch

from metrics_tpu_torch.functional.retrieval._common import _descending, _inputs
from metrics_tpu_torch.utils.checks import _check_retrieval_k

Tensor = torch.Tensor


def retrieval_hit_rate(
    preds: Any, target: Any, k: Optional[int] = None, device: Optional[Union[str, torch.device]] = None
) -> Tensor:
    """1.0 if any relevant document is in the top k, else 0.0.

    Example:
        >>> import torch
        >>> retrieval_hit_rate(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]), k=2)
        tensor(1.)
    """
    preds, target = _inputs(preds, target, device)
    if k is None:
        k = preds.shape[-1]
    _check_retrieval_k(k)
    relevant = target[_descending(preds)][:k].sum()
    return (relevant > 0).to(torch.float32)
