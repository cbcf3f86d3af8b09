"""Retrieval average precision.

Counterpart of ``metrics_tpu/functional/retrieval/average_precision.py``.
"""
from typing import Any, Optional, Union

import torch

from metrics_tpu_torch.functional.retrieval._common import _descending, _inputs, _zero

Tensor = torch.Tensor


def retrieval_average_precision(preds: Any, target: Any, device: Optional[Union[str, torch.device]] = None) -> Tensor:
    """Average precision of a single query's ranking.

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> retrieval_average_precision(preds, target)
        tensor(0.8333)
    """
    preds, target = _inputs(preds, target, device)
    if not bool(target.sum()):
        return _zero(preds)
    target = target[_descending(preds)]
    positions = torch.arange(1, len(target) + 1, dtype=torch.float32, device=preds.device)[target > 0]
    return torch.mean((torch.arange(len(positions), dtype=torch.float32, device=preds.device) + 1) / positions)
