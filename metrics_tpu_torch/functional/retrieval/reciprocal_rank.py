"""Retrieval reciprocal rank.

Counterpart of ``metrics_tpu/functional/retrieval/reciprocal_rank.py``.
"""
from typing import Any, Optional, Union

import torch

from metrics_tpu_torch.functional.retrieval._common import _descending, _inputs, _zero

Tensor = torch.Tensor


def retrieval_reciprocal_rank(preds: Any, target: Any, device: Optional[Union[str, torch.device]] = None) -> Tensor:
    """Reciprocal rank of the first relevant document.

    Example:
        >>> import torch
        >>> retrieval_reciprocal_rank(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([False, True, False]))
        tensor(0.5000)
    """
    preds, target = _inputs(preds, target, device)
    if not bool(target.sum()):
        return _zero(preds)
    position = torch.nonzero(target[_descending(preds)])[:, 0]
    return (1.0 / (position[0] + 1.0)).to(preds.dtype)
