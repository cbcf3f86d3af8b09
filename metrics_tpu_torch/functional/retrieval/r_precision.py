"""Retrieval R-precision.

Counterpart of ``metrics_tpu/functional/retrieval/r_precision.py``.
"""
from typing import Any, Optional, Union

import torch

from metrics_tpu_torch.functional.retrieval._common import _descending, _inputs, _zero

Tensor = torch.Tensor


def retrieval_r_precision(preds: Any, target: Any, device: Optional[Union[str, torch.device]] = None) -> Tensor:
    """Precision at R, where R is the number of relevant documents.

    Example:
        >>> import torch
        >>> retrieval_r_precision(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([True, False, True]))
        tensor(0.5000)
    """
    preds, target = _inputs(preds, target, device)
    relevant_number = int(target.sum())
    if not relevant_number:
        return _zero(preds)
    relevant = target[_descending(preds)][:relevant_number].sum().to(torch.float32)
    return relevant / relevant_number
