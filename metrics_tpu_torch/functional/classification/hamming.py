"""Hamming distance.

Counterpart of ``metrics_tpu/functional/classification/hamming.py``: the
share of canonical label entries that differ, from an int32 count.
"""
from typing import Any, Optional, Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _input_format_classification
from metrics_tpu_torch.utils.data import _as_tensor

Tensor = torch.Tensor


def _hamming_distance_update(preds: Tensor, target: Tensor, threshold: float = 0.5) -> Tuple[Tensor, int]:
    preds, target, _ = _input_format_classification(preds, target, threshold=threshold)
    correct = torch.sum(preds == target, dtype=torch.int32)
    return correct, preds.numel()


def _hamming_distance_compute(correct: Tensor, total: Union[int, Tensor]) -> Tensor:
    # a tensor divisor on the count's device: CUDA divides by a host scalar
    # as a product with its reciprocal, which may round differently
    return 1 - correct.to(torch.float32) / torch.as_tensor(total, device=correct.device)


def hamming_distance(preds: Any, target: Any, threshold: float = 0.5, device: Optional[Any] = None) -> Tensor:
    """Average Hamming distance (Hamming loss) of one batch. Tensors are
    counted where they lie; numpy inputs go to ``device`` (the card unless
    ``device="cpu"``).

    Example:
        >>> import torch
        >>> target = torch.tensor([[0, 1], [1, 1]])
        >>> preds = torch.tensor([[0, 1], [0, 1]])
        >>> hamming_distance(preds, target)
        tensor(0.2500)
    """
    correct, total = _hamming_distance_update(_as_tensor(preds, device), _as_tensor(target, device), threshold)
    return _hamming_distance_compute(correct, total)
