"""Modular HammingDistance.

Counterpart of ``metrics_tpu/classification/hamming.py``: int32 ``correct``
and ``total`` on the metric's device.
"""
from typing import Any

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.hamming import _hamming_distance_compute, _hamming_distance_update

Tensor = torch.Tensor


class HammingDistance(Metric):
    """Computes the average Hamming distance (Hamming loss).

    Example:
        >>> import torch
        >>> target = torch.tensor([[0, 1], [1, 1]])
        >>> preds = torch.tensor([[0, 1], [0, 1]])
        >>> hamming_distance = HammingDistance(device="cpu")
        >>> hamming_distance(preds, target)
        tensor(0.2500)
    """

    is_differentiable = False
    higher_is_better = False

    def __init__(self, threshold: float = 0.5, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("correct", default=0, dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")
        self.threshold = threshold

    def _update(self, preds: Tensor, target: Tensor) -> None:
        correct, total = _hamming_distance_update(preds, target, self.threshold)
        self.correct = self.correct + correct
        self.total = self.total + total

    def _compute(self) -> Tensor:
        return _hamming_distance_compute(self.correct, self.total)
