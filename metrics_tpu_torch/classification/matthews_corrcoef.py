"""Modular MatthewsCorrCoef.

Counterpart of ``metrics_tpu/classification/matthews_corrcoef.py``: an
int32 ``[C, C]`` confusion matrix on the metric's device, counted by K1
(``bincount_i32``) on the card.
"""
from typing import Any

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.matthews_corrcoef import (
    _matthews_corrcoef_compute,
    _matthews_corrcoef_update,
)

Tensor = torch.Tensor


class MatthewsCorrCoef(Metric):
    """Computes the Matthews correlation coefficient.

    Example:
        >>> import torch
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> matthews_corrcoef = MatthewsCorrCoef(num_classes=2, device="cpu")
        >>> matthews_corrcoef(preds, target)
        tensor(0.5774)
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(
        self,
        num_classes: int,
        threshold: float = 0.5,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.threshold = threshold
        default = torch.zeros((num_classes, num_classes), dtype=torch.int32, device=self.device)
        self.add_state("confmat", default=default, dist_reduce_fx="sum")

    def _update(self, preds: Tensor, target: Tensor) -> None:
        confmat = _matthews_corrcoef_update(preds, target, self.num_classes, self.threshold)
        self.confmat = self.confmat + confmat

    def _compute(self) -> Tensor:
        return _matthews_corrcoef_compute(self.confmat)
