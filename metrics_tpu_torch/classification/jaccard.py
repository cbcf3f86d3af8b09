"""Modular JaccardIndex (intersection over union), a ConfusionMatrix.

Counterpart of ``metrics_tpu/classification/jaccard.py``.
"""
from typing import Any, Optional

import torch

from metrics_tpu_torch.classification.confusion_matrix import ConfusionMatrix
from metrics_tpu_torch.functional.classification.jaccard import _jaccard_from_confmat

Tensor = torch.Tensor


class JaccardIndex(ConfusionMatrix):
    """Computes the Jaccard index (intersection over union).

    Example:
        >>> import torch
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> jaccard = JaccardIndex(num_classes=2, device="cpu")
        >>> jaccard(preds, target)
        tensor(0.5833)
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(
        self,
        num_classes: int,
        ignore_index: Optional[int] = None,
        absent_score: float = 0.0,
        threshold: float = 0.5,
        reduction: str = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes,
            normalize=None,
            threshold=threshold,
            **kwargs,
        )
        self.reduction = reduction
        self.ignore_index = ignore_index
        self.absent_score = absent_score

    def _compute(self) -> Tensor:
        return _jaccard_from_confmat(self.confmat, self.num_classes, self.ignore_index, self.absent_score, self.reduction)
