"""Modular ConfusionMatrix (counterpart of ``metrics_tpu/classification/confusion_matrix.py``)."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _confusion_matrix_compute,
    _confusion_matrix_update,
)

Tensor = torch.Tensor


class ConfusionMatrix(Metric):
    """Computes the confusion matrix; the state is an int32 ``[C, C]``
    (``[C, 2, 2]`` when ``multilabel``) count on the metric's device.

    Example:
        >>> import torch
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> confmat = ConfusionMatrix(num_classes=2, device="cpu")
        >>> confmat(preds, target)
        tensor([[2, 0],
                [1, 1]], dtype=torch.int32)
    """

    is_differentiable = False

    def __init__(
        self,
        num_classes: int,
        normalize: Optional[str] = None,
        threshold: float = 0.5,
        multilabel: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.normalize = normalize
        self.threshold = threshold
        self.multilabel = multilabel

        allowed_normalize = ("true", "pred", "all", "none", None)
        if normalize not in allowed_normalize:
            raise ValueError(f"Argument average needs to one of the following: {allowed_normalize}")

        shape = (num_classes, 2, 2) if multilabel else (num_classes, num_classes)
        self.add_state("confmat", default=torch.zeros(shape, dtype=torch.int32, device=self.device), dist_reduce_fx="sum")

    def _update(self, preds: Tensor, target: Tensor) -> None:
        confmat = _confusion_matrix_update(preds, target, self.num_classes, self.threshold, self.multilabel)
        self.confmat = self.confmat + confmat

    def _compute(self) -> Tensor:
        return _confusion_matrix_compute(self.confmat, self.normalize)
