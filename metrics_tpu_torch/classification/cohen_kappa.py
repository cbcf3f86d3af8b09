"""Modular CohenKappa.

Counterpart of ``metrics_tpu/classification/cohen_kappa.py``: an int32
``[C, C]`` confusion matrix on the metric's device, counted by K1
(``bincount_i32``) on the card.
"""
from typing import Any, Optional

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.cohen_kappa import _cohen_kappa_compute, _cohen_kappa_update

Tensor = torch.Tensor


class CohenKappa(Metric):
    """Computes Cohen's kappa (inter-annotator agreement).

    Example:
        >>> import torch
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> cohenkappa = CohenKappa(num_classes=2, device="cpu")
        >>> cohenkappa(preds, target)
        tensor(0.5000)
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(
        self,
        num_classes: int,
        weights: Optional[str] = None,
        threshold: float = 0.5,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.weights = weights
        self.threshold = threshold

        allowed_weights = ("linear", "quadratic", "none", None)
        if weights not in allowed_weights:
            raise ValueError(f"Argument weights needs to one of the following: {allowed_weights}")

        default = torch.zeros((num_classes, num_classes), dtype=torch.int32, device=self.device)
        self.add_state("confmat", default=default, dist_reduce_fx="sum")

    def _update(self, preds: Tensor, target: Tensor) -> None:
        confmat = _cohen_kappa_update(preds, target, self.num_classes, self.threshold)
        self.confmat = self.confmat + confmat

    def _compute(self) -> Tensor:
        return _cohen_kappa_compute(self.confmat, None if self.weights == "none" else self.weights)
