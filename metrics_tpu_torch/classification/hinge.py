"""Modular HingeLoss.

Counterpart of ``metrics_tpu/classification/hinge.py``: two sum states
(the summed measures, float32, and the sample count, int32) on the metric's
device.
"""
from typing import Any, Optional, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.hinge import MulticlassMode, _hinge_compute, _hinge_update

Tensor = torch.Tensor


class HingeLoss(Metric):
    """Computes the mean hinge loss.

    Example:
        >>> import torch
        >>> target = torch.tensor([0, 1, 1])
        >>> preds = torch.tensor([-2.2, 2.4, 0.1])
        >>> hinge = HingeLoss(device="cpu")
        >>> hinge(preds, target)
        tensor(0.3000)
    """

    is_differentiable = True
    higher_is_better = False

    def __init__(
        self,
        squared: bool = False,
        multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.add_state("measure", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")
        if multiclass_mode not in (None, MulticlassMode.CRAMMER_SINGER, MulticlassMode.ONE_VS_ALL):
            raise ValueError(
                "The `multiclass_mode` should be either None / 'crammer-singer' / MulticlassMode.CRAMMER_SINGER"
                "(default) or 'one-vs-all' / MulticlassMode.ONE_VS_ALL,"
                f" got {multiclass_mode}."
            )
        self.squared = squared
        self.multiclass_mode = multiclass_mode

    def _update(self, preds: Tensor, target: Tensor) -> None:
        measure, total = _hinge_update(preds, target, squared=self.squared, multiclass_mode=self.multiclass_mode)
        self.measure = measure + self.measure
        self.total = total + self.total

    def _compute(self) -> Tensor:
        return _hinge_compute(self.measure, self.total)
