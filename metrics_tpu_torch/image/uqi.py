"""Modular UniversalImageQualityIndex.

Counterpart of ``metrics_tpu/image/uqi.py``: ``"cat"`` list states, so the
eager leg of a fused collection update, as in the JAX package.
"""
from typing import Any, Optional, Sequence

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.image.uqi import _uqi_compute, _uqi_update
from metrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class UniversalImageQualityIndex(Metric):
    """Computes UQI over accumulated batches.

    Example:
        >>> import torch
        >>> preds = torch.rand(8, 3, 16, 16, generator=torch.Generator().manual_seed(0))
        >>> target = preds * 0.75
        >>> uqi = UniversalImageQualityIndex(device="cpu")
        >>> bool(uqi(preds, target) > 0.9)
        True
    """

    is_differentiable = True
    higher_is_better = True
    #: list-append update; the cat states send it to the eager leg anyway
    __jit_unsafe__ = False

    def __init__(
        self,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        reduction: str = "elementwise_mean",
        data_range: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.data_range = data_range
        self.reduction = reduction

    def _update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _uqi_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def _compute(self) -> Tensor:
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _uqi_compute(preds, target, self.kernel_size, self.sigma, self.reduction, self.data_range)
