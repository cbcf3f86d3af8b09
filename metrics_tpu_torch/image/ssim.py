"""Modular SSIM and MultiScaleSSIM.

Counterpart of ``metrics_tpu/image/ssim.py``. The states are the batches
themselves (``"cat"`` list states), so a fused collection update sends
these metrics to its eager leg, as in the JAX package; ``compute`` runs the
functional over the concatenated images.
"""
from typing import Any, Optional, Sequence, Tuple

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.image.ssim import _multiscale_ssim_compute, _ssim_compute, _ssim_update
from metrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class StructuralSimilarityIndexMeasure(Metric):
    """Computes SSIM over accumulated batches.

    Example:
        >>> import torch
        >>> preds = torch.rand(8, 3, 16, 16, generator=torch.Generator().manual_seed(0))
        >>> target = preds * 0.75
        >>> ssim = StructuralSimilarityIndexMeasure(device="cpu")
        >>> bool(ssim(preds, target) > 0.9)
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
        k1: float = 0.01,
        k2: float = 0.03,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.reduction = reduction

    def _update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _ssim_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def _compute(self) -> Tensor:
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _ssim_compute(
            preds, target, self.kernel_size, self.sigma, self.reduction, self.data_range, self.k1, self.k2
        )


class MultiScaleStructuralSimilarityIndexMeasure(Metric):
    """Computes MS-SSIM over accumulated batches.

    Example:
        >>> import torch
        >>> preds = torch.rand(8, 3, 192, 192, generator=torch.Generator().manual_seed(0))
        >>> target = preds * 0.75
        >>> ms_ssim = MultiScaleStructuralSimilarityIndexMeasure(device="cpu")
        >>> bool(ms_ssim(preds, target) > 0.9)
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
        k1: float = 0.01,
        k2: float = 0.03,
        betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
        normalize: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.reduction = reduction
        if not isinstance(betas, tuple) or not all(isinstance(beta, float) for beta in betas):
            raise ValueError("Argument `betas` is expected to be of a type tuple of floats.")
        self.betas = betas
        if normalize and normalize not in ("relu", "simple"):
            raise ValueError("Argument `normalize` to be expected either `None`, `relu` or `simple`")
        self.normalize = normalize

    def _update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _ssim_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def _compute(self) -> Tensor:
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _multiscale_ssim_compute(
            preds,
            target,
            self.kernel_size,
            self.sigma,
            self.reduction,
            self.data_range,
            self.k1,
            self.k2,
            self.betas,
            self.normalize,
        )
