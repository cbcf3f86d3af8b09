"""Universal Image Quality Index.

Counterpart of ``metrics_tpu/functional/image/uqi.py``: SSIM with
c1 = c2 = 0, so a window where both images are constant divides 0 by 0
and gives NaN, at the same positions as in the JAX package.
"""
from typing import Optional, Sequence, Tuple

import torch

from metrics_tpu_torch.functional.image.helper import _check_floating_images
from metrics_tpu_torch.functional.image.ssim import _crop, _local_moments, _ssim_check_kernel
from metrics_tpu_torch.parallel.distributed import reduce
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import _x64_off

Tensor = torch.Tensor


def _uqi_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    _check_floating_images(preds, target)
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {preds.dtype} and target: {target.dtype}."
        )
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW shape."
            f" Got preds: {preds.shape} and target: {target.shape}."
        )
    return _x64_off(preds), _x64_off(target)


def _uqi_compute(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: str = "elementwise_mean",
    data_range: Optional[float] = None,
) -> Tensor:
    _ssim_check_kernel(kernel_size, sigma)

    mu_pred_sq, mu_target_sq, mu_pred_target, sigma_pred_sq, sigma_target_sq, sigma_pred_target, pad_h, pad_w = (
        _local_moments(preds, target, kernel_size, sigma)
    )

    upper = 2 * sigma_pred_target
    lower = sigma_pred_sq + sigma_target_sq

    uqi_idx = _crop(((2 * mu_pred_target) * upper) / ((mu_pred_sq + mu_target_sq) * lower), pad_h, pad_w)

    return reduce(uqi_idx, reduction)


def universal_image_quality_index(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: str = "elementwise_mean",
    data_range: Optional[float] = None,
) -> Tensor:
    """Computes the Universal Image Quality Index.

    Example:
        >>> import torch
        >>> preds = torch.rand(8, 3, 16, 16, generator=torch.Generator().manual_seed(0))
        >>> target = preds * 0.75
        >>> bool(universal_image_quality_index(preds, target) > 0.9)
        True
    """
    preds, target = _uqi_update(preds, target)
    return _uqi_compute(preds, target, kernel_size, sigma, reduction, data_range)
