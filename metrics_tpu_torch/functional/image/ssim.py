"""Structural Similarity Index Measure (and multi-scale variant).

Counterpart of ``metrics_tpu/functional/image/ssim.py``: one grouped
convolution over five stacked planes (the two means and three second
moments), the reflect pad, the crop, ``return_contrast_sensitivity`` and
the multi-scale product with its ``relu``/``simple`` normalizations. The
convolution is taken in float64 and rounded once (``helper.py``); the rest
is float32 arithmetic, as in the JAX package. ``data_range=None`` takes the
larger of the two images' ranges on their device, with no host read.
"""
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.functional.image.helper import (
    _avg_pool2d,
    _check_floating_images,
    _depthwise_conv2d,
    _gaussian_kernel,
    _reflect_pad,
)
from metrics_tpu_torch.parallel.distributed import reduce
from metrics_tpu_torch.utils.checks import _check_same_shape, _same_dtype_x64_off

Tensor = torch.Tensor


def _ssim_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    _check_floating_images(preds, target)
    preds, target = _same_dtype_x64_off(preds, target)
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW shape."
            f" Got preds: {preds.shape} and target: {target.shape}."
        )
    return preds, target


def _ssim_check_kernel(kernel_size: Sequence[int], sigma: Sequence[float]) -> None:
    if len(kernel_size) != 2 or len(sigma) != 2:
        raise ValueError(
            "Expected `kernel_size` and `sigma` to have the length of two."
            f" Got kernel_size: {len(kernel_size)} and sigma: {len(sigma)}."
        )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")


def _local_moments(
    preds: Tensor, target: Tensor, kernel_size: Sequence[int], sigma: Sequence[float]
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, int, int]:
    """``(mu_p^2, mu_t^2, mu_p mu_t, sigma_p^2, sigma_t^2, sigma_pt)`` over the
    Gaussian window of the reflect-padded images, and the pads: one grouped
    conv over the five stacked planes. Shared by SSIM and UQI."""
    channel = preds.shape[1]
    kernel = _gaussian_kernel(channel, kernel_size, sigma, preds.dtype, preds.device)
    pad_h = (kernel_size[0] - 1) // 2
    pad_w = (kernel_size[1] - 1) // 2

    preds = _reflect_pad(preds, pad_h, pad_w)
    target = _reflect_pad(target, pad_h, pad_w)

    # one grouped conv over 5 stacked planes: mu_p, mu_t, E[p^2], E[t^2], E[pt]
    input_list = torch.cat([preds, target, preds * preds, target * target, preds * target])
    outputs = _depthwise_conv2d(input_list, kernel)
    n = preds.shape[0]
    output_list = [outputs[i * n : (i + 1) * n] for i in range(5)]

    mu_pred_sq = torch.square(output_list[0])
    mu_target_sq = torch.square(output_list[1])
    mu_pred_target = output_list[0] * output_list[1]

    sigma_pred_sq = output_list[2] - mu_pred_sq
    sigma_target_sq = output_list[3] - mu_target_sq
    sigma_pred_target = output_list[4] - mu_pred_target
    return mu_pred_sq, mu_target_sq, mu_pred_target, sigma_pred_sq, sigma_target_sq, sigma_pred_target, pad_h, pad_w


def _crop(x: Tensor, pad_h: int, pad_w: int) -> Tensor:
    """The JAX package's crop: both pads off, or nothing when either is 0."""
    return x[..., pad_h:-pad_h, pad_w:-pad_w] if pad_h and pad_w else x


def _ssim_compute(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: str = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_contrast_sensitivity: bool = False,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    _ssim_check_kernel(kernel_size, sigma)

    if data_range is None:
        data_range = torch.maximum(torch.max(preds) - torch.min(preds), torch.max(target) - torch.min(target))

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu_pred_sq, mu_target_sq, mu_pred_target, sigma_pred_sq, sigma_target_sq, sigma_pred_target, pad_h, pad_w = (
        _local_moments(preds, target, kernel_size, sigma)
    )

    upper = 2 * sigma_pred_target + c2
    lower = sigma_pred_sq + sigma_target_sq + c2

    ssim_idx = _crop(((2 * mu_pred_target + c1) * upper) / ((mu_pred_sq + mu_target_sq + c1) * lower), pad_h, pad_w)

    if return_contrast_sensitivity:
        contrast_sensitivity = _crop(upper / lower, pad_h, pad_w)
        return reduce(ssim_idx, reduction), reduce(contrast_sensitivity, reduction)

    return reduce(ssim_idx, reduction)


def structural_similarity_index_measure(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: str = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
) -> Tensor:
    """Computes the structural similarity index measure.

    Example:
        >>> import torch
        >>> preds = torch.rand(8, 3, 16, 16, generator=torch.Generator().manual_seed(0))
        >>> target = preds * 0.75
        >>> bool(structural_similarity_index_measure(preds, target) > 0.9)
        True
    """
    preds, target = _ssim_update(preds, target)
    return _ssim_compute(preds, target, kernel_size, sigma, reduction, data_range, k1, k2)


def _get_normalized_sim_and_cs(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int],
    sigma: Sequence[float],
    reduction: str,
    data_range: Optional[float],
    k1: float,
    k2: float,
    normalize: Optional[str] = None,
) -> Tuple[Tensor, Tensor]:
    sim, contrast_sensitivity = _ssim_compute(
        preds, target, kernel_size, sigma, reduction, data_range, k1, k2, return_contrast_sensitivity=True
    )
    if normalize == "relu":
        sim = torch.relu(sim)
        contrast_sensitivity = torch.relu(contrast_sensitivity)
    return sim, contrast_sensitivity


def _multiscale_ssim_compute(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: str = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = None,
) -> Tensor:
    if preds.shape[-1] < 2 ** len(betas) or preds.shape[-2] < 2 ** len(betas):
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)}, the image height and width dimensions must be"
            f" larger than or equal to {2 ** len(betas)}."
        )
    _betas_div = max(1, (len(betas) - 1)) ** 2
    if preds.shape[-2] // _betas_div <= kernel_size[0] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kernel_size[0]},"
            f" the image height must be larger than {(kernel_size[0] - 1) * _betas_div}."
        )
    if preds.shape[-1] // _betas_div <= kernel_size[1] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kernel_size[1]},"
            f" the image width must be larger than {(kernel_size[1] - 1) * _betas_div}."
        )

    sim_list = []
    cs_list = []
    for _ in range(len(betas)):
        sim, contrast_sensitivity = _get_normalized_sim_and_cs(
            preds, target, kernel_size, sigma, reduction, data_range, k1, k2, normalize
        )
        sim_list.append(sim)
        cs_list.append(contrast_sensitivity)
        preds = _avg_pool2d(preds)
        target = _avg_pool2d(target)

    sim_stack = torch.stack(sim_list)
    cs_stack = torch.stack(cs_list)

    if normalize == "simple":
        sim_stack = (sim_stack + 1) / 2
        cs_stack = (cs_stack + 1) / 2

    # betas as float32 values, as jnp.asarray gives them (a host copy, no read)
    betas_arr = torch.from_numpy(np.asarray(betas, dtype=np.float32)).to(sim_stack.device)
    sim_stack = sim_stack**betas_arr
    cs_stack = cs_stack**betas_arr
    return torch.prod(cs_stack[:-1]) * sim_stack[-1]


def multiscale_structural_similarity_index_measure(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: str = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = None,
) -> Tensor:
    """Computes the multi-scale structural similarity index measure.

    Example:
        >>> import torch
        >>> preds = torch.rand(8, 3, 192, 192, generator=torch.Generator().manual_seed(0))
        >>> target = preds * 0.75
        >>> bool(multiscale_structural_similarity_index_measure(preds, target) > 0.9)
        True
    """
    if not isinstance(betas, tuple) or not all(isinstance(beta, float) for beta in betas):
        raise ValueError("Argument `betas` is expected to be of a type tuple of floats.")
    if normalize and normalize not in ("relu", "simple"):
        raise ValueError("Argument `normalize` to be expected either `None`, `relu` or `simple`")

    preds, target = _ssim_update(preds, target)
    return _multiscale_ssim_compute(
        preds, target, kernel_size, sigma, reduction, data_range, k1, k2, betas, normalize
    )
