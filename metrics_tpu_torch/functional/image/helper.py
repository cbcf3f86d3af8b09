"""Gaussian kernel, depthwise convolution and 2x2 pooling of the image metrics.

Counterpart of ``metrics_tpu/functional/image/helper.py``. The JAX package
takes the depthwise convolution at full float32 on its CPU tests; a
float32 convolution on the card runs in TF32 whenever the caller's
``torch.backends.cudnn.allow_tf32`` says so (PyTorch's default). So
:func:`_depthwise_conv2d` convolves in float64 and rounds once to the
input's dtype, as ``functional/pairwise/helpers.py:_matmul_t`` does for
products: the result depends on no global flag, and it is at least as
accurate as a float32 convolution.
"""
from typing import Sequence

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _gaussian(kernel_size: int, sigma: float, dtype: torch.dtype, device=None) -> Tensor:
    """1D gaussian kernel of shape (1, kernel_size)."""
    dist = torch.arange((1 - kernel_size) / 2, (1 + kernel_size) / 2, 1.0, dtype=dtype, device=device)
    gauss = torch.exp(-torch.square(dist / sigma) / 2)
    return (gauss / torch.sum(gauss))[None, :]


def _gaussian_kernel(
    channel: int, kernel_size: Sequence[int], sigma: Sequence[float], dtype: torch.dtype, device=None
) -> Tensor:
    """2D gaussian kernel of shape (channel, 1, kh, kw) for a grouped conv."""
    kernel_x = _gaussian(kernel_size[0], sigma[0], dtype, device)
    kernel_y = _gaussian(kernel_size[1], sigma[1], dtype, device)
    kernel = kernel_x.T * kernel_y  # (kh, kw): an outer product, no reduction
    return kernel.expand(channel, 1, kernel_size[0], kernel_size[1])


def _depthwise_conv2d(x: Tensor, kernel: Tensor) -> Tensor:
    """VALID depthwise conv: x [N,C,H,W], kernel [C,1,kh,kw]; taken in
    float64 and rounded once to ``x``'s dtype."""
    out = F.conv2d(x.to(torch.float64), kernel.to(torch.float64), groups=x.shape[1])
    return out.to(x.dtype)


def _avg_pool2d(x: Tensor) -> Tensor:
    """2x2 average pool with stride 2."""
    return F.avg_pool2d(x, kernel_size=2, stride=2)


def _reflect_pad(x: Tensor, pad_h: int, pad_w: int) -> Tensor:
    """``jnp.pad(x, ..., mode="reflect")`` over the last two axes: numpy's
    reflection (the edge not repeated), for any pad width (``F.pad`` asks
    for a pad narrower than the axis)."""
    for dim, pad in ((-2, pad_h), (-1, pad_w)):
        if pad:
            n = x.shape[dim]
            pos = torch.arange(-pad, n + pad, device=x.device)
            if n == 1:
                idx = torch.zeros_like(pos)
            else:
                period = 2 * (n - 1)
                idx = torch.remainder(pos, period)
                idx = torch.where(idx > n - 1, period - idx, idx)
            x = torch.index_select(x, x.ndim + dim, idx)
    return x
