"""Image gradients (dy, dx).

Counterpart of ``metrics_tpu/functional/image/gradients.py``: forward
differences along H and W, zero-padded at the far edge. Bit-equal to the
JAX package (one subtraction per element).
"""
from typing import Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _image_gradients_validate(img: Tensor) -> None:
    if not isinstance(img, Tensor):
        raise TypeError(f"The `img` expects a value of <Array> type but got {type(img)}")
    if img.ndim != 4:
        raise RuntimeError(f"The `img` expects a 4D tensor but got {img.ndim}D tensor")


def _compute_image_gradients(img: Tensor) -> Tuple[Tensor, Tensor]:
    dy = img[..., 1:, :] - img[..., :-1, :]
    dx = img[..., :, 1:] - img[..., :, :-1]

    dy = F.pad(dy, (0, 0, 0, 1))
    dx = F.pad(dx, (0, 1, 0, 0))

    return dy, dx


def image_gradients(img: Tensor) -> Tuple[Tensor, Tensor]:
    """Computes (dy, dx) of an ``(N, C, H, W)`` image tensor.

    Example:
        >>> import torch
        >>> img = torch.arange(16, dtype=torch.float32).reshape(1, 1, 4, 4)
        >>> dy, dx = image_gradients(img)
        >>> dy[0, 0, :, :]
        tensor([[4., 4., 4., 4.],
                [4., 4., 4., 4.],
                [4., 4., 4., 4.],
                [0., 0., 0., 0.]])
    """
    _image_gradients_validate(img)
    return _compute_image_gradients(img)
