"""SNR / SI-SNR.

Counterpart of ``metrics_tpu/functional/audio/snr.py``: elementwise math and
time-axis sums, batched over leading dims. Half-precision and float64
inputs are computed in float32 (the JAX package computes float16 and
bfloat16 in their own dtype with their own epsilon); integer estimates
raise ``ValueError``, as the JAX package's ``jnp.finfo`` of an integer
dtype does, and an integer target takes the estimate's float dtype.
"""
import torch

from metrics_tpu_torch.functional.audio.sdr import _float_inputs, scale_invariant_signal_distortion_ratio
from metrics_tpu_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor


def signal_noise_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """Signal-to-noise ratio: 10 log10(|target|^2 / |target - preds|^2).

    Args:
        preds: estimate, shape ``[..., time]``.
        target: reference, shape ``[..., time]``.
        zero_mean: subtract the time-axis mean from both signals first.

    Returns:
        SNR in dB, shape ``[...]``.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> signal_noise_ratio(preds, target)
        tensor(16.1805)
    """
    _check_same_shape(preds, target)
    preds, target = _float_inputs(preds, target)
    eps = torch.finfo(preds.dtype).eps

    if zero_mean:
        target = target - torch.mean(target, dim=-1, keepdim=True)
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)

    noise = target - preds
    snr_value = (torch.sum(target**2, dim=-1) + eps) / (torch.sum(noise**2, dim=-1) + eps)
    return 10 * torch.log10(snr_value)


def scale_invariant_signal_noise_ratio(preds: Tensor, target: Tensor) -> Tensor:
    """Scale-invariant SNR: SI-SDR with zero-mean inputs.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> scale_invariant_signal_noise_ratio(preds, target)
        tensor(15.0918)
    """
    return scale_invariant_signal_distortion_ratio(preds, target, zero_mean=True)
