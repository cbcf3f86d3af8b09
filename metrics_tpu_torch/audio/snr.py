"""Modular SNR / SI-SNR.

Counterpart of ``metrics_tpu/audio/snr.py``: a float32 sum of the batch's
values and an int32 count, both sum-reduced, on the metric's device, so the
metrics slice (``SlicedMetric``) and fuse (``compile_update``). An update
reads nothing back and copies nothing to the card.
"""
from typing import Any

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.audio.snr import scale_invariant_signal_noise_ratio, signal_noise_ratio
from metrics_tpu_torch.utils.data import _tree_sum

Tensor = torch.Tensor


class SignalNoiseRatio(Metric):
    """Mean signal-to-noise ratio over all seen signals, in dB.

    Args:
        zero_mean: subtract the time-axis mean from both signals first.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> snr = SignalNoiseRatio(device="cpu")
        >>> snr(preds, target)
        tensor(16.1805)
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean
        self.add_state("sum_snr", default=0.0, dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")

    def _update(self, preds: Tensor, target: Tensor) -> None:
        snr_batch = signal_noise_ratio(preds, target, zero_mean=self.zero_mean)
        self.sum_snr = self.sum_snr + _tree_sum(snr_batch.reshape(-1))
        self.total = self.total + snr_batch.numel()

    def _compute(self) -> Tensor:
        return self.sum_snr / self.total


class ScaleInvariantSignalNoiseRatio(Metric):
    """Mean scale-invariant SNR over all seen signals, in dB.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> si_snr = ScaleInvariantSignalNoiseRatio(device="cpu")
        >>> si_snr(preds, target)
        tensor(15.0918)
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_si_snr", default=0.0, dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")

    def _update(self, preds: Tensor, target: Tensor) -> None:
        si_snr_batch = scale_invariant_signal_noise_ratio(preds, target)
        self.sum_si_snr = self.sum_si_snr + _tree_sum(si_snr_batch.reshape(-1))
        self.total = self.total + si_snr_batch.numel()

    def _compute(self) -> Tensor:
        return self.sum_si_snr / self.total
