"""Modular SDR / SI-SDR.

Counterpart of ``metrics_tpu/audio/sdr.py``: a float32 sum of the batch's
values and an int32 count, both sum-reduced, on the metric's device.
"""
from typing import Any, Optional

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.audio.sdr import (
    scale_invariant_signal_distortion_ratio,
    signal_distortion_ratio,
)
from metrics_tpu_torch.utils.data import _tree_sum

Tensor = torch.Tensor


class SignalDistortionRatio(Metric):
    """Mean signal-to-distortion ratio (BSS-eval) over all seen signals, in dB.

    Args:
        use_cg_iter: solve the distortion filter with this many conjugate-
            gradient iterations instead of the dense Toeplitz solve.
        filter_length: allowed distortion-filter length (default 512).
        zero_mean: subtract time-axis means before computing.
        load_diag: diagonal loading for near-singular systems.

    Example:
        >>> import numpy as np
        >>> import torch
        >>> rng = np.random.RandomState(0)
        >>> preds = torch.as_tensor(rng.randn(8000))
        >>> target = torch.as_tensor(rng.randn(8000))
        >>> sdr = SignalDistortionRatio(device="cpu")
        >>> float(sdr(preds, target)) < 0  # random signals are uncorrelated
        True
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(
        self,
        use_cg_iter: Optional[int] = None,
        filter_length: int = 512,
        zero_mean: bool = False,
        load_diag: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.use_cg_iter = use_cg_iter
        self.filter_length = filter_length
        self.zero_mean = zero_mean
        self.load_diag = load_diag
        self.add_state("sum_sdr", default=0.0, dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")

    def _update(self, preds: Tensor, target: Tensor) -> None:
        sdr_batch = signal_distortion_ratio(
            preds, target, self.use_cg_iter, self.filter_length, self.zero_mean, self.load_diag
        )
        self.sum_sdr = self.sum_sdr + _tree_sum(sdr_batch.reshape(-1))
        self.total = self.total + sdr_batch.numel()

    def _compute(self) -> Tensor:
        return self.sum_sdr / self.total


class ScaleInvariantSignalDistortionRatio(Metric):
    """Mean scale-invariant SDR over all seen signals, in dB.

    Args:
        zero_mean: subtract time-axis means before computing.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> si_sdr = ScaleInvariantSignalDistortionRatio(device="cpu")
        >>> si_sdr(preds, target)
        tensor(18.4030)
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean
        self.add_state("sum_si_sdr", default=0.0, dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")

    def _update(self, preds: Tensor, target: Tensor) -> None:
        si_sdr_batch = scale_invariant_signal_distortion_ratio(preds, target, zero_mean=self.zero_mean)
        self.sum_si_sdr = self.sum_si_sdr + _tree_sum(si_sdr_batch.reshape(-1))
        self.total = self.total + si_sdr_batch.numel()

    def _compute(self) -> Tensor:
        return self.sum_si_sdr / self.total
