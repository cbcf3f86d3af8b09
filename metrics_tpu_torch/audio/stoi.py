"""Modular ShortTimeObjectiveIntelligibility.

Counterpart of ``metrics_tpu/audio/stoi.py``: a float32 sum of per-utterance
STOI and an int32 count on the metric's device. The resampling and the
silent-frame removal run on the host (one read of the batch), the
spectrograms and correlations on the metric's device (one copy there); see
:mod:`metrics_tpu_torch.functional.audio.stoi`.
"""
from typing import Any

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.audio.stoi import short_time_objective_intelligibility
from metrics_tpu_torch.utils.data import _tree_sum

Tensor = torch.Tensor


class ShortTimeObjectiveIntelligibility(Metric):
    """Average STOI over accumulated utterances.

    Args:
        fs: sampling frequency of the input waveforms.
        extended: use extended STOI (eSTOI).
    """

    is_differentiable = False
    higher_is_better = True
    __jit_unsafe__ = True  # silent-frame removal is data-dependent host work

    def __init__(self, fs: int, extended: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(fs, int) and fs > 0):
            raise ValueError(f"Expected argument `fs` to be a positive int, but got {fs}")
        self.fs = fs
        self.extended = extended

        self.add_state("sum_stoi", default=0.0, dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")

    def _update(self, preds: Tensor, target: Tensor) -> None:
        stoi_batch = short_time_objective_intelligibility(preds, target, self.fs, self.extended, device=self.device).reshape(-1)
        self.sum_stoi = self.sum_stoi + _tree_sum(stoi_batch)
        self.total = self.total + stoi_batch.shape[0]

    def _compute(self) -> Tensor:
        return self.sum_stoi / self.total
