"""Modular PerceptualEvaluationSpeechQuality.

Counterpart of ``metrics_tpu/audio/pesq.py``: the fs/mode checks,
per-utterance scoring on the host (the ``pesq`` C binding when installed,
else the in-repo P.862 engine; ``pesq_fn`` stays injectable), and a float32
sum and an int32 count on the metric's device, which the scores reach in
one copy per update.
"""
from typing import Any, Callable, Optional

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.audio.pesq import perceptual_evaluation_speech_quality
from metrics_tpu_torch.utils.data import _tree_sum

Tensor = torch.Tensor


class PerceptualEvaluationSpeechQuality(Metric):
    """Average PESQ MOS-LQO over accumulated utterances (host-side P.862 DSP).

    Args:
        fs: sampling frequency (8000 for narrow-band, 16000 for wide-band).
        mode: 'nb' (narrow-band) or 'wb' (wide-band; requires fs=16000).
        pesq_fn: optional scorer override ``(ref, deg, fs, mode) -> float``;
            defaults to the ``pesq`` C binding when installed, else the
            in-repo P.862 engine.
    """

    is_differentiable = False
    higher_is_better = True
    __jit_unsafe__ = True  # per-utterance host DSP

    def __init__(self, fs: int, mode: str, pesq_fn: Optional[Callable] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if fs not in (8000, 16000):
            raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
        self.fs = fs
        if mode not in ("wb", "nb"):
            raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
        if mode == "wb" and fs == 8000:
            raise ValueError("Wide-band PESQ ('wb') requires fs=16000")
        self.mode = mode
        self.pesq_fn = pesq_fn

        self.add_state("sum_pesq", default=0.0, dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")

    def _update(self, preds: Tensor, target: Tensor) -> None:
        scores = perceptual_evaluation_speech_quality(preds, target, self.fs, self.mode, self.pesq_fn, device=self.device)
        self.sum_pesq = self.sum_pesq + _tree_sum(scores.reshape(-1))
        self.total = self.total + scores.numel()

    def _compute(self) -> Tensor:
        return self.sum_pesq / self.total
