"""Modular WordInfoLost.

Counterpart of ``metrics_tpu/text/wil.py``: float32 sum states on the
metric's device, one host-to-device copy per update.
"""
from typing import Any, List, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text.wil import _wil_compute, _wil_update

Tensor = torch.Tensor


class WordInfoLost(Metric):
    """Word information lost of transcriptions vs references; 0 is perfect.

    Example:
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> metric = WordInfoLost(device="cpu")
        >>> metric(preds, target)
        tensor(0.6528)
    """

    is_differentiable = False
    higher_is_better = False
    __jit_unsafe__ = True  # update consumes Python strings

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", default=0.0, dist_reduce_fx="sum")
        self.add_state("target_total", default=0.0, dist_reduce_fx="sum")
        self.add_state("preds_total", default=0.0, dist_reduce_fx="sum")

    def _update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        errors, target_total, preds_total = _wil_update(preds, target, self.device)
        self.errors = self.errors + errors
        self.target_total = self.target_total + target_total
        self.preds_total = self.preds_total + preds_total

    def _compute(self) -> Tensor:
        return _wil_compute(self.errors, self.target_total, self.preds_total)
