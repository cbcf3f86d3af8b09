"""Modular WordInfoPreserved.

Counterpart of ``metrics_tpu/text/wip.py``: float32 sum states on the
metric's device, one host-to-device copy per update.
"""
from typing import Any, List, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text.wip import _wip_compute, _wip_update

Tensor = torch.Tensor


class WordInfoPreserved(Metric):
    """Word information preserved of transcriptions vs references; 1 is perfect.

    Example:
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> metric = WordInfoPreserved(device="cpu")
        >>> metric(preds, target)
        tensor(0.3472)
    """

    is_differentiable = False
    higher_is_better = True
    __jit_unsafe__ = True  # update consumes Python strings

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", default=0.0, dist_reduce_fx="sum")
        self.add_state("target_total", default=0.0, dist_reduce_fx="sum")
        self.add_state("preds_total", default=0.0, dist_reduce_fx="sum")

    def _update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        errors, target_total, preds_total = _wip_update(preds, target, self.device)
        self.errors = self.errors + errors
        self.target_total = self.target_total + target_total
        self.preds_total = self.preds_total + preds_total

    def _compute(self) -> Tensor:
        return _wip_compute(self.errors, self.target_total, self.preds_total)
