"""Modular MatchErrorRate.

Counterpart of ``metrics_tpu/text/mer.py``: float32 sum states on the
metric's device, one host-to-device copy per update.
"""
from typing import Any, List, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text.mer import _mer_compute, _mer_update

Tensor = torch.Tensor


class MatchErrorRate(Metric):
    """Match error rate of transcriptions vs references; 0 is perfect.

    Example:
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> metric = MatchErrorRate(device="cpu")
        >>> metric(preds, target)
        tensor(0.4444)
    """

    is_differentiable = False
    higher_is_better = False
    __jit_unsafe__ = True  # update consumes Python strings

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", default=0.0, dist_reduce_fx="sum")
        self.add_state("total", default=0.0, dist_reduce_fx="sum")

    def _update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        errors, total = _mer_update(preds, target, self.device)
        self.errors = self.errors + errors
        self.total = self.total + total

    def _compute(self) -> Tensor:
        return _mer_compute(self.errors, self.total)
