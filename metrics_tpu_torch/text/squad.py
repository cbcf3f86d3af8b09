"""Modular SQuAD metric.

Counterpart of ``metrics_tpu/text/squad.py``: float32 ``f1_score`` and
``exact_match`` sums and an int32 ``total`` on the metric's device, one
host-to-device copy per update.
"""
from typing import Any, Dict

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text.squad import (
    PREDS_TYPE,
    TARGETS_TYPE,
    _squad_compute,
    _squad_input_check,
    _squad_update,
)

Tensor = torch.Tensor


class SQuAD(Metric):
    """SQuAD v1 exact-match + token-F1 over accumulated question/answer pairs.

    Example:
        >>> preds = [{"prediction_text": "1976", "id": "56e10a3be3433e1400422b22"}]
        >>> target = [{"answers": {"answer_start": [97], "text": ["1976"]}, "id": "56e10a3be3433e1400422b22"}]
        >>> metric = SQuAD(device="cpu")
        >>> {k: float(v) for k, v in metric(preds, target).items()}
        {'exact_match': 100.0, 'f1': 100.0}
    """

    is_differentiable = False
    higher_is_better = True
    __jit_unsafe__ = True  # update consumes Python dicts of strings

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("f1_score", default=0.0, dist_reduce_fx="sum")
        self.add_state("exact_match", default=0.0, dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")

    def _update(self, preds: PREDS_TYPE, target: TARGETS_TYPE) -> None:
        preds_dict, target_dict = _squad_input_check(preds, target)
        f1_score, exact_match, total = _squad_update(preds_dict, target_dict, self.device)
        self.f1_score = self.f1_score + f1_score
        self.exact_match = self.exact_match + exact_match
        self.total = self.total + total

    def _compute(self) -> Dict[str, Tensor]:
        return _squad_compute(self.f1_score, self.exact_match, self.total)
