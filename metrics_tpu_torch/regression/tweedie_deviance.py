"""Modular TweedieDevianceScore.

Counterpart of ``metrics_tpu/regression/tweedie_deviance.py``: a float32
deviance sum and an int32 count, both sum-reduced.
"""
from typing import Any

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.tweedie_deviance import (
    _tweedie_deviance_score_compute,
    _tweedie_deviance_score_update,
)

Tensor = torch.Tensor


class TweedieDevianceScore(Metric):
    """Computes the Tweedie deviance score.

    Example:
        >>> import torch
        >>> targets = torch.tensor([1.0, 2.0, 3.0, 4.0])
        >>> preds = torch.tensor([4.0, 3.0, 2.0, 1.0])
        >>> deviance_score = TweedieDevianceScore(power=2, device="cpu")
        >>> deviance_score(preds, targets)
        tensor(1.2083)
    """

    is_differentiable = True
    higher_is_better = False

    def __init__(self, power: float = 0.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if 0 < power < 1:
            raise ValueError(f"Deviance Score is not defined for power={power}.")
        self.power = power
        self.add_state("sum_deviance_score", default=0.0, dist_reduce_fx="sum")
        self.add_state("num_observations", default=0, dist_reduce_fx="sum")

    def _update(self, preds: Tensor, targets: Tensor) -> None:
        sum_deviance_score, num_observations = _tweedie_deviance_score_update(preds, targets, self.power)
        self.sum_deviance_score = self.sum_deviance_score + sum_deviance_score
        self.num_observations = self.num_observations + num_observations

    def _compute(self) -> Tensor:
        return _tweedie_deviance_score_compute(self.sum_deviance_score, self.num_observations)
