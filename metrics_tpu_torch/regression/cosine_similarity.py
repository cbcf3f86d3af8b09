"""Modular CosineSimilarity.

Counterpart of ``metrics_tpu/regression/cosine_similarity.py``. For
``reduction="sum"``/``"mean"`` the per-row similarities are reduced by a
plain sum, so a running float32 sum and an int32 row count are an exact,
fixed-shape state. ``reduction="none"`` returns per-row values and keeps
the rows in list states, as ``exact=True`` does for every reduction.
"""
from typing import Any, Optional

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.cosine_similarity import (
    _cosine_similarity_compute,
    _cosine_similarity_update,
)
from metrics_tpu_torch.sketches.compat import register_exact_list_states, warn_exact_buffer
from metrics_tpu_torch.utils.data import _tree_sum, dim_zero_cat

Tensor = torch.Tensor


class CosineSimilarity(Metric):
    """Computes cosine similarity between predictions and targets.

    Example:
        >>> import torch
        >>> target = torch.tensor([[0., 1.], [1., 1.]])
        >>> preds = torch.tensor([[0., 1.], [0., 1.]])
        >>> cosine_similarity = CosineSimilarity(reduction='mean', device="cpu")
        >>> cosine_similarity(preds, target)
        tensor(0.8536)
    """

    is_differentiable = True
    higher_is_better = True
    __jit_unsafe__ = False  # the streaming default has a fixed-shape update
    __exact_mode_attr__ = "_exact"

    def __init__(self, reduction: Optional[str] = "sum", exact: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        allowed_reduction = ("sum", "mean", "none", None)
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.reduction = reduction
        self._exact = bool(exact) or reduction in ("none", None)
        if self._exact:
            register_exact_list_states(self, ("preds", "target"))
            if exact:
                warn_exact_buffer("CosineSimilarity")
        else:
            self.add_state("sim_sum", default=0.0, dist_reduce_fx="sum")
            self.add_state("total", default=0, dist_reduce_fx="sum")

    def _update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _cosine_similarity_update(preds, target)
        if self._exact:
            self.preds = self.preds + [preds]
            self.target = self.target + [target]
            return
        sim = _cosine_similarity_compute(preds, target, None).reshape(-1)
        self.sim_sum = self.sim_sum + _tree_sum(sim)
        self.total = self.total + sim.shape[0]

    def _compute(self) -> Tensor:
        if self._exact:
            return _cosine_similarity_compute(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.reduction)
        if self.reduction == "mean":
            return self.sim_sum / torch.clamp(self.total.to(torch.float32), min=1.0)
        return self.sim_sum
