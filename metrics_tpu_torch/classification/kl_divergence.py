"""Modular KLDivergence.

Counterpart of ``metrics_tpu/classification/kl_divergence.py``: with
``reduction`` "mean" or "sum" a float32 sum state, otherwise a list of
per-row divergences; the row count is an int32 sum state.
"""
from typing import Any, Optional

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.kl_divergence import _kld_compute, _kld_update
from metrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class KLDivergence(Metric):
    """Computes the KL divergence between distributions p and q.

    Example:
        >>> import torch
        >>> p = torch.tensor([[0.36, 0.48, 0.16]])
        >>> q = torch.tensor([[1/3, 1/3, 1/3]])
        >>> kl_divergence = KLDivergence(device="cpu")
        >>> kl_divergence(p, q)
        tensor(0.0853)
    """

    is_differentiable = True
    higher_is_better = False
    __jit_unsafe__ = False

    def __init__(
        self,
        log_prob: bool = False,
        reduction: Optional[str] = "mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(log_prob, bool):
            raise TypeError(f"Expected argument `log_prob` to be bool but got {log_prob}")
        self.log_prob = log_prob
        allowed_reduction = ("mean", "sum", "none", None)
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.reduction = reduction
        if self.reduction in ("mean", "sum"):
            self.add_state("measures", default=torch.tensor(0.0), dist_reduce_fx="sum")
        else:
            self.add_state("measures", default=[], dist_reduce_fx="cat")
        self.add_state("total", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx="sum")

    def _update(self, p: Tensor, q: Tensor) -> None:
        measures, total = _kld_update(p, q, self.log_prob)
        if self.reduction is None or self.reduction == "none":
            self.measures.append(measures)
        else:
            self.measures = self.measures + torch.sum(measures)
        self.total = self.total + total

    def _compute(self) -> Tensor:
        measures = dim_zero_cat(self.measures) if isinstance(self.measures, list) else self.measures
        return _kld_compute(measures, self.total, self.reduction)
