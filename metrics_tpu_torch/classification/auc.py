"""Modular AUC: the area under an (x, y) curve.

Counterpart of ``metrics_tpu/classification/auc.py``: list states of the
points, the trapezoid at ``compute()``.
"""
from typing import Any

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.auc import _auc_compute, _auc_update
from metrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class AUC(Metric):
    """Area under a curve given by (x, y) points.

    Example:
        >>> import torch
        >>> auc = AUC(device="cpu")
        >>> auc(torch.tensor([0., 1., 2., 3.]), torch.tensor([0., 1., 2., 2.]))
        tensor(4.)
    """

    is_differentiable = False

    def __init__(self, reorder: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.reorder = reorder
        self.add_state("x", default=[], dist_reduce_fx="cat")
        self.add_state("y", default=[], dist_reduce_fx="cat")

    def _update(self, x: Tensor, y: Tensor) -> None:
        x, y = _auc_update(x, y)
        self.x.append(x)
        self.y.append(y)

    def _compute(self) -> Tensor:
        return _auc_compute(dim_zero_cat(self.x), dim_zero_cat(self.y), reorder=self.reorder)
