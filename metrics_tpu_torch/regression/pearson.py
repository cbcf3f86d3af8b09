"""Modular PearsonCorrCoef: streaming moments with the parallel merge.

Counterpart of ``metrics_tpu/regression/pearson.py``. The six moment
states take no reducer (``dist_reduce_fx=None``): two processes' moments
are stacked (:meth:`PearsonCorrCoef.merge_states`) and ``compute`` merges
stacked moments with the exact parallel formula (``_final_aggregation``).
"""
from typing import Any, Dict

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.pearson import (
    _final_aggregation,
    _pearson_corrcoef_compute,
    _pearson_corrcoef_update,
)

Tensor = torch.Tensor

_MOMENTS = ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")


class PearsonCorrCoef(Metric):
    """Computes the Pearson correlation coefficient.

    Example:
        >>> import torch
        >>> target = torch.tensor([3., -0.5, 2., 7.])
        >>> preds = torch.tensor([2.5, 0.0, 2., 8.])
        >>> pearson = PearsonCorrCoef(device="cpu")
        >>> pearson(preds, target)
        tensor(0.9849)
    """

    is_differentiable = True
    higher_is_better = None  # both -1 and 1 are optimal

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        for name in _MOMENTS:
            self.add_state(name, default=0.0, dist_reduce_fx=None)

    def _update(self, preds: Tensor, target: Tensor) -> None:
        self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total = _pearson_corrcoef_update(
            preds, target, self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total
        )

    def _compute(self) -> Tensor:
        if self.mean_x.ndim == 1 and self.mean_x.shape[0] > 1:
            # moments of several processes, stacked: merge them
            var_x, var_y, corr_xy, n_total = _final_aggregation(
                self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total
            )
        else:
            var_x, var_y, corr_xy, n_total = self.var_x, self.var_y, self.corr_xy, self.n_total
        return _pearson_corrcoef_compute(var_x, var_y, corr_xy, n_total)

    def merge_states(self, a: Dict[str, Tensor], b: Dict[str, Tensor], counts: Any = None) -> Dict[str, Tensor]:
        """Stack the two sides' moments; ``compute`` merges them."""
        return {name: torch.cat([torch.atleast_1d(a[name]), torch.atleast_1d(b[name])]) for name in self._defaults}
