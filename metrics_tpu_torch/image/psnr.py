"""Modular PeakSignalNoiseRatio.

Counterpart of ``metrics_tpu/image/psnr.py``. With ``dim=None`` (the
default) every state is a sum, min or max leaf, so the metric slices
(``SlicedMetric``: the running ``min_target``/``max_target`` are what
reach K2, the segment max/min kernel) and windows. With ``dim=`` the
per-image errors are list (``"cat"``) states.
"""
from typing import Any, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.image.psnr import _psnr_compute, _psnr_update
from metrics_tpu_torch.utils.data import _widen_half, _x64_off, amax_ieee, amin_ieee, maximum_ieee, minimum_ieee
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


class PeakSignalNoiseRatio(Metric):
    """Computes the peak signal-to-noise ratio.

    Example:
        >>> import torch
        >>> psnr = PeakSignalNoiseRatio(device="cpu")
        >>> preds = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> psnr(preds, target)
        tensor(2.5527)
    """

    is_differentiable = True
    higher_is_better = True
    __jit_unsafe__ = False

    def __init__(
        self,
        data_range: Optional[float] = None,
        base: float = 10.0,
        reduction: str = "elementwise_mean",
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)

        if dim is None and reduction != "elementwise_mean":
            rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")

        if dim is None:
            self.add_state("sum_squared_error", default=0.0, dist_reduce_fx="sum")
            self.add_state("total", default=0, dist_reduce_fx="sum")
        else:
            self.add_state("sum_squared_error", default=[], dist_reduce_fx="cat")
            self.add_state("total", default=[], dist_reduce_fx="cat")

        if data_range is None:
            if dim is not None:
                raise ValueError("The `data_range` must be given when `dim` is not None.")
            self.data_range = None
            self.add_state("min_target", default=0.0, dist_reduce_fx="min")
            self.add_state("max_target", default=0.0, dist_reduce_fx="max")
        else:
            self.add_state("data_range", default=float(data_range), dist_reduce_fx="mean")
        self.base = base
        self.reduction = reduction
        self.dim = tuple(dim) if isinstance(dim, Sequence) else dim

    def _update(self, preds: Tensor, target: Tensor) -> None:
        sum_squared_error, n_obs = _psnr_update(preds, target, dim=self.dim)
        if self.dim is None:
            if self.data_range is None:
                wide = _widen_half(_x64_off(target))  # the values the squared error sees
                self.min_target = minimum_ieee(amin_ieee(wide), self.min_target)
                self.max_target = maximum_ieee(amax_ieee(wide), self.max_target)
            self.sum_squared_error = self.sum_squared_error + sum_squared_error
            self.total = self.total + n_obs
        else:
            self.sum_squared_error.append(sum_squared_error)
            self.total.append(n_obs)

    def _compute(self) -> Tensor:
        data_range = self.data_range if self.data_range is not None else self.max_target - self.min_target
        if self.dim is None:
            sum_squared_error = self.sum_squared_error
            total = self.total
        else:
            sum_squared_error = torch.cat([v.flatten() for v in self.sum_squared_error])
            total = torch.cat([v.flatten() for v in self.total])
        return _psnr_compute(sum_squared_error, total, data_range, base=self.base, reduction=self.reduction)
