"""Modular PermutationInvariantTraining.

Counterpart of ``metrics_tpu/audio/pit.py``: the mean of the best
permutation's metric, a float32 sum and an int32 count on the metric's
device. Up to six speakers an update runs on the device with no host read;
past six it makes the Hungarian solver's one read (see
:mod:`metrics_tpu_torch.functional.audio.pit`).
"""
from typing import Any, Callable

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.audio.pit import permutation_invariant_training
from metrics_tpu_torch.utils.data import _tree_sum

Tensor = torch.Tensor

#: keyword arguments that go to ``Metric`` rather than to ``metric_func``
_BASE_KWARGS = ("device", "dist_sync_on_step", "process_group", "dist_sync_fn", "compute_on_step")


class PermutationInvariantTraining(Metric):
    """Mean of a pairwise metric evaluated under the best speaker permutation.

    Args:
        metric_func: batched pairwise metric,
            ``metric_func(preds[:, j], target[:, i], **kwargs) -> [batch]``.
        eval_func: ``"max"`` (higher better) or ``"min"``.
        kwargs: the base metric's arguments (``device`` and the sync
            arguments); the others are forwarded to ``metric_func``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional.audio.sdr import scale_invariant_signal_distortion_ratio
        >>> preds = torch.tensor([[[-0.0579,  0.3560, -0.9604], [-0.1719,  0.3205,  0.2951]]])
        >>> target = torch.tensor([[[ 1.0958, -0.1648,  0.5228], [-0.4100,  1.1942, -0.5103]]])
        >>> pit = PermutationInvariantTraining(scale_invariant_signal_distortion_ratio, 'max', device="cpu")
        >>> pit(preds, target)
        tensor(-5.1091)
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(self, metric_func: Callable, eval_func: str = "max", **kwargs: Any) -> None:
        base_kwargs = {k: kwargs.pop(k) for k in list(kwargs) if k in _BASE_KWARGS}
        super().__init__(**base_kwargs)
        if eval_func not in ("max", "min"):
            raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
        self.metric_func = metric_func
        self.eval_func = eval_func
        self.kwargs = kwargs
        self.add_state("sum_pit_metric", default=0.0, dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")

    def _update(self, preds: Tensor, target: Tensor) -> None:
        pit_metric = permutation_invariant_training(preds, target, self.metric_func, self.eval_func, **self.kwargs)[0]
        self.sum_pit_metric = self.sum_pit_metric + _tree_sum(pit_metric.reshape(-1))
        self.total = self.total + pit_metric.numel()

    def _compute(self) -> Tensor:
        return self.sum_pit_metric / self.total
