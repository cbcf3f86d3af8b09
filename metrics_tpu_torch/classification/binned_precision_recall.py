"""Binned (fixed-threshold) precision-recall curve, average precision and
recall at a fixed precision, in constant memory.

Counterpart of ``metrics_tpu/classification/binned_precision_recall.py``:
``[num_classes, num_thresholds]`` TP/FP/FN sums with a ``"sum"`` reducer.
Each prediction is placed into its threshold bin (the last threshold at
or below it, ``searchsorted(side="right") - 1``), the per-bin counts of
positives and of all samples are summed, and a reversed cumulative sum
gives the ``pred >= threshold`` counts. On the card the two per-bin
counts are two ``bincount_i32`` launches (K1's count form) over the
``[N * C]`` (sample, class) ids ``c * T + bin`` into ``C * T`` bins: one over
every id, one over the ids of positive targets. A sample below every
threshold (``bin = -1``), and a negative in the second count, take the id
-1, which K1 drops (the JAX package adds them with weight 0 into bin 0;
the counts are the same). Integer counts are exact in any order, so K1's
order-free atomics serve; its float form, ``segment_sum_f32`` over
``[N * C, 2]`` rows of (target, 1), gives the same counts but adds each bin
in row order, which at 100,000 bins took about 100 times as long on an
NVIDIA H100 80GB HBM3, 700.00 W (``chip_smoke.py``'s kernels line). Integer ``thresholds`` are
``linspace_f32`` values, the JAX package's float32 ``jnp.linspace``.
"""
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.average_precision import (
    _average_precision_compute_with_precision_recall,
)
from metrics_tpu_torch.utils.data import _bincount, amax_ieee, linspace_f32, to_onehot

Tensor = torch.Tensor

#: the reference's epsilon of the precision and recall ratios
METRIC_EPS = 1e-6


def _recall_at_precision(
    precision: Tensor,
    recall: Tensor,
    thresholds: Tensor,
    min_precision: float,
) -> Tuple[Tensor, Tensor]:
    """The highest recall with precision >= ``min_precision`` (ties to the
    highest precision, then the highest threshold), and its threshold;
    (0, 1e6) when no point qualifies."""
    n = thresholds.shape[0]
    precision, recall = precision[:n], recall[:n]
    valid = precision >= min_precision
    neg_inf = torch.full_like(recall, -torch.inf)
    max_recall = amax_ieee(torch.where(valid, recall, neg_inf))
    cand = valid & (recall == max_recall)
    cand = cand & (precision == amax_ieee(torch.where(cand, precision, neg_inf)))
    best_threshold = amax_ieee(torch.where(cand, thresholds, torch.full_like(thresholds, -torch.inf)))
    max_recall = torch.where(torch.isfinite(max_recall), max_recall, 0.0)
    best_threshold = torch.where(max_recall == 0.0, torch.full_like(best_threshold, 1e6), best_threshold)
    return max_recall, best_threshold


class BinnedPrecisionRecallCurve(Metric):
    """Precision-recall pairs at fixed thresholds, in constant memory.

    Example:
        >>> import torch
        >>> pred = torch.tensor([0.0, 0.1, 0.8, 0.4])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> pr_curve = BinnedPrecisionRecallCurve(num_classes=1, thresholds=5, device="cpu")
        >>> precision, recall, thresholds = pr_curve(pred, target)
        >>> precision
        tensor([0.5000, 0.5000, 1.0000, 1.0000, 1.0000, 1.0000])
        >>> recall
        tensor([1.0000, 0.5000, 0.5000, 0.5000, 0.0000, 0.0000])
        >>> thresholds
        tensor([0.0000, 0.2500, 0.5000, 0.7500, 1.0000])
    """

    is_differentiable = False

    def __init__(
        self,
        num_classes: int,
        thresholds: Union[int, Tensor, List[float], np.ndarray, None] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        if isinstance(thresholds, int):
            self.num_thresholds = thresholds
            self.thresholds = linspace_f32(thresholds, device=self.device)
        elif thresholds is not None:
            if not isinstance(thresholds, (list, Tensor, np.ndarray)):
                raise ValueError("Expected argument `thresholds` to either be an integer, list of floats or a tensor")
            thresholds = torch.as_tensor(thresholds, dtype=torch.float32, device=self.device)
            if bool((thresholds[1:] < thresholds[:-1]).any()):
                raise ValueError("Expected argument `thresholds` to be sorted in increasing order")
            self.num_thresholds = thresholds.numel()
            self.thresholds = thresholds
        else:
            raise ValueError("Expected argument `thresholds` to either be an integer, list of floats or a tensor")

        for name in ("TPs", "FPs", "FNs"):
            self.add_state(
                name=name,
                default=torch.zeros((num_classes, self.num_thresholds), dtype=torch.float32),
                dist_reduce_fx="sum",
            )

    def _update(self, preds: Tensor, target: Tensor) -> None:
        if preds.ndim == target.ndim == 1:
            preds = preds.reshape(-1, 1)
            target = target.reshape(-1, 1)
        if preds.ndim == target.ndim + 1:
            target = to_onehot(target, num_classes=self.num_classes)

        positive = target == 1  # [N, C]
        preds = preds.to(torch.float32).contiguous()
        n_cls, n_thr = preds.shape[1], self.num_thresholds

        # the bin of the largest threshold <= pred; -1 below all thresholds
        bins = torch.searchsorted(self.thresholds, preds, right=True, out_int32=True) - 1
        cols = torch.arange(n_cls, dtype=torch.int32, device=preds.device) * n_thr
        ids = torch.where(bins >= 0, cols + bins, -1)
        all_per_bin = _bincount(ids.reshape(-1), n_cls * n_thr).reshape(n_cls, n_thr).to(torch.float32)
        pos_ids = torch.where(positive, ids, -1).reshape(-1)
        pos_per_bin = _bincount(pos_ids, n_cls * n_thr).reshape(n_cls, n_thr).to(torch.float32)

        # pred >= thresholds[t]  <=>  bin >= t: a reversed cumulative sum
        tp = torch.cumsum(pos_per_bin.flip(1), dim=1).flip(1)
        pred_pos = torch.cumsum(all_per_bin.flip(1), dim=1).flip(1)
        total_pos = torch.sum(positive, dim=0, dtype=torch.float32)[:, None]

        self.TPs = self.TPs + tp
        self.FPs = self.FPs + (pred_pos - tp)
        self.FNs = self.FNs + (total_pos - tp)

    def _compute(self) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
        precisions = (self.TPs + METRIC_EPS) / (self.TPs + self.FPs + METRIC_EPS)
        recalls = self.TPs / (self.TPs + self.FNs + METRIC_EPS)

        # the curve ends at precision 1, recall 0
        precisions = torch.cat([precisions, precisions.new_ones((self.num_classes, 1))], dim=1)
        recalls = torch.cat([recalls, recalls.new_zeros((self.num_classes, 1))], dim=1)
        if self.num_classes == 1:
            return precisions[0, :], recalls[0, :], self.thresholds
        return list(precisions), list(recalls), [self.thresholds for _ in range(self.num_classes)]


class BinnedAveragePrecision(BinnedPrecisionRecallCurve):
    """Average precision at fixed thresholds, in constant memory.

    Example:
        >>> import torch
        >>> pred = torch.tensor([0.0, 1.0, 2.0, 3.0]) / 3
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> average_precision = BinnedAveragePrecision(num_classes=1, thresholds=10, device="cpu")
        >>> average_precision(pred, target)
        tensor(1.0000)
    """

    def _compute(self) -> Union[List[Tensor], Tensor]:
        precisions, recalls, _ = super()._compute()
        return _average_precision_compute_with_precision_recall(precisions, recalls, self.num_classes, average=None)


class BinnedRecallAtFixedPrecision(BinnedPrecisionRecallCurve):
    """The highest recall at a minimum precision, at fixed thresholds, and
    its threshold.

    Example:
        >>> import torch
        >>> pred = torch.tensor([0.0, 0.2, 0.5, 0.8])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> metric = BinnedRecallAtFixedPrecision(num_classes=1, thresholds=10, min_precision=0.5, device="cpu")
        >>> metric(pred, target)
        (tensor(1.0000), tensor(0.1111))
    """

    def __init__(
        self,
        num_classes: int,
        min_precision: float,
        thresholds: Union[int, Tensor, List[float], np.ndarray, None] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes=num_classes, thresholds=thresholds, **kwargs)
        self.min_precision = min_precision

    def _compute(self) -> Tuple[Tensor, Tensor]:
        precisions, recalls, thresholds = super()._compute()
        if self.num_classes == 1:
            return _recall_at_precision(precisions, recalls, thresholds, self.min_precision)
        pairs = [_recall_at_precision(p, r, t, self.min_precision) for p, r, t in zip(precisions, recalls, thresholds)]
        return torch.stack([r for r, _ in pairs]), torch.stack([t for _, t in pairs])
