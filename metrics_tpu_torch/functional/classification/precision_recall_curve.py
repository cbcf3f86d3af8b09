"""The sorted-curve kernel shared by the exact curve family.

Counterpart of the part of
``metrics_tpu/functional/classification/precision_recall_curve.py`` that
ROC and AUROC need: ``_binary_clf_curve`` (sort by descending score,
dedupe thresholds, cumulate) and ``_precision_recall_curve_update`` (the
input canonicalisation). The outputs have data-dependent shapes (one point
per distinct score), so these run eagerly; finding the distinct scores
reads the card once. ``precision_recall_curve`` itself waits for its slice
(ROADMAP.md, queue A: 'regression and breadth').
"""
from typing import Any, Optional, Sequence, Tuple

import torch

from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _binary_clf_curve(
    preds: Tensor,
    target: Tensor,
    sample_weights: Optional[Sequence] = None,
    pos_label: int = 1,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Cumulative false and true positives at each distinct threshold, and
    the thresholds, in descending score order (sklearn's construction). The
    sort is stable, as ``jnp.argsort`` is: tied scores keep their order."""
    if sample_weights is not None and not isinstance(sample_weights, Tensor):
        sample_weights = torch.as_tensor(sample_weights, dtype=torch.float32, device=preds.device)

    if preds.ndim > target.ndim:
        preds = preds[:, 0]
    desc_score_indices = torch.sort(-preds, stable=True).indices

    preds = preds[desc_score_indices]
    target = target[desc_score_indices]
    weight: Any = sample_weights[desc_score_indices] if sample_weights is not None else 1.0

    distinct_value_indices = torch.nonzero(preds[1:] - preds[:-1]).reshape(-1)
    last = torch.tensor([target.shape[0] - 1], device=preds.device)
    threshold_idxs = torch.cat([distinct_value_indices, last])
    target = (target == pos_label).to(torch.int32)
    tps = torch.cumsum(target * weight, dim=0)[threshold_idxs]

    if sample_weights is not None:
        fps = torch.cumsum((1 - target) * weight, dim=0)[threshold_idxs]
    else:
        fps = 1 + threshold_idxs - tps

    return fps, tps, preds[threshold_idxs]


def _precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
) -> Tuple[Tensor, Tensor, int, Optional[int]]:
    """Canonicalise curve inputs to flat binary or ``(N, C)`` layouts."""
    if preds.ndim == target.ndim:
        if pos_label is None:
            pos_label = 1
        if num_classes is not None and num_classes != 1:
            # multilabel problem
            if num_classes != preds.shape[1]:
                raise ValueError(
                    f"Argument `num_classes` was set to {num_classes} in"
                    f" metric `precision_recall_curve` but detected {preds.shape[1]}"
                    " number of classes from predictions"
                )
            preds = preds.transpose(0, 1).reshape(num_classes, -1).T
            target = target.transpose(0, 1).reshape(num_classes, -1).T
        else:
            preds = preds.flatten()
            target = target.flatten()
            num_classes = 1
    elif preds.ndim == target.ndim + 1:
        if pos_label is not None:
            rank_zero_warn(
                "Argument `pos_label` should be `None` when running"
                f" multiclass precision recall curve. Got {pos_label}"
            )
        if num_classes != preds.shape[1]:
            raise ValueError(
                f"Argument `num_classes` was set to {num_classes} in"
                f" metric `precision_recall_curve` but detected {preds.shape[1]}"
                " number of classes from predictions"
            )
        preds = preds.transpose(0, 1).reshape(num_classes, -1).T
        target = target.flatten()
    else:
        raise ValueError("preds and target must have same number of dimensions, or one additional dimension for preds")

    return preds, target, num_classes, pos_label
