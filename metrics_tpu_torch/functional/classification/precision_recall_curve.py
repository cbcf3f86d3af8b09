"""Precision-recall curve, and the sorted-curve kernel of the exact curve family.

Counterpart of ``metrics_tpu/functional/classification/
precision_recall_curve.py``: ``_binary_clf_curve`` (sort by descending
score, dedupe thresholds, cumulate), ``_precision_recall_curve_update``
(the input canonicalisation) and ``precision_recall_curve``. The outputs
have data-dependent shapes (one point per distinct score), so these run
eagerly: each binary curve reads the card twice, once for its distinct
scores and once for the point where it reaches full recall. A multiclass
or multilabel curve is one binary curve per class, as in the JAX package.
"""
from typing import Any, List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.utils.data import _as_tensor
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


def _precision_recall_curve_compute_single_class(
    preds: Tensor,
    target: Tensor,
    pos_label: int,
    sample_weights: Optional[Sequence] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    fps, tps, thresholds = _binary_clf_curve(
        preds=preds, target=target, sample_weights=sample_weights, pos_label=pos_label
    )
    precision = tps / (tps + fps)
    recall = tps / tps[-1]

    # stop when full recall is attained (one host read); reverse so that
    # recall decreases
    last_ind = int(torch.argmax((tps == tps[-1]).to(torch.uint8)))
    precision = torch.cat([precision[: last_ind + 1].flip(0), precision.new_ones(1)])
    recall = torch.cat([recall[: last_ind + 1].flip(0), recall.new_zeros(1)])
    thresholds = thresholds[: last_ind + 1].flip(0)
    return precision, recall, thresholds


def _precision_recall_curve_compute_multi_class(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    sample_weights: Optional[Sequence] = None,
) -> Tuple[List[Tensor], List[Tensor], List[Tensor]]:
    precision, recall, thresholds = [], [], []
    for cls in range(num_classes):
        if target.ndim > 1:
            target_cls, pos_label = target[:, cls], 1
        else:
            target_cls, pos_label = target, cls
        res = precision_recall_curve(
            preds=preds[:, cls], target=target_cls, num_classes=1, pos_label=pos_label, sample_weights=sample_weights
        )
        precision.append(res[0])
        recall.append(res[1])
        thresholds.append(res[2])
    return precision, recall, thresholds


def _precision_recall_curve_compute(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    if num_classes == 1:
        if pos_label is None:
            pos_label = 1
        return _precision_recall_curve_compute_single_class(preds, target, pos_label, sample_weights)
    return _precision_recall_curve_compute_multi_class(preds, target, num_classes, sample_weights)


def precision_recall_curve(
    preds: Any,
    target: Any,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    """Precision-recall pairs at every distinct threshold. Host inputs go
    to ``device`` (the card unless ``"cpu"``); tensors stay where they are.

    Example:
        >>> import torch
        >>> pred = torch.tensor([0., 1., 2., 3.])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> precision, recall, thresholds = precision_recall_curve(pred, target, pos_label=1)
        >>> precision
        tensor([0.6667, 0.5000, 0.0000, 1.0000])
        >>> recall
        tensor([1.0000, 0.5000, 0.0000, 0.0000])
        >>> thresholds
        tensor([1., 2., 3.])
    """
    preds, target = _as_tensor(preds, device), _as_tensor(target, device)
    preds, target, num_classes, pos_label = _precision_recall_curve_update(preds, target, num_classes, pos_label)
    return _precision_recall_curve_compute(preds, target, num_classes, pos_label, sample_weights)
