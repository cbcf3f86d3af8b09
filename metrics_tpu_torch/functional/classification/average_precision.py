"""Average precision: the area under the precision-recall curve by its steps.

Counterpart of ``metrics_tpu/functional/classification/average_precision.py``.
Each class is one exact binary curve (``precision_recall_curve.py``), so
the outputs run eagerly. The macro and weighted averages read the card
once more, to find the classes whose score is NaN; the weighted average's
supports of integer labels are one ``bincount_i32`` launch on the card
(K1, through ``utils/data._bincount``).
"""
from typing import Any, List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    _precision_recall_curve_compute,
    _precision_recall_curve_update,
)
from metrics_tpu_torch.utils.data import _as_tensor, _bincount
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _average_precision_update(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
) -> Tuple[Tensor, Tensor, int, Optional[int]]:
    preds, target, num_classes, pos_label = _precision_recall_curve_update(preds, target, num_classes, pos_label)
    if average == "micro":
        if preds.ndim == target.ndim:
            # each element of the label indicator matrix is a label
            preds = preds.flatten()
            target = target.flatten()
            num_classes = 1
        else:
            raise ValueError("Cannot use `micro` average with multi-class input")
    return preds, target, num_classes, pos_label


def _average_precision_compute_with_precision_recall(
    precision: Union[Tensor, List[Tensor]],
    recall: Union[Tensor, List[Tensor]],
    num_classes: int,
    average: Optional[str] = "macro",
    weights: Optional[Tensor] = None,
) -> Union[List[Tensor], Tensor]:
    if num_classes == 1:
        return -torch.sum((recall[1:] - recall[:-1]) * precision[:-1])

    res = [-torch.sum((r[1:] - r[:-1]) * p[:-1]) for p, r in zip(precision, recall)]

    if average in ("macro", "weighted"):
        res = torch.stack(res)
        nan = torch.isnan(res)
        if bool(nan.any()):
            rank_zero_warn(
                "Average precision score for one or more classes was `nan`. Ignoring these classes in average",
                UserWarning,
            )
        if average == "macro":
            return torch.mean(res[~nan])
        zero = torch.zeros_like(res)
        weights = torch.where(nan, zero, weights)
        return torch.sum(torch.where(nan, zero, res) * weights / torch.sum(weights))
    if average is None or average == "none":
        return res
    allowed_average = ("micro", "macro", "weighted", "none", None)
    raise ValueError(f"Expected argument `average` to be one of {allowed_average} but got {average}")


def _average_precision_compute(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    sample_weights: Optional[Sequence] = None,
) -> Union[List[Tensor], Tensor]:
    precision, recall, _ = _precision_recall_curve_compute(preds, target, num_classes, pos_label, sample_weights)
    weights = None
    if average == "weighted":
        if preds.ndim == target.ndim and target.ndim > 1:
            weights = torch.sum(target, dim=0).to(torch.float32)
        else:
            weights = _bincount(target.to(torch.int32), minlength=num_classes).to(torch.float32)
        weights = weights / torch.sum(weights)
    return _average_precision_compute_with_precision_recall(precision, recall, num_classes, average, weights)


def average_precision(
    preds: Any,
    target: Any,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    sample_weights: Optional[Sequence] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Union[List[Tensor], Tensor]:
    """Average precision score. Host inputs go to ``device`` (the card
    unless ``"cpu"``); tensors stay where they are.

    Example:
        >>> import torch
        >>> pred = torch.tensor([0., 1., 2., 3.])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> average_precision(pred, target, pos_label=1)
        tensor(1.)
        >>> pred = torch.tensor([[0.75, 0.05, 0.05, 0.05, 0.05],
        ...                      [0.05, 0.75, 0.05, 0.05, 0.05],
        ...                      [0.05, 0.05, 0.75, 0.05, 0.05],
        ...                      [0.05, 0.05, 0.05, 0.75, 0.05]])
        >>> target = torch.tensor([0, 1, 3, 2])
        >>> average_precision(pred, target, num_classes=5, average=None)
        [tensor(1.), tensor(1.), tensor(0.2500), tensor(0.2500), tensor(nan)]
    """
    preds, target = _as_tensor(preds, device), _as_tensor(target, device)
    preds, target, num_classes, pos_label = _average_precision_update(preds, target, num_classes, pos_label, average)
    return _average_precision_compute(preds, target, num_classes, pos_label, average, sample_weights)
