"""Precision and recall.

Counterpart of ``metrics_tpu/functional/classification/precision_recall.py``,
with the macro class removal as an ignore mask, as in the JAX package.
"""
from typing import Any, Optional, Tuple

import torch

from metrics_tpu_torch.functional.classification.stat_scores import (
    _check_avg_arguments,
    _reduce_stat_scores,
    _stat_scores_update,
)
from metrics_tpu_torch.utils.data import _as_tensor
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod

Tensor = torch.Tensor


def _mask_macro_none(
    numerator: Tensor,
    denominator: Tensor,
    tp: Tensor,
    fp: Tensor,
    fn: Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
) -> Tuple[Tensor, Tensor]:
    """Shared absent-class masking for macro / none averaging."""
    numerator = numerator.to(torch.float32)
    denominator = denominator.to(torch.float32)
    if average == AverageMethod.MACRO and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        cond = (tp + fp + fn) == 0
        numerator = torch.where(cond, 0.0, numerator)
        denominator = torch.where(cond, -1.0, denominator)
    if average == AverageMethod.NONE and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        cond = (tp | fn | fp) == 0
        numerator = torch.where(cond, -1.0, numerator)
        denominator = torch.where(cond, -1.0, denominator)
    return numerator, denominator


def _precision_compute(
    tp: Tensor,
    fp: Tensor,
    fn: Tensor,
    average: str,
    mdmc_average: Optional[str],
) -> Tensor:
    numerator, denominator = _mask_macro_none(tp, tp + fp, tp, fp, fn, average, mdmc_average)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else (tp + fn),
        average=average,
        mdmc_average=mdmc_average,
    )


def _recall_compute(
    tp: Tensor,
    fp: Tensor,
    fn: Tensor,
    average: str,
    mdmc_average: Optional[str],
) -> Tensor:
    numerator, denominator = _mask_macro_none(tp, tp + fn, tp, fp, fn, average, mdmc_average)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else (tp + fn),
        average=average,
        mdmc_average=mdmc_average,
    )


def _precision_recall_stats(
    preds: Any,
    target: Any,
    average: str,
    mdmc_average: Optional[str],
    ignore_index: Optional[int],
    num_classes: Optional[int],
    threshold: float,
    top_k: Optional[int],
    multiclass: Optional[bool],
    device: Optional[Any],
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Validated arguments, then the counts of one batch."""
    _check_avg_arguments(average, mdmc_average, num_classes, ignore_index)
    reduce = "macro" if average in ("weighted", "none", None) else average
    return _stat_scores_update(
        _as_tensor(preds, device),
        _as_tensor(target, device),
        reduce=reduce,
        mdmc_reduce=mdmc_average,
        threshold=threshold,
        num_classes=num_classes,
        top_k=top_k,
        multiclass=multiclass,
        ignore_index=ignore_index,
    )


def precision(
    preds: Any,
    target: Any,
    average: str = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
    device: Optional[Any] = None,
) -> Tensor:
    """Precision of one batch. Tensors are counted where they lie; numpy
    inputs go to ``device`` (the card unless ``device="cpu"``).

    Example:
        >>> import torch
        >>> preds  = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> precision(preds, target, average='macro', num_classes=3)
        tensor(0.1667)
    """
    tp, fp, _, fn = _precision_recall_stats(
        preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass, device
    )
    return _precision_compute(tp, fp, fn, average, mdmc_average)


def recall(
    preds: Any,
    target: Any,
    average: str = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
    device: Optional[Any] = None,
) -> Tensor:
    """Recall of one batch (inputs as :func:`precision`).

    Example:
        >>> import torch
        >>> preds  = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> recall(preds, target, average='macro', num_classes=3)
        tensor(0.3333)
    """
    tp, fp, _, fn = _precision_recall_stats(
        preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass, device
    )
    return _recall_compute(tp, fp, fn, average, mdmc_average)


def precision_recall(
    preds: Any,
    target: Any,
    average: str = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
    device: Optional[Any] = None,
) -> Tuple[Tensor, Tensor]:
    """Precision and recall from one count of the batch.

    Example:
        >>> import torch
        >>> preds  = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> precision_recall(preds, target, average='macro', num_classes=3)
        (tensor(0.1667), tensor(0.3333))
    """
    tp, fp, _, fn = _precision_recall_stats(
        preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass, device
    )
    return (
        _precision_compute(tp, fp, fn, average, mdmc_average),
        _recall_compute(tp, fp, fn, average, mdmc_average),
    )
