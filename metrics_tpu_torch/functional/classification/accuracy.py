"""Accuracy, subset accuracy included.

Counterpart of ``metrics_tpu/functional/classification/accuracy.py``: the
macro class removal is an ignore mask (denominator -1) that
``_reduce_stat_scores`` drops, as in the JAX package. The input checks read
the card once per call: the mode check's value stats are handed on to the
formatter (``stats=``).
"""
from typing import Any, Dict, Optional, Tuple

import torch

from metrics_tpu_torch.functional.classification.stat_scores import _reduce_stat_scores, _stat_scores_update
from metrics_tpu_torch.utils.checks import _check_inputs_with_stats, _input_format_classification, _input_squeeze
from metrics_tpu_torch.utils.data import _as_tensor
from metrics_tpu_torch.utils.enums import AverageMethod, DataType, MDMCAverageMethod

Tensor = torch.Tensor


def _check_subset_validity(mode: DataType) -> bool:
    return mode in (DataType.MULTILABEL, DataType.MULTIDIM_MULTICLASS)


def _mode(
    preds: Tensor,
    target: Tensor,
    threshold: float,
    top_k: Optional[int],
    num_classes: Optional[int],
    multiclass: Optional[bool],
    ignore_index: Optional[int] = None,
) -> Tuple[DataType, Dict[str, int]]:
    """The input case, and the value stats read to deduce it (one host read),
    which the formatter then takes instead of reading again."""
    return _check_inputs_with_stats(
        preds,
        target,
        threshold=threshold,
        top_k=top_k,
        num_classes=num_classes,
        multiclass=multiclass,
        ignore_index=ignore_index,
    )


def _accuracy_update(
    preds: Tensor,
    target: Tensor,
    reduce: Optional[str],
    mdmc_reduce: Optional[str],
    threshold: float,
    num_classes: Optional[int],
    top_k: Optional[int],
    multiclass: Optional[bool],
    ignore_index: Optional[int],
    mode: DataType,
    stats: Optional[Dict[str, int]] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    if mode == DataType.MULTILABEL and top_k:
        raise ValueError("You can not use the `top_k` parameter to calculate accuracy for multi-label inputs.")
    preds, target = _input_squeeze(preds, target)
    return _stat_scores_update(
        preds,
        target,
        reduce=reduce,
        mdmc_reduce=mdmc_reduce,
        threshold=threshold,
        num_classes=num_classes,
        top_k=top_k,
        multiclass=multiclass,
        ignore_index=ignore_index,
        mode=mode,
        stats=stats,
    )


def _accuracy_compute(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
    mode: DataType,
) -> Tensor:
    simple_average = (AverageMethod.MICRO, AverageMethod.SAMPLES)
    if (mode == DataType.BINARY and average in simple_average) or mode == DataType.MULTILABEL:
        numerator = tp + tn
        denominator = tp + tn + fp + fn
    else:
        numerator = tp
        denominator = tp + fn

    numerator = numerator.to(torch.float32)
    denominator = denominator.to(torch.float32)

    if mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        if average == AverageMethod.MACRO:
            cond = (tp + fp + fn) == 0
            numerator = torch.where(cond, 0.0, numerator)
            denominator = torch.where(cond, -1.0, denominator)
        if average == AverageMethod.NONE:
            # a class is absent if there are no TPs, FPs, nor FNs
            cond = (tp | fn | fp) == 0
            numerator = torch.where(cond, -1.0, numerator)
            denominator = torch.where(cond, -1.0, denominator)

    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else (tp + fn),
        average=average,
        mdmc_average=mdmc_average,
    )


def _subset_accuracy_update(
    preds: Tensor,
    target: Tensor,
    threshold: float,
    top_k: Optional[int],
    ignore_index: Optional[int] = None,
    stats: Optional[Dict[str, int]] = None,
) -> Tuple[Tensor, Tensor]:
    """int32 ``correct`` and ``total`` of one batch."""
    preds, target = _input_squeeze(preds, target)
    preds, target, mode = _input_format_classification(
        preds, target, threshold=threshold, top_k=top_k, ignore_index=ignore_index, stats=stats
    )

    if mode == DataType.MULTILABEL and top_k:
        raise ValueError("You can not use the `top_k` parameter to calculate accuracy for multi-label inputs.")

    device = preds.device
    if mode == DataType.MULTILABEL:
        correct = torch.sum(torch.all(preds == target, dim=1), dtype=torch.int32)
        total = torch.full((), target.shape[0], dtype=torch.int32, device=device)
    elif mode == DataType.MULTICLASS:
        correct = torch.sum(preds * target, dtype=torch.int32)
        total = torch.sum(target, dtype=torch.int32)
    elif mode == DataType.MULTIDIM_MULTICLASS:
        sample_correct = torch.sum(preds * target, dim=(1, 2), dtype=torch.int32)
        correct = torch.sum(sample_correct == target.shape[2], dtype=torch.int32)
        total = torch.full((), target.shape[0], dtype=torch.int32, device=device)
    else:
        correct = total = torch.zeros((), dtype=torch.int32, device=device)

    return correct, total


def _subset_accuracy_compute(correct: Tensor, total: Tensor) -> Tensor:
    return correct.to(torch.float32) / total


def accuracy(
    preds: Any,
    target: Any,
    average: str = "micro",
    mdmc_average: Optional[str] = "global",
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    subset_accuracy: bool = False,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
    device: Optional[Any] = None,
) -> Tensor:
    """Accuracy of one batch. Tensors are counted where they lie; numpy
    inputs go to ``device`` (the card unless ``device="cpu"``).

    Example:
        >>> import torch
        >>> target = torch.tensor([0, 1, 2, 3])
        >>> preds = torch.tensor([0, 2, 1, 3])
        >>> accuracy(preds, target)
        tensor(0.5000)
    """
    allowed_average = ("micro", "macro", "weighted", "samples", "none", None)
    if average not in allowed_average:
        raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")

    if average in ("macro", "weighted", "none", None) and (not num_classes or num_classes < 1):
        raise ValueError(f"When you set `average` as {average}, you have to provide the number of classes.")

    allowed_mdmc_average = (None, "samplewise", "global")
    if mdmc_average not in allowed_mdmc_average:
        raise ValueError(f"The `mdmc_average` has to be one of {allowed_mdmc_average}, got {mdmc_average}.")

    if num_classes and ignore_index is not None and (not ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")

    preds, target = _as_tensor(preds, device), _as_tensor(target, device)
    if top_k is not None and (not isinstance(top_k, int) or top_k <= 0):
        raise ValueError(f"The `top_k` should be an integer larger than 0, got {top_k}")

    preds, target = _input_squeeze(preds, target)
    mode, stats = _mode(preds, target, threshold, top_k, num_classes, multiclass, ignore_index)
    reduce = "macro" if average in ("weighted", "none", None) else average

    if subset_accuracy and _check_subset_validity(mode):
        correct, total = _subset_accuracy_update(preds, target, threshold, top_k, ignore_index, stats)
        return _subset_accuracy_compute(correct, total)
    tp, fp, tn, fn = _accuracy_update(
        preds, target, reduce, mdmc_average, threshold, num_classes, top_k, multiclass, ignore_index, mode, stats
    )
    return _accuracy_compute(tp, fp, tn, fn, average, mdmc_average, mode)
