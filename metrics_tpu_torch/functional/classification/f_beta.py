"""F-beta and F1.

Counterpart of ``metrics_tpu/functional/classification/f_beta.py``: the
micro path masks ignored classes before summing; the macro/none class
removal is an ignore mask. The ignored class's overwrites are clones plus
index assignments.
"""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.classification.stat_scores import (
    _check_avg_arguments,
    _reduce_stat_scores,
    _set_class,
    _stat_scores_update,
)
from metrics_tpu_torch.utils.data import _as_tensor, _safe_divide
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod

Tensor = torch.Tensor


def _fbeta_compute(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    beta: float,
    ignore_index: Optional[int],
    average: str,
    mdmc_average: Optional[str],
) -> Tensor:
    """F-beta from the counts.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional.classification.stat_scores import _stat_scores_update
        >>> target = torch.tensor([0, 1, 2, 0, 1, 2])
        >>> preds = torch.tensor([0, 2, 1, 0, 0, 1])
        >>> tp, fp, tn, fn = _stat_scores_update(preds, target, reduce='micro', num_classes=3)
        >>> _fbeta_compute(tp, fp, tn, fn, beta=0.5, ignore_index=None, average='micro', mdmc_average=None)
        tensor(0.3333)
    """
    if average == AverageMethod.MICRO and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        mask = tp >= 0
        tp_sum = torch.sum(torch.where(mask, tp, 0), dtype=torch.int32).to(torch.float32)
        precision = _safe_divide(tp_sum, torch.sum(torch.where(mask, tp + fp, 0), dtype=torch.int32))
        recall = _safe_divide(tp_sum, torch.sum(torch.where(mask, tp + fn, 0), dtype=torch.int32))
    else:
        precision = _safe_divide(tp.to(torch.float32), tp + fp)
        recall = _safe_divide(tp.to(torch.float32), tp + fn)

    num = (1 + beta**2) * precision * recall
    denom = beta**2 * precision + recall
    denom = torch.where(denom == 0.0, 1.0, denom)

    # absent classes (no TPs, FPs, nor FNs) are meaningless for per-class scores
    if average == AverageMethod.NONE and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        meaningless = (tp | fn | fp) == 0
        if ignore_index is not None:
            meaningless = _set_class(meaningless, ignore_index, True)
        num = torch.where(meaningless, -1.0, num)
        denom = torch.where(meaningless, -1.0, denom)
    elif ignore_index is not None and average not in (AverageMethod.MICRO, AverageMethod.SAMPLES):
        # the class axis is the last: [C] counts, or [N, C] samplewise
        num, denom = _set_class(num, ignore_index, -1.0), _set_class(denom, ignore_index, -1.0)

    if average == AverageMethod.MACRO and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        cond = ((tp + fp + fn) == 0) | ((tp + fp + fn) == -3)
        num = torch.where(cond, 0.0, num)
        denom = torch.where(cond, -1.0, denom)

    return _reduce_stat_scores(
        numerator=num,
        denominator=denom,
        weights=None if average != AverageMethod.WEIGHTED else (tp + fn),
        average=average,
        mdmc_average=mdmc_average,
    )


def fbeta_score(
    preds: Any,
    target: Any,
    beta: float = 1.0,
    average: str = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
    device: Optional[Any] = None,
) -> Tensor:
    """F-beta of one batch. Tensors are counted where they lie; numpy
    inputs go to ``device`` (the card unless ``device="cpu"``).

    Example:
        >>> import torch
        >>> target = torch.tensor([0, 1, 2, 0, 1, 2])
        >>> preds = torch.tensor([0, 2, 1, 0, 0, 1])
        >>> fbeta_score(preds, target, num_classes=3, beta=0.5)
        tensor(0.3333)
    """
    _check_avg_arguments(average, mdmc_average, num_classes, ignore_index)

    reduce = "macro" if average in ("weighted", "none", None) else average
    tp, fp, tn, fn = _stat_scores_update(
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
    return _fbeta_compute(tp, fp, tn, fn, beta, ignore_index, average, mdmc_average)


def f1_score(
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
    """F1: F-beta with beta 1.

    Example:
        >>> import torch
        >>> target = torch.tensor([0, 1, 2, 0, 1, 2])
        >>> preds = torch.tensor([0, 2, 1, 0, 0, 1])
        >>> f1_score(preds, target, num_classes=3)
        tensor(0.3333)
    """
    return fbeta_score(
        preds, target, 1.0, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass, device
    )
