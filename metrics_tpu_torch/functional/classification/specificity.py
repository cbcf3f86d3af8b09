"""Specificity.

Counterpart of ``metrics_tpu/functional/classification/specificity.py``
(``average='weighted'`` weighs by ``tn + fp``, the denominator, as the JAX
package does).
"""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.classification.stat_scores import (
    _check_avg_arguments,
    _reduce_stat_scores,
    _stat_scores_update,
)
from metrics_tpu_torch.utils.data import _as_tensor
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod

Tensor = torch.Tensor


def _specificity_compute(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: str,
    mdmc_average: Optional[str],
) -> Tensor:
    numerator = tn.to(torch.float32)
    denominator = (tn + fp).to(torch.float32)
    if average == AverageMethod.NONE and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        cond = (tp | fn | fp) == 0
        numerator = torch.where(cond, -1.0, numerator)
        denominator = torch.where(cond, -1.0, denominator)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else (tn + fp),
        average=average,
        mdmc_average=mdmc_average,
    )


def specificity(
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
    """Specificity of one batch. Tensors are counted where they lie; numpy
    inputs go to ``device`` (the card unless ``device="cpu"``).

    Example:
        >>> import torch
        >>> preds  = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> specificity(preds, target, average='macro', num_classes=3)
        tensor(0.6111)
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
    return _specificity_compute(tp, fp, tn, fn, average, mdmc_average)
