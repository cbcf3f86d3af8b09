"""True/false positive/negative counting, the spine of the classification
family.

Counterpart of ``metrics_tpu/functional/classification/stat_scores.py``:
canonical inputs (``_input_format_classification``) are reduced by boolean
masks and int32 sums over the (sample, class, extra) axes that ``reduce``
and ``mdmc_reduce`` name; ``_reduce_stat_scores`` is the shared
micro/macro/weighted/none/samples averaging of every StatScores-derived
metric. Counts are int32 as in the JAX package (``torch.sum`` of a bool
tensor would give int64). Every update builds new tensors; the ignored
class's overwrite is a clone plus an index assignment.
"""
from typing import Any, Dict, Optional, Tuple

import torch

from metrics_tpu_torch.utils.checks import _input_format_classification
from metrics_tpu_torch.utils.data import _as_tensor
from metrics_tpu_torch.utils.enums import AverageMethod, DataType, MDMCAverageMethod

Tensor = torch.Tensor


def _check_avg_arguments(
    average: str, mdmc_average: Optional[str], num_classes: Optional[int], ignore_index: Optional[int]
) -> None:
    """Shared argument validation for the StatScores-derived metric family."""
    allowed_average = ("micro", "macro", "weighted", "samples", "none", None)
    if average not in allowed_average:
        raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")
    allowed_mdmc_average = (None, "samplewise", "global")
    if mdmc_average not in allowed_mdmc_average:
        raise ValueError(f"The `mdmc_average` has to be one of {allowed_mdmc_average}, got {mdmc_average}.")
    if average in ("macro", "weighted", "none", None) and (not num_classes or num_classes < 1):
        raise ValueError(f"When you set `average` as {average}, you have to provide the number of classes.")
    if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")


def _del_column(data: Tensor, idx: int) -> Tensor:
    return torch.cat([data[:, :idx], data[:, (idx + 1):]], dim=1)


def _drop_negative_ignored_indices(
    preds: Tensor, target: Tensor, ignore_index: int, mode: DataType
) -> Tuple[Tensor, Tensor]:
    """Remove the positions whose target equals a negative ``ignore_index``.

    Boolean-mask indexing gives a shape that depends on the data, so on the
    card this reads the host once."""
    if mode == DataType.MULTIDIM_MULTICLASS and preds.is_floating_point():
        num_classes = preds.shape[1]
        preds = preds.transpose(1, preds.ndim - 1).reshape(-1, num_classes)
        target = target.reshape(-1)

    if mode in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS):
        keep = target != ignore_index
        preds = preds[keep]
        target = target[keep]

    return preds, target


def _stat_scores(
    preds: Tensor,
    target: Tensor,
    reduce: Optional[str] = "micro",
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """int32 tp/fp/tn/fn over canonical binary ``(N, C)`` / ``(N, C, X)`` inputs."""
    if reduce == "micro":
        dim = (0, 1) if preds.ndim == 2 else (1, 2)
    elif reduce == "macro":
        dim = 0 if preds.ndim == 2 else 2
    else:  # samples
        dim = 1

    true_pred, false_pred = target == preds, target != preds
    pos_pred, neg_pred = preds == 1, preds == 0

    tp = torch.sum(true_pred & pos_pred, dim=dim, dtype=torch.int32)
    fp = torch.sum(false_pred & pos_pred, dim=dim, dtype=torch.int32)
    tn = torch.sum(true_pred & neg_pred, dim=dim, dtype=torch.int32)
    fn = torch.sum(false_pred & neg_pred, dim=dim, dtype=torch.int32)
    return tp, fp, tn, fn


def _stat_scores_update(
    preds: Tensor,
    target: Tensor,
    reduce: Optional[str] = "micro",
    mdmc_reduce: Optional[str] = None,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = None,
    threshold: float = 0.5,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
    mode: Optional[DataType] = None,
    stats: Optional[Dict[str, int]] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Format the inputs and count. ``stats`` are the value stats a caller
    already read from these inputs (Accuracy's mode check); they are used
    only while no position was dropped."""
    _negative_index_dropped = False

    if ignore_index is not None and ignore_index < 0 and mode is not None:
        preds, target = _drop_negative_ignored_indices(preds, target, ignore_index, mode)
        _negative_index_dropped = True
        stats = None

    preds, target, _ = _input_format_classification(
        preds,
        target,
        threshold=threshold,
        num_classes=num_classes,
        multiclass=multiclass,
        top_k=top_k,
        ignore_index=ignore_index,
        stats=stats,
    )

    if ignore_index is not None and ignore_index < 0 and not _negative_index_dropped:
        # a negative index would wrap to the last class in torch, as
        # .at[-1] would corrupt silently in JAX: raise instead
        raise ValueError(
            f"A negative `ignore_index` {ignore_index} is only supported by metrics that infer the"
            " input mode (e.g. Accuracy); use a non-negative class index here instead"
        )
    if ignore_index is not None and ignore_index >= preds.shape[1]:
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {preds.shape[1]} classes")
    if ignore_index is not None and preds.shape[1] == 1:
        raise ValueError("You can not use `ignore_index` with binary data.")

    if preds.ndim == 3:
        if not mdmc_reduce:
            raise ValueError(
                "When your inputs are multi-dimensional multi-class, you have to set the `mdmc_reduce` parameter"
            )
        if mdmc_reduce == "global":
            preds = preds.transpose(1, 2).reshape(-1, preds.shape[1])
            target = target.transpose(1, 2).reshape(-1, target.shape[1])

    if ignore_index is not None and reduce != "macro" and not _negative_index_dropped:
        preds = _del_column(preds, ignore_index)
        target = _del_column(target, ignore_index)

    tp, fp, tn, fn = _stat_scores(preds, target, reduce=reduce)

    if ignore_index is not None and reduce == "macro" and not _negative_index_dropped:
        tp, fp, tn, fn = (_set_class(x, ignore_index, -1) for x in (tp, fp, tn, fn))

    return tp, fp, tn, fn


def _set_class(x: Tensor, idx: int, value: float) -> Tensor:
    """A copy of ``x`` with ``x[..., idx] = value`` (``x.at[..., idx].set``)."""
    out = x.clone()
    out[..., idx] = value
    return out


def _stat_scores_compute(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Tensor:
    """``[tp, fp, tn, fn, support]`` stacked on a new last dim; -1 marks an ignored class."""
    outputs = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    return torch.where(outputs < 0, -1, outputs)


def _reduce_stat_scores(
    numerator: Tensor,
    denominator: Tensor,
    weights: Optional[Tensor],
    average: Optional[str],
    mdmc_average: Optional[str],
    zero_division: int = 0,
) -> Tensor:
    """Shared micro/macro/weighted/none/samples reduction (float32)."""
    numerator = numerator.to(torch.float32)
    denominator = denominator.to(torch.float32)
    zero_div_mask = denominator == 0
    ignore_mask = denominator < 0

    weights = torch.ones_like(denominator) if weights is None else weights.to(torch.float32)

    numerator = torch.where(zero_div_mask, float(zero_division), numerator)
    denominator = torch.where(zero_div_mask | ignore_mask, 1.0, denominator)
    weights = torch.where(ignore_mask, 0.0, weights)

    if average not in (AverageMethod.MICRO, AverageMethod.NONE, None):
        weights = weights / torch.sum(weights, dim=-1, keepdim=True)

    scores = weights * (numerator / denominator)
    # sum(weights) == 0 (e.g. only the present class ignored with average='weighted')
    scores = torch.where(torch.isnan(scores), float(zero_division), scores)

    if mdmc_average == MDMCAverageMethod.SAMPLEWISE:
        scores = torch.mean(scores, dim=0)
        ignore_mask = torch.sum(ignore_mask, dim=0).to(torch.bool)

    if average in (AverageMethod.NONE, None):
        return torch.where(ignore_mask, float("nan"), scores)
    return torch.sum(scores)


def stat_scores(
    preds: Any,
    target: Any,
    reduce: str = "micro",
    mdmc_reduce: Optional[str] = None,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = None,
    threshold: float = 0.5,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
    device: Optional[Any] = None,
) -> Tensor:
    """tp/fp/tn/fn/support counts (int32). Tensors are counted where they
    lie; numpy inputs go to ``device`` (the card unless ``device="cpu"``).

    Example:
        >>> import torch
        >>> preds  = torch.tensor([1, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> stat_scores(preds, target, reduce='macro', num_classes=3)
        tensor([[0, 1, 2, 1, 1],
                [1, 1, 1, 1, 2],
                [1, 0, 3, 0, 1]], dtype=torch.int32)
    """
    if reduce not in ("micro", "macro", "samples"):
        raise ValueError(f"The `reduce` {reduce} is not valid.")
    if mdmc_reduce not in (None, "samplewise", "global"):
        raise ValueError(f"The `mdmc_reduce` {mdmc_reduce} is not valid.")
    if reduce == "macro" and (not num_classes or num_classes < 1):
        raise ValueError("When you set `reduce` as 'macro', you have to provide the number of classes.")
    if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")

    tp, fp, tn, fn = _stat_scores_update(
        _as_tensor(preds, device),
        _as_tensor(target, device),
        reduce=reduce,
        mdmc_reduce=mdmc_reduce,
        top_k=top_k,
        threshold=threshold,
        num_classes=num_classes,
        multiclass=multiclass,
        ignore_index=ignore_index,
    )
    return _stat_scores_compute(tp, fp, tn, fn)
