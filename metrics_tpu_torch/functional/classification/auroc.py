"""Area under the ROC curve.

Counterpart of ``metrics_tpu/functional/classification/auroc.py``: the
curve-based ``auroc`` (``_auroc_update``/``_auroc_compute``: binary,
multiclass one-vs-rest and multilabel, macro/weighted/micro/none, and the
``max_fpr`` partial AUC with the McClish correction), and the exact
one-vs-rest rank AUROC by the Mann-Whitney statistic
(``_sorted_mean_ranks``, ``auroc_rank_multiclass_masked``,
``auroc_rank_multiclass``).

The curve-based path runs eagerly: its curves have one point per distinct
score, and its checks read the card. Rank AUROC layout as in the JAX package: class-major ``[C, N]`` scores, one stable
sort along the minor axis (``torch.sort(stable=True)``), midranks from run
boundaries with cummax/cummin. The positive rank sums differ in form: each
valid row is a positive of exactly one class, so the sums are a
segment-sum of the N rows' own-class midranks by their label (the
``segment_sum_f32`` kernel on the card) instead of a masked reduction over
all ``C x N`` entries. Midranks are half-integers, so both forms give the
same sums exactly while they stay below 2**23.
"""
from typing import Any, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.auc import _auc_compute_without_check
from metrics_tpu_torch.functional.classification.roc import roc
from metrics_tpu_torch.ops import segment_sum_dispatch
from metrics_tpu_torch.utils.checks import _input_format_classification, _score_mode_static, checks_read_nothing
from metrics_tpu_torch.utils.data import _as_tensor, _bincount, _tie_runs
from metrics_tpu_torch.utils.enums import AverageMethod, DataType
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _auroc_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, DataType]:
    """Validate the inputs (one host read), deduce the mode, and flatten
    multi-dimensional multiclass and multilabel inputs to ``(N, C)`` rows."""
    if checks_read_nothing():
        # the capture rule: the mode from the shapes alone, as the JAX
        # package deduces it from a tracer's shapes (the value checks are
        # host work, and integer predictions cannot be formatted there)
        mode = _score_mode_static(preds, target)
    else:
        _, _, mode = _input_format_classification(preds, target)

    if mode == DataType.MULTIDIM_MULTICLASS:
        n_classes = preds.shape[1]
        preds = preds.transpose(0, 1).reshape(n_classes, -1).T
        target = target.flatten()
    if mode == DataType.MULTILABEL and preds.ndim > 2:
        n_classes = preds.shape[1]
        preds = preds.transpose(0, 1).reshape(n_classes, -1).T
        target = target.transpose(0, 1).reshape(n_classes, -1).T

    return preds, target, mode


def _auroc_compute(
    preds: Tensor,
    target: Tensor,
    mode: DataType,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    sample_weights: Optional[Sequence] = None,
) -> Tensor:
    # binary mode overrides num_classes
    if mode == DataType.BINARY:
        num_classes = 1

    if max_fpr is not None:
        if not isinstance(max_fpr, float) or not 0 < max_fpr <= 1:
            raise ValueError(f"`max_fpr` should be a float in range (0, 1], got: {max_fpr}")
        if mode != DataType.BINARY:
            raise ValueError(
                "Partial AUC computation not available in multilabel/multiclass setting,"
                f" 'max_fpr' must be set to `None`, received `{max_fpr}`."
            )

    if mode == DataType.MULTILABEL:
        if average == AverageMethod.MICRO:
            fpr, tpr, _ = roc(preds.flatten(), target.flatten(), 1, pos_label, sample_weights)
        elif num_classes:
            output = [
                roc(preds[:, i], target[:, i], num_classes=1, pos_label=1, sample_weights=sample_weights)
                for i in range(num_classes)
            ]
            fpr = [o[0] for o in output]
            tpr = [o[1] for o in output]
        else:
            raise ValueError("Detected input to be `multilabel` but you did not provide `num_classes` argument")
    else:
        if mode != DataType.BINARY:
            if num_classes is None:
                raise ValueError("Detected input to `multiclass` but you did not provide `num_classes` argument")
            if average == AverageMethod.WEIGHTED and len(torch.unique(target)) < num_classes:
                # classes with 0 observations are excluded (their weight is 0)
                target_bool_mat = torch.zeros((len(target), num_classes), dtype=torch.bool, device=target.device)
                target_bool_mat[torch.arange(len(target), device=target.device), target.long()] = True
                class_observed = target_bool_mat.sum(dim=0) > 0
                for c, observed in enumerate(class_observed.tolist()):
                    if not observed:
                        rank_zero_warn(f"Class {c} had 0 observations, omitted from AUROC calculation", UserWarning)
                preds = preds[:, class_observed]
                target_bool_mat = target_bool_mat[:, class_observed]
                target = torch.nonzero(target_bool_mat)[:, 1]
                num_classes = int(class_observed.sum())
                if num_classes == 1:
                    raise ValueError("Found 1 non-empty class in `multiclass` AUROC calculation")
        fpr, tpr, _ = roc(preds, target, num_classes, pos_label, sample_weights)

    if max_fpr is None or max_fpr == 1:
        if mode == DataType.MULTILABEL and average == AverageMethod.MICRO:
            pass
        elif num_classes != 1:
            auc_scores = [_auc_compute_without_check(x, y, 1.0) for x, y in zip(fpr, tpr)]
            if average == AverageMethod.NONE:
                return torch.stack(auc_scores)
            if average == AverageMethod.MACRO:
                return torch.mean(torch.stack(auc_scores))
            if average == AverageMethod.WEIGHTED:
                if mode == DataType.MULTILABEL:
                    support = torch.sum(target, dim=0)
                else:
                    support = _bincount(target.flatten().to(torch.int32), minlength=num_classes)
                return torch.sum(torch.stack(auc_scores) * support / torch.sum(support))
            allowed_average = (AverageMethod.NONE.value, AverageMethod.MACRO.value, AverageMethod.WEIGHTED.value)
            raise ValueError(
                f"Argument `average` expected to be one of the following: {allowed_average} but got {average}"
            )
        return _auc_compute_without_check(fpr, tpr, 1.0)

    # partial AUC needs both classes present: the roc kernel zero-fills the
    # degenerate axis, which the interpolation below would silently turn
    # into NaN (no negatives) or a meaningless value (no positives)
    last_fpr, last_tpr = torch.stack([fpr[-1], tpr[-1]]).tolist()
    if not last_fpr > 0:
        raise ValueError("Partial AUC (`max_fpr`) is undefined when `target` contains no negative samples.")
    if not last_tpr > 0:
        raise ValueError("Partial AUC (`max_fpr`) is undefined when `target` contains no positive samples.")

    max_area = torch.tensor(max_fpr, dtype=torch.float32, device=fpr.device)
    # add a single point at max_fpr by linear interpolation
    stop = int(torch.searchsorted(fpr, max_area.reshape(1), side="right"))
    weight = (max_area - fpr[stop - 1]) / (fpr[stop] - fpr[stop - 1])
    interp_tpr = tpr[stop - 1] + weight * (tpr[stop] - tpr[stop - 1])
    tpr = torch.cat([tpr[:stop], interp_tpr.reshape(1)])
    fpr = torch.cat([fpr[:stop], max_area.reshape(1)])

    partial_auc = _auc_compute_without_check(fpr, tpr, 1.0)

    # McClish correction: 0.5 if non-discriminant, 1 if maximal
    min_area = 0.5 * max_area**2
    return 0.5 * (1 + (partial_auc - min_area) / (max_area - min_area))


def _sorted_mean_ranks(sorted_x: Tensor) -> Tensor:
    """Tie-averaged 1-based ranks of an already row-sorted ``[C, N]``
    (ascending along the last axis): a tie run's mean rank is
    (first + last position) / 2 + 1."""
    start, end = _tie_runs(sorted_x)
    return (start + end).to(torch.float32) / 2 + 1


def auroc_rank_multiclass_masked(
    preds: Any,
    target: Any,
    valid: Any,
    num_classes: int,
    average: Optional[str] = "macro",
    device: Optional[Any] = None,
) -> Tensor:
    """``auroc_rank_multiclass`` over a fixed-capacity buffer with a
    validity mask (the stateful exact multiclass mode).

    Invalid rows get ``-inf`` scores, so they sort below every real score;
    their rank block (1..n_invalid) is subtracted from the positive rank
    sums, which gives the ranks among valid rows alone. Real ``-inf``
    scores would tie with the padding and are not supported.
    """
    preds, target, valid = (_as_tensor(x, device) for x in (preds, target, valid))
    if preds.ndim != 2 or preds.shape[1] != num_classes:
        raise ValueError(f"Expected `preds` of shape [capacity, {num_classes}], got {tuple(preds.shape)}")

    n = preds.shape[0]
    valid = valid.to(torch.bool)
    neg_inf = torch.tensor(float("-inf"), device=preds.device)
    scores_t = torch.where(valid[None, :], preds.to(torch.float32).T, neg_inf)  # [C, N]
    masked_target = torch.where(valid, target.to(torch.int64), -1)
    sorted_scores, order = torch.sort(scores_t, dim=1, stable=True)
    mean_rank_sorted = _sorted_mean_ranks(sorted_scores)  # [C, N]

    # each row's midrank within its own class's column, back in row order
    ranks = torch.empty_like(mean_rank_sorted).scatter_(1, order, mean_rank_sorted)
    own_class = masked_target.clamp(0, num_classes - 1).view(1, n)
    own_rank = ranks.gather(0, own_class).view(n)
    # per class: (sum of positive midranks, positives); invalid rows and
    # labels outside [0, C) carry ids the segment-sum drops
    rank_and_count = torch.stack([own_rank, torch.ones_like(own_rank)], dim=1)
    per_class = segment_sum_dispatch(rank_and_count, masked_target, num_classes)
    n_pos = per_class[:, 1]

    n_valid = valid.sum().to(torch.float32)
    n_invalid = n - n_valid
    n_neg = n_valid - n_pos

    rank_sum_pos = per_class[:, 0] - n_pos * n_invalid
    u = rank_sum_pos - n_pos * (n_pos + 1) / 2
    defined = (n_pos > 0) & (n_neg > 0)
    nan = torch.tensor(float("nan"), device=preds.device)
    auc_per_class = torch.where(defined, u / torch.where(defined, n_pos * n_neg, 1.0), nan)

    if average in (None, "none", AverageMethod.NONE):
        return auc_per_class
    # NaN (not 0) when NO class is defined: a blanked valid mask must never
    # yield a plausible value
    any_defined = defined.any()
    zero = torch.zeros_like(auc_per_class)
    if average == AverageMethod.MACRO:
        macro = torch.where(defined, auc_per_class, zero).sum() / torch.clamp(defined.sum(), min=1)
        return torch.where(any_defined, macro, nan)
    if average == AverageMethod.WEIGHTED:
        w = torch.where(defined, n_pos, zero)
        weighted = (torch.where(defined, auc_per_class, zero) * w).sum() / torch.clamp(w.sum(), min=1.0)
        return torch.where(any_defined, weighted, nan)
    raise ValueError(f"Argument `average` expected to be one of ('macro', 'weighted', 'none') but got {average}")


def auroc_rank_multiclass(
    preds: Any,
    target: Any,
    num_classes: int,
    average: Optional[str] = "macro",
    device: Optional[Any] = None,
) -> Tensor:
    """Exact one-vs-rest multiclass AUROC via the Mann-Whitney U statistic:

        auc_c = (sum of positive midranks - n_pos(n_pos+1)/2) / (n_pos n_neg)

    Classes with no positives or no negatives are excluded from the average
    (AUROC is undefined there).

    Args:
        preds: ``[N, C]`` scores (any monotone transform of probabilities).
        target: ``[N]`` integer labels.
        num_classes: number of classes ``C``.
        average: 'macro' | 'weighted' | 'none'/None.
        device: where numpy inputs go (the card unless ``"cpu"``); tensors
            are computed where they lie.
    """
    preds = _as_tensor(preds, device)
    valid = torch.ones((preds.shape[0],), dtype=torch.bool, device=preds.device)
    return auroc_rank_multiclass_masked(preds, target, valid, num_classes, average=average, device=preds.device)


def auroc(
    preds: Any,
    target: Any,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    sample_weights: Optional[Sequence] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """Computes the Area Under the Receiver Operating Characteristic Curve.
    Host inputs go to ``device`` (the card unless ``"cpu"``); tensors are
    computed where they lie.

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.13, 0.26, 0.08, 0.19, 0.34])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> auroc(preds, target, pos_label=1)
        tensor(0.5000)
    """
    preds, target = _as_tensor(preds, device), _as_tensor(target, device)
    preds, target, mode = _auroc_update(preds, target)
    return _auroc_compute(preds, target, mode, num_classes, pos_label, average, max_fpr, sample_weights)
