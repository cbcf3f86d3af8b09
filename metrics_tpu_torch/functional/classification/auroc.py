"""Exact one-vs-rest multiclass AUROC by the Mann-Whitney rank statistic.

Counterpart of the rank part of
``metrics_tpu/functional/classification/auroc.py`` (``_sorted_mean_ranks``,
``auroc_rank_multiclass_masked``, ``auroc_rank_multiclass``). The curve-based
``auroc`` waits for the port of ``roc``.

Layout as in the JAX package: class-major ``[C, N]`` scores, one stable
sort along the minor axis (``torch.sort(stable=True)``), midranks from run
boundaries with cummax/cummin. The positive rank sums differ in form: each
valid row is a positive of exactly one class, so the sums are a
segment-sum of the N rows' own-class midranks by their label (the
``segment_sum_f32`` kernel on the card) instead of a masked reduction over
all ``C x N`` entries. Midranks are half-integers, so both forms give the
same sums exactly while they stay below 2**23.
"""
from typing import Any, Optional

import torch

from metrics_tpu_torch.ops import segment_sum_dispatch
from metrics_tpu_torch.utils.data import _as_tensor
from metrics_tpu_torch.utils.enums import AverageMethod

Tensor = torch.Tensor


def _sorted_mean_ranks(sorted_x: Tensor) -> Tensor:
    """Tie-averaged 1-based ranks of an already row-sorted ``[C, N]``
    (ascending along the last axis): a tie run's mean rank is
    (first + last position) / 2 + 1."""
    c, n = sorted_x.shape
    pos = torch.arange(n, dtype=torch.int32, device=sorted_x.device).expand(c, n)
    change = sorted_x[:, 1:] != sorted_x[:, :-1]
    edge = torch.ones((c, 1), dtype=torch.bool, device=sorted_x.device)
    is_start = torch.cat([edge, change], dim=1)
    is_last = torch.cat([change, edge], dim=1)
    start = torch.cummax(torch.where(is_start, pos, 0), dim=1).values
    end = torch.cummin(torch.where(is_last, pos, n - 1).flip(1), dim=1).values.flip(1)
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
