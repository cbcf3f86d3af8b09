"""Weighted curve kernels for the sketched curve metrics.

Counterpart of ``metrics_tpu/functional/classification/sketch_curve.py``. Past its lossless window a sketched metric holds
WEIGHTED rows ``(score, y, w)`` where ``y`` may be fractional (a compaction
averages the indicator payloads and keeps their first moments exactly).
These kernels generalise the exact-curve cumulants (``exact_curve.py``)
from counts to masses: ``tps = cumsum(w * y)``, ``fps = cumsum(w * (1 - y))``,
with the same descending sort, tie runs and endpoint conventions; at unit
weights and crisp labels they give the unweighted kernels' values. The
masses are fractional, so their prefix sums take a fixed order
(``utils/data._scan_fixed``): the curves are the same bits on the card and
on the CPU.

They work along the last axis and batch over any leading axes, which takes
the place of the JAX package's ``vmap`` over class columns.

:func:`coco_precision_recall_grid` is the detection twin: the same
sort-then-cumulate reduction onto COCO's fixed recall grid, in host numpy
float64 with the reference's mergesort and zigzag-removal semantics, as
the JAX package keeps it (detection AP is held bit for bit).
"""
from typing import Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.functional.classification.exact_curve import _run_ends
from metrics_tpu_torch.utils.data import _scan_fixed, stable_sort_with_payloads

Tensor = torch.Tensor

#: the reference's denominator epsilon (float64 machine epsilon)
_COCO_EPS = float(np.finfo(np.float64).eps)


def coco_precision_recall_grid(
    scores: np.ndarray,
    matches: np.ndarray,
    ignore: np.ndarray,
    npig: int,
    rec_thrs: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """COCO PR integration for one (class, area, max_det) cell.

    ``scores [nd]`` in unit-major arrival order, ``matches``/``ignore``
    ``[T, nd]`` bool over the IoU-threshold axis, ``npig`` the number of
    non-ignored ground truths, ``rec_thrs [R]`` the fixed recall grid.
    Returns ``(precision [T, R], recall [T])`` float64: descending
    mergesort, float64 cumulative TP/FP counts, the right-to-left running
    max (the fixed point of the iterative zigzag removal), a left
    ``searchsorted`` onto the recall grid with first-out-of-bounds
    truncation.
    """
    T = matches.shape[0]
    R = rec_thrs.shape[0]
    nd = scores.shape[0]
    precision = np.zeros((T, R))
    recall = np.zeros((T,))
    if nd == 0:
        return precision, recall

    inds = np.argsort(-scores, kind="mergesort")
    matches = matches[:, inds]
    ignore = ignore[:, inds]

    tps = np.cumsum(matches & ~ignore, axis=1, dtype=np.float64)
    fps = np.cumsum(~matches & ~ignore, axis=1, dtype=np.float64)

    rc_all = tps / npig  # [T, nd]
    pr_all = tps / (fps + tps + _COCO_EPS)
    recall[:] = rc_all[:, -1]
    pr_all = np.maximum.accumulate(pr_all[:, ::-1], axis=1)[:, ::-1]
    for t in range(T):
        r_inds = np.searchsorted(rc_all[t], rec_thrs, side="left")
        num = int(r_inds.argmax()) if r_inds.max() >= nd else R
        precision[t, :num] = pr_all[t, r_inds[:num]]
    return precision, recall


def _weighted_sorted_cumulants(
    scores: Tensor, y: Tensor, w: Tensor
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Descending-score sort (zero-weight rows last) with weighted run-end
    cumulants; the weighted twin of ``exact_curve._masked_sorted_cumulants``."""
    valid = w > 0
    neg_inf = torch.tensor(float("-inf"), device=scores.device)
    key = torch.where(valid, scores.to(torch.float32), neg_inf)
    sorted_key, sorted_wy, sorted_w = stable_sort_with_payloads(
        key, (w * y).to(torch.float32), torch.where(valid, w, 0.0).to(torch.float32), descending=True
    )
    # fractional masses: a fixed-order scan, so the card and the CPU agree
    # bit for bit
    tps = _scan_fixed(sorted_wy)
    fps = _scan_fixed(sorted_w - sorted_wy)
    run_end, run_start = _run_ends(sorted_key)
    return sorted_key, sorted_w > 0, tps, fps, run_end, run_start


def binary_auroc_weighted(scores: Tensor, y: Tensor, w: Tensor) -> Tensor:
    """Weighted binary AUROC (trapezoid over run-end ROC points) along the
    last axis; NaN where either class carries no weight."""
    _, _, tps, fps, run_end, _ = _weighted_sorted_cumulants(scores, y, w)
    total_pos, total_neg = tps[..., -1:], fps[..., -1:]
    tpr = tps.gather(-1, run_end) / torch.clamp(total_pos, min=1e-12)
    fpr = fps.gather(-1, run_end) / torch.clamp(total_neg, min=1e-12)
    first = 0.5 * tpr[..., 0] * fpr[..., 0]
    rest = torch.sum(0.5 * (tpr[..., 1:] + tpr[..., :-1]) * (fpr[..., 1:] - fpr[..., :-1]), dim=-1)
    defined = (total_pos[..., 0] > 0) & (total_neg[..., 0] > 0)
    return torch.where(defined, first + rest, torch.nan)


def binary_auroc_max_fpr_weighted(scores: Tensor, y: Tensor, w: Tensor, max_fpr: float) -> Tensor:
    """Weighted partial AUC (1-D) with the McClish standardisation: the ROC
    interpolated at ``max_fpr``, integrated on ``[0, max_fpr]`` and mapped
    to ``0.5 * (1 + (pauc - min) / (max - min))``."""
    _, valid, tps, fps, run_end, _ = _weighted_sorted_cumulants(scores, y, w)
    total_pos, total_neg = tps[-1], fps[-1]
    zero = tps.new_zeros(1)
    tpr = torch.cat([zero, tps[run_end] / torch.clamp(total_pos, min=1e-12)])
    fpr = torch.cat([zero, fps[run_end] / torch.clamp(total_neg, min=1e-12)])
    idx = torch.arange(run_end.shape[0], device=run_end.device)
    is_point = torch.cat([torch.ones(1, dtype=torch.bool, device=valid.device), (run_end == idx) & valid])
    # clamp the curve to fpr <= max_fpr: points beyond collapse onto the
    # interpolated boundary point, so the trapezoid over ALL points equals
    # the truncated integral (non-points repeat their run-end neighbour)
    fpr_mono = torch.cummax(torch.where(is_point, fpr, float("-inf")), dim=0).values
    tpr_mono = torch.cummax(torch.where(is_point, tpr, 0.0), dim=0).values
    below = fpr_mono <= max_fpr
    # the tpr at max_fpr between the two points that straddle it
    idx_hi = torch.clamp(below.sum(), 1, fpr_mono.shape[0] - 1).reshape(1)
    f_lo, f_hi = fpr_mono.gather(0, idx_hi - 1)[0], fpr_mono.gather(0, idx_hi)[0]
    t_lo, t_hi = tpr_mono.gather(0, idx_hi - 1)[0], tpr_mono.gather(0, idx_hi)[0]
    t_at = torch.where(f_hi > f_lo, t_lo + (t_hi - t_lo) * (max_fpr - f_lo) / torch.clamp(f_hi - f_lo, min=1e-12), t_lo)
    fpr_c = torch.where(below, fpr_mono, max_fpr)
    tpr_c = torch.where(below, tpr_mono, t_at)
    area = torch.sum(0.5 * (tpr_c[1:] + tpr_c[:-1]) * (fpr_c[1:] - fpr_c[:-1]))
    min_area = 0.5 * max_fpr * max_fpr
    max_area = max_fpr
    pauc = 0.5 * (1.0 + (area - min_area) / max(max_area - min_area, 1e-12))
    return torch.where((total_pos > 0) & (total_neg > 0), pauc, torch.nan)


def binary_roc_weighted(scores: Tensor, y: Tensor, w: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Weighted ROC points ``(fpr, tpr, thresholds, point_mask)`` in the
    fixed-kernel layout (a leading (0, 0) point at ``thresholds[0] + 1``),
    along the last axis."""
    sorted_key, valid, tps, fps, run_end, _ = _weighted_sorted_cumulants(scores, y, w)
    total_pos, total_neg = tps[..., -1:], fps[..., -1:]
    idx = torch.arange(sorted_key.shape[-1], device=sorted_key.device)
    is_threshold = (run_end == idx) & valid
    zero = tps.new_zeros(tps.shape[:-1] + (1,))
    tpr = torch.cat([zero, tps / torch.clamp(total_pos, min=1e-12)], dim=-1)
    fpr = torch.cat([zero, fps / torch.clamp(total_neg, min=1e-12)], dim=-1)
    thresholds = torch.cat([sorted_key[..., :1] + 1.0, sorted_key], dim=-1)
    point_mask = torch.cat([valid.any(dim=-1, keepdim=True), is_threshold], dim=-1)
    return fpr, tpr, thresholds, point_mask


def binary_prc_weighted(scores: Tensor, y: Tensor, w: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Weighted precision-recall points ``(precision, recall, thresholds,
    point_mask)`` in descending score order, cut where full recall is
    reached; callers reverse them and append ``(1, 0)``."""
    sorted_key, valid, tps, fps, run_end, run_start = _weighted_sorted_cumulants(scores, y, w)
    total_pos = tps[..., -1:]
    idx = torch.arange(sorted_key.shape[-1], device=sorted_key.device)
    is_threshold = (run_end == idx) & valid
    prev_end_tps = torch.where(run_start > 0, tps.gather(-1, torch.clamp(run_start - 1, min=0)), 0.0)
    # the strict comparison needs a tolerance under weighted (inexact) masses
    reached = prev_end_tps < total_pos - 1e-6 * torch.clamp(total_pos, min=1.0)
    is_threshold = is_threshold & (reached | (run_start == 0))
    precision = tps / torch.clamp(tps + fps, min=1e-12)
    recall = torch.where(total_pos > 0, tps / torch.clamp(total_pos, min=1e-12), torch.nan)
    return precision, recall, sorted_key, is_threshold


def binary_average_precision_weighted(scores: Tensor, y: Tensor, w: Tensor) -> Tensor:
    """Weighted average precision (the step sum over deduplicated
    thresholds) along the last axis; NaN where no positive mass."""
    _, valid, tps, fps, run_end, _ = _weighted_sorted_cumulants(scores, y, w)
    total_pos = tps[..., -1]
    precision = tps / torch.clamp(tps + fps, min=1e-12)
    step = torch.diff(tps, dim=-1, prepend=tps.new_zeros(tps.shape[:-1] + (1,)))
    contributions = step * precision.gather(-1, run_end) * valid
    ap = torch.sum(contributions, dim=-1) / torch.clamp(total_pos, min=1e-12)
    return torch.where(total_pos > 0, ap, torch.nan)


def weighted_class_supports(y_cols: Tensor, w: Tensor) -> Tensor:
    """Per-class positive weight mass ``[C]`` for weighted averaging."""
    return torch.sum(w[:, None] * y_cols, dim=0)


def average_class_scores(scores_per_class: Tensor, supports: Tensor, average: Optional[str]) -> Tensor:
    """macro / weighted / none averaging over per-class scores, excluding
    classes with zero positive mass (absent tail classes must not poison
    sharded evaluations)."""
    defined = supports > 0
    any_defined = defined.any()
    if average in (None, "none"):
        return scores_per_class
    zero = torch.zeros_like(scores_per_class)
    if average == "macro":
        val = torch.where(defined, scores_per_class, zero).sum() / torch.clamp(defined.sum(), min=1)
        return torch.where(any_defined, val, torch.nan)
    if average == "weighted":
        wts = torch.where(defined, supports, zero)
        val = (torch.where(defined, scores_per_class, zero) * wts).sum() / torch.clamp(wts.sum(), min=1e-12)
        return torch.where(any_defined, val, torch.nan)
    raise ValueError(
        f"Argument `average` expected to be one of ('macro', 'weighted', 'none', None) but got {average}"
    )
