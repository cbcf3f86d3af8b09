"""The benchmark's plain reference: float64 arithmetic in plain PyTorch,
written from the definitions and frozen here. It imports nothing of the
program and takes nothing the program made: it is handed the inputs the
benchmark generated and works out again what the program derives from them.

* :func:`multiclass_auroc` -- one-vs-rest AUROC from midranks (ties share
  their mean rank), per class and the macro mean over defined classes;
* :func:`confusion_matrix` -- ``bincount(target * C + argmax)``;
* :func:`topk_accuracy` -- the share of rows whose label is among the ``k``
  highest scores;
* :func:`binary_auroc` / :func:`binary_average_precision` -- the exact
  binary curves (midranks; the step sum over distinct thresholds);
* :func:`sketch_insert` -- a plain copy of the program's quantile-sketch
  absorb (stable pack; past capacity one merging-t-digest compaction on the
  ``k1(q) = capacity / 2pi * asin(2q - 1)`` scale into ``capacity // 2 + 4``
  centroids), in float64, with ``store_dtype`` the precision the rows are
  kept in between absorbs (the control keeps them in bfloat16);
* :func:`weighted_auroc` / :func:`weighted_average_precision` -- the same
  curves over weighted rows (a sketch's centroids);
* :func:`sketch_w1_gap` / :func:`sketch_mass_gap` -- how far two sketches'
  weighted key distributions lie apart.

Everything runs on the tensors' device, in blocks where the inputs are large.
"""
import math
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor
F64 = torch.float64


# ---------------------------------------------------------------------------
# multiclass
# ---------------------------------------------------------------------------


def midranks_sorted(sorted_vals: Tensor) -> Tensor:
    """1-based midranks of rows sorted ascending along the last axis."""
    n = sorted_vals.shape[-1]
    idx = torch.arange(n, device=sorted_vals.device).expand_as(sorted_vals)
    starts = torch.ones_like(sorted_vals, dtype=torch.bool)
    starts[..., 1:] = sorted_vals[..., 1:] != sorted_vals[..., :-1]
    ends = torch.ones_like(starts)
    ends[..., :-1] = starts[..., 1:]
    first = torch.cummax(torch.where(starts, idx, 0), dim=-1).values
    last = torch.flip(torch.cummin(torch.flip(torch.where(ends, idx, n - 1), [-1]), dim=-1).values, [-1])
    return (first + last).to(F64) / 2 + 1


def multiclass_auroc(preds: Tensor, target: Tensor, num_classes: int, block: int = 100) -> Tuple[Tensor, float]:
    """``(per-class AUROC [C] float64, macro mean over the classes that have
    positives and negatives)`` of ``[N, C]`` scores and ``[N]`` labels."""
    n = preds.shape[0]
    target = target.to(torch.int64)
    rank_sum = torch.zeros(num_classes, dtype=F64, device=preds.device)
    rows = torch.arange(n, device=preds.device)
    for lo in range(0, num_classes, block):
        hi = min(lo + block, num_classes)
        cols = preds[:, lo:hi].to(F64).T.contiguous()
        srt, order = torch.sort(cols, dim=1)
        ranks = torch.empty_like(srt).scatter_(1, order, midranks_sorted(srt))
        mine = (target >= lo) & (target < hi)
        own = ranks[target[mine] - lo, rows[mine]]
        rank_sum.index_add_(0, target[mine], own)
    n_pos = torch.bincount(target, minlength=num_classes).to(F64)
    n_neg = n - n_pos
    defined = (n_pos > 0) & (n_neg > 0)
    auc = (rank_sum - n_pos * (n_pos + 1) / 2) / torch.where(defined, n_pos * n_neg, 1.0)
    auc = torch.where(defined, auc, torch.nan)
    return auc, float(auc[defined].mean())


def confusion_matrix(preds: Tensor, target: Tensor, num_classes: int) -> Tensor:
    """``[C, C]`` int64 counts, rows the label, columns the first highest score."""
    pred = preds.argmax(dim=1)
    ids = target.to(torch.int64) * num_classes + pred
    return torch.bincount(ids, minlength=num_classes * num_classes).reshape(num_classes, num_classes)


def topk_accuracy(preds: Tensor, target: Tensor, k: int, block: int = 8192) -> float:
    """Share of rows whose label is among the ``k`` highest scores (top 1:
    the first highest score; past it, fewer than ``k`` scores above the
    label's)."""
    hits = 0
    for lo in range(0, preds.shape[0], block):
        p, t = preds[lo : lo + block].to(F64), target[lo : lo + block].to(torch.int64)
        if k == 1:
            hits += int((p.argmax(dim=1) == t).sum())
        else:
            own = p.gather(1, t[:, None])
            hits += int(((p > own).sum(dim=1) < k).sum())
    return hits / preds.shape[0]


# ---------------------------------------------------------------------------
# binary, exact
# ---------------------------------------------------------------------------


def binary_auroc(score: Tensor, y: Tensor) -> float:
    """Exact binary AUROC from float64 midranks."""
    srt, order = torch.sort(score.to(F64))
    ranks = torch.empty_like(srt).scatter_(0, order, midranks_sorted(srt))
    pos = y.to(torch.bool)
    n_pos = float(pos.sum())
    n_neg = y.numel() - n_pos
    return (float(ranks[pos].sum()) - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


def binary_average_precision(score: Tensor, y: Tensor) -> float:
    """Exact average precision: the step sum over distinct thresholds."""
    return weighted_average_precision(score, y.to(F64), torch.ones_like(score, dtype=F64))


# ---------------------------------------------------------------------------
# weighted curves (over a sketch's centroids)
# ---------------------------------------------------------------------------


def _run_end_cumulants(key: Tensor, y: Tensor, w: Tensor) -> Tuple[Tensor, Tensor]:
    """Cumulative positive and negative mass at the end of each run of equal
    keys, keys descending; rows of weight 0 left out."""
    keep = w > 0
    key, y, w = key[keep].to(F64), y[keep].to(F64), w[keep].to(F64)
    order = torch.sort(key, descending=True, stable=True).indices
    key, wy, w = key[order], (w * y)[order], w[order]
    tps = torch.cumsum(wy, 0)
    fps = torch.cumsum(w - wy, 0)
    _, counts = torch.unique_consecutive(key, return_counts=True)
    run_end = torch.cumsum(counts, 0) - 1
    return tps[run_end], fps[run_end]


def weighted_auroc(key: Tensor, y: Tensor, w: Tensor) -> float:
    """Trapezoid area under the weighted ROC through the runs' end points
    from (0, 0); NaN without positive or negative mass."""
    tps, fps = _run_end_cumulants(key, y, w)
    if tps.numel() == 0 or tps[-1] <= 0 or fps[-1] <= 0:
        return math.nan
    zero = tps.new_zeros(1)
    tpr = torch.cat([zero, tps / tps[-1]])
    fpr = torch.cat([zero, fps / fps[-1]])
    return float(torch.sum(0.5 * (tpr[1:] + tpr[:-1]) * (fpr[1:] - fpr[:-1])))


def weighted_average_precision(key: Tensor, y: Tensor, w: Tensor) -> float:
    """Sum over runs of (positive mass of the run) x (precision at its end),
    over the total positive mass; NaN without positive mass."""
    tps, fps = _run_end_cumulants(key, y, w)
    if tps.numel() == 0 or tps[-1] <= 0:
        return math.nan
    step = torch.diff(tps, prepend=tps.new_zeros(1))
    return float(torch.sum(step * tps / (tps + fps)) / tps[-1])


# ---------------------------------------------------------------------------
# the quantile sketch's absorb
# ---------------------------------------------------------------------------


def sketch_init(capacity: int, payload_cols: int, device: torch.device) -> Tensor:
    """An empty sketch: ``[capacity, 2 + payload_cols]`` rows (weight, key,
    payload), float64."""
    return torch.zeros((capacity, 2 + payload_cols), dtype=F64, device=device)


def _pack(rows: Tensor) -> Tensor:
    """Occupied rows (weight > 0) first, each group in its own order."""
    occupied = rows[:, 0] > 0
    order = torch.cat([torch.nonzero(occupied).flatten(), torch.nonzero(~occupied).flatten()])
    return rows[order]


def _compact(rows: Tensor, capacity: int) -> Tensor:
    """One compaction of packed rows into ``capacity // 2 + 4`` centroids:
    rows sorted by key (unoccupied last, ties by position), each row's
    bucket from the midpoint of its cumulative weight on the k1 scale, the
    weighted payload summed per bucket and divided back."""
    n_seg = capacity // 2 + 4
    w = rows[:, 0]
    occupied = w > 0
    key = torch.where(occupied, rows[:, 1], torch.inf)
    key = torch.where(key == 0, torch.zeros_like(key), key)  # -0.0 sorts as +0.0
    order = torch.sort(key, stable=True).indices
    srt = rows[order]
    sw = srt[:, 0]
    total = torch.clamp(sw.sum(), min=1e-30)
    q = torch.clamp((torch.cumsum(sw, 0) - sw / 2) / total, 0.0, 1.0)
    k = capacity / (2.0 * math.pi) * torch.asin(2.0 * q - 1.0)
    bucket = torch.clamp(torch.floor(k).to(torch.int64) + capacity // 4 + 1, 0, n_seg - 1)
    weighted = torch.cat([sw[:, None], sw[:, None] * srt[:, 1:]], dim=1)
    sums = torch.zeros((n_seg, rows.shape[1]), dtype=rows.dtype, device=rows.device).index_add_(0, bucket, weighted)
    out = torch.zeros_like(rows)
    out[:n_seg, 0] = sums[:, 0]
    out[:n_seg, 1:] = sums[:, 1:] / torch.clamp(sums[:, :1], min=1e-30)
    return _pack(out)


def _absorb(sketch: Tensor, new_rows: Tensor) -> Tensor:
    capacity = sketch.shape[0]
    packed = _pack(torch.cat([sketch, new_rows], dim=0))
    if int((packed[:, 0] > 0).sum()) > capacity:
        packed = _compact(packed, capacity)
    return packed[:capacity]


def sketch_insert(sketch: Tensor, key: Tensor, payload: Tensor, store_dtype: torch.dtype = F64) -> Tensor:
    """Insert unit-weight rows ``(key [B], payload [B, P])`` into ``sketch``
    in capacity-sized chunks, as the program absorbs a batch. Inputs and the
    kept rows are rounded to ``store_dtype`` (float64: no rounding)."""
    capacity = sketch.shape[0]
    key = key.to(store_dtype).to(F64).reshape(-1)
    payload = payload.to(store_dtype).to(F64).reshape(key.shape[0], -1)
    rows = torch.cat([torch.ones_like(key)[:, None], key[:, None], payload], dim=1)
    for lo in range(0, rows.shape[0], capacity):
        sketch = _absorb(sketch, rows[lo : lo + capacity]).to(store_dtype).to(F64)
    return sketch


def _weighted_cdf(rows: Tensor, xs: Tensor, column: Optional[int]) -> Tensor:
    """Share of the weight (``column`` None) or of the weighted payload
    column ``column`` carried by rows whose key is at most each of ``xs``."""
    rows = rows.to(F64)
    w = rows[:, 0]
    mass = w if column is None else w * rows[:, column]
    keep = w > 0
    key, mass = rows[keep, 1], mass[keep]
    order = torch.sort(key).indices
    key, cum = key[order], torch.cumsum(mass[order], 0)
    total = torch.clamp(cum[-1:], min=1e-30)
    at = torch.searchsorted(key, xs, right=True)
    below = torch.where(at > 0, cum[torch.clamp(at - 1, min=0)], 0.0)
    return below / total


def sketch_w1_gap(got: Tensor, want: Tensor) -> float:
    """Earth mover's (Wasserstein-1) distance between two sketches' weighted
    key distributions, of the weight and of the positive mass (the first
    payload column), the larger of the two: the integral of the gap between
    the two cumulative distributions over the keys, in key units. Keys that
    differ by rounding move it by that rounding, not by a centroid's mass."""
    got, want = got.to(F64), want.to(F64)
    xs = torch.cat([got[got[:, 0] > 0, 1], want[want[:, 0] > 0, 1]]).sort().values
    if xs.numel() < 2:
        return 0.0
    widths = xs[1:] - xs[:-1]
    gaps = []
    for col in (None, 2):
        diff = (_weighted_cdf(got, xs, col) - _weighted_cdf(want, xs, col)).abs()
        gaps.append(float((diff[:-1] * widths).sum()))
    return max(gaps)


def sketch_mass_gap(got: Tensor, want: Tensor) -> float:
    """Relative gap of the total weight and of the total positive mass."""
    got, want = got.to(F64), want.to(F64)
    gaps = []
    for rows_got, rows_want in ((got[:, 0], want[:, 0]), (got[:, 0] * got[:, 2], want[:, 0] * want[:, 2])):
        total = float(rows_want.sum())
        gaps.append(abs(float(rows_got.sum()) - total) / max(total, 1e-30))
    return max(gaps)
