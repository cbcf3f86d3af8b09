"""Rank sketch: streaming Spearman over a reservoir of (pred, target) pairs.

Counterpart of ``metrics_tpu/sketches/rank.py``. Spearman needs the joint
rank distribution of the pairs, which a quantile sketch keyed on one of
them cannot carry; a uniform sample of pairs can. Spearman over a ``k``-row
Gumbel reservoir (:func:`~metrics_tpu_torch.sketches.reservoir.reservoir_insert`)
is unbiased with a standard error of about ``(1 - rho**2) / sqrt(k)``, and
inside the lossless window (stream of at most ``k`` pairs) the reservoir
is the stream in arrival order, so the exact tie-averaged kernel applies.

The state is a reservoir leaf ``[capacity, 3]`` (priority, pred, target).
:func:`ranksketch_spearman` is the fixed-shape query past the window:
midranks weighted by occupancy, then the exact kernel's eps-regularised,
clipped Pearson of ranks. Its sums are fixed-order (``_tree_sum``,
``_scan_fixed``), so the card and the CPU give the same bits.
"""
from typing import Any, Optional

import torch

from metrics_tpu_torch.sketches.reservoir import reservoir_init, reservoir_insert, reservoir_merge, reservoir_merge_fx
from metrics_tpu_torch.utils.data import _as_tensor, _scan_fixed, _tie_runs, _tree_sum

Tensor = torch.Tensor

ranksketch_merge = reservoir_merge
ranksketch_merge_fx = reservoir_merge_fx


def ranksketch_init(capacity: int, device: Optional[Any] = None) -> Tensor:
    """Fresh ``[capacity, 3]`` (priority, pred, target) reservoir on
    ``device`` (the card unless ``device="cpu"``)."""
    return reservoir_init(capacity, payload_cols=2, device=device)


def ranksketch_insert(
    sketch: Tensor, preds: Any, target: Any, seen: Any, seed: int = 0, n_valid: Optional[Any] = None
) -> Tensor:
    """Insert (pred, target) pairs as float32; pure. ``seen`` is the
    caller's count of pairs inserted before (it seeds the priority draw)."""
    device = sketch.device
    preds = _as_tensor(preds, device).to(torch.float32).reshape(-1)
    target = _as_tensor(target, device).to(torch.float32).reshape(-1)
    return reservoir_insert(sketch, torch.stack([preds, target], dim=1), seen, seed=seed, n_valid=n_valid)


def _weighted_midranks(values: Tensor, weights: Tensor) -> Tensor:
    """Weighted tie-averaged midranks: a run of equal values of weight mass
    ``W`` preceded by mass ``S`` ranks at ``S + (W + 1) / 2`` (unit weights
    give the classic average ranks). Zero-weight rows sort last. A run's
    mass is the difference of two prefix sums, exact for the 0/1
    occupancy weights the sketch gives it."""
    n = values.shape[0]
    order = torch.sort(torch.where(weights > 0, values, torch.inf), stable=True).indices
    sv, sw = values[order], weights[order]
    cum = _scan_fixed(sw)
    start, end = _tie_runs(sv)
    group_end = cum[end]
    before = torch.where(start > 0, cum[(start - 1).clamp(min=0)], torch.zeros_like(cum))
    group_w = group_end - before
    midrank = group_end - group_w + (group_w + 1.0) / 2.0
    return torch.zeros(n, dtype=torch.float32, device=values.device).scatter(0, order, midrank.to(torch.float32))


def ranksketch_spearman(sketch: Tensor, eps: float = 1e-6) -> Tensor:
    """Spearman correlation of the sampled pairs (fixed shape): occupancy-
    weighted midranks, then the exact kernel's Pearson of ranks."""
    w = (sketch[:, 0] > -torch.inf).to(torch.float32)
    preds, target = sketch[:, 1], sketch[:, 2]
    total = torch.clamp(_tree_sum(w), min=1e-12)
    rp = _weighted_midranks(preds, w)
    rt = _weighted_midranks(target, w)
    mp = _tree_sum(w * rp) / total
    mt = _tree_sum(w * rt) / total
    dp = torch.where(w > 0, rp - mp, 0.0)
    dt = torch.where(w > 0, rt - mt, 0.0)
    cov = _tree_sum(w * dp * dt) / total
    sp = torch.sqrt(_tree_sum(w * dp * dp) / total)
    st = torch.sqrt(_tree_sum(w * dt * dt) / total)
    return torch.clamp(cov / (sp * st + eps), -1.0, 1.0)
