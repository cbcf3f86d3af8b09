"""Reference-vs-live distribution drift: PSI / KL / JS / total variation
over sketch histograms and categorical count leaves.

The port's own copy of ``metrics_tpu/observability/drift.py``: the
windowed layer answers "what is the metric now"; this module answers "is
*now* still the same distribution as *then*". Everything reduces to
fixed-shape histogram arithmetic in float32 on the histograms' device:

* a **quantile-sketch window** (a ``TelemetrySeries.window_sketch`` fold,
  or a ``WindowedMetric`` ring row's merge leaf) histograms over SHARED
  STATIC edges via :func:`~metrics_tpu_torch.sketches.quantile.
  qsketch_histogram` (``segment_sum_f32`` on the card, one launch per
  side);
* a **categorical count leaf** (a confusion matrix, per-class totals —
  any sum-reduced non-negative array) is already a histogram after
  flattening.

Normalized histograms then compare through the standard scores:

========  ============================================================
``psi``   Population Stability Index ``sum((p-q) * ln(p/q))`` — the
          industry drift score; > 0.1 is "investigate", > 0.25 "act".
``kl``    ``KL(live || reference)`` in nats — asymmetric, unbounded.
``js``    Jensen–Shannon divergence — symmetric, bounded by ``ln 2``.
``tv``    Total variation ``0.5 * sum(|p-q|)`` — bounded by 1; the
          natural score for categorical (confusion-matrix) leaves.
========  ============================================================

Histograms are floored at :data:`DRIFT_EPS` relative mass before they
compare (the JAX package's floor), so a bin empty on one side contributes
a large-but-finite term instead of ``inf``. Each score is one float read
back to the host. The :class:`~metrics_tpu_torch.observability.health.
DriftRule` turns these scores into the seventh standard alarm class.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = [
    "DRIFT_STATS",
    "categorical_drift",
    "histogram_drift",
    "js_divergence_hist",
    "kl_divergence_hist",
    "normalize_histogram",
    "psi_divergence",
    "reference_edges",
    "sketch_drift",
    "state_drift",
    "total_variation",
]

#: the drift statistics every comparator in this module reports
DRIFT_STATS = ("psi", "kl", "js", "tv")

#: RELATIVE smoothing mass per bin (added after normalizing) — the
#: standard PSI zero-bin floor. Absolute-count smoothing would scale the
#: floor with the histogram's total weight, making an empty bin's
#: log-ratio explode for well-sampled references and vanish for tiny ones;
#: a relative floor bounds every per-bin log term by ``ln(1/eps)``
#: regardless of sample counts, so scores rank severity instead of
#: measuring how many samples happened to be in the window.
DRIFT_EPS = 1e-4


def _f32(x: Any, device: Optional[Any] = None) -> torch.Tensor:
    """``x`` as a float32 tensor (a tensor stays on its device; host data
    goes to ``device``, the CPU by default)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def normalize_histogram(hist: Any, eps: float = DRIFT_EPS) -> torch.Tensor:
    """Flatten, clip negatives (defensive: counts are non-negative by
    contract), normalize to a probability vector, then floor every bin at
    ``eps`` relative mass (renormalized). An all-zero histogram reads as
    uniform — two empty sides compare as identical, not as NaN."""
    h = torch.clamp(_f32(hist).reshape(-1), min=0.0)
    total = torch.sum(h)
    p = torch.where(total > 0, h / torch.clamp(total, min=1e-30), torch.full_like(h, 1.0 / h.shape[0]))
    p = p + eps
    return p / torch.sum(p)


def psi_divergence(p: Any, q: Any, eps: float = DRIFT_EPS) -> float:
    """Population Stability Index between two (un)normalized histograms."""
    p, q = normalize_histogram(p, eps), normalize_histogram(q, eps)
    return float(torch.sum((p - q) * torch.log(p / q)))


def kl_divergence_hist(p: Any, q: Any, eps: float = DRIFT_EPS) -> float:
    """``KL(p || q)`` in nats between two (un)normalized histograms."""
    p, q = normalize_histogram(p, eps), normalize_histogram(q, eps)
    return float(torch.sum(p * torch.log(p / q)))


def js_divergence_hist(p: Any, q: Any, eps: float = DRIFT_EPS) -> float:
    """Jensen–Shannon divergence (symmetric, ``<= ln 2``)."""
    p, q = normalize_histogram(p, eps), normalize_histogram(q, eps)
    m = (p + q) / 2.0
    return float(0.5 * torch.sum(p * torch.log(p / m)) + 0.5 * torch.sum(q * torch.log(q / m)))


def total_variation(p: Any, q: Any, eps: float = DRIFT_EPS) -> float:
    """Total variation distance ``0.5 * sum(|p - q|)`` (``<= 1``)."""
    p, q = normalize_histogram(p, eps), normalize_histogram(q, eps)
    return float(0.5 * torch.sum(torch.abs(p - q)))


def reference_edges(sketch: Any, n_bins: int = 16, pad_frac: float = 0.01) -> np.ndarray:
    """Static histogram edges spanning a reference sketch's occupied keys.

    Derived ONCE at reference-freeze time and then shared by every
    comparison — shared static edges are what keep the live-side
    ``qsketch_histogram`` a fixed-shape op (and the scores comparable
    across evaluations). The span is padded by ``pad_frac`` so live mass
    drifting slightly past the reference extremes still lands in the edge
    bins rather than all clamping into one."""
    if not isinstance(n_bins, int) or n_bins < 2:
        raise ValueError(f"`n_bins` must be an int >= 2, got {n_bins!r}")
    arr = sketch.detach().cpu().numpy() if isinstance(sketch, torch.Tensor) else np.asarray(sketch)
    occ = arr[arr[:, 0] > 0]
    if occ.size == 0:
        raise ValueError("cannot derive edges from an empty sketch (total weight 0)")
    lo, hi = float(occ[:, 1].min()), float(occ[:, 1].max())
    span = max(hi - lo, 1e-6)
    return np.linspace(lo - pad_frac * span, hi + pad_frac * span, n_bins + 1)


def sketch_drift(reference: Any, live: Any, edges: Any) -> Dict[str, float]:
    """All four drift scores between two quantile sketches histogrammed
    over shared static ``edges`` (reference first: ``kl`` reads as
    ``KL(live || reference)``, the "how surprised is the reference model
    by live traffic" direction)."""
    from metrics_tpu_torch.sketches.quantile import qsketch_histogram

    reference = _f32(reference)
    live = _f32(live, reference.device)
    edges = _f32(edges, reference.device)
    ref_hist = qsketch_histogram(reference, edges)
    live_hist = qsketch_histogram(live, edges.to(live.device))
    return histogram_drift(ref_hist, live_hist)


def histogram_drift(ref_hist: Any, live_hist: Any) -> Dict[str, float]:
    """All four drift scores between two pre-binned histograms. PSI, JS,
    and TV are symmetric; ``kl`` is oriented ``KL(live || reference)``.

    One normalization per side and one fused dispatch chain serve all
    four scores — this runs on every monitor tick per drift rule, so the
    per-score public functions (which re-normalize) are not called here.
    """
    p = normalize_histogram(ref_hist)  # reference
    q = normalize_histogram(live_hist).to(p.device)  # live
    log_pq = torch.log(p / q)
    m = (p + q) / 2.0
    scores = torch.stack(
        [
            torch.sum((p - q) * log_pq),  # psi (symmetric)
            torch.sum(q * -log_pq),  # KL(live || reference)
            0.5 * torch.sum(p * torch.log(p / m)) + 0.5 * torch.sum(q * torch.log(q / m)),  # js
            0.5 * torch.sum(torch.abs(p - q)),  # tv
        ]
    )
    host = [float(v) for v in scores.tolist()]  # one read of the four scores
    return dict(zip(DRIFT_STATS, host))


def categorical_drift(ref_counts: Any, live_counts: Any) -> Dict[str, float]:
    """Drift scores between two categorical count leaves (confusion
    matrices, per-class totals): the flattened counts ARE the histograms.
    ``tv`` is the headline score here — bounded, symmetric, and exactly
    the fraction of probability mass that moved between cells."""
    ref = _f32(ref_counts)
    live = _f32(live_counts, ref.device)
    if ref.shape != live.shape:
        # compared BEFORE ravel: a transposed leaf has the same size but
        # misaligned cells, and scoring it would read pure layout skew as
        # drift
        raise ValueError(
            f"categorical drift needs same-shaped count leaves, got"
            f" {tuple(ref.shape)} vs {tuple(live.shape)}"
        )
    return histogram_drift(ref.reshape(-1), live.reshape(-1))


def state_drift(
    metric: Any,
    reference_state: Dict[str, Any],
    live_state: Dict[str, Any],
    edges: Optional[Any] = None,
    n_bins: int = 16,
) -> Dict[str, Dict[str, float]]:
    """Per-leaf drift between two window folds of the same metric — e.g.
    ``WindowedMetric.window_state(w, before=w)`` (reference) vs
    ``.window_state(w)`` (live).

    Sketch (``merge``-reduced) leaves compare via :func:`sketch_drift`
    over shared edges (derived from the reference leaf when ``edges`` is
    not given); multi-element sum-reduced count leaves (confusion-matrix
    shape) via :func:`categorical_drift`. Scalar leaves have no
    distribution and are skipped — compare their computed values directly.
    """
    from metrics_tpu_torch.utils.data import dim_zero_sum

    out: Dict[str, Dict[str, float]] = {}
    for name, red in metric._reductions.items():
        if name not in reference_state or name not in live_state:
            continue
        ref, live = reference_state[name], live_state[name]
        # sum-shaped covers both a bare metric's dim_zero_sum leaves and a
        # WindowedMetric's tagged ring/decay sum reducers — window folds
        # are template-shaped either way, so passing the wrapper itself
        # must not silently skip its categorical leaves
        sum_shaped = red is dim_zero_sum or getattr(red, "inner_reduce", None) == "sum"
        if getattr(red, "merge_like", False):
            if getattr(red, "sketch_kind", "quantile") != "quantile":
                # reservoir/rank leaves pack [priority, payload...] rows —
                # column 0 is a Gumbel PRIORITY, not a weight, and reading
                # it as one scores identical distributions as drifted
                continue
            ref_arr = ref.detach().cpu().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
            if ref_arr.ndim != 2 or not (ref_arr[:, 0] > 0).any():
                continue  # empty reference window: nothing to anchor on
            leaf_edges = edges if edges is not None else reference_edges(ref_arr, n_bins=n_bins)
            out[name] = sketch_drift(ref, live, leaf_edges)
        elif sum_shaped and _f32(ref).numel() > 1:
            out[name] = categorical_drift(ref, live)
    return out
