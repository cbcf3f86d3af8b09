"""Exact curve metrics with fixed shapes: a capacity buffer and a validity mask.

Counterpart of ``metrics_tpu/functional/classification/exact_curve.py``:
the buffer triple (``curve_buffer_*``), the masked run-end cumulants, and
the binary AUROC, average precision, ROC and precision-recall curve over
them, with their one-vs-rest forms for multiclass and multilabel buffers.
Ties are resolved without data-dependent shapes: after the descending
sort, every position reads the cumulative counts at the END of its
equal-score run, so positions inside a run carry identical curve points
and the trapezoid (or the step sum) equals the deduplicated-threshold one.

The binary kernels work along the last axis and batch over leading ones,
which takes the place of the JAX package's ``vmap`` over class columns:
``[C, N]`` class-major scores and targets share one ``[N]`` valid mask.
"""
from typing import Dict, Tuple

import torch

from metrics_tpu_torch.utils.data import stable_sort_with_payloads

Tensor = torch.Tensor


def curve_buffer_init(capacity: int, device: torch.device) -> Dict[str, Tensor]:
    """Fresh (preds, target, valid) buffer state on ``device``."""
    return {
        "preds": torch.zeros((capacity,), dtype=torch.float32, device=device),
        "target": torch.zeros((capacity,), dtype=torch.int32, device=device),
        "valid": torch.zeros((capacity,), dtype=torch.bool, device=device),
    }


def curve_buffer_update(state: Dict[str, Tensor], preds: Tensor, target: Tensor) -> Dict[str, Tensor]:
    """Write a batch into the first free slots (pure, no host read). The
    write positions come from the valid mask, so a merged buffer with holes
    keeps its valid entries; rows that find no free slot are dropped, as
    the JAX package's ``mode='drop'`` scatter drops them (the stateful
    wrapper raises on overflow before this)."""
    valid = state["valid"]
    capacity = valid.shape[0]
    # free slots first, in index order; a row whose slot is taken goes to a
    # spare slot past the end, which is cut off
    order = torch.sort(valid.to(torch.uint8), stable=True).indices[: preds.shape[0]]
    n = order.shape[0]
    dest = torch.where(valid[order], capacity, order)

    def put(buf: Tensor, rows: Tensor) -> Tensor:
        spare = buf.new_zeros((1,) + tuple(buf.shape[1:]))
        return torch.cat([buf, spare]).index_copy(0, dest, rows[:n].to(buf.dtype))[:capacity]

    return {
        "preds": put(state["preds"], preds),
        "target": put(state["target"], target),
        "valid": put(valid, torch.ones(n, dtype=torch.bool, device=valid.device)),
    }


def curve_buffer_merge(*states: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Concatenate buffers (such as per-process shards)."""
    return {key: torch.cat([s[key] for s in states]) for key in ("preds", "target", "valid")}


def _run_ends(sorted_key: Tensor) -> Tuple[Tensor, Tensor]:
    """``(run_end, run_start)``: the last and first index along the last
    axis sharing each position's key (keys sorted along that axis)."""
    n = sorted_key.shape[-1]
    idx = torch.arange(n, device=sorted_key.device).expand(sorted_key.shape)
    boundary = sorted_key[..., 1:] != sorted_key[..., :-1]
    edge = torch.ones(sorted_key.shape[:-1] + (1,), dtype=torch.bool, device=sorted_key.device)
    is_run_last = torch.cat([boundary, edge], dim=-1)
    is_run_first = torch.cat([edge, boundary], dim=-1)
    run_end = torch.cummin(torch.where(is_run_last, idx, n - 1).flip(-1), dim=-1).values.flip(-1)
    run_start = torch.cummax(torch.where(is_run_first, idx, 0), dim=-1).values
    return run_end, run_start


def _masked_sorted_cumulants(
    preds: Tensor, target: Tensor, valid: Tensor
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Sort by descending score (invalid rows last) and return
    ``(sorted_key, sorted_valid, tps, fps, run_end, run_start)``: the
    cumulative true/false positive counts and each position's tie run."""
    valid = valid.expand(preds.shape)
    neg_inf = torch.tensor(float("-inf"), device=preds.device)
    key = torch.where(valid, preds.to(torch.float32), neg_inf)
    sorted_key, sorted_tgt, sorted_valid = stable_sort_with_payloads(
        key, torch.where(valid, target, 0).to(torch.float32), valid, descending=True
    )
    tps = torch.cumsum(sorted_tgt, dim=-1)
    fps = torch.cumsum((1.0 - sorted_tgt) * sorted_valid, dim=-1)
    run_end, run_start = _run_ends(sorted_key)
    return sorted_key, sorted_valid, tps, fps, run_end, run_start


def _prepend(x: Tensor, value: Tensor) -> Tensor:
    """``value`` (a scalar or one per leading index) before the last axis of ``x``."""
    return torch.cat([value.to(x.dtype).expand(x.shape[:-1] + (1,)), x], dim=-1)


def binary_auroc_fixed(preds: Tensor, target: Tensor, valid: Tensor) -> Tensor:
    """Exact binary AUROC over the valid entries (tie-exact): the trapezoid
    over run-end ROC points. NaN when either class is absent."""
    _, _, tps, fps, run_end, _ = _masked_sorted_cumulants(preds, target, valid)
    total_pos, total_neg = tps[..., -1:], fps[..., -1:]
    tpr = tps.gather(-1, run_end) / torch.clamp(total_pos, min=1.0)
    fpr = fps.gather(-1, run_end) / torch.clamp(total_neg, min=1.0)
    first = 0.5 * tpr[..., 0] * fpr[..., 0]  # the segment from the implicit (0, 0) point
    rest = torch.sum(0.5 * (tpr[..., 1:] + tpr[..., :-1]) * (fpr[..., 1:] - fpr[..., :-1]), dim=-1)
    defined = (total_pos[..., 0] > 0) & (total_neg[..., 0] > 0)
    return torch.where(defined, first + rest, torch.nan)


def binary_average_precision_fixed(preds: Tensor, target: Tensor, valid: Tensor) -> Tensor:
    """Exact binary average precision over the valid entries: the step sum
    over deduplicated thresholds, each positive weighted by the precision
    at the END of its tie run. NaN when there is no positive."""
    _, sorted_valid, tps, fps, run_end, _ = _masked_sorted_cumulants(preds, target, valid)
    total_pos = tps[..., -1]
    precision = tps / torch.clamp(tps + fps, min=1.0)
    step = torch.diff(tps, dim=-1, prepend=tps.new_zeros(tps.shape[:-1] + (1,)))
    contributions = step * precision.gather(-1, run_end) * sorted_valid
    ap = torch.sum(contributions, dim=-1) / torch.clamp(total_pos, min=1.0)
    return torch.where(total_pos > 0, ap, torch.nan)


def binary_roc_fixed(preds: Tensor, target: Tensor, valid: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Fixed-shape ROC: ``(fpr, tpr, thresholds, point_mask)``, each
    ``[..., capacity + 1]``. The points where ``point_mask`` holds are the
    exact ROC: first the prepended (0, 0) at ``thresholds[0] + 1``, then one
    point per distinct threshold in descending score order. The other
    slots repeat a point of their run."""
    sorted_key, sorted_valid, tps, fps, run_end, _ = _masked_sorted_cumulants(preds, target, valid)
    total_pos, total_neg = tps[..., -1:], fps[..., -1:]
    idx = torch.arange(sorted_key.shape[-1], device=sorted_key.device)
    is_threshold = (run_end == idx) & sorted_valid
    zero = tps.new_zeros(())
    tpr = _prepend(tps / torch.clamp(total_pos, min=1.0), zero)
    fpr = _prepend(fps / torch.clamp(total_neg, min=1.0), zero)
    thresholds = torch.cat([sorted_key[..., :1] + 1.0, sorted_key], dim=-1)
    point_mask = torch.cat([sorted_valid.any(dim=-1, keepdim=True), is_threshold], dim=-1)
    return fpr, tpr, thresholds, point_mask


def binary_precision_recall_curve_fixed(
    preds: Tensor, target: Tensor, valid: Tensor
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Fixed-shape precision-recall curve: ``(precision, recall,
    thresholds, point_mask, last_point)``, arrays ``[..., capacity]`` in
    descending score order. The exact curve is the masked points REVERSED
    with ``last_point`` = (precision 1, recall 0) appended, as
    ``precision_recall_curve`` returns it; thresholds below the first one
    that reaches full recall are dropped, as there."""
    sorted_key, sorted_valid, tps, fps, run_end, run_start = _masked_sorted_cumulants(preds, target, valid)
    total_pos = tps[..., -1:]
    idx = torch.arange(sorted_key.shape[-1], device=sorted_key.device)
    is_threshold = (run_end == idx) & sorted_valid
    # a run is kept iff full recall was not reached strictly before it;
    # with no positive only the first (highest) threshold stays, as in the
    # unbounded curve
    prev_end_tps = torch.where(run_start > 0, tps.gather(-1, torch.clamp(run_start - 1, min=0)), 0.0)
    is_threshold = is_threshold & ((prev_end_tps < total_pos) | (run_start == 0))
    precision = tps / torch.clamp(tps + fps, min=1.0)
    recall = torch.where(total_pos > 0, tps / torch.clamp(total_pos, min=1.0), torch.nan)
    last_point = torch.tensor([1.0, 0.0], device=tps.device).expand(tps.shape[:-1] + (2,))
    return precision, recall, sorted_key, is_threshold, last_point


def _per_class_scores_targets(preds: Tensor, target: Tensor, num_classes: int, multilabel: bool) -> Tuple[Tensor, Tensor]:
    """``([C, N] scores, [C, N] 0/1 targets)`` for the one-vs-rest kernels,
    from ``[N, C]`` score rows and ``[N]`` labels (multiclass) or ``[N, C]``
    indicators (multilabel)."""
    scores = preds.to(torch.float32).T
    if multilabel:
        return scores, target.to(torch.int32).T
    classes = torch.arange(num_classes, device=target.device)
    return scores, (target[None, :] == classes[:, None]).to(torch.int32)


def multiclass_roc_fixed(
    preds: Tensor, target: Tensor, valid: Tensor, num_classes: int, multilabel: bool = False
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """One-vs-rest :func:`binary_roc_fixed` per class: ``(fpr, tpr,
    thresholds, point_mask)``, each ``[C, capacity + 1]``; row ``c`` is the
    exact ROC of class ``c`` against the rest."""
    scores, tgt = _per_class_scores_targets(preds, target, num_classes, multilabel)
    return binary_roc_fixed(scores, tgt, valid)


def multiclass_precision_recall_curve_fixed(
    preds: Tensor, target: Tensor, valid: Tensor, num_classes: int, multilabel: bool = False
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """One-vs-rest :func:`binary_precision_recall_curve_fixed` per class:
    arrays ``[C, capacity]`` and ``last_point [C, 2]``."""
    scores, tgt = _per_class_scores_targets(preds, target, num_classes, multilabel)
    return binary_precision_recall_curve_fixed(scores, tgt, valid)


def multiclass_average_precision_fixed(
    preds: Tensor,
    target: Tensor,
    valid: Tensor,
    num_classes: int,
    average: str = "macro",
    multilabel: bool = False,
) -> Tensor:
    """Exact one-vs-rest average precision over a fixed-capacity buffer.

    ``'macro'``/``'weighted'`` average over the classes with at least one
    positive (undefined classes are left out, as in the capacity-mode
    multiclass AUROC), NaN when no class is defined; ``'micro'`` flattens
    the scores against the one-vs-rest indicators; ``'none'``/``None``
    gives the per-class vector (NaN where undefined)."""
    scores, tgt = _per_class_scores_targets(preds, target, num_classes, multilabel)
    if average == "micro":
        flat_valid = valid[None, :].expand(tgt.shape).reshape(-1)
        return binary_average_precision_fixed(scores.reshape(-1), tgt.reshape(-1), flat_valid)
    ap = binary_average_precision_fixed(scores, tgt, valid)
    if average in (None, "none"):
        return ap
    n_pos = torch.sum(tgt * valid[None, :], dim=1).to(torch.float32)
    defined = n_pos > 0
    zero = torch.zeros_like(ap)
    if average == "macro":
        macro = torch.where(defined, ap, zero).sum() / torch.clamp(defined.sum(), min=1)
        return torch.where(defined.any(), macro, torch.nan)
    if average == "weighted":
        w = torch.where(defined, n_pos, zero)
        weighted = (torch.where(defined, ap, zero) * w).sum() / torch.clamp(w.sum(), min=1.0)
        return torch.where(defined.any(), weighted, torch.nan)
    raise ValueError(
        f"Argument `average` expected to be one of ('micro', 'macro', 'weighted', 'none') but got {average}"
    )
