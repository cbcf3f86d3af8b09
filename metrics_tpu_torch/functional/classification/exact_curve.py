"""Exact curve metrics with fixed shapes: a capacity buffer and a validity mask.

Counterpart of the part of ``metrics_tpu/functional/classification/
exact_curve.py`` that the binary capacity mode of ``AUROC`` needs: the
buffer triple (``curve_buffer_*``), the masked run-end cumulants and the
binary AUROC over them. Ties are resolved without data-dependent shapes:
after the descending sort, every position reads the cumulative counts at
the END of its equal-score run, so positions inside a run carry identical
curve points and the trapezoid equals the deduplicated-threshold integral.
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
    neg_inf = torch.tensor(float("-inf"), device=preds.device)
    key = torch.where(valid, preds.to(torch.float32), neg_inf)
    sorted_key, sorted_tgt, sorted_valid = stable_sort_with_payloads(
        key, torch.where(valid, target, 0).to(torch.float32), valid, descending=True
    )
    tps = torch.cumsum(sorted_tgt, dim=-1)
    fps = torch.cumsum((1.0 - sorted_tgt) * sorted_valid, dim=-1)
    run_end, run_start = _run_ends(sorted_key)
    return sorted_key, sorted_valid, tps, fps, run_end, run_start


def binary_auroc_fixed(preds: Tensor, target: Tensor, valid: Tensor) -> Tensor:
    """Exact binary AUROC over the valid entries (tie-exact): the trapezoid
    over run-end ROC points. NaN when either class is absent."""
    _, _, tps, fps, run_end, _ = _masked_sorted_cumulants(preds, target, valid)
    total_pos, total_neg = tps[-1], fps[-1]
    tpr = tps[run_end] / torch.clamp(total_pos, min=1.0)
    fpr = fps[run_end] / torch.clamp(total_neg, min=1.0)
    first = 0.5 * tpr[0] * fpr[0]  # the segment from the implicit (0, 0) point
    rest = torch.sum(0.5 * (tpr[1:] + tpr[:-1]) * (fpr[1:] - fpr[:-1]))
    return torch.where((total_pos > 0) & (total_neg > 0), first + rest, torch.nan)
