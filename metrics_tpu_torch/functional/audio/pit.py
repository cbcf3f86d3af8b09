"""Permutation-invariant training.

Counterpart of ``metrics_tpu/functional/audio/pit.py``. Up to
``_MAX_EXHAUSTIVE_SPK = 6`` speakers (720 permutations) every permutation
is scored on the metric matrix's device: one gather of ``[B, P, spk]``, a
mean, then ``argmax``/``argmin`` (the first best index, as ``jnp.argmax``
takes). The permutation table is made once per speaker count and device,
so an update copies nothing to the card and reads nothing back. Past six
speakers the in-repo C++ Hungarian solver
(:func:`metrics_tpu_torch.native.lsap`) takes over, on the host: one read
of the ``[B, spk, spk]`` matrix, and one copy of the result back.

``best_perm`` is int32, the JAX package's dtype with x64 off.
"""
import functools
from itertools import permutations
from typing import Any, Callable, Tuple

import numpy as np
import torch

from metrics_tpu_torch.utils.data import _host_to_device

Tensor = torch.Tensor

_MAX_EXHAUSTIVE_SPK = 6


@functools.lru_cache(maxsize=None)
def _permutation_table(spk_num: int, device: torch.device) -> Tensor:
    """``[spk!, spk]`` int64 permutations in ``itertools.permutations``
    order, on ``device`` (made once: an update then copies nothing)."""
    return torch.tensor(list(permutations(range(spk_num))), dtype=torch.int64, device=device)


def _find_best_perm_exhaustive(metric_mtx: Tensor, eval_max: bool) -> Tuple[Tensor, Tensor]:
    """Score every permutation on the device; ``metric_mtx`` is
    ``[batch, spk, spk]`` with ``[b, target_i, pred_j]`` entries."""
    spk_num = metric_mtx.shape[-1]
    perms = _permutation_table(spk_num, metric_mtx.device)  # [P, spk]
    # score[b, p] = mean_i mtx[b, i, perms[p, i]]
    rows = torch.arange(spk_num, device=metric_mtx.device)
    gathered = metric_mtx[:, rows[None, :], perms]  # [batch, P, spk]
    scores = torch.mean(gathered, dim=-1)  # [batch, P]
    best_idx = torch.argmax(scores, dim=-1) if eval_max else torch.argmin(scores, dim=-1)
    best_metric = torch.gather(scores, 1, best_idx[:, None])[:, 0]
    best_perm = perms[best_idx].to(torch.int32)
    return best_metric, best_perm


def _find_best_perm_lsa(metric_mtx: Tensor, eval_max: bool) -> Tuple[Tensor, Tensor]:
    """Hungarian assignment on the host for large speaker counts: the
    in-repo C++ solver. One read of the matrix, one copy of the result."""
    from metrics_tpu_torch.native import lsap

    mtx = metric_mtx.detach().cpu().numpy()
    best_perm = lsap(mtx, maximize=eval_max).astype(np.int64)
    best_metric = np.take_along_axis(mtx, best_perm[:, :, None], axis=2).mean(axis=(-1, -2))
    # one copy: the float32 metrics and the int32 columns share a buffer
    packed = np.concatenate([best_metric.astype(np.float32)[:, None], best_perm.astype(np.int32).view(np.float32)], axis=1)
    out = _host_to_device(packed, metric_mtx.device)
    return out[:, 0], out[:, 1:].view(torch.int32)


def permutation_invariant_training(
    preds: Tensor, target: Tensor, metric_func: Callable, eval_func: str = "max", **kwargs: Any
) -> Tuple[Tensor, Tensor]:
    """Evaluate ``metric_func`` under the best speaker permutation.

    Args:
        preds: estimates, shape ``[batch, spk, ...]``.
        target: references, shape ``[batch, spk, ...]``.
        metric_func: batched pairwise metric,
            ``metric_func(preds[:, j], target[:, i], **kwargs) -> [batch]``.
        eval_func: ``"max"`` (higher better) or ``"min"``.

    Returns:
        ``(best_metric [batch], best_perm [batch, spk])``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional.audio.sdr import scale_invariant_signal_distortion_ratio
        >>> preds = torch.tensor([[[-0.0579,  0.3560, -0.9604], [-0.1719,  0.3205,  0.2951]]])
        >>> target = torch.tensor([[[ 1.0958, -0.1648,  0.5228], [-0.4100,  1.1942, -0.5103]]])
        >>> best_metric, best_perm = permutation_invariant_training(
        ...     preds, target, scale_invariant_signal_distortion_ratio, 'max')
        >>> best_metric
        tensor([-5.1091])
        >>> best_perm
        tensor([[0, 1]], dtype=torch.int32)
    """
    if preds.shape[0:2] != target.shape[0:2]:
        raise RuntimeError(
            "Predictions and targets are expected to have the same shape at the batch and speaker dimensions"
        )
    if eval_func not in ("max", "min"):
        raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
    if target.ndim < 2:
        raise ValueError(f"Inputs must be of shape [batch, spk, ...], got {target.shape} and {preds.shape} instead")

    spk_num = target.shape[1]
    rows = []
    for target_idx in range(spk_num):
        row = [
            metric_func(preds[:, preds_idx, ...], target[:, target_idx, ...], **kwargs)
            for preds_idx in range(spk_num)
        ]
        rows.append(torch.stack(row, dim=-1))
    metric_mtx = torch.stack(rows, dim=-2)  # [batch, target_spk, pred_spk]

    if spk_num <= _MAX_EXHAUSTIVE_SPK:
        return _find_best_perm_exhaustive(metric_mtx, eval_func == "max")
    return _find_best_perm_lsa(metric_mtx, eval_func == "max")


def pit_permutate(preds: Tensor, perm: Tensor) -> Tensor:
    """Reorder ``preds`` along the speaker axis by ``perm`` (``[batch, spk]``;
    int32 is widened to int64 for the gather).

    Example:
        >>> import torch
        >>> preds = torch.tensor([[[1.0, 2.0], [3.0, 4.0]]])
        >>> pit_permutate(preds, torch.tensor([[1, 0]], dtype=torch.int32))
        tensor([[[3., 4.],
                 [1., 2.]]])
    """
    index = perm.to(torch.int64)[(...,) + (None,) * (preds.ndim - 2)]
    return torch.take_along_dim(preds, index, dim=1)
