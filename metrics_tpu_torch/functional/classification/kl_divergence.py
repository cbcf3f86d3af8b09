"""KL divergence.

Counterpart of ``metrics_tpu/functional/classification/kl_divergence.py``:
plain torch on the inputs' device.
"""
from typing import Optional, Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import METRIC_EPS, _as_tensor

Tensor = torch.Tensor


def _kld_update(p: Tensor, q: Tensor, log_prob: bool) -> Tuple[Tensor, int]:
    """Per-row divergences of one batch and its row count."""
    _check_same_shape(p, q)
    if p.ndim != 2 or q.ndim != 2:
        raise ValueError(f"Expected both p and q distribution to be 2D but got {p.ndim} and {q.ndim} respectively")
    # the JAX package's inputs are float32 with x64 off
    p, q = (x.to(torch.float32) if x.dtype == torch.float64 else x for x in (p, q))
    total = p.shape[0]
    if log_prob:
        measures = torch.sum(torch.exp(p) * (p - q), dim=-1)
    else:
        p = p / torch.sum(p, dim=-1, keepdim=True)
        q = q / torch.sum(q, dim=-1, keepdim=True)
        q = torch.clamp(q, min=METRIC_EPS)
        measures = torch.sum(p * torch.log(p / q), dim=-1)
    return measures, total


def _kld_compute(measures: Tensor, total: Union[int, Tensor], reduction: Optional[str] = "mean") -> Tensor:
    if reduction == "sum":
        return torch.sum(measures)
    if reduction == "mean":
        return torch.sum(measures) / total
    if reduction is None or reduction == "none":
        return measures
    return measures / total


def kl_divergence(
    p: Tensor,
    q: Tensor,
    log_prob: bool = False,
    reduction: Optional[str] = "mean",
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """Computes the KL divergence between distributions p and q. Host
    inputs go to ``device`` (the card unless ``"cpu"``).

    Example:
        >>> import torch
        >>> p = torch.tensor([[0.36, 0.48, 0.16]])
        >>> q = torch.tensor([[1/3, 1/3, 1/3]])
        >>> kl_divergence(p, q)
        tensor(0.0853)
    """
    p, q = _as_tensor(p, device), _as_tensor(q, device)
    measures, total = _kld_update(p, q, log_prob)
    return _kld_compute(measures, total, reduction)
