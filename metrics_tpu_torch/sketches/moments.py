"""Exact streaming moments: sum, outer-product sum and count leaves.

Counterpart of ``metrics_tpu/sketches/moments.py``. A mean and covariance
(FID's Gaussian fit) depend on the features only through

    ``feat_sum  = sum of x_i``           ``[d]``
    ``outer_sum = sum of x_i x_i^T``     ``[d, d]``
    ``count     = N``                    scalar

so a fixed-size state of those three leaves is exact for any stream
length. The leaves add element-wise: the merge of two states is their sum.
:func:`moments_merge_fx` is that reducer, tagged ``merge_like`` so that
``Metric.merge_states`` folds it like the sketch reducers (detection's
``images_seen`` counter uses it too).

Accumulation is float32 on the metric's device; ``sum x x^T`` loses
precision to cancellation when the mean is large against the spread.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.data import _resolve_device, dim_zero_sum

Tensor = torch.Tensor


def moments_init(dim: int, device=None) -> Tuple[Tensor, Tensor, Tensor]:
    """Fresh ``(feat_sum [dim], outer_sum [dim, dim], count)`` float32 leaves
    on ``device`` (the card unless ``device="cpu"``)."""
    if not (isinstance(dim, int) and dim > 0):
        raise ValueError(f"feature dim must be a positive int, got {dim}")
    device = _resolve_device(device)
    return (
        torch.zeros((dim,), dtype=torch.float32, device=device),
        torch.zeros((dim, dim), dtype=torch.float32, device=device),
        torch.zeros((), dtype=torch.float32, device=device),
    )


def moments_update(feat_sum: Tensor, outer_sum: Tensor, count: Tensor, feats: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Fold a ``[B, d]`` feature batch into the three moment leaves."""
    feats = torch.as_tensor(feats, device=feat_sum.device).to(torch.float32)
    return (
        feat_sum + feats.sum(dim=0),
        outer_sum + feats.T @ feats,
        count + feats.shape[0],
    )


def mean_cov_from_moments(feat_sum: Tensor, outer_sum: Tensor, count: Tensor) -> Tuple[Tensor, Tensor]:
    """``(mean [d], unbiased covariance [d, d])`` by the identity
    ``cov = (sum x x^T - N mu mu^T) / (N - 1)``."""
    n = torch.clamp(count, min=1.0)
    mean = feat_sum / n
    cov = (outer_sum - n * torch.outer(mean, mean)) / torch.clamp(n - 1.0, min=1.0)
    return mean, cov


class _MomentsReduce:
    """``dist_reduce_fx`` summing stacked per-rank moment leaves
    ``[world, ...] -> [...]`` in their dtype (an int32 counter stays int32,
    as ``jnp.sum`` keeps it). A module-level class, so metrics holding it
    pickle; tagged ``merge_like`` for ``Metric.merge_states``."""

    merge_like = True
    sketch_kind = "moments"
    __name__ = "moments_reduce"

    def __call__(self, stacked: Tensor) -> Tensor:
        return dim_zero_sum(torch.as_tensor(stacked))


_MOMENTS_REDUCE = _MomentsReduce()


def moments_merge_fx() -> _MomentsReduce:
    """The shared streaming-moment ``dist_reduce_fx``."""
    return _MOMENTS_REDUCE
