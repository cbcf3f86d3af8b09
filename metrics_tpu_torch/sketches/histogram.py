"""Fixed-edge weighted histogram: the sketch that is exact.

Counterpart of ``metrics_tpu/sketches/histogram.py``. When a statistic only
reads binned sums (the top-label calibration error bins confidences into
``n_bins`` before comparing accuracy with confidence), the per-bin
weighted sums are sufficient statistics: the streaming state is exact for
every stream length at ``O(n_bins)`` memory, and its leaves are plain
``"sum"``-reduced tensors.

``hist_insert`` adds a batch with one ``segment_sum_f32`` launch on the card
(K1; the plain version on the CPU). The histogram's own rows go first,
ahead of the batch's, so each bin adds in the order of the JAX package's
scatter into the histogram: the old sum, then the batch's samples in
order. K1 adds each bin in row order, so the card, the CPU and the JAX
package agree bit for bit. The bin index convention is the calibration
kernel's ``searchsorted(side="left") - 1``, clipped into range.
"""
from typing import Any, Optional, Union

import torch

from metrics_tpu_torch.ops import segment_sum_dispatch
from metrics_tpu_torch.utils.data import _resolve_device

Tensor = torch.Tensor


def hist_init(n_bins: int, n_stats: int = 1, device: Optional[Union[str, torch.device]] = None) -> Tensor:
    """A zero ``[n_stats, n_bins]`` float32 histogram on ``device`` (the
    card unless ``"cpu"``): its rows are independent per-bin weighted sums,
    such as count, confidence sum and accuracy sum."""
    if not (isinstance(n_bins, int) and n_bins > 0):
        raise ValueError(f"`n_bins` must be a positive int, got {n_bins}")
    if not (isinstance(n_stats, int) and n_stats > 0):
        raise ValueError(f"`n_stats` must be a positive int, got {n_stats}")
    return torch.zeros((n_stats, n_bins), dtype=torch.float32, device=_resolve_device(device))


def hist_bin_index(edges: Tensor, x: Tensor) -> Tensor:
    """Each sample's bin under the calibration convention: the last edge
    strictly below it (``searchsorted(side="left") - 1``), clipped to
    ``[0, n_bins - 1]``. NaN goes past every edge, so to the last bin."""
    n_bins = edges.shape[0] - 1
    return torch.clamp(torch.searchsorted(edges, x.contiguous()) - 1, 0, n_bins - 1)


def hist_insert(
    hist: Tensor,
    bin_idx: Tensor,
    stats: Any,
    weights: Optional[Any] = None,
    n_valid: Optional[Any] = None,
) -> Tensor:
    """Add ``[n_stats, B]`` per-sample statistics (``[B]`` for one), times
    their ``weights``, into their bins; pure (``hist`` is not modified).
    ``n_valid`` masks trailing pad rows.

    Example:
        >>> import torch
        >>> edges = torch.tensor([0.0, 0.5, 1.0])
        >>> x = torch.tensor([0.1, 0.7, 0.9])
        >>> hist_insert(hist_init(2, 2, device="cpu"), hist_bin_index(edges, x), torch.stack([torch.ones(3), x]))
        tensor([[1.0000, 2.0000],
                [0.1000, 1.6000]])
    """
    stats = torch.as_tensor(stats, dtype=torch.float32, device=hist.device)
    if stats.ndim == 1:
        stats = stats[None, :]
    b = stats.shape[1]
    w = torch.ones(b, dtype=torch.float32, device=hist.device)
    if weights is not None:
        w = torch.as_tensor(weights, dtype=torch.float32, device=hist.device)
    if n_valid is not None:
        w = w * (torch.arange(b, device=hist.device) < torch.as_tensor(n_valid, device=hist.device))
    n_bins = hist.shape[1]
    # a half-precision histogram (``set_dtype``) adds in float32 and rounds
    # back once, as the sketch's compaction does
    rows = torch.cat([hist.T.to(torch.float32), (w[None, :] * stats).T])
    ids = torch.cat([torch.arange(n_bins, device=hist.device), bin_idx.reshape(-1).to(torch.int64)])
    return segment_sum_dispatch(rows, ids, n_bins).T.to(hist.dtype)


def hist_merge(a: Tensor, b: Tensor) -> Tensor:
    """Histograms merge by addition (the ``"sum"`` reducer is the merge)."""
    return a + b
