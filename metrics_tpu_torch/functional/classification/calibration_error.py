"""Top-label calibration error (ECE, MCE, RMSCE).

Counterpart of ``metrics_tpu/functional/classification/calibration_error.py``.
The three per-bin sums (count, confidence, accuracy) are one
``segment_sum_f32`` launch on the card (K1) over ``[N, 3]`` rows: K1 adds
each bin in row order, the order of the JAX package's scatters on the CPU,
so the bins agree with it bit for bit, and the card with the CPU. The bin
edges are ``linspace_f32`` (``jnp.linspace``'s float32 values, which
``torch.linspace`` does not give).
"""
from typing import Any, Optional, Tuple, Union

import torch

from metrics_tpu_torch.ops import segment_sum_dispatch
from metrics_tpu_torch.utils.checks import _input_format_classification, _score_mode_static, checks_read_nothing
from metrics_tpu_torch.utils.data import _as_tensor, amax_ieee, linspace_f32
from metrics_tpu_torch.utils.enums import DataType

Tensor = torch.Tensor


def _binning_bucketize(confidences: Tensor, accuracies: Tensor, bin_boundaries: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-bin mean accuracy, mean confidence and share of the samples."""
    n_bins = bin_boundaries.shape[0] - 1
    indices = torch.clamp(torch.searchsorted(bin_boundaries, confidences.contiguous()) - 1, 0, n_bins - 1)
    rows = torch.stack([torch.ones_like(confidences), confidences, accuracies], dim=1)
    count_bin, conf_bin, acc_bin = segment_sum_dispatch(rows, indices, n_bins).unbind(1)
    return _bin_means(count_bin, conf_bin, acc_bin, torch.sum(count_bin))


def _bin_means(count: Tensor, conf_sum: Tensor, acc_sum: Tensor, total: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """``(acc_bin, conf_bin, prop_bin)`` from the per-bin sums: empty bins
    take 0 for both means."""
    empty = count == 0
    safe = torch.where(empty, 1.0, count)
    conf_bin = torch.where(empty, 0.0, conf_sum / safe)
    acc_bin = torch.where(empty, 0.0, acc_sum / safe)
    return acc_bin, conf_bin, count / total


def _ce_from_bins(acc_bin: Tensor, conf_bin: Tensor, prop_bin: Tensor, norm: str) -> Tensor:
    if norm == "l1":
        return torch.sum(torch.abs(acc_bin - conf_bin) * prop_bin)
    if norm == "max":
        return amax_ieee(torch.abs(acc_bin - conf_bin))
    return torch.sum(torch.square(acc_bin - conf_bin) * prop_bin)


def _l2_root(ce: Tensor) -> Tensor:
    positive = ce > 0
    return torch.where(positive, torch.sqrt(torch.where(positive, ce, 1.0)), 0.0)


def _ce_compute(
    confidences: Tensor,
    accuracies: Tensor,
    bin_boundaries: Tensor,
    norm: str = "l1",
    debias: bool = False,
) -> Tensor:
    if norm not in {"l1", "l2", "max"}:
        raise ValueError(f"Norm {norm} is not supported. Please select from l1, l2, or max. ")

    acc_bin, conf_bin, prop_bin = _binning_bucketize(confidences, accuracies, bin_boundaries)
    ce = _ce_from_bins(acc_bin, conf_bin, prop_bin, norm)
    if norm != "l2":
        return ce
    if debias:
        debias_bins = (acc_bin * (acc_bin - 1) * prop_bin) / (prop_bin * accuracies.shape[0] - 1)
        ce = ce + torch.sum(torch.where(torch.isnan(debias_bins) | torch.isinf(debias_bins), 0.0, debias_bins))
    return _l2_root(ce)


def _ce_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Top-label confidences and 0/1 accuracies, float32 (the value checks
    read the card once)."""
    if checks_read_nothing():
        # the capture rule: the mode from the shapes alone, as the JAX
        # package deduces it from a tracer's shapes (the value checks are
        # host work, and integer predictions cannot be formatted there)
        mode = _score_mode_static(preds, target)
    else:
        _, _, mode = _input_format_classification(preds, target)

    if mode == DataType.BINARY:
        confidences, accuracies = preds, target
    elif mode in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS):
        if mode == DataType.MULTIDIM_MULTICLASS:
            preds = preds.transpose(1, -1).reshape(-1, preds.shape[1])
            target = target.flatten()
        # the first NaN, or the first maximum, as jnp.argmax picks it
        confidences = amax_ieee(preds, 1)
        accuracies = torch.argmax(preds, dim=1) == target
    else:
        raise ValueError(
            f"Calibration error is not well-defined for data with size {tuple(preds.shape)} and targets {tuple(target.shape)}."
        )
    return confidences.to(torch.float32), accuracies.to(torch.float32)


def calibration_error(
    preds: Any,
    target: Any,
    n_bins: int = 15,
    norm: str = "l1",
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """Top-label calibration error (``norm``: ``'l1'`` ECE, ``'l2'`` RMSCE,
    ``'max'`` MCE). Host inputs go to ``device`` (the card unless
    ``"cpu"``); tensors stay where they are.

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.9, 0.8, 0.3, 0.2])
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> calibration_error(preds, target, n_bins=2)
        tensor(0.2000)
        >>> preds = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.3, 0.3, 0.4]])
        >>> calibration_error(preds, torch.tensor([0, 2, 2]), n_bins=4, norm="max")
        tensor(0.8000)
    """
    if norm not in ("l1", "l2", "max"):
        raise ValueError(f"Norm {norm} is not supported. Please select from l1, l2, or max. ")
    if not isinstance(n_bins, int) or n_bins <= 0:
        raise ValueError(f"Expected argument `n_bins` to be a int larger than 0 but got {n_bins}")

    preds, target = _as_tensor(preds, device), _as_tensor(target, device)
    confidences, accuracies = _ce_update(preds, target)
    bin_boundaries = linspace_f32(n_bins + 1, device=preds.device)
    return _ce_compute(confidences, accuracies, bin_boundaries, norm=norm)
