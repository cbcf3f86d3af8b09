"""Modular CalibrationError: per-bin sums by default, ``exact=True`` opt-in.

Counterpart of ``metrics_tpu/classification/calibration_error.py``. The
exact compute bins the confidences into ``n_bins`` anyway, so the per-bin
sums of count, confidence and accuracy are sufficient statistics: the
default state is three ``[n_bins]`` float32 sums, exact for every stream
length. Each update adds the batch with one ``segment_sum_f32`` launch on
the card (``sketches/histogram.hist_insert``), bit for bit as the JAX
package's scatters. ``exact=True`` keeps the reference's unbounded list
states instead.
"""
from typing import Any

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.calibration_error import (
    _bin_means,
    _ce_compute,
    _ce_from_bins,
    _ce_update,
    _l2_root,
)
from metrics_tpu_torch.sketches.compat import register_exact_list_states, warn_exact_buffer
from metrics_tpu_torch.sketches.histogram import hist_bin_index, hist_insert
from metrics_tpu_torch.utils.data import dim_zero_cat, linspace_f32

Tensor = torch.Tensor


class CalibrationError(Metric):
    """Top-label calibration error (``'l1'`` ECE, ``'l2'`` RMSCE, ``'max'`` MCE).

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.9, 0.8, 0.3, 0.2])
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> metric = CalibrationError(n_bins=2, device="cpu")
        >>> metric(preds, target)
        tensor(0.2000)
        >>> metric.bin_count
        tensor([2., 2.])
    """

    DISTANCES = {"l1", "l2", "max"}
    is_differentiable = False
    __jit_unsafe__ = False  # binned default: fixed-shape update, fusible
    #: the static analysis classifies the default mode: branches on
    #: ``self._exact`` belong to the opt-in exact (list-state) mode
    __exact_mode_attr__ = "_exact"

    def __init__(self, n_bins: int = 15, norm: str = "l1", exact: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if norm not in self.DISTANCES:
            raise ValueError(f"Norm {norm} is not supported. Please select from l1, l2, or max. ")
        if not isinstance(n_bins, int) or n_bins <= 0:
            raise ValueError(f"Expected argument `n_bins` to be a int larger than 0 but got {n_bins}")

        self.n_bins = n_bins
        self.bin_boundaries = linspace_f32(n_bins + 1, device=self.device)
        self.norm = norm
        self._exact = bool(exact)

        if self._exact:
            register_exact_list_states(self, ("confidences", "accuracies"))
            warn_exact_buffer("CalibrationError", "confidences and accuracies")
        else:
            for name in ("bin_count", "bin_conf", "bin_acc"):
                self.add_state(name, default=torch.zeros(n_bins, dtype=torch.float32), dist_reduce_fx="sum")

    def _update(self, preds: Tensor, target: Tensor) -> None:
        confidences, accuracies = _ce_update(preds, target)
        if self._exact:
            self.confidences.append(confidences)
            self.accuracies.append(accuracies)
            return
        hist = torch.stack([self.bin_count, self.bin_conf, self.bin_acc])
        stats = torch.stack([torch.ones_like(confidences), confidences, accuracies])
        hist = hist_insert(hist, hist_bin_index(self.bin_boundaries, confidences), stats)
        self.bin_count, self.bin_conf, self.bin_acc = hist.contiguous().unbind(0)

    def _compute(self) -> Tensor:
        if self._exact:
            confidences, accuracies = dim_zero_cat(self.confidences), dim_zero_cat(self.accuracies)
            return _ce_compute(confidences, accuracies, self.bin_boundaries, norm=self.norm)
        count = self.bin_count
        acc_bin, conf_bin, prop_bin = _bin_means(count, self.bin_conf, self.bin_acc, torch.clamp(torch.sum(count), min=1.0))
        ce = _ce_from_bins(acc_bin, conf_bin, prop_bin, self.norm)
        return _l2_root(ce) if self.norm == "l2" else ce
