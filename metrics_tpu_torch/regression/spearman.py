"""Modular SpearmanCorrCoef: the rank-sketch default and ``exact=True``.

Counterpart of ``metrics_tpu/regression/spearman.py``. The default state
is a fixed-capacity rank sketch (:mod:`metrics_tpu_torch.sketches.rank`):
a Gumbel reservoir of (pred, target) pairs, merged by its own reducer, and
an int32 count of the pairs seen. The update reads nothing back and has a
fixed shape (it fuses, and masks bucket pads through ``n_valid``). The
compute reads the fill and the count once: inside the lossless window (the
stream fits the capacity) it runs the exact tie-averaged kernel on the
reservoir's rows, which are the stream in arrival order; past it, the
weighted-midrank estimator :func:`~metrics_tpu_torch.sketches.rank.ranksketch_spearman`.
``exact=True`` keeps every pair in list states, with the reference's
large-memory warning.
"""
from typing import Any, Optional

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.spearman import _spearman_corrcoef_compute, _spearman_corrcoef_update
from metrics_tpu_torch.parallel.distributed import process_index
from metrics_tpu_torch.sketches.compat import register_exact_list_states, warn_exact_buffer
from metrics_tpu_torch.sketches.rank import ranksketch_init, ranksketch_insert, ranksketch_merge_fx, ranksketch_spearman
from metrics_tpu_torch.sketches.reservoir import reservoir_fill
from metrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor

#: default rank-sketch capacity: 8192 (pred, target) pairs are 96 KiB, for a
#: standard error of about (1 - rho**2) / 90; smaller streams stay exact
DEFAULT_RANK_CAPACITY = 8192


class SpearmanCorrCoef(Metric):
    """Computes the Spearman rank correlation coefficient.

    Example:
        >>> import torch
        >>> target = torch.tensor([3., -0.5, 2., 7.])
        >>> preds = torch.tensor([2.5, 0.0, 2., 8.])
        >>> spearman = SpearmanCorrCoef(device="cpu")
        >>> spearman(preds, target)
        tensor(1.0000)
    """

    is_differentiable = False
    higher_is_better = True
    __jit_unsafe__ = False  # the sketch default has a fixed-shape update
    __exact_mode_attr__ = "_exact"
    __fused_mask_valid__ = True  # bucket pads are masked out through n_valid

    def __init__(self, exact: bool = False, sketch_capacity: int = DEFAULT_RANK_CAPACITY, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._exact = bool(exact)
        if self._exact:
            register_exact_list_states(self, ("preds", "target"))
            warn_exact_buffer("SpearmanCorrcoef", "targets and predictions")
        else:
            if not (isinstance(sketch_capacity, int) and sketch_capacity > 0):
                raise ValueError(f"Argument `sketch_capacity` must be a positive int, got {sketch_capacity}")
            self.add_state(
                "rsketch", default=ranksketch_init(sketch_capacity, device=self.device), dist_reduce_fx=ranksketch_merge_fx()
            )
            self.add_state("n_seen", default=torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
        # each process draws its own priority stream: equal seeds would
        # draw equal priorities and bias the merged sample
        self._key_seed = process_index()

    def _update(self, preds: Tensor, target: Tensor, n_valid: Optional[Any] = None) -> None:
        preds, target = _spearman_corrcoef_update(preds, target)
        if self._exact:
            self.preds = self.preds + [preds]
            self.target = self.target + [target]
            return
        self.rsketch = ranksketch_insert(self.rsketch, preds, target, self.n_seen, seed=self._key_seed, n_valid=n_valid)
        self.n_seen = self.n_seen + preds.numel()

    def _compute(self) -> Tensor:
        if self._exact:
            return _spearman_corrcoef_compute(dim_zero_cat(self.preds), dim_zero_cat(self.target))
        leaf = self.rsketch
        fill, seen = torch.stack([reservoir_fill(leaf), self.n_seen.to(torch.int32)]).tolist()
        if fill == seen:
            # the lossless window: the rows are the stream in arrival order
            rows = leaf[:fill]
            return _spearman_corrcoef_compute(rows[:, 1], rows[:, 2])
        return ranksketch_spearman(leaf)
