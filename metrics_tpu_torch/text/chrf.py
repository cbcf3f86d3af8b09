"""Modular CHRFScore.

Counterpart of ``metrics_tpu/text/chrf.py``: one float32 scalar state per
(accumulator, n-gram order), so corpus statistics sum across processes.
An update counts on the host and adds its batch totals (and appends its
sentence scores, one chunk per update) in one host-to-device copy; it reads
nothing back. The JAX package reads the totals at every update, adds the
batch in Python floats and rounds once; the totals are integer counts, so
adding the batch's float32 totals on the device gives the same float32
while a batch's total of one order stays below 2**24. ``compute`` reads
every total in one stacked copy.
"""
from typing import Any, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text.chrf import (
    _chrf_score_compute,
    _chrf_score_update,
    _validate_chrf_args,
    _zero_totals,
)
from metrics_tpu_torch.functional.text.helper import _float32_sums
from metrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor

_TOTAL_NAMES = ("pred_char", "pred_word", "tgt_char", "tgt_word", "match_char", "match_word")


class CHRFScore(Metric):
    """Corpus chrF/chrF++ with per-order accumulator states.

    Example:
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> metric = CHRFScore(device="cpu")
        >>> metric(preds, target)
        tensor(0.8640)
    """

    is_differentiable = False
    higher_is_better = True
    __jit_unsafe__ = True  # update consumes Python strings

    def __init__(
        self,
        n_char_order: int = 6,
        n_word_order: int = 2,
        beta: float = 2.0,
        lowercase: bool = False,
        whitespace: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _validate_chrf_args(n_char_order, n_word_order, beta)
        self.n_char_order = n_char_order
        self.n_word_order = n_word_order
        self.beta = beta
        self.lowercase = lowercase
        self.whitespace = whitespace
        self.return_sentence_level_score = return_sentence_level_score
        self.n_order = float(n_char_order + n_word_order)

        # one scalar state per (accumulator, n-gram order): sums across ranks
        for name in self._state_names():
            self.add_state(name, np.float32(0.0), dist_reduce_fx="sum")
        if return_sentence_level_score:
            self.add_state("sentence_chrf_score", [], dist_reduce_fx="cat")

    def _layout(self) -> List[Tuple[str, Dict[int, float]]]:
        return list(zip(_TOTAL_NAMES, _zero_totals(self.n_char_order, self.n_word_order)))

    def _state_names(self) -> List[str]:
        return [f"total_{name}_{n}grams" for name, orders in self._layout() for n in orders]

    def _totals(self) -> tuple:
        """Every per-order total as host floats, from one stacked read."""
        stacked = torch.stack([getattr(self, name) for name in self._state_names()]).cpu().numpy()
        out = []
        i = 0
        for _, orders in self._layout():
            out.append({n: float(stacked[i + j]) for j, n in enumerate(orders)})
            i += len(orders)
        return tuple(out)

    def _update(self, preds: Sequence[str], target: Sequence[Sequence[str]]) -> None:
        totals, sentence_scores = _chrf_score_update(
            preds,
            target,
            _zero_totals(self.n_char_order, self.n_word_order),
            self.n_char_order,
            self.n_word_order,
            self.n_order,
            self.beta,
            self.lowercase,
            self.whitespace,
        )
        values = [v for orders in totals for v in orders.values()]
        names = self._state_names()
        batch = _float32_sums(values + (sentence_scores if self.return_sentence_level_score else []), self.device)
        for i, name in enumerate(names):
            setattr(self, name, getattr(self, name) + batch[i])
        if self.return_sentence_level_score:
            self.sentence_chrf_score.append(batch[len(names) :])

    def _compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        score = _chrf_score_compute(self._totals(), self.n_order, self.beta, self.device)
        if self.return_sentence_level_score:
            return score, dim_zero_cat(self.sentence_chrf_score)
        return score
