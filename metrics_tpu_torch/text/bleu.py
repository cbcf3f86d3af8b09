"""Modular BLEUScore.

Counterpart of ``metrics_tpu/text/bleu.py``. Tokenizing and counting stay
on the host; the accumulated n-gram numerator/denominator and length states
are float32 on the metric's device (``dist_reduce_fx="sum"``), and an update
adds what it counted in one host-to-device copy. ``compute`` reads the
counts in one copy and scores them on the host (``functional/text/bleu.py``).
"""
from typing import Any, Callable, Sequence

import numpy as np
import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text.bleu import _bleu_score_compute, _bleu_score_update, _tokenize_fn
from metrics_tpu_torch.functional.text.helper import _float32_sums

Tensor = torch.Tensor


class BLEUScore(Metric):
    """Calculate BLEU score of machine-translated text with one or more references.

    Args:
        n_gram: Gram value ranged from 1 to 4 (default 4).
        smooth: Whether to apply add-one smoothing (Lin & Och 2004).

    Example:
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> metric = BLEUScore(device="cpu")
        >>> metric(preds, target)
        tensor(0.7598)
    """

    is_differentiable = False
    higher_is_better = True
    __jit_unsafe__ = True  # update consumes Python strings

    def __init__(self, n_gram: int = 4, smooth: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.n_gram = n_gram
        self.smooth = smooth
        self.tokenizer: Callable[[str], Sequence[str]] = _tokenize_fn

        self.add_state("preds_len", default=0.0, dist_reduce_fx="sum")
        self.add_state("target_len", default=0.0, dist_reduce_fx="sum")
        self.add_state("numerator", default=np.zeros(n_gram, np.float32), dist_reduce_fx="sum")
        self.add_state("denominator", default=np.zeros(n_gram, np.float32), dist_reduce_fx="sum")

    def _update(self, preds: Sequence[str], target: Sequence[Sequence[str]]) -> None:
        preds_ = [preds] if isinstance(preds, str) else preds
        target_ = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]
        if len(preds_) != len(target_):
            raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")

        numerator = np.zeros(self.n_gram)
        denominator = np.zeros(self.n_gram)
        preds_len, target_len = _bleu_score_update(
            preds_, target_, numerator, denominator, 0.0, 0.0, self.n_gram, self.tokenizer
        )
        batch = _float32_sums(np.concatenate([[preds_len, target_len], numerator, denominator]), self.device)
        n = self.n_gram
        self.preds_len = self.preds_len + batch[0]
        self.target_len = self.target_len + batch[1]
        self.numerator = self.numerator + batch[2 : 2 + n]
        self.denominator = self.denominator + batch[2 + n :]

    def _compute(self) -> Tensor:
        return _bleu_score_compute(
            self.preds_len, self.target_len, self.numerator, self.denominator, self.n_gram, self.smooth
        )
