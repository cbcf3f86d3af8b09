"""Modular ROUGEScore.

Counterpart of ``metrics_tpu/text/rouge.py``: the per-sentence scores are
list states (one per ``rouge_key`` x fmeasure/precision/recall,
``dist_reduce_fx=None``) that grow one chunk per update; an update sends
all of them to the device in one copy. ``compute`` reads them in one copy
and takes each mean with ``np.mean`` over the float32 scores, as the JAX
package does.
"""
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text.helper import _float32_sums
from metrics_tpu_torch.functional.text.rouge import (
    ALLOWED_ACCUMULATE_VALUES,
    ALLOWED_ROUGE_KEYS,
    _rouge_score_compute,
    _rouge_score_update,
)
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.imports import _NLTK_AVAILABLE

Tensor = torch.Tensor

_SCORES = ("fmeasure", "precision", "recall")


class ROUGEScore(Metric):
    """Calculate ROUGE score for automatic summarization.

    Args:
        use_stemmer: Use the Porter stemmer to strip word suffixes.
        normalizer: Custom normalization function ``str -> str``.
        tokenizer: Custom tokenization function ``str -> Sequence[str]``.
        accumulate: Multi-reference accumulation: ``"best"`` takes the
            reference with the highest first-key fmeasure, ``"avg"`` averages
            over all references.
        rouge_keys: Which rouge scores to compute (``rouge1..rouge9``,
            ``rougeL``, ``rougeLsum``).

    Example:
        >>> preds = "My name is John"
        >>> target = "Is your name John"
        >>> rouge = ROUGEScore(rouge_keys=("rouge1", "rouge2", "rougeL"), device="cpu")
        >>> from pprint import pprint
        >>> pprint(rouge(preds, target))
        {'rouge1_fmeasure': tensor(0.7500),
         'rouge1_precision': tensor(0.7500),
         'rouge1_recall': tensor(0.7500),
         'rouge2_fmeasure': tensor(0.),
         'rouge2_precision': tensor(0.),
         'rouge2_recall': tensor(0.),
         'rougeL_fmeasure': tensor(0.5000),
         'rougeL_precision': tensor(0.5000),
         'rougeL_recall': tensor(0.5000)}
    """

    higher_is_better = True
    is_differentiable = False
    __jit_unsafe__ = True  # update consumes Python strings

    def __init__(
        self,
        use_stemmer: bool = False,
        normalizer: Optional[Callable[[str], str]] = None,
        tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
        accumulate: str = "best",
        rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if use_stemmer or "rougeLsum" in rouge_keys:
            if not _NLTK_AVAILABLE:
                raise ModuleNotFoundError(
                    "Stemmer and/or `rougeLsum` requires that `nltk` is installed. Use `pip install nltk`."
                )
            import nltk

        if not isinstance(rouge_keys, tuple):
            rouge_keys = (rouge_keys,)
        for key in rouge_keys:
            if key not in ALLOWED_ROUGE_KEYS:
                raise ValueError(
                    f"Got unknown rouge key {key}. Expected to be one of {list(ALLOWED_ROUGE_KEYS.keys())}"
                )
        if accumulate not in ALLOWED_ACCUMULATE_VALUES:
            raise ValueError(
                f"Got unknown accumulate value {accumulate}. Expected to be one of {ALLOWED_ACCUMULATE_VALUES}"
            )

        self.rouge_keys = rouge_keys
        self.rouge_keys_values = [ALLOWED_ROUGE_KEYS[key] for key in rouge_keys]
        self.stemmer = nltk.stem.porter.PorterStemmer() if use_stemmer else None
        self.normalizer = normalizer
        self.tokenizer = tokenizer
        self.accumulate = accumulate

        for rouge_key in self.rouge_keys:
            for score in _SCORES:
                self.add_state(f"{rouge_key}_{score}", [], dist_reduce_fx=None)

    def _state_names(self) -> List[str]:
        return [f"rouge{rouge_key}_{tp}" for rouge_key in self.rouge_keys_values for tp in _SCORES]

    def _update(
        self, preds: Union[str, Sequence[str]], target: Union[str, Sequence[str], Sequence[Sequence[str]]]
    ) -> None:
        if isinstance(target, list) and all(isinstance(tgt, str) for tgt in target):
            target = [target] if isinstance(preds, str) else [[tgt] for tgt in target]
        if isinstance(preds, str):
            preds = [preds]
        if isinstance(target, str):
            target = [[target]]

        output: Dict[Union[int, str], List[Dict[str, float]]] = _rouge_score_update(
            preds,
            target,
            self.rouge_keys_values,
            stemmer=self.stemmer,
            normalizer=self.normalizer,
            tokenizer=self.tokenizer,
            accumulate=self.accumulate,
        )
        rows = [[metric[tp] for metric in output[rouge_key]] for rouge_key in self.rouge_keys_values for tp in _SCORES]
        if not rows[0]:
            return
        batch = _float32_sums(rows, self.device)
        for name, row in zip(self._state_names(), batch):
            getattr(self, name).append(row)

    def _compute(self) -> Dict[str, Tensor]:
        names = self._state_names()
        if not getattr(self, names[0]):
            return _rouge_score_compute({name: np.zeros(0, np.float32) for name in names}, self.device)
        host = torch.stack([dim_zero_cat(getattr(self, name)) for name in names]).cpu().numpy()
        return _rouge_score_compute(dict(zip(names, host)), self.device)
