"""Modular TranslationEditRate.

Counterpart of ``metrics_tpu/text/ter.py``: two float32 sum states on the
metric's device and, with ``return_sentence_level_score``, the sentence
scores as a list state that grows one chunk per update; an update adds
both in one host-to-device copy.
"""
from typing import Any, List, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text.helper import _float32_sums
from metrics_tpu_torch.functional.text.ter import _TercomTokenizer, _ter_compute, _ter_update
from metrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class TranslationEditRate(Metric):
    """Corpus Translation Edit Rate with Tercom shift search.

    Example:
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> metric = TranslationEditRate(device="cpu")
        >>> metric(preds, target)
        tensor(0.1538)
    """

    is_differentiable = False
    higher_is_better = False
    __jit_unsafe__ = True  # update consumes Python strings

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        for name, value in [
            ("normalize", normalize),
            ("no_punctuation", no_punctuation),
            ("lowercase", lowercase),
            ("asian_support", asian_support),
        ]:
            if not isinstance(value, bool):
                raise ValueError(f"Expected argument `{name}` to be of type boolean but got {value}.")

        self.tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
        self.return_sentence_level_score = return_sentence_level_score

        self.add_state("total_num_edits", 0.0, dist_reduce_fx="sum")
        self.add_state("total_tgt_len", 0.0, dist_reduce_fx="sum")
        if return_sentence_level_score:
            self.add_state("sentence_ter", [], dist_reduce_fx="cat")

    def _update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        num_edits, tgt_length, sentence_ter = _ter_update(preds, target, self.tokenizer)
        batch = _float32_sums([num_edits, tgt_length] + (sentence_ter if self.return_sentence_level_score else []), self.device)
        self.total_num_edits = self.total_num_edits + batch[0]
        self.total_tgt_len = self.total_tgt_len + batch[1]
        if self.return_sentence_level_score:
            self.sentence_ter.append(batch[2:])

    def _compute(self) -> Union[Tensor, Tuple[Tensor, List[Tensor]]]:
        score = _ter_compute(self.total_num_edits, self.total_tgt_len)
        if self.return_sentence_level_score:
            # one [1] tensor per sentence, as the JAX package's list state holds them
            return score, list(dim_zero_cat(self.sentence_ter).split(1)) if self.sentence_ter else []
        return score
