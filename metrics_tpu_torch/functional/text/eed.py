"""Extended Edit Distance (EED).

Counterpart of ``metrics_tpu/functional/text/eed.py`` (following
rwth-i6/ExtendedEditDistance): a character-level CDER-grid DP with an extra
"long jump" operation at blanks, a coverage penalty for re-visited
positions, language-specific preprocessing (en/ja), and per-sentence
best-reference selection averaged over the corpus.

The DP uses plain Python floats in the JAX package's evaluation order: the
relaxation accumulates ``+ deletion`` sequentially, and 0.2 is not exactly
representable, so a re-associated vectorized form could flip argmin ties.
Host-side string processing; the scores reach the device in one copy.
"""
import re
import unicodedata
from math import inf
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.functional.text.helper import _host_to_device, _validate_inputs
from metrics_tpu_torch.utils.data import _resolve_device

Tensor = torch.Tensor


def _eed_function(
    hyp: str,
    ref: str,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> float:
    """Sentence-level EED via the CDER alignment grid with long jumps.

    ``alpha`` is the jump penalty, ``rho`` the coverage cost for re-visited
    hypothesis positions, ``deletion``/``insertion`` the character edit
    costs (substitution shares the 0/1 word-distance with identity).
    """
    width = len(hyp) + 1
    visit_count = [-1] * width

    row = [1.0] * width
    row[0] = 0.0  # CDER initialisation: (0, 0) = 0, rest 1
    for w in range(1, len(ref) + 1):
        ref_char = ref[w - 1]
        next_row = [inf] * width
        next_row[0] = row[0] + 1.0
        for i in range(1, width):
            next_row[i] = min(
                next_row[i - 1] + deletion,
                row[i - 1] + (0 if hyp[i - 1] == ref_char else 1),
                row[i] + insertion,
            )

        min_index = next_row.index(min(next_row))
        visit_count[min_index] += 1

        if ref_char == " ":  # long jump from the best position
            jump = alpha + next_row[min_index]
            next_row = [min(x, jump) for x in next_row]

        row = next_row

    coverage = rho * sum(x if x >= 0 else 1 for x in visit_count)
    return min(1, (row[-1] + coverage) / (float(len(ref)) + coverage))


_ABBREVIATION_RE = re.compile(r"(Dr|Jr|Prof|Rev|Gen|Mr|Mt|Mrs|Ms) .")
_NUMBER_RE = re.compile(r"(\d) ([.,]) (\d)")
_SPACES_RE = re.compile(r"\s+")


def _preprocess_en(sentence: str) -> str:
    """English preprocessing (rwth-i6 EED util.py recipe): space out
    punctuation, then re-join numbers and known abbreviations, pad ends."""
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    sentence = sentence.rstrip()
    for mark in (".", "!", "?", ","):
        sentence = sentence.replace(mark, f" {mark}")
    sentence = _SPACES_RE.sub(" ", sentence)
    sentence = _NUMBER_RE.sub(r"\1\2\3", sentence)
    sentence = _ABBREVIATION_RE.sub(r"\1.", sentence)
    for spaced, joined in (("e . g .", "e.g."), ("i . e .", "i.e."), ("U . S .", "U.S.")):
        sentence = sentence.replace(spaced, joined)
    return f" {sentence} "


def _preprocess_ja(sentence: str) -> str:
    """Japanese preprocessing: NFKC normalization only."""
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    return unicodedata.normalize("NFKC", sentence.rstrip())


def _eed_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> List[float]:
    """Sentence-level best-reference EED scores for a batch."""
    target, preds = _validate_inputs(target, preds)

    if language == "en":
        preprocess = _preprocess_en
    elif language == "ja":
        preprocess = _preprocess_ja
    else:
        raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")

    preds = [preprocess(pred) for pred in preds]
    target = [[preprocess(ref) for ref in refs] for refs in target]

    if 0 in (len(preds), len(target[0])):
        return []

    scores: List[float] = []
    for hypothesis, references in zip(preds, target):
        best = inf
        for reference in references:
            score = _eed_function(hypothesis, reference, alpha, rho, deletion, insertion)
            if score < best:
                best = score
        scores.append(best)
    return scores


def _eed_compute(sentence_level_scores: List[float]) -> np.float32:
    """The mean of the sentence scores in Python floats, rounded once."""
    if not sentence_level_scores:
        return np.float32(0.0)
    return np.float32(sum(sentence_level_scores) / len(sentence_level_scores))


def extended_edit_distance(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    return_sentence_level_score: bool = False,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
    device: Optional[Union[str, torch.device]] = None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Corpus-level Extended Edit Distance.

    Example:
        >>> preds = ["this is the prediction", "here is an other sample"]
        >>> target = ["this is the reference", "here is another one"]
        >>> extended_edit_distance(preds=preds, target=target, device="cpu")
        tensor(0.3078)
    """
    for param_name, param in zip(["alpha", "rho", "deletion", "insertion"], [alpha, rho, deletion, insertion]):
        if not isinstance(param, float) or param < 0:
            raise ValueError(f"Parameter `{param_name}` is expected to be a non-negative float.")

    sentence_level_scores = _eed_update(preds, target, language, alpha, rho, deletion, insertion)
    values = _host_to_device(np.asarray([_eed_compute(sentence_level_scores)] + sentence_level_scores, np.float32), _resolve_device(device))
    if return_sentence_level_score:
        return values[0], values[1:]
    return values[0]
