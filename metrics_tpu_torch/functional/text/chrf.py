"""chrF / chrF++ score (character + word n-gram F-beta).

Counterpart of ``metrics_tpu/functional/text/chrf.py`` (following
m-popovic/chrF and sacrebleu): character n-grams up to ``n_char_order``
(whitespace stripped unless ``whitespace=True``) and word n-grams up to
``n_word_order`` with leading/trailing punctuation split off; per sentence
the BEST-scoring reference contributes its statistics to the corpus
totals; F-beta averaged uniformly over all n-gram orders with the 1e-16
denominator smoothing. The statistics are Python floats on the host, and
a score rounds once to float32, as in the JAX package.
"""
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.functional.text.helper import _host_to_device, _validate_inputs
from metrics_tpu_torch.utils.data import _resolve_device

Tensor = torch.Tensor

_EPS_SMOOTHING = 1e-16
# fixed by the sacrebleu chrF spec
_PUNCTUATIONS = set("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")

# per-order totals for (pred_char, pred_word, target_char, target_word,
# matching_char, matching_word) — the six corpus accumulators
_Totals = Tuple[Dict[int, float], Dict[int, float], Dict[int, float], Dict[int, float], Dict[int, float], Dict[int, float]]


def _zero_totals(n_char_order: int, n_word_order: int) -> _Totals:
    char_orders = {n: 0.0 for n in range(1, n_char_order + 1)}
    word_orders = {n: 0.0 for n in range(1, n_word_order + 1)}
    return (
        dict(char_orders), dict(word_orders),
        dict(char_orders), dict(word_orders),
        dict(char_orders), dict(word_orders),
    )


def _split_word_punctuation(word: str) -> List[str]:
    """chrF++ word tokenization: peel ONE leading or trailing punctuation."""
    if len(word) == 1:
        return [word]
    if word[-1] in _PUNCTUATIONS:
        return [word[:-1], word[-1]]
    if word[0] in _PUNCTUATIONS:
        return [word[0], word[1:]]
    return [word]


def _sentence_units(sentence: str, lowercase: bool, whitespace: bool) -> Tuple[List[str], List[str]]:
    """(character list, word list) after chrF preprocessing."""
    if lowercase:
        sentence = sentence.lower()
    chars = list(sentence) if whitespace else list(sentence.strip().replace(" ", ""))
    words = [piece for word in sentence.strip().split() for piece in _split_word_punctuation(word)]
    return chars, words


def _ngram_counters(units: Sequence[str], max_order: int) -> Dict[int, Counter]:
    return {
        n: Counter(tuple(units[i : i + n]) for i in range(len(units) - n + 1))
        for n in range(1, max_order + 1)
    }


def _matches(pred_counts: Dict[int, Counter], target_counts: Dict[int, Counter]) -> Dict[int, float]:
    return {
        n: float(sum((pred_counts[n] & target_counts[n]).values())) for n in pred_counts
    }


def _totals_of(counts: Dict[int, Counter]) -> Dict[int, float]:
    return {n: float(sum(c.values())) for n, c in counts.items()}


def _fscore(
    matching_char: Dict[int, float],
    matching_word: Dict[int, float],
    pred_char: Dict[int, float],
    pred_word: Dict[int, float],
    target_char: Dict[int, float],
    target_word: Dict[int, float],
    n_order: float,
    beta: float,
) -> float:
    """Uniform average of per-order F-beta over char + word orders."""

    def _per_order(matching: Dict[int, float], target: Dict[int, float], pred: Dict[int, float]) -> float:
        total = 0.0
        for n in matching:
            precision = matching[n] / pred[n] if pred[n] > 0 else 0.0
            recall = matching[n] / target[n] if target[n] > 0 else 0.0
            denominator = max(beta**2 * precision + recall, _EPS_SMOOTHING)
            total += (1 + beta**2) * precision * recall / denominator
        return total

    return (
        _per_order(matching_char, target_char, pred_char)
        + _per_order(matching_word, target_word, pred_word)
    ) / n_order


def _chrf_score_update(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    totals: _Totals,
    n_char_order: int,
    n_word_order: int,
    n_order: float,
    beta: float,
    lowercase: bool,
    whitespace: bool,
) -> Tuple[_Totals, List[float]]:
    """Accumulate best-reference statistics per sentence into ``totals``."""
    target_corpus, preds = _validate_inputs(target, preds)
    (t_pred_char, t_pred_word, t_tgt_char, t_tgt_word, t_match_char, t_match_word) = totals

    sentence_scores: List[float] = []
    for pred, targets in zip(preds, target_corpus):
        chars, words = _sentence_units(pred, lowercase, whitespace)
        pred_char_counts = _ngram_counters(chars, n_char_order)
        pred_word_counts = _ngram_counters(words, n_word_order)
        pred_char = _totals_of(pred_char_counts)
        pred_word = _totals_of(pred_word_counts)
        for n in pred_char:
            t_pred_char[n] += pred_char[n]
        for n in pred_word:
            t_pred_word[n] += pred_word[n]

        best = 0.0
        best_stats = (
            {n: 0.0 for n in pred_char}, {n: 0.0 for n in pred_word},
            {n: 0.0 for n in pred_char}, {n: 0.0 for n in pred_word},
        )
        for tgt in targets:
            tgt_chars, tgt_words = _sentence_units(tgt, lowercase, whitespace)
            tgt_char_counts = _ngram_counters(tgt_chars, n_char_order)
            tgt_word_counts = _ngram_counters(tgt_words, n_word_order)
            tgt_char = _totals_of(tgt_char_counts)
            tgt_word = _totals_of(tgt_word_counts)
            match_char = _matches(pred_char_counts, tgt_char_counts)
            match_word = _matches(pred_word_counts, tgt_word_counts)
            score = _fscore(
                match_char, match_word, pred_char, pred_word, tgt_char, tgt_word, n_order, beta
            )
            if score > best:
                best = score
                best_stats = (match_char, match_word, tgt_char, tgt_word)

        sentence_scores.append(best)
        match_char, match_word, tgt_char, tgt_word = best_stats
        for n in tgt_char:
            t_tgt_char[n] += tgt_char[n]
            t_match_char[n] += match_char[n]
        for n in tgt_word:
            t_tgt_word[n] += tgt_word[n]
            t_match_word[n] += match_word[n]

    return (t_pred_char, t_pred_word, t_tgt_char, t_tgt_word, t_match_char, t_match_word), sentence_scores


def _chrf_score_compute(
    totals: _Totals, n_order: float, beta: float, device: Optional[Union[str, torch.device]] = None
) -> Tensor:
    """The corpus score from host totals, a float32 scalar on ``device``."""
    (t_pred_char, t_pred_word, t_tgt_char, t_tgt_word, t_match_char, t_match_word) = totals
    score = _fscore(t_match_char, t_match_word, t_pred_char, t_pred_word, t_tgt_char, t_tgt_word, n_order, beta)
    return torch.full((), float(np.float32(score)), dtype=torch.float32, device=_resolve_device(device))


def _validate_chrf_args(n_char_order: int, n_word_order: int, beta: float) -> None:
    if not isinstance(n_char_order, int) or n_char_order < 1:
        raise ValueError("Expected argument `n_char_order` to be an integer greater than or equal to 1.")
    if not isinstance(n_word_order, int) or n_word_order < 0:
        raise ValueError("Expected argument `n_word_order` to be an integer greater than or equal to 0.")
    if beta < 0:
        raise ValueError("Expected argument `beta` to be greater than 0.")


def chrf_score(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    n_char_order: int = 6,
    n_word_order: int = 2,
    beta: float = 2.0,
    lowercase: bool = False,
    whitespace: bool = False,
    return_sentence_level_score: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Corpus chrF (``n_word_order=0``) / chrF++ (default) score.

    Example:
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> chrf_score(preds, target, device="cpu")
        tensor(0.8640)
    """
    _validate_chrf_args(n_char_order, n_word_order, beta)
    n_order = float(n_char_order + n_word_order)
    totals, sentence_scores = _chrf_score_update(
        preds, target, _zero_totals(n_char_order, n_word_order),
        n_char_order, n_word_order, n_order, beta, lowercase, whitespace,
    )
    device = _resolve_device(device)
    score = _chrf_score_compute(totals, n_order, beta, device)
    if return_sentence_level_score:
        return score, _host_to_device(np.asarray(sentence_scores, dtype=np.float32), device)
    return score
