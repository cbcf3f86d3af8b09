"""BLEU score.

Counterpart of ``metrics_tpu/functional/text/bleu.py``. The n-gram counting
is host-side Counter math; the module's numerator, denominator and length
states are float32 on the device, one copy per update. The score is taken
on the host from one read of those counts, in float64 and rounded once to
float32, so the card and the CPU give the same bits. The JAX package takes
``log`` and ``exp`` in float32 (XLA's, which differ from correctly rounded
ones on about a tenth of inputs), so the two packages agree within a few
float32 ulp (``tests/test_torch_text.py`` pins the gap).
"""
from collections import Counter
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.utils.data import _resolve_device

Tensor = torch.Tensor


def _count_ngram(ngram_input_list: Sequence[str], n_gram: int) -> Counter:
    """Count all 1..n_gram tuples in a token list."""
    ngram_counter: Counter = Counter()
    for i in range(1, n_gram + 1):
        for j in range(len(ngram_input_list) - i + 1):
            ngram_counter[tuple(ngram_input_list[j : i + j])] += 1
    return ngram_counter


def _tokenize_fn(sentence: str) -> Sequence[str]:
    return sentence.split()


def _bleu_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    numerator: np.ndarray,
    denominator: np.ndarray,
    preds_len: float,
    target_len: float,
    n_gram: int = 4,
    tokenizer: Callable[[str], Sequence[str]] = _tokenize_fn,
) -> Tuple[float, float]:
    """Accumulate clipped n-gram hits into numerator/denominator.

    ``numerator``/``denominator`` are mutated in place (host numpy staging
    buffers); returns updated ``(preds_len, target_len)``.
    """
    target_tok = [[tokenizer(line) if line else [] for line in t] for t in target]
    preds_tok = [tokenizer(line) if line else [] for line in preds]

    for pred, targets in zip(preds_tok, target_tok):
        preds_len += len(pred)
        target_len_list = [len(tgt) for tgt in targets]
        target_len_diff = [abs(len(pred) - x) for x in target_len_list]
        target_len += target_len_list[target_len_diff.index(min(target_len_diff))]
        preds_counter = _count_ngram(pred, n_gram)
        target_counter: Counter = Counter()
        for tgt in targets:
            target_counter |= _count_ngram(tgt, n_gram)

        ngram_counter_clip = preds_counter & target_counter
        for counter_clip in ngram_counter_clip:
            numerator[len(counter_clip) - 1] += ngram_counter_clip[counter_clip]
        for counter in preds_counter:
            denominator[len(counter) - 1] += preds_counter[counter]

    return preds_len, target_len


def _bleu_score_compute(
    preds_len: Union[float, Tensor],
    target_len: Union[float, Tensor],
    numerator: Union[np.ndarray, Tensor],
    denominator: Union[np.ndarray, Tensor],
    n_gram: int = 4,
    smooth: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """Geometric mean of n-gram precisions with brevity penalty, as a
    float32 scalar on ``device`` (the counts' device when they are
    tensors). The counts are read as float32 (the states' dtype), the score
    is taken in float64 and rounded once."""
    if isinstance(numerator, Tensor):
        device = numerator.device
        # the four count states in one read
        counts = torch.cat([preds_len.reshape(1), target_len.reshape(1), numerator, denominator]).cpu().numpy()
        counts = counts.astype(np.float64)
    else:
        device = _resolve_device(device)
        counts = np.concatenate(
            [[preds_len, target_len], numerator, denominator]
        ).astype(np.float32).astype(np.float64)
    preds_len_, target_len_ = counts[0], counts[1]
    num, den = counts[2 : 2 + n_gram], counts[2 + n_gram :]

    if num.min() == 0.0:
        return torch.zeros((), dtype=torch.float32, device=device)

    if smooth:
        precision_scores = (num + 1.0) / (den + 1.0)
        precision_scores[0] = num[0] / den[0]
    else:
        precision_scores = num / den

    geometric_mean = np.exp(np.sum((1.0 / n_gram) * np.log(precision_scores)))
    brevity_penalty = 1.0 if preds_len_ > target_len_ else np.exp(1 - target_len_ / preds_len_)
    return torch.full((), float(np.float32(brevity_penalty * geometric_mean)), dtype=torch.float32, device=device)


def bleu_score(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    n_gram: int = 4,
    smooth: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """Calculate BLEU score of machine-translated text with one or more references.

    Example:
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> bleu_score(preds, target, device="cpu")
        tensor(0.7598)
    """
    preds_ = [preds] if isinstance(preds, str) else preds
    target_ = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]

    if len(preds_) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")

    numerator = np.zeros(n_gram)
    denominator = np.zeros(n_gram)
    preds_len, target_len = _bleu_score_update(preds_, target_, numerator, denominator, 0.0, 0.0, n_gram)
    return _bleu_score_compute(preds_len, target_len, numerator, denominator, n_gram, smooth, device)
