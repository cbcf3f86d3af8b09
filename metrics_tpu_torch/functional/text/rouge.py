"""ROUGE score.

Counterpart of ``metrics_tpu/functional/text/rouge.py``: Rouge-N via clipped
n-gram hits, Rouge-L/Lsum via the longest common subsequence (the
row-vectorized DP of ``helper.py``). Scores are Python floats on the host;
the means reach the device in one copy. ``rougeLsum`` splits sentences with
``nltk`` when its ``punkt`` data is installed and otherwise with the JAX
package's offline regex splitter; the port never downloads anything.
"""
import re
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.functional.text.helper import _host_to_device, _lcs
from metrics_tpu_torch.utils.data import _resolve_device
from metrics_tpu_torch.utils.imports import _NLTK_AVAILABLE

Tensor = torch.Tensor

ALLOWED_ROUGE_KEYS: Dict[str, Union[int, str]] = {
    "rouge1": 1,
    "rouge2": 2,
    "rouge3": 3,
    "rouge4": 4,
    "rouge5": 5,
    "rouge6": 6,
    "rouge7": 7,
    "rouge8": 8,
    "rouge9": 9,
    "rougeL": "L",
    "rougeLsum": "Lsum",
}
ALLOWED_ACCUMULATE_VALUES = ("avg", "best")


def _regex_sent_tokenize(x: str) -> List[str]:
    """Offline fallback sentence splitter: break after ./!/? followed by space."""
    sentences = re.split(r"(?<=[.!?])\s+", x.strip())
    return [s for s in sentences if s]


_PUNKT_USABLE: Optional[bool] = None  # resolved once on first rougeLsum use


def _punkt_usable() -> bool:
    """Probe (once) whether nltk sentence tokenization works with the data
    installed here (``punkt_tab`` on nltk>=3.8.2, ``punkt`` before). No
    download is tried: without the data the regex splitter is used, which
    is what the JAX package gives offline."""
    global _PUNKT_USABLE
    if _PUNKT_USABLE is None:
        import nltk

        try:
            nltk.sent_tokenize("probe. probe.")
            _PUNKT_USABLE = True
        except LookupError:
            _PUNKT_USABLE = False
    return _PUNKT_USABLE


def _add_newline_to_end_of_each_sentence(x: str) -> str:
    """Sentence-split with nltk and re-join with newlines (rougeLsum prep).

    When the nltk punkt model is not installed, falls back to a regex
    splitter (identical on ordinary prose).
    """
    if not _NLTK_AVAILABLE:
        raise ModuleNotFoundError("ROUGE-Lsum calculation requires that `nltk` is installed. Use `pip install nltk`.")
    x = re.sub("<n>", "", x)  # remove pegasus newline char
    if _punkt_usable():
        import nltk

        return "\n".join(nltk.sent_tokenize(x))
    return "\n".join(_regex_sent_tokenize(x))


def _compute_metrics(hits_or_lcs: int, pred_len: int, target_len: int) -> Dict[str, float]:
    """Precision/recall/F1 from hit (or LCS) counts."""
    precision = hits_or_lcs / pred_len
    recall = hits_or_lcs / target_len
    if precision == recall == 0.0:
        return dict(precision=0.0, recall=0.0, fmeasure=0.0)
    fmeasure = 2 * precision * recall / (precision + recall)
    return dict(precision=precision, recall=recall, fmeasure=fmeasure)


def _normalize_and_tokenize_text(
    text: str,
    stemmer: Optional[Any] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
) -> Sequence[str]:
    """Lowercase/strip non-alphanumerics, tokenize, optionally stem."""
    text = normalizer(text) if callable(normalizer) else re.sub(r"[^a-z0-9]+", " ", text.lower())
    tokens = tokenizer(text) if callable(tokenizer) else re.split(r"\s+", text)
    if stemmer:
        tokens = [stemmer.stem(x) if len(x) > 3 else x for x in tokens]
    return [x for x in tokens if (isinstance(x, str) and len(x) > 0)]


def _rouge_n_score(pred: Sequence[str], target: Sequence[str], n_gram: int) -> Dict[str, float]:
    """Rouge-N precision/recall/F1 via clipped n-gram counts."""

    def _create_ngrams(tokens: Sequence[str], n: int) -> Counter:
        ngrams: Counter = Counter()
        for ngram in (tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)):
            ngrams[ngram] += 1
        return ngrams

    pred_ngrams, target_ngrams = _create_ngrams(pred, n_gram), _create_ngrams(target, n_gram)
    pred_len, target_len = sum(pred_ngrams.values()), sum(target_ngrams.values())
    if 0 in (pred_len, target_len):
        return dict(precision=0.0, recall=0.0, fmeasure=0.0)
    hits = sum(min(pred_ngrams[w], target_ngrams[w]) for w in set(pred_ngrams))
    return _compute_metrics(hits, max(pred_len, 1), max(target_len, 1))


def _rouge_l_score(pred: Sequence[str], target: Sequence[str]) -> Dict[str, float]:
    """Rouge-L precision/recall/F1 via LCS length."""
    pred_len, target_len = len(pred), len(target)
    if 0 in (pred_len, target_len):
        return dict(precision=0.0, recall=0.0, fmeasure=0.0)
    return _compute_metrics(_lcs(pred, target), pred_len, target_len)


def _rouge_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    rouge_keys_values: List[Union[int, str]],
    accumulate: str,
    stemmer: Optional[Any] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
) -> Dict[Union[int, str], List[Dict[str, float]]]:
    """Per-sentence rouge scores with avg/best multi-reference accumulation."""
    results: Dict[Union[int, str], List[Dict[str, float]]] = {key: [] for key in rouge_keys_values}

    for pred_raw, target_raw in zip(preds, target):
        result_inner: Dict[Union[int, str], Dict[str, float]] = {key: {} for key in rouge_keys_values}
        result_avg: Dict[Union[int, str], List[Dict[str, float]]] = {key: [] for key in rouge_keys_values}
        list_results = []
        pred = _normalize_and_tokenize_text(pred_raw, stemmer, normalizer, tokenizer)
        if "Lsum" in rouge_keys_values:
            pred_lsum = _normalize_and_tokenize_text(
                _add_newline_to_end_of_each_sentence(pred_raw), stemmer, normalizer, tokenizer
            )

        for target_raw_inner in target_raw:
            tgt = _normalize_and_tokenize_text(target_raw_inner, stemmer, normalizer, tokenizer)
            if "Lsum" in rouge_keys_values:
                target_lsum = _normalize_and_tokenize_text(
                    _add_newline_to_end_of_each_sentence(target_raw_inner), stemmer, normalizer, tokenizer
                )

            for rouge_key in rouge_keys_values:
                if isinstance(rouge_key, int):
                    score = _rouge_n_score(pred, tgt, rouge_key)
                else:
                    score = _rouge_l_score(
                        pred if rouge_key != "Lsum" else pred_lsum,
                        tgt if rouge_key != "Lsum" else target_lsum,
                    )
                result_inner[rouge_key] = score
                result_avg[rouge_key].append(score)
            list_results.append(result_inner.copy())

        if accumulate == "best":
            key_curr = rouge_keys_values[0]
            all_fmeasure = [v[key_curr]["fmeasure"] for v in list_results]
            highest_idx = int(np.argmax(all_fmeasure))
            for rouge_key in rouge_keys_values:
                results[rouge_key].append(list_results[highest_idx][rouge_key])
        elif accumulate == "avg":
            for rouge_key in rouge_keys_values:
                metrics = result_avg[rouge_key]
                results[rouge_key].append(
                    {
                        score_type: float(np.mean([m[score_type] for m in metrics]))
                        for score_type in ("fmeasure", "precision", "recall")
                    }
                )
    return results


def _rouge_score_compute(
    sentence_results: Dict[str, Any], device: Optional[Union[str, torch.device]] = None
) -> Dict[str, Tensor]:
    """Mean over per-sentence scores (``np.mean`` of Python floats or of a
    float32 array, as in the JAX package), each rounded to float32; all of
    them reach ``device`` in one copy."""
    if sentence_results == {}:
        return {}
    means = np.asarray([np.mean(scores) for scores in sentence_results.values()], dtype=np.float32)
    values = _host_to_device(means, _resolve_device(device))
    return dict(zip(sentence_results, values.unbind()))


def rouge_score(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    accumulate: str = "best",
    use_stemmer: bool = False,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
    rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, Tensor]:
    """Calculate ROUGE score for automatic summarization.

    Example:
        >>> preds = "My name is John"
        >>> target = "Is your name John"
        >>> from pprint import pprint
        >>> pprint(rouge_score(preds, target, rouge_keys=("rouge1",), device="cpu"))
        {'rouge1_fmeasure': tensor(0.7500),
         'rouge1_precision': tensor(0.7500),
         'rouge1_recall': tensor(0.7500)}
    """
    if use_stemmer:
        if not _NLTK_AVAILABLE:
            raise ModuleNotFoundError("Stemmer requires that `nltk` is installed. Use `pip install nltk`.")
        import nltk

    stemmer = nltk.stem.porter.PorterStemmer() if use_stemmer else None

    if not isinstance(rouge_keys, tuple):
        rouge_keys = (rouge_keys,)
    for key in rouge_keys:
        if key not in ALLOWED_ROUGE_KEYS.keys():
            raise ValueError(f"Got unknown rouge key {key}. Expected to be one of {list(ALLOWED_ROUGE_KEYS.keys())}")
    if accumulate not in ALLOWED_ACCUMULATE_VALUES:
        raise ValueError(
            f"Got unknown accumulate value {accumulate}. Expected to be one of {ALLOWED_ACCUMULATE_VALUES}"
        )
    rouge_keys_values = [ALLOWED_ROUGE_KEYS[key] for key in rouge_keys]

    if isinstance(target, list) and all(isinstance(tgt, str) for tgt in target):
        target = [target] if isinstance(preds, str) else [[tgt] for tgt in target]
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [[target]]

    sentence_results = _rouge_score_update(
        preds, target, rouge_keys_values, accumulate, stemmer, normalizer, tokenizer
    )

    output: Dict[str, List[float]] = {
        f"rouge{rouge_key}_{tp}": [] for rouge_key in rouge_keys_values for tp in ["fmeasure", "precision", "recall"]
    }
    for rouge_key, metrics in sentence_results.items():
        for metric in metrics:
            for tp, value in metric.items():
                output[f"rouge{rouge_key}_{tp}"].append(value)
    return _rouge_score_compute(output, device)
