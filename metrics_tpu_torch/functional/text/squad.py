"""SQuAD v1 metric (exact match + token F1).

Counterpart of ``metrics_tpu/functional/text/squad.py`` (the official SQuAD
v1.1 evaluation recipe: lowercase, strip punctuation and articles,
whitespace-tokenize; per question take the max score over all gold answers;
report percentages). String handling on the host; the three sums reach the
device in one copy.
"""
import re
import string
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.functional.text.helper import _float32_sums
from metrics_tpu_torch.utils.data import _resolve_device
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor

SINGLE_PRED_TYPE = Dict[str, str]
PREDS_TYPE = Union[SINGLE_PRED_TYPE, List[SINGLE_PRED_TYPE]]
SINGLE_TARGET_TYPE = Dict[str, Any]
TARGETS_TYPE = Union[SINGLE_TARGET_TYPE, List[SINGLE_TARGET_TYPE]]

_SQUAD_FORMAT = {
    "answers": {"answer_start": [1], "text": ["This is a test text"]},
    "context": "This is a test context.",
    "id": "1",
    "question": "Is this a test?",
    "title": "train test",
}

_ARTICLES = re.compile(r"\b(a|an|the)\b")
_PUNCT = set(string.punctuation)


def _normalize_text(s: str) -> str:
    """Lowercase, drop punctuation, drop articles, squeeze whitespace."""
    s = "".join(ch for ch in s.lower() if ch not in _PUNCT)
    s = _ARTICLES.sub(" ", s)
    return " ".join(s.split())


def _get_tokens(s: str) -> List[str]:
    return _normalize_text(s).split() if s else []


def _exact_match_score(prediction: str, ground_truth: str) -> float:
    return float(_normalize_text(prediction) == _normalize_text(ground_truth))


def _f1_score(prediction: str, ground_truth: str) -> float:
    pred_tokens = _get_tokens(prediction)
    target_tokens = _get_tokens(ground_truth)
    if not pred_tokens or not target_tokens:
        # no-answer convention: 1 iff both are empty
        return float(pred_tokens == target_tokens)
    overlap = sum((Counter(pred_tokens) & Counter(target_tokens)).values())
    if overlap == 0:
        return 0.0
    precision = overlap / len(pred_tokens)
    recall = overlap / len(target_tokens)
    return 2 * precision * recall / (precision + recall)


def _max_over_ground_truths(
    metric_fn: Callable[[str, str], float], prediction: str, ground_truths: List[str]
) -> float:
    return max(metric_fn(prediction, truth) for truth in ground_truths)


def _squad_input_check(preds: PREDS_TYPE, targets: TARGETS_TYPE) -> Tuple[Dict[str, str], List[dict]]:
    """Validate inputs and convert to (id -> answer, nested article format)."""
    if isinstance(preds, dict):
        preds = [preds]
    if isinstance(targets, dict):
        targets = [targets]

    for pred in preds:
        if "prediction_text" not in pred or "id" not in pred:
            raise KeyError(
                "Expected keys in a single prediction are 'prediction_text' and 'id'."
                " Please make sure that 'prediction_text' maps to the answer string and"
                " 'id' maps to the key string."
            )
    for target in targets:
        if "answers" not in target or "id" not in target:
            raise KeyError(
                "Expected keys in a single target are 'answers' and 'id'."
                " Please make sure that 'answers' maps to a `SQuAD` format dictionary and"
                f" 'id' maps to the key string.\nSQuAD Format: {_SQUAD_FORMAT}"
            )
        if "text" not in target["answers"]:
            raise KeyError(
                "Expected keys in a 'answers' are 'text'."
                f" Please make sure that 'answer' maps to a `SQuAD` format dictionary.\n"
                f"SQuAD Format: {_SQUAD_FORMAT}"
            )

    preds_dict = {pred["id"]: pred["prediction_text"] for pred in preds}
    qas = [
        {"id": tgt["id"], "answers": [{"text": txt} for txt in tgt["answers"]["text"]]}
        for tgt in targets
    ]
    return preds_dict, [{"paragraphs": [{"qas": qas}]}]


def _squad_update(
    preds: Dict[str, str], target: List[dict], device: Optional[Union[str, torch.device]] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """Sum of per-question F1 / exact-match (max over gold answers) + count."""
    f1 = 0.0
    exact_match = 0.0
    total = 0
    for article in target:
        for paragraph in article["paragraphs"]:
            for qa in paragraph["qas"]:
                total += 1
                if qa["id"] not in preds:
                    rank_zero_warn(f"Unanswered question {qa['id']} will receive score 0.")
                    continue
                ground_truths = [answer["text"] for answer in qa["answers"]]
                pred = preds[qa["id"]]
                exact_match += _max_over_ground_truths(_exact_match_score, pred, ground_truths)
                f1 += _max_over_ground_truths(_f1_score, pred, ground_truths)
    sums = _float32_sums([f1, exact_match, total], _resolve_device(device))
    return sums[0], sums[1], sums[2].to(torch.int32)


def _squad_compute(f1: Tensor, exact_match: Tensor, total: Tensor) -> Dict[str, Tensor]:
    return {"exact_match": 100.0 * exact_match / total, "f1": 100.0 * f1 / total}


def squad(
    preds: PREDS_TYPE, target: TARGETS_TYPE, device: Optional[Union[str, torch.device]] = None
) -> Dict[str, Tensor]:
    """SQuAD v1 exact-match + F1 (percent).

    Example:
        >>> preds = [{"prediction_text": "1976", "id": "56e10a3be3433e1400422b22"}]
        >>> target = [{"answers": {"answer_start": [97], "text": ["1976"]}, "id": "56e10a3be3433e1400422b22"}]
        >>> {k: float(v) for k, v in squad(preds, target, device="cpu").items()}
        {'exact_match': 100.0, 'f1': 100.0}
    """
    preds_dict, target_dict = _squad_input_check(preds, target)
    f1, exact_match, total = _squad_update(preds_dict, target_dict, device)
    return _squad_compute(f1, exact_match, total)
