"""Translation Edit Rate (TER).

Counterpart of ``metrics_tpu/functional/text/ter.py`` (itself following
sacrebleu's near-exact Tercom reimplementation): the Tercom tokenizer, the
greedy shift search with Tercom's candidate-ranking heuristics and limits,
and the beam-limited Levenshtein with the substitute > delete > insert tie
preference that fixes the alignment trace.

The shift-search hot path (up to 1000 candidate re-scorings per sentence)
scores each candidate with a row-vectorized numpy DP (the prefix-relaxation
trick handles the in-row insert dependency) over a prefix-row trie cache;
the operation-trace DP walks only the beam window. All of it runs on the
host and gives the JAX package's integers; the two corpus totals are
float32 on the device.
"""
import math
import re
from functools import lru_cache
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.functional.text.helper import _float32_sums, _validate_inputs
from metrics_tpu_torch.utils.data import _resolve_device

Tensor = torch.Tensor

# Tercom-inspired limits (reference ter.py:50-54)
_MAX_SHIFT_SIZE = 10
_MAX_SHIFT_DIST = 50
_MAX_SHIFT_CANDIDATES = 1000

# beam-limited DP (reference helper.py:36-40)
_BEAM_WIDTH = 25
_INT_INF = int(1e16)

# edit-operation codes for the trace DP
_OP_NOTHING, _OP_SUBSTITUTE, _OP_INSERT, _OP_DELETE = 0, 1, 2, 3


class _TercomTokenizer:
    """Tercom normalizer/tokenizer (rule tables fixed by the Tercom spec;
    reference ter.py:57-193, following sacrebleu's tokenizer_ter.py)."""

    _ASIAN_PUNCTUATION = r"([、。〈-】〔-〟｡-･・])"
    _FULL_WIDTH_PUNCTUATION = r"([．，？：；！＂（）])"

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
    ) -> None:
        self.normalize = normalize
        self.no_punctuation = no_punctuation
        self.lowercase = lowercase
        self.asian_support = asian_support

    @lru_cache(maxsize=2**16)
    def __call__(self, sentence: str) -> str:
        if not sentence:
            return ""
        if self.lowercase:
            sentence = sentence.lower()
        if self.normalize:
            sentence = self._normalize_general_and_western(sentence)
            if self.asian_support:
                sentence = self._normalize_asian(sentence)
        if self.no_punctuation:
            sentence = self._remove_punct(sentence)
            if self.asian_support:
                sentence = self._remove_asian_punct(sentence)
        return " ".join(sentence.split())

    @staticmethod
    def _normalize_general_and_western(sentence: str) -> str:
        sentence = f" {sentence} "
        rules = [
            (r"\n-", ""),
            (r"\n", " "),
            (r"&quot;", '"'),
            (r"&amp;", "&"),
            (r"&lt;", "<"),
            (r"&gt;", ">"),
            (r"([{-~[-` -&(-+:-@/])", r" \1 "),
            (r"'s ", r" 's "),
            (r"'s$", r" 's"),
            (r"([^0-9])([\.,])", r"\1 \2 "),
            (r"([\.,])([^0-9])", r" \1 \2"),
            (r"([0-9])(-)", r"\1 \2 "),
        ]
        for pattern, replacement in rules:
            sentence = re.sub(pattern, replacement, sentence)
        return sentence

    @classmethod
    def _normalize_asian(cls, sentence: str) -> str:
        sentence = re.sub(r"([一-鿿㐀-䶿])", r" \1 ", sentence)
        sentence = re.sub(r"([㇀-㇯⺀-⻿])", r" \1 ", sentence)
        sentence = re.sub(r"([㌀-㏿豈-﫿︰-﹏])", r" \1 ", sentence)
        sentence = re.sub(r"([㈀-㼢])", r" \1 ", sentence)
        sentence = re.sub(r"(^|^[぀-ゟ])([぀-ゟ]+)(?=$|^[぀-ゟ])", r"\1 \2 ", sentence)
        sentence = re.sub(r"(^|^[゠-ヿ])([゠-ヿ]+)(?=$|^[゠-ヿ])", r"\1 \2 ", sentence)
        sentence = re.sub(r"(^|^[ㇰ-ㇿ])([ㇰ-ㇿ]+)(?=$|^[ㇰ-ㇿ])", r"\1 \2 ", sentence)
        sentence = re.sub(cls._ASIAN_PUNCTUATION, r" \1 ", sentence)
        sentence = re.sub(cls._FULL_WIDTH_PUNCTUATION, r" \1 ", sentence)
        return sentence

    @staticmethod
    def _remove_punct(sentence: str) -> str:
        return re.sub(r"[\.,\?:;!\"\(\)]", "", sentence)

    @classmethod
    def _remove_asian_punct(cls, sentence: str) -> str:
        sentence = re.sub(cls._ASIAN_PUNCTUATION, r"", sentence)
        return re.sub(cls._FULL_WIDTH_PUNCTUATION, r"", sentence)


def _preprocess_sentence(sentence: str, tokenizer: _TercomTokenizer) -> str:
    return tokenizer(sentence.rstrip())


_MAX_CACHE_SIZE = 10000


class _RefEditScorer:
    """Edit distances of candidate hypotheses against ONE fixed reference.

    Reproduces the reference _LevenshteinEditDistance (helper.py:64-306)
    semantics EXACTLY — including the prefix-row trie cache, whose frozen
    rows (computed under an earlier call's beam window) are deliberately
    reused by later calls with different lengths; this quirk influences
    Tercom shift choices and therefore final TER values — but computes each
    new row with a vectorized numpy kernel instead of per-cell Python loops.
    """

    def __init__(self, reference_tokens: List[str]) -> None:
        self.reference_tokens = reference_tokens
        self._vocab: Dict[str, int] = {}
        self.ref_ids = self._intern(reference_tokens)
        m = len(self.ref_ids)
        self._initial_row = (
            np.arange(m + 1, dtype=np.int64),
            np.full(m + 1, _OP_INSERT, np.int8),
        )
        # trie over hypothesis word ids: wid -> (child_dict, (cost_row, op_row))
        self._trie: Dict[int, tuple] = {}
        self._cache_size = 0

    def _intern(self, tokens: Sequence[str]) -> Tuple[int, ...]:
        return tuple(self._vocab.setdefault(t, len(self._vocab)) for t in tokens)

    @staticmethod
    def _beam_bounds(i: int, n_pred: int, n_ref: int, length_ratio: float) -> Tuple[int, int]:
        """Row window of the beam-limited DP (reference helper.py:131-143)."""
        beam = (
            math.ceil(length_ratio / 2 + _BEAM_WIDTH)
            if _BEAM_WIDTH < length_ratio / 2
            else _BEAM_WIDTH
        )
        pseudo_diag = math.floor(i * length_ratio)
        min_j = max(0, pseudo_diag - beam)
        max_j = n_ref + 1 if i == n_pred else min(n_ref + 1, pseudo_diag + beam)
        return min_j, max_j

    def _compute_row(
        self, prev_cost: np.ndarray, word_id: int, min_j: int, max_j: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """One DP row, vectorized, with the reference's tie order
        (substitute/nothing first, then delete, then insert;
        helper.py:160-174). The in-row insert dependency is resolved with a
        prefix-min; insert wins a cell only when strictly cheaper."""
        m = len(self.ref_ids)
        cols = np.arange(m + 1, dtype=np.int64)
        ref_arr = np.asarray(self.ref_ids, np.int64) if m else np.zeros(0, np.int64)

        sub_cost = (ref_arr != word_id).astype(np.int64)
        diag = prev_cost[:-1] + sub_cost
        top = prev_cost[1:] + 1
        pre = np.full(m + 1, _INT_INF, np.int64)
        pre[0] = prev_cost[0] + 1  # delete-only first column
        np.minimum(diag, top, out=pre[1:])
        pre_op = np.empty(m + 1, np.int8)
        pre_op[0] = _OP_DELETE
        pre_op[1:] = np.where(
            top < diag,
            _OP_DELETE,
            np.where(sub_cost == 0, _OP_NOTHING, _OP_SUBSTITUTE),
        )
        pre[:min_j] = _INT_INF
        pre[max_j:] = _INT_INF

        cost = np.minimum(pre, np.minimum.accumulate(pre - cols) + cols)
        op = np.where(cost < pre, _OP_INSERT, pre_op).astype(np.int8)
        cost[:min_j] = _INT_INF
        cost[max_j:] = _INT_INF
        return cost, op

    def _rows(self, pred_ids: Tuple[int, ...]) -> List[Tuple[np.ndarray, np.ndarray]]:
        """All DP rows for this hypothesis: initial + cached prefix + fresh."""
        rows: List[Tuple[np.ndarray, np.ndarray]] = [self._initial_row]
        node = self._trie
        start = 0
        for wid in pred_ids:
            if wid in node:
                node, row = node[wid]
                rows.append(row)
                start += 1
            else:
                break

        n, m = len(pred_ids), len(self.ref_ids)
        length_ratio = m / n if pred_ids else 1.0
        new_rows: List[Tuple[np.ndarray, np.ndarray]] = []
        prev_cost = rows[-1][0]
        for i in range(start + 1, n + 1):
            min_j, max_j = self._beam_bounds(i, n, m, length_ratio)
            row = self._compute_row(prev_cost, pred_ids[i - 1], min_j, max_j)
            new_rows.append(row)
            rows.append(row)
            prev_cost = row[0]

        # cache the fresh rows (reference helper.py:218-249: size checked
        # once at entry, then the whole suffix is added)
        if self._cache_size < _MAX_CACHE_SIZE:
            node = self._trie
            for wid in pred_ids[:start]:
                node = node[wid][0]
            for wid, row in zip(pred_ids[start:], new_rows):
                if wid not in node:
                    node[wid] = ({}, row)
                    self._cache_size += 1
                node = node[wid][0]
        return rows

    def distance(self, prediction_tokens: Sequence[str]) -> int:
        rows = self._rows(self._intern(prediction_tokens))
        return int(rows[-1][0][len(self.ref_ids)])

    def distance_with_trace(self, prediction_tokens: Sequence[str]) -> Tuple[int, List[int]]:
        pred_ids = self._intern(prediction_tokens)
        rows = self._rows(pred_ids)
        i, j = len(pred_ids), len(self.ref_ids)
        trace: List[int] = []
        while i > 0 or j > 0:
            operation = int(rows[i][1][j])
            trace.append(operation)
            if operation in (_OP_NOTHING, _OP_SUBSTITUTE):
                i, j = i - 1, j - 1
            elif operation == _OP_INSERT:
                j -= 1
            else:  # delete
                i -= 1
        trace.reverse()
        return int(rows[len(pred_ids)][0][len(self.ref_ids)]), trace


def _flip_trace(trace: List[int]) -> List[int]:
    """Rewrite the a->b recipe as b->a (swap inserts and deletes)."""
    swap = {_OP_INSERT: _OP_DELETE, _OP_DELETE: _OP_INSERT}
    return [swap.get(operation, operation) for operation in trace]


def _trace_to_alignment(trace: List[int]) -> Tuple[Dict[int, int], List[int], List[int]]:
    """Alignment map + per-position error flags from an operation trace
    (reference helper.py:398-446)."""
    ref_pos = pred_pos = -1
    alignments: Dict[int, int] = {}
    ref_errors: List[int] = []
    pred_errors: List[int] = []
    for operation in trace:
        if operation == _OP_NOTHING:
            pred_pos += 1
            ref_pos += 1
            alignments[ref_pos] = pred_pos
            ref_errors.append(0)
            pred_errors.append(0)
        elif operation == _OP_SUBSTITUTE:
            pred_pos += 1
            ref_pos += 1
            alignments[ref_pos] = pred_pos
            ref_errors.append(1)
            pred_errors.append(1)
        elif operation == _OP_INSERT:
            pred_pos += 1
            pred_errors.append(1)
        elif operation == _OP_DELETE:
            ref_pos += 1
            alignments[ref_pos] = pred_pos  # deleted ref words map to the last hyp position
            ref_errors.append(1)
        else:
            raise ValueError(f"Unknown operation {operation!r}")
    return alignments, ref_errors, pred_errors


def _find_shifted_pairs(pred_words: List[str], target_words: List[str]) -> Iterator[Tuple[int, int, int]]:
    """All matching word sub-sequences eligible for a Tercom shift
    (reference ter.py:209-247)."""
    for pred_start in range(len(pred_words)):
        for target_start in range(len(target_words)):
            if abs(target_start - pred_start) > _MAX_SHIFT_DIST:
                continue
            for length in range(1, _MAX_SHIFT_SIZE):
                if pred_words[pred_start + length - 1] != target_words[target_start + length - 1]:
                    break
                yield pred_start, target_start, length
                if len(pred_words) == pred_start + length or len(target_words) == target_start + length:
                    break


def _shift_is_pointless(
    alignments: Dict[int, int],
    pred_errors: List[int],
    target_errors: List[int],
    pred_start: int,
    target_start: int,
    length: int,
) -> bool:
    """Tercom corner cases: skip shifts of already-correct spans, spans whose
    target is already matched, and shifts within the own sub-sequence
    (reference ter.py:250-291)."""
    if sum(pred_errors[pred_start : pred_start + length]) == 0:
        return True
    if sum(target_errors[target_start : target_start + length]) == 0:
        return True
    if pred_start <= alignments[target_start] < pred_start + length:
        return True
    return False


def _perform_shift(words: List[str], start: int, length: int, target: int) -> List[str]:
    """Move ``words[start:start+length]`` to position ``target``
    (reference ter.py:294-327)."""
    span = words[start : start + length]
    if target < start:
        return words[:target] + span + words[target:start] + words[start + length :]
    if target > start + length:
        return words[:start] + words[start + length : target] + span + words[target:]
    return words[:start] + words[start + length : length + target] + span + words[length + target :]


def _shift_words(
    pred_words: List[str],
    target_words: List[str],
    scorer: _RefEditScorer,
    checked_candidates: int,
) -> Tuple[int, List[str], int]:
    """One round of Tercom's greedy shift selection: try every eligible
    shifted candidate, ranked by (edit-distance gain, span length, earliest
    pred position, earliest target position) (reference ter.py:329-410)."""
    edit_distance, inverted_trace = scorer.distance_with_trace(pred_words)
    trace = _flip_trace(inverted_trace)
    alignments, target_errors, pred_errors = _trace_to_alignment(trace)

    best: Optional[Tuple[int, int, int, int, List[str]]] = None
    for pred_start, target_start, length in _find_shifted_pairs(pred_words, target_words):
        if _shift_is_pointless(alignments, pred_errors, target_errors, pred_start, target_start, length):
            continue

        prev_idx = -1
        for offset in range(-1, length):
            if target_start + offset == -1:
                idx = 0
            elif target_start + offset in alignments:
                idx = alignments[target_start + offset] + 1
            else:
                break  # offset aims past the reference
            if idx == prev_idx:
                continue
            prev_idx = idx

            shifted_words = _perform_shift(pred_words, pred_start, length, idx)
            candidate = (
                edit_distance - scorer.distance(shifted_words),
                length,
                -pred_start,
                -idx,
                shifted_words,
            )
            checked_candidates += 1
            if not best or candidate > best:
                best = candidate

        if checked_candidates >= _MAX_SHIFT_CANDIDATES:
            break

    if not best:
        return 0, pred_words, checked_candidates
    best_score, _, _, _, shifted_words = best
    return best_score, shifted_words, checked_candidates


def _translation_edit_rate(pred_words: List[str], target_words: List[str]) -> int:
    """Edits needed to turn ``pred_words`` into ``target_words`` including
    shifts (reference ter.py:413-444)."""
    if len(target_words) == 0:
        return 0

    scorer = _RefEditScorer(target_words)
    num_shifts = 0
    checked_candidates = 0
    input_words = pred_words
    while True:
        delta, new_input_words, checked_candidates = _shift_words(
            input_words, target_words, scorer, checked_candidates
        )
        if checked_candidates >= _MAX_SHIFT_CANDIDATES or delta <= 0:
            break
        num_shifts += 1
        input_words = new_input_words

    return num_shifts + scorer.distance(input_words)


def _compute_sentence_statistics(
    pred_words: List[str], target_words: List[List[str]]
) -> Tuple[float, float]:
    """Best edit count over references + average reference length. NOTE: the
    reference evaluates ``_translation_edit_rate(tgt_words, pred_words)``
    with swapped roles (ter.py:467) — preserved for parity."""
    tgt_lengths = 0.0
    best_num_edits = float(2e16)
    for tgt_words in target_words:
        num_edits = _translation_edit_rate(tgt_words, pred_words)
        tgt_lengths += len(tgt_words)
        if num_edits < best_num_edits:
            best_num_edits = float(num_edits)
    avg_tgt_len = tgt_lengths / len(target_words) if target_words else 0.0
    return best_num_edits, avg_tgt_len


def _compute_ter_score_from_statistics(num_edits: float, tgt_length: float) -> float:
    if tgt_length > 0 and num_edits > 0:
        return num_edits / tgt_length
    if tgt_length == 0 and num_edits > 0:
        return 1.0
    return 0.0


def _ter_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    tokenizer: _TercomTokenizer,
) -> Tuple[float, float, List[float]]:
    """Per-batch totals: (sum best edits, sum avg reference length,
    sentence-level scores)."""
    target, preds = _validate_inputs(target, preds)

    total_num_edits = 0.0
    total_tgt_length = 0.0
    sentence_ter: List[float] = []
    for pred, tgt in zip(preds, target):
        tgt_words = [_preprocess_sentence(t, tokenizer).split() for t in tgt]
        pred_words = _preprocess_sentence(pred, tokenizer).split()
        num_edits, tgt_length = _compute_sentence_statistics(pred_words, tgt_words)
        total_num_edits += num_edits
        total_tgt_length += tgt_length
        sentence_ter.append(_compute_ter_score_from_statistics(num_edits, tgt_length))
    return total_num_edits, total_tgt_length, sentence_ter


def _ter_compute(total_num_edits: Tensor, total_tgt_length: Tensor) -> Tensor:
    score = torch.where(
        (total_tgt_length > 0) & (total_num_edits > 0),
        total_num_edits / torch.clamp(total_tgt_length, min=1e-38),
        torch.where((total_tgt_length == 0) & (total_num_edits > 0), 1.0, 0.0).to(total_num_edits.dtype),
    )
    return score.to(torch.float32)


def translation_edit_rate(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    normalize: bool = False,
    no_punctuation: bool = False,
    lowercase: bool = True,
    asian_support: bool = False,
    return_sentence_level_score: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Union[Tensor, Tuple[Tensor, List[Tensor]]]:
    """Corpus-level Translation Edit Rate.

    Example:
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> translation_edit_rate(preds, target, device="cpu")
        tensor(0.1538)
    """
    for name, value in [
        ("normalize", normalize),
        ("no_punctuation", no_punctuation),
        ("lowercase", lowercase),
        ("asian_support", asian_support),
    ]:
        if not isinstance(value, bool):
            raise ValueError(f"Expected argument `{name}` to be of type boolean but got {value}.")

    tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
    total_num_edits, total_tgt_length, sentence_ter = _ter_update(preds, target, tokenizer)
    sums = _float32_sums([total_num_edits, total_tgt_length] + sentence_ter, _resolve_device(device))
    score = _ter_compute(sums[0], sums[1])
    if return_sentence_level_score:
        return score, list(sums[2:].unbind())
    return score
