"""Shared text-metric helpers: input validation, the row-vectorized edit
distance and LCS, and the one host-to-device copy of an update.

Counterpart of ``metrics_tpu/functional/text/helper.py`` (kept as a copy:
the port imports nothing of the JAX package). Tokenization and the dynamic
programs run on the host and give the same integers; each DP row is one
vectorized numpy step. What an update adds to its device states reaches
the card in one copy of one stacked float32 array
(:func:`_host_to_device`).
"""
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

Tensor = torch.Tensor


def _validate_inputs(
    ref_corpus: Union[Sequence[str], Sequence[Sequence[str]]],
    hyp_corpus: Union[str, Sequence[str]],
) -> Tuple[Sequence[Sequence[str]], Sequence[str]]:
    """Normalize reference/hypothesis corpora to ``Sequence[Sequence[str]]`` / ``Sequence[str]``."""
    if isinstance(hyp_corpus, str):
        hyp_corpus = [hyp_corpus]

    if all(isinstance(ref, str) for ref in ref_corpus):
        if len(hyp_corpus) == 1:
            ref_corpus = [ref_corpus]  # type: ignore[list-item]
        else:
            ref_corpus = [[ref] for ref in ref_corpus]  # type: ignore[misc]

    if hyp_corpus and all(ref for ref in ref_corpus) and len(ref_corpus) != len(hyp_corpus):
        raise ValueError(f"Corpus has different size {len(ref_corpus)} != {len(hyp_corpus)}")
    return ref_corpus, hyp_corpus


def _token_ids(a: Sequence[str], b: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Map two token sequences into a shared integer id space."""
    vocab: dict = {}
    aid = np.fromiter((vocab.setdefault(t, len(vocab)) for t in a), np.int64, len(a))
    bid = np.fromiter((vocab.setdefault(t, len(vocab)) for t in b), np.int64, len(b))
    return aid, bid


def _edit_distance(prediction_tokens: List[str], reference_tokens: List[str]) -> int:
    """Levenshtein distance between two token sequences.

    Each DP row is one vectorized numpy step. The in-row insertion
    dependency ``dp[j] = min(dp[j], dp[j-1]+1)`` telescopes to
    ``min_k<=j (cand[k] + (j-k))``, computed as a running min of
    ``cand[k]-k`` plus ``j``.
    """
    n, m = len(prediction_tokens), len(reference_tokens)
    if n == 0:
        return m
    if m == 0:
        return n
    pid, rid = _token_ids(prediction_tokens, reference_tokens)

    jrange = np.arange(m + 1, dtype=np.int64)
    prev = jrange.copy()
    cand = np.empty(m + 1, np.int64)
    for i in range(1, n + 1):
        subst = (rid != pid[i - 1]).astype(np.int64)
        cand[0] = i
        np.minimum(prev[1:] + 1, prev[:-1] + subst, out=cand[1:])
        prev = np.minimum.accumulate(cand - jrange) + jrange
    return int(prev[m])


def _lcs(pred_tokens: Sequence[str], target_tokens: Sequence[str]) -> int:
    """Length of the longest common subsequence. Row-vectorized: within a
    row the left-neighbor max telescopes to a running maximum (LCS rows are
    non-decreasing)."""
    n, m = len(pred_tokens), len(target_tokens)
    if n == 0 or m == 0:
        return 0
    pid, tid = _token_ids(pred_tokens, target_tokens)

    prev = np.zeros(m + 1, np.int64)
    cand = np.empty(m + 1, np.int64)
    for i in range(1, n + 1):
        eq = (tid == pid[i - 1]).astype(np.int64)
        cand[0] = 0
        np.maximum(prev[1:], prev[:-1] + eq, out=cand[1:])
        prev = np.maximum.accumulate(cand)
    return int(prev[m])


def _host_to_device(values: np.ndarray, device: torch.device) -> Tensor:
    """``values`` (a host array) on ``device`` after one copy. On the card
    the copy goes from pinned memory without blocking the host, so an
    update that ends in it makes no host sync."""
    out = torch.from_numpy(np.ascontiguousarray(values))
    if device.type == "cuda":
        return out.pin_memory().to(device, non_blocking=True)
    return out.to(device)


def _float32_sums(values: Sequence, device: torch.device) -> Tensor:
    """Host numbers (a list, or a list of equal-length rows) as one float32
    tensor on ``device`` after one copy: each rounds once to float32, as
    ``jnp.asarray(x, jnp.float32)`` rounds it."""
    return _host_to_device(np.asarray(values, dtype=np.float64).astype(np.float32), device)
