"""BERTScore (contextual-embedding cosine matching).

Counterpart of ``metrics_tpu/functional/text/bert.py``: tokenize, embed
with a BERT encoder, L2-normalize, zero out [CLS]/[SEP] via the processed
attention mask, greedy cosine matching (row/column max), IDF weighting
computed on the TARGET corpus, optional all-layers output and baseline
rescaling.

``model`` is the port's BERT (:mod:`metrics_tpu_torch.models.bert`), a
``transformers`` torch model, or any callable
``(input_ids, attention_mask) -> [batch, seq, dim]`` tensor; with
``model_name_or_path`` a LOCAL ``transformers`` checkpoint is loaded
(``transformers`` is imported only then). Batches keep one padded length
(the attention mask makes the results identical to re-trimmed batches),
scores come back in input order, and baselines load from ``baseline_path``
only. The encoder runs on ``device`` (the card by default) at full float32,
and so do the normalisation and the cosine matching; the token ids reach
the device in one copy per batch.
"""
import csv
import math
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.functional.text.helper import _host_to_device
from metrics_tpu_torch.models import full_float32_convs
from metrics_tpu_torch.utils.data import _resolve_device

Tensor = torch.Tensor


def _process_attention_mask_for_special_tokens(attention_mask: Tensor) -> Tensor:
    """Zero the [CLS] (first) and [SEP] (last attended) positions. The last
    attended position is the first maximum of ``cumsum(mask - 0.1)``, taken
    here in integers (``cumsum(10 mask - 1)``), so no rounding decides it."""
    attention_mask = attention_mask.clone()
    attention_mask[:, 0] = 0
    sep_pos = torch.argmax(torch.cumsum(10 * attention_mask.long() - 1, dim=-1), dim=-1)
    attention_mask[torch.arange(attention_mask.shape[0], device=attention_mask.device), sep_pos] = 0
    return attention_mask


def _tokens_idf(input_ids: np.ndarray) -> Dict[int, float]:
    """log((N+1)/(df+1)) inverse document frequencies over a corpus; unseen
    tokens default to log(N+1)."""
    num_sentences = len(input_ids)
    counter: Counter = Counter()
    for ids in input_ids:
        # ALL input_ids count, padding included, so the pad token gets
        # df = num_sentences (as in the JAX package)
        counter.update(set(ids.tolist()))
    idf = {idx: math.log((num_sentences + 1) / (df + 1)) for idx, df in counter.items()}
    default = math.log(num_sentences + 1)
    return {"__default__": default, **idf}


def _idf_matrix(input_ids: np.ndarray, idf: Dict[int, float]) -> np.ndarray:
    default = idf["__default__"]
    lookup = np.vectorize(lambda t: idf.get(int(t), default))
    return lookup(input_ids).astype(np.float32)


def _default_forward(model: Any, num_layers: Optional[int], all_layers: bool) -> Callable:
    """Forward through a BERT model, selecting hidden layers (index 0 is the
    embeddings' output)."""
    from metrics_tpu_torch.models.bert import bert_forward

    def forward(input_ids: Tensor, attention_mask: Tensor) -> Tensor:
        hidden = bert_forward(model, input_ids, attention_mask)
        if all_layers:
            return torch.stack(hidden, dim=1)  # [B, L, S, D]
        layer = hidden[num_layers if num_layers is not None else -1]
        return layer[:, None]  # [B, 1, S, D]

    return forward


def _on_device(tok: Dict[str, Any], device: torch.device) -> Tuple[Tensor, Tensor]:
    """``input_ids`` and ``attention_mask`` as int64 tensors on ``device``:
    host arrays in one copy (stacked), tensors moved as they are."""
    ids, mask = tok["input_ids"], tok["attention_mask"]
    if isinstance(ids, Tensor) and isinstance(mask, Tensor):
        return ids.to(device).long(), mask.to(device).long()
    both = _host_to_device(np.stack([np.asarray(ids, np.int64), np.asarray(mask, np.int64)]), device)
    return both[0], both[1]


def _embed_corpus(
    input_ids: Tensor,
    attention_mask: Tensor,
    forward: Callable,
    batch_size: int,
    idf_weights: Optional[Tensor],
) -> Tuple[Tensor, Tensor]:
    """Normalized, special-token-masked embeddings + per-token weight scale."""
    embeddings = []
    scales = []
    for lo in range(0, len(input_ids), batch_size):
        ids = input_ids[lo : lo + batch_size]
        mask = attention_mask[lo : lo + batch_size]
        with torch.no_grad():
            out = forward(ids, mask)
        if out.ndim == 3:  # user forward fn returns [B, S, D]
            if out.shape[:2] != ids.shape[:2]:
                raise ValueError(
                    "The model output must be of shape [batch_size, seq_len, model_dim],"
                    f" i.e. [{ids.shape[0]}, {ids.shape[1]}, model_dim], but got {out.shape}."
                )
            out = out[:, None]
        out = out / torch.clamp(torch.linalg.vector_norm(out, dim=-1, keepdim=True), min=1e-30)
        processed_mask = _process_attention_mask_for_special_tokens(mask)
        out = out * processed_mask.to(out.dtype)[:, None, :, None]
        embeddings.append(out)

        if idf_weights is not None:
            scale = idf_weights[lo : lo + batch_size] * processed_mask
        else:
            scale = processed_mask.to(out.dtype)
        scale = scale / torch.clamp(scale.sum(-1, keepdim=True), min=1e-30)
        scales.append(scale)
    return torch.cat(embeddings), torch.cat(scales)


def _greedy_cosine_scores(
    preds_embeddings: Tensor, target_embeddings: Tensor, preds_scale: Tensor, target_scale: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Greedy matching: precision = row max, recall = column max, weighted."""
    cos_sim = torch.matmul(preds_embeddings, target_embeddings.transpose(-1, -2))  # [B, L, P, R]
    precision = (cos_sim.amax(dim=3) * preds_scale[:, None]).sum(-1)
    recall = (cos_sim.amax(dim=2) * target_scale[:, None]).sum(-1)
    f1 = 2 * precision * recall / (precision + recall)
    f1 = torch.where(torch.isnan(f1), torch.zeros_like(f1), f1)
    # [B, L] -> [L, B] to match the original BERTScore layout, squeezed below
    return precision.T, recall.T, f1.T


def _read_baseline_csv(baseline_path: str) -> np.ndarray:
    with open(baseline_path) as handle:
        rows = [[float(item) for item in row] for idx, row in enumerate(csv.reader(handle)) if idx > 0]
    return np.asarray(rows, np.float32)[:, 1:]


def _rescale_with_baseline(
    precision: Tensor, recall: Tensor, f1: Tensor, baseline: np.ndarray, num_layers: Optional[int], all_layers: bool
) -> Tuple[Tensor, Tensor, Tensor]:
    if num_layers is None and not all_layers:
        num_layers = -1
    stacked = torch.stack([precision, recall, f1], dim=-1)
    base = torch.from_numpy(baseline).to(stacked.device)
    scale = base[:, None] if all_layers else base[num_layers]
    stacked = (stacked - scale) / (1 - scale)
    return stacked[..., 0], stacked[..., 1], stacked[..., 2]


def _tokenize(
    texts: List[str], tokenizer: Any, max_length: int, own_tokenizer: bool, truncation: bool = True
) -> Dict[str, np.ndarray]:
    """HF-style tokenizers are called with padding/truncation kwargs (also
    user tokenizers, as the JAX package does); plain ``(texts, max_length)``
    callables are supported as a fallback."""
    if not own_tokenizer:
        encoded = tokenizer(texts, padding=True, max_length=max_length, truncation=truncation, return_tensors="np")
    else:
        try:
            encoded = tokenizer(texts, padding=True, max_length=max_length, truncation=truncation, return_tensors="np")
        except TypeError:
            try:
                encoded = tokenizer(texts, max_length)
            except BaseException as ex:
                raise BaseException(f"Tokenization was not successful: {ex}")
    return {
        "input_ids": np.asarray(encoded["input_ids"]),
        "attention_mask": np.asarray(encoded["attention_mask"]),
    }


def _host_ids(ids: Any) -> np.ndarray:
    return ids.cpu().numpy() if isinstance(ids, Tensor) else np.asarray(ids)


def bert_score(
    preds: Union[List[str], Dict[str, Any]],
    target: Union[List[str], Dict[str, Any]],
    model_name_or_path: Optional[str] = None,
    num_layers: Optional[int] = None,
    all_layers: bool = False,
    model: Optional[Callable] = None,
    user_tokenizer: Any = None,
    user_forward_fn: Optional[Callable] = None,
    idf: bool = False,
    max_length: int = 512,
    batch_size: int = 64,
    return_hash: bool = False,
    lang: str = "en",
    rescale_with_baseline: bool = False,
    baseline_path: Optional[str] = None,
    device: Optional[Union[str, torch.device]] = None,
    **_ignored: Any,
) -> Dict[str, Union[List[float], str]]:
    """BERTScore precision/recall/F1 per sentence pair.

    ``model`` may be the port's BERT, a ``transformers`` torch model or any
    callable ``(input_ids, attention_mask) -> [batch, seq, dim]``; with
    ``model_name_or_path`` a LOCAL ``transformers`` checkpoint is loaded.
    ``preds``/``target`` are lists of strings (with a tokenizer) or dicts
    of pre-tokenized ``input_ids``/``attention_mask`` (numpy or tensors).
    The model must already be on ``device`` (the card by default).
    """
    if len(preds) != len(target):
        raise ValueError("Number of predicted and reference sententes must be the same!")

    empty_lists = all(isinstance(t, list) and len(t) == 0 for t in (preds, target))
    if empty_lists:
        output: Dict[str, Union[List[float], str]] = {"precision": [0.0], "recall": [0.0], "f1": [0.0]}
        if return_hash:
            output["hash"] = f"{model_name_or_path}_L{num_layers}{'_idf' if idf else '_no-idf'}"
        return output

    device = _resolve_device(device)
    tokenizer = user_tokenizer
    if model is None:
        if model_name_or_path is None:
            raise ValueError(
                "`bert_score` needs either a `model` callable or a LOCAL `model_name_or_path`"
                " transformers checkpoint — this environment cannot download the default model."
            )
        from transformers import AutoModel, AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_name_or_path)
        model = AutoModel.from_pretrained(model_name_or_path).eval().to(device)
    elif user_forward_fn is None and not callable(getattr(model, "__call__", None)):
        raise ValueError("`model` must be callable or `user_forward_fn` must be provided.")

    valid_lists = all(isinstance(t, list) and len(t) > 0 and isinstance(t[0], str) for t in (preds, target))
    if valid_lists:
        if tokenizer is None:
            raise ValueError("A tokenizer is required for string inputs (pass `user_tokenizer`).")
        target_tok = _tokenize(target, tokenizer, max_length, own_tokenizer=user_tokenizer is not None)
        preds_tok = _tokenize(preds, tokenizer, max_length, own_tokenizer=user_tokenizer is not None)
    elif all(isinstance(t, dict) and "input_ids" in t for t in (preds, target)):
        target_tok = {k: target[k] for k in ("input_ids", "attention_mask")}
        preds_tok = {k: preds[k] for k in ("input_ids", "attention_mask")}
    else:
        raise ValueError("Invalid input provided.")

    preds_idf = target_idf = None
    if idf:
        idf_dict = _tokens_idf(_host_ids(target_tok["input_ids"]))
        preds_idf = _host_to_device(_idf_matrix(_host_ids(preds_tok["input_ids"]), idf_dict), device)
        target_idf = _host_to_device(_idf_matrix(_host_ids(target_tok["input_ids"]), idf_dict), device)

    if user_forward_fn is not None:
        if all_layers:
            raise ValueError("The option `all_layers=True` can be used only with default `transformers` models.")
        forward = lambda ids, mask: user_forward_fn(model, {"input_ids": ids, "attention_mask": mask})
    elif callable(model) and not hasattr(model, "config"):
        forward = lambda ids, mask: model(ids, mask)
    else:
        forward = _default_forward(model, num_layers, all_layers)

    preds_ids, preds_mask = _on_device(preds_tok, device)
    target_ids, target_mask = _on_device(target_tok, device)
    with full_float32_convs(device):
        target_embeddings, target_scale = _embed_corpus(target_ids, target_mask, forward, batch_size, target_idf)
        preds_embeddings, preds_scale = _embed_corpus(preds_ids, preds_mask, forward, batch_size, preds_idf)
        precision, recall, f1 = _greedy_cosine_scores(preds_embeddings, target_embeddings, preds_scale, target_scale)
    if precision.shape[0] == 1:  # single-layer: squeeze to [B]
        precision, recall, f1 = precision[0], recall[0], f1[0]

    if rescale_with_baseline:
        if baseline_path is None:
            raise ValueError(
                "`rescale_with_baseline=True` requires `baseline_path` (no network access to fetch baselines)."
            )
        precision, recall, f1 = _rescale_with_baseline(
            precision, recall, f1, _read_baseline_csv(baseline_path), num_layers, all_layers
        )

    host = torch.stack([precision, recall, f1]).cpu().numpy()  # one read
    output = {
        "precision": np.atleast_1d(host[0]).tolist(),
        "recall": np.atleast_1d(host[1]).tolist(),
        "f1": np.atleast_1d(host[2]).tolist(),
    }
    if return_hash:
        output["hash"] = f"{model_name_or_path}_L{num_layers}{'_idf' if idf else '_no-idf'}"
    return output
