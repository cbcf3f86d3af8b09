"""Modular BERTScore.

Counterpart of ``metrics_tpu/text/bert.py``: the class tokenizes at update
time and accumulates int32 ``input_ids``/``attention_mask`` list states of
both corpora on the metric's device (``"cat"``-synced), all chunks of a
state kept at one width (``_append_uniform``); an update sends its four
arrays in one host-to-device copy. ``compute`` concatenates them on the
device, trims the padding back to the longest attended sequence (one host
read) and runs the functional pipeline there.
"""
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text.bert import _tokenize, bert_score
from metrics_tpu_torch.functional.text.helper import _host_to_device

Tensor = torch.Tensor

_STATES = ("preds_input_ids", "preds_attention_mask", "target_input_ids", "target_attention_mask")


class BERTScore(Metric):
    """Accumulating BERTScore (precision/recall/f1 per sentence pair).

    Requires either a ``model`` (the port's BERT, a ``transformers`` torch
    model or a callable ``(input_ids, attention_mask) -> [batch, seq, dim]``)
    plus ``user_tokenizer``, or a LOCAL ``model_name_or_path`` checkpoint.
    The model must be on the metric's device.
    """

    is_differentiable = False
    higher_is_better = True
    __jit_unsafe__ = True  # update consumes Python strings

    def __init__(
        self,
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
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.model_name_or_path = model_name_or_path
        self.num_layers = num_layers
        self.all_layers = all_layers
        self.model = model
        self.user_forward_fn = user_forward_fn
        self.idf = idf
        self.max_length = max_length
        self.batch_size = batch_size
        self.return_hash = return_hash
        self.lang = lang
        self.rescale_with_baseline = rescale_with_baseline
        self.baseline_path = baseline_path

        if user_tokenizer is not None:
            self.tokenizer = user_tokenizer
            self.user_tokenizer = True
        else:
            if model_name_or_path is None:
                raise ValueError(
                    "`BERTScore` needs either `user_tokenizer` (+ `model`) or a LOCAL"
                    " `model_name_or_path` checkpoint — this environment cannot download"
                    " the default model."
                )
            from transformers import AutoModel, AutoTokenizer

            self.tokenizer = AutoTokenizer.from_pretrained(model_name_or_path)
            self.user_tokenizer = False
            if self.model is None:
                # load once; _compute would otherwise re-read the checkpoint per call
                self.model = AutoModel.from_pretrained(model_name_or_path).eval().to(self.device)
            if num_layers is not None and hasattr(self.model, "config") and (
                num_layers > self.model.config.num_hidden_layers
            ):
                raise ValueError(
                    f"num_layers={num_layers} is forbidden for {model_name_or_path}."
                    f" Please use num_layers <= {self.model.config.num_hidden_layers}"
                )

        for name in _STATES:
            self.add_state(name, [], dist_reduce_fx="cat")

    def _update(self, preds: List[str], target: List[str]) -> None:
        if isinstance(preds, str):
            preds = [preds]
        elif not isinstance(preds, list):
            preds = list(preds)
        if isinstance(target, str):
            target = [target]
        elif not isinstance(target, list):
            target = list(target)
        # truncation=False at update time, as in the JAX package
        preds_tok = _tokenize(preds, self.tokenizer, self.max_length, self.user_tokenizer, truncation=False)
        target_tok = _tokenize(target, self.tokenizer, self.max_length, self.user_tokenizer, truncation=False)
        toks = [preds_tok["input_ids"], preds_tok["attention_mask"], target_tok["input_ids"], target_tok["attention_mask"]]
        padded = [self._uniform(getattr(self, name), np.asarray(tok)) for name, tok in zip(_STATES, toks)]
        if len({p.shape for p in padded}) == 1:  # the usual case: one copy
            chunks = list(_host_to_device(np.stack(padded).astype(np.int32), self.device).unbind())
        else:
            chunks = [_host_to_device(p.astype(np.int32), self.device) for p in padded]
        for name, chunk in zip(_STATES, chunks):
            getattr(self, name).append(chunk)

    def _uniform(self, state: List[Tensor], tok: np.ndarray) -> np.ndarray:
        """``tok`` padded to the width that ALL chunks of ``state`` then
        share, so the "cat" list states concatenate across updates on a
        rank. truncation=False can exceed max_length, in which case the
        narrower chunks already stored are re-padded (on the device) to the
        new width. Cross-rank sync additionally requires all ranks to agree
        on the width, as in the JAX package."""
        width = max(self.max_length, tok.shape[1], *(int(c.shape[1]) for c in state))
        if tok.shape[1] < width:
            tok = np.pad(tok, ((0, 0), (0, width - tok.shape[1])))
        for i, chunk in enumerate(state):
            if chunk.shape[1] < width:
                state[i] = F.pad(chunk, (0, width - chunk.shape[1]))
        return tok

    @staticmethod
    def _pad_cat(chunks: List[Tensor]) -> Tensor:
        """Concatenate [N_i, S_i] chunks along N (chunks may still be ragged
        when truncation=False produced sequences beyond max_length)."""
        max_len = max(int(c.shape[1]) for c in chunks)
        return torch.cat([F.pad(c, (0, max_len - c.shape[1])) for c in chunks])

    def _compute(self) -> Dict[str, Union[List[float], str]]:
        toks = {name: self._pad_cat(getattr(self, name)) for name in _STATES}
        # trim the uniform max_length padding back to the longest attended
        # sequence of each corpus (both widths in one host read)
        widths = torch.stack(
            [toks["preds_attention_mask"].sum(1).max(), toks["target_attention_mask"].sum(1).max()]
        ).tolist()
        preds = {k: toks[f"preds_{k}"][:, : max(widths[0], 1)] for k in ("input_ids", "attention_mask")}
        target = {k: toks[f"target_{k}"][:, : max(widths[1], 1)] for k in ("input_ids", "attention_mask")}
        return bert_score(
            preds,
            target,
            model_name_or_path=self.model_name_or_path,
            num_layers=self.num_layers,
            all_layers=self.all_layers,
            model=self.model,
            user_forward_fn=self.user_forward_fn,
            idf=self.idf,
            max_length=self.max_length,
            batch_size=self.batch_size,
            return_hash=self.return_hash,
            lang=self.lang,
            rescale_with_baseline=self.rescale_with_baseline,
            baseline_path=self.baseline_path,
            device=self.device,
        )
