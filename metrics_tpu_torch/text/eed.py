"""Modular ExtendedEditDistance.

Counterpart of ``metrics_tpu/text/eed.py``: the sentence scores are a list
state (gathered across processes) that grows one chunk per update, one
host-to-device copy each. ``compute`` reads them in one copy and averages
them on the host in float32: the sum in sentence order (``np.cumsum``)
times ``float32(1 / n)``, which is what XLA's CPU ``jnp.mean`` computes for
up to 32 sentences (it turns the division into that product). On a longer
corpus XLA adds in another order, and the two means differ by float32
rounding of the sum; the card and the CPU give the same bits.
"""
from typing import Any, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text.eed import _eed_update
from metrics_tpu_torch.functional.text.helper import _float32_sums
from metrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class ExtendedEditDistance(Metric):
    """Corpus Extended Edit Distance (average of sentence-level scores).

    Example:
        >>> preds = ["this is the prediction", "here is an other sample"]
        >>> target = ["this is the reference", "here is another one"]
        >>> metric = ExtendedEditDistance(device="cpu")
        >>> metric(preds, target)
        tensor(0.3078)
    """

    is_differentiable = False
    higher_is_better = False
    __jit_unsafe__ = True  # update consumes Python strings

    def __init__(
        self,
        language: str = "en",
        return_sentence_level_score: bool = False,
        alpha: float = 2.0,
        rho: float = 0.3,
        deletion: float = 0.2,
        insertion: float = 1.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if language not in ("en", "ja"):
            raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
        self.language = language
        self.return_sentence_level_score = return_sentence_level_score
        for param_name, param in zip(["alpha", "rho", "deletion", "insertion"], [alpha, rho, deletion, insertion]):
            if not isinstance(param, float) or param < 0:
                raise ValueError(f"Parameter `{param_name}` is expected to be a non-negative float.")
        self.alpha = alpha
        self.rho = rho
        self.deletion = deletion
        self.insertion = insertion

        self.add_state("sentence_eed", [], dist_reduce_fx="cat")

    def _update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        scores = _eed_update(preds, target, self.language, self.alpha, self.rho, self.deletion, self.insertion)
        if scores:
            self.sentence_eed.append(_float32_sums(scores, self.device))

    def _compute(self) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        if not self.sentence_eed:
            average = torch.zeros((), dtype=torch.float32, device=self.device)
            scores = torch.zeros((0,), dtype=torch.float32, device=self.device)
        else:
            scores = dim_zero_cat(self.sentence_eed)
            host = scores.cpu().numpy()
            mean = np.cumsum(host, dtype=np.float32)[-1] * np.float32(1.0 / host.size)
            average = torch.full((), float(mean), dtype=torch.float32, device=self.device)
        if self.return_sentence_level_score:
            return average, scores
        return average
