"""Inception Score.

Counterpart of ``metrics_tpu/image/inception.py``. By default the metric
streams exact per-split sufficient statistics: softmax-probability sums
``[splits, C]``, per-sample ``sum_c p log p`` sums ``[splits]`` and per-split
counts, since each split's KL term depends on its samples only through
them:

    ``kl_k = plogp_sum_k / n_k - sum_c m_c log m_c``,  ``m = prob_sum_k / n_k``

Samples land in splits round-robin by arrival index (deterministic, the
same whatever the batching); pad rows of a bucketed fused update (masked
by ``n_valid``) neither land anywhere nor move the cursor. ``exact=True``
keeps the logits list and the reference's seeded shuffle and
``array_split``. The split sums are products with a one-hot matrix, taken
in float64 and rounded once to float32.
"""
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.pairwise.helpers import _matmul_t
from metrics_tpu_torch.image.fid import _ExtractorMixin
from metrics_tpu_torch.models.inception import build_fid_inception
from metrics_tpu_torch.sketches.compat import register_exact_list_states, warn_exact_buffer
from metrics_tpu_torch.sketches.moments import moments_merge_fx
from metrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class InceptionScore(_ExtractorMixin, Metric):
    """Computes the Inception Score (mean and std over splits).

    Args:
        feature: 'logits_unbiased' / int depth for the bundled InceptionV3,
            or any callable ``imgs -> [N, num_classes]``.
        splits: number of KL splits (reference default 10).
        seed: host RNG seed for the ``exact=True`` shuffle (unused by the
            streaming default, whose round-robin assignment is
            deterministic).
        num_classes: logits width ``C`` for callable extractors (ignored
            otherwise; 'logits_unbiased' emits 1008, an int depth emits
            itself); default 1008.
        exact: keep the logits and the reference's shuffle-then-split.
    """

    __exact_mode_attr__ = "_exact"
    #: ``self.inception(imgs)`` is a fixed-shape tensor program (the static
    #: analysis models it as a torch op; a user extractor that is not is
    #: caught by the fused update's stale-manifest retry)
    __traced_callable_attrs__ = ("inception",)
    __fused_mask_valid__ = True
    is_differentiable = False
    higher_is_better = True

    def __init__(
        self,
        feature: Union[str, int, Callable] = "logits_unbiased",
        splits: int = 10,
        seed: Optional[int] = None,
        feature_extractor_weights_path: Optional[str] = None,
        num_classes: Optional[int] = None,
        exact: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)

        if isinstance(feature, (str, int)):
            valid_int_input = ("logits_unbiased", 64, 192, 768, 2048)
            if feature not in valid_int_input:
                raise ValueError(
                    f"Integer input to argument `feature` must be one of {valid_int_input}, but got {feature}."
                )
            self.inception = build_fid_inception(feature, feature_extractor_weights_path, self.device)
            num_classes = 1008 if feature == "logits_unbiased" else feature
        elif callable(feature):
            self.inception = feature
            num_classes = 1008 if num_classes is None else num_classes
        else:
            raise TypeError("Got unknown input to argument `feature`")
        if not (isinstance(num_classes, int) and num_classes > 0):
            raise ValueError(f"Argument `num_classes` expected to be a positive int, got {num_classes}")
        self._num_classes = num_classes

        if not (isinstance(splits, int) and splits > 0):
            raise ValueError(f"Argument `splits` expected to be a positive int, got {splits}")
        self.splits = splits
        self._rng = np.random.RandomState(seed)

        self._exact = bool(exact)
        if self._exact:
            register_exact_list_states(self, ("features",), dist_reduce_fx=None)
            warn_exact_buffer("InceptionScore", "extracted features")
        else:
            self.add_state("prob_sum", default=torch.zeros((splits, num_classes)), dist_reduce_fx=moments_merge_fx())
            self.add_state("plogp_sum", default=torch.zeros((splits,)), dist_reduce_fx=moments_merge_fx())
            self.add_state("split_count", default=torch.zeros((splits,)), dist_reduce_fx=moments_merge_fx())

    def _update(self, imgs: Tensor, n_valid: Optional[Tensor] = None) -> None:
        features = self.inception(imgs)
        if self._exact:
            self.features.append(features)
            return
        logits = torch.as_tensor(features, device=self.device).to(torch.float32)
        if logits.shape[-1] != self._num_classes:
            raise ValueError(
                f"Extractor emitted logits of width {logits.shape[-1]} but the streaming"
                f" split state was sized for num_classes={self._num_classes} — pass the"
                " extractor's true width via `num_classes` (or use `exact=True`)."
            )
        prob = torch.softmax(logits, dim=1)
        log_prob = torch.log_softmax(logits, dim=1)
        plogp = torch.sum(prob * log_prob, dim=1)  # [B]

        b = logits.shape[0]
        row = torch.arange(b, dtype=torch.int32, device=logits.device)
        valid = row < n_valid if n_valid is not None else torch.ones((b,), dtype=torch.bool, device=logits.device)
        # round-robin split assignment by global arrival index; pad rows
        # (masked by n_valid) neither land anywhere nor advance the cursor
        cursor = torch.sum(self.split_count).to(torch.int32)
        arrival = cursor + torch.cumsum(valid.to(torch.int32), dim=0) - 1
        assign = torch.where(valid, torch.remainder(arrival, self.splits), self.splits)
        onehot = (assign[:, None] == torch.arange(self.splits, device=logits.device)[None, :]).to(torch.float32)

        self.prob_sum = self.prob_sum + _matmul_t(onehot.T, prob.T)
        self.plogp_sum = self.plogp_sum + _matmul_t(onehot.T, plogp[None, :])[:, 0]
        self.split_count = self.split_count + torch.sum(onehot, dim=0)

    def _compute_exact(self) -> Tuple[Tensor, Tensor]:
        features = dim_zero_cat(self.features)
        idx = self._rng.permutation(features.shape[0])
        features = features[torch.from_numpy(idx).to(features.device)]

        prob = torch.softmax(features, dim=1)
        log_prob = torch.log_softmax(features, dim=1)

        prob_chunks = torch.tensor_split(prob, self.splits, dim=0)
        log_prob_chunks = torch.tensor_split(log_prob, self.splits, dim=0)

        kl_ = []
        for p, log_p in zip(prob_chunks, log_prob_chunks):
            m_p = torch.mean(p, dim=0, keepdim=True)
            kl = p * (log_p - torch.log(m_p))
            kl_.append(torch.exp(torch.mean(torch.sum(kl, dim=1))))
        kl = torch.stack(kl_)
        return torch.mean(kl), torch.std(kl)

    def _compute(self) -> Tuple[Tensor, Tensor]:
        getattr(self.inception, "finalize", lambda: None)()  # the last batch's range check
        if self._exact:
            return self._compute_exact()

        n = torch.clamp(self.split_count, min=1.0)  # [S]
        marginal = self.prob_sum / n[:, None]  # [S, C]
        cross = torch.sum(marginal * torch.log(torch.clamp(marginal, min=1e-38)), dim=1)
        kl = torch.exp(self.plogp_sum / n - cross)  # [S]
        return torch.mean(kl), torch.std(kl)
