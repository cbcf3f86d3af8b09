"""Retrieval normalized discounted cumulative gain.

Counterpart of ``metrics_tpu/functional/retrieval/ndcg.py`` (graded
targets allowed). The discount ``log2(position + 1)`` is correctly rounded
(:func:`metrics_tpu_torch.functional.retrieval.padded._discount`); the JAX
package's XLA ``log2`` is off by an ulp on about a quarter of the
positions, so results agree within float32 rounding.
"""
from typing import Any, Optional, Union

import torch

from metrics_tpu_torch.functional.retrieval._common import _descending, _inputs
from metrics_tpu_torch.functional.retrieval.padded import _discount
from metrics_tpu_torch.utils.checks import _check_retrieval_k

Tensor = torch.Tensor


def _dcg(target: Tensor) -> Tensor:
    return torch.sum(target / _discount(target.shape[-1], target.device), dim=-1)


def retrieval_normalized_dcg(
    preds: Any, target: Any, k: Optional[int] = None, device: Optional[Union[str, torch.device]] = None
) -> Tensor:
    """nDCG (at k) of a single query's ranking; targets may be graded.

    Example:
        >>> import torch
        >>> retrieval_normalized_dcg(torch.tensor([.1, .2, .3, 4., 70.]), torch.tensor([10, 0, 0, 1, 5]))
        tensor(0.6957)
    """
    preds, target = _inputs(preds, target, device, allow_non_binary_target=True)
    k = preds.shape[-1] if k is None else k
    _check_retrieval_k(k)
    sorted_target = target[_descending(preds)][:k]
    ideal_target = -torch.sort(-target).values[:k]
    ideal_dcg = _dcg(ideal_target)
    target_dcg = _dcg(sorted_target)
    return torch.where(ideal_dcg == 0, 0.0, target_dcg / torch.where(ideal_dcg == 0, 1.0, ideal_dcg))
