"""RetrievalMRR.

Counterpart of ``metrics_tpu/retrieval/reciprocal_rank.py``.
"""
import torch

from metrics_tpu_torch.functional.retrieval.reciprocal_rank import retrieval_reciprocal_rank
from metrics_tpu_torch.functional.retrieval.padded import reciprocal_rank_row
from metrics_tpu_torch.retrieval.base import RetrievalMetric

Tensor = torch.Tensor


class RetrievalMRR(RetrievalMetric):
    """Mean reciprocal rank over queries.

    The default state is the fixed-capacity per-query table (``max_queries``
    / ``max_docs`` size it); ``exact=True`` keeps the unbounded
    list states of the reference.

    Example:
        >>> import torch
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> mrr = RetrievalMRR(device="cpu")
        >>> mrr(preds, target, indexes=indexes)
        tensor(0.7500)
    """

    _padded_metric = staticmethod(reciprocal_rank_row)

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return retrieval_reciprocal_rank(preds, target)
