"""RetrievalMAP.

Counterpart of ``metrics_tpu/retrieval/average_precision.py``.
"""
import torch

from metrics_tpu_torch.functional.retrieval.average_precision import retrieval_average_precision
from metrics_tpu_torch.functional.retrieval.padded import average_precision_row
from metrics_tpu_torch.retrieval.base import RetrievalMetric

Tensor = torch.Tensor


class RetrievalMAP(RetrievalMetric):
    """Mean average precision over queries.

    The default state is the fixed-capacity per-query table (``max_queries``
    / ``max_docs`` size it); ``exact=True`` keeps the unbounded
    list states of the reference.

    Example:
        >>> import torch
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> rmap = RetrievalMAP(device="cpu")
        >>> rmap(preds, target, indexes=indexes)
        tensor(0.7917)
    """

    _padded_metric = staticmethod(average_precision_row)

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return retrieval_average_precision(preds, target)
