"""RetrievalRPrecision.

Counterpart of ``metrics_tpu/retrieval/r_precision.py``.
"""
import torch

from metrics_tpu_torch.functional.retrieval.r_precision import retrieval_r_precision
from metrics_tpu_torch.functional.retrieval.padded import r_precision_row
from metrics_tpu_torch.retrieval.base import RetrievalMetric

Tensor = torch.Tensor


class RetrievalRPrecision(RetrievalMetric):
    """Mean R-precision over queries.

    The default state is the fixed-capacity per-query table (``max_queries``
    / ``max_docs`` size it); ``exact=True`` keeps the unbounded
    list states of the reference.

    """

    _padded_metric = staticmethod(r_precision_row)

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return retrieval_r_precision(preds, target)
