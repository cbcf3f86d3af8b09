"""RetrievalRecall.

Counterpart of ``metrics_tpu/retrieval/recall.py``.
"""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.retrieval.recall import retrieval_recall
from metrics_tpu_torch.functional.retrieval.padded import recall_row
from metrics_tpu_torch.retrieval.base import RetrievalMetric
from metrics_tpu_torch.utils.checks import _check_retrieval_k

Tensor = torch.Tensor


class RetrievalRecall(RetrievalMetric):
    """Mean recall@k over queries.

    The default state is the fixed-capacity per-query table (``max_queries``
    / ``max_docs`` size it); ``exact=True`` keeps the unbounded
    list states of the reference.
    """

    _padded_metric = staticmethod(recall_row)

    @property
    def _padded_k(self) -> Optional[int]:
        return self.k

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        k: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        _check_retrieval_k(k)
        self.k = k

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return retrieval_recall(preds, target, k=self.k)
