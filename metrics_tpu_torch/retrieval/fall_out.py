"""RetrievalFallOut.

Counterpart of ``metrics_tpu/retrieval/fall_out.py``: the empty-query
handling is inverted (queries with no *negative* target).
"""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.retrieval.fall_out import retrieval_fall_out
from metrics_tpu_torch.functional.retrieval.padded import fall_out_row
from metrics_tpu_torch.retrieval.base import RetrievalMetric
from metrics_tpu_torch.utils.checks import _check_retrieval_k

Tensor = torch.Tensor


class RetrievalFallOut(RetrievalMetric):
    """Mean fall-out@k over queries; lower is better. A query is empty when
    it has no NEGATIVE target; the table reads that from its exact
    negative-document counter.

    The default state is the fixed-capacity per-query table (``max_queries``
    / ``max_docs`` size it); ``exact=True`` keeps the unbounded
    list states of the reference.
    """

    _padded_metric = staticmethod(fall_out_row)
    higher_is_better = False

    @property
    def _padded_k(self) -> Optional[int]:
        return self.k

    def __init__(
        self,
        empty_target_action: str = "pos",
        ignore_index: Optional[int] = None,
        k: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        _check_retrieval_k(k)
        self.k = k

    def _empty_rows(self, padded_target: Tensor, mask: Tensor) -> Tensor:
        return ((1.0 - padded_target) * mask).sum(-1) == 0

    def _table_empty_rows(self, pos_mass: Tensor, neg_count: Tensor) -> Tensor:
        return neg_count <= 0

    def _group_empty(self, mini_target: Tensor) -> bool:
        return not bool(torch.sum(1 - mini_target))

    def _empty_error_message(self) -> str:
        return "`compute` method was provided with a query with no negative target."

    def _metric(self, preds: Tensor, target: Tensor) -> Tensor:
        return retrieval_fall_out(preds, target, k=self.k)
