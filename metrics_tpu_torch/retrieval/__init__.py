"""Retrieval metrics over ``(indexes, preds, target)`` triples, with the
fixed-capacity per-query table as their default state."""
from metrics_tpu_torch.retrieval.base import RetrievalMetric  # noqa: F401
from metrics_tpu_torch.retrieval.table import (  # noqa: F401
    retrieval_table_fill,
    retrieval_table_init,
    retrieval_table_insert,
    retrieval_table_layout,
    retrieval_table_layout_rows,
    retrieval_table_merge,
    retrieval_table_merge_fx,
)
from metrics_tpu_torch.retrieval.average_precision import RetrievalMAP  # noqa: F401
from metrics_tpu_torch.retrieval.fall_out import RetrievalFallOut  # noqa: F401
from metrics_tpu_torch.retrieval.hit_rate import RetrievalHitRate  # noqa: F401
from metrics_tpu_torch.retrieval.ndcg import RetrievalNormalizedDCG  # noqa: F401
from metrics_tpu_torch.retrieval.precision import RetrievalPrecision  # noqa: F401
from metrics_tpu_torch.retrieval.r_precision import RetrievalRPrecision  # noqa: F401
from metrics_tpu_torch.retrieval.recall import RetrievalRecall  # noqa: F401
from metrics_tpu_torch.retrieval.reciprocal_rank import RetrievalMRR  # noqa: F401
