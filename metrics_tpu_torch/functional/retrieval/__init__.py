"""Functional retrieval metrics: the single-query functions (the padded
batched kernels are in :mod:`metrics_tpu_torch.functional.retrieval.padded`)."""
from metrics_tpu_torch.functional.retrieval.average_precision import retrieval_average_precision  # noqa: F401
from metrics_tpu_torch.functional.retrieval.fall_out import retrieval_fall_out  # noqa: F401
from metrics_tpu_torch.functional.retrieval.hit_rate import retrieval_hit_rate  # noqa: F401
from metrics_tpu_torch.functional.retrieval.ndcg import retrieval_normalized_dcg  # noqa: F401
from metrics_tpu_torch.functional.retrieval.precision import retrieval_precision  # noqa: F401
from metrics_tpu_torch.functional.retrieval.r_precision import retrieval_r_precision  # noqa: F401
from metrics_tpu_torch.functional.retrieval.recall import retrieval_recall  # noqa: F401
from metrics_tpu_torch.functional.retrieval.reciprocal_rank import retrieval_reciprocal_rank  # noqa: F401
