from metrics_tpu_torch.core.fused import FUSED_ENTRY, FusedUpdate  # noqa: F401
from metrics_tpu_torch.core.metric import CompositionalMetric, Metric  # noqa: F401
from metrics_tpu_torch.core.pipeline import (  # noqa: F401
    AsyncQueueFull,
    AsyncUpdateHandle,
    AsyncWorkerError,
)

__all__ = [
    "AsyncQueueFull",
    "AsyncUpdateHandle",
    "AsyncWorkerError",
    "CompositionalMetric",
    "FUSED_ENTRY",
    "FusedUpdate",
    "Metric",
]
