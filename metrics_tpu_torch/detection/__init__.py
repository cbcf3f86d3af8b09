"""Detection metrics."""
from metrics_tpu_torch.detection.mean_ap import MeanAveragePrecision  # noqa: F401

__all__ = ["MeanAveragePrecision"]
