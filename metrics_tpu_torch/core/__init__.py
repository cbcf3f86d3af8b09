from metrics_tpu_torch.core.metric import CompositionalMetric, Metric  # noqa: F401
