from metrics_tpu_torch.core.metric import Metric  # noqa: F401
