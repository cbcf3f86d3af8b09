"""The port's observability plane: so far only the freshness stamps
(:mod:`metrics_tpu_torch.observability.freshness`)."""
from metrics_tpu_torch.observability.freshness import IDENTITY, FreshnessStamp, merge_stamps  # noqa: F401
