"""Windowed metric state: sliding-window (ring) and exponential-decay
semantics for a metric whose leaves are sum, max or min states.

Counterpart of ``metrics_tpu/windowed/``. :class:`WindowedMetric` turns an
all-of-time metric into a live one; ``WindowedMetric(SlicedMetric(...))``
is the per-tenant live view.
"""
from metrics_tpu_torch.windowed.metric import DECAY_WEIGHT, RING_COUNT, RING_ROWS, WindowedMetric  # noqa: F401
from metrics_tpu_torch.windowed.reducers import decay_sum_fx, ring_merge_fx, ring_sum_fx  # noqa: F401

__all__ = ["DECAY_WEIGHT", "RING_COUNT", "RING_ROWS", "WindowedMetric", "decay_sum_fx", "ring_merge_fx", "ring_sum_fx"]
