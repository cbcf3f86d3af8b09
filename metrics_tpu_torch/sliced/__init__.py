"""Sliced metric state: one metric tracked across many slices (tenants,
cohorts, model versions) with a leading ``[S]`` axis on every state leaf.

Counterpart of ``metrics_tpu/sliced/``. The partition rules of
``sliced/sharding.py`` wait for the ``torch.distributed`` slice (ROADMAP.md,
queue A).
"""
from metrics_tpu_torch.sliced.metric import SLICE_ROWS, SlicedMetric  # noqa: F401

__all__ = ["SLICE_ROWS", "SlicedMetric"]
