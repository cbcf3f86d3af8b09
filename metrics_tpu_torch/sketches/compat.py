"""Exact-mode helpers for metrics whose default state is a sketch.

Counterpart of ``metrics_tpu/sketches/compat.py``. A metric converted to a
fixed-capacity sketch keeps the reference's unbounded list states behind
``exact=True``; these two functions register those states and give the
reference's large-memory warning.
"""
from typing import Any, Optional, Sequence

from metrics_tpu_torch.utils.prints import rank_zero_warn


def register_exact_list_states(metric: Any, names: Sequence[str], dist_reduce_fx: Optional[str] = "cat") -> None:
    """Register the exact mode's unbounded list states on ``metric`` and
    mark the instance ``__jit_unsafe__`` (list growth keeps it on the fused
    update's eager leg whatever its class declares)."""
    for name in names:
        metric.add_state(name, default=[], dist_reduce_fx=dist_reduce_fx)
    metric.__dict__["__jit_unsafe__"] = True


def warn_exact_buffer(cls_name: str, what: str = "targets and predictions") -> None:
    """The reference's large-memory-footprint warning, given by ``exact=True`` instances only."""
    rank_zero_warn(
        f"Metric `{cls_name}` with `exact=True` will save all {what} in buffer."
        " For large datasets this may lead to large memory footprint."
    )
