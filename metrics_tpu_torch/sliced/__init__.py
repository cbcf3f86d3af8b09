"""Sliced metric state: one metric tracked across many slices (tenants,
cohorts, model versions) with a leading ``[S]`` axis on every state leaf.

Counterpart of ``metrics_tpu/sliced/``. :class:`SlicedMetric` gives any
sliceable metric a leading slice dimension on every state leaf: one state,
one segment reduction per leaf and batch (the port's kernels on the card),
one vmapped compute; per-tenant metrics at 10^5-10^6 slices, with the slice
axis sharded across a ``torch.distributed`` process group by the partition
rules of :mod:`metrics_tpu_torch.sliced.sharding`.
"""
from metrics_tpu_torch.sliced.metric import SLICE_ROWS, SLICED_FOOTPRINT_PREFIX, SlicedMetric  # noqa: F401
from metrics_tpu_torch.sliced.sharding import (  # noqa: F401
    get_naive_slice_sharding,
    match_partition_rules,
    shard_sliced_states,
    slice_partition_rules,
    sliced_partition_specs,
)

__all__ = [
    "SLICED_FOOTPRINT_PREFIX",
    "SLICE_ROWS",
    "SlicedMetric",
    "get_naive_slice_sharding",
    "match_partition_rules",
    "shard_sliced_states",
    "slice_partition_rules",
    "sliced_partition_specs",
]
