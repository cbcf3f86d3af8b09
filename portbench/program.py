"""The one place the benchmark reaches into the program under test: it
builds a ``metrics_tpu_torch.MetricCollection`` from a configuration's
``collection`` entry (``{key: [class name, keyword arguments]}``, the
classes of ``metrics_tpu_torch.classification``)."""
from typing import Any, Dict

import torch


def build_collection(spec: Dict[str, Any], device: torch.device) -> Any:
    from metrics_tpu_torch import MetricCollection
    from metrics_tpu_torch import classification

    metrics = {key: getattr(classification, cls)(device=device, **kwargs) for key, (cls, kwargs) in spec.items()}
    return MetricCollection(metrics)


def rank_bounds(rows: int, rank: int, world: int) -> range:
    """The rows of a pass that ``rank`` of ``world`` evaluates: contiguous
    shares, the first ``rows % world`` one row longer."""
    base, extra = divmod(rows, world)
    lo = rank * base + min(rank, extra)
    return range(lo, lo + base + (1 if rank < extra else 0))
