"""Cross-process state synchronisation (single-process only in this slice)
and the scalar ``reduce`` helper.

Counterpart of ``metrics_tpu/parallel/distributed.py``. With one process
the world size is 1 and syncing a state is the identity. A metric computed
inside an initialised ``torch.distributed`` group of more than one process
raises instead of returning a rank-local value: the ``torch.distributed``
sync is its own item of the port (ROADMAP.md, queue A).
"""
from typing import Any, Optional

import torch

_NOT_PORTED = (
    "cross-process metric sync is not ported yet (ROADMAP.md, queue A:"
    " 'torch.distributed sync'); this slice runs in one process"
)


def distributed_available() -> bool:
    """True when an initialised ``torch.distributed`` group has more than one process."""
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def world_size(group: Optional[Any] = None) -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return 1


def process_index() -> int:
    """This process's ``torch.distributed`` rank, 0 when no group is initialised."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def check_single_process() -> None:
    """Raise where a sync would be needed: more than one process."""
    if distributed_available():
        raise NotImplementedError(_NOT_PORTED)


def reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    """Reduce a tensor: ``"elementwise_mean"`` | ``"sum"`` | ``"none"`` (or ``None``)."""
    if reduction == "elementwise_mean":
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    if reduction in ("none", None):
        return x
    raise ValueError("Reduction parameter unknown.")
