"""Tagged reducers for windowed metric state.

Counterpart of ``metrics_tpu/windowed/reducers.py``. A windowed ring row
or decayed sum adds elementwise across processes and in ``merge_states``,
like a ``"sum"`` state, but it is tagged apart from ``dim_zero_sum``: the
window applies its own semantics (a ring slot, a decay factor), and a
consumer must be able to tell such a leaf from a plain sum. Each reducer
carries:

* ``windowed_kind`` -- ``"ring"`` or ``"decay"``;
* ``inner_reduce`` -- ``"sum"``, the fold that ``merge_states`` applies.

The ring of sketches (``ring_merge_fx`` in the JAX package) is not ported
yet (ROADMAP.md, queue A). Both reducers are module-level singletons that
pickle through their constructors.
"""
import torch

__all__ = ["decay_sum_fx", "ring_sum_fx"]


class _WindowedSumReduce:
    """Cross-process fold of a windowed sum leaf: the elementwise sum of the
    stacked per-process leaves (ring rows align on the bucket index of
    lock-stepped processes; decayed sums of synchronised streams add)."""

    inner_reduce = "sum"

    def __init__(self, kind: str) -> None:
        self.windowed_kind = kind
        self.__name__ = f"{kind}_sum"

    def __call__(self, stacked: torch.Tensor) -> torch.Tensor:
        stacked = torch.as_tensor(stacked)
        return torch.sum(stacked, dim=0, dtype=stacked.dtype)

    def __reduce__(self):
        return (ring_sum_fx if self.windowed_kind == "ring" else decay_sum_fx, ())


_RING_SUM = _WindowedSumReduce("ring")
_DECAY_SUM = _WindowedSumReduce("decay")


def ring_sum_fx() -> _WindowedSumReduce:
    """The ring-of-sums ``dist_reduce_fx`` (``add_state`` maps ``"ring"`` here)."""
    return _RING_SUM


def decay_sum_fx() -> _WindowedSumReduce:
    """The decayed-sum ``dist_reduce_fx`` (``add_state`` maps ``"decay"`` here)."""
    return _DECAY_SUM
