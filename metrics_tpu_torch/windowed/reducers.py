"""Tagged reducers for windowed metric state.

Counterpart of ``metrics_tpu/windowed/reducers.py``. A windowed ring row
or decayed sum adds elementwise across processes and in ``merge_states``,
like a ``"sum"`` state, but it is tagged apart from ``dim_zero_sum``: the
window applies its own semantics (a ring slot, a decay factor), and a
consumer must be able to tell such a leaf from a plain sum. Each reducer
carries:

* ``windowed_kind`` -- ``"ring"`` or ``"decay"``;
* ``inner_reduce`` -- ``"sum"``, the fold that ``merge_states`` applies.

A ring of sketch leaves (``[R, capacity, cols]``) takes
:func:`ring_merge_fx`: tagged ``merge_like``, it merges slot ``i`` of one
ring with slot ``i`` of the other through the wrapped metric's own sketch
merge, never across buckets. All reducers pickle through their
constructors.
"""
from typing import Any

import torch

__all__ = ["decay_sum_fx", "ring_merge_fx", "ring_sum_fx"]


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


class _RingMergeReduce:
    """Cross-process fold of a ring of sketches ``[R, capacity, cols]``:
    the stacked rings ``[world, R, capacity, cols]`` fold pairwise in
    process order, slot by slot, with the wrapped metric's own merge
    reducer (``inner``). Inside each sketch's lossless window the fold is
    the concatenation per slot in process order."""

    merge_like = True
    windowed_kind = "ring"
    __name__ = "ring_merge"

    def __init__(self, inner: Any) -> None:
        self._inner = inner
        self.sketch_kind = getattr(inner, "sketch_kind", "quantile")

    def __call__(self, stacked: torch.Tensor) -> torch.Tensor:
        if stacked.ndim == 3:  # a single process passes through
            return stacked
        out = stacked[0]
        for i in range(1, stacked.shape[0]):
            out = torch.stack([self._inner(torch.stack([a, b])) for a, b in zip(out, stacked[i])])
        return out

    def __reduce__(self):
        return (ring_merge_fx, (self._inner,))


def ring_merge_fx(inner: Any) -> _RingMergeReduce:
    """The ring-axis form of a ``merge_like`` reducer (the wrapped metric's
    own sketch merge), see :class:`_RingMergeReduce`."""
    return _RingMergeReduce(inner)
