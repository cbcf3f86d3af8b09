"""The ``Metric`` base class and the operator algebra.

Counterpart of ``metrics_tpu/core/metric.py``: the state registry
(``add_state``), the child-metric registry of wrappers and compositions
(``_children``: an attribute holding a ``Metric``, or a non-empty list of
them, registers as a child), the ``update``/``compute`` lifecycle with the
write-epoch compute cache, the double-update ``forward`` (which snapshots
and restores the children's states too), ``reset``, the pure-state API
(``init_state`` / ``update_state`` / ``compute_state`` / ``merge_states``),
``state_dict`` / ``load_state_dict`` (children under ``name.`` and
``name.i.`` prefixes), the state memory accounting (``state_footprint``,
``total_state_bytes``, ``theoretical_state_bytes``,
``sketch_fill_ratios``) and :class:`CompositionalMetric`, which the 33
operator overloads build.

States are tensors on the metric's device (or lists of tensors), held as
plain attributes. Every update replaces a state with a new tensor and never
writes into the old one, so the pure-state API stays functional: a state
dict handed to ``update_state`` is never modified. The one exception is a
donating fused update, whose replays overwrite its static buffers in place:
``compute`` then copies every result that shares storage with a state.

Sketch states (``dist_reduce_fx="merge"`` or a ``merge_like`` reducer:
:func:`~metrics_tpu_torch.sketches.sketch_merge_fx`,
:func:`~metrics_tpu_torch.sketches.reservoir_merge_fx` or
:func:`~metrics_tpu_torch.sketches.moments_merge_fx`) merge through their
own reducer; windowed ring and decay states (``"ring"``/``"decay"``) add
like sums. Max and min states fold with the JAX package's semantics (NaN
wins, +0.0 over -0.0 for max): :func:`~metrics_tpu_torch.utils.data.maximum_ieee`.
``clone``, ``persistent``, ``to_device``, ``state_reductions``, ``dtype`` and
``set_dtype`` are the JAX package's, and each recurses into the children; a
fused update (``core/fused.py``) installs its states through
``_mark_fused_written``.

**Cross-process sync** is the JAX package's state machine on
``torch.distributed`` (``parallel/distributed.py``): ``compute`` runs inside
``sync_context``, which gathers every state from every rank, folds it by its
reducer, computes and puts the local states back. ``sync`` installs new
tensors and never writes into a state, so a donating fused update's static
buffers are left as they are, and ``unsync`` puts the very same objects
back. ``update`` and ``forward`` raise while synced. A ``dist_sync_fn``
(``fn(x, group=...) -> [one tensor per rank]``) replaces the gather, which
is how a simulated world drives it. In a real group every rank must compute
in step: each sync is a series of collectives that every rank enters in
the same order. Not in this slice: the observability hooks (see
``ROADMAP.md``).

A metric defines ``__eq__`` (it builds a composition), so code that
compares metrics compares them by identity (``is``), never with ``==``,
``in`` or ``list.index``; and ``__getitem__`` (a composition too), so a
metric is never iterated: ``iter(metric)`` raises ``TypeError``.
"""
from abc import ABC, abstractmethod
from contextlib import contextmanager
from copy import deepcopy
import inspect
import operator
from typing import Any, Callable, Dict, Generator, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from metrics_tpu_torch.parallel.distributed import distributed_available as _dist_available
from metrics_tpu_torch.parallel.distributed import gather_all_arrays
from metrics_tpu_torch.sketches.quantile import (
    _FILL_BOUND,
    fill_bound,
    sketch_merge_fx,
    stack_with_fill_bounds,
    with_fill_bound,
)
from metrics_tpu_torch.utils.data import (
    _as_tensor,
    _resolve_device,
    _squeeze_if_scalar,
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
    maximum_ieee,
    minimum_ieee,
)
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor
StateValue = Union[Tensor, List[Tensor]]

#: auto-registered update counter accompanying any mean-reduced state: the
#: default weights of `merge_states` on uneven accumulations; negative means
#: "history unknown" (a checkpoint restored without it)
_AUTO_COUNT = "_n_updates"

#: key prefix of sketch leaves (merge-like reducers) in ``state_footprint``:
#: their bytes are a fixed budget, not a growing accumulation
SKETCH_FOOTPRINT_PREFIX = "sketch/"

_REDUCERS = {
    "sum": dim_zero_sum,
    "mean": dim_zero_mean,
    "max": dim_zero_max,
    "min": dim_zero_min,
    "cat": dim_zero_cat,
}


def _sentinel_count_sum(x: Tensor) -> Tensor:
    """Dim-zero sum of per-rank `_n_updates` counters that propagates the
    negative "history unknown" sentinel instead of summing past it."""
    return torch.where((x >= 0).all(), x.sum(dim=0, dtype=x.dtype), torch.full_like(x[0], -1))


def _clone_state(value: Tensor, device: Optional[torch.device] = None) -> Tensor:
    """A copy of a state tensor (on ``device`` if given) with the host-side
    facts attached to it (such as a sketch's occupancy bound): the content
    is the same, so they still hold."""
    out = (value if device is None else value.detach().to(device)).clone()
    out.__dict__.update(value.__dict__)
    return out


def _cast_state(value: Any, dtype: torch.dtype) -> Any:
    """``value`` cast to ``dtype`` if it is a floating tensor, else as it
    is. Host-side facts ride along (a sketch's occupancy bound stays an
    upper bound: a cast can empty a slot, never fill one)."""
    if not isinstance(value, Tensor) or not value.is_floating_point() or value.dtype == dtype:
        return value
    out = value.to(dtype)
    out.__dict__.update(value.__dict__)
    return out


def _state_tensor(value: Any, device: torch.device) -> Tensor:
    """A state default as a tensor on ``device``, with the JAX package's
    x64-off dtypes for host values (Python/numpy ints become int32, floats
    float32)."""
    if isinstance(value, Tensor):
        return _clone_state(value, device)
    arr = np.asarray(value)
    if arr.dtype == np.int64:
        arr = arr.astype(np.int32)
    elif arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    if arr.dtype == object:
        raise ValueError("not an array")
    return torch.as_tensor(arr, device=device)


def _to_device_inputs(obj: Any, device: torch.device) -> Any:
    """Host arrays (numpy) in update inputs go to the metric's device;
    tensors stay where they are and everything else passes through."""
    if isinstance(obj, (np.ndarray, np.generic)):
        return _as_tensor(obj, device)
    if isinstance(obj, tuple):
        return tuple(_to_device_inputs(o, device) for o in obj)
    if isinstance(obj, list):
        return [_to_device_inputs(o, device) for o in obj]
    if isinstance(obj, dict):
        return {k: _to_device_inputs(v, device) for k, v in obj.items()}
    return obj


class Metric(ABC):
    """Base class for all metrics of the port.

    Subclasses implement ``_update(self, ...)`` (reading and assigning the
    registered states) and ``_compute(self)``. ``device=None`` means the
    card; without CUDA that raises, so CPU use is asked for explicitly with
    ``device="cpu"``. The sync arguments are the JAX package's:
    ``dist_sync_on_step`` (``forward``'s batch value is synced too),
    ``process_group`` (the ``torch.distributed`` group to sync over, the
    default group when None), ``dist_sync_fn`` (replaces the gather) and the
    deprecated ``compute_on_step``, which has no effect.
    """

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    #: True on metrics whose update cannot run inside a fused (captured)
    #: update; they take the fused update's eager leg
    __jit_unsafe__: bool = False
    #: host-side attributes that the states need to be read (such as the
    #: input mode a first update fixed); carried with the states by
    #: :func:`metrics_tpu_torch.convert.state_from_jax`
    _host_state: Tuple[str, ...] = ()

    def __init__(
        self,
        device: Optional[Union[str, torch.device]] = None,
        *,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        compute_on_step: Optional[bool] = None,
    ) -> None:
        # first: every later attribute that holds a metric registers here
        self._children: Dict[str, Union["Metric", List["Metric"]]] = {}
        self._device = _resolve_device(device)
        self._dtype = torch.float32
        if compute_on_step is not None:
            rank_zero_warn(
                "Argument `compute_on_step` is deprecated and has no effect; `forward` always"
                " returns the batch value.",
                DeprecationWarning,
            )
        if not isinstance(dist_sync_on_step, bool):
            raise ValueError(
                f"Expected keyword argument `dist_sync_on_step` to be an `bool` but got {dist_sync_on_step}"
            )
        if dist_sync_fn is not None and not callable(dist_sync_fn):
            raise ValueError(
                f"Expected keyword argument `dist_sync_fn` to be an callable function but got {dist_sync_fn}"
            )
        self.dist_sync_on_step = dist_sync_on_step
        self.process_group = process_group
        self.dist_sync_fn = dist_sync_fn
        # sync state machine: `forward` flips the first two for its batch
        # compute; `_cache` holds the local states while synced
        self._to_sync = True
        self._should_unsync = True
        self._is_synced = False
        self._cache: Optional[Dict[str, StateValue]] = None
        self._update_called = False
        self._forward_cache: Any = None
        self._computed: Any = None
        # write-epoch clock: bumped on every state mutation; the cached
        # `_computed` is served only while it was folded at the current epoch
        self._write_epoch: int = 0
        self._computed_epoch: int = -1
        # whether the cached value is a synced one: a local read never gets
        # a synced value, nor the reverse
        self._computed_synced = False
        # set while the states may be a donating fused update's static
        # buffers, which its next replay overwrites in place
        self._states_donated = False
        self._defaults: Dict[str, StateValue] = {}
        self._persistent: Dict[str, bool] = {}
        self._reductions: Dict[str, Optional[Callable]] = {}
        self._cat_states: Dict[str, bool] = {}

    # ------------------------------------------------------------------
    # child-metric registry (wrappers and compositions)
    # ------------------------------------------------------------------
    def __setattr__(self, name: str, value: Any) -> None:
        children = self.__dict__.get("_children")
        if children is not None and name != "_children":
            if isinstance(value, Metric):
                children[name] = value
            elif isinstance(value, list) and value and all(isinstance(v, Metric) for v in value):
                # the copies of BootStrapper and MultioutputWrapper
                children[name] = value
            elif name in children:
                del children[name]
        object.__setattr__(self, name, value)

    #: a metric is not a sequence, though ``__getitem__`` builds a
    #: composition: without this, ``iter(metric)`` would never end
    __iter__ = None

    def _iter_child_metrics(self) -> Iterator[Tuple[str, "Metric"]]:
        """``(name, metric)`` for every child; list children as ``name.i``."""
        for name, child in self._children.items():
            if isinstance(child, list):
                for i, c in enumerate(child):
                    yield f"{name}.{i}", c
            else:
                yield name, child

    def _snapshot_state(self) -> Dict[str, Any]:
        """The states of this metric and of its children, recursively (what
        ``forward`` restores after its batch-only update)."""
        return {
            "own": {attr: getattr(self, attr) for attr in self._defaults},
            "children": {n: c._snapshot_state() for n, c in self._iter_child_metrics()},
            "update_called": self._update_called,
            "donated": self._states_donated,
        }

    def _restore_state(self, snap: Dict[str, Any]) -> None:
        for attr, val in snap["own"].items():
            object.__setattr__(self, attr, val)
        for n, c in self._iter_child_metrics():
            if n in snap["children"]:
                c._restore_state(snap["children"][n])
        self._update_called = snap["update_called"]
        self._mark_state_written()
        self._states_donated = snap["donated"]
        self._is_synced = False
        self._cache = None

    # ------------------------------------------------------------------
    # state registry
    # ------------------------------------------------------------------
    def add_state(
        self,
        name: str,
        default: StateValue,
        dist_reduce_fx: Optional[Union[str, Callable]] = None,
        persistent: bool = False,
    ) -> None:
        """Register a state: a tensor (reduced across processes by
        ``dist_reduce_fx``) or an empty list (gathered and concatenated).
        String reducers ``"sum"/"mean"/"max"/"min"/"cat"`` map to the
        dim-zero functions, ``"merge"`` to the quantile-sketch reducer,
        ``"ring"``/``"decay"`` to the windowed sum reducers; the
        reservoir and moments reducers are passed as their ``*_merge_fx()``
        callables. ``persistent`` is recorded as in the JAX package
        (:meth:`persistent` flips it); ``state_dict`` saves every state."""
        if isinstance(default, list):
            if default:
                raise ValueError("state variable must be an array or an empty list (where you can append arrays)")
        else:
            try:
                default = _state_tensor(default, self._device)
            except (TypeError, ValueError, RuntimeError):
                raise ValueError("state variable must be an array or an empty list (where you can append arrays)")

        if dist_reduce_fx == "merge":
            dist_reduce_fx = sketch_merge_fx()
        elif dist_reduce_fx in ("ring", "decay"):
            # lazy: the windowed package imports this module
            from metrics_tpu_torch.windowed.reducers import decay_sum_fx, ring_sum_fx

            dist_reduce_fx = ring_sum_fx() if dist_reduce_fx == "ring" else decay_sum_fx()
        elif isinstance(dist_reduce_fx, str) and dist_reduce_fx in _REDUCERS:
            dist_reduce_fx = _REDUCERS[dist_reduce_fx]
        elif dist_reduce_fx is not None and not callable(dist_reduce_fx):
            raise ValueError(
                "`dist_reduce_fx` must be callable or one of"
                " ['mean', 'sum', 'cat', 'min', 'max', 'merge', 'ring', 'decay', None]"
            )

        object.__setattr__(self, name, [] if isinstance(default, list) else _clone_state(default))
        self._defaults[name] = default
        self._persistent[name] = persistent
        self._reductions[name] = dist_reduce_fx
        self._cat_states[name] = dist_reduce_fx is dim_zero_cat
        # mean-reduced states need each side's update count to merge; the
        # first one registers a sum-reduced counter (see merge_states)
        if dist_reduce_fx is dim_zero_mean and _AUTO_COUNT not in self._defaults:
            self.add_state(_AUTO_COUNT, default=0, dist_reduce_fx=_sentinel_count_sum)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    @abstractmethod
    def _update(self, *args: Any, **kwargs: Any) -> None:
        """Accumulate batch statistics into the registered states."""

    @abstractmethod
    def _compute(self) -> Any:
        """Compute the final value from the accumulated states."""

    def _bump_auto_count(self, eager: bool) -> None:
        """Increment the mean-merge update counter (no-op without mean
        states). A negative counter stays negative. The eager path keeps
        the counter a Python int (one host read after a reset or restore);
        the pure-state path keeps it a tensor and never reads it."""
        if _AUTO_COUNT not in self._defaults:
            return
        count = getattr(self, _AUTO_COUNT)
        if isinstance(count, int):
            object.__setattr__(self, _AUTO_COUNT, count + 1 if count >= 0 else count)
        elif eager:
            c = int(count)
            object.__setattr__(self, _AUTO_COUNT, c + 1 if c >= 0 else c)
        else:
            object.__setattr__(self, _AUTO_COUNT, torch.where(count < 0, count, count + 1))

    def _mark_state_written(self) -> None:
        """Record an out-of-band state write (reset, restore, load, group borrow)."""
        self._write_epoch += 1
        self._computed = None

    def _mark_fused_written(self, donated: bool) -> None:
        """Install hook of the fused update (``core/fused.py``): its program
        just wrote this metric's states, so the update is observed and the
        write epoch advances, as an out-of-band write's does. ``donated``:
        the states are buffers that the next update overwrites in place."""
        self._update_called = True
        self._states_donated = donated
        self._mark_state_written()

    def _undonated(self, value: Any) -> Any:
        """``value`` with every tensor that shares storage with a donated
        state copied: a result handed out must not change under the next
        fused update (the JAX package deletes a donated array instead)."""
        if not self._states_donated:
            return value
        held = {
            v.untyped_storage().data_ptr() for k in self._defaults if isinstance(v := getattr(self, k), Tensor)
        }
        leaves, spec = tree_flatten(value)
        return tree_unflatten(
            [x.clone() if isinstance(x, Tensor) and x.untyped_storage().data_ptr() in held else x for x in leaves],
            spec,
        )

    def _raise_if_synced(self) -> None:
        if self._is_synced:
            raise MetricsUserError(
                "The Metric shouldn't be synced when performing ``update``. HINT: Did you forget to call ``unsync``?."
            )

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Accumulate a batch into the states. numpy inputs go to the metric's device."""
        self._raise_if_synced()
        self._write_epoch += 1
        self._computed = None
        self._update_called = True
        self._update(*_to_device_inputs(args, self._device), **_to_device_inputs(kwargs, self._device))
        self._bump_auto_count(eager=True)

    def compute(self) -> Any:
        """Compute (and cache) the metric from the accumulated states,
        synced across processes first where there are several (or a
        ``dist_sync_fn`` was given); the local states are put back after."""
        if not self._update_called:
            rank_zero_warn(
                f"The ``compute`` method of metric {self.__class__.__name__} was called before"
                " the ``update`` method which may lead to errors, as metric states have not yet been updated.",
                UserWarning,
            )
        synced = self._to_sync and (_dist_available() or self.dist_sync_fn is not None)
        # one read of the cache: an update on another thread (the async
        # pipeline's worker) may clear it between a check and a second read
        cached = self._computed
        if cached is not None and self._computed_epoch == self._write_epoch and self._computed_synced == synced:
            return cached
        epoch0 = self._write_epoch
        with self.sync_context(
            dist_sync_fn=self.dist_sync_fn, should_sync=self._to_sync, should_unsync=self._should_unsync
        ):
            value = self._undonated(_squeeze_if_scalar(self._compute()))
            self._computed = value
            self._computed_epoch = epoch0
            self._computed_synced = synced
        return value

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Update the accumulated states AND return the metric of this batch
        alone (double update: accumulate; then snapshot, reset, update on
        the batch, compute, restore). The snapshot holds the children's
        states too, so a wrapper keeps its children's accumulation. With
        ``dist_sync_on_step`` the batch value is synced across processes."""
        self._raise_if_synced()
        self.update(*args, **kwargs)
        snapshot = self._snapshot_state()
        self._to_sync = self.dist_sync_on_step
        self._should_unsync = False
        try:
            self.reset()
            self.update(*args, **kwargs)
            self._forward_cache = self.compute()
        finally:
            self._restore_state(snapshot)
            self._should_unsync = True
            self._to_sync = True
        self._update_called = True
        return self._forward_cache

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def reset(self) -> None:
        """Restore every state, and every child's, to its default."""
        self._update_called = False
        self._states_donated = False
        self._forward_cache = None
        self._is_synced = False
        self._cache = None
        self._mark_state_written()
        for attr, default in self._defaults.items():
            object.__setattr__(self, attr, [] if isinstance(default, list) else _clone_state(default))
        for _, child in self._iter_child_metrics():
            child.reset()

    # ------------------------------------------------------------------
    # cross-process sync
    # ------------------------------------------------------------------
    def _sync_dist(self, dist_sync_fn: Callable = gather_all_arrays, process_group: Optional[Any] = None) -> None:
        """Replace every state by its cross-rank reduction: each tensor state
        is gathered (``dist_sync_fn``), stacked ``[world, ...]`` with the
        ranks' sketch occupancy bounds, and folded by its reducer (None
        keeps the stack). A list state is concatenated first, so it costs one
        gather whatever its length, and an empty one still gathers (zero
        rows). The eager ``_n_updates`` counter gathers as an int32 tensor.
        Tensors are installed, never written in place."""
        group = process_group or self.process_group
        for attr, reduction_fn in self._reductions.items():
            value = getattr(self, attr)
            if isinstance(value, int):
                value = torch.tensor(value, dtype=torch.int32, device=self._device)
            if isinstance(value, list):
                synced = self._sync_list(value, reduction_fn, dist_sync_fn, group)
            else:
                stacked = stack_with_fill_bounds(dist_sync_fn(value, group=group))
                synced = stacked if reduction_fn is None else reduction_fn(stacked)
            object.__setattr__(self, attr, synced)

    def _sync_list(
        self, value: List[Tensor], reduction_fn: Optional[Callable], dist_sync_fn: Callable, group: Any
    ) -> StateValue:
        """A list state across ranks. With a reducer (``"cat"``): every rank's
        rows, reduced (the concatenation in rank order), or ``[]`` where no
        rank has any. Without one: every rank's entries, rank by rank, each
        as it was appended (a second gather carries the entry lengths)."""
        entries = [torch.atleast_1d(v) for v in value]
        if entries:
            local = torch.cat(entries) if len(entries) > 1 else entries[0]
        else:
            local = torch.zeros((0,), device=self._device)
        rows = dist_sync_fn(local, group=group)
        if reduction_fn is not None:
            kept = [r for r in rows if r.shape[0]]
            return reduction_fn(kept) if kept else []
        lengths = torch.tensor([e.shape[0] for e in entries], dtype=torch.int64, device=self._device)
        per_rank = dist_sync_fn(lengths, group=group)
        sizes = torch.cat([s.reshape(-1) for s in per_rank]).tolist()
        out: List[Tensor] = []
        for r, s in zip(rows, per_rank):
            n = s.numel()
            out.extend(torch.split(r, sizes[:n]))
            sizes = sizes[n:]
        return out

    def sync(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        distributed_available: Optional[Callable] = _dist_available,
    ) -> None:
        """Replace the states by their cross-process reduction (kept local
        states go back with :meth:`unsync`). Nothing happens with one
        process and no ``dist_sync_fn`` (this call's or the constructor's);
        a ``dist_sync_fn`` alone makes a simulated world."""
        if self._is_synced and should_sync:
            raise MetricsUserError("The Metric has already been synced.")
        is_distributed = distributed_available() if callable(distributed_available) else None
        if dist_sync_fn is None:
            dist_sync_fn = self.dist_sync_fn
        if not should_sync or not (is_distributed or dist_sync_fn is not None):
            return
        if dist_sync_fn is None:
            dist_sync_fn = gather_all_arrays
        self._cache = {attr: getattr(self, attr) for attr in self._defaults}
        self._sync_dist(dist_sync_fn, process_group=process_group)
        self._is_synced = True

    def unsync(self, should_unsync: bool = True) -> None:
        """Put back the local states that :meth:`sync` kept (the same objects)."""
        if not should_unsync:
            return
        if not self._is_synced:
            raise MetricsUserError("The Metric has already been un-synced.")
        if self._cache is None:
            raise MetricsUserError("The internal cache should exist to unsync the Metric.")
        for attr, val in self._cache.items():
            object.__setattr__(self, attr, val)
        self._is_synced = False
        self._cache = None

    @contextmanager
    def sync_context(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        should_unsync: bool = True,
        distributed_available: Optional[Callable] = _dist_available,
    ) -> Generator:
        """Sync on entry and put the local states back on exit (an exception
        inside leaves the metric unsynced too)."""
        self.sync(
            dist_sync_fn=dist_sync_fn,
            process_group=process_group,
            should_sync=should_sync,
            distributed_available=distributed_available,
        )
        try:
            yield
        finally:
            self.unsync(should_unsync=self._is_synced and should_unsync)

    # ------------------------------------------------------------------
    # pure-state API
    # ------------------------------------------------------------------
    def state_reductions(self) -> Dict[str, Union[str, Callable, None]]:
        """Reducer spec per state: ``"sum"``/``"mean"``/``"max"``/``"min"``/
        ``"cat"``, the callable of any other reducer, or None."""
        names = {
            dim_zero_sum: "sum",
            dim_zero_mean: "mean",
            dim_zero_max: "max",
            dim_zero_min: "min",
            dim_zero_cat: "cat",
        }
        return {k: names.get(fn, fn) for k, fn in self._reductions.items()}

    def init_state(self) -> Dict[str, StateValue]:
        """Fresh state dict (copies of the defaults)."""
        return {k: ([] if isinstance(v, list) else _clone_state(v)) for k, v in self._defaults.items()}

    def _bind(self, state: Dict[str, StateValue]) -> Dict[str, StateValue]:
        old = {k: getattr(self, k) for k in self._defaults}
        for k, v in state.items():
            object.__setattr__(self, k, v)
        return old

    def update_state(self, state: Dict[str, StateValue], *args: Any, **kwargs: Any) -> Dict[str, StateValue]:
        """Pure functional update: ``(state, batch) -> new state``; ``state`` is not modified."""
        old = self._bind(state)
        try:
            self._update(*_to_device_inputs(args, self._device), **_to_device_inputs(kwargs, self._device))
            # a state without the counter (hand-built, or restored from an
            # old checkpoint) stays without it
            if _AUTO_COUNT in state:
                self._bump_auto_count(eager=False)
            out = {k: getattr(self, k) for k in self._defaults if k != _AUTO_COUNT or k in state}
            if isinstance(out.get(_AUTO_COUNT), int):
                out[_AUTO_COUNT] = torch.tensor(out[_AUTO_COUNT], dtype=torch.int32, device=self._device)
            return out
        finally:
            for k, v in old.items():
                object.__setattr__(self, k, v)

    def compute_state(self, state: Dict[str, StateValue]) -> Any:
        """Pure functional compute: ``state -> value``."""
        old = self._bind(state)
        try:
            return self._compute()
        finally:
            for k, v in old.items():
                object.__setattr__(self, k, v)

    def merge_states(
        self,
        a: Dict[str, StateValue],
        b: Dict[str, StateValue],
        counts: Optional[Sequence[Union[int, float, Tensor]]] = None,
    ) -> Dict[str, StateValue]:
        """Merge two independently accumulated states by each state's reducer.

        Mean states merge as the count-weighted average; ``counts`` defaults
        to the two states' `_n_updates` counters, and a negative counter on
        either side (history unknown) falls back to the unweighted mean.
        """
        if counts is not None and len(counts) != 2:
            raise ValueError(f"`counts` must be a pair (n_a, n_b), got {len(counts)} entries")
        if counts is None and _AUTO_COUNT in a and _AUTO_COUNT in b:
            counts = (a[_AUTO_COUNT], b[_AUTO_COUNT])
        out: Dict[str, StateValue] = {}
        for name, red in self._reductions.items():
            if name == _AUTO_COUNT and (name not in a or name not in b):
                continue
            va, vb = a[name], b[name]
            if name == _AUTO_COUNT:
                va, vb = torch.as_tensor(va), torch.as_tensor(vb)
                out[name] = torch.where((va >= 0) & (vb >= 0), va + vb, torch.full_like(va, -1))
            elif isinstance(va, list) or isinstance(vb, list) or self._cat_states.get(name):
                out[name] = (va if isinstance(va, list) else [va]) + (vb if isinstance(vb, list) else [vb])
            elif red is dim_zero_sum:
                out[name] = va + vb
            elif red is dim_zero_mean:
                if counts is None:
                    out[name] = (va + vb) / 2
                else:
                    na, nb = (torch.as_tensor(c, dtype=torch.float32, device=va.device) for c in counts)
                    total = na + nb
                    weighted_ok = (na >= 0) & (nb >= 0) & (total > 0)
                    out[name] = torch.where(
                        weighted_ok, (na * va + nb * vb) / torch.clamp(total, min=1.0), (va + vb) / 2
                    )
            elif red is dim_zero_max:
                out[name] = maximum_ieee(va, vb)
            elif red is dim_zero_min:
                out[name] = minimum_ieee(va, vb)
            elif getattr(red, "merge_like", False):
                # sketch states merge through their own reducer, given the
                # stacked states as a distributed sync would give them
                out[name] = red(torch.stack([va, vb]))
            elif getattr(red, "inner_reduce", None) == "sum":
                # windowed ring rows and decayed sums add pairwise
                out[name] = va + vb
            elif red is None:
                raise MetricsUserError(
                    f"Cannot merge tensor state {name!r} with reduction None (gathered-not-reduced"
                    " states have no well-defined pairwise merge); use a list state instead"
                )
            else:
                raise MetricsUserError(f"Cannot merge state {name!r} with custom reduction")
        return out

    # ------------------------------------------------------------------
    # state memory accounting
    # ------------------------------------------------------------------
    def state_footprint(self, include_children: bool = True) -> Dict[str, int]:
        """Bytes per state (``numel * element_size``): a list state sums its
        elements, the eager ``_n_updates`` counter (a host int) counts 4,
        sketch leaves report under ``"sketch/"`` and children's states under
        their dotted names. Reads nothing from the card."""
        out: Dict[str, int] = {}
        for name in self._defaults:
            val = getattr(self, name)
            if isinstance(val, list):
                out[name] = sum(_nbytes(v) for v in val)
            elif isinstance(val, int):
                out[name] = 4
            else:
                merge_like = getattr(self._reductions.get(name), "merge_like", False)
                out[f"{SKETCH_FOOTPRINT_PREFIX}{name}" if merge_like else name] = _nbytes(val)
        if include_children:
            for cname, child in self._iter_child_metrics():
                for key, nb in child.state_footprint().items():
                    out[f"{cname}.{key}"] = nb
        return out

    def total_state_bytes(self) -> int:
        """Bytes held by the states of this metric and of its children."""
        return sum(self.state_footprint().values())

    def theoretical_state_bytes(self) -> int:
        """Bytes that the defaults predict at their current dtypes (list
        states predict 0), children included: equal to
        :meth:`total_state_bytes` for a fixed-shape metric."""
        total = sum(_nbytes(d) for d in self._defaults.values() if not isinstance(d, list))
        return total + sum(child.theoretical_state_bytes() for _, child in self._iter_child_metrics())

    def sketch_fill_ratios(self) -> Dict[str, float]:
        """Occupied share of each sketch leaf (a reservoir's slot is
        occupied above -inf, any other sketch's above 0); a ring of sketches
        reports its fullest slot. Reads the card: never called by
        ``update``."""
        out: Dict[str, float] = {}
        for name, red in self._reductions.items():
            if not getattr(red, "merge_like", False):
                continue
            val = getattr(self, name)
            if not isinstance(val, Tensor) or val.ndim < 2:
                continue
            lead = val[..., 0]
            occupied = lead > float("-inf") if getattr(red, "sketch_kind", "") == "reservoir" else lead > 0
            out[name] = float(occupied.to(torch.float32).mean(dim=-1).max())
        return out

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def persistent(self, mode: bool = False) -> None:
        """Set every state's ``persistent`` flag to ``mode``, children's too."""
        for name in self._persistent:
            self._persistent[name] = mode
        for _, child in self._iter_child_metrics():
            child.persistent(mode)

    def state_dict(self, destination: Optional[Dict] = None, prefix: str = "") -> Dict[str, Any]:
        """Flat dict of copies of all states; a child's under its name
        (``metric.`` or, in a list, ``metrics.0.``)."""
        destination = {} if destination is None else destination
        for name in self._defaults:
            current = getattr(self, name)
            if isinstance(current, list):
                destination[prefix + name] = [v.clone() for v in current]
            elif isinstance(current, int):  # the eager `_n_updates` counter
                destination[prefix + name] = torch.tensor(current, dtype=torch.int32, device=self._device)
            else:
                destination[prefix + name] = _clone_state(current)
        for cname, child in self._iter_child_metrics():
            child.state_dict(destination, prefix=f"{prefix}{cname}.")
        return destination

    def load_state_dict(self, state_dict: Dict[str, Any], prefix: str = "") -> None:
        """Restore states saved by ``state_dict``. When real states are
        restored without the `_n_updates` counter (an old checkpoint), the
        counter becomes the -1 "history unknown" sentinel, so a later
        count-weighted merge never weighs this side's data as zero."""
        restored_real_state = False
        for name in self._defaults:
            key = prefix + name
            if key in state_dict:
                val = state_dict[key]
                if isinstance(val, list):
                    object.__setattr__(self, name, [torch.as_tensor(v, device=self._device) for v in val])
                else:
                    object.__setattr__(self, name, torch.as_tensor(val, device=self._device))
                if name != _AUTO_COUNT:
                    restored_real_state = True
        if restored_real_state and _AUTO_COUNT in self._defaults and prefix + _AUTO_COUNT not in state_dict:
            object.__setattr__(self, _AUTO_COUNT, torch.tensor(-1, dtype=torch.int32, device=self._device))
        if restored_real_state:
            self._mark_state_written()
        for cname, child in self._iter_child_metrics():
            child.load_state_dict(state_dict, prefix=f"{prefix}{cname}.")

    def _set_host_state(self, values: Mapping[str, Any]) -> None:
        """Adopt host-side attributes (names from ``_host_state``)."""
        for name, value in values.items():
            if name not in self._host_state:
                raise ValueError(f"{name!r} is not host state of {type(self).__name__}")
            setattr(self, name, value)

    # ------------------------------------------------------------------
    # misc
    # ------------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def dtype(self) -> torch.dtype:
        """The floating dtype set by :meth:`set_dtype` (float32 by default)."""
        return self._dtype

    def set_dtype(self, dst_type: torch.dtype) -> "Metric":
        """Cast every floating state and default (list states too) to
        ``dst_type``; integer and bool states stay as they are. The cast is a
        state write, so the write epoch advances; a cached ``compute()``
        value is cast too and kept, stamped at the new epoch. A fused update
        keys its graphs on the states' dtypes, so it captures anew."""
        self._dtype = dst_type
        for name, default in self._defaults.items():
            val = getattr(self, name)
            if isinstance(val, list):
                object.__setattr__(self, name, [_cast_state(v, dst_type) for v in val])
            else:
                object.__setattr__(self, name, _cast_state(val, dst_type))
            if isinstance(default, Tensor):
                self._defaults[name] = _cast_state(default, dst_type)
        computed = self._computed
        self._mark_state_written()
        if computed is not None:
            leaves, spec = tree_flatten(computed)
            self._computed = tree_unflatten([_cast_state(x, dst_type) for x in leaves], spec)
            self._computed_epoch = self._write_epoch
        for _, child in self._iter_child_metrics():
            child.set_dtype(dst_type)
        return self

    def to_device(self, device: Union[str, torch.device]) -> "Metric":
        """Move every state (list states too), the defaults and a wrapped
        template metric to ``device``; later host inputs go there as well.
        A fused update keys its graphs on the states' devices, so a moved
        metric never replays a graph captured on the old one."""
        device = _resolve_device(device)
        for name, default in self._defaults.items():
            val = getattr(self, name)
            if isinstance(val, list):
                object.__setattr__(self, name, [v.to(device) for v in val])
            elif isinstance(val, Tensor):
                object.__setattr__(self, name, _clone_state(val, device))
            if isinstance(default, Tensor):
                self._defaults[name] = _clone_state(default, device)
        self._device = device
        template = getattr(self, "_template", None)
        if isinstance(template, Metric):
            template.to_device(device)
        for _, child in self._iter_child_metrics():
            child.to_device(device)
        self._mark_state_written()
        return self

    def clone(self) -> "Metric":
        """A deep copy of the metric, its children included."""
        return deepcopy(self)

    def __deepcopy__(self, memo: Dict[int, Any]) -> "Metric":
        # the ordinary deep copy, then the host-side facts of the sketch
        # tensors (their occupancy bounds), which the tensors' copies void:
        # a copied sketch is as full as its original
        new = self.__class__.__new__(self.__class__)
        memo[id(self)] = new
        new.__dict__.update(deepcopy(self.__dict__, memo))
        for name, default in self._defaults.items():
            for old, copied in ((default, new._defaults[name]), (getattr(self, name), getattr(new, name))):
                if isinstance(old, Tensor) and hasattr(old, _FILL_BOUND):
                    with_fill_bound(copied, fill_bound(old))
        return new

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """Keep the kwargs that ``self._update`` accepts."""
        params = inspect.signature(self._update).parameters
        if any(p.kind == p.VAR_KEYWORD for p in params.values()):
            return kwargs
        _params = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
        return {k: v for k, v in kwargs.items() if k in params and params[k].kind not in _params}

    def __hash__(self) -> int:
        hash_vals: List[Any] = [self.__class__.__name__, id(self)]
        for key in self._defaults:
            val = getattr(self, key)
            if isinstance(val, list):
                hash_vals.extend(id(v) for v in val)
            else:
                hash_vals.append(id(val))
        return hash(tuple(hash_vals))

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}()"

    # ------------------------------------------------------------------
    # operator algebra: each operator builds a CompositionalMetric
    # ------------------------------------------------------------------
    def __add__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.add, self, other)

    def __radd__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.add, other, self)

    def __sub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.sub, self, other)

    def __rsub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.sub, other, self)

    def __mul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.mul, self, other)

    def __rmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.mul, other, self)

    def __truediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.truediv, self, other)

    def __rtruediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.truediv, other, self)

    def __floordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.floordiv, self, other)

    def __rfloordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.floordiv, other, self)

    def __mod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.mod, self, other)

    def __rmod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.mod, other, self)

    def __pow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.pow, self, other)

    def __rpow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.pow, other, self)

    def __matmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.matmul, self, other)

    def __rmatmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.matmul, other, self)

    def __and__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.and_, self, other)

    def __rand__(self, other: Any) -> "CompositionalMetric":
        # as in the JAX package: bitwise and commutes, so the order is kept
        return CompositionalMetric(operator.and_, self, other)

    def __or__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.or_, self, other)

    def __ror__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.or_, other, self)

    def __xor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.xor, self, other)

    def __rxor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.xor, other, self)

    def __eq__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(operator.eq, self, other)

    def __ne__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(operator.ne, self, other)

    def __lt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.lt, self, other)

    def __le__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.le, self, other)

    def __gt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.gt, self, other)

    def __ge__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(operator.ge, self, other)

    def __abs__(self) -> "CompositionalMetric":
        return CompositionalMetric(operator.abs, self, None)

    def __neg__(self) -> "CompositionalMetric":
        # the JAX package's quirk: -metric is -|metric|
        return CompositionalMetric(_neg, self, None)

    def __pos__(self) -> "CompositionalMetric":
        # the JAX package's quirk: +metric is |metric|
        return CompositionalMetric(operator.abs, self, None)

    def __invert__(self) -> "CompositionalMetric":
        return CompositionalMetric(operator.invert, self, None)

    def __getitem__(self, idx: Any) -> "CompositionalMetric":
        return CompositionalMetric(lambda x: x[idx], self, None)


def _nbytes(value: Any) -> int:
    return value.numel() * value.element_size() if isinstance(value, Tensor) else 0


def _neg(x: Tensor) -> Tensor:
    return -torch.abs(x)


def _operand(value: Any, device: torch.device) -> Any:
    """A composition's operand: a metric or ``None`` as it is, anything else
    a tensor on ``device`` (host ints int32, floats float32, as
    ``_state_tensor`` makes defaults)."""
    if value is None or isinstance(value, Metric):
        return value
    return _state_tensor(value, device)


class CompositionalMetric(Metric):
    """Two metrics, or a metric and a constant, joined by an operator.

    ``update`` and ``forward`` pass each child the keyword arguments its
    update accepts; ``compute`` applies the operator to the children's
    values (it keeps no cache and no states of its own, and its
    ``_sync_dist`` does nothing: the children sync themselves, each by its
    own sync arguments). It runs on its first metric operand's device.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanSquaredError
        >>> mse = MeanSquaredError(device="cpu")
        >>> rmse = mse ** 0.5
        >>> rmse.update(torch.tensor([1.0, 2.0]), torch.tensor([2.0, 4.0]))
        >>> rmse.compute()
        tensor(1.5811)
    """

    def __init__(
        self,
        operator: Callable,
        metric_a: Union[Metric, float, int, Tensor],
        metric_b: Union[Metric, float, int, Tensor, None],
    ) -> None:
        metric = metric_a if isinstance(metric_a, Metric) else metric_b
        super().__init__(device=metric.device if isinstance(metric, Metric) else None)
        self.op = operator
        self.metric_a = _operand(metric_a, self._device)
        self.metric_b = _operand(metric_b, self._device)

    def _sync_dist(self, *args: Any, **kwargs: Any) -> None:
        pass  # the children sync themselves

    def _update(self, *args: Any, **kwargs: Any) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.update(*args, **self.metric_a._filter_kwargs(**kwargs))
        if isinstance(self.metric_b, Metric):
            self.metric_b.update(*args, **self.metric_b._filter_kwargs(**kwargs))

    def _compute(self) -> Any:
        return self.compute()

    def compute(self) -> Any:
        val_a = self.metric_a.compute() if isinstance(self.metric_a, Metric) else self.metric_a
        val_b = self.metric_b.compute() if isinstance(self.metric_b, Metric) else self.metric_b
        if val_b is None:
            return self.op(val_a)
        return self.op(val_a, val_b)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        val_a = (
            self.metric_a(*args, **self.metric_a._filter_kwargs(**kwargs))
            if isinstance(self.metric_a, Metric)
            else self.metric_a
        )
        val_b = (
            self.metric_b(*args, **self.metric_b._filter_kwargs(**kwargs))
            if isinstance(self.metric_b, Metric)
            else self.metric_b
        )
        if val_a is None:
            self._forward_cache = None
        elif val_b is None:
            self._forward_cache = None if isinstance(self.metric_b, Metric) else self.op(val_a)
        else:
            self._forward_cache = self.op(val_a, val_b)
        return self._forward_cache

    def reset(self) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.reset()
        if isinstance(self.metric_b, Metric):
            self.metric_b.reset()
        self._update_called = False
        self._forward_cache = None
        self._computed = None

    def __repr__(self) -> str:
        _op_name = getattr(self.op, "__name__", str(self.op))
        return self.__class__.__name__ + f"(\n  {_op_name}(\n    {repr(self.metric_a)},\n    {repr(self.metric_b)}\n  )\n)"

    def __hash__(self) -> int:
        return hash((self.__class__.__name__, id(self)))
