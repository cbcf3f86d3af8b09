"""``SlicedMetric`` -- one metric, a leading ``[S]`` slice axis on every state.

Counterpart of ``metrics_tpu/sliced/metric.py``. Where an object fan-out
keeps N metric objects, a sliced metric keeps ONE state whose every leaf
carries a leading slice dimension, and ``update(slice_ids, *batch)``
scatters each batch row's contribution into its slice:

* **Per-row contributions** come from the wrapped metric's own pure update
  (``update_state``) run by ``torch.func.vmap`` over length-1 rows against
  the default state: no per-slice Python loop. A template whose update
  cannot be vmapped (it reads values back to the host, say) raises
  :class:`MetricsUserError`.
* **One segment reduction per leaf**, through the port's kernels on the
  card: a ``"sum"`` leaf adds its segment-summed row deltas
  (``segment_sum_f32`` for float32, ``segment_sum_i32`` for int32);
  ``"max"``/``"min"`` leaves fold their segment extremum (K2,
  ``segment_max_f32``/``segment_min_f32``) with the JAX package's NaN and
  signed-zero semantics. Empty segments hold the fold's identity, so an
  untouched slice is left bit-identical. Other reducers (``mean``, ``cat``,
  custom, None) have no exact scatter and are rejected at construction.
* **Reads** fold only the slices written since their last read. A bool
  dirty bitmap on the metric's device is set by each update with no host
  read, and read once per ``compute()``; the per-slice values of earlier
  folds are kept on the device (the ``sliced_value_cache`` memory plane).
  The dirty ids are padded (:func:`~metrics_tpu_torch.core.readers.pad_ids`)
  to a bucket of :func:`~metrics_tpu_torch.core.readers.round_up_bucket`
  and folded through the ``sliced_subset`` reader of a
  :class:`~metrics_tpu_torch.core.readers.ReaderCache`: on the card a CUDA
  graph of the vmapped compute over static row buffers, which the slices'
  rows are gathered into; ``top_k`` takes the ``sliced_topk`` reader (a
  stable descending sort of the row counts, at a bucketed ``k``). A
  padded read equals the unpadded cold fold bit for bit: the wrapped
  compute of one slice does not depend on the others in the batch.
  ``compute_state(state)`` always folds the state it is given and never
  serves the kept values. A synced read (the cross-rank states, inside
  ``sync_context``) folds every slice that any rank wrote, i.e. all of
  them, and leaves the bitmap and the kept values to the local states.

Slice ids are a 1-D integer tensor aligned with the batch's leading axis;
ids outside ``[0, num_slices)`` are dropped. The ``_slice_rows`` counter
counts rows per slice and drives ``compute(top_k=)`` and ``hot_slices``.
A sliced metric runs inside the fused update (``core/fused.py``)
unchanged. With the default telemetry recorder enabled, each eager update
records a ``sliced_scatter`` event (with an attached time series, the
batch's hottest-slice row count too: one host read of a bincount); inside
a fused update the event is recorded once per cache entry (``in_jit``),
with no host read. A read with ``slice_ids=``/``top_k=`` records a
``sliced`` read event, and a full ``compute()`` carries the number of
slices it refolded (``fanin``).

**Sharded over a process group** (``sliced/sharding.py``'s
``shard_sliced_states``): rank ``r`` of ``W`` owns the slices
``[r*S/W, (r+1)*S/W)`` and holds every leaf, the row counter, the dirty
bitmap and the kept values as blocks of that size. An update is
collective (every rank calls it in the same order, with batches of the
same size): each rank computes its per-row states, one gather brings
every rank's ids and rows (``W*B`` rows received per rank), and each rank
folds them into its block at ids shifted by ``r*S/W`` through the same
kernels (K1, K2), which drop the ids it does not own. Reads are collective
too: ``compute()`` folds the rank's dirty slices through its own read
plane and gathers the value blocks in rank order into ``[S]`` on every
rank; ``compute(slice_ids=)``, ``top_k``, ``hot_slices`` and
``slice_counts`` answer over the whole ``S``. While synced, ``compute()``
refuses, as every synced metric's does; the other reads go through the
owners when the sync passed the blocks through (``partition_specs=``), and
index the gathered ``[S]`` states directly when it did not. The hot-slice
row count covers the rank's own slices.
"""
from copy import deepcopy
import time
import weakref
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from metrics_tpu_torch.core.metric import _AUTO_COUNT, Metric
from metrics_tpu_torch.core.readers import ReaderCache, pad_ids, round_up_bucket
from metrics_tpu_torch.observability.memory import register_cache_plane
from metrics_tpu_torch.observability.recorder import _DEFAULT_RECORDER as _TELEMETRY
from metrics_tpu_torch.ops.segment_extremum import segment_max_dispatch, segment_min_dispatch
from metrics_tpu_torch.ops.segment_sum import segment_sum_dispatch
from metrics_tpu_torch.parallel.distributed import gather_parts
from metrics_tpu_torch.sketches.quantile import _FILL_BOUND, fill_bound, with_fill_bound
from metrics_tpu_torch.utils.checks import capturing_checks, checks_read_nothing, in_entry_build
from metrics_tpu_torch.utils.data import (
    _as_tensor,
    _is_integer,
    _resolve_device,
    dim_zero_max,
    dim_zero_min,
    dim_zero_sum,
    maximum_ieee,
    minimum_ieee,
)
from metrics_tpu_torch.utils.exceptions import MetricsUserError

Tensor = torch.Tensor

#: per-slice row counter: the sum-reduced ``[S]`` int32 state every
#: SlicedMetric registers beside the wrapped leaves
SLICE_ROWS = "_slice_rows"
#: key prefix of this wrapper's states in ``state_footprint``
SLICED_FOOTPRINT_PREFIX = "sliced/"

#: reducers with an exact slice-axis scatter
_SLICEABLE = {dim_zero_sum: "sum", dim_zero_max: "max", dim_zero_min: "min"}


def _reducer_name(red: Any) -> str:
    if red is None:
        return "None"
    return _SLICEABLE.get(red) or getattr(red, "__name__", repr(red))


#: every live SlicedMetric (weak); the ``sliced_value_cache`` memory plane
#: sums the kept per-slice values and the dirty bitmap over this set
_LIVE_SLICED: "weakref.WeakSet" = weakref.WeakSet()


def _svc_plane_nbytes() -> int:
    total = 0
    for m in list(_LIVE_SLICED):
        dirty = getattr(m, "_dirty", None)
        if dirty is not None:
            total += dirty.numel() * dirty.element_size()
        kept = getattr(m, "_values", None)
        if kept is not None:
            total += sum(v.numel() * v.element_size() for v in kept[0])
    return total


register_cache_plane("sliced_value_cache", _svc_plane_nbytes)


def _wrapper_device(metric: Metric, kwargs: Dict[str, Any], wrapper: str) -> torch.device:
    """The device a wrapper of ``metric`` runs on: the template's. A
    ``device=`` among ``kwargs`` (taken out of them) must name it."""
    device = kwargs.pop("device", None)
    if device is not None and not _same_device(torch.device(device), metric.device):
        raise MetricsUserError(
            f"{wrapper} runs on its wrapped metric's device {metric.device}; got device={str(device)!r}."
            f" Build the wrapped metric with device={str(device)!r} instead"
        )
    return metric.device


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one: a CUDA device without an index is the
    current one."""
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index == b.index:
        return True
    current = torch.cuda.current_device()
    return (current if a.index is None else a.index) == (current if b.index is None else b.index)


def _vmapped_compute(template: Metric) -> Any:
    """The template's compute vmapped over a leading slice axis, under the
    capture rule of ``utils/checks.py``: no value of a vmapped slice can be
    read on the host, as the JAX package's checks skip vmap's tracers."""
    fold = torch.func.vmap(template.compute_state)

    def compute(states: Dict[str, Tensor]) -> Any:
        with capturing_checks():
            return fold(states)

    return compute


def _template_of(metric: Metric) -> Metric:
    """A reset copy of ``metric``, the wrapper's template. The wrapper runs
    on the template's device."""
    template = deepcopy(metric)
    # a copy is a write to torch's version counter, which voids a sketch
    # default's occupancy bound; the copied content keeps it
    for name, default in template._defaults.items():
        original = metric._defaults[name]
        if isinstance(default, Tensor) and hasattr(original, _FILL_BOUND):
            with_fill_bound(default, fill_bound(original))
    template.reset()
    return template


class SlicedMetric(Metric):
    """Track ``metric`` independently across ``num_slices`` slices.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanSquaredError
        >>> from metrics_tpu_torch.sliced import SlicedMetric
        >>> per_tenant = SlicedMetric(MeanSquaredError(device="cpu"), num_slices=3)
        >>> per_tenant.update(torch.tensor([0, 1, 2, 2]),  # slice ids, row-aligned
        ...                   torch.tensor([1.0, 2.0, 2.0, 4.0]),   # preds
        ...                   torch.tensor([1.0, 0.0, 0.0, 0.0]))   # target
        >>> per_tenant.compute()  # [S]-leading: one value per slice
        tensor([ 0.,  4., 10.])

    ``update(slice_ids, *args, **kwargs)`` forwards ``*args``/``kwargs`` to
    the wrapped metric row by row; ``compute()`` runs the wrapped compute
    over the slice axis. ``compute(slice_ids=...)`` evaluates a subset and
    ``compute(top_k=k)`` returns ``(slice_ids, values)`` for the ``k``
    slices with the most rows (ties to the lower id). Reset,
    ``merge_states`` and ``state_dict`` are the ordinary :class:`Metric`
    ones. The metric runs on the wrapped metric's device; a ``device=``
    must name that device (:class:`MetricsUserError` otherwise).
    """

    higher_is_better = None
    is_differentiable = False
    # a sharded update gathers the batch rows and folds the owned ones
    _routes_sharded_update = True

    def __init__(self, metric: Metric, num_slices: int, **kwargs: Any) -> None:
        if not isinstance(metric, Metric):
            raise MetricsUserError(f"SlicedMetric wraps a Metric instance, got {type(metric).__name__}")
        if isinstance(metric, SlicedMetric):
            raise MetricsUserError("SlicedMetric cannot wrap another SlicedMetric")
        if not isinstance(num_slices, int) or isinstance(num_slices, bool) or num_slices <= 0:
            raise MetricsUserError(f"`num_slices` must be a positive int, got {num_slices!r}")
        self._validate_sliceable(metric)
        super().__init__(device=_wrapper_device(metric, kwargs, "SlicedMetric"), **kwargs)
        self.num_slices = num_slices
        # the slices this process holds: all of them, or a rank's block
        self._offset, self._n_local = 0, num_slices
        # the wrapped metric is a TEMPLATE: its pure update and compute run
        # per row and per slice; its own states are never accumulated
        # set past the child registry: the template is not a child (a child
        # would send this metric to a fused update's eager leg, and its
        # placeholder states would count in the footprint)
        object.__setattr__(self, "_template", _template_of(metric))
        for name, red in self._template._reductions.items():
            default = self._template._defaults[name]
            self.add_state(name, default=default.expand((num_slices,) + tuple(default.shape)), dist_reduce_fx=red)
        self.add_state(SLICE_ROWS, default=torch.zeros(num_slices, dtype=torch.int32), dist_reduce_fx="sum")
        # dirty bitmap: True where a slice was written since its value was
        # last folded; entry S is the sink of dropped ids. Starts all-dirty.
        self._dirty = torch.ones(num_slices + 1, dtype=torch.bool, device=self.device)
        # per-slice values of earlier folds: ([S, ...] tensors, tree spec),
        # trusted where the dirty bit is clear
        self._values: Optional[Tuple[list, Any]] = None
        # the subset-fold and top-k readers (core/readers.py)
        self._readers = ReaderCache()
        _LIVE_SLICED.add(self)

    # ------------------------------------------------------------------
    # construction-time sliceability validation
    # ------------------------------------------------------------------
    @staticmethod
    def _validate_sliceable(metric: Metric) -> None:
        """Reject metrics without an exact per-leaf scatter: mis-scattering
        (segment-summing a running mean, say) would corrupt every touched
        slice silently."""
        cls_name = type(metric).__name__
        if getattr(metric, "__jit_unsafe__", False):
            raise MetricsUserError(
                f"`{cls_name}` declares `__jit_unsafe__`: its update cannot be vmapped, so it"
                " cannot run inside the sliced scatter."
            )
        if metric._children:
            raise MetricsUserError(
                f"`{cls_name}` is a wrapper metric (child registry"
                f" {sorted(dict(metric._iter_child_metrics()))}); slice the inner"
                " metric directly instead of the wrapper."
            )
        static = metric.static_sliceability() or {}
        for name, red in metric._reductions.items():
            if isinstance(metric._defaults[name], list):
                raise MetricsUserError(
                    f"`{cls_name}` state `{name}` is a list ('cat') state; unbounded"
                    " concatenation has no fixed-shape slice axis. Sliceable leaves"
                    " need a sum/max/min reducer over an array state."
                )
            if name == SLICE_ROWS:
                raise MetricsUserError(
                    f"`{cls_name}` state `{name}` collides with the reserved sliced row-counter state name"
                )
            if red not in _SLICEABLE:
                hint = ""
                if name == _AUTO_COUNT:
                    hint = " (the auto mean-merge counter has no per-slice scatter)"
                elif static.get(name) is False:
                    hint = " (the fusibility manifest's per-leaf `sliceable` verdict agrees)"
                raise MetricsUserError(
                    f"`{cls_name}` state `{name}` has reducer"
                    f" `{_reducer_name(red)}`; only sum/max/min-reduced array states"
                    " have an exact slice-axis scatter (segment_sum / scatter-max /"
                    f" scatter-min){hint}. A mean-style metric should accumulate"
                    " sum-reduced numerator/denominator leaves."
                )

    # ------------------------------------------------------------------
    # update
    # ------------------------------------------------------------------
    @property
    def wrapped(self) -> Metric:
        """The wrapped template metric (its states are placeholders)."""
        return self._template

    @property
    def slice_counts(self) -> Tensor:
        """Rows ingested per slice, ``[S]`` int32 (sharded: gathered from
        every rank, a collective)."""
        return self._gathered([getattr(self, SLICE_ROWS)])[0]

    def _holds_blocks(self) -> bool:
        """Whether the states are this rank's blocks of slices: sharded, and
        not gathered into the full ``[S]`` by a sync (a sync whose
        ``partition_specs`` pass every state through leaves the blocks, the
        same objects; one without gathers them). A sync that gathered some
        states and passed others leaves nothing a read can fold per slice."""
        if not self._shardings:
            return False
        rows = {getattr(self, name).shape[0] for name in self._defaults}
        if rows == {self._n_local}:
            return True
        if rows == {self.num_slices}:
            return False
        raise MetricsUserError(
            f"a sharded {type(self).__name__} cannot be read while a sync has gathered some of its states and"
            " passed others through: sync every state with the axis in `partition_specs`, or none"
        )

    def _gathered(self, blocks: list) -> list:
        """Per-rank blocks (leading axis the rank's slices) laid end to end
        in rank order, in one round; as they are when the states are not
        blocks (not sharded, or gathered by a sync)."""
        if not self._holds_blocks():
            return blocks
        stacks = gather_parts(blocks, self._shard_mesh().group, self.dist_sync_fn)
        return [stack.reshape((-1,) + tuple(stack.shape[2:])) for stack in stacks]

    def _on_sharded(self) -> None:
        """Every leaf holds the same block of slices: the read plane (dirty
        bitmap, kept values, readers) is resized to it."""
        names = set(self._defaults)
        if set(self._shardings) != names:
            raise MetricsUserError(
                f"a SlicedMetric shards all of its states or none; sharded {sorted(self._shardings)} of {sorted(names)}"
            )
        sharding = self._shardings[SLICE_ROWS]
        self._offset, hi = sharding.block(self.num_slices)
        self._n_local = hi - self._offset
        self._dirty = torch.ones(self._n_local + 1, dtype=torch.bool, device=self.device)
        self._values = None
        self._readers.clear()

    def _row_states(self, args: Tuple, kwargs: Dict[str, Any], n_rows: int) -> Dict[str, Tensor]:
        """Per-row post-update states ``{leaf: [B, *leaf_shape]}``: the
        wrapped metric's pure update vmapped over single-row batches against
        the default state. Tensor arguments whose leading axis matches the
        slice ids are batched; everything else is closed over."""
        m = self._template
        defaults = dict(m._defaults)
        leaves, spec = tree_flatten((args, kwargs))
        batched = [
            i for i, leaf in enumerate(leaves) if isinstance(leaf, Tensor) and leaf.ndim >= 1 and leaf.shape[0] == n_rows
        ]
        if not batched:
            raise MetricsUserError(
                "SlicedMetric.update: no batch argument shares the slice_ids"
                f" leading dimension ({n_rows}); slice ids must be row-aligned"
                " with the update inputs"
            )
        # rows keep a length-1 batch axis, so the wrapped update sees an
        # ordinary (1, ...) batch
        rows = [leaves[i].unsqueeze(1) for i in batched]

        def one_row(*row_leaves: Tensor) -> Dict[str, Tensor]:
            full = list(leaves)
            for i, r in zip(batched, row_leaves):
                full[i] = r
            a, kw = tree_unflatten(full, spec)
            return m.update_state(dict(defaults), *a, **kw)

        try:
            # no value of a vmapped row can be read on the host: the value
            # checks read nothing (the capture rule of utils/checks.py), as
            # the JAX package's checks skip vmap's tracers
            with capturing_checks():
                return torch.func.vmap(one_row)(*rows)
        except RuntimeError as err:
            if "vmap" not in str(err):
                raise
            raise MetricsUserError(
                f"`{type(m).__name__}`'s update cannot be vmapped over single-row batches, so it"
                f" cannot run inside the sliced scatter: {err}"
            ) from err

    def _update(self, slice_ids: Any, *args: Any, **kwargs: Any) -> None:
        slice_ids = _as_tensor(slice_ids, self.device)
        if slice_ids.ndim != 1:
            raise MetricsUserError(f"`slice_ids` must be a 1-D integer array, got shape {tuple(slice_ids.shape)}")
        if not _is_integer(slice_ids.dtype):
            raise MetricsUserError(f"`slice_ids` must be integer-typed, got dtype {slice_ids.dtype}")
        m = self._template
        n_rows = int(slice_ids.shape[0])
        num = self._n_local
        row_states = self._row_states(args, m._filter_kwargs(**kwargs), n_rows)
        # per-row delta against the default for the sums: exact for
        # additive accumulation
        rows_by_leaf = {
            name: row_states[name] - m._defaults[name] if red is dim_zero_sum else row_states[name]
            for name, red in m._reductions.items()
        }
        if self._shardings:
            # every rank's ids and rows, in rank order; ids outside this
            # rank's block land out of range and the kernels drop them
            names = list(rows_by_leaf)
            stacks = gather_parts([slice_ids] + [rows_by_leaf[n] for n in names], self._shard_mesh().group, self.dist_sync_fn)
            slice_ids = stacks[0].reshape(-1) - self._offset
            rows_by_leaf = {n: stack.reshape((-1,) + tuple(stack.shape[2:])) for n, stack in zip(names, stacks[1:])}
            n_rows = int(slice_ids.shape[0])
        for name, red in m._reductions.items():
            rows = rows_by_leaf[name]
            old = getattr(self, name)
            if red is dim_zero_sum:
                # segment-summed into the slice axis
                new = old + segment_sum_dispatch(rows, slice_ids, num)
            elif red is dim_zero_max:
                # empty segments hold -inf, so untouched slices keep their bits
                new = maximum_ieee(old, segment_max_dispatch(rows, slice_ids, num))
            else:  # dim_zero_min (validated at construction)
                new = minimum_ieee(old, segment_min_dispatch(rows, slice_ids, num))
            setattr(self, name, new)
        ones = torch.ones(n_rows, dtype=torch.int32, device=slice_ids.device)
        setattr(self, SLICE_ROWS, getattr(self, SLICE_ROWS) + segment_sum_dispatch(ones, slice_ids, num))
        # the written slices go dirty on the device, with no host read:
        # dropped ids land in the sink entry
        in_range = (slice_ids >= 0) & (slice_ids < num)
        self._dirty.index_fill_(0, torch.where(in_range, slice_ids, num).long(), True)
        if _TELEMETRY.enabled:
            self._record_scatter(slice_ids, n_rows, len(m._reductions))

    def _record_scatter(self, slice_ids: Tensor, n_rows: int, n_leaves: int) -> None:
        """The ``sliced_scatter`` event. Inside a fused update (the value
        checks read nothing) it is recorded once per cache entry, as the
        JAX package records it once per trace, and reads nothing; an eager
        update with a time series attached reads the batch's hottest-slice
        row count (one host read) for the hot-slice-skew series."""
        in_jit = checks_read_nothing()
        if in_jit and not in_entry_build():
            return  # the probe, the warm-ups, later plain runs
        hot_rows = None
        if not in_jit and _TELEMETRY.timeseries is not None and n_rows:
            # only the rows this process folds: a sharded update's rows of
            # other ranks' blocks (and dropped ids) count in no slice
            held = slice_ids[(slice_ids >= 0) & (slice_ids < self._n_local)].long()
            hot_rows = int(torch.bincount(held, minlength=1).max())
        _TELEMETRY.record_sliced_scatter(
            self, n_rows=n_rows, n_slices=self.num_slices, n_leaves=n_leaves, in_jit=in_jit, hot_rows=hot_rows
        )

    def _mark_state_written(self) -> None:
        # out-of-band installs (reset, restore, load, a compute group's
        # borrow) cannot say which slices changed
        super()._mark_state_written()
        dirty = getattr(self, "_dirty", None)
        if dirty is not None:
            dirty.fill_(True)

    def set_dtype(self, dst_type: torch.dtype) -> "SlicedMetric":
        # kept per-slice values hold the old dtype's bits: every slice
        # refolds (the cast marked them all dirty)
        out = super().set_dtype(dst_type)
        self._values = None
        # the readers were captured for the old dtype's rows; the
        # signature-free probe must never see them
        self._readers.clear()
        return out

    def to_device(self, device: Any) -> "SlicedMetric":
        # the dirty bitmap moves with the states, and every slice refolds
        self._dirty = self._dirty.to(_resolve_device(device))
        self._values = None
        self._readers.clear()
        return super().to_device(device)

    # ------------------------------------------------------------------
    # compute
    # ------------------------------------------------------------------
    def _fold(self, states: Dict[str, Tensor]) -> Any:
        """The wrapped compute over the leading axis of ``states``."""
        return _vmapped_compute(self._template)(states)

    def compute_state(self, state: Dict[str, Tensor]) -> Any:
        """Pure functional compute: the wrapped compute over every slice of
        ``state``. It folds the state it is given: the values kept for
        ``compute()`` describe this metric's own states, not ``state``."""
        return self._fold({name: state[name] for name in self._template._defaults})

    def _subset_reader(self, bucket: int, index: Tensor) -> Any:
        """The ``sliced_subset`` reader at ``bucket`` rows: the vmapped
        wrapped compute over gathered slice rows."""
        reader = self._readers.fast("sliced_subset", bucket)
        if reader is not None:
            return reader
        names = tuple(self._template._defaults)
        rows = {name: getattr(self, name).index_select(0, index) for name in names}
        # the reader holds the template, not this metric: no reference
        # cycle keeps a metric's graphs alive past the metric
        template = self._template
        return self._readers.get("sliced_subset", lambda: _vmapped_compute(template), rows, bucket=bucket)

    def _fold_slices(self, req: np.ndarray) -> Tuple[Any, int]:
        """Values of the slices ``req`` (host ids): the dirty ones among them
        are folded (padded to a bucket, through the ``sliced_subset``
        reader) and kept, the others come from the kept values. Returns
        ``(values, n_folded)``. The dirty bitmap is read to the host once."""
        m = self._template
        dirty = self._dirty[: self._n_local].cpu().numpy()
        fold = np.unique(req[dirty[req]])
        if fold.size:
            bucket = round_up_bucket(fold.size, self._n_local)
            index = torch.as_tensor(pad_ids(fold, bucket), device=self.device).long()
            reader = self._subset_reader(bucket, index)
            # the rows dict's order is the reader's flattened argument order
            sources = [getattr(self, name) for name in m._defaults]
            flat, spec = tree_flatten(reader.gather(sources, index))
            if self._values is None:
                cache = [torch.zeros((self._n_local,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device) for v in flat]
                self._values = (cache, spec)
            for kept, value in zip(self._values[0], flat):
                # a copy: the reader's next replay overwrites its outputs
                # (the pad rows repeat the last id with its own value)
                kept[index] = value
            self._dirty[index] = False
        index = torch.as_tensor(req, device=self.device).long()
        cache, spec = self._values
        return tree_unflatten([kept[index] for kept in cache], spec), int(fold.size)

    def _compute(self) -> Any:
        if self._is_synced and not self._holds_blocks():
            # synced states are the cross-rank reduction, not the local
            # accumulation that the dirty bitmap and the kept values
            # describe: fold every slice, and touch neither (blocks passed
            # through a sync are the local states themselves)
            return self._fold({name: getattr(self, name) for name in self._template._defaults})
        values, n_folded = self._fold_slices(np.arange(self._n_local))
        self._last_fold_fanin = n_folded
        return values

    def _compute_cold(self, synced: bool) -> Any:
        if not self._shardings:
            return super()._compute_cold(synced)
        if self._is_synced:
            # what the base's sync_context refuses: compute() syncs itself
            raise MetricsUserError("The Metric has already been synced.")
        # sharded: the rank folds its own dirty slices (its memo and value
        # cache), then the value blocks are gathered in rank order
        epoch0 = self._write_epoch
        flat, spec = tree_flatten(self._compute())
        value = self._undonated(tree_unflatten(self._gathered(flat), spec))
        self._computed, self._computed_epoch, self._computed_synced = value, epoch0, synced
        return value

    def _local_values(self, local: np.ndarray) -> Tuple[list, Any, int]:
        """Flat values, tree spec and slices refolded of the held slices
        ``local`` (ids into this process's block), through the read plane;
        an empty subset is the fold of one slice, cut to none."""
        if local.size:
            values, n_folded = self._fold_slices(local)
            return (*tree_flatten(values), n_folded)
        flat, spec = tree_flatten(self._fold({name: getattr(self, name)[:1] for name in self._template._defaults}))
        return [v[:0] for v in flat], spec, 0

    def _sharded_subset(self, host_ids: np.ndarray) -> Tuple[Any, int]:
        """Values of the global slices ``host_ids`` on every rank: each rank
        folds the ones it owns into their places, zeros elsewhere; one
        gather, and each place takes its owner's row."""
        owner = host_ids // self._n_local
        mine = np.flatnonzero(owner == self._shardings[SLICE_ROWS].rank)
        flat, spec, n_folded = self._local_values(host_ids[mine] - self._offset)
        index = torch.as_tensor(mine, device=self.device).long()
        parts = []
        for v in flat:
            placed = torch.zeros((host_ids.size,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
            parts.append(placed.index_copy(0, index, v))
        stacks = gather_parts(parts, self._shard_mesh().group, self.dist_sync_fn)
        rows = torch.as_tensor(owner, device=self.device).long()
        cols = torch.arange(host_ids.size, device=self.device)
        return tree_unflatten([stack[rows, cols] for stack in stacks], spec), n_folded

    def _read_extras(self) -> Dict[str, Any]:
        # the refolded slices of the last cold compute, on its read event
        return {"fanin": getattr(self, "_last_fold_fanin", None)}

    def compute(self, *, slice_ids: Optional[Any] = None, top_k: Optional[int] = None) -> Any:
        """Per-slice values.

        With no arguments: the full ``[S]``-leading result through the
        ordinary :meth:`Metric.compute` cycle (cached until the next write).
        ``slice_ids=`` evaluates only those slices; ids out of range raise
        (a gather would clamp them to a neighbouring slice). ``top_k=k``
        selects the ``k`` slices with the most ingested rows, ties to the
        lower id, and returns ``(slice_ids, values)``.
        """
        if slice_ids is None and top_k is None:
            return super().compute()
        if slice_ids is not None and top_k is not None:
            raise MetricsUserError("pass either `slice_ids` or `top_k`, not both")
        t0 = time.perf_counter() if _TELEMETRY.enabled else 0.0
        if top_k is not None:
            if not isinstance(top_k, int) or isinstance(top_k, bool) or top_k <= 0:
                raise MetricsUserError(f"`top_k` must be a positive int, got {top_k!r}")
            ids = self._top_ids(min(top_k, self.num_slices))
            host_ids = ids.cpu().numpy()
        else:
            ids = _as_tensor(slice_ids, self.device)
            if ids.ndim != 1 or not _is_integer(ids.dtype):
                raise MetricsUserError(
                    f"`slice_ids` must be a 1-D integer array, got shape {tuple(ids.shape)} dtype {ids.dtype}"
                )
            host_ids = ids.cpu().numpy()
            if host_ids.size and (host_ids.min() < 0 or host_ids.max() >= self.num_slices):
                raise MetricsUserError(
                    f"`slice_ids` out of range for num_slices={self.num_slices}:"
                    f" min {int(host_ids.min())}, max {int(host_ids.max())}"
                )
        n_folded = int(host_ids.size)
        if self._holds_blocks():
            values, n_folded = self._sharded_subset(host_ids)
        elif host_ids.size and self._is_synced:
            index = torch.as_tensor(host_ids, device=self.device).long()
            values = self._fold({name: getattr(self, name)[index] for name in self._template._defaults})
        else:
            flat, spec, n_folded = self._local_values(host_ids)
            values = tree_unflatten(flat, spec)
        if _TELEMETRY.enabled:
            # leaves folded = wrapped leaves gathered per selected slice
            _TELEMETRY.record_read(
                "sliced",
                self,
                duration_s=time.perf_counter() - t0,
                leaves=len(self._template._defaults) * int(host_ids.size),
                cache_hit=n_folded == 0,
                fanin=n_folded,
                freshness=self.freshness_stamp(),
            )
        return self._undonated((ids, values) if top_k is not None else values)

    def _top_ids(self, k: int, counts: Optional[Tensor] = None) -> Tensor:
        """Ids (int32) of the ``k`` fullest slices, in descending count with
        ties to the lower id (``lax.top_k``'s order; ``torch.topk`` promises
        no order on ties, a stable descending sort does), through the
        ``sliced_topk`` reader at ``k`` rounded up to a bucket: the
        ``k``-prefix of a larger ``k``'s order is the ``k`` order."""
        kb = round_up_bucket(k, self.num_slices)
        counts = self.slice_counts if counts is None else counts
        reader = self._readers.fast("sliced_topk", kb)
        if reader is None:

            def build():
                def read(c: Tensor) -> Tensor:
                    return torch.sort(c, descending=True, stable=True).indices[:kb].to(torch.int32)

                return read

            reader = self._readers.get("sliced_topk", build, counts, bucket=kb)
        # a copy: the reader's next replay overwrites its output
        return reader(counts)[:k].clone()

    def hot_slices(self, k: int = 10) -> Tuple[Tensor, Tensor]:
        """The ``k`` slices with the most ingested rows and each one's share
        of all ingested rows."""
        if not isinstance(k, int) or isinstance(k, bool) or k <= 0:
            raise MetricsUserError(f"`k` must be a positive int, got {k!r}")
        counts = self.slice_counts
        total = torch.clamp(counts.sum(dtype=torch.int32), min=1)
        ids = self._top_ids(min(k, self.num_slices), counts)
        return ids, counts[ids.long()].to(torch.float32) / total.to(torch.float32)

    def state_footprint(self, include_children: bool = True) -> Dict[str, int]:
        """Bytes per state, every key under ``"sliced/"``."""
        base = super().state_footprint(include_children=include_children)
        return {f"{SLICED_FOOTPRINT_PREFIX}{k}": v for k, v in base.items()}

    def __repr__(self) -> str:
        return f"{type(self).__name__}({type(self._template).__name__}(), num_slices={self.num_slices})"
