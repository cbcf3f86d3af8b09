"""Fused ``MetricCollection`` updates: one CUDA graph per batch signature.

Counterpart of ``metrics_tpu/core/fused.py``. A collection of N metrics
updated eagerly issues every member's kernels from Python, with the host
in the loop between each (and its value checks read back per update).
:class:`FusedUpdate` stitches every fusible member's update into ONE
``(states, batch) -> states`` function and, on the card, captures it once
per batch signature as a ``torch.cuda.CUDAGraph``; each later batch is a
few copies and one replay:

* **Static state buffers** -- the fused members' states live in buffers
  that the graph reads and ends by writing (``copy_``) the new states into.
  This plays the part of the JAX package's donation: callers must not hold
  references to state tensors across a fused update. ``compute()`` copies
  any result that would share a buffer (``Metric._undonated``), so a value
  it returned never changes under a later replay.
* **Signature-keyed cache** -- one entry per batch (shape, dtype, device)
  signature, static arguments, fused member set and state signature.
  Python floats are copied into static 0-d tensors (the JAX package traces
  them); ints, bools and strings stay static and key the cache. A one-time
  warning fires at 16 entries.
* **Pad-and-mask shape bucketing** -- with ``buckets=(...)`` a batch is
  edge-padded along its leading axis to the nearest bucket, so ragged
  batches share one graph. The pad rows replicate the last real row, so
  their contribution to a sum state, ``k_pad * delta(last_row)``, is
  subtracted inside the program (one more single-row update per member); a
  member flagged ``__fused_mask_valid__`` takes ``n_valid`` instead and
  masks its merge-like (sketch) and windowed leaves itself. Members with
  mean, custom or None-reduced states, bool sums, or the
  ``__fused_bucket_unsafe__`` flag decline bucketing.
* **Compute-group dedup** -- once groups are known, only group leaders run.
* **The eager leg** -- members flagged ``__jit_unsafe__``, wrappers and
  compositions (members with child metrics), list ("cat") states, sharded
  members (``Metric.shard_states``: their update is a collective) and
  members that fail the probe run their ordinary update in the same call,
  on the same card with the same kernels; ``declined`` names the probe's
  refusals, the members with child metrics and the sharded ones.
* **The probe** stands in for ``jax.eval_shape``: a member's update runs
  once per batch signature, on a copy of its state, under the capture rule
  of ``utils/checks.py`` and a function mode that raises on every call that
  reads a tensor's values on the host or makes a shape of them
  (``tolist``, ``item``, ``bool``/``int``/``float`` of a tensor,
  ``nonzero``, ``unique``, boolean-mask indexing); on the card it is then
  captured once more on a throwaway graph, which any other synchronisation
  fails. Both are local to the probing thread (``capture_error_mode=
  "thread_local"``), so other threads may synchronise meanwhile, which a
  process-wide ``set_sync_debug_mode("error")`` would forbid them. A member
  that passes the probe but then fails to capture raises; it is not moved
  to the eager leg. ``n_probes`` counts the probes run.
* **Manifest seeding** (``use_manifest``, default on): a member whose class
  the static analysis proved ``fusible``
  (``analysis/fusibility_manifest.json``) skips the probe -- the scratch
  state copy, the probe run and the trial capture -- for every signature;
  ``manifest_probe_skips`` counts the skips. ``unsafe``/``unknown`` classes
  and classes outside the package keep the probe. If a build that trusted
  the manifest fails (the capture on the card; on the CPU the entry's
  first run, which runs under the probe's function mode in its place), the
  handle warns that the manifest is stale, stops trusting it, re-probes
  the seeded members, runs the refuted ones on the eager leg (named in
  ``declined``) and retries the build once.
  ``METRICS_TPU_TORCH_VERIFY_MANIFEST=1`` probes every member anyway and
  warns where a ``fusible`` verdict fails its probe;
  ``METRICS_TPU_TORCH_NO_MANIFEST=1`` disables the seeding.

The ``_n_updates`` mean-merge counter is bumped inside the program. A graph
replays device work only, so the handle does each replay's host
bookkeeping: the installs and write epochs (``Metric._mark_fused_written``),
the buffers' in-place write counters (bumped, so host-side facts and memos
keyed on them lapse) and the launch counters (each graph's launches,
recorded at capture, are added to ``ops.launch_counts()`` per replay). A quantile sketch's host-side
occupancy bound is dropped from the state buffers, so a captured absorb
always takes the compact-then-select branch: the JAX package's
``lax.cond``, decided on the device, at the price of the compaction kernels
on every replay.

Capture runs on a side stream after warm-up runs there, which work on
scratch copies of the states (never the live ones), with
``capture_error_mode="thread_local"`` so the async worker
(``core/pipeline.py``) can capture; capture executes nothing, so the first
batch of a signature is one replay after its capture. The entries of a
handle share one memory pool. On the CPU there is no graph: the handle runs
the same fused function directly, its plain version (an entry's first run
under the probe's function mode, as a capture refuses host reads).

**Telemetry.** With the default recorder enabled, each dispatch records one
``fused_update`` event (and no member ``update`` events: the fused function
calls the members' ``_update``), the batch signature feeds the recompile
detector under ``MetricCollection.fused_update``, and each new cache entry
records one ``compile`` event: its warm-up and capture times and the bytes
its capture reserved in the pool (``pool_nbytes``, also the
``fused_compile`` cache plane). Nothing of it runs on the card or inside a
capture; disabled, it costs one bool check per dispatch.

Sliced metrics ride this path unchanged: their update is a fixed-shape
segment scatter, and an edge-padded row repeats the last row's slice id,
so the ``k * delta(last_row)`` correction lands in the slice the pad rows
polluted. Windowed metrics correct their pad rows in the live ring slot
themselves (``windowed/metric.py``), through ``n_valid``.
"""
import contextlib
import gc
import os
import time
import traceback
import weakref
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten, tree_unflatten

from metrics_tpu_torch.analysis.interp import VERDICT_FUSIBLE
from metrics_tpu_torch.analysis.manifest import ENV_VERIFY_MANIFEST, manifest_verdict
from metrics_tpu_torch.core.metric import _AUTO_COUNT, Metric, _to_device_inputs
from metrics_tpu_torch.observability.memory import register_cache_plane
from metrics_tpu_torch.observability.recorder import _DEFAULT_RECORDER as _TELEMETRY
from metrics_tpu_torch.ops.dispatch import add_launches, recording_launches
from metrics_tpu_torch.utils.checks import building_entry, capturing_checks
from metrics_tpu_torch.utils.data import dim_zero_max, dim_zero_min, dim_zero_sum
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from metrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor

#: one-time warning threshold for cache growth: an un-bucketed ragged
#: stream (or a per-batch static int) captures a graph per batch
_CACHE_WARN_ENTRIES = 16

#: runs of the fused function on the side stream, on scratch states, before
#: a capture (lazy library and allocator set-up happens outside the graph)
_WARMUP_RUNS = 2

#: the recompile detector's entry point for fused dispatches
FUSED_ENTRY = "MetricCollection.fused_update"

#: live handles, for the ``fused_compile`` cache plane
_LIVE_FUSED: "weakref.WeakSet[FusedUpdate]" = weakref.WeakSet()


def _fused_plane_nbytes() -> int:
    """Bytes the live handles' graphs hold on the card (their entries'
    ``pool_nbytes``)."""
    return sum(e.pool_nbytes for h in list(_LIVE_FUSED) for e in list(h._cache.values()))


class _HostReadError(RuntimeError):
    """A probed update read a tensor's values on the host."""


def _is_bool_index(index: Any) -> bool:
    items = index if isinstance(index, tuple) else (index,)
    return any(isinstance(i, Tensor) and i.dtype == torch.bool for i in items)


class _NoHostReads(TorchFunctionMode):
    """The probe's mode: raise on every call that would read a card
    tensor's values on the host or give an output shape that depends on
    them (the CPU has no synchronisation to catch)."""

    _READS = {
        "tolist",
        "item",
        "numpy",
        "__bool__",
        "__int__",
        "__float__",
        "__index__",
        "nonzero",
        "unique",
        "unique_consecutive",
        "masked_select",
        "argwhere",
    }

    def __torch_function__(self, func: Any, types: Any, args: Tuple = (), kwargs: Optional[Dict] = None) -> Any:
        name = getattr(func, "__name__", "")
        if name in self._READS or (name == "__getitem__" and len(args) > 1 and _is_bool_index(args[1])):
            raise _HostReadError(f"the update reads tensor values on the host ({name})")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _capturing(graph: Any, stream: Any, pool: Optional[Any] = None) -> Iterator[None]:
    """Capture the block into ``graph`` on ``stream``, for this thread only
    (other threads may run and synchronise meanwhile). The caller's current
    stream is restored whether the capture succeeds or not. Python's cyclic
    collector is off for the capture: a collection there could destroy an
    unreachable CUDA graph that some reference cycle held, and destroying a
    graph is a call that invalidates the capture.

    A capture that never ended is wound up here: torch neither stops
    routing the capture's allocations to its pool (``empty_cache()`` frees
    nothing of the default pool while any capture counts as underway) nor
    gives the pool back when the graph goes, so one failed trial capture (an
    update that cannot be captured, one that ran out of memory) otherwise
    kept every cached block, and its own, reserved for the life of the
    process."""
    pool = torch.cuda.graph_pool_handle() if pool is None else pool
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                try:
                    yield
                except BaseException:
                    try:
                        graph.capture_end()
                    except Exception:  # noqa: BLE001 -- the error being raised comes first
                        pass
                    raise
                graph.capture_end()
            except BaseException:
                try:
                    # answers once the capture has ended (then the graph
                    # gives its pool back itself, even where capture_end
                    # raised after it, as a warning turned error does)
                    graph.pool()
                except RuntimeError:
                    try:
                        torch._C._cuda_endAllocateToPool(stream.device.index, pool)
                    except RuntimeError:
                        pass  # capture_end got as far as ending the routing
                    torch._C._cuda_releasePool(stream.device.index, pool)
                raise
    finally:
        if collecting:
            gc.enable()


def _reason(err: BaseException) -> str:
    """An error and the innermost line of this package that raised it."""
    frames = [f for f in traceback.extract_tb(err.__traceback__) if "metrics_tpu_torch" in f.filename]
    if not frames:
        return f"{type(err).__name__}: {err}"
    path = frames[-1].filename.rsplit("metrics_tpu_torch", 1)[-1].lstrip("/")
    return f"{type(err).__name__}: {err} ({path}:{frames[-1].lineno})"


def _pure_update(metric: Metric, state: Dict[str, Any], args: Tuple, kwargs: Dict[str, Any]) -> Dict[str, Tensor]:
    """``(state, batch) -> state`` through the metric's ``_update``, without
    the counter bump (the fused program owns it)."""
    old = metric._bind(state)
    try:
        metric._update(*args, **kwargs)
        return {k: getattr(metric, k) for k in metric._defaults}
    finally:
        for k, v in old.items():
            object.__setattr__(metric, k, v)


def pad_correct(
    metric: Metric, new: Dict[str, Tensor], args: Tuple, kwargs: Dict[str, Any], k_pad: Tensor
) -> Dict[str, Tensor]:
    """``new`` without the edge-pad rows' share of its sum leaves. The pads
    replicate the last real row, so that share is ``k_pad * delta(last_row)``,
    the delta being the update of the defaults by that row; max/min leaves
    need nothing. ``kwargs`` are the metric's filtered keyword arguments."""
    leaves, spec = tree_flatten((args, kwargs))
    pad_args, pad_kwargs = tree_unflatten(
        [x[-1:] if isinstance(x, Tensor) and x.ndim >= 1 else x for x in leaves], spec
    )
    init = dict(metric._defaults)
    d = _pure_update(metric, dict(init), pad_args, pad_kwargs)
    out = dict(new)
    for s, v in new.items():
        if s != _AUTO_COUNT and metric._reductions[s] is dim_zero_sum:
            delta = d[s] - init[s]
            out[s] = v - delta * k_pad.to(delta.dtype)
    return out


def _state_tensor(metric: Metric, name: str) -> Tensor:
    """A state as a tensor (the eager counter's Python int becomes int32)."""
    val = getattr(metric, name)
    if isinstance(val, int):
        return torch.full((), val, dtype=torch.int32, device=metric.device)
    return val


def _state_sig(metric: Metric, name: str) -> Tuple:
    """(shape, dtype, device) of a state, read without materialising it."""
    val = getattr(metric, name)
    if isinstance(val, int):
        return ((), torch.int32, metric.device)
    return (tuple(val.shape), val.dtype, val.device)


def _bare(x: Tensor) -> Tensor:
    """``x`` without host-side facts attached (a sketch's occupancy bound):
    a view, so no copy."""
    return x.view_as(x)


def _states_of(metric: Metric) -> Dict[str, Tensor]:
    return {name: _bare(_state_tensor(metric, name)) for name in metric._defaults}


def _scratch(metric: Metric) -> Dict[str, Tensor]:
    """Copies of the metric's states, for runs whose result is dropped."""
    return {name: v.clone() for name, v in _states_of(metric).items()}


def _pad(x: Tensor, rows: int) -> Tensor:
    """Edge-pad ``x`` along its leading axis to ``rows``."""
    n = x.shape[0]
    if n == rows:
        return x
    return torch.cat([x, x[n - 1 :].expand((rows - n,) + tuple(x.shape[1:]))])


class _Entry:
    """One cache entry: the fused function and, on the card, its graph with
    the static buffers it reads and writes."""

    __slots__ = ("fn", "graph", "inputs", "n_valid", "states", "launches", "calls", "pool_nbytes")

    def __init__(self, fn: Any) -> None:
        self.fn = fn
        self.graph: Optional[Any] = None
        self.inputs: List[Tensor] = []
        self.n_valid: Optional[Tensor] = None
        self.states: Dict[str, Dict[str, Tensor]] = {}
        self.launches: Dict[str, int] = {}
        self.calls = 0
        #: bytes the capture reserved in the handle's pool plus the static
        #: inputs (0 without a graph)
        self.pool_nbytes = 0


class FusedUpdate:
    """Handle returned by :meth:`MetricCollection.compile_update`.

    Calling the handle (or ``collection.update(...)`` once compiled) runs
    the fused update. ``buckets`` enables pad-and-mask shape bucketing along
    axis 0. ``donate`` (default: on the card) installs the static state
    buffers themselves as the members' states; ``donate=False`` installs
    copies, so a caller may keep references across updates.
    ``use_manifest`` (default on) seeds fusibility from the static
    analysis' manifest: a ``fusible`` class skips the probe (see the module
    docstring); ``use_manifest=False`` probes every member.
    """

    def __init__(
        self,
        collection: Any,
        buckets: Optional[Sequence[int]] = None,
        donate: Optional[bool] = None,
        use_manifest: Optional[bool] = None,
    ) -> None:
        # weak: the collection holds the handle, and a strong back-reference
        # made a cycle that kept the graphs, pools and static buffers alive
        # until Python's cyclic collector ran
        self._collection_ref = weakref.ref(collection)
        self._buckets: Tuple[int, ...] = tuple(sorted(int(b) for b in buckets)) if buckets else ()
        if any(b <= 0 for b in self._buckets):
            raise ValueError(f"bucket sizes must be positive, got {self._buckets}")
        self._device = next(iter(collection.values())).device if len(collection) else torch.device("cpu")
        self._donate = self._device.type == "cuda" if donate is None else bool(donate)
        # manifest seeding, default on; `_use_manifest` drops to False when a
        # seeded build fails, while `_requested_manifest` keeps the request,
        # so warm reuse keeps matching (and an epoch loop does not rebuild a
        # manifest-trusting handle that re-hits the stale manifest)
        self._use_manifest = True if use_manifest is None else bool(use_manifest)
        self._requested_manifest = self._use_manifest
        self._cache: Dict[Tuple, _Entry] = {}
        self._fusible: Dict[Tuple, bool] = {}
        #: (name, sig) keys whose fusibility came from the manifest without
        #: a probe: the stale-manifest retry re-probes exactly these
        self._manifest_seeded: set = set()
        self.manifest_probe_skips = 0
        self.n_probes = 0
        self._bucket_ok: Dict[Tuple[str, ...], bool] = {}
        self._bucket_warned = False
        #: static state buffers, shared by the entries of one member set and
        #: state signature
        self._state_bufs: Dict[Tuple, Dict[str, Dict[str, Tensor]]] = {}
        self._pool: Optional[Any] = None
        self._capture_stream: Optional[Any] = None
        self.n_compiles = 0
        #: members the probe routed to the eager leg for some signature
        self._eager_names: set = set()
        #: why the probe declined each of them (the first error it met),
        #: and the wrappers and compositions (members with child metrics)
        self.declined: Dict[str, str] = {}
        _LIVE_FUSED.add(self)

    @property
    def _collection(self) -> Any:
        collection = self._collection_ref()
        if collection is None:
            raise MetricsUserError(
                "this fused update's MetricCollection is gone; call compile_update() on a live collection"
            )
        return collection

    # graphs, buffers and the collection back-reference are not copied:
    # MetricCollection.clone() drops the handle and the clone captures anew
    def __deepcopy__(self, memo: Dict) -> None:
        return None

    @property
    def cache_size(self) -> int:
        return len(self._cache)

    @property
    def donating(self) -> bool:
        """Whether the members' states ARE the graphs' static buffers, which
        each replay overwrites in place (the JAX package's donation)."""
        return self._donate

    def config_matches(
        self,
        buckets: Optional[Sequence[int]] = None,
        donate: Optional[bool] = None,
        use_manifest: Optional[bool] = None,
    ) -> bool:
        """True when a ``compile_update(...)`` request resolves to this
        handle's config: the warm reuse that keeps the captured graphs.
        ``use_manifest`` matches the request the handle was built with (a
        stale-manifest demotion does not break the match)."""
        want_buckets = tuple(sorted(int(b) for b in buckets)) if buckets else ()
        want_donate = self._device.type == "cuda" if donate is None else bool(donate)
        want_manifest = True if use_manifest is None else bool(use_manifest)
        return (
            self._buckets == want_buckets
            and self._donate == want_donate
            and self._requested_manifest == want_manifest
        )

    def donated_state_bytes(self) -> int:
        """State bytes a donating update owns: the group leaders that can
        reach the fused program (eager members keep their own buffers)."""
        if not self._donate:
            return 0
        col = self._collection
        names = [cg[0] for cg in col._groups.values()] if col._groups_checked else list(col._metrics)
        return sum(col._metrics[name].total_state_bytes() for name in names if not self._never_fused(name))

    @staticmethod
    def _static_unfusible(m: Metric) -> Optional[str]:
        """Why ``m`` never fuses, or None: ``__jit_unsafe__``, child metrics
        (a wrapper or a composition), list states, sharded states (their
        update is a collective: gloo cannot be captured, and a graph of
        NCCL ranks needs a card per rank)."""
        if m._children:
            return f"child metrics {sorted(dict(m._iter_child_metrics()))}"
        if m._shardings:
            return f"sharded states {sorted(m._shardings)} (a collective update)"
        if getattr(m, "__jit_unsafe__", False):
            return "__jit_unsafe__"
        if any(isinstance(v, list) for v in m._defaults.values()) or any(
            isinstance(getattr(m, k), list) for k in m._defaults
        ):
            return "list states"
        return None

    def _never_fused(self, name: str) -> bool:
        return self._static_unfusible(self._collection._metrics[name]) is not None or name in self._eager_names

    # ------------------------------------------------------------------
    # fusibility / bucket eligibility
    # ------------------------------------------------------------------
    def _is_fusible(self, name: str, args: Tuple, kwargs: Dict[str, Any], sig: Tuple) -> bool:
        m = self._collection._metrics[name]
        static = self._static_unfusible(m)
        if static is not None:
            if m._children or m._shardings:
                self.declined.setdefault(name, static)
            return False
        key = (name, sig)
        cached = self._fusible.get(key)
        if cached is not None:
            return cached
        verify = bool(os.environ.get(ENV_VERIFY_MANIFEST))
        if self._use_manifest and not verify and manifest_verdict(type(m)) == VERDICT_FUSIBLE:
            # the static analysis proved the class fusible: no probe
            self._fusible[key] = True
            self._manifest_seeded.add(key)
            self.manifest_probe_skips += 1
            return True
        ok = self._probe(name, m, args, kwargs)
        if verify and self._use_manifest and not ok and manifest_verdict(type(m)) == VERDICT_FUSIBLE:
            rank_zero_warn(
                f"fusibility manifest says `{type(m).__name__}` is fusible but the probe declines it"
                f" ({self.declined.get(name)}); the committed manifest is stale -- regenerate it with"
                " `python -m metrics_tpu_torch.analysis --manifest`.",
                UserWarning,
            )
        self._fusible[key] = ok
        if not ok:
            self._eager_names.add(name)
        return ok

    def _probe(self, name: str, m: Metric, args: Tuple, kwargs: Dict[str, Any]) -> bool:
        """One probe run on a copy of the state (and, on the card, a trial
        capture): host-dependent updates (value reads, data-dependent
        shapes) surface here. A refusal is named in ``declined``."""
        self.n_probes += 1
        try:
            fkw = m._filter_kwargs(**kwargs)
            with recording_launches(), capturing_checks():
                with _NoHostReads():
                    _pure_update(m, _scratch(m), args, fkw)
                if m.device.type == "cuda":
                    state = _scratch(m)
                    self._side_stream().wait_stream(torch.cuda.current_stream(m.device))
                    with _capturing(torch.cuda.CUDAGraph(), self._side_stream()):
                        _pure_update(m, state, args, fkw)
            return True
        except Exception as e:
            self.declined.setdefault(name, _reason(e))
            return False

    def _bucket_eligible(self, names: List[str]) -> bool:
        key = tuple(names)
        if key not in self._bucket_ok:
            self._bucket_ok[key] = self._bucket_eligible_uncached(names)
        return self._bucket_ok[key]

    def _bucket_eligible_uncached(self, names: List[str]) -> bool:
        for name in names:
            m = self._collection._metrics[name]
            if getattr(m, "__fused_bucket_unsafe__", False):
                return False
            mask_valid = bool(getattr(m, "__fused_mask_valid__", False))
            for sname, red in m._reductions.items():
                if sname == _AUTO_COUNT:
                    continue  # bumped once per batch; padding cannot skew it
                if mask_valid and (getattr(red, "merge_like", False) or getattr(red, "windowed_kind", None)):
                    # sketch leaves insert the pad rows with weight 0, and a
                    # windowed wrapper corrects its own slot: both via n_valid
                    continue
                if red not in (dim_zero_sum, dim_zero_max, dim_zero_min):
                    return False
                default = m._defaults[sname]
                if red is dim_zero_sum and default.dtype == torch.bool:
                    return False
        return True

    # ------------------------------------------------------------------
    # call path
    # ------------------------------------------------------------------
    def __call__(self, *args: Any, **kwargs: Any) -> None:
        self.dispatch(args, kwargs)

    def dispatch(self, args: Tuple, kwargs: Dict[str, Any]) -> None:
        """One fused update of a packed ``(args, kwargs)`` batch (the entry
        point of the async worker). On the card it issues copies and a graph
        replay on the current stream and reads nothing back; host work that
        synchronises is one-time (the probe, a capture, the first call's
        compute-group discovery) or belongs to the eager leg."""
        col = self._collection
        # one read of the flag: a recorder enabled mid-call records nothing
        recording = _TELEMETRY.enabled
        t0 = time.perf_counter() if recording else 0.0
        for m in col._metrics.values():
            # the synced states are the cross-rank reduction; the graphs'
            # static buffers wait in the metric's cache for unsync
            m._raise_if_synced()
        args = _to_device_inputs(args, self._device)
        kwargs = _to_device_inputs(kwargs, self._device)
        leaders = [cg[0] for cg in col._groups.values()] if col._groups_checked else list(col._metrics)

        leaves, spec = tree_flatten((args, kwargs))
        # floats are dynamic (a per-batch weight must not key the cache by
        # value); ints, bools and strings stay static
        dynamic = [isinstance(leaf, Tensor) or type(leaf) is float for leaf in leaves]
        dyn_idx = [i for i, d in enumerate(dynamic) if d]
        dyn = [leaves[i] for i in dyn_idx]
        static = tuple((i, leaf) for i, (leaf, d) in enumerate(zip(leaves, dynamic)) if not d)
        sig = tuple(_leaf_sig(x, self._device) for x in dyn)

        fused_names = [n for n in leaders if self._is_fusible(n, args, kwargs, sig)]
        fallback_names = [n for n in leaders if n not in fused_names]
        for name in fallback_names:
            m = col._metrics[name]
            m.update(*args, **m._filter_kwargs(**kwargs))
        bucket, cache_hit = None, False
        if fused_names:
            try:
                bucket, cache_hit = self._run_fused(fused_names, spec, dyn_idx, dyn, static, sig)
            except Exception:
                if not any((n, sig) in self._manifest_seeded for n in fused_names):
                    raise  # no static seed involved: a genuine failure, not a stale manifest
                # the stale-manifest retry: the build trusted a `fusible`
                # verdict that the capture refuted. Stop trusting the
                # manifest for this handle, re-probe the seeded members, run
                # the refuted ones on the eager leg and retry once.
                rank_zero_warn(
                    "fused update build failed for a manifest-seeded member set; the committed"
                    " fusibility manifest is stale. Probing every member of this collection from"
                    " now on -- regenerate it with `python -m metrics_tpu_torch.analysis --manifest`.",
                    UserWarning,
                )
                self._use_manifest = False
                for key in list(self._manifest_seeded):
                    self._fusible.pop(key, None)
                self._manifest_seeded.clear()
                retry = [n for n in fused_names if self._is_fusible(n, args, kwargs, sig)]
                for name in fused_names:
                    if name not in retry:
                        m = col._metrics[name]
                        m.update(*args, **m._filter_kwargs(**kwargs))
                fallback_names = fallback_names + [n for n in fused_names if n not in retry]
                fused_names = retry
                if fused_names:
                    bucket, cache_hit = self._run_fused(fused_names, spec, dyn_idx, dyn, static, sig)

        if not col._groups_checked and col._enable_compute_groups:
            # first-call group discovery on the concrete states (the eager
            # path's semantics); the next call fuses the leaders only
            col._merge_compute_groups()
            col._groups_checked = True

        if recording:
            _TELEMETRY.record_fused_update(
                n_metrics=len(col._metrics),
                n_fused=len(fused_names),
                n_fallback=len(fallback_names),
                duration_s=time.perf_counter() - t0,
                # the batch's leading-axis rows (a shape read): the windowed
                # ingest_rows series turns it into a rows/sec rate
                batch_rows=next((int(x.shape[0]) for x in dyn if isinstance(x, Tensor) and x.ndim >= 1), None),
                n_groups=len(col._groups) if col._groups_checked else None,
                bucket=bucket,
                cache_entries=len(self._cache),
                cache_hit=cache_hit,
                n_sliced=sum(1 for n in fused_names if getattr(col._metrics[n], "num_slices", None) is not None),
            )

    def _pick_bucket(self, dyn: List[Any], names: List[str]) -> Optional[int]:
        if not self._buckets:
            return None
        batched = [x for x in dyn if isinstance(x, Tensor) and x.ndim >= 1]
        if not batched:
            return None
        n = int(batched[0].shape[0])
        if n == 0 or any(int(x.shape[0]) != n for x in batched):
            return None
        if not self._bucket_eligible(names):
            if not self._bucket_warned:
                self._bucket_warned = True
                rank_zero_warn(
                    "compile_update: shape bucketing is disabled for this collection -- a fused metric carries"
                    " a mean/custom/None-reduced (or `__fused_bucket_unsafe__`) state with no exact pad"
                    " correction. Batches capture per exact shape instead.",
                    UserWarning,
                )
            return None
        return next((b for b in self._buckets if b >= n), None)

    def _run_fused(
        self, names: List[str], spec: Any, dyn_idx: List[int], dyn: List[Any], static: Tuple, sig: Tuple
    ) -> Tuple[Optional[int], bool]:
        """One fused update of the fusible leaders ``names``; returns the
        bucket it ran at and whether its cache entry existed."""
        col = self._collection
        bucket = self._pick_bucket(dyn, names)
        n_rows = None
        if bucket is not None:
            n_rows = next(int(x.shape[0]) for x in dyn if isinstance(x, Tensor) and x.ndim >= 1)
            sig = tuple(_leaf_sig(x, self._device, bucket) for x in dyn)
        state_sig = tuple(
            (name, k) + _state_sig(col._metrics[name], k) for name in names for k in col._metrics[name]._defaults
        )
        static_sig = tuple((i, repr(v)) for i, v in static)
        key = (tuple(names), spec, sig, static_sig, state_sig, bucket)

        entry = self._cache.get(key)
        cache_hit = entry is not None
        if entry is None:
            entry = _Entry(self._build(names, spec, dyn_idx, static, bucket))
            times = (0.0, 0.0)
            if self._device.type == "cuda":
                # a member that passed the probe but cannot be captured
                # raises here; it is not moved to the eager leg
                times = self._capture(entry, names, state_sig, dyn, bucket, n_rows)
            self._cache[key] = entry
            self.n_compiles += 1
            if _TELEMETRY.enabled:
                # one compile event per cache entry, priced entry by entry
                _TELEMETRY.record_compile(
                    f"{FUSED_ENTRY}[{self.n_compiles - 1}]",
                    trace_s=times[0],
                    compile_s=times[1],
                    memory={"pool_bytes": entry.pool_nbytes} if entry.graph is not None else None,
                    n_fused_metrics=len(names),
                    bucket=bucket,
                    donated=self._donate and entry.graph is not None,
                    captured=entry.graph is not None,
                )
            if len(self._cache) == _CACHE_WARN_ENTRIES:
                if _TELEMETRY.enabled:
                    _TELEMETRY.record_cache_plane(
                        "fused_compile",
                        entries=len(self._cache),
                        nbytes=sum(e.pool_nbytes for e in self._cache.values()),
                        reason="growth_warning",
                    )
                rank_zero_warn(
                    f"compile_update: the fused cache now holds {_CACHE_WARN_ENTRIES} entries -- shape-varying"
                    " batches (or a per-batch static argument such as a Python int) are capturing the fused"
                    " update repeatedly. Pass `compile_update(buckets=...)` to collapse ragged batch sizes,"
                    " and pass per-batch scalars as floats or 0-d tensors.",
                    UserWarning,
                )
        if _TELEMETRY.enabled:
            # bucketed shapes collapse to one signature here; un-bucketed
            # ragged batches accumulate and trip the recompile warning
            _TELEMETRY.track_signature(FUSED_ENTRY, signature=(sig, static_sig, bucket))
        entry.calls += 1
        if entry.graph is not None:
            new_states = self._replay(entry, names, dyn, n_rows)
        else:
            states = {name: _states_of(col._metrics[name]) for name in names}
            padded = [_pad(x, bucket) if isinstance(x, Tensor) and x.ndim >= 1 and bucket else x for x in dyn]
            padded = [
                torch.tensor(x, dtype=torch.float32, device=self._device) if type(x) is float else x for x in padded
            ]
            n_valid = None if bucket is None else torch.tensor(n_rows, dtype=torch.int32, device=self._device)
            # the plain version decides as the captured program does; its
            # first run builds the entry (once-per-entry hooks fire there)
            # and, as a capture would, refuses host reads
            building = entry.calls == 1
            try:
                with capturing_checks(), building_entry() if building else contextlib.nullcontext():
                    with _NoHostReads() if building else contextlib.nullcontext():
                        new_states = entry.fn(states, padded, n_valid)
            except Exception:
                if building:
                    # a failed build leaves no entry, as a failed capture
                    del self._cache[key]
                    self.n_compiles -= 1
                raise

        member_of = {cg[0]: cg for cg in col._groups.values()} if col._groups_checked else {}
        for name in names:
            for mname in member_of.get(name, [name]):
                # group members get the leader's new states too, as the
                # JAX package installs them
                m = col._metrics[mname]
                for k, v in new_states[name].items():
                    object.__setattr__(m, k, v)
                m._mark_fused_written(self._donate)
        return bucket, cache_hit

    def _build(self, names: List[str], spec: Any, dyn_idx: List[int], static: Tuple, bucket: Optional[int]) -> Any:
        """The fused ``(states, dyn leaves, n_valid) -> states`` function."""
        col_metrics = self._collection._metrics
        static_map = dict(static)
        n_leaves = len(static) + len(dyn_idx)

        def rebuild(dyn_leaves: List[Any]) -> Tuple[Tuple, Dict[str, Any]]:
            leaves: List[Any] = [None] * n_leaves
            for i, v in static_map.items():
                leaves[i] = v
            for pos, v in zip(dyn_idx, dyn_leaves):
                leaves[pos] = v
            return tree_unflatten(leaves, spec)

        def one_metric(
            name: str, state: Dict[str, Tensor], dyn_leaves: List[Tensor], k_pad: Optional[Tensor]
        ) -> Dict[str, Tensor]:
            m = col_metrics[name]
            args, kwargs = rebuild(dyn_leaves)
            fkw = m._filter_kwargs(**kwargs)
            call_kw = fkw
            if k_pad is not None and getattr(m, "__fused_mask_valid__", False):
                # merge-like (sketch) and windowed leaves mask the pad rows
                # themselves; the sum leaves still take the correction below
                call_kw = {**fkw, "n_valid": bucket - k_pad}
            new = _pure_update(m, state, args, call_kw)
            if k_pad is not None:
                new = pad_correct(m, new, args, fkw, k_pad)
            if _AUTO_COUNT in new:
                c = new[_AUTO_COUNT]
                new[_AUTO_COUNT] = torch.where(c < 0, c, c + 1)
            return new

        def fused(
            states: Dict[str, Dict[str, Tensor]], dyn_leaves: List[Tensor], n_valid: Optional[Tensor]
        ) -> Dict[str, Dict[str, Tensor]]:
            k_pad = None if n_valid is None else bucket - n_valid
            return {n: one_metric(n, states[n], dyn_leaves, k_pad) for n in names}

        return fused

    # ------------------------------------------------------------------
    # the card: capture and replay
    # ------------------------------------------------------------------
    def _side_stream(self) -> Any:
        """The handle's capture stream (warm-ups, probes and captures)."""
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self._device)
        return self._capture_stream

    def _capture(
        self,
        entry: _Entry,
        names: List[str],
        state_sig: Tuple,
        dyn: List[Any],
        bucket: Optional[int],
        n_rows: Optional[int],
    ) -> Tuple[float, float]:
        """Warm up and capture a new entry's graph; returns the warm-ups'
        and the capture's wall seconds."""
        col = self._collection
        device = self._device
        t0 = time.perf_counter()
        buf_key = (tuple(names), state_sig)
        bufs = self._state_bufs.get(buf_key)
        if bufs is None:
            bufs = self._state_bufs[buf_key] = {
                name: {k: v.clone() for k, v in _states_of(col._metrics[name]).items()} for name in names
            }
            try:
                return self._capture_into(entry, names, bufs, dyn, bucket, n_rows, t0)
            except BaseException:
                del self._state_bufs[buf_key]  # a failed capture keeps no buffers
                raise
        return self._capture_into(entry, names, bufs, dyn, bucket, n_rows, t0)

    def _capture_into(
        self,
        entry: _Entry,
        names: List[str],
        bufs: Dict[str, Dict[str, Tensor]],
        dyn: List[Any],
        bucket: Optional[int],
        n_rows: Optional[int],
        t0: float,
    ) -> Tuple[float, float]:
        device = self._device
        entry.states = bufs
        entry.inputs = [
            torch.empty(
                (bucket,) + tuple(x.shape[1:]) if bucket and x.ndim >= 1 else x.shape, dtype=x.dtype, device=device
            )
            if isinstance(x, Tensor)
            else torch.empty((), dtype=torch.float32, device=device)
            for x in dyn
        ]
        entry.n_valid = None if bucket is None else torch.empty((), dtype=torch.int32, device=device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        side = self._side_stream()
        caller = torch.cuda.current_stream(device)
        self._fill_inputs(entry, dyn, n_rows)
        side.wait_stream(caller)
        with torch.cuda.stream(side), capturing_checks():
            with recording_launches():
                for _ in range(_WARMUP_RUNS):
                    scratch = {n: {k: v.clone() for k, v in s.items()} for n, s in bufs.items()}
                    entry.fn(scratch, entry.inputs, entry.n_valid)
            del scratch
            side.synchronize()  # the warm-ups' memory is free before the capture
            t1 = time.perf_counter()
            reserved = torch.cuda.memory_stats(device).get("reserved_bytes.all.current", 0)
            graph = torch.cuda.CUDAGraph()
            with recording_launches() as launches, building_entry():
                with _capturing(graph, side, pool=self._pool):
                    new = entry.fn(bufs, entry.inputs, entry.n_valid)
                    for n in names:
                        for k, v in new[n].items():
                            buf = bufs[n][k]
                            if v.shape != buf.shape or v.dtype != buf.dtype:
                                raise RuntimeError(
                                    f"fused update: {n}.{k} changed from {tuple(buf.shape)} {buf.dtype} to"
                                    f" {tuple(v.shape)} {v.dtype} in one update; a captured graph needs fixed states"
                                )
                            if v is not buf:
                                buf.copy_(v)
                del new
        caller.wait_stream(side)
        t2 = time.perf_counter()
        entry.graph = graph
        entry.launches = dict(launches)
        grown = torch.cuda.memory_stats(device).get("reserved_bytes.all.current", 0) - reserved
        entry.pool_nbytes = max(int(grown), 0) + sum(t.numel() * t.element_size() for t in entry.inputs)
        return t1 - t0, t2 - t1

    def _fill_inputs(self, entry: _Entry, dyn: List[Any], n_rows: Optional[int]) -> None:
        """Copy a batch into the entry's static inputs (edge-padded)."""
        for buf, x in zip(entry.inputs, dyn):
            if not isinstance(x, Tensor):
                buf.fill_(x)
            elif x.ndim >= 1 and buf.shape[0] != x.shape[0]:
                n = x.shape[0]
                buf[:n].copy_(x)
                buf[n:].copy_(x[n - 1 :].expand((buf.shape[0] - n,) + tuple(x.shape[1:])))
            else:
                buf.copy_(x)
        if entry.n_valid is not None:
            entry.n_valid.fill_(n_rows)

    def _replay(
        self, entry: _Entry, names: List[str], dyn: List[Any], n_rows: Optional[int]
    ) -> Dict[str, Dict[str, Tensor]]:
        col = self._collection
        for name in names:
            m = col._metrics[name]
            for k, buf in entry.states[name].items():
                live = getattr(m, k)
                # a state replaced since the last replay (reset, an eager
                # update, a restore) is copied into the static buffer
                if isinstance(live, int):
                    buf.fill_(live)
                elif live is not buf:
                    buf.copy_(live)
        self._fill_inputs(entry, dyn, n_rows)
        entry.graph.replay()
        add_launches(entry.launches)
        if self._donate:
            # the replay wrote the buffers in place: their write counters
            # say so to host-side facts and memos keyed on them
            for states in entry.states.values():
                for buf in states.values():
                    torch.autograd.graph.increment_version(buf)
            return entry.states
        return {n: {k: v.clone() for k, v in s.items()} for n, s in entry.states.items()}


def _leaf_sig(x: Any, device: torch.device, bucket: Optional[int] = None) -> Tuple:
    if not isinstance(x, Tensor):
        return ((), torch.float32, device)
    shape = tuple(x.shape)
    if bucket is not None and x.ndim >= 1:
        shape = (bucket,) + shape[1:]
    return (shape, x.dtype, x.device)


# one plane per cache kind (see observability/memory.py): the graphs' pool
# bytes, summed over every live handle's entries
register_cache_plane("fused_compile", _fused_plane_nbytes)
