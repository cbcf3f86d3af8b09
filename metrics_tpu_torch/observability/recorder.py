"""Process-local metric telemetry: typed events, recompile detection,
sync accounting, and state-memory high-water marks.

The port's own copy of ``metrics_tpu/observability/recorder.py`` (that
module imports nothing of JAX; the port keeps its own copy, as it imports
nothing of ``metrics_tpu``). Three failure modes are invisible without
instrumentation until a job is slow:

* **Recaptures** -- an unpadded batch pipeline feeds a new ``(shape,
  dtype)`` signature every step. At a fused entry point
  (``MetricCollection.compile_update``) each one is a new CUDA graph
  capture; at an eager entry point it is only counted. The recorder
  tracks distinct argument signatures per entry point and warns once when
  a configurable threshold is crossed.
* **Cross-process syncs** -- every ``gather_all_arrays`` and
  ``sync_pytree`` records gather bytes, world size, and the pad waste of
  the pad-to-max uneven-shape contract.
* **Unbounded cat-state growth** -- list states grow per update;
  ``Metric.state_footprint()`` plus the opt-in ``footprint_warn_bytes``
  high-water-mark warning make the growth visible.

Zero-overhead contract: when the recorder is disabled (the default), the
only cost on the metric hot path is ONE attribute/bool check
(``_TELEMETRY.enabled``) -- no event objects are allocated, no timestamps
taken, no locks touched. Every recorder method is host-only: it reads
tensor metadata (shapes, dtypes, ``nbytes``), never tensor values, and
launches nothing, so a call made while a CUDA graph is being captured
records into the host stream and leaves the graph as it was.

The environment variable that switches the default recorder on is
``METRICS_TPU_TORCH_TELEMETRY`` (the JAX package's is
``METRICS_TPU_TELEMETRY``): a process that imports both packages switches
each on separately, and the two never append to one file. Event fields and
the Prometheus family names are the JAX package's, so one dashboard reads
either. Warnings and exports are rank-zero gated on the
``torch.distributed`` rank.
"""
from __future__ import annotations

import contextvars
import threading
import time
from typing import Any, Dict, List, Optional, Tuple



def rank_zero_warn(message: str, *args: Any, **kwargs: Any) -> None:
    """``metrics_tpu_torch.utils.prints.rank_zero_warn``, imported at the
    first warning (the prints module imports the distributed module, which
    imports this one)."""
    from metrics_tpu_torch.utils.prints import rank_zero_warn as warn

    kwargs.setdefault("stacklevel", 4)
    warn(message, *args, **kwargs)

#: ambient span stack (innermost last) — lives here rather than in
#: ``trace.py`` so the recorder can annotate every event with the active
#: span without importing the trace module (which imports this one).
#: Context-local (contextvars), so threads AND async tasks nest correctly.
_SPAN_STACK: "contextvars.ContextVar[Tuple[int, ...]]" = contextvars.ContextVar(
    "metrics_tpu_torch_span_stack", default=()
)


def current_span_id() -> Optional[int]:
    """Id of the innermost active :func:`metrics_tpu_torch.observability.span`,
    or ``None`` outside any span."""
    stack = _SPAN_STACK.get()
    return stack[-1] if stack else None

#: environment variable holding a JSONL path; when set, the default recorder
#: auto-enables at import and entry points append their events to that path
#: (see ``maybe_export_env``) — how ``bench.py``/``__graft_entry__.py``
#: thread one artifact through their subprocesses
TELEMETRY_ENV_VAR = "METRICS_TPU_TORCH_TELEMETRY"

#: core lifecycle event types; auxiliary events ("recompile_warning",
#: "footprint", "tracker_increment", "span", "compile", "fused_update",
#: and the async-pipeline "enqueue"/"dequeue"/"flush") ride the same stream
EVENT_TYPES = ("update", "compute", "forward", "sync")

#: footprint-HWM label for bytes pinned by the async update pipeline
#: (queued batch payloads + donated in-flight state buffers) — the memory
#: ``state_footprint()`` alone undercounts while an update is in flight
ASYNC_IN_FLIGHT_LABEL = "async_in_flight"

#: footprint keys under this prefix (SlicedMetric's [S]-leading states) are
#: attributed to a separate `<Metric>[sliced]` HWM label, so slice-axis
#: growth never masquerades as base-state growth in the high-water marks
SLICED_FOOTPRINT_PREFIX = "sliced/"

#: HWM-label suffix for the sliced split of a metric's footprint
SLICED_LABEL_SUFFIX = "[sliced]"


#: footprint keys under this prefix (fixed-capacity sketch leaves,
#: metrics_tpu/sketches/) are a BOUNDED budget, not an accumulation — the
#: HWM label split keeps them from masquerading as cat-state growth
SKETCH_FOOTPRINT_PREFIX = "sketch/"

#: HWM-label suffix for the sketch split of a metric's footprint
SKETCH_LABEL_SUFFIX = "[sketch]"

#: footprint keys under this prefix (WindowedMetric's [R]-leading ring /
#: decayed states, metrics_tpu/windowed/) are the R-fold window budget —
#: split to their own HWM label so window cost never masquerades as
#: base-state growth
WINDOWED_FOOTPRINT_PREFIX = "windowed/"

#: HWM-label suffix for the windowed split of a metric's footprint
WINDOWED_LABEL_SUFFIX = "[windowed]"


# ---------------------------------------------------------------------------
# standard time-series names (fed when a TimeSeriesRegistry is attached via
# ``attach_timeseries`` — see observability/timeseries.py). Defined HERE, not
# in timeseries.py, so the jax-free recorder module owns the vocabulary the
# health rules (observability/health.py) reference, the same way it owns the
# footprint prefixes.
# ---------------------------------------------------------------------------

#: per-call wall time distributions (ms) — one series per lifecycle phase
SERIES_UPDATE_MS = "update_ms"
SERIES_COMPUTE_MS = "compute_ms"
SERIES_FORWARD_MS = "forward_ms"
#: host wall time of one fused collection dispatch (ms)
SERIES_FUSED_DISPATCH_MS = "fused_dispatch_ms"
#: batch rows ingested through fused dispatches (counter — rolling rows/sec)
SERIES_INGEST_ROWS = "ingest_rows"
#: async pipeline: apply (dequeue->install) wall time per batch (ms)
SERIES_ASYNC_APPLY_MS = "async_apply_ms"
#: async pipeline: enqueue->apply age per batch (ms) — the live staleness
#: signal the bounded-staleness contract is about
SERIES_ASYNC_AGE_MS = "async_age_ms"
#: async pipeline: outstanding batches observed at enqueue/dequeue
SERIES_ASYNC_QUEUE_DEPTH = "async_queue_depth"
#: async pipeline: compute-snapshot staleness in unapplied batches
SERIES_ASYNC_STALENESS = "async_staleness_steps"
#: async pipeline: accepted / dropped batch counters
SERIES_ASYNC_ENQUEUED = "async_enqueued"
SERIES_ASYNC_DROPPED = "async_dropped"
#: new (shape, dtype) signatures at metric and fused entry points -- at a
#: fused entry each one is a new CUDA graph capture; a storm of them is the
#: classic ragged-batch failure mode the recompile alarm watches
SERIES_RECOMPILES = "recompiles"
#: sketch capacity-fill ratios reported from cold computes
SERIES_SKETCH_FILL = "sketch_fill_ratio"
#: sliced scatter: rows ingested (counter) and the per-batch share of rows
#: landing in the single hottest slice (hot-slice skew signal)
SERIES_SLICED_ROWS = "sliced_rows"
SERIES_HOT_SLICE_SHARE = "hot_slice_share"
#: exporter ticks that raised (PeriodicExporter hardening)
SERIES_EXPORT_ERRORS = "export_errors"
#: sampled model-score observations (fed by serving loops via
#: ``record_scores``) — the live distribution the drift alarm compares
#: against its frozen reference window
SERIES_SCORES = "scores"
#: fleet collector: worst per-publisher snapshot lag observed at a poll
#: (seconds behind the collector clock) — the ``publisher_stale`` signal
SERIES_PUBLISHER_LAG = "publisher_lag_s"
#: fleet collector: unfolded snapshots (queued files + in-window pending
#: deltas) observed at a poll — the ``snapshot_backlog`` signal
SERIES_COLLECTOR_BACKLOG = "collector_backlog"
#: fleet collector: fold errors (undecodable/foreign/mismatched/failed
#: snapshots) per poll — the ``fold_error`` signal
SERIES_FOLD_ERRORS = "collector_fold_errors"
#: read plane: reads served (counter — compute()/window_state()/
#: fold_values() calls, cache hits included)
SERIES_READS = "reads"
#: read plane: per-read wall time distribution (ms) — the ``read_latency``
#: alarm signal
SERIES_READ_MS = "read_ms"
#: read plane: fan-in (contributing publishers/states folded) per fleet read
SERIES_READ_FANIN = "read_fanin"
#: read plane: observed ingest-to-visible staleness per read (seconds) —
#: the ``freshness_slo`` alarm signal, fed from FreshnessStamp-carrying
#: reads (see observability/freshness.py)
SERIES_FRESHNESS_AGE_S = "freshness_age_s"
#: memory plane (observability/memory.py): live committed state bytes the
#: MemoryLedger attributes to metric state pytrees (dedup by buffer identity)
SERIES_MEM_LEDGER_BYTES = "mem_ledger_bytes"
#: memory plane: bytes held by registered cache planes (reader caches,
#: fused compile cache, retrieval layout LRU, sketch scratch, sliced value
#: cache) at an observation
SERIES_MEM_CACHE_BYTES = "mem_cache_plane_bytes"
#: memory plane: backend-reported bytes_in_use (host-RSS fallback on
#: backends that report no memory stats — see the observation's ``source``)
SERIES_MEM_DEVICE_BYTES = "mem_device_bytes_in_use"
#: memory plane: device_in_use − ledger − cache planes — the leak signal
#: the ``memory_leak`` alarm watches for monotone growth
SERIES_MEM_UNACCOUNTED = "mem_unaccounted_bytes"
#: memory plane: sliced state bytes per tenant (slice) — the
#: ``memory_budget`` alarm signal, ROADMAP item 3's headline denominator
SERIES_MEM_BYTES_PER_TENANT = "mem_bytes_per_tenant"

#: the standard counter-kind series; every other standard series is a
#: distribution (sketch-backed)
COUNTER_SERIES = (
    SERIES_INGEST_ROWS,
    SERIES_ASYNC_ENQUEUED,
    SERIES_ASYNC_DROPPED,
    SERIES_RECOMPILES,
    SERIES_SLICED_ROWS,
    SERIES_EXPORT_ERRORS,
    SERIES_FOLD_ERRORS,
    SERIES_READS,
)


def _new_sliced_totals() -> Dict[str, int]:
    return {"scatter_events": 0, "rows": 0, "max_slices": 0}


def _new_memory_totals() -> Dict[str, Any]:
    """Zeroed memory-plane counters: boundary/observation/cache-plane event
    counts and layout-cache eviction tallies (extensive — summed across
    hosts) plus last-seen and high-water gauges for the ledger, the cache
    planes, the backend in-use bytes, the unaccounted residue, and the
    bytes/tenant headline (maxed across hosts). All host ints/floats —
    TL-STATE-clean, never traced, never device-resident."""
    return {
        "events": 0,
        "update_boundaries": 0,
        "compute_boundaries": 0,
        "reset_boundaries": 0,
        "observations": 0,
        "cache_plane_events": 0,
        "plane_evictions": 0,
        "plane_evicted_bytes": 0,
        "ledger_bytes": 0,
        "max_ledger_bytes": 0,
        "cache_plane_bytes": 0,
        "max_cache_plane_bytes": 0,
        "device_bytes_in_use": 0,
        "max_device_bytes_in_use": 0,
        "unaccounted_bytes": 0,
        "max_unaccounted_bytes": 0,
        "boundary_live_bytes": 0,
        "max_boundary_live_bytes": 0,
        "bytes_per_tenant": 0.0,
        "max_bytes_per_tenant": 0.0,
    }


def _new_read_totals() -> Dict[str, float]:
    """Zeroed read-plane counters: reads served and what they folded
    (extensive — summed across hosts) plus high-water gauges for the
    worst read latency and the widest fleet fan-in (maxed across hosts)."""
    return {
        "reads": 0,
        "cache_hits": 0,
        "leaves_folded": 0,
        "ring_buckets_folded": 0,
        "table_rows_unpacked": 0,
        "fanin": 0,
        "read_s_total": 0.0,
        "max_read_ms": 0.0,
        "max_fanin": 0,
    }


def _new_freshness_totals() -> Dict[str, Any]:
    """Zeroed freshness aggregates, merged via MIN/MAX identity like the
    gauge families: ``min_event_t``/``max_event_t`` (wall clock of the
    oldest/newest contribution visible to any read; ``None`` until a
    stamped read happens — the identity element) plus high-water gauges
    for the observed staleness components."""
    return {
        "stamps": 0,
        "min_event_t": None,
        "max_event_t": None,
        "max_staleness_s": 0.0,
        "max_async_age_s": 0.0,
        "max_ring_span_s": 0.0,
        "max_watermark_lag_s": 0.0,
    }


def _new_sketch_totals() -> Dict[str, float]:
    """Zeroed sketch counters: cross-rank/pairwise sketch merges performed
    (extensive — summed across hosts) plus last-seen and high-water
    capacity-fill ratio gauges (maxed across hosts)."""
    return {"merges": 0, "fill_ratio": 0.0, "max_fill_ratio": 0.0}


def _new_fleet_totals() -> Dict[str, float]:
    """Zeroed fleet-collector counters: snapshot ingest outcomes and fold
    errors (extensive — summed across hosts) plus last-seen and high-water
    gauges for the backlog and the worst publisher lag."""
    return {
        "absorbed": 0,
        "duplicates": 0,
        "late_dropped": 0,
        "fold_errors": 0,
        "backlog": 0,
        "max_backlog": 0,
        "publisher_lag_s": 0.0,
        "max_publisher_lag_s": 0.0,
        "publishers": 0,
    }


def _new_async_totals() -> Dict[str, int]:
    """Zeroed async-pipeline counters: extensive batch counts (enqueued/
    applied/dropped/flushes — summed across hosts) plus last-seen and
    high-water gauges for queue depth, compute staleness, and in-flight
    bytes."""
    return {
        "enqueued": 0,
        "applied": 0,
        "dropped": 0,
        "flushes": 0,
        "queue_depth": 0,
        "max_queue_depth": 0,
        "staleness_steps": 0,
        "max_staleness_steps": 0,
        "in_flight_bytes": 0,
        "max_in_flight_bytes": 0,
    }


def _signature_of(args: Any, kwargs: Any) -> Tuple:
    """The ``(shape, dtype)`` signature of every array leaf in a call's
    arguments -- the key a fused update's graph cache discriminates on, so
    a growing set of signatures at one entry point means recaptures."""
    parts: List[Tuple] = []

    def walk(obj: Any) -> None:
        shape = getattr(obj, "shape", None)
        dtype = getattr(obj, "dtype", None)
        if shape is not None and dtype is not None:
            # torch's "torch.float32" is recorded as "float32", the name
            # numpy and the JAX package give the same dtype
            parts.append((tuple(shape), str(dtype).replace("torch.", "")))
        elif isinstance(obj, (list, tuple)):
            for o in obj:
                walk(o)
        elif isinstance(obj, dict):
            try:
                items = sorted(obj.items())
            except TypeError:
                items = list(obj.items())
            for _, o in items:
                walk(o)

    walk(args)
    if kwargs:
        walk(kwargs)
    return tuple(parts)


def _nbytes(value: Any) -> int:
    """Best-effort nbytes of an array from its metadata (``numel *
    element_size`` of a tensor; no read of its values). An array that
    reports itself deleted counts 0, as the JAX package's donated buffers
    do."""
    is_deleted = getattr(value, "is_deleted", None)
    if callable(is_deleted):
        try:
            if is_deleted():
                return 0
        except Exception:  # noqa: BLE001 — foreign array types may refuse
            pass
    nb = getattr(value, "nbytes", None)
    if isinstance(nb, int):
        return nb
    size = getattr(value, "size", None)
    dtype = getattr(value, "dtype", None)
    if size is not None and dtype is not None:
        try:
            return int(size) * int(dtype.itemsize)
        except (TypeError, AttributeError):
            return 0
    return 0


class MetricRecorder:
    """Collects typed telemetry events from the metric runtime.

    Not a per-metric object: ONE recorder observes every metric in the
    process (the registry in ``metrics_tpu_torch.observability`` hands out named
    instances; the ``"default"`` one is wired into the runtime hot paths).

    The public surface intended for users is ``enable()``/``disable()``/
    ``reset()``, the read accessors (``events``/``call_counts``/
    ``signature_counts``/``sync_totals``), and the exporters
    (``export_jsonl``/``render_prometheus``/``summary``). The ``record_*``
    methods are the runtime's hook points; callers must check ``.enabled``
    first — that check IS the zero-overhead gate.
    """

    DEFAULT_RECOMPILE_THRESHOLD = 8
    MAX_EVENTS = 200_000
    #: minimum seconds between emitted ``memory`` event rows per boundary
    #: kind — the boundary counters stay exact, only the stream is paced
    MEMORY_EVENT_INTERVAL_S = 0.25

    def __init__(
        self,
        name: str = "default",
        recompile_threshold: int = DEFAULT_RECOMPILE_THRESHOLD,
        footprint_warn_bytes: Optional[int] = None,
        profile_compiles: bool = False,
    ) -> None:
        self.name = name
        self.enabled = False
        self.recompile_threshold = recompile_threshold
        self.footprint_warn_bytes = footprint_warn_bytes
        #: opt-in capture-cost attribution: when True, every NEW call
        #: signature at a metric entry point is billed by capturing the
        #: metric's pure update as a CUDA graph and recording a ``compile``
        #: event with its capture time and pool bytes (see
        #: observability/profiling.py)
        self.profile_compiles = profile_compiles
        self._lock = threading.Lock()
        self._t0 = time.time()
        self._events: List[Dict[str, Any]] = []
        self._dropped = 0
        self._counts: Dict[Tuple[str, str], int] = {}
        self._times: Dict[Tuple[str, str], float] = {}
        self._signatures: Dict[str, set] = {}
        self._recompile_warned: set = set()
        self._footprint_warned: set = set()
        self._footprint_hwm: Dict[str, int] = {}
        self._sync_bytes = 0
        self._pad_waste_bytes = 0
        self._sync_events = 0
        self._compile_counts: Dict[str, int] = {}
        self._compile_times: Dict[str, float] = {}
        self._fused_updates = 0
        self._fused_metric_updates = 0
        self._fused_fallback_updates = 0
        self._async = _new_async_totals()
        self._sliced = _new_sliced_totals()
        self._sliced_slice_counts: Dict[str, int] = {}
        self._sketch = _new_sketch_totals()
        self._reads = _new_read_totals()
        self._freshness = _new_freshness_totals()
        self._memory = _new_memory_totals()
        #: per-boundary-kind wall clock of the last emitted ``memory`` event
        #: — boundary COUNTERS are exact, boundary EVENT rows are throttled
        #: to MEMORY_EVENT_INTERVAL_S so an eager update loop cannot flood
        #: the ring buffer with byte snapshots
        self._memory_last_event: Dict[str, float] = {}
        #: "source|stat" -> last observed drift score (gauges; fed by the
        #: health layer's DriftRule evaluations — see record_drift_score)
        self._drift: Dict[str, float] = {}
        self._fleet = _new_fleet_totals()
        #: "op|backend" -> dispatches through the ops kernel registry
        #: (ops/dispatch.py) — which backends actually ran kernels vs
        #: fallbacks; see record_ops_dispatch
        self._ops_dispatch: Dict[str, int] = {}
        self._export_errors = 0
        #: monotonic provenance sequence for exported counter payloads —
        #: see ``next_snapshot_seq`` / ``aggregate.counter_payload``
        self._snapshot_seq = 0
        #: tid -> thread name, registered as events from new threads arrive —
        #: export_perfetto emits these as thread_name metadata so the async
        #: worker's spans land on their own labeled track
        self._thread_names: Dict[int, str] = {}
        #: attached TimeSeriesRegistry (None = the windowed layer is off and
        #: costs one attribute check per hook) — see attach_timeseries()
        self.timeseries: Optional[Any] = None
        # per-thread compute-group attribution: a shared field would let
        # concurrent MetricCollection.update calls cross-attribute events
        self._group_local = threading.local()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def enable(
        self,
        recompile_threshold: Optional[int] = None,
        footprint_warn_bytes: Optional[int] = None,
        profile_compiles: Optional[bool] = None,
    ) -> "MetricRecorder":
        if recompile_threshold is not None:
            self.recompile_threshold = recompile_threshold
        if footprint_warn_bytes is not None:
            self.footprint_warn_bytes = footprint_warn_bytes
        if profile_compiles is not None:
            self.profile_compiles = profile_compiles
        self.enabled = True
        return self

    def disable(self) -> "MetricRecorder":
        self.enabled = False
        return self

    def attach_timeseries(self, registry: Optional[Any] = None, **kwargs: Any) -> Any:
        """Attach a :class:`~metrics_tpu_torch.observability.timeseries.
        TimeSeriesRegistry` (created from ``**kwargs`` when not given) and
        start feeding the standard windowed series (``SERIES_*``) from the
        recorder's hooks. Returns the registry. Idempotent-friendly: a
        second call replaces the registry."""
        if registry is None:
            from metrics_tpu_torch.observability.timeseries import TimeSeriesRegistry

            registry = TimeSeriesRegistry(**kwargs)
        self.timeseries = registry
        return registry

    def detach_timeseries(self) -> "MetricRecorder":
        """Stop feeding windowed series (the registry is dropped)."""
        self.timeseries = None
        return self

    def tick(self) -> int:
        """Deferred telemetry housekeeping: fold the attached time-series'
        pending observations into their bucket sketches now, instead of
        letting the bounded inline flush fire inside a latency-sensitive
        read. Serving loops call this between probe reads; it is a no-op
        (returning 0) with no registry attached."""
        ts = self.timeseries
        if ts is None:
            return 0
        try:
            return int(ts.housekeep())
        except Exception:  # noqa: BLE001 — telemetry must never take down the hot path
            return 0

    def _observe(self, name: str, value: float) -> None:
        """Feed one observation into the attached registry (no-op when
        detached). Called OUTSIDE the recorder lock — the registry has its
        own leaf lock and never calls back into the recorder."""
        ts = self.timeseries
        if ts is not None:
            try:
                ts.observe(name, value, kind="counter" if name in COUNTER_SERIES else "distribution")
            except Exception:  # noqa: BLE001 — telemetry must never take down the hot path
                pass

    def reset(self) -> "MetricRecorder":
        with self._lock:
            self._t0 = time.time()
            self._events = []
            self._dropped = 0
            self._counts = {}
            self._times = {}
            self._signatures = {}
            self._recompile_warned = set()
            self._footprint_warned = set()
            self._footprint_hwm = {}
            self._sync_bytes = 0
            self._pad_waste_bytes = 0
            self._sync_events = 0
            self._compile_counts = {}
            self._compile_times = {}
            self._fused_updates = 0
            self._fused_metric_updates = 0
            self._fused_fallback_updates = 0
            self._async = _new_async_totals()
            self._sliced = _new_sliced_totals()
            self._sliced_slice_counts = {}
            self._sketch = _new_sketch_totals()
            self._reads = _new_read_totals()
            self._freshness = _new_freshness_totals()
            self._memory = _new_memory_totals()
            self._memory_last_event = {}
            self._drift = {}
            self._fleet = _new_fleet_totals()
            self._ops_dispatch = {}
            self._export_errors = 0
            # the snapshot sequence survives reset ON PURPOSE: provenance
            # must stay monotonic for the publisher's whole lifetime, or a
            # collector's dedup would see post-reset payloads as replays
            self._thread_names = {}
            self._group_local = threading.local()
        # the windowed layer stays ATTACHED across reset (long jobs reset the
        # event buffer periodically; the ring is fixed-capacity and must keep
        # observing) but its data clears with everything else
        ts = self.timeseries
        if ts is not None:
            ts.reset()
        return self

    # ------------------------------------------------------------------
    # read accessors
    # ------------------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def call_counts(self) -> Dict[Tuple[str, str], int]:
        with self._lock:
            return dict(self._counts)

    def call_times(self) -> Dict[Tuple[str, str], float]:
        with self._lock:
            return dict(self._times)

    def signature_counts(self) -> Dict[str, int]:
        with self._lock:
            return {k: len(v) for k, v in self._signatures.items()}

    def sync_totals(self) -> Dict[str, int]:
        with self._lock:
            return {
                "sync_events": self._sync_events,
                "gather_bytes": self._sync_bytes,
                "pad_waste_bytes": self._pad_waste_bytes,
            }

    def footprint_high_water_marks(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._footprint_hwm)

    def compile_counts(self) -> Dict[str, int]:
        """Recorded captures per entry point (``compile`` events)."""
        with self._lock:
            return dict(self._compile_counts)

    def compile_times(self) -> Dict[str, float]:
        """Cumulative capture wall seconds per entry point."""
        with self._lock:
            return dict(self._compile_times)

    def fused_update_totals(self) -> Dict[str, int]:
        """Aggregate fused-collection-update counters: batches dispatched
        through the fused path, metric updates served inside fused kernels,
        and metric updates that fell back to the eager loop."""
        with self._lock:
            return {
                "fused_updates": self._fused_updates,
                "fused_metric_updates": self._fused_metric_updates,
                "fallback_metric_updates": self._fused_fallback_updates,
            }

    def async_totals(self) -> Dict[str, int]:
        """Async-pipeline counters: batches enqueued/applied/dropped and
        flush count (extensive), plus last-seen and high-water gauges for
        queue depth, compute-snapshot staleness, and in-flight bytes."""
        with self._lock:
            return dict(self._async)

    def sliced_totals(self) -> Dict[str, int]:
        """Sliced-scatter counters: segment-scatter updates recorded (once
        per eager update, once per TRACE under the fused kernel), total rows
        scattered, and the largest slice count seen."""
        with self._lock:
            return dict(self._sliced)

    def sketch_totals(self) -> Dict[str, float]:
        """Sketch-state counters: cross-rank/pairwise sketch merges
        performed, plus the last-seen and high-water capacity-fill ratios
        reported from the compute path."""
        with self._lock:
            return dict(self._sketch)

    def footprint_slice_counts(self) -> Dict[str, int]:
        """``num_slices`` per ``<Metric>[sliced]`` HWM label — what the
        summary exporter divides by for the per-slice average."""
        with self._lock:
            return dict(self._sliced_slice_counts)

    def drift_scores(self) -> Dict[str, float]:
        """Last observed drift score per ``"source|stat"`` key (the
        ``metrics_tpu_drift_score{metric,stat}`` Prometheus family's raw
        data; gauges — merged max-wise across hosts)."""
        with self._lock:
            return dict(self._drift)

    def fleet_totals(self) -> Dict[str, float]:
        """Fleet-collector counters: snapshot ingest outcomes (absorbed/
        duplicates/late_dropped — extensive), fold errors, plus last-seen
        and high-water gauges for the unfolded backlog and the worst
        publisher lag. Fed by ``FleetCollector`` polls via
        ``record_fleet_poll``."""
        with self._lock:
            return dict(self._fleet)

    def read_totals(self) -> Dict[str, float]:
        """Read-plane counters: reads served (cache hits included) and what
        they folded — state leaves, ring buckets, retrieval-table rows —
        plus high-water gauges for the worst read latency and the widest
        fleet fan-in. Fed by ``record_read`` from every ``compute()``/
        ``window_state()``/``fold_values()`` entry point."""
        with self._lock:
            return dict(self._reads)

    def freshness_totals(self) -> Dict[str, Any]:
        """Freshness aggregates from stamped reads: wall clock of the
        oldest/newest contribution any read saw (``None`` identity until a
        stamped read happens) plus high-water staleness-component gauges.
        Merged across hosts via min/max identity like the gauge families."""
        with self._lock:
            return dict(self._freshness)

    def memory_totals(self) -> Dict[str, Any]:
        """Memory-plane counters: update/compute/reset boundary tallies,
        observatory polls, cache-plane events and eviction totals
        (extensive), plus last-seen and high-water gauges for the ledger
        bytes, the cache-plane inventory, the backend in-use bytes, the
        unaccounted residue, and bytes/tenant. Fed by
        ``record_memory_boundary`` / ``record_memory_observation`` /
        ``record_cache_plane`` — see observability/memory.py."""
        with self._lock:
            return dict(self._memory)

    def ops_dispatch_totals(self) -> Dict[str, int]:
        """Kernel-registry dispatches per ``"op|backend"`` key (backend in
        ``pallas | jnp | interpret``) — the raw data behind the Prometheus
        family ``metrics_tpu_ops_dispatch_total{op,backend}``. Extensive:
        summed across hosts by ``aggregate_across_hosts``."""
        with self._lock:
            return dict(self._ops_dispatch)

    def next_snapshot_seq(self) -> int:
        """The next monotonic provenance sequence number for an exported
        counter payload / fleet snapshot from this process. Monotonic for
        the recorder's lifetime (``reset()`` does NOT rewind it — a
        collector's duplicate detection keys on it)."""
        with self._lock:
            seq = self._snapshot_seq
            self._snapshot_seq += 1
            return seq

    def export_errors(self) -> int:
        """Exporter ticks that raised (see ``PeriodicExporter``) — a
        nonzero count means telemetry artifacts may be stale."""
        with self._lock:
            return self._export_errors

    def thread_names(self) -> Dict[int, str]:
        """tid -> thread name for every thread that recorded a span or an
        async-pipeline event (Perfetto track labeling)."""
        with self._lock:
            return dict(self._thread_names)

    def dropped_events(self) -> int:
        """Events discarded after the MAX_EVENTS buffer cap (aggregate
        counters still include them; the JSONL stream does not)."""
        with self._lock:
            return self._dropped

    # ------------------------------------------------------------------
    # hook points (callers check ``.enabled`` first)
    # ------------------------------------------------------------------
    def _append(self, event: Dict[str, Any]) -> None:
        # caller holds the lock
        stack = _SPAN_STACK.get()
        if stack and "span_id" not in event:
            # attribute every event to the innermost active trace span so
            # flat rows ("an update inside a collection forward inside a
            # sync") regain their nesting in post-hoc analysis
            event["span_id"] = stack[-1]
        if len(self._events) >= self.MAX_EVENTS:
            self._dropped += 1
            if self._dropped == 1:
                # surface the cap the moment it first bites — a silently
                # truncated JSONL artifact would misread as complete coverage
                rank_zero_warn(
                    f"Telemetry: the event buffer reached its {self.MAX_EVENTS}-event"
                    " cap; further events are dropped (aggregate counters keep"
                    " counting). Export and reset() periodically for long runs."
                    " The dropped count is reported by dropped_events(), summary(),"
                    " and the Prometheus page.",
                    UserWarning,
                )
            return
        self._events.append(event)

    def record_call(
        self,
        phase: str,
        metric: Any,
        duration_s: float,
        args: Tuple = (),
        kwargs: Optional[Dict[str, Any]] = None,
    ) -> bool:
        """Record one update/compute/forward lifecycle call with its wall
        time and argument signature (and feed recompile detection).

        Returns True when the call carried a signature NOT seen before at
        this entry point; the caller may then attribute the capture cost
        (see ``profile_compiles``)."""
        label = type(metric).__name__
        sig = _signature_of(args, kwargs) if (args or kwargs) else ()
        with self._lock:
            key = (label, phase)
            self._counts[key] = self._counts.get(key, 0) + 1
            self._times[key] = self._times.get(key, 0.0) + duration_s
            event: Dict[str, Any] = {
                "type": phase,
                "metric": label,
                "t": round(time.time() - self._t0, 6),
                "dur_ms": round(duration_s * 1e3, 4),
                "n_calls": self._counts[key],
            }
            if sig:
                # events store at most 8 leaves (detection-style structured
                # inputs carry thousands); recompile detection below keys on
                # the FULL tuple regardless
                event["signature"] = [[list(shape), dtype] for shape, dtype in sig[:8]]
                if len(sig) > 8:
                    event["signature_leaves"] = len(sig)
            group = getattr(self._group_local, "group", None)
            if group is not None:
                event["compute_group"] = list(group)
            self._append(event)
        if phase in ("update", "compute", "forward"):
            # windowed per-phase latency distributions (SERIES_UPDATE_MS ...)
            self._observe(f"{phase}_ms", duration_s * 1e3)
        if sig and phase in ("update", "forward"):
            return self.track_signature(f"{label}.{phase}", signature=sig)
        return False

    def track_signature(self, entry: str, *args: Any, signature: Optional[Tuple] = None, **kwargs: Any) -> bool:
        """Note one call signature for an entry point; warn (once per
        entry, rank-zero) when the distinct-signature count crosses
        ``recompile_threshold`` -- the classic "unpadded batch -> recapture
        every step" bug. Users of the functional API can call this
        directly with their arguments.

        Returns True when the signature is NEW for this entry point (a
        capture at a fused entry), False for a cache hit."""
        sig = signature if signature is not None else _signature_of(args, kwargs)
        with self._lock:
            seen = self._signatures.setdefault(entry, set())
            before = len(seen)
            seen.add(sig)
            is_new = len(seen) > before
            crossed = (
                is_new
                and len(seen) > self.recompile_threshold
                and entry not in self._recompile_warned
            )
            if crossed:
                self._recompile_warned.add(entry)
                n = len(seen)
                self._append(
                    {
                        "type": "recompile_warning",
                        "entry": entry,
                        "distinct_signatures": n,
                        "threshold": self.recompile_threshold,
                        "t": round(time.time() - self._t0, 6),
                    }
                )
        if crossed:
            rank_zero_warn(
                f"Telemetry: entry point `{entry}` has now seen {n} distinct"
                f" (shape, dtype) argument signatures (threshold"
                f" {self.recompile_threshold}). Every new signature at a fused update"
                " captures a new CUDA graph -- pad or bucket your batches"
                " to a fixed shape, or raise the threshold via"
                " `get_recorder().enable(recompile_threshold=...)` if the shapes"
                " are genuinely static-bounded.",
                UserWarning,
            )
        if is_new:
            # every new signature is a capture trigger -- the windowed rate
            # of this counter is the recompile-storm signal
            self._observe(SERIES_RECOMPILES, 1)
        return is_new

    def record_compile(
        self,
        entry: str,
        trace_s: float = 0.0,
        lower_s: float = 0.0,
        compile_s: float = 0.0,
        cost: Optional[Dict[str, float]] = None,
        memory: Optional[Dict[str, int]] = None,
        **extra: Any,
    ) -> None:
        """Record one attributed capture: the wall-time breakdown (in the
        port ``trace_s`` is the warm-up runs, ``compile_s`` the graph
        capture) plus the cost analysis (FLOPs where the profiler counts
        them) and the bytes of the graph's memory pool. Emitted by :func:`metrics_tpu_torch.observability.compiled_cost`
        and by the recompile hook in ``core/metric.py`` (when
        ``profile_compiles`` is on) — turning the recompile warning's count
        into a bill."""
        total_s = float(trace_s) + float(lower_s) + float(compile_s)
        with self._lock:
            self._compile_counts[entry] = self._compile_counts.get(entry, 0) + 1
            self._compile_times[entry] = self._compile_times.get(entry, 0.0) + total_s
            event: Dict[str, Any] = {
                "type": "compile",
                "entry": entry,
                "t": round(time.time() - self._t0, 6),
                "trace_ms": round(float(trace_s) * 1e3, 4),
                "lower_ms": round(float(lower_s) * 1e3, 4),
                "compile_ms": round(float(compile_s) * 1e3, 4),
                "n_compiles": self._compile_counts[entry],
            }
            if cost:
                event["cost_analysis"] = cost
            if memory:
                event["memory_analysis"] = memory
            event.update(extra)
            self._append(event)

    def record_sync(
        self,
        source: str,
        gather_bytes: int,
        world_size: int,
        pad_waste_bytes: int = 0,
        **extra: Any,
    ) -> None:
        """Record one cross-device/cross-process state synchronization.

        ``gather_bytes`` is the bytes of synced state received per
        participant (concat/gather states count ``world_size`` shards;
        all-reduced states count one payload). ``pad_waste_bytes`` is the
        portion of those bytes that is pad-to-max padding, not data.
        """
        with self._lock:
            self._sync_events += 1
            self._sync_bytes += int(gather_bytes)
            self._pad_waste_bytes += int(pad_waste_bytes)
            event = {
                "type": "sync",
                "source": source,
                "gather_bytes": int(gather_bytes),
                "world_size": int(world_size),
                "pad_waste_bytes": int(pad_waste_bytes),
                "t": round(time.time() - self._t0, 6),
            }
            event.update(extra)
            self._append(event)

    def record_footprint(self, metric: Any, footprint: Dict[str, int], **extra: Any) -> None:
        """Record a state-memory snapshot and maintain the per-metric high
        water mark; warn once (rank-zero) when ``footprint_warn_bytes`` is
        configured and crossed — the unbounded-cat-state guard.

        Keys under ``sliced/`` (a ``SlicedMetric``'s [S]-leading states)
        are split out to a separate ``<Metric>[sliced]`` HWM label with the
        metric's ``num_slices`` remembered alongside, so the summary
        exporter can show a per-slice average and slice-axis growth never
        silently mixes with base-state growth under one mark."""
        label = type(metric).__name__
        total = int(sum(footprint.values()))
        windowed_bytes = int(
            sum(v for k, v in footprint.items() if k.startswith(WINDOWED_FOOTPRINT_PREFIX))
        )
        sliced_bytes = int(
            sum(v for k, v in footprint.items() if k.startswith(SLICED_FOOTPRINT_PREFIX))
        )
        sketch_bytes = int(
            sum(v for k, v in footprint.items() if k.startswith(SKETCH_FOOTPRINT_PREFIX))
        )
        base_bytes = total - sliced_bytes - sketch_bytes - windowed_bytes
        n_slices = getattr(metric, "num_slices", None) if sliced_bytes else None
        with self._lock:
            if windowed_bytes:
                # windowed ring/decay leaves are the R-fold window budget —
                # bounded by construction, tracked under their own mark
                windowed_label = label + WINDOWED_LABEL_SUFFIX
                if windowed_bytes > self._footprint_hwm.get(windowed_label, -1):
                    self._footprint_hwm[windowed_label] = windowed_bytes
            if sliced_bytes:
                sliced_label = label + SLICED_LABEL_SUFFIX
                if sliced_bytes > self._footprint_hwm.get(sliced_label, -1):
                    self._footprint_hwm[sliced_label] = sliced_bytes
                if isinstance(n_slices, int) and n_slices > 0:
                    self._sliced_slice_counts[sliced_label] = n_slices
            if sketch_bytes:
                # sketch leaves are a FIXED budget: the split keeps the
                # bounded bytes from tripping the cat-state growth warning's
                # mental model, and the HWM simply pins the budget
                sketch_label = label + SKETCH_LABEL_SUFFIX
                if sketch_bytes > self._footprint_hwm.get(sketch_label, -1):
                    self._footprint_hwm[sketch_label] = sketch_bytes
            if (
                base_bytes or not (sliced_bytes or sketch_bytes or windowed_bytes)
            ) and base_bytes > self._footprint_hwm.get(label, -1):
                self._footprint_hwm[label] = base_bytes
            event = {
                "type": "footprint",
                "metric": label,
                "total_bytes": total,
                "t": round(time.time() - self._t0, 6),
            }
            if sliced_bytes:
                event["sliced_bytes"] = sliced_bytes
                if isinstance(n_slices, int):
                    event["n_slices"] = n_slices
            if sketch_bytes:
                event["sketch_bytes"] = sketch_bytes
            if windowed_bytes:
                event["windowed_bytes"] = windowed_bytes
            event.update(extra)
            self._append(event)
            warn = (
                self.footprint_warn_bytes is not None
                and total > self.footprint_warn_bytes
                and label not in self._footprint_warned
            )
            if warn:
                self._footprint_warned.add(label)
        if warn:
            rank_zero_warn(
                f"Telemetry: metric `{label}` state footprint is {total} bytes,"
                f" above the configured high-water mark of"
                f" {self.footprint_warn_bytes} bytes. Unbounded list ('cat')"
                " states (AUROC/ROC/PRC-style curve accumulators) grow with"
                " every update — consider the fixed-capacity exact-curve mode"
                " or more frequent compute()+reset() cycles.",
                UserWarning,
            )

    def record_fused_update(
        self,
        n_metrics: int,
        n_fused: int,
        n_fallback: int,
        duration_s: float,
        batch_rows: Optional[int] = None,
        **extra: Any,
    ) -> None:
        """Record ONE fused collection update (one graph replay serving
        ``n_fused`` metric updates, plus ``n_fallback`` eager fallbacks in
        the same batch). Exactly one ``fused_update`` event per batch is
        the fused path's dispatch-count contract — the guard test in
        tests/bases/test_fused.py pins it. ``batch_rows`` (the batch's
        leading dimension) feeds the windowed ingest-rate series."""
        with self._lock:
            self._fused_updates += 1
            self._fused_metric_updates += int(n_fused)
            self._fused_fallback_updates += int(n_fallback)
            event: Dict[str, Any] = {
                "type": "fused_update",
                "t": round(time.time() - self._t0, 6),
                "n_metrics": int(n_metrics),
                "n_fused": int(n_fused),
                "n_fallback": int(n_fallback),
                "dur_ms": round(duration_s * 1e3, 4),
            }
            if batch_rows is not None:
                event["batch_rows"] = int(batch_rows)
            event.update(extra)
            self._append(event)
        self._observe(SERIES_FUSED_DISPATCH_MS, duration_s * 1e3)
        if batch_rows is not None:
            self._observe(SERIES_INGEST_ROWS, int(batch_rows))

    def record_sketch_merge(self, n_merges: int = 1, **extra: Any) -> None:
        """Record ``n_merges`` pairwise sketch merges (cross-rank sync folds,
        ``merge_states`` calls). Counter-only — merges run inside sync/merge
        cold paths and inside traced collectives (where this hook fires once
        per TRACE, the in-jit accounting convention), so no event row is
        appended on their behalf."""
        with self._lock:
            self._sketch["merges"] += int(n_merges)

    def record_sketch_fill(self, metric: Any, ratios: Dict[str, float], **extra: Any) -> None:
        """Record capacity-fill ratios for a metric's sketch leaves (hooked
        from the cold ``compute`` path — reading occupancy syncs the leaf,
        which the update hot path must never do). Keeps last-seen and
        high-water gauges plus one ``sketch_fill`` event."""
        if not ratios:
            return
        worst = max(ratios.values())
        with self._lock:
            self._sketch["fill_ratio"] = worst
            self._sketch["max_fill_ratio"] = max(self._sketch["max_fill_ratio"], worst)
            event: Dict[str, Any] = {
                "type": "sketch_fill",
                "metric": type(metric).__name__,
                "ratios": {k: round(float(v), 6) for k, v in ratios.items()},
                "t": round(time.time() - self._t0, 6),
            }
            event.update(extra)
            self._append(event)
        self._observe(SERIES_SKETCH_FILL, worst)

    def record_scores(self, values: Any, series: str = SERIES_SCORES, max_samples: int = 32) -> None:
        """Feed a bounded sample of model scores into the windowed
        ``scores`` distribution series (no-op when no registry is
        attached). The drift alarm (``DriftRule`` in observability/
        health.py) freezes a reference window of this series and compares
        the live window against it. Host-only: ``values`` is read back
        once (callers on a hot path should pass host arrays); at most
        ``max_samples`` evenly-strided values are recorded per call so
        per-batch cost stays O(max_samples) whatever the batch size.
        Gated on ``enabled`` like every other feed: a disabled recorder
        pays one bool check and records nothing."""
        ts = self.timeseries
        if not self.enabled or ts is None:
            return
        try:
            import numpy as np

            if hasattr(values, "detach"):  # a tensor: one copy to the host
                values = values.detach().to("cpu", copy=False).numpy()
            arr = np.asarray(values, dtype=np.float64).reshape(-1)
            if arr.size == 0:
                return
            # ceil stride: floor would over-generate and the truncation
            # would then ALWAYS drop the batch tail — a biased sample when
            # batches are ordered (sorted scores, grouped tenants)
            stride = -(-arr.size // int(max_samples))
            for v in arr[::stride]:
                ts.observe(series, float(v), kind="distribution")
        except Exception:  # noqa: BLE001 — telemetry must never take down the hot path
            pass

    def record_drift_score(self, source: str, stat: str, value: float, **extra: Any) -> None:
        """Record one reference-vs-live drift score (``DriftRule``
        evaluations): a last-seen gauge per (source, stat) — rendered as
        the ``metrics_tpu_drift_score{metric,stat}`` Prometheus family and
        carried through the cross-host aggregate payload (merged max-wise,
        like every gauge family) — plus one ``drift`` event row so score
        trajectories survive in the JSONL stream."""
        key = f"{source}|{stat}"
        with self._lock:
            self._drift[key] = float(value)
            event: Dict[str, Any] = {
                "type": "drift",
                "source": source,
                "stat": stat,
                "value": round(float(value), 6),
                "t": round(time.time() - self._t0, 6),
            }
            event.update(extra)
            self._append(event)

    def record_sliced_scatter(
        self,
        metric: Any,
        n_rows: int,
        n_slices: int,
        n_leaves: int,
        in_jit: bool = False,
        hot_rows: Optional[int] = None,
        **extra: Any,
    ) -> None:
        """Record one slice-axis segment-scatter (``SlicedMetric._update``).

        On the eager path this is once per update; under the fused kernel
        the hook runs at TRACE time — once per compilation, not per executed
        batch (shapes are static), the same convention the in-jit sync-byte
        accounting uses. The counters are therefore dispatch-shaped on the
        eager path and compile-shaped on the fused one; ``bench.py sliced``
        reads the fused handle's ``n_compiles`` for the hard compile gate.

        ``hot_rows`` (eager path only — needs concrete slice ids) is the
        row count of the batch's single most-hit slice; its share of the
        batch feeds the windowed hot-slice-skew series the health layer
        alarms on.
        """
        with self._lock:
            self._sliced["scatter_events"] += 1
            self._sliced["rows"] += int(n_rows)
            self._sliced["max_slices"] = max(self._sliced["max_slices"], int(n_slices))
            event: Dict[str, Any] = {
                "type": "sliced_scatter",
                "metric": type(metric).__name__,
                "n_rows": int(n_rows),
                "n_slices": int(n_slices),
                "n_leaves": int(n_leaves),
                "in_jit": bool(in_jit),
                "t": round(time.time() - self._t0, 6),
            }
            if hot_rows is not None:
                event["hot_rows"] = int(hot_rows)
            event.update(extra)
            self._append(event)
        if not in_jit:
            # trace-time hooks are compile-shaped, not traffic-shaped — only
            # eager scatters feed the windowed ingest/skew series
            self._observe(SERIES_SLICED_ROWS, int(n_rows))
            if hot_rows is not None and n_rows:
                self._observe(SERIES_HOT_SLICE_SHARE, int(hot_rows) / int(n_rows))

    def record_ops_dispatch(self, op: str, backend: str) -> None:
        """Count one kernel-registry dispatch (``ops/dispatch.py``).

        Counter-only — no event append: a dispatched op can run inside
        every eager metric update (``_bincount`` under every
        confusion-matrix metric), and the per-call interest is which
        BACKEND served it, not each occurrence. Under jit the dispatch
        decision happens at trace time, so jitted traffic counts once per
        compilation — the same convention as the in-jit sliced-scatter
        accounting.
        """
        key = f"{op}|{backend}"
        with self._lock:
            self._ops_dispatch[key] = self._ops_dispatch.get(key, 0) + 1

    def record_async_event(
        self,
        kind: str,
        batch_index: Optional[int] = None,
        queue_depth: Optional[int] = None,
        staleness_steps: Optional[int] = None,
        in_flight_bytes: Optional[int] = None,
        dur_ms: Optional[float] = None,
        **extra: Any,
    ) -> None:
        """Record one async-pipeline transition (core/pipeline.py hooks).

        ``kind`` is one of the typed events — ``"enqueue"`` (exactly one per
        ACCEPTED batch: the per-batch observability contract the guard test
        in tests/bases/test_pipeline.py pins), ``"dequeue"`` (one per applied
        batch), ``"flush"`` (one per drain) — or a counter/gauge-only update:
        ``"drop"`` (a batch the drop policy discarded) and ``"snapshot"``
        (a bounded-staleness compute), which bump totals without adding an
        event. In-flight bytes also feed the footprint high-water mark under
        the ``async_in_flight`` label, so the memory pinned by queued
        batches and donated in-flight state shows up next to the per-metric
        state HWMs instead of being invisible exactly when pressure peaks.

        Every async event is stamped with the recording thread's id (and
        the tid -> name map updated), so the Perfetto export can land the
        worker's rows on their own labeled track.
        """
        tid = threading.get_ident()
        with self._lock:
            self._thread_names.setdefault(tid, threading.current_thread().name)
            totals = self._async
            if kind == "enqueue":
                totals["enqueued"] += 1
            elif kind == "dequeue":
                totals["applied"] += 1
            elif kind == "flush":
                totals["flushes"] += 1
            elif kind == "drop":
                totals["dropped"] += 1
            if queue_depth is not None:
                totals["queue_depth"] = int(queue_depth)
                totals["max_queue_depth"] = max(totals["max_queue_depth"], int(queue_depth))
            if staleness_steps is not None:
                totals["staleness_steps"] = int(staleness_steps)
                totals["max_staleness_steps"] = max(
                    totals["max_staleness_steps"], int(staleness_steps)
                )
            if in_flight_bytes is not None:
                totals["in_flight_bytes"] = int(in_flight_bytes)
                totals["max_in_flight_bytes"] = max(
                    totals["max_in_flight_bytes"], int(in_flight_bytes)
                )
                if int(in_flight_bytes) > self._footprint_hwm.get(ASYNC_IN_FLIGHT_LABEL, -1):
                    self._footprint_hwm[ASYNC_IN_FLIGHT_LABEL] = int(in_flight_bytes)
            if kind not in ("drop", "snapshot"):  # counter/gauge-only kinds skip the stream
                event: Dict[str, Any] = {
                    "type": kind,
                    "t": round(time.time() - self._t0, 6),
                    "tid": tid,
                }
                if batch_index is not None:
                    event["batch_index"] = int(batch_index)
                if queue_depth is not None:
                    event["queue_depth"] = int(queue_depth)
                if staleness_steps is not None:
                    event["staleness_steps"] = int(staleness_steps)
                if in_flight_bytes is not None:
                    event["in_flight_bytes"] = int(in_flight_bytes)
                if dur_ms is not None:
                    event["dur_ms"] = dur_ms
                event.update(extra)
                self._append(event)
        # windowed feeds (outside the lock; no-ops when detached)
        if kind == "enqueue":
            self._observe(SERIES_ASYNC_ENQUEUED, 1)
        elif kind == "drop":
            self._observe(SERIES_ASYNC_DROPPED, 1)
        elif kind == "dequeue":
            if dur_ms is not None:
                self._observe(SERIES_ASYNC_APPLY_MS, float(dur_ms))
            age_ms = extra.get("age_ms")
            if age_ms is not None:
                self._observe(SERIES_ASYNC_AGE_MS, float(age_ms))
        elif kind == "snapshot" and staleness_steps is not None:
            self._observe(SERIES_ASYNC_STALENESS, int(staleness_steps))
        if queue_depth is not None:
            self._observe(SERIES_ASYNC_QUEUE_DEPTH, int(queue_depth))

    def record_read(
        self,
        kind: str,
        metric: Any = None,
        duration_s: float = 0.0,
        cache_hit: bool = False,
        leaves: int = 0,
        ring_buckets: int = 0,
        table_rows: int = 0,
        fanin: int = 0,
        freshness: Optional[Any] = None,
        **extra: Any,
    ) -> None:
        """Record one read-path serve (the typed ``read`` event family).

        ``kind`` names the entry point — ``"compute"`` (Metric.compute,
        cache hit or cold), ``"window"`` (WindowedMetric.window_state /
        compute(window=)), ``"sliced"`` (SlicedMetric.compute with
        slice_ids/top_k), ``"fleet"`` (FleetCollector.fold_values), or
        ``"probe"`` (a serving loop's dashboard-age probe). The fold-size
        arguments say what the read paid for: state ``leaves`` folded,
        ``ring_buckets`` folded oldest-first, retrieval-table rows
        unpacked, and the fleet ``fanin`` (contributing publishers).

        ``freshness`` is an optional :class:`~metrics_tpu_torch.observability.
        freshness.FreshnessStamp` (duck-typed — only its attributes are
        read, keeping this module import-free): when present, the stamp's
        min/max contributing event-times and staleness components fold
        into the freshness aggregates and the observed ingest-to-visible
        staleness feeds the windowed ``freshness_age_s`` series the
        ``freshness_slo`` alarm watches.
        """
        label = metric if isinstance(metric, str) else (
            type(metric).__name__ if metric is not None else kind
        )
        dur_ms = round(float(duration_s) * 1e3, 4)
        staleness_s: Optional[float] = None
        with self._lock:
            r = self._reads
            r["reads"] += 1
            if cache_hit:
                r["cache_hits"] += 1
            r["leaves_folded"] += int(leaves)
            r["ring_buckets_folded"] += int(ring_buckets)
            r["table_rows_unpacked"] += int(table_rows)
            r["fanin"] += int(fanin)
            r["read_s_total"] += float(duration_s)
            r["max_read_ms"] = max(r["max_read_ms"], dur_ms)
            r["max_fanin"] = max(r["max_fanin"], int(fanin))
            event: Dict[str, Any] = {
                "type": "read",
                "kind": kind,
                "metric": label,
                "t": round(time.time() - self._t0, 6),
                "dur_ms": dur_ms,
                "cache_hit": bool(cache_hit),
            }
            if leaves:
                event["leaves"] = int(leaves)
            if ring_buckets:
                event["ring_buckets"] = int(ring_buckets)
            if table_rows:
                event["table_rows"] = int(table_rows)
            if fanin:
                event["fanin"] = int(fanin)
            if freshness is not None:
                fr = self._freshness
                fr["stamps"] += 1
                lo = getattr(freshness, "min_event_t", None)
                hi = getattr(freshness, "max_event_t", None)
                if lo is not None:
                    fr["min_event_t"] = lo if fr["min_event_t"] is None else min(fr["min_event_t"], lo)
                if hi is not None:
                    fr["max_event_t"] = hi if fr["max_event_t"] is None else max(fr["max_event_t"], hi)
                    staleness_s = max(0.0, time.time() - float(hi))
                    event["staleness_s"] = round(staleness_s, 6)
                    fr["max_staleness_s"] = max(fr["max_staleness_s"], staleness_s)
                for attr, key in (
                    ("async_age_s", "max_async_age_s"),
                    ("ring_span_s", "max_ring_span_s"),
                    ("watermark_lag_s", "max_watermark_lag_s"),
                ):
                    v = float(getattr(freshness, attr, 0.0) or 0.0)
                    if v:
                        event[attr] = round(v, 6)
                        fr[key] = max(fr[key], v)
            event.update(extra)
            self._append(event)
        # windowed feeds (outside the lock; no-ops when detached)
        self._observe(SERIES_READS, 1)
        self._observe(SERIES_READ_MS, dur_ms)
        if fanin:
            self._observe(SERIES_READ_FANIN, int(fanin))
        if staleness_s is not None:
            self._observe(SERIES_FRESHNESS_AGE_S, staleness_s)

    def record_memory_boundary(
        self,
        kind: str,
        metric: Any,
        live_bytes: Any = None,
        **extra: Any,
    ) -> None:
        """Record one metric-lifecycle memory boundary (``kind`` in
        ``update | compute | reset``). The per-kind counter always bumps;
        a typed ``memory`` event row (stamped with the metric's live
        committed state bytes) is emitted at most once per
        ``MEMORY_EVENT_INTERVAL_S`` per kind, so eager update loops pay a
        counter bump, not an event allocation plus a state walk.

        ``live_bytes`` may be an int or a zero-arg callable (e.g. the
        metric's bound ``total_state_bytes``) — the callable is only
        invoked when an event row is actually emitted."""
        now = time.time()
        with self._lock:
            m = self._memory
            key = kind + "_boundaries"
            m[key] = m.get(key, 0) + 1
            emit = now - self._memory_last_event.get(kind, 0.0) >= self.MEMORY_EVENT_INTERVAL_S
            if emit:
                self._memory_last_event[kind] = now
        if not emit:
            return
        lb = int(live_bytes() if callable(live_bytes) else (live_bytes or 0))
        with self._lock:
            m = self._memory
            m["events"] += 1
            m["boundary_live_bytes"] = lb
            m["max_boundary_live_bytes"] = max(m["max_boundary_live_bytes"], lb)
            event: Dict[str, Any] = {
                "type": "memory",
                "kind": kind,
                "metric": type(metric).__name__ if metric is not None else kind,
                "live_bytes": lb,
                "t": round(time.time() - self._t0, 6),
            }
            event.update(extra)
            self._append(event)

    def record_memory_observation(
        self,
        ledger_bytes: int,
        cache_plane_bytes: int,
        device_bytes_in_use: Optional[int] = None,
        device_peak_bytes: Optional[int] = None,
        unaccounted_bytes: Optional[int] = None,
        bytes_per_tenant: Optional[float] = None,
        per_device: Optional[Dict[str, int]] = None,
        planes: Optional[Dict[str, int]] = None,
        source: Optional[str] = None,
        **extra: Any,
    ) -> None:
        """Record one full memory-observatory poll (``MemoryObservatory.
        observe``): the ledger total, the cache-plane inventory total, the
        backend's in-use/peak bytes where it reports them (``source`` says
        what backed the in-use number — ``"backend"``, ``"host_rss"``, or
        ``None`` when nothing could), and the derived unaccounted residue.
        Updates last-seen + high-water gauges, appends one ``memory`` event
        (kind ``observe``), and feeds the ``mem_*`` windowed series the
        ``memory_leak`` / ``memory_budget`` alarms watch."""
        with self._lock:
            m = self._memory
            m["observations"] += 1
            m["events"] += 1
            m["ledger_bytes"] = int(ledger_bytes)
            m["max_ledger_bytes"] = max(m["max_ledger_bytes"], int(ledger_bytes))
            m["cache_plane_bytes"] = int(cache_plane_bytes)
            m["max_cache_plane_bytes"] = max(m["max_cache_plane_bytes"], int(cache_plane_bytes))
            if device_bytes_in_use is not None:
                m["device_bytes_in_use"] = int(device_bytes_in_use)
                m["max_device_bytes_in_use"] = max(
                    m["max_device_bytes_in_use"], int(device_bytes_in_use)
                )
            if unaccounted_bytes is not None:
                m["unaccounted_bytes"] = int(unaccounted_bytes)
                m["max_unaccounted_bytes"] = max(
                    m["max_unaccounted_bytes"], int(unaccounted_bytes)
                )
            if bytes_per_tenant is not None:
                m["bytes_per_tenant"] = float(bytes_per_tenant)
                m["max_bytes_per_tenant"] = max(
                    m["max_bytes_per_tenant"], float(bytes_per_tenant)
                )
            event: Dict[str, Any] = {
                "type": "memory",
                "kind": "observe",
                "t": round(time.time() - self._t0, 6),
                "ledger_bytes": int(ledger_bytes),
                "cache_plane_bytes": int(cache_plane_bytes),
            }
            if device_bytes_in_use is not None:
                event["device_bytes_in_use"] = int(device_bytes_in_use)
            if device_peak_bytes is not None:
                event["device_peak_bytes"] = int(device_peak_bytes)
            if unaccounted_bytes is not None:
                event["unaccounted_bytes"] = int(unaccounted_bytes)
            if bytes_per_tenant is not None:
                event["bytes_per_tenant"] = round(float(bytes_per_tenant), 4)
            if per_device:
                event["per_device"] = {str(k): int(v) for k, v in per_device.items()}
            if planes:
                event["planes"] = {str(k): int(v) for k, v in planes.items()}
            if source is not None:
                event["source"] = source
            event.update(extra)
            self._append(event)
        # windowed feeds (outside the lock; no-ops when detached)
        self._observe(SERIES_MEM_LEDGER_BYTES, int(ledger_bytes))
        self._observe(SERIES_MEM_CACHE_BYTES, int(cache_plane_bytes))
        if device_bytes_in_use is not None:
            self._observe(SERIES_MEM_DEVICE_BYTES, int(device_bytes_in_use))
        if unaccounted_bytes is not None:
            self._observe(SERIES_MEM_UNACCOUNTED, int(unaccounted_bytes))
        if bytes_per_tenant is not None:
            self._observe(SERIES_MEM_BYTES_PER_TENANT, float(bytes_per_tenant))

    def record_cache_plane(
        self,
        plane: str,
        entries: int,
        nbytes: int,
        evictions: int = 0,
        evicted_bytes: int = 0,
        **extra: Any,
    ) -> None:
        """Record one cache-plane lifecycle event: a growth warning
        (ReaderCache crossing its entry threshold) or an eviction (the
        retrieval layout LRU dropping an entry). Carries the plane's entry
        count and byte size as typed fields — what the fleet alarms on
        instead of losing a ``warnings.warn`` to stderr — and sums
        eviction count/bytes into the extensive memory totals."""
        with self._lock:
            m = self._memory
            m["cache_plane_events"] += 1
            m["plane_evictions"] += int(evictions)
            m["plane_evicted_bytes"] += int(evicted_bytes)
            event: Dict[str, Any] = {
                "type": "cache_plane",
                "plane": plane,
                "entries": int(entries),
                "nbytes": int(nbytes),
                "t": round(time.time() - self._t0, 6),
            }
            if evictions:
                event["evictions"] = int(evictions)
            if evicted_bytes:
                event["evicted_bytes"] = int(evicted_bytes)
            event.update(extra)
            self._append(event)

    def record_event(self, etype: str, **fields: Any) -> None:
        """Record a free-form auxiliary event (e.g. ``tracker_increment``)."""
        with self._lock:
            tid = fields.get("tid")
            if isinstance(tid, int) and tid == threading.get_ident():
                # span-exit events carry their own thread's id — register
                # the name so Perfetto tracks are labeled
                self._thread_names.setdefault(tid, threading.current_thread().name)
            event: Dict[str, Any] = {"type": etype, "t": round(time.time() - self._t0, 6)}
            event.update(fields)
            self._append(event)

    def record_fleet_poll(
        self,
        absorbed: int = 0,
        duplicates: int = 0,
        late_dropped: int = 0,
        fold_errors: int = 0,
        backlog: int = 0,
        max_lag_s: float = 0.0,
        publishers: int = 0,
        **extra: Any,
    ) -> None:
        """Record one fleet-collector poll (``FleetCollector._feed_recorder``).

        The count arguments are DELTAS since the previous poll (summed
        into the extensive totals); ``backlog``/``max_lag_s`` are gauges
        (last seen + high-water). Feeds the windowed ``publisher_lag_s``
        / ``collector_backlog`` / ``collector_fold_errors`` series the
        three fleet alarm classes watch. An event row is appended only
        when a poll actually moved a counter — idle polls update gauges
        and series without flooding the stream."""
        with self._lock:
            f = self._fleet
            f["absorbed"] += int(absorbed)
            f["duplicates"] += int(duplicates)
            f["late_dropped"] += int(late_dropped)
            f["fold_errors"] += int(fold_errors)
            f["backlog"] = int(backlog)
            f["max_backlog"] = max(f["max_backlog"], int(backlog))
            f["publisher_lag_s"] = float(max_lag_s)
            f["max_publisher_lag_s"] = max(f["max_publisher_lag_s"], float(max_lag_s))
            f["publishers"] = max(f["publishers"], int(publishers))
            if absorbed or duplicates or late_dropped or fold_errors:
                event: Dict[str, Any] = {
                    "type": "fleet_poll",
                    "t": round(time.time() - self._t0, 6),
                    "absorbed": int(absorbed),
                    "duplicates": int(duplicates),
                    "late_dropped": int(late_dropped),
                    "fold_errors": int(fold_errors),
                    "backlog": int(backlog),
                    "max_lag_s": round(float(max_lag_s), 4),
                }
                event.update(extra)
                self._append(event)
        # windowed feeds (outside the lock; no-ops when detached)
        self._observe(SERIES_COLLECTOR_BACKLOG, int(backlog))
        self._observe(SERIES_PUBLISHER_LAG, float(max_lag_s))
        if fold_errors:
            self._observe(SERIES_FOLD_ERRORS, int(fold_errors))

    def record_export_error(self, error: Optional[BaseException] = None) -> None:
        """Count one failed exporter tick (``PeriodicExporter`` hardening):
        the thread keeps ticking, but the failure must be visible — in the
        summary, the Prometheus page, the health snapshot, and the windowed
        export-error series."""
        with self._lock:
            self._export_errors += 1
            event: Dict[str, Any] = {
                "type": "export_error",
                "t": round(time.time() - self._t0, 6),
                "n_errors": self._export_errors,
            }
            if error is not None:
                event["error"] = repr(error)
            self._append(event)
        self._observe(SERIES_EXPORT_ERRORS, 1)

    # ------------------------------------------------------------------
    # compute-group attribution (MetricCollection)
    # ------------------------------------------------------------------
    def group_attribution(self, members: List[str]) -> "_GroupContext":
        """Context manager: lifecycle events recorded inside are annotated
        with the compute-group members sharing the leader's update, so group
        updates are attributed once instead of double-counted per member."""
        return _GroupContext(self, tuple(members))

    # ------------------------------------------------------------------
    # exporters (delegating to metrics_tpu_torch.observability.exporters)
    # ------------------------------------------------------------------
    def export_jsonl(self, path: str, append: bool = False) -> Optional[str]:
        from metrics_tpu_torch.observability.exporters import export_jsonl

        return export_jsonl(path, recorder=self, append=append)

    def render_prometheus(self) -> str:
        from metrics_tpu_torch.observability.exporters import render_prometheus

        return render_prometheus(recorder=self)

    def summary(self) -> str:
        from metrics_tpu_torch.observability.exporters import summary

        return summary(recorder=self)


class _GroupContext:
    def __init__(self, recorder: MetricRecorder, members: Tuple[str, ...]) -> None:
        self._recorder = recorder
        self._members = members
        self._prev: Optional[Tuple[str, ...]] = None

    def __enter__(self) -> "_GroupContext":
        local = self._recorder._group_local
        self._prev = getattr(local, "group", None)
        local.group = self._members
        return self

    def __exit__(self, *exc: Any) -> None:
        self._recorder._group_local.group = self._prev


#: THE process-local default recorder — the instance the runtime hot paths
#: (core/metric.py, collections.py, parallel/distributed.py,
#: wrappers/tracker.py) check. Import the OBJECT, never copy its ``enabled``
#: flag.
_DEFAULT_RECORDER = MetricRecorder("default")
