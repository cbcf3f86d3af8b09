"""metrics_tpu_torch.observability — structured telemetry for the port's runtime.

The port's counterpart of ``metrics_tpu.observability``. A process-local
:class:`MetricRecorder` registry collects typed events
(``update``/``compute``/``forward``/``sync``, ``fused_update``, the async
pipeline's ``enqueue``/``dequeue``/``flush``, reads, spans) from the core
runtime, counts new call signatures per entry point (at a fused entry each
is a CUDA graph capture), accounts cross-process sync traffic (gather
bytes, world size, pad waste), and tracks state-memory high-water marks.
Exporters render the stream as a JSONL event log, a Prometheus text page,
a Perfetto trace or a human summary table; the time series, drift and
health layers turn it into windowed alarms.

Everything is OFF by default; the disabled hot-path cost is one bool check
(no event allocation). Enable with::

    from metrics_tpu_torch.observability import get_recorder
    get_recorder().enable(recompile_threshold=8)
    ...  # run your eval loop
    get_recorder().export_jsonl("telemetry.jsonl")

or set ``METRICS_TPU_TORCH_TELEMETRY=/path/to/telemetry.jsonl`` in the
environment, which switches the default recorder on at import and lets
entry points append their events to that one file
(:func:`maybe_export_env`). The JAX package reads its own variable,
``METRICS_TPU_TELEMETRY``, so a process that imports both packages switches
each on separately.

The fleet plane: ``wire.py`` serializes metric states and telemetry
payloads into versioned, dtype-stable snapshots (the JAX package's bytes;
the card's leaves leave in one copy per publish), and ``collector.py``
folds the snapshots of many publishers into one job's answer
(:class:`FleetCollector`: exactly-once dedup, a watermark and late window,
liveness, the three fleet alarm classes' feed, a merge tree of collectors).
``PeriodicExporter(snapshot_sink=...)`` publishes one snapshot per tick,
and ``export_perfetto(collector=...)`` draws one track per publisher.
"""
import os
from typing import Dict

from metrics_tpu_torch.observability.aggregate import aggregate_across_hosts, counter_payload, merge_payloads
from metrics_tpu_torch.observability.collector import FleetCollector, PublisherStatus, SnapshotQueue, SnapshotSink
from metrics_tpu_torch.observability.drift import (
    categorical_drift,
    histogram_drift,
    js_divergence_hist,
    kl_divergence_hist,
    psi_divergence,
    reference_edges,
    sketch_drift,
    state_drift,
    total_variation,
)
from metrics_tpu_torch.observability.exporters import (
    PeriodicExporter,
    export_jsonl,
    render_prometheus,
    summary,
    write_prometheus,
)
from metrics_tpu_torch.observability.freshness import IDENTITY, FreshnessStamp, merge_stamps, stamp_from_payload
from metrics_tpu_torch.observability.health import (
    AlarmState,
    BurnRateRule,
    DriftRule,
    HealthMonitor,
    HealthSnapshot,
    MemoryBudget,
    MemoryLeak,
    Rule,
    ThresholdRule,
    default_rules,
    render_health,
)
from metrics_tpu_torch.observability.memory import (
    MemoryLedger,
    MemoryObservatory,
    backend_memory_stats,
    cache_plane_inventory,
    cache_plane_total,
    host_rss_bytes,
    live_metrics,
    register_cache_plane,
    unregister_cache_plane,
)
from metrics_tpu_torch.observability.profiling import compiled_cost, metric_compile_cost
from metrics_tpu_torch.observability.recorder import (
    _DEFAULT_RECORDER,
    EVENT_TYPES,
    TELEMETRY_ENV_VAR,
    MetricRecorder,
    current_span_id,
)
from metrics_tpu_torch.observability.timeseries import (
    TelemetrySeries,
    TimeSeriesRegistry,
    merge_registry_payloads,
    registry_from_payload,
    series_from_payload,
)
from metrics_tpu_torch.observability.trace import current_span_context, export_perfetto, span
from metrics_tpu_torch.observability.wire import (
    Snapshot,
    WireError,
    decode_snapshot,
    encode_snapshot,
    manifest_fingerprint,
    members_of,
    snapshot_states,
    states_key,
)

__all__ = [
    "MetricRecorder",
    "EVENT_TYPES",
    "TELEMETRY_ENV_VAR",
    "activate_telemetry",
    "get_recorder",
    "recorders",
    "telemetry_enabled",
    "maybe_export_env",
    "export_jsonl",
    "render_prometheus",
    "write_prometheus",
    "summary",
    "PeriodicExporter",
    "compiled_cost",
    "metric_compile_cost",
    "span",
    "current_span_id",
    "current_span_context",
    "export_perfetto",
    "aggregate_across_hosts",
    "counter_payload",
    "merge_payloads",
    "TelemetrySeries",
    "TimeSeriesRegistry",
    "merge_registry_payloads",
    "registry_from_payload",
    "series_from_payload",
    "FreshnessStamp",
    "IDENTITY",
    "merge_stamps",
    "stamp_from_payload",
    "AlarmState",
    "BurnRateRule",
    "DriftRule",
    "HealthMonitor",
    "HealthSnapshot",
    "MemoryBudget",
    "MemoryLeak",
    "MemoryLedger",
    "MemoryObservatory",
    "backend_memory_stats",
    "cache_plane_inventory",
    "cache_plane_total",
    "host_rss_bytes",
    "live_metrics",
    "register_cache_plane",
    "unregister_cache_plane",
    "Rule",
    "ThresholdRule",
    "categorical_drift",
    "default_rules",
    "histogram_drift",
    "js_divergence_hist",
    "kl_divergence_hist",
    "psi_divergence",
    "reference_edges",
    "render_health",
    "sketch_drift",
    "state_drift",
    "total_variation",
    "FleetCollector",
    "PublisherStatus",
    "SnapshotQueue",
    "SnapshotSink",
    "Snapshot",
    "WireError",
    "decode_snapshot",
    "encode_snapshot",
    "manifest_fingerprint",
    "members_of",
    "snapshot_states",
    "states_key",
]

_RECORDERS: Dict[str, MetricRecorder] = {"default": _DEFAULT_RECORDER}


def get_recorder(name: str = "default") -> MetricRecorder:
    """The process-local recorder registry. ``"default"`` is the instance
    wired into the runtime hot paths; named instances are for ad-hoc user
    instrumentation (they share nothing with the default one)."""
    rec = _RECORDERS.get(name)
    if rec is None:
        rec = _RECORDERS[name] = MetricRecorder(name)
    return rec


def recorders() -> Dict[str, MetricRecorder]:
    """Snapshot of the registry (name -> recorder)."""
    return dict(_RECORDERS)


def telemetry_enabled() -> bool:
    """Whether the default recorder is currently collecting."""
    return _DEFAULT_RECORDER.enabled


def activate_telemetry(argv, default_path: str = "telemetry.jsonl"):
    """The ``--telemetry[=path]`` activation sequence for entry points:
    parse the flag out of ``argv``; when present, enable the default
    recorder, pin the ``METRICS_TPU_TORCH_TELEMETRY`` env var so spawned
    subprocesses inherit the artifact (they append via
    ``maybe_export_env``), and truncate the artifact file. An empty
    ``--telemetry=`` value falls back to ``default_path``. Returns
    ``(abs_path_or_None, remaining_argv)``."""
    path = None
    rest = []
    for arg in argv:
        if arg == "--telemetry":
            path = default_path
        elif arg.startswith("--telemetry="):
            path = arg.split("=", 1)[1] or default_path
        else:
            rest.append(arg)
    if path is not None:
        path = os.path.abspath(path)
        os.environ[TELEMETRY_ENV_VAR] = path
        _DEFAULT_RECORDER.enable()
        open(path, "w").close()  # truncate: this run's processes append
    return path, rest


def maybe_export_env() -> str:
    """Append the default recorder's events to the
    ``METRICS_TPU_TORCH_TELEMETRY`` path if that env var is set and anything
    was recorded; returns the path written or ``""``. Safe to call
    unconditionally at entry-point exit."""
    path = os.environ.get(TELEMETRY_ENV_VAR)
    if path and _DEFAULT_RECORDER.enabled and _DEFAULT_RECORDER.events():
        export_jsonl(path, recorder=_DEFAULT_RECORDER, append=True)
        _DEFAULT_RECORDER.reset()
        return path
    return ""


# env-var activation: lets subprocess entry points (and users who cannot
# edit the launch script) turn collection on without a code change
if os.environ.get(TELEMETRY_ENV_VAR):
    _DEFAULT_RECORDER.enable()
