"""Telemetry exporters: JSONL event log, Prometheus text exposition, a
human summary table, and a background :class:`PeriodicExporter` that keeps
file artifacts fresh on an interval.

The port's own copy of ``metrics_tpu/observability/exporters.py``: the
same artifact formats and Prometheus family names (``metrics_tpu_*``), so
one dashboard reads either package. All exporters are rank-zero gated on
the ``torch.distributed`` rank (multi-process jobs emit one copy) and read
a consistent snapshot of the recorder, so they can run concurrently with
metric updates. Every file write is atomic (tmp file + ``os.replace`` in
the target directory), so a concurrent scrape or a crash mid-write never
observes a truncated artifact. The windowed families query the attached
time series on the calling thread (the exporter's own, for a
:class:`PeriodicExporter`): sketch folds there run on that thread's
current stream. A :class:`PeriodicExporter` with a ``snapshot_sink``
publishes one fleet snapshot per tick (its states leave the card in one
copy, on the exporter's thread).
"""
from __future__ import annotations

import atexit
import json
import os
import threading
from typing import Any, Dict, List, Optional



def _process_index() -> int:
    from metrics_tpu_torch.parallel.distributed import process_index

    return process_index()


def _resolve(recorder: Optional[Any]) -> Any:
    if recorder is None:
        from metrics_tpu_torch.observability.recorder import _DEFAULT_RECORDER

        return _DEFAULT_RECORDER
    return recorder


# ---------------------------------------------------------------------------
# atomic file writes
# ---------------------------------------------------------------------------

def _atomic_write(path: str, text: str) -> None:
    """Write ``text`` to ``path`` atomically: a same-directory tmp file is
    fully written and fsynced, then ``os.replace``d over the target, so any
    concurrent reader sees either the old complete artifact or the new one
    — never a truncation. The tmp name is pid-distinct, so two processes
    racing the same target each land a complete (last-writer-wins) file."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    tmp = os.path.join(directory, f".{os.path.basename(path)}.tmp.{os.getpid()}")
    with open(tmp, "w") as fh:
        fh.write(text)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


#: rotation cap for appended line logs (alarm JSONL, env-var telemetry
#: appends): past it the current file moves to ``<path>.1`` (previous
#: ``.1`` overwritten) and appends continue on a fresh file — long-running
#: jobs keep bounded log disk, with the newest full generation retained
APPEND_ROTATE_BYTES = 64 * 1024 * 1024


def _atomic_append(path: str, text: str, max_bytes: Optional[int] = APPEND_ROTATE_BYTES) -> None:
    """Line-log append: ONE ``O_APPEND`` ``write`` of the new bytes.

    O(len(text)) per call whatever the file size — the previous
    read-whole-file-and-rewrite implementation made every append O(file),
    so a long-running alarm/telemetry log degraded quadratically (pinned
    by the multi-thousand-append test). ``O_APPEND`` + a single ``write``
    is atomic w.r.t. the file offset, so concurrent appenders (and
    multi-process env-var telemetry) interleave at line granularity, and
    a crash mid-call loses at most the tail of this one write — every
    previously appended line survives intact.

    ``max_bytes`` caps the file: when this append would push past it, the
    current file rotates to ``<path>.1`` first (previous ``.1``
    overwritten — one old generation retained) and the append lands on a
    fresh file. ``None`` disables rotation."""
    data = text.encode("utf-8")
    flags = os.O_WRONLY | os.O_CREAT | os.O_APPEND
    fd = os.open(path, flags, 0o644)
    try:
        if (
            max_bytes is not None
            and os.fstat(fd).st_size > 0
            and os.fstat(fd).st_size + len(data) > max_bytes
        ):
            os.close(fd)
            fd = -1
            os.replace(path, path + ".1")
            fd = os.open(path, flags, 0o644)
        os.write(fd, data)
    finally:
        if fd >= 0:
            os.close(fd)


def export_jsonl(path: str, recorder: Optional[Any] = None, append: bool = False) -> Optional[str]:
    """Write every recorded event as one JSON object per line.

    Returns the path written, or ``None`` on non-zero ranks (rank-zero
    gated). Events are plain dicts of JSON scalars/lists, so the artifact
    round-trips through ``json.loads`` line by line. Full writes are
    atomic (tmp + ``os.replace``); ``append=True`` is a single
    ``O_APPEND`` write (crash-safe up to the current write, size-cap
    rotated — see :func:`_atomic_append`).
    """
    if _process_index() != 0:
        return None
    rec = _resolve(recorder)
    text = "".join(json.dumps(event) + "\n" for event in rec.events())
    if append:
        _atomic_append(path, text)
    else:
        _atomic_write(path, text)
    return path


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels(**kv: Any) -> str:
    inner = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in kv.items())
    return "{" + inner + "}" if inner else ""


#: default lookback for the windowed (time-series) Prometheus families
WINDOW_EXPORT_SECONDS = 60.0

#: quantiles rendered per distribution series on the Prometheus page
WINDOW_EXPORT_QUANTILES = (0.5, 0.95, 0.99)

#: fixed bucket edges (``le`` bounds) for the qsketch-backed exposition
#: histograms: log-spaced 1ms..5000s in base units, wide enough to cover
#: millisecond latencies and multi-minute staleness ages with one shared
#: grid — FIXED so the fleet merge and PromQL ``histogram_quantile`` see
#: the same ``le`` set from every rank
WINDOW_HISTOGRAM_EDGES = (
    0.001, 0.005, 0.025, 0.1, 0.5, 1.0, 2.5, 10.0, 50.0, 250.0, 1000.0, 5000.0,
)


def _timeseries_lines(registry: Any, window_s: float = WINDOW_EXPORT_SECONDS) -> List[str]:
    """Windowed families from a TimeSeriesRegistry (or a registry rebuilt
    from a merged cross-host payload): per-series observation count and
    rate, plus p50/p95/p99 for distribution series. One merged-sketch
    query serves all quantiles of a series.

    Each sample carries a ``window_s`` label with the seconds ACTUALLY
    covered — the requested window clamped to the series' ring span
    (``n_buckets * bucket_seconds``): a short-ring registry must not
    publish numbers labeled as a longer lookback than it holds."""
    lines: List[str] = []
    names = registry.names()
    if not names:
        return lines

    def eff_window(s: Any) -> float:
        return min(float(window_s), s.n_buckets * s.bucket_seconds)

    lines.append(
        "# HELP metrics_tpu_window_count Observations recorded in the trailing window"
        " (window_s label = seconds covered) per series."
    )
    lines.append("# TYPE metrics_tpu_window_count gauge")
    for name in names:
        s = registry.get(name)
        w = eff_window(s)
        lines.append(
            f"metrics_tpu_window_count{_labels(series=name, window_s=f'{w:g}')} {s.count(w)}"
        )
    lines.append(
        "# HELP metrics_tpu_window_rate Summed values per second over the trailing window"
        " (window_s label = seconds covered) per series."
    )
    lines.append("# TYPE metrics_tpu_window_rate gauge")
    for name in names:
        s = registry.get(name)
        w = eff_window(s)
        lines.append(
            f"metrics_tpu_window_rate{_labels(series=name, window_s=f'{w:g}')} {s.rate(w):g}"
        )
    lines.append(
        "# HELP metrics_tpu_window_quantile Sketch-estimated quantiles over the trailing"
        " window (window_s label = seconds covered) per distribution series."
    )
    lines.append("# TYPE metrics_tpu_window_quantile gauge")
    for name in names:
        s = registry.get(name)
        if s.kind != "distribution":
            continue
        w = eff_window(s)
        vals = s.quantiles(WINDOW_EXPORT_QUANTILES, window_s=w)
        if vals is None:
            continue
        for q, v in zip(WINDOW_EXPORT_QUANTILES, vals):
            lines.append(
                f"metrics_tpu_window_quantile{_labels(series=name, q=q, window_s=f'{w:g}')} {v:g}"
            )
    lines.extend(_histogram_lines(registry, names, eff_window))
    return lines


def _histogram_lines(registry: Any, names: List[str], eff_window: Any) -> List[str]:
    """Real Prometheus histograms for the distribution series: cumulative
    ``_bucket{le=}`` counts from the window sketch's CDF at the fixed
    :data:`WINDOW_HISTOGRAM_EDGES`, plus ``_sum``/``_count`` from the
    series' exact windowed totals — so PromQL ``histogram_quantile`` and
    the existing quantile gauges answer from the same sketch. Sketch-
    estimated bucket counts are forced monotone non-decreasing and capped
    at the exact ``_count`` (a strict-parser requirement the CDF estimate
    alone cannot guarantee)."""
    samples: List[str] = []
    for name in names:
        s = registry.get(name)
        if s.kind != "distribution":
            continue
        w = eff_window(s)
        n = s.count(w)
        if not n:
            continue
        sketch = s.window_sketch(w)
        if sketch is None:
            continue
        import numpy as np

        from metrics_tpu_torch.sketches.quantile import qsketch_cdf

        edges = np.asarray(WINDOW_HISTOGRAM_EDGES, np.float32)
        cdf = qsketch_cdf(sketch, edges).cpu().numpy()
        if np.any(np.isnan(cdf)):
            continue
        counts = np.minimum(np.maximum.accumulate(np.clip(cdf, 0.0, 1.0)) * n, n)
        labels = {"series": name, "window_s": f"{w:g}"}
        for edge, c in zip(WINDOW_HISTOGRAM_EDGES, counts):
            samples.append(
                f"metrics_tpu_window_hist_bucket{_labels(le=f'{edge:g}', **labels)} {c:g}"
            )
        samples.append(f"metrics_tpu_window_hist_bucket{_labels(le='+Inf', **labels)} {n}")
        samples.append(f"metrics_tpu_window_hist_sum{_labels(**labels)} {s.total(w):g}")
        samples.append(f"metrics_tpu_window_hist_count{_labels(**labels)} {n}")
    if not samples:
        return []
    return [
        "# HELP metrics_tpu_window_hist Sketch-backed distribution histogram over the"
        " trailing window (window_s label = seconds covered) per series.",
        "# TYPE metrics_tpu_window_hist histogram",
        *samples,
    ]


def render_prometheus(recorder: Optional[Any] = None, aggregate: Optional[Dict[str, Any]] = None) -> str:
    """Prometheus text-format rendering of the aggregate counters/gauges.

    Meant for a scrape endpoint or a textfile-collector drop: call counts
    and cumulative wall time per (metric, phase), sync/gather byte totals,
    distinct-signature gauges (the recompile detector's raw data),
    state-footprint high-water marks, and compile bills. Returns ``""`` on
    non-zero ranks.

    ``aggregate`` — a job-wide result from
    :func:`metrics_tpu_torch.observability.aggregate_across_hosts`. When given,
    the page covers the WHOLE job instead of this process: call counts are
    the merged totals, and the families where per-rank detail matters
    (wall time for stragglers, sync bytes, signature skew, footprint and
    compile bills per host) carry a ``process`` label per rank.
    """
    if _process_index() != 0:
        return ""
    rec = _resolve(recorder)
    if aggregate is not None:
        counts = aggregate["call_counts"]
        per_proc = aggregate["processes"]
        dropped = aggregate["dropped_events"]
    else:
        counts = rec.call_counts()
        # single-process rendering reuses the per-process machinery with
        # this one recorder's payload, minus the process label
        from metrics_tpu_torch.observability.aggregate import counter_payload

        per_proc = [counter_payload(rec)]
        dropped = rec.dropped_events()

    def proc_label(payload: Dict[str, Any]) -> Dict[str, Any]:
        if aggregate is None:
            return {}
        # per-host labelling for the federated (fleet-collector) view:
        # payloads carrying snapshot provenance get host (and, through a
        # collector, publisher) labels next to the process index — several
        # publishers on one host share a process index, so the publisher
        # id is what keeps the per-rank series distinct. Older payloads
        # without provenance stay process-only.
        labels: Dict[str, Any] = {"process": payload.get("process", 0)}
        if payload.get("host"):
            labels["host"] = payload["host"]
        if payload.get("publisher"):
            labels["publisher"] = payload["publisher"]
        return labels

    lines: List[str] = []
    lines.append("# HELP metrics_tpu_calls_total Metric lifecycle calls by metric and phase.")
    lines.append("# TYPE metrics_tpu_calls_total counter")
    for (metric, phase), n in sorted(counts.items()):
        lines.append(f"metrics_tpu_calls_total{_labels(metric=metric, phase=phase)} {n}")
    lines.append("# HELP metrics_tpu_call_seconds_total Cumulative wall time by metric and phase.")
    lines.append("# TYPE metrics_tpu_call_seconds_total counter")
    for payload in per_proc:
        for key, t in sorted(payload.get("call_times", {}).items()):
            metric, phase = key.split("|")
            lines.append(
                f"metrics_tpu_call_seconds_total"
                f"{_labels(metric=metric, phase=phase, **proc_label(payload))} {t:.6f}"
            )
    lines.append("# HELP metrics_tpu_sync_events_total Cross-device/process state synchronizations.")
    lines.append("# TYPE metrics_tpu_sync_events_total counter")
    for payload in per_proc:
        lines.append(
            f"metrics_tpu_sync_events_total{_labels(**proc_label(payload))}"
            f" {payload.get('sync_totals', {}).get('sync_events', 0)}"
        )
    lines.append("# HELP metrics_tpu_gather_bytes_total Bytes of synced state received per participant.")
    lines.append("# TYPE metrics_tpu_gather_bytes_total counter")
    for payload in per_proc:
        lines.append(
            f"metrics_tpu_gather_bytes_total{_labels(**proc_label(payload))}"
            f" {payload.get('sync_totals', {}).get('gather_bytes', 0)}"
        )
    lines.append("# HELP metrics_tpu_pad_waste_bytes_total Pad-to-max padding bytes moved by uneven gathers.")
    lines.append("# TYPE metrics_tpu_pad_waste_bytes_total counter")
    for payload in per_proc:
        lines.append(
            f"metrics_tpu_pad_waste_bytes_total{_labels(**proc_label(payload))}"
            f" {payload.get('sync_totals', {}).get('pad_waste_bytes', 0)}"
        )
    lines.append("# HELP metrics_tpu_distinct_signatures Distinct (shape, dtype) call signatures per entry point.")
    lines.append("# TYPE metrics_tpu_distinct_signatures gauge")
    for payload in per_proc:
        for entry, n in sorted(payload.get("signature_counts", {}).items()):
            lines.append(
                f"metrics_tpu_distinct_signatures{_labels(entry=entry, **proc_label(payload))} {n}"
            )
    lines.append("# HELP metrics_tpu_state_bytes_hwm State-footprint high-water mark per metric.")
    lines.append("# TYPE metrics_tpu_state_bytes_hwm gauge")
    for payload in per_proc:
        for metric, nbytes in sorted(payload.get("footprint_hwm", {}).items()):
            lines.append(
                f"metrics_tpu_state_bytes_hwm{_labels(metric=metric, **proc_label(payload))} {nbytes}"
            )
    lines.append("# HELP metrics_tpu_compiles_total Attributed CUDA graph captures per entry point.")
    lines.append("# TYPE metrics_tpu_compiles_total counter")
    for payload in per_proc:
        for entry, n in sorted(payload.get("compile_counts", {}).items()):
            lines.append(
                f"metrics_tpu_compiles_total{_labels(entry=entry, **proc_label(payload))} {n}"
            )
    lines.append("# HELP metrics_tpu_compile_seconds_total Cumulative trace+lower+compile wall time per entry point.")
    lines.append("# TYPE metrics_tpu_compile_seconds_total counter")
    for payload in per_proc:
        for entry, t in sorted(payload.get("compile_times", {}).items()):
            lines.append(
                f"metrics_tpu_compile_seconds_total{_labels(entry=entry, **proc_label(payload))} {t:.6f}"
            )
    # disjoint terminal outcomes only (applied + dropped): every accepted-or-
    # rejected batch lands in exactly one, so sum()/rate() over the family is
    # meaningful. Ingress (enqueued, a superset of applied) and flush
    # operations (not batches at all) get their own families.
    lines.append("# HELP metrics_tpu_async_batches_total Async-pipeline batches by terminal outcome (applied|dropped; disjoint).")
    lines.append("# TYPE metrics_tpu_async_batches_total counter")
    for payload in per_proc:
        totals = payload.get("async_totals", {})
        for outcome in ("applied", "dropped"):
            lines.append(
                f"metrics_tpu_async_batches_total"
                f"{_labels(outcome=outcome, **proc_label(payload))} {totals.get(outcome, 0)}"
            )
    lines.append("# HELP metrics_tpu_async_enqueued_total Batches accepted into the async update queue (ingress; applied is a subset).")
    lines.append("# TYPE metrics_tpu_async_enqueued_total counter")
    for payload in per_proc:
        totals = payload.get("async_totals", {})
        lines.append(
            f"metrics_tpu_async_enqueued_total{_labels(**proc_label(payload))}"
            f" {totals.get('enqueued', 0)}"
        )
    lines.append("# HELP metrics_tpu_async_flushes_total Deterministic drains (flush() calls and draining close()).")
    lines.append("# TYPE metrics_tpu_async_flushes_total counter")
    for payload in per_proc:
        totals = payload.get("async_totals", {})
        lines.append(
            f"metrics_tpu_async_flushes_total{_labels(**proc_label(payload))}"
            f" {totals.get('flushes', 0)}"
        )
    # each family's HELP/TYPE must sit directly above its own samples: the
    # exposition format requires all lines of a metric as one contiguous
    # group, and strict consumers (promtool, OpenMetrics scrapers) reject
    # interleaved headers
    for family, key, help_text in (
        ("metrics_tpu_async_queue_depth", "queue_depth",
         "Outstanding async batches: accepted but not yet applied, including"
         " the one in the worker's hand — may exceed the configured queue"
         " depth by one (last seen / high-water)."),
        ("metrics_tpu_async_staleness_steps", "staleness_steps",
         "Compute-snapshot staleness in unapplied batches (last seen / high-water)."),
        ("metrics_tpu_async_in_flight_bytes", "in_flight_bytes",
         "Bytes pinned by queued batches and donated in-flight state (last seen / high-water)."),
    ):
        lines.append(f"# HELP {family} {help_text}")
        lines.append(f"# TYPE {family} gauge")
        for payload in per_proc:
            totals = payload.get("async_totals", {})
            lines.append(
                f"{family}{_labels(window='last', **proc_label(payload))} {totals.get(key, 0)}"
            )
            lines.append(
                f"{family}{_labels(window='max', **proc_label(payload))} {totals.get('max_' + key, 0)}"
            )
    lines.append("# HELP metrics_tpu_sliced_scatter_total Slice-axis segment-scatter updates (eager: per update; fused: per compilation).")
    lines.append("# TYPE metrics_tpu_sliced_scatter_total counter")
    for payload in per_proc:
        totals = payload.get("sliced_totals", {})
        lines.append(
            f"metrics_tpu_sliced_scatter_total{_labels(**proc_label(payload))}"
            f" {totals.get('scatter_events', 0)}"
        )
    lines.append("# HELP metrics_tpu_sliced_rows_total Batch rows scattered into slice states.")
    lines.append("# TYPE metrics_tpu_sliced_rows_total counter")
    for payload in per_proc:
        totals = payload.get("sliced_totals", {})
        lines.append(
            f"metrics_tpu_sliced_rows_total{_labels(**proc_label(payload))}"
            f" {totals.get('rows', 0)}"
        )
    lines.append("# HELP metrics_tpu_sliced_slices Largest slice count seen on a sliced metric (high-water).")
    lines.append("# TYPE metrics_tpu_sliced_slices gauge")
    for payload in per_proc:
        totals = payload.get("sliced_totals", {})
        lines.append(
            f"metrics_tpu_sliced_slices{_labels(**proc_label(payload))}"
            f" {totals.get('max_slices', 0)}"
        )
    lines.append("# HELP metrics_tpu_sketch_merges_total Cross-rank/pairwise sketch-state merges performed.")
    lines.append("# TYPE metrics_tpu_sketch_merges_total counter")
    for payload in per_proc:
        totals = payload.get("sketch_totals", {})
        lines.append(
            f"metrics_tpu_sketch_merges_total{_labels(**proc_label(payload))}"
            f" {totals.get('merges', 0)}"
        )
    lines.append("# HELP metrics_tpu_sketch_fill_ratio Sketch capacity-fill ratio (occupied slots / capacity) reported at compute.")
    lines.append("# TYPE metrics_tpu_sketch_fill_ratio gauge")
    for payload in per_proc:
        totals = payload.get("sketch_totals", {})
        lines.append(
            f"metrics_tpu_sketch_fill_ratio{_labels(window='last', **proc_label(payload))}"
            f" {totals.get('fill_ratio', 0.0)}"
        )
        lines.append(
            f"metrics_tpu_sketch_fill_ratio{_labels(window='max', **proc_label(payload))}"
            f" {totals.get('max_fill_ratio', 0.0)}"
        )
    lines.append("# HELP metrics_tpu_ops_dispatch_total Kernel dispatches by op and backend (cuda or plain).")
    lines.append("# TYPE metrics_tpu_ops_dispatch_total counter")
    for payload in per_proc:
        for key, n in sorted(payload.get("ops_dispatch_totals", {}).items()):
            op, _, backend = key.partition("|")
            lines.append(
                f"metrics_tpu_ops_dispatch_total"
                f"{_labels(op=op, backend=backend, **proc_label(payload))} {n}"
            )
    # read-path telemetry plane: every compute/window/sliced/fleet read
    # emits a typed event; these families are its cumulative face. The two
    # cache outcomes are disjoint (hit + miss = reads), so sum()/rate()
    # over the family is meaningful.
    lines.append("# HELP metrics_tpu_read_total Metric reads by cache outcome (hit|miss; disjoint).")
    lines.append("# TYPE metrics_tpu_read_total counter")
    for payload in per_proc:
        totals = payload.get("read_totals", {})
        reads = totals.get("reads", 0)
        hits = totals.get("cache_hits", 0)
        lines.append(
            f"metrics_tpu_read_total{_labels(cache='hit', **proc_label(payload))} {hits}"
        )
        lines.append(
            f"metrics_tpu_read_total{_labels(cache='miss', **proc_label(payload))} {max(reads - hits, 0)}"
        )
    lines.append("# HELP metrics_tpu_read_seconds_total Cumulative wall time spent serving metric reads.")
    lines.append("# TYPE metrics_tpu_read_seconds_total counter")
    for payload in per_proc:
        totals = payload.get("read_totals", {})
        lines.append(
            f"metrics_tpu_read_seconds_total{_labels(**proc_label(payload))}"
            f" {totals.get('read_s_total', 0.0):.6f}"
        )
    lines.append("# HELP metrics_tpu_read_fanin Contributors folded by a single read (fleet-tier publisher fan-in; last window high-water).")
    lines.append("# TYPE metrics_tpu_read_fanin gauge")
    for payload in per_proc:
        totals = payload.get("read_totals", {})
        lines.append(
            f"metrics_tpu_read_fanin{_labels(window='max', **proc_label(payload))}"
            f" {totals.get('max_fanin', 0)}"
        )
    lines.append("# HELP metrics_tpu_read_folded_total State folded while serving reads, by unit (leaves|ring_buckets|table_rows).")
    lines.append("# TYPE metrics_tpu_read_folded_total counter")
    for payload in per_proc:
        totals = payload.get("read_totals", {})
        for unit, key in (
            ("leaves", "leaves_folded"),
            ("ring_buckets", "ring_buckets_folded"),
            ("table_rows", "table_rows_unpacked"),
        ):
            lines.append(
                f"metrics_tpu_read_folded_total"
                f"{_labels(unit=unit, **proc_label(payload))} {totals.get(key, 0)}"
            )
    lines.append("# HELP metrics_tpu_freshness_stamps_total Reads that carried an ingest-to-visible freshness stamp.")
    lines.append("# TYPE metrics_tpu_freshness_stamps_total counter")
    for payload in per_proc:
        fresh = payload.get("freshness", {})
        lines.append(
            f"metrics_tpu_freshness_stamps_total{_labels(**proc_label(payload))}"
            f" {fresh.get('stamps', 0)}"
        )
    lines.append("# HELP metrics_tpu_freshness_staleness_seconds Worst ingest-to-visible staleness observed at a read (high-water).")
    lines.append("# TYPE metrics_tpu_freshness_staleness_seconds gauge")
    for payload in per_proc:
        fresh = payload.get("freshness", {})
        lines.append(
            f"metrics_tpu_freshness_staleness_seconds{_labels(window='max', **proc_label(payload))}"
            f" {fresh.get('max_staleness_s', 0.0):g}"
        )
    # memory-observatory families (observability/memory.py): the ledger /
    # cache-plane / device / unaccounted byte gauges follow the async-gauge
    # contiguity pattern (window='last' + window='max' per family)
    lines.append("# HELP metrics_tpu_memory_boundaries_total Metric lifecycle memory boundaries by kind (update|compute|reset; disjoint).")
    lines.append("# TYPE metrics_tpu_memory_boundaries_total counter")
    for payload in per_proc:
        totals = payload.get("memory", {})
        for kind in ("update", "compute", "reset"):
            lines.append(
                f"metrics_tpu_memory_boundaries_total"
                f"{_labels(boundary=kind, **proc_label(payload))}"
                f" {totals.get(kind + '_boundaries', 0)}"
            )
    lines.append("# HELP metrics_tpu_memory_observations_total Full memory-observatory polls (ledger + cache planes + backend).")
    lines.append("# TYPE metrics_tpu_memory_observations_total counter")
    for payload in per_proc:
        totals = payload.get("memory", {})
        lines.append(
            f"metrics_tpu_memory_observations_total{_labels(**proc_label(payload))}"
            f" {totals.get('observations', 0)}"
        )
    for family, key, help_text in (
        ("metrics_tpu_memory_ledger_bytes", "ledger_bytes",
         "Live committed device bytes held by metric state pytrees, deduped"
         " by buffer identity (last seen / high-water)."),
        ("metrics_tpu_memory_cache_plane_bytes", "cache_plane_bytes",
         "Bytes held by registered cache planes (reader/fused executables,"
         " layout memo, value caches; last seen / high-water)."),
        ("metrics_tpu_memory_device_bytes_in_use", "device_bytes_in_use",
         "Allocator-reported bytes in use (backend memory_stats, or host RSS"
         " where the backend reports none; last seen / high-water)."),
        ("metrics_tpu_memory_unaccounted_bytes", "unaccounted_bytes",
         "In-use bytes minus ledger minus cache planes — the residue the"
         " memory_leak alarm watches (last seen / high-water)."),
        ("metrics_tpu_memory_bytes_per_tenant", "bytes_per_tenant",
         "Ledger bytes per sliced-state tenant — what the memory_budget"
         " alarm ceilings (last seen / high-water)."),
    ):
        lines.append(f"# HELP {family} {help_text}")
        lines.append(f"# TYPE {family} gauge")
        for payload in per_proc:
            totals = payload.get("memory", {})
            lines.append(
                f"{family}{_labels(window='last', **proc_label(payload))} {totals.get(key, 0)}"
            )
            lines.append(
                f"{family}{_labels(window='max', **proc_label(payload))}"
                f" {totals.get('max_' + key, 0)}"
            )
    lines.append("# HELP metrics_tpu_memory_plane_evictions_total Cache-plane entries evicted (layout memo LRU drops and finalizers).")
    lines.append("# TYPE metrics_tpu_memory_plane_evictions_total counter")
    for payload in per_proc:
        totals = payload.get("memory", {})
        lines.append(
            f"metrics_tpu_memory_plane_evictions_total{_labels(**proc_label(payload))}"
            f" {totals.get('plane_evictions', 0)}"
        )
    lines.append("# HELP metrics_tpu_memory_plane_evicted_bytes_total Bytes released by cache-plane evictions.")
    lines.append("# TYPE metrics_tpu_memory_plane_evicted_bytes_total counter")
    for payload in per_proc:
        totals = payload.get("memory", {})
        lines.append(
            f"metrics_tpu_memory_plane_evicted_bytes_total{_labels(**proc_label(payload))}"
            f" {totals.get('plane_evicted_bytes', 0)}"
        )
    lines.append("# HELP metrics_tpu_drift_score Last reference-vs-live drift score per watched source and statistic.")
    lines.append("# TYPE metrics_tpu_drift_score gauge")
    for payload in per_proc:
        for key, v in sorted(payload.get("drift_scores", {}).items()):
            source, _, stat = key.partition("|")
            lines.append(
                f"metrics_tpu_drift_score{_labels(metric=source, stat=stat, **proc_label(payload))} {v:g}"
            )
    lines.append("# HELP metrics_tpu_fleet_ingest_total Fleet-collector snapshot ingests by outcome (absorbed|duplicate|late_dropped|fold_error; disjoint).")
    lines.append("# TYPE metrics_tpu_fleet_ingest_total counter")
    for payload in per_proc:
        totals = payload.get("fleet_totals", {})
        for outcome, key in (
            ("absorbed", "absorbed"),
            ("duplicate", "duplicates"),
            ("late_dropped", "late_dropped"),
            ("fold_error", "fold_errors"),
        ):
            lines.append(
                f"metrics_tpu_fleet_ingest_total"
                f"{_labels(outcome=outcome, **proc_label(payload))} {totals.get(key, 0)}"
            )
    # the fleet gauges follow the async-gauge contiguity pattern: each
    # family's HELP/TYPE directly above its own samples
    for family, key, help_text in (
        ("metrics_tpu_fleet_backlog_snapshots", "backlog",
         "Unfolded snapshots at the collector (queued files + in-window"
         " pending deltas; last seen / high-water)."),
        ("metrics_tpu_fleet_worst_publisher_lag_seconds", "publisher_lag_s",
         "Worst per-publisher snapshot lag observed at a collector poll"
         " (last seen / high-water)."),
    ):
        lines.append(f"# HELP {family} {help_text}")
        lines.append(f"# TYPE {family} gauge")
        for payload in per_proc:
            totals = payload.get("fleet_totals", {})
            lines.append(
                f"{family}{_labels(window='last', **proc_label(payload))} {totals.get(key, 0)}"
            )
            lines.append(
                f"{family}{_labels(window='max', **proc_label(payload))}"
                f" {totals.get('max_' + key, 0)}"
            )
    lines.append("# HELP metrics_tpu_export_errors_total Exporter ticks that raised (artifacts may be stale).")
    lines.append("# TYPE metrics_tpu_export_errors_total counter")
    for payload in per_proc:
        lines.append(
            f"metrics_tpu_export_errors_total{_labels(**proc_label(payload))}"
            f" {payload.get('export_errors', 0)}"
        )
    lines.append("# HELP metrics_tpu_dropped_events_total Events discarded past the buffer cap.")
    lines.append("# TYPE metrics_tpu_dropped_events_total counter")
    lines.append(f"metrics_tpu_dropped_events_total {dropped}")
    # windowed (time-series) families — present only when the live layer is
    # attached (single-process: the recorder's registry; aggregate: the
    # cross-host merged payload rebuilt into a queryable registry)
    ts_registry = None
    if aggregate is not None:
        merged_ts = aggregate.get("timeseries")
        if merged_ts:
            from metrics_tpu_torch.observability.timeseries import registry_from_payload

            ts_registry = registry_from_payload(merged_ts, device=getattr(rec.timeseries, "device", None))
    else:
        ts_registry = rec.timeseries
    if ts_registry is not None:
        lines.extend(_timeseries_lines(ts_registry))
    return "\n".join(lines) + "\n"


def write_prometheus(path: str, recorder: Optional[Any] = None, aggregate: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Atomically drop the Prometheus page as a textfile-collector artifact.
    Returns the path written, or ``None`` on non-zero ranks."""
    if _process_index() != 0:
        return None
    _atomic_write(path, render_prometheus(recorder, aggregate=aggregate))
    return path


# ---------------------------------------------------------------------------
# human summary
# ---------------------------------------------------------------------------

def summary(recorder: Optional[Any] = None) -> str:
    """Human-readable summary table of where metric time went.

    Returns ``""`` on non-zero ranks.
    """
    if _process_index() != 0:
        return ""
    rec = _resolve(recorder)
    counts = rec.call_counts()
    times = rec.call_times()
    sync = rec.sync_totals()
    sigs = rec.signature_counts()
    hwm = rec.footprint_high_water_marks()
    compiles = rec.compile_counts()
    compile_times = rec.compile_times()

    rows = []
    for (metric, phase), n in sorted(counts.items(), key=lambda kv: -times.get(kv[0], 0.0)):
        total_ms = times.get((metric, phase), 0.0) * 1e3
        rows.append((metric, phase, n, total_ms, total_ms / max(n, 1)))

    # clamp to the header's own width: all-short metric names must not
    # shrink the column below len("metric") and shear the header row
    width = max([len(r[0]) for r in rows] + [6])
    lines = [
        f"telemetry summary (recorder `{rec.name}`)",
        f"{'metric':<{width}}  {'phase':<8} {'calls':>7} {'total_ms':>10} {'mean_ms':>9}",
    ]
    for metric, phase, n, total_ms, mean_ms in rows:
        lines.append(f"{metric:<{width}}  {phase:<8} {n:>7} {total_ms:>10.3f} {mean_ms:>9.4f}")
    if not rows:
        lines.append("(no lifecycle calls recorded)")
    lines.append(
        f"sync: {sync['sync_events']} events, {sync['gather_bytes']} gather bytes,"
        f" {sync['pad_waste_bytes']} pad-waste bytes"
    )
    async_totals = rec.async_totals()
    if async_totals.get("enqueued") or async_totals.get("dropped"):
        lines.append(
            f"async pipeline: {async_totals['enqueued']} enqueued,"
            f" {async_totals['applied']} applied, {async_totals['dropped']} dropped,"
            f" {async_totals['flushes']} flushes; queue depth max"
            f" {async_totals['max_queue_depth']}, staleness max"
            f" {async_totals['max_staleness_steps']} steps, in-flight max"
            f" {async_totals['max_in_flight_bytes']} bytes"
        )
    sliced_totals = rec.sliced_totals()
    if sliced_totals.get("scatter_events"):
        lines.append(
            f"sliced scatter: {sliced_totals['scatter_events']} events,"
            f" {sliced_totals['rows']} rows, max {sliced_totals['max_slices']} slices"
        )
    drift = rec.drift_scores()
    if drift:
        lines.append("drift scores (reference vs live):")
        for key, v in sorted(drift.items()):
            source, _, stat = key.partition("|")
            lines.append(f"  {source} [{stat}]: {v:.4g}")
    dropped = rec.dropped_events()
    if dropped:
        lines.append(
            f"WARNING: {dropped} events dropped past the buffer cap"
            " (aggregate counters above still include them)"
        )
    export_errors = rec.export_errors()
    if export_errors:
        lines.append(
            f"WARNING: {export_errors} exporter tick(s) failed — telemetry"
            " artifacts may be stale (the exporter keeps retrying)"
        )
    registry = rec.timeseries
    if registry is not None and registry.names():
        # requested lookback clamped to what the ring actually holds — the
        # header must not claim a longer window than the series span
        window_s = min(
            WINDOW_EXPORT_SECONDS,
            min(
                s.n_buckets * s.bucket_seconds
                for s in (registry.get(n) for n in registry.names())
            ),
        )
        lines.append(f"windowed series (last {window_s:g}s):")
        for name in registry.names():
            s = registry.get(name)
            n = s.count(window_s)
            if not n:
                continue
            if s.kind == "distribution":
                qs = s.quantiles((0.5, 0.95, 0.99), window_s=window_s)
                q50, q95, q99 = (f"{v:.4g}" for v in qs) if qs else ("-", "-", "-")
                lines.append(f"  {name}: n={n} p50={q50} p95={q95} p99={q99}")
            else:
                lines.append(f"  {name}: n={n} rate={s.rate(window_s):.4g}/s")
    if sigs:
        lines.append("distinct call signatures per entry point:")
        for entry, n in sorted(sigs.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {entry}: {n}")
    if compiles:
        lines.append("compile bills per entry point (count, total ms):")
        for entry, n in sorted(compiles.items(), key=lambda kv: -compile_times.get(kv[0], 0.0)):
            lines.append(f"  {entry}: {n} compiles, {compile_times.get(entry, 0.0) * 1e3:.1f} ms")
    if hwm:
        slice_counts = rec.footprint_slice_counts()
        lines.append("state-footprint high-water marks:")
        for metric, nbytes in sorted(hwm.items(), key=lambda kv: -kv[1]):
            n_slices = slice_counts.get(metric)
            if n_slices:
                # sliced-state marks carry the per-slice average so slice-
                # count growth reads differently from per-slice state growth
                lines.append(
                    f"  {metric}: {nbytes} bytes"
                    f" ({nbytes / n_slices:.1f} B/slice over {n_slices} slices)"
                )
            else:
                lines.append(f"  {metric}: {nbytes} bytes")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# continuous export
# ---------------------------------------------------------------------------

class PeriodicExporter:
    """Background thread that re-exports telemetry artifacts on an interval.

    Long jobs should not need an explicit export call at every checkpoint:
    give the exporter a Prometheus textfile path and/or a JSONL path (both
    atomically re-rendered on ticks where anything new was recorded — a
    scraper or tail can read at any moment and never sees a truncation),
    then ``start()`` it. ``stop()`` — also registered via ``atexit`` —
    performs one final export, so events recorded between the last tick
    and interpreter exit still land.

    Rank-zero gated: on other ranks ``start()`` is a no-op, matching the
    exporters it drives. Restartable: ``start()`` after ``stop()`` begins
    a fresh thread.

    **Hardened against bad ticks**: an exception inside one export tick
    (ENOSPC, permissions, a non-serializable event field) is caught,
    counted (``export_errors`` here, ``record_export_error`` on the
    recorder — surfaced by ``summary()``, the
    ``metrics_tpu_export_errors_total`` Prometheus family, and the health
    snapshot), warned once, and the thread KEEPS ticking — continuous
    export must degrade to stale-but-recovering, never die silently.

    **Health integration**: pass a
    :class:`~metrics_tpu_torch.observability.health.HealthMonitor` as
    ``health`` and every tick evaluates it (firing/clearing alarms on
    schedule even when no new events arrive — clearing is time passing)
    and appends its Prometheus families to the Prometheus artifact.

    **Fleet publishing**: pass a
    :class:`~metrics_tpu_torch.observability.collector.SnapshotSink` as
    ``snapshot_sink`` and every tick also publishes one fleet snapshot: the
    recorder's counter payload, plus the states returned by ``states_fn``
    when given (a zero-arg callable returning the
    :func:`~metrics_tpu_torch.observability.wire.snapshot_states` dict, or
    the metric or collection itself, which also embeds the layout key the
    collector validates; with a bare dict pass the metric or collection as
    ``states_template``). Published on every tick, idle ones too: the
    snapshot is the publisher's heartbeat, whose absence the collector's
    ``publisher_stale`` alarm watches. ``snapshot_mode`` is ``"state"``
    (cumulative) or ``"delta"`` (the caller resets after each tick). The
    tick runs on the exporter's thread: the encode's device work (one
    packing and one copy to the host) goes on the states' device's default
    stream, ordered both ways with that thread's current stream.
    """

    def __init__(
        self,
        interval_s: float = 30.0,
        prometheus_path: Optional[str] = None,
        jsonl_path: Optional[str] = None,
        recorder: Optional[Any] = None,
        health: Optional[Any] = None,
        snapshot_sink: Optional[Any] = None,
        states_fn: Optional[Any] = None,
        states_template: Optional[Any] = None,
        snapshot_mode: str = "state",
    ) -> None:
        if prometheus_path is None and jsonl_path is None and snapshot_sink is None:
            raise ValueError("PeriodicExporter needs a prometheus_path, a jsonl_path, and/or a snapshot_sink")
        if interval_s <= 0:
            raise ValueError(f"interval_s must be positive, got {interval_s}")
        self.interval_s = float(interval_s)
        self.prometheus_path = prometheus_path
        self.jsonl_path = jsonl_path
        self.health = health
        self.snapshot_sink = snapshot_sink
        self.states_fn = states_fn
        self.states_template = states_template
        self.snapshot_mode = snapshot_mode
        self.export_errors = 0
        self._recorder = recorder
        self._thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        # (event count, dropped count) at the last export; every counter
        # mutation either appends an event or bumps the dropped tally, so
        # this pair is a complete change detector. None = never exported.
        self._exported_state: Optional[tuple] = None
        self._warned = False
        self._lock = threading.Lock()

    def start(self) -> "PeriodicExporter":
        if _process_index() != 0:
            return self
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop_event = threading.Event()
            self._thread = threading.Thread(
                target=self._run, name="metrics-tpu-torch-telemetry-export", daemon=True
            )
            self._thread.start()
        atexit.register(self.stop)
        return self

    def _run(self) -> None:
        while not self._stop_event.wait(self.interval_s):
            try:
                self.export_once()
            except Exception as err:  # noqa: BLE001
                # one bad tick (ENOSPC, a permissions hiccup, an event with
                # a non-serializable field) must not kill continuous export
                # for the rest of the job — count it (visible in summary(),
                # the Prometheus page, and the health snapshot), warn once,
                # and keep ticking
                self.export_errors += 1
                rec = _resolve(self._recorder)
                try:
                    rec.record_export_error(err)
                except Exception:  # noqa: BLE001 — counting must not re-raise
                    pass
                if not self._warned:
                    self._warned = True
                    from metrics_tpu_torch.utils.prints import rank_zero_warn

                    rank_zero_warn(
                        f"Telemetry: a PeriodicExporter tick failed ({err!r});"
                        " the thread keeps running and will retry next tick."
                        " Further tick failures are counted (export_errors),"
                        " not re-warned.",
                        UserWarning,
                    )

    def export_once(self) -> None:
        """One export tick (also usable manually, without the thread).

        Both artifacts are re-rendered in FULL (the recorder holds every
        event in memory anyway, bounded by its event cap) and swapped in
        atomically — no read-modify-append cycle, and a reader always sees
        a complete artifact. A tick where nothing was recorded since the
        last one skips the writes entirely (after the first tick, which
        always materializes the artifacts) — UNLESS a health monitor or a
        time-series registry rides along: windowed stats and alarm states
        change with the clock, not only with new events, so those ticks
        always re-evaluate and re-render the Prometheus artifact."""
        rec = _resolve(self._recorder)
        events = rec.events()
        snapshot = None
        if self.health is not None:
            # evaluated OUTSIDE the exporter lock (rule evaluation does
            # sketch math) and unconditionally: alarms must clear on
            # schedule even when the job records nothing new
            snapshot = self.health.evaluate()
        if self.snapshot_sink is not None:
            # every tick, idle ones too: the snapshot is the publisher's
            # heartbeat for the collector's liveness tracking
            self._publish_snapshot(rec)
        with self._lock:
            state = (len(events), rec.dropped_events())
            live_window = self.health is not None or rec.timeseries is not None
            if state == self._exported_state and not live_window:
                return
            if self.prometheus_path is not None:
                text = render_prometheus(rec)
                if snapshot is not None:
                    text += "\n".join(self.health.prometheus_lines(snapshot)) + "\n"
                _atomic_write(self.prometheus_path, text)
            if state != self._exported_state and self.jsonl_path is not None:
                _atomic_write(
                    self.jsonl_path, "".join(json.dumps(e) + "\n" for e in events)
                )
            self._exported_state = state

    def _publish_snapshot(self, rec: Any) -> None:
        """One fleet snapshot into the sink: the counter payload and, with
        ``states_fn``, the metric states."""
        from metrics_tpu_torch.observability.aggregate import counter_payload
        from metrics_tpu_torch.observability.collector import _device_work, _template_device
        from metrics_tpu_torch.observability.wire import snapshot_states

        states = None
        template = self.states_template
        if self.states_fn is not None:
            obj = self.states_fn()
            if obj is not None:
                if isinstance(obj, dict):
                    # a bare dict carries no structure: the explicit
                    # states_template supplies the layout key
                    states = obj
                else:
                    states = snapshot_states(obj)
                    template = obj
        device = _template_device(template) if template is not None else None
        with _device_work(device):
            self.snapshot_sink.publish(
                states=states, states_template=template, telemetry=counter_payload(rec), mode=self.snapshot_mode
            )

    def stop(self) -> None:
        """Stop the thread and perform one final export. Idempotent."""
        thread = self._thread
        self._stop_event.set()
        if thread is not None:
            thread.join(timeout=max(5.0, self.interval_s))
            self._thread = None
        if _process_index() == 0:
            try:
                self.export_once()
            except Exception:  # noqa: BLE001 — exit paths must not raise
                pass
        try:
            atexit.unregister(self.stop)
        except Exception:
            pass
