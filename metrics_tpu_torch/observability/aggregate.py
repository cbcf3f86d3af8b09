"""Job-wide telemetry aggregation: merge every rank's counters onto one view.

The port's own copy of ``metrics_tpu/observability/aggregate.py``. Each
process serializes its counter totals (call counts/times, signature
counts, sync totals, footprint high-water marks, compile bills, the
windowed series) to a JSON payload; the payloads travel as ``uint8``
tensors through :func:`metrics_tpu_torch.parallel.distributed.
gather_all_arrays` (which carries uneven lengths itself), and the merge
runs on every rank so rank zero exports the whole job while other ranks
stay consistent.

Merge semantics per counter family:

* call counts / call times / sync totals / compile counts+times / dropped —
  **summed** (extensive quantities; the job total is the sum of ranks)
* distinct signature counts — **max** across ranks
* footprint high-water marks and every gauge — **max**

In a single-process run there is no gather: the local payload is returned
as a world-size-1 aggregate.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from metrics_tpu_torch.observability.recorder import _DEFAULT_RECORDER

__all__ = ["aggregate_across_hosts", "counter_payload", "merge_payloads"]

#: separator for (metric, phase) keys in the JSON payload; class and phase
#: names are identifiers, so "|" cannot collide
_KEY_SEP = "|"


def counter_payload(recorder: Optional[Any] = None) -> Dict[str, Any]:
    """One process's aggregate counters as a flat JSON-safe dict (the unit
    the cross-host allgather serializes — and the fleet wire format ships).

    Every payload is stamped with snapshot provenance beyond the bare
    process index: the ``host`` name, the wall-clock ``t`` it was taken,
    and a monotonic per-process ``seq`` (survives recorder resets) — what
    a fleet collector's per-host labelling, lag tracking, and duplicate
    detection key on. All three merge as identity defaults: a payload
    from an older build simply lacks them (``merge_payloads`` reads every
    family with ``.get``), so mixed-fleet merges keep working."""
    rec = recorder if recorder is not None else _DEFAULT_RECORDER
    import socket
    import time as _time

    from metrics_tpu_torch.parallel.distributed import process_index

    registry = getattr(rec, "timeseries", None)
    next_seq = getattr(rec, "next_snapshot_seq", None)
    return {
        "process": process_index(),
        "host": socket.gethostname(),
        "t": _time.time(),
        "seq": next_seq() if callable(next_seq) else 0,
        "call_counts": {_KEY_SEP.join(k): v for k, v in rec.call_counts().items()},
        "call_times": {_KEY_SEP.join(k): v for k, v in rec.call_times().items()},
        "signature_counts": dict(rec.signature_counts()),
        "sync_totals": dict(rec.sync_totals()),
        "footprint_hwm": dict(rec.footprint_high_water_marks()),
        "compile_counts": dict(rec.compile_counts()),
        "compile_times": dict(rec.compile_times()),
        "fused_update_totals": dict(rec.fused_update_totals()),
        "async_totals": dict(rec.async_totals()),
        "sliced_totals": dict(rec.sliced_totals()),
        "sliced_slice_counts": dict(rec.footprint_slice_counts()),
        "sketch_totals": dict(rec.sketch_totals()),
        "drift_scores": dict(rec.drift_scores()),
        "fleet_totals": dict(rec.fleet_totals()),
        "ops_dispatch_totals": dict(rec.ops_dispatch_totals()),
        "read_totals": dict(rec.read_totals()),
        "memory": dict(rec.memory_totals()),
        "freshness": dict(rec.freshness_totals()),
        "export_errors": rec.export_errors(),
        # windowed time series ride the same payload path: per-bucket
        # sketches serialize JSON-safe and merge by qsketch_merge, so a
        # fleet-wide windowed p99 is the same fold as every other family
        "timeseries": registry.payload() if registry is not None else {},
        "dropped_events": rec.dropped_events(),
    }


def _merge_sum(maps: List[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for m in maps:
        for k, v in m.items():
            out[k] = out.get(k, 0) + v
    return out


def _merge_max(maps: List[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for m in maps:
        for k, v in m.items():
            out[k] = max(out.get(k, v), v)
    return out


def merge_payloads(payloads: List[Dict[str, Any]], device: Optional[Any] = None) -> Dict[str, Any]:
    """Merge per-process counter payloads into one job-wide aggregate.

    Returns tuple-keyed counters matching the recorder's accessors, plus
    the raw per-process payloads under ``"processes"`` (per-rank detail for
    the ``process``-labelled Prometheus series and straggler triage).

    Every counter family is read with ``.get`` and an identity default: a
    heterogeneous fleet (a rank on an older build missing a family, a rank
    whose workload never touched a subsystem) merges as zero/identity —
    absent keys are data about that rank, never an error. The windowed
    series merge their sketches on ``device`` (the card unless ``"cpu"``).
    """
    return {
        "world_size": len(payloads),
        "call_counts": {
            tuple(k.split(_KEY_SEP)): v
            for k, v in _merge_sum([p.get("call_counts", {}) for p in payloads]).items()
        },
        "call_times": {
            tuple(k.split(_KEY_SEP)): v
            for k, v in _merge_sum([p.get("call_times", {}) for p in payloads]).items()
        },
        "signature_counts": _merge_max([p.get("signature_counts", {}) for p in payloads]),
        "sync_totals": _merge_sum([p.get("sync_totals", {}) for p in payloads]),
        "footprint_hwm": _merge_max([p.get("footprint_hwm", {}) for p in payloads]),
        "compile_counts": _merge_sum([p.get("compile_counts", {}) for p in payloads]),
        "compile_times": _merge_sum([p.get("compile_times", {}) for p in payloads]),
        # extensive, like the call counts they mirror (older payloads from
        # pre-fused ranks simply contribute nothing)
        "fused_update_totals": _merge_sum([p.get("fused_update_totals", {}) for p in payloads]),
        "async_totals": _merge_async([p.get("async_totals", {}) for p in payloads]),
        "sliced_totals": _merge_sliced([p.get("sliced_totals", {}) for p in payloads]),
        # slice counts are a structural property (same SlicedMetric config
        # on every rank) — max is the safe reconciliation if they skew
        "sliced_slice_counts": _merge_max([p.get("sliced_slice_counts", {}) for p in payloads]),
        "sketch_totals": _merge_sketch([p.get("sketch_totals", {}) for p in payloads]),
        # drift scores are last-seen gauges; the worst (max) rank's score is
        # the fleet's headline — a rank without the drift layer contributes
        # nothing, like every other family
        "drift_scores": _merge_max([p.get("drift_scores", {}) for p in payloads]),
        "fleet_totals": _merge_fleet([p.get("fleet_totals", {}) for p in payloads]),
        # dispatch counts are extensive; the per-backend split surviving the
        # merge is the point — a fleet where one host's TPU traffic all
        # lands on the jnp fallback is exactly what this view must show
        "ops_dispatch_totals": _merge_sum(
            [p.get("ops_dispatch_totals", {}) for p in payloads]
        ),
        "read_totals": _merge_reads([p.get("read_totals", {}) for p in payloads]),
        "memory": _merge_memory([p.get("memory", {}) for p in payloads]),
        "freshness": _merge_freshness([p.get("freshness", {}) for p in payloads]),
        "export_errors": sum(p.get("export_errors", 0) for p in payloads),
        "timeseries": _merge_timeseries([p.get("timeseries", {}) for p in payloads], device),
        "dropped_events": sum(p.get("dropped_events", 0) for p in payloads),
        "processes": list(payloads),
    }


def _merge_timeseries(maps: List[Dict[str, Any]], device: Optional[Any] = None) -> Dict[str, Any]:
    """Windowed-series fan-in: same-name series merge bucket-by-bucket
    (counts summed, sketches ``qsketch_merge``d — see
    ``timeseries.merge_registry_payloads``); a rank without the live layer
    contributes nothing. Lazy import: payload merging must stay cheap for
    the (common) case where no rank attached a registry."""
    maps = [m for m in maps if m]
    if not maps:
        return {}
    from metrics_tpu_torch.observability.timeseries import merge_registry_payloads

    return merge_registry_payloads(maps, device=device)


#: async-pipeline counter keys that are extensive batch counts (summed);
#: every other key in the payload is a gauge/high-water mark (maxed)
_ASYNC_SUM_KEYS = ("enqueued", "applied", "dropped", "flushes")


def _merge_async(maps: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Async totals mix extensive counts (batches moved — summed) with
    gauges and high-water marks (queue depth, staleness, in-flight bytes —
    maxed, same semantics as the footprint HWMs)."""
    sums = _merge_sum([{k: v for k, v in m.items() if k in _ASYNC_SUM_KEYS} for m in maps])
    maxes = _merge_max([{k: v for k, v in m.items() if k not in _ASYNC_SUM_KEYS} for m in maps])
    return {**maxes, **sums}


#: sliced-scatter counter keys that are extensive (summed); max_slices is
#: a high-water mark
_SLICED_SUM_KEYS = ("scatter_events", "rows")


def _merge_sliced(maps: List[Dict[str, Any]]) -> Dict[str, Any]:
    sums = _merge_sum([{k: v for k, v in m.items() if k in _SLICED_SUM_KEYS} for m in maps])
    maxes = _merge_max([{k: v for k, v in m.items() if k not in _SLICED_SUM_KEYS} for m in maps])
    return {**maxes, **sums}


#: fleet-collector counter keys that are extensive (summed); backlog and
#: publisher-lag gauges/high-water marks (and the publisher count) max
_FLEET_SUM_KEYS = ("absorbed", "duplicates", "late_dropped", "fold_errors")


def _merge_fleet(maps: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fleet-collector totals: snapshot outcome counts sum; the backlog /
    worst-lag gauges and the publisher count max — a rank that runs no
    collector contributes nothing, like every other family."""
    sums = _merge_sum([{k: v for k, v in m.items() if k in _FLEET_SUM_KEYS} for m in maps])
    maxes = _merge_max([{k: v for k, v in m.items() if k not in _FLEET_SUM_KEYS} for m in maps])
    return {**maxes, **sums}


#: read-path counter keys that are extensive (summed); the per-read maxima
#: are high-water marks (maxed)
_READ_SUM_KEYS = (
    "reads", "cache_hits", "leaves_folded", "ring_buckets_folded",
    "table_rows_unpacked", "fanin", "read_s_total",
)


def _merge_reads(maps: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Read-path totals: read/fold counts sum across ranks; the worst
    single read (latency, fan-in) maxes — a rank that never computes
    contributes nothing, like every other family."""
    sums = _merge_sum([{k: v for k, v in m.items() if k in _READ_SUM_KEYS} for m in maps])
    maxes = _merge_max([{k: v for k, v in m.items() if k not in _READ_SUM_KEYS} for m in maps])
    return {**maxes, **sums}


#: memory-plane counter keys that are extensive (summed); the byte gauges
#: and their ``max_*`` high-water marks max — a fleet's ledger bytes are
#: per-host numbers, and the merged view keeps the worst host's figure
#: (per-host detail stays in the ``processes`` list)
_MEMORY_SUM_KEYS = (
    "events", "update_boundaries", "compute_boundaries", "reset_boundaries",
    "observations", "cache_plane_events", "plane_evictions", "plane_evicted_bytes",
)


def _merge_memory(maps: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Memory-observatory totals: boundary/observation counts sum across
    ranks; the ledger / cache-plane / device / unaccounted byte gauges (and
    their high-water marks) max — a rank without the memory plane
    contributes nothing, like every other family."""
    sums = _merge_sum([{k: v for k, v in m.items() if k in _MEMORY_SUM_KEYS} for m in maps])
    maxes = _merge_max([{k: v for k, v in m.items() if k not in _MEMORY_SUM_KEYS} for m in maps])
    return {**maxes, **sums}


def _merge_freshness(maps: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Freshness totals merge like the stamps they summarize: min of the
    mins, max of the maxes (``None`` is the identity for the event-time
    bounds, matching :class:`~metrics_tpu_torch.observability.freshness.
    FreshnessStamp`'s monoid), stamp counts sum. A payload from a rank
    without the freshness layer contributes the identity."""
    maps = [m for m in maps if m]
    out: Dict[str, Any] = {
        "stamps": 0, "min_event_t": None, "max_event_t": None,
        "max_staleness_s": 0.0, "max_async_age_s": 0.0,
        "max_ring_span_s": 0.0, "max_watermark_lag_s": 0.0,
    }
    if not maps:
        return out
    for m in maps:
        out["stamps"] += int(m.get("stamps", 0) or 0)
        lo = m.get("min_event_t")
        if lo is not None:
            out["min_event_t"] = lo if out["min_event_t"] is None else min(out["min_event_t"], lo)
        hi = m.get("max_event_t")
        if hi is not None:
            out["max_event_t"] = hi if out["max_event_t"] is None else max(out["max_event_t"], hi)
        for key in ("max_staleness_s", "max_async_age_s", "max_ring_span_s", "max_watermark_lag_s"):
            out[key] = max(out[key], float(m.get(key, 0.0) or 0.0))
    return out


#: sketch counter keys that are extensive (summed); the fill ratios are
#: gauges/high-water marks (maxed)
_SKETCH_SUM_KEYS = ("merges",)


def _merge_sketch(maps: List[Dict[str, Any]]) -> Dict[str, Any]:
    sums = _merge_sum([{k: v for k, v in m.items() if k in _SKETCH_SUM_KEYS} for m in maps])
    maxes = _merge_max([{k: v for k, v in m.items() if k not in _SKETCH_SUM_KEYS} for m in maps])
    return {**maxes, **sums}


def aggregate_across_hosts(recorder: Optional[Any] = None, group: Optional[Any] = None) -> Dict[str, Any]:
    """Merge this recorder's counters with every other process's.

    Single-process: returns the local totals as a world-size-1 aggregate
    without touching any collective. Multi-process: the JSON-serialized
    payload goes as a ``uint8`` tensor through ``gather_all_arrays`` (on
    the card under NCCL, on the host otherwise; the lengths are uneven
    across ranks, which the gather's header carries), and every rank
    merges the payloads in rank order. Every rank must call it. Call it at
    export time, then hand the result to
    ``render_prometheus(aggregate=...)`` or read the merged counters
    directly.
    """
    local = counter_payload(recorder)
    from metrics_tpu_torch.parallel.distributed import distributed_available, gather_all_arrays

    rec = recorder if recorder is not None else _DEFAULT_RECORDER
    registry = getattr(rec, "timeseries", None)
    device = registry.device if registry is not None else None
    if not distributed_available():
        return merge_payloads([local], device=device)

    import torch

    raw = json.dumps(local).encode("utf-8")
    nccl = torch.distributed.get_backend(group) == "nccl"
    device = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
    mine = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(device)
    gathered = gather_all_arrays(mine, group=group)
    payloads = [json.loads(bytes(g.cpu().numpy().tobytes()).decode("utf-8")) for g in gathered]
    payloads.sort(key=lambda p: p.get("process", 0))
    return merge_payloads(payloads, device=device)
