"""Structured trace spans: nested, context-local timing regions emitted
through the :class:`MetricRecorder` event stream, plus a Chrome/Perfetto
trace-event exporter.

The port's own copy of ``metrics_tpu/observability/trace.py``. Every span
has an id and a parent id kept on a ``contextvars`` stack (so concurrent
threads, the async update worker among them, each see their own
ancestry), and every OTHER event recorded while a span is active carries
that span's id, re-attaching the flat rows to the tree.

The runtime opens spans for you: ``Metric.update/compute/forward/sync``,
``MetricCollection.update/forward/compute`` and the transport hooks
(``gather_all_arrays`` / ``sync_pytree``) are spans whenever the default
recorder is enabled. User code adds its own::

    from metrics_tpu_torch.observability import get_recorder, span
    get_recorder().enable()
    with span("eval_epoch", epoch=3):
        ...  # metric traffic nests under this span

Zero-overhead contract: entering a span while the recorder is disabled
costs one attribute check; no ids are drawn, no clocks read, nothing
recorded. A span is host-side only; device profiles get their own
annotation through ``Metric.enable_profiling`` (``torch.profiler.
record_function``).

``export_perfetto(path)`` renders the span log as trace-event JSON that
``chrome://tracing`` / https://ui.perfetto.dev load directly; the async
worker's rows land on their own labeled track
(``metrics-tpu-torch-async-update``). Given a ``FleetCollector`` it also
draws one track per publisher, stitched to the collector's folds through
the span contexts that the snapshots' headers carry (wire schema v2).
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Any, Dict, List, Optional

from metrics_tpu_torch.observability.exporters import _atomic_write, _process_index
from metrics_tpu_torch.observability.recorder import _DEFAULT_RECORDER, _SPAN_STACK, current_span_id

__all__ = ["span", "current_span_id", "current_span_context", "export_perfetto"]

#: process-wide monotonically increasing span ids; ``itertools.count`` is
#: atomic under the GIL, so concurrent threads never share an id
_SPAN_IDS = itertools.count(1)


class span:
    """Context manager marking one nested timing region.

    ``with span("name", **attributes):`` records a ``span`` event on exit
    carrying ``span_id`` / ``parent_id`` / ``name`` / ``dur_ms`` / ``tid``
    plus the given JSON-safe attributes. Nestable: the parent link follows
    the ``contextvars`` ancestry, so spans opened in different threads (or
    asyncio tasks) cannot interleave each other's stacks. Each instance
    marks ONE region — use a fresh ``span(...)`` per ``with`` block (an
    instance holds per-entry state, so re-entering the same object while
    it is active would corrupt the ancestry stack; nesting distinct
    instances, including same-named ones, is the supported shape).
    """

    __slots__ = ("name", "attributes", "_recorder", "_token", "_t0", "span_id", "parent_id")

    def __init__(self, name: str, recorder: Optional[Any] = None, **attributes: Any) -> None:
        self.name = name
        self.attributes = attributes
        self._recorder = recorder
        self._token = None
        self.span_id: Optional[int] = None
        self.parent_id: Optional[int] = None

    def __enter__(self) -> "span":
        rec = self._recorder if self._recorder is not None else _DEFAULT_RECORDER
        if not rec.enabled:  # disabled spans cost this ONE check
            return self
        stack = _SPAN_STACK.get()
        self.span_id = next(_SPAN_IDS)
        self.parent_id = stack[-1] if stack else None
        self._token = _SPAN_STACK.set(stack + (self.span_id,))
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        if self._token is None:
            return
        dur_s = time.perf_counter() - self._t0
        _SPAN_STACK.reset(self._token)
        self._token = None
        rec = self._recorder if self._recorder is not None else _DEFAULT_RECORDER
        event: Dict[str, Any] = {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "dur_ms": round(dur_s * 1e3, 4),
            "tid": threading.get_ident(),
        }
        if self.attributes:
            event["attributes"] = self.attributes
        if exc and exc[0] is not None:
            event["error"] = getattr(exc[0], "__name__", str(exc[0]))
        rec.record_event("span", **event)


def _resolve(recorder: Optional[Any]) -> Any:
    return recorder if recorder is not None else _DEFAULT_RECORDER


def current_span_context(recorder: Optional[Any] = None) -> Optional[Dict[str, Any]]:
    """The calling context's active span as a JSON-safe dict, or ``None``
    when the recorder is disabled or no span is open.

    This is the cross-process half of span nesting (the fleet plane's
    snapshot header carries it). Shape::

        {"span_id": int, "parent_id": int | None, "t": wall-clock seconds}
    """
    rec = _resolve(recorder)
    if not rec.enabled:
        return None
    stack = _SPAN_STACK.get()
    if not stack:
        return None
    return {
        "span_id": stack[-1],
        "parent_id": stack[-2] if len(stack) > 1 else None,
        "t": time.time(),
    }


def export_perfetto(path: str, recorder: Optional[Any] = None, collector: Optional[Any] = None) -> Optional[str]:
    """Write the recorded span log as Chrome/Perfetto trace-event JSON.

    Every ``span`` event becomes one complete ("X") trace event with
    microsecond ``ts``/``dur``; nesting renders from ts/dur containment per
    (pid, tid) track, exactly how the contextvars stack nested them.
    Duration-carrying lifecycle events (``update``/``compute``/``forward``),
    ``sync``/``compile`` rows, and the async-pipeline transitions
    (``enqueue``/``dequeue``/``flush`` -- which carry the recording thread's
    id) are included too, so the Perfetto view shows the same stream the
    JSONL export does. The recorder's tid -> thread-name map is emitted as
    ``thread_name``/``process_name`` metadata, so the async worker's rows
    land on their own LABELED track (``metrics-tpu-torch-async-update``)
    instead of interleaving with the main thread. Rank-zero gated: returns
    the path written, or ``None`` on non-zero ranks.

    **Fleet mode**: given ``collector`` (a
    :class:`~metrics_tpu_torch.observability.collector.FleetCollector`), the
    per-publisher publish-span contexts from the snapshots' headers render
    as one labelled process track per publisher (publish instants), and
    each ``fleet_fold`` span's ``links`` become flow arrows from the
    publish in the publisher's process to the fold in the collector's.
    """
    if _process_index() != 0:
        return None
    rec = _resolve(recorder)
    if collector is not None and recorder is None and getattr(collector, "_recorder", None) is not None:
        rec = collector._recorder
    pid = _process_index()
    all_events = rec.events()
    # spans carry the real thread id; other rows only carry the enclosing
    # span's id — resolve them onto the same track so ts/dur containment
    # (Perfetto's nesting rule is per (pid, tid)) actually nests them
    span_tid = {
        ev["span_id"]: ev.get("tid", 0) for ev in all_events if ev.get("type") == "span"
    }
    trace_events: List[Dict[str, Any]] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "args": {"name": f"metrics_tpu_torch rank {pid} ({rec.name})"},
        }
    ]
    for tid, tname in sorted(rec.thread_names().items()):
        trace_events.append(
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": int(tid), "args": {"name": tname}}
        )
    for ev in all_events:
        etype = ev.get("type")
        dur_ms = ev.get("dur_ms")
        if etype == "span":
            name = ev.get("name", "span")
        elif etype in ("update", "compute", "forward"):
            name = f"{ev.get('metric', '?')}.{etype}"
        elif etype in ("sync", "metric_sync", "compile"):
            name = f"{etype}:{ev.get('source') or ev.get('metric') or ev.get('entry') or '?'}"
            if dur_ms is None:
                dur_ms = ev.get("compile_ms", 0.0)
        elif etype in ("enqueue", "dequeue", "flush"):
            # async-pipeline transitions: stamped with the recording
            # thread's id, so dequeues render on the worker's labeled track
            name = f"async.{etype}"
            if ev.get("batch_index") is not None:
                name = f"{name}[{ev['batch_index']}]"
        else:
            continue
        dur_ms = float(dur_ms or 0.0)
        # events carry their END time relative to recorder start ("t");
        # the trace event starts dur earlier
        end_us = float(ev.get("t", 0.0)) * 1e6
        args = {
            k: v
            for k, v in ev.items()
            if k not in ("type", "t", "dur_ms", "tid", "name") and _json_safe(v)
        }
        trace_events.append(
            {
                "name": name,
                "cat": etype,
                "ph": "X",
                "ts": round(max(end_us - dur_ms * 1e3, 0.0), 3),
                "dur": round(dur_ms * 1e3, 3),
                "pid": pid,
                "tid": int(ev.get("tid") or span_tid.get(ev.get("span_id"), 0)),
                "args": args,
            }
        )
    if collector is not None:
        trace_events.extend(_fleet_trace_events(collector, rec, pid, all_events))
    doc = {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": {"recorder": rec.name},
    }
    _atomic_write(path, json.dumps(doc))
    return path


def _fleet_trace_events(
    collector: Any, rec: Any, collector_pid: int, all_events: List[Dict[str, Any]]
) -> List[Dict[str, Any]]:
    """Per-publisher tracks and publish->fold flow arrows (fleet mode).

    Publisher span contexts carry wall-clock publish times; the collector
    recorder's rows are relative to its start (``rec._t0``), so the
    publish instants are moved onto the same timeline. Flows pair by
    ``(publisher, seq)``: the ``s`` end on the publish instant in the
    publisher's process, the ``f`` end on the matching ``fleet_fold`` span."""
    t0_wall = float(getattr(rec, "_t0", 0.0))
    out: List[Dict[str, Any]] = []
    spans_by_pub = collector.publisher_spans()
    # small stable pids per publisher, clear of real process indices
    pub_pid = {name: 1000 + i for i, name in enumerate(sorted(spans_by_pub))}
    flow_ids = itertools.count(1_000_000)
    flow_of: Dict[Any, int] = {}
    for name, ctxs in sorted(spans_by_pub.items()):
        ppid = pub_pid[name]
        out.append({"name": "process_name", "ph": "M", "pid": ppid, "tid": 0, "args": {"name": f"publisher {name}"}})
        for ctx in ctxs:
            ts = round(max((float(ctx.get("t", t0_wall)) - t0_wall) * 1e6, 0.0), 3)
            seq = ctx.get("seq")
            fid = next(flow_ids)
            flow_of[(name, seq)] = fid
            out.append(
                {"name": f"publish[{seq}]", "cat": "fleet", "ph": "i", "s": "p", "ts": ts, "pid": ppid, "tid": 0,
                 "args": {k: v for k, v in ctx.items() if _json_safe(v)}}
            )
            out.append({"name": "publish->fold", "cat": "fleet", "ph": "s", "id": fid, "ts": ts, "pid": ppid, "tid": 0})
    for ev in all_events:
        if ev.get("type") != "span" or ev.get("name") != "fleet_fold":
            continue
        links = (ev.get("attributes") or {}).get("links") or []
        dur_ms = float(ev.get("dur_ms") or 0.0)
        end_us = float(ev.get("t", 0.0)) * 1e6
        ts = round(max(end_us - dur_ms * 1e3, 0.0), 3)
        tid = int(ev.get("tid") or 0)
        for link in links:
            fid = flow_of.get((link.get("publisher"), link.get("seq")))
            if fid is None:
                continue
            out.append(
                {"name": "publish->fold", "cat": "fleet", "ph": "f", "bp": "e", "id": fid, "ts": ts,
                 "pid": collector_pid, "tid": tid}
            )
    return out


def _json_safe(value: Any) -> bool:
    try:
        json.dumps(value)
        return True
    except (TypeError, ValueError):
        return False
