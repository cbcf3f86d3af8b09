"""The port's telemetry recorder, spans, exporters, aggregate and runtime
hooks (``metrics_tpu_torch.observability``) on the CPU.

The contracts of the JAX package's ``tests/bases/test_observability.py``
and ``test_freshness.py``, and the port held to the JAX package: the same
seeded numpy inputs go through both packages with both default recorders
enabled, and the event streams must agree in every field but the timing
ones (``t``, ``dur_ms``, span ids, thread ids, staleness ages); the
Prometheus pages must carry the same family names and label sets; and
``counter_payload``/``merge_payloads`` must agree. Memory event rows are
paced by wall time in both recorders, so the fixture paces them to one per
kind, which makes both streams deterministic.

The disabled path is held to its contract: with the recorder off, no event
is appended, no recorder lock is taken and no clock is read at any hook
site of the runtime. A telemetry-enabled ``compile_update`` gives the same
states as one with telemetry off, and records one ``fused_update`` per
dispatch and no member ``update`` events.
"""
import json
import os
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import metrics_tpu as jm
import metrics_tpu_torch as tm
from metrics_tpu.observability import counter_payload as jax_counter_payload
from metrics_tpu.observability import get_recorder as jax_get_recorder
from metrics_tpu.observability import merge_payloads as jax_merge_payloads
from metrics_tpu.observability import render_prometheus as jax_render_prometheus
from metrics_tpu_torch.observability import (
    TELEMETRY_ENV_VAR,
    aggregate_across_hosts,
    counter_payload,
    current_span_context,
    export_jsonl,
    export_perfetto,
    get_recorder,
    merge_payloads,
    render_prometheus,
    span,
    summary,
    telemetry_enabled,
    write_prometheus,
)
from metrics_tpu_torch.observability.exporters import PeriodicExporter
from metrics_tpu_torch.observability.freshness import IDENTITY
from metrics_tpu_torch.observability.recorder import _DEFAULT_RECORDER, MetricRecorder

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent

#: event fields that carry timing, ids or wall-clock ages
_TIMING = {"t", "dur_ms", "span_id", "parent_id", "tid", "staleness_s", "age_ms"}


def _enable(rec):
    rec.reset()
    rec.enable(recompile_threshold=rec.DEFAULT_RECOMPILE_THRESHOLD, footprint_warn_bytes=None)
    rec.MEMORY_EVENT_INTERVAL_S = 1e9  # one memory event row per boundary kind


def _disable(rec):
    rec.disable()
    rec.footprint_warn_bytes = None
    rec.profile_compiles = False
    rec.recompile_threshold = rec.DEFAULT_RECOMPILE_THRESHOLD
    rec.detach_timeseries()
    rec.__dict__.pop("MEMORY_EVENT_INTERVAL_S", None)
    rec.reset()


@pytest.fixture
def recorders():
    """Both default recorders enabled for one test, and always disabled and
    reset after (tests/conftest.py requires the JAX one off at the end)."""
    port, ref = get_recorder(), jax_get_recorder()
    _enable(port)
    _enable(ref)
    try:
        yield port, ref
    finally:
        _disable(port)
        _disable(ref)


@pytest.fixture
def recorder(recorders):
    return recorders[0]


def _strip(events, types=None):
    out = []
    for e in events:
        if types is not None and e["type"] not in types:
            continue
        out.append({k: v for k, v in e.items() if k not in _TIMING})
    return out


def _batches(seed, n=3, rows=16, classes=None):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if classes is None:
            out.append((rng.random(rows).astype(np.float32), rng.random(rows).astype(np.float32)))
        else:
            preds = rng.random((rows, classes)).astype(np.float32)
            preds /= preds.sum(-1, keepdims=True)
            out.append((preds, rng.integers(0, classes, rows).astype(np.int64)))
    return out


# ---------------------------------------------------------------------------
# the disabled path
# ---------------------------------------------------------------------------


class _Tripwire:
    """Stands in for a clock or a lock: any use fails the test."""

    def __init__(self, what):
        self.what = what

    def __call__(self, *a, **k):
        raise AssertionError(f"{self.what} used with telemetry disabled")

    def __enter__(self):
        raise AssertionError(f"{self.what} taken with telemetry disabled")

    def __exit__(self, *exc):
        return False


def _traffic():
    """Metric traffic through every hook site of the runtime."""
    rng = np.random.default_rng(0)
    p, t = rng.random(16).astype(np.float32), rng.random(16).astype(np.float32)
    m = tm.MeanSquaredError(device="cpu")
    m.update(p, t)
    m.compute()
    m.compute()
    m(p, t)
    m.reset()
    m.sync(dist_sync_fn=lambda x, group=None: [x, x], distributed_available=lambda: True)
    m.unsync()
    col = tm.MetricCollection([tm.Precision(num_classes=3, average="macro", device="cpu"),
                               tm.Recall(num_classes=3, average="macro", device="cpu")])
    (cp, ct), = _batches(1, n=1, classes=3)
    col.update(torch.from_numpy(cp), torch.from_numpy(ct))
    col.update(torch.from_numpy(cp), torch.from_numpy(ct))
    col.compute()
    col(torch.from_numpy(cp), torch.from_numpy(ct))
    col.compile_update()
    col.update(torch.from_numpy(cp), torch.from_numpy(ct))
    handle = col.compile_update_async(queue_depth=2)
    handle.update_async(torch.from_numpy(cp), torch.from_numpy(ct))
    handle.flush()
    col.compute()
    handle.close()
    sl = tm.SlicedMetric(tm.MeanSquaredError(device="cpu"), 4)
    sl.update(torch.tensor([0, 1, 1, 3] * 4), torch.from_numpy(p), torch.from_numpy(t))
    sl.compute(slice_ids=torch.tensor([1, 3]))
    sl.compute()
    w = tm.WindowedMetric(tm.MeanSquaredError(device="cpu"), window=3)
    w.update(p, t)
    w.window_state(2)
    w.compute()
    tracker = tm.MetricTracker(tm.SumMetric(device="cpu"))
    tracker.increment()
    tracker.update(torch.tensor(1.0))


def test_disabled_telemetry_takes_no_event_lock_or_timestamp(monkeypatch):
    import metrics_tpu_torch.collections as collections_mod
    import metrics_tpu_torch.core.fused as fused_mod
    import metrics_tpu_torch.core.metric as metric_mod
    import metrics_tpu_torch.parallel.distributed as dist_mod
    import metrics_tpu_torch.retrieval.base as retrieval_mod
    import metrics_tpu_torch.sliced.metric as sliced_mod
    import metrics_tpu_torch.windowed.metric as windowed_mod

    rec = get_recorder()
    assert not rec.enabled and not telemetry_enabled()
    # the clocks of the hook sites: the metric, the collection, the fused
    # update, the sliced, windowed and retrieval reads and the transport
    fake_time = type("T", (), {"perf_counter": _Tripwire("time.perf_counter"), "time": _Tripwire("time.time")})
    for mod in (metric_mod, collections_mod, fused_mod, sliced_mod, windowed_mod, retrieval_mod):
        monkeypatch.setattr(mod, "time", fake_time)
    monkeypatch.setattr(rec, "_lock", _Tripwire("the recorder lock"))
    monkeypatch.setattr(rec, "_append", _Tripwire("MetricRecorder._append"))
    monkeypatch.setattr(dist_mod, "_span", _Tripwire("a transport span"))
    _traffic()
    monkeypatch.undo()
    assert rec.events() == [] and rec.call_counts() == {} and rec.signature_counts() == {}
    assert rec.sync_totals() == {"sync_events": 0, "gather_bytes": 0, "pad_waste_bytes": 0}
    assert rec.async_totals()["enqueued"] == 0 and rec.memory_totals()["update_boundaries"] == 0


def test_enabled_traffic_records_every_hook_family(recorder):
    _traffic()
    types = {e["type"] for e in recorder.events()}
    assert {
        "update", "compute", "forward", "read", "span", "memory", "metric_sync", "fused_update",
        "compile", "enqueue", "dequeue", "flush", "sliced_scatter", "tracker_increment",
    } <= types


# ---------------------------------------------------------------------------
# lifecycle events against the JAX package
# ---------------------------------------------------------------------------


def _lifecycle(make, batches, forward=True):
    m = make()
    for b in batches:
        m.update(*b)
    m.compute()
    m.compute()  # a cache hit: a read event
    if forward:
        m(*batches[0])
    m.reset()


_METRICS = {
    "mse": (lambda: jm.MeanSquaredError(), lambda: tm.MeanSquaredError(device="cpu"), None),
    "mean": (lambda: jm.MeanMetric(), lambda: tm.MeanMetric(device="cpu"), None),
    "accuracy": (lambda: jm.Accuracy(), lambda: tm.Accuracy(device="cpu"), 4),
    "confusion": (lambda: jm.ConfusionMatrix(num_classes=4), lambda: tm.ConfusionMatrix(num_classes=4, device="cpu"), 4),
    "auroc_sketch": (
        lambda: jm.AUROC(num_classes=4, sketch_capacity=64),
        lambda: tm.AUROC(num_classes=4, sketch_capacity=64, device="cpu"),
        4,
    ),
}


@pytest.mark.parametrize("name", sorted(_METRICS))
def test_lifecycle_events_match_jax(recorders, name):
    port, ref = recorders
    jax_make, port_make, classes = _METRICS[name]
    batches = _batches(3, classes=classes)
    if name == "mean":
        batches = [(b[0],) for b in batches]
    # the same numpy arrays go to both: each records the arguments as given
    _lifecycle(jax_make, batches)
    _lifecycle(port_make, batches)
    want, got = _strip(ref.events()), _strip(port.events())
    assert [e["type"] for e in got] == [e["type"] for e in want]
    assert got == want
    assert port.call_counts() == ref.call_counts()
    assert port.signature_counts() == ref.signature_counts()
    assert port.footprint_high_water_marks() == ref.footprint_high_water_marks()
    assert port.memory_totals()["update_boundaries"] == ref.memory_totals()["update_boundaries"]


def test_recompile_warning_fires_once_like_jax(recorders):
    port, ref = recorders
    for rec in recorders:
        rec.recompile_threshold = 3
    caught = {}
    for key, make, conv in (("jax", jm.MeanMetric, jnp.asarray), ("port", lambda: tm.MeanMetric(device="cpu"), torch.from_numpy)):
        m = make()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            for n in range(1, 10):
                m.update(conv(np.ones(n, np.float32)))
        caught[key] = [x for x in w if "distinct (shape, dtype)" in str(x.message)]
    assert len(caught["port"]) == len(caught["jax"]) == 1
    assert "MeanMetric.update" in str(caught["port"][0].message)
    assert port.signature_counts() == ref.signature_counts() == {"MeanMetric.update": 9}
    assert _strip(port.events(), {"recompile_warning"}) == _strip(ref.events(), {"recompile_warning"})
    # a stable shape does not warn
    m2 = tm.SumMetric(device="cpu")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for _ in range(20):
            m2.update(torch.ones(4))
    assert not [x for x in w if "distinct (shape, dtype)" in str(x.message)]


def test_footprint_high_water_marks_split_like_jax(recorders):
    port, ref = recorders
    for rec in recorders:
        rec.footprint_warn_bytes = 1
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 5, 16).astype(np.int32)
    p, t = rng.random(16).astype(np.float32), rng.random(16).astype(np.float32)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        jsl = jm.SlicedMetric(jm.MeanSquaredError(), 5)
        jsl.update(jnp.asarray(ids), jnp.asarray(p), jnp.asarray(t))
        jwin = jm.WindowedMetric(jm.MeanSquaredError(), window=4)
        jwin.update(jnp.asarray(p), jnp.asarray(t))
        jsk = jm.AUROC(sketch_capacity=32)
        jsk.update(jnp.asarray(p), jnp.asarray((t > 0.5).astype(np.int64)))
        sl = tm.SlicedMetric(tm.MeanSquaredError(device="cpu"), 5)
        sl.update(torch.from_numpy(ids), torch.from_numpy(p), torch.from_numpy(t))
        win = tm.WindowedMetric(tm.MeanSquaredError(device="cpu"), window=4)
        win.update(torch.from_numpy(p), torch.from_numpy(t))
        sk = tm.AUROC(sketch_capacity=32, device="cpu")
        sk.update(torch.from_numpy(p), torch.from_numpy((t > 0.5).astype(np.int64)))
    hwm = port.footprint_high_water_marks()
    assert hwm == ref.footprint_high_water_marks()
    assert {"SlicedMetric[sliced]", "WindowedMetric[windowed]", "AUROC[sketch]"} <= set(hwm)
    assert port.footprint_slice_counts() == ref.footprint_slice_counts() == {"SlicedMetric[sliced]": 5}
    got = _strip(port.events(), {"footprint"})
    assert got == _strip(ref.events(), {"footprint"})
    # the warning fires once per metric label
    assert len([x for x in w if "state footprint" in str(x.message)]) == 2 * 3


def test_set_dtype_footprint_event_like_jax(recorders):
    port, ref = recorders
    jm.MeanSquaredError().set_dtype(jnp.float16)
    tm.MeanSquaredError(device="cpu").set_dtype(torch.float16)
    assert _strip(port.events(), {"footprint"}) == _strip(ref.events(), {"footprint"})
    assert _strip(port.events(), {"footprint"})[0]["cast_to"] == "float16"


def test_collection_spans_and_group_attribution_like_jax(recorders):
    port, ref = recorders
    (p, t), = _batches(5, n=1, classes=3)
    jcol = jm.MetricCollection([jm.Precision(num_classes=3, average="macro"), jm.Recall(num_classes=3, average="macro")])
    col = tm.MetricCollection([tm.Precision(num_classes=3, average="macro", device="cpu"),
                               tm.Recall(num_classes=3, average="macro", device="cpu")])
    for c in (jcol, col):  # the same numpy arrays to both
        c.update(p, t)
        c.update(p, t)
        c.compute()
    grouped = [e for e in port.events() if e.get("compute_group")]
    assert len(grouped) == 1 and sorted(grouped[0]["compute_group"]) == ["Precision", "Recall"]
    got, want = _strip(port.events()), _strip(ref.events())
    for a, b in zip(got, want):
        assert a == b
    assert len(got) == len(want)
    spans = {e["span_id"]: e for e in port.events() if e["type"] == "span"}
    col_updates = [s for s in spans.values() if s["name"] == "MetricCollection.update"]
    assert len(col_updates) == 2
    members = [s for s in spans.values() if s["name"] == "Precision.update"]
    assert members and all(spans[s["parent_id"]]["name"] == "MetricCollection.update" for s in members)


def test_collection_freshness_folds_members_and_ingest(recorder):
    col = tm.MetricCollection([tm.MeanSquaredError(device="cpu"), tm.MeanAbsoluteError(device="cpu")])
    assert col.freshness().is_identity
    p, t = _batches(6, n=1)[0]
    before = time.time()
    col.update(torch.from_numpy(p), torch.from_numpy(t))
    stamp = col.freshness()
    assert stamp.min_event_t >= before and stamp.max_event_t >= stamp.min_event_t
    member = col["MeanSquaredError"].freshness_stamp()
    assert member.min_event_t is not None and stamp.min_event_t <= member.min_event_t
    col.reset()
    assert col.freshness().is_identity and col["MeanSquaredError"].freshness_stamp() == IDENTITY


def test_tracker_increment_events_like_jax(recorders):
    port, ref = recorders
    jt, tt = jm.MetricTracker(jm.SumMetric()), tm.MetricTracker(tm.SumMetric(device="cpu"))
    for epoch in range(3):
        jt.increment()
        jt.update(jnp.asarray(float(epoch)))
        tt.increment()
        tt.update(torch.tensor(float(epoch)))
    incs = _strip(port.events(), {"tracker_increment"})
    assert [e["n_steps"] for e in incs] == [1, 2, 3]
    assert incs == _strip(ref.events(), {"tracker_increment"})


def test_sync_events_like_jax_in_a_simulated_world(recorders):
    port, ref = recorders
    p, t = _batches(7, n=1)[0]
    for m, conv in ((jm.MeanSquaredError(), jnp.asarray), (tm.MeanSquaredError(device="cpu"), torch.from_numpy)):
        m.update(conv(p), conv(t))
        m.sync(dist_sync_fn=lambda x, group=None: [x, x], distributed_available=lambda: True)
        m.unsync()
    for m, conv in ((jm.AUROC(sketch_capacity=64), jnp.asarray), (tm.AUROC(sketch_capacity=64, device="cpu"), torch.from_numpy)):
        m.update(conv(p), conv((t > 0.5).astype(np.int64)))
        m.sync(dist_sync_fn=lambda x, group=None: [x, x, x], distributed_available=lambda: True)
        m.unsync()
    assert _strip(port.events(), {"metric_sync"}) == _strip(ref.events(), {"metric_sync"})
    assert port.sketch_totals()["merges"] == ref.sketch_totals()["merges"] == 2
    spans = [e["name"] for e in port.events() if e["type"] == "span"]
    assert "MeanSquaredError.sync" in spans and "AUROC.sync" in spans


def test_sync_pytree_records_one_sync_event(recorder):
    from metrics_tpu_torch.parallel.distributed import sync_pytree

    col = tm.MetricCollection({"mse": tm.MeanSquaredError(device="cpu"), "max": tm.MaxMetric(device="cpu")},
                              compute_groups=False)
    p, t = _batches(8, n=1)[0]
    col["mse"].update(torch.from_numpy(p), torch.from_numpy(t))
    col["max"].update(torch.from_numpy(p))
    state = {name: {k: getattr(m, k) for k in m._defaults} for name, m in col.items()}
    world = lambda x, group=None: [x, x]  # noqa: E731
    out = sync_pytree(state, col.state_reductions(), dist_sync_fn=world)
    assert float(out["mse"]["total"]) == 2 * 16
    syncs = [e for e in recorder.events() if e["type"] == "sync"]
    assert len(syncs) == 1 and syncs[0]["source"] == "sync_pytree"
    assert syncs[0]["gather_bytes"] > 0 and syncs[0]["n_leaves"] == 3
    assert recorder.sync_totals()["sync_events"] == 1


def test_merge_states_counts_a_sketch_merge(recorders):
    port, ref = recorders
    p, t = _batches(9, n=1)[0]
    for m, conv in ((jm.AUROC(sketch_capacity=32), jnp.asarray), (tm.AUROC(sketch_capacity=32, device="cpu"), torch.from_numpy)):
        s = m.update_state(m.init_state(), conv(p), conv((t > 0.5).astype(np.int64)))
        m.merge_states(s, s)
    assert port.sketch_totals() == ref.sketch_totals()


# ---------------------------------------------------------------------------
# read hooks
# ---------------------------------------------------------------------------


def test_sliced_scatter_and_read_events_like_jax(recorders):
    port, ref = recorders
    rng = np.random.default_rng(10)
    ids = rng.integers(0, 6, 32).astype(np.int32)
    p, t = rng.random(32).astype(np.float32), rng.random(32).astype(np.float32)
    for m, conv in ((jm.SlicedMetric(jm.MeanSquaredError(), 6), jnp.asarray),
                    (tm.SlicedMetric(tm.MeanSquaredError(device="cpu"), 6), torch.from_numpy)):
        m.update(conv(ids), conv(p), conv(t))
        m.compute(slice_ids=conv(np.asarray([1, 4], np.int32)))
        m.compute()
    want = _strip(ref.events(), {"sliced_scatter", "read"})
    got = _strip(port.events(), {"sliced_scatter", "read"})
    assert got == want
    assert port.sliced_totals() == ref.sliced_totals()
    assert got[0]["in_jit"] is False and got[0]["n_slices"] == 6


def test_sliced_hot_rows_with_a_time_series(recorder):
    recorder.attach_timeseries(device="cpu", clock=lambda: 50.0)
    sl = tm.SlicedMetric(tm.MeanSquaredError(device="cpu"), 4)
    ids = torch.tensor([2] * 12 + [0] * 4)
    sl.update(ids, torch.rand(16), torch.rand(16))
    ev = [e for e in recorder.events() if e["type"] == "sliced_scatter"][0]
    assert ev["hot_rows"] == 12
    assert recorder.timeseries.get("hot_slice_share").mean() == 12 / 16


def test_sliced_scatter_in_a_fused_update_records_once_per_entry(recorder):
    col = tm.MetricCollection({"s": tm.SlicedMetric(tm.MeanSquaredError(device="cpu"), 4)})
    col.compile_update()
    for _ in range(3):
        col.update(torch.tensor([0, 1, 2, 3]), torch.rand(4), torch.rand(4))
    scatters = [e for e in recorder.events() if e["type"] == "sliced_scatter"]
    assert [e["in_jit"] for e in scatters] == [True]
    assert "hot_rows" not in scatters[0]


def test_windowed_read_events_and_ring_freshness(recorders):
    port, ref = recorders
    batches = _batches(11, n=5)
    for m, conv in ((jm.WindowedMetric(jm.MeanSquaredError(), window=3), jnp.asarray),
                    (tm.WindowedMetric(tm.MeanSquaredError(device="cpu"), window=3), torch.from_numpy)):
        for b in batches:
            m.update(*(conv(x) for x in b))
        m.window_state(2)
        m.compute()
    reads = _strip(port.events(), {"read"})
    want = _strip(ref.events(), {"read"})
    assert [(e["kind"], e["ring_buckets"]) for e in reads] == [(e["kind"], e["ring_buckets"]) for e in want]
    assert reads[0]["kind"] == "window" and reads[0]["ring_buckets"] == 2
    w = tm.WindowedMetric(tm.MeanSquaredError(device="cpu"), window=3)
    t0 = time.time()
    w.update(*(torch.from_numpy(x) for x in batches[0]))
    stamp = w.freshness_stamp(now=t0 + 10.0)
    assert stamp.min_event_t >= t0 and 9.0 < stamp.ring_span_s <= 10.0
    w.reset()
    assert w.freshness_stamp().is_identity


def test_windowed_ring_clock_mirror_reads_the_card_once_after_an_install(recorder):
    w = tm.WindowedMetric(tm.MeanSquaredError(device="cpu"), window=2, updates_per_bucket=2)
    b = [torch.from_numpy(x) for x in _batches(12, n=1)[0]]
    w.update(*b)
    assert w._host_count == 1
    w.load_state_dict(w.state_dict())  # an install: the host clock is unknown
    assert w._host_count is None
    w.update(*b)
    assert w._host_count == 2 and w._bucket_wall[0] is not None


def test_retrieval_read_extras(recorder):
    r = tm.RetrievalMAP(device="cpu")
    rng = np.random.default_rng(13)
    idx = torch.from_numpy(rng.integers(0, 5, 40))
    r.update(torch.rand(40), torch.from_numpy(rng.integers(0, 2, 40)), indexes=idx)
    r.compute()
    r._computed = None  # a second cold read of the unwritten table: a layout memo hit
    r.compute()
    reads = [e for e in recorder.events() if e["type"] == "read"]
    assert [e["cache_hit"] for e in reads] == [False, True]
    assert reads[0]["table_rows"] == 5 and reads[0]["layout_entries"] >= 1
    r.table_rows_layout([0, 1])
    table = [e for e in recorder.events() if e["type"] == "read" and e["kind"] == "table"]
    assert table and table[0]["table_rows"] == 2


# ---------------------------------------------------------------------------
# the fused and async updates
# ---------------------------------------------------------------------------


def _fused_run(telemetry):
    rec = get_recorder()
    if telemetry:
        _enable(rec)
    try:
        col = tm.MetricCollection([tm.ConfusionMatrix(num_classes=5, device="cpu"),
                                   tm.AUROC(num_classes=5, capacity=64, device="cpu"),
                                   tm.Accuracy(device="cpu")])
        col.compile_update()
        for p, t in _batches(14, n=4, rows=24, classes=5):
            col.update(torch.from_numpy(p), torch.from_numpy(t))
        states = {n: {k: getattr(m, k).clone() for k in m._defaults if isinstance(getattr(m, k), torch.Tensor)}
                  for n, m in col.items()}
        return states, _strip(rec.events()), col
    finally:
        if telemetry:
            _disable(rec)


def test_fused_update_states_equal_with_telemetry_on_and_off():
    off, off_events, _ = _fused_run(False)
    on, events, col = _fused_run(True)
    assert off_events == []
    for name in off:
        for k in off[name]:
            assert torch.equal(off[name][k], on[name][k]), (name, k)
    types = [e["type"] for e in events]
    assert types.count("fused_update") == 4
    # member updates run inside the fused function: no update events
    assert "update" not in types
    assert types.count("compile") == col.fused_update.n_compiles
    fused = [e for e in events if e["type"] == "fused_update"]
    assert all(e["n_metrics"] == 3 and e["batch_rows"] == 24 for e in fused)
    # the first dispatch captures; compute groups change nothing here
    assert [e["cache_hit"] for e in fused] == [False, True, True, True]


def test_fused_update_events_match_jax(recorders):
    port, ref = recorders
    batches = _batches(15, n=3, rows=24, classes=5)
    jcol = jm.MetricCollection([jm.ConfusionMatrix(num_classes=5), jm.Accuracy()])
    col = tm.MetricCollection([tm.ConfusionMatrix(num_classes=5, device="cpu"), tm.Accuracy(device="cpu")])
    for c, conv in ((jcol, jnp.asarray), (col, torch.from_numpy)):
        c.compile_update()
        for p, t in batches:
            c.update(conv(p), conv(t))
    keys = ("n_metrics", "n_fused", "n_fallback", "batch_rows", "n_groups", "cache_entries", "cache_hit")
    got = [{k: e.get(k) for k in keys} for e in port.events() if e["type"] == "fused_update"]
    want = [{k: e.get(k) for k in keys} for e in ref.events() if e["type"] == "fused_update"]
    assert got == want
    assert port.fused_update_totals() == ref.fused_update_totals()
    assert port.signature_counts() == ref.signature_counts()
    assert [e["type"] for e in port.events()].count("compile") == [e["type"] for e in ref.events()].count("compile")


def test_async_pipeline_events_like_jax(recorders):
    port, ref = recorders
    batches = _batches(16, n=5, rows=24, classes=3)
    jcol = jm.MetricCollection([jm.MeanSquaredError()])
    col = tm.MetricCollection([tm.MeanSquaredError(device="cpu")])
    for c, conv in ((jcol, jnp.asarray), (col, torch.from_numpy)):
        c.update(conv(batches[0][0][:, 0].copy()), conv(batches[0][0][:, 1].copy()))
        h = c.compile_update_async(queue_depth=8)
        for p, _ in batches:
            h.update_async(conv(p[:, 0].copy()), conv(p[:, 1].copy()))
        h.flush()
        c.compute()
        h.close()
    counted = ("enqueue", "dequeue", "flush")
    assert [e["type"] for e in port.events() if e["type"] in counted] == [
        e["type"] for e in ref.events() if e["type"] in counted
    ]
    keys = ("enqueued", "applied", "dropped", "flushes")
    assert {k: port.async_totals()[k] for k in keys} == {k: ref.async_totals()[k] for k in keys}
    assert port.async_totals()["enqueued"] == 5
    deq = [e for e in port.events() if e["type"] == "dequeue"]
    worker = [e["tid"] for e in deq]
    assert set(worker) != {threading.get_ident()}
    assert port.thread_names()[worker[0]] == "metrics-tpu-torch-async-update"
    assert all(e["age_ms"] >= 0 for e in deq)


def test_async_drop_is_counted_not_streamed(recorder):
    class Slow(tm.SumMetric):
        def _update(self, value):
            time.sleep(0.05)
            super()._update(value)

    col = tm.MetricCollection([Slow(device="cpu")])
    col.update(torch.tensor(1.0))
    h = col.compile_update_async(queue_depth=1, policy="drop")
    accepted = sum(bool(h.update_async(torch.tensor(1.0))) for _ in range(10))
    h.flush()
    totals = recorder.async_totals()
    assert totals["dropped"] == 10 - accepted > 0
    assert [e["type"] for e in recorder.events()].count("enqueue") == accepted
    assert "drop" not in {e["type"] for e in recorder.events()}
    col.compute()  # a bounded-staleness snapshot: counter only
    h.close()
    assert recorder.async_totals()["flushes"] == 2


# ---------------------------------------------------------------------------
# spans, exporters and the aggregate
# ---------------------------------------------------------------------------


def test_span_nesting_and_context(recorder):
    assert current_span_context() is None
    with span("outer", epoch=3) as outer:
        ctx = current_span_context()
        assert ctx["span_id"] == outer.span_id and ctx["parent_id"] is None
        with span("inner") as inner:
            tm.SumMetric(device="cpu").update(torch.tensor(1.0))
    spans = {e["name"]: e for e in recorder.events() if e["type"] == "span"}
    assert spans["inner"]["parent_id"] == outer.span_id
    assert spans["outer"]["attributes"] == {"epoch": 3}
    upd = [e for e in recorder.events() if e["type"] == "update"][0]
    assert spans["SumMetric.update"]["parent_id"] == inner.span_id and upd["span_id"] == spans["SumMetric.update"]["span_id"]


def test_disabled_span_draws_no_id():
    with span("x") as s:
        pass
    assert s.span_id is None and get_recorder().events() == []


def test_profiling_annotation_reaches_the_torch_profiler(recorder):
    m = tm.SumMetric(device="cpu")
    m.enable_profiling = True
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        m.update(torch.tensor(2.0))
        m.compute()
    names = {e.key for e in prof.key_averages()}
    assert {"SumMetric.update", "SumMetric.compute"} <= names


def test_jsonl_perfetto_and_prometheus_round_trip(tmp_path, recorder):
    m = tm.MeanMetric(device="cpu")
    with span("epoch"):
        m.update(torch.ones(4))
        m.compute()
    recorder.record_sync("gather_all_arrays", gather_bytes=1024, world_size=4, pad_waste_bytes=128)
    path = tmp_path / "t.jsonl"
    assert export_jsonl(str(path), recorder) == str(path)
    events = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(events) == len(recorder.events()) and {"update", "compute", "sync", "span"} <= {e["type"] for e in events}
    export_jsonl(str(path), recorder, append=True)
    assert len(path.read_text().splitlines()) == 2 * len(events)
    trace = tmp_path / "t.perfetto.json"
    assert export_perfetto(str(trace), recorder) == str(trace)
    doc = json.loads(trace.read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"epoch", "MeanMetric.update", "MeanMetric.compute", "process_name"} <= names
    prom_path = tmp_path / "t.prom"
    assert write_prometheus(str(prom_path), recorder) == str(prom_path)
    prom = prom_path.read_text()
    assert 'metrics_tpu_calls_total{metric="MeanMetric",phase="update"} 1' in prom
    assert "metrics_tpu_gather_bytes_total 1024" in prom
    text = summary(recorder)
    assert "MeanMetric" in text and "1024 gather bytes" in text


def _families(page):
    """{family: sorted label-name tuples} of a Prometheus page."""
    out = {}
    for line in page.splitlines():
        if line.startswith("# TYPE"):
            out.setdefault(line.split()[2], set())
        elif line and not line.startswith("#"):
            name = line.split("{")[0].split(" ")[0]
            labels = ()
            if "{" in line:
                inner = line[line.index("{") + 1 : line.rindex("}")]
                labels = tuple(sorted(kv.split("=")[0] for kv in inner.split('",') if kv))
            base = name
            for suffix in ("_bucket", "_sum", "_count"):
                if name.endswith(suffix) and name[: -len(suffix)] in out:
                    base = name[: -len(suffix)]
            out.setdefault(base, set()).add(labels)
    return out


def test_prometheus_families_match_jax(recorders):
    port, ref = recorders
    port.attach_timeseries(device="cpu", clock=lambda: 100.0)
    ref.attach_timeseries(clock=lambda: 100.0)
    p, t = _batches(17, n=1)[0]
    ids = np.arange(16, dtype=np.int32) % 4
    for pkg, conv in ((jm, jnp.asarray), (tm, torch.from_numpy)):
        kw = {} if pkg is jm else {"device": "cpu"}
        m = pkg.MeanSquaredError(**kw)
        m.update(conv(p), conv(t))
        m.compute()
        sl = pkg.SlicedMetric(pkg.MeanSquaredError(**kw), 4)
        sl.update(conv(ids), conv(p), conv(t))
        col = pkg.MetricCollection([pkg.MeanAbsoluteError(**kw)])
        col.compile_update()
        col.update(conv(p), conv(t))
    for rec in recorders:
        rec.record_sync("gather_all_arrays", gather_bytes=64, world_size=2)
        rec.record_drift_score("scores", "psi", 0.5)
    got, want = _families(render_prometheus(port)), _families(jax_render_prometheus(ref))
    assert set(got) == set(want)
    for fam in want:
        assert got[fam] == want[fam], fam


def test_counter_payload_and_merge_match_jax(recorders):
    port, ref = recorders
    p, t = _batches(18, n=1)[0]
    for m, conv in ((jm.MeanSquaredError(), jnp.asarray), (tm.MeanSquaredError(device="cpu"), torch.from_numpy)):
        m.update(conv(p), conv(t))
        m.compute()
    skip = {"host", "t", "seq", "call_times", "compile_times", "read_totals", "freshness", "memory", "timeseries"}
    a, b = counter_payload(port), jax_counter_payload(ref)
    assert {k: v for k, v in a.items() if k not in skip} == {k: v for k, v in b.items() if k not in skip}
    a2 = counter_payload(port)
    assert a2["seq"] == a["seq"] + 1  # monotonic provenance
    mine = merge_payloads([a, a2])
    theirs = jax_merge_payloads([a, a2])
    assert mine == theirs
    assert mine["call_counts"][("MeanSquaredError", "update")] == 2 and mine["world_size"] == 2


def test_aggregate_in_one_process_is_the_local_payload(recorder):
    tm.SumMetric(device="cpu").update(torch.tensor(1.0))
    agg = aggregate_across_hosts(recorder)
    assert agg["world_size"] == 1 and agg["call_counts"] == {("SumMetric", "update"): 1}
    page = render_prometheus(recorder, aggregate=agg)
    assert 'metrics_tpu_calls_total{metric="SumMetric",phase="update"} 1' in page and 'process="0"' in page


def test_exports_are_rank_zero_gated(tmp_path, recorder, monkeypatch):
    import metrics_tpu_torch.parallel.distributed as dist_mod

    monkeypatch.setattr(dist_mod, "process_index", lambda: 1)
    assert export_jsonl(str(tmp_path / "x.jsonl"), recorder) is None
    assert render_prometheus(recorder) == "" and summary(recorder) == ""
    assert export_perfetto(str(tmp_path / "x.json"), recorder) is None
    ex = PeriodicExporter(interval_s=0.05, jsonl_path=str(tmp_path / "y.jsonl"), recorder=recorder).start()
    assert ex._thread is None
    assert not list(tmp_path.iterdir())


def test_periodic_exporter_thread_ticks_and_stops(tmp_path, recorder):
    before = set(threading.enumerate())
    jsonl, prom = tmp_path / "e.jsonl", tmp_path / "e.prom"
    ex = PeriodicExporter(interval_s=0.02, jsonl_path=str(jsonl), prometheus_path=str(prom), recorder=recorder)
    ex.start()
    started = [t for t in threading.enumerate() if t not in before]
    assert [t.name for t in started] == ["metrics-tpu-torch-telemetry-export"]
    tm.SumMetric(device="cpu").update(torch.tensor(1.0))
    deadline = time.monotonic() + 5
    while not jsonl.exists() and time.monotonic() < deadline:
        time.sleep(0.01)
    ex.stop()
    assert not started[0].is_alive()
    assert [json.loads(x)["type"] for x in jsonl.read_text().splitlines()][0] == "update"
    assert "metrics_tpu_calls_total" in prom.read_text()
    with pytest.raises(ValueError):
        PeriodicExporter(interval_s=1.0)


def test_periodic_exporter_survives_bad_ticks(tmp_path, recorder):
    ex = PeriodicExporter(interval_s=0.01, jsonl_path=str(tmp_path / "missing" / "e.jsonl"), recorder=recorder)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ex.start()
        deadline = time.monotonic() + 5
        while ex.export_errors < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        thread = ex._thread
        assert thread.is_alive()  # failed ticks do not kill the thread
        ex.stop()
    assert not thread.is_alive()
    assert ex.export_errors >= 3 and recorder.export_errors() >= 3
    assert len([w for w in caught if "PeriodicExporter tick failed" in str(w.message)]) == 1
    assert "export_error" in {e["type"] for e in recorder.events()}


def test_package_exports_every_ported_name_of_the_jax_package():
    import metrics_tpu.observability as jax_obs
    import metrics_tpu_torch.observability as obs

    missing = set(jax_obs.__all__) - set(obs.__all__)
    assert missing == set()
    assert not hasattr(obs, "FLEET_NAMES_NOT_PORTED")
    assert set(obs.__all__) - set(jax_obs.__all__) == {"IDENTITY"}
    for name in obs.__all__:
        assert getattr(obs, name) is not None


def test_named_recorders_are_independent(recorder):
    other = get_recorder("side-channel")
    assert other is not recorder and not other.enabled and get_recorder("side-channel") is other
    assert isinstance(other, MetricRecorder)


def test_environment_variable_switches_only_the_port_on(tmp_path):
    assert TELEMETRY_ENV_VAR == "METRICS_TPU_TORCH_TELEMETRY" != "METRICS_TPU_TELEMETRY"
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['metrics_tpu'] = None\n"
        "import metrics_tpu_torch as tm\n"
        "from metrics_tpu_torch.observability import get_recorder, maybe_export_env\n"
        "assert get_recorder().enabled\n"
        "import torch; tm.SumMetric(device='cpu').update(torch.tensor(1.0))\n"
        "print(maybe_export_env())\n"
    )
    path = tmp_path / "env.jsonl"
    env = {**os.environ, TELEMETRY_ENV_VAR: str(path)}
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(path)
    assert json.loads(path.read_text().splitlines()[0])["type"] == "update"
    assert not jax_get_recorder().enabled and not _DEFAULT_RECORDER.enabled


def test_activate_telemetry_parses_the_flag(tmp_path, monkeypatch):
    from metrics_tpu_torch.observability import activate_telemetry

    monkeypatch.delenv(TELEMETRY_ENV_VAR, raising=False)
    path, rest = activate_telemetry(["--x", f"--telemetry={tmp_path / 'a.jsonl'}"])
    try:
        assert rest == ["--x"] and os.environ[TELEMETRY_ENV_VAR] == path and _DEFAULT_RECORDER.enabled
        assert Path(path).exists()
    finally:
        _disable(_DEFAULT_RECORDER)
    assert activate_telemetry(["--y"]) == (None, ["--y"])
