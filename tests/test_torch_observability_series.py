"""The port's sketch-backed telemetry time series
(``metrics_tpu_torch.observability.timeseries``) on the CPU.

The contracts of the JAX package's ``tests/bases/test_timeseries.py`` with
every observation at an injected time, and the port held to the JAX
package: the same observations at the same times go into both packages'
series, and the scalar window statistics must be equal, the payloads equal
with every sketch row bit-equal inside the lossless window (fewer
observations per bucket than ``sketch_capacity``), and quantiles past it
within the sketch's advertised rank-error bound of the pooled values.

The port's own contracts: a flush absorbs fixed ``[sketch_capacity]``
chunks padded with weight-0 rows (one shape for every flush); an inline
flush waits while the caller's stream captures a graph; the recorder's
hooks feed the standard series; ``device=None`` means the card, which
raises without one.
"""
import numpy as np
import pytest
import torch

from metrics_tpu.observability.timeseries import TelemetrySeries as JaxSeries
from metrics_tpu.observability.timeseries import TimeSeriesRegistry as JaxRegistry
from metrics_tpu.observability.timeseries import merge_registry_payloads as jax_merge_registry_payloads
import metrics_tpu_torch as tm
from metrics_tpu_torch.observability import get_recorder, render_prometheus, summary
from metrics_tpu_torch.observability import timeseries as ts_mod
from metrics_tpu_torch.observability.aggregate import counter_payload, merge_payloads
from metrics_tpu_torch.observability.recorder import (
    SERIES_ASYNC_ENQUEUED,
    SERIES_FUSED_DISPATCH_MS,
    SERIES_INGEST_ROWS,
    SERIES_RECOMPILES,
    SERIES_SCORES,
    SERIES_SKETCH_FILL,
    SERIES_UPDATE_MS,
)
from metrics_tpu_torch.observability.timeseries import (
    TelemetrySeries,
    TimeSeriesRegistry,
    merge_registry_payloads,
    registry_from_payload,
    series_from_payload,
)
from metrics_tpu_torch.sketches.quantile import rank_error_bound

torch.set_num_threads(2)

T0 = 10_000.0  # explicit timestamps: no test depends on the wall clock


def _rank_err(vals, est, q):
    return abs(float(np.mean(np.asarray(vals) <= est)) - q)


def _pending(series):
    """Observations recorded but not yet folded into a sketch."""
    return sum(len(b.pending) for b in series._ring if b is not None)


def _feed(series_list, vals, times):
    for s in series_list:
        for v, t in zip(vals, times):
            s.record(float(v), t=float(t))


@pytest.fixture
def recorder():
    rec = get_recorder()
    rec.reset()
    rec.enable()
    rec.attach_timeseries(bucket_seconds=1.0, n_buckets=60, sketch_capacity=64, device="cpu")
    try:
        yield rec
    finally:
        rec.disable()
        rec.detach_timeseries()
        rec.reset()


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        assert TelemetrySeries("x").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TimeSeriesRegistry()
    assert TimeSeriesRegistry(device="cpu").series("x").device.type == "cpu"


@pytest.mark.parametrize("kind", ["distribution", "counter"])
def test_window_statistics_match_jax(kind):
    rng = np.random.default_rng(0)
    vals = rng.normal(5.0, 2.0, 300)
    times = T0 + rng.uniform(0.0, 12.0, 300)
    mine = TelemetrySeries("s", kind=kind, n_buckets=10, sketch_capacity=64, device="cpu")
    ref = JaxSeries("s", kind=kind, n_buckets=10, sketch_capacity=64)
    _feed([mine, ref], vals, times)
    now = T0 + 12.0
    for w in (None, 0.5, 3.0, 9.5):
        assert mine.count(w, now=now) == ref.count(w, now=now)
        assert mine.total(w, now=now) == ref.total(w, now=now)
        assert mine.mean(w, now=now) == ref.mean(w, now=now)
        assert mine.value_min(w, now=now) == ref.value_min(w, now=now)
        assert mine.value_max(w, now=now) == ref.value_max(w, now=now)
    assert mine.rate(4.0, now=now) == ref.rate(4.0, now=now)
    assert mine.window_count() == ref.window_count()


def test_payload_sketch_rows_bit_equal_inside_the_lossless_window():
    rng = np.random.default_rng(1)
    cap = 64
    vals = rng.uniform(0.0, 100.0, 400).astype(np.float32)
    times = T0 + np.repeat(np.arange(8), 50)  # 50 per bucket < capacity
    mine = TelemetrySeries("lat", n_buckets=10, sketch_capacity=cap, device="cpu")
    ref = JaxSeries("lat", n_buckets=10, sketch_capacity=cap)
    _feed([mine, ref], vals, times)
    a, b = mine.to_payload(), ref.to_payload()
    assert a == b
    for row_a, row_b in zip(a["buckets"], b["buckets"]):
        sa = np.asarray(row_a["sk"], np.float32)
        sb = np.asarray(row_b["sk"], np.float32)
        np.testing.assert_array_equal(sa.view(np.int32), sb.view(np.int32))
        assert len(row_a["sk"]) == 50
    q = (0.1, 0.5, 0.99)
    assert mine.quantiles(q, window_s=10, now=T0 + 8) == ref.quantiles(q, window_s=10, now=T0 + 8)


def test_quantiles_past_capacity_within_the_rank_error_bound():
    rng = np.random.default_rng(7)
    cap = 64
    vals = rng.uniform(0.0, 100.0, 3000)
    times = T0 + (np.arange(3000) % 10)
    mine = TelemetrySeries("lat", n_buckets=20, sketch_capacity=cap, device="cpu")
    ref = JaxSeries("lat", n_buckets=20, sketch_capacity=cap)
    _feed([mine, ref], vals, times)
    bound = rank_error_bound(len(vals), cap) / len(vals)
    qs = (0.5, 0.95, 0.99)
    got = mine.quantiles(qs, window_s=20, now=T0 + 10)
    want = ref.quantiles(qs, window_s=20, now=T0 + 10)
    for q, g, w in zip(qs, got, want):
        assert _rank_err(vals, g, q) <= bound
        assert _rank_err(vals, w, q) <= bound


def test_inline_flush_bound_many_values_one_bucket():
    s = TelemetrySeries("lat", n_buckets=4, sketch_capacity=16, device="cpu")
    vals = np.arange(5000, dtype=np.float64)
    _feed([s], vals, [T0] * 5000)
    assert _pending(s) < s._flush_at  # flushed inline on the way
    assert s.count(None, now=T0) == 5000
    est = s.quantile(0.5, window_s=None, now=T0)
    assert _rank_err(vals, est, 0.5) <= rank_error_bound(5000, 16) / 5000


def test_a_flush_waits_while_the_stream_captures(monkeypatch):
    s = TelemetrySeries("lat", n_buckets=4, sketch_capacity=16, device="cpu")
    monkeypatch.setattr(ts_mod, "_capturing", lambda: True)
    _feed([s], np.arange(2000.0), [T0] * 2000)
    assert _pending(s) == 2000  # nothing was launched inside the "capture"
    monkeypatch.undo()
    assert s.quantile(0.5, now=T0) is not None  # the next query flushes
    assert _pending(s) == 0 and s.count(None, now=T0) == 2000


def test_every_flush_absorbs_one_chunk_shape(monkeypatch):
    import metrics_tpu_torch.sketches.quantile as quantile

    shapes = []
    real = quantile.qsketch_insert

    def spy(sketch, key, *a, **k):
        shapes.append((tuple(key.shape), k.get("n_valid")))
        return real(sketch, key, *a, **k)

    monkeypatch.setattr(quantile, "qsketch_insert", spy)
    s = TelemetrySeries("lat", n_buckets=4, sketch_capacity=32, device="cpu")
    _feed([s], np.arange(5.0), [T0] * 5)
    s.housekeep()
    _feed([s], np.arange(70.0), [T0] * 70)
    s.housekeep()
    assert shapes == [((32,), 5), ((32,), 32), ((32,), 32), ((32,), 6)]


def test_host_int_n_valid_bounds_the_occupancy():
    from metrics_tpu_torch.sketches.quantile import fill_bound, qsketch_init, qsketch_insert

    sk = qsketch_init(32, device="cpu")
    sk = qsketch_insert(sk, torch.arange(32.0), n_valid=5)
    assert fill_bound(sk) == 5 and int((sk[:, 0] > 0).sum()) == 5
    sk = qsketch_insert(sk, torch.arange(32.0), n_valid=torch.tensor(3))
    assert fill_bound(sk) == 32  # a tensor n_valid says nothing to the host
    assert int((sk[:, 0] > 0).sum()) == 8


def test_payload_round_trip_and_merge_match_jax():
    rng = np.random.default_rng(3)
    hosts, ref_hosts, pooled = [], [], []
    for h in range(3):
        vals = rng.uniform(h * 40.0, h * 40.0 + 100.0, 700)
        times = T0 + (np.arange(700) % 8)
        mine = TimeSeriesRegistry(n_buckets=20, sketch_capacity=64, device="cpu")
        ref = JaxRegistry(n_buckets=20, sketch_capacity=64)
        for v, t in zip(vals, times):
            mine.observe("lat_ms", float(v), t=float(t))
            ref.observe("lat_ms", float(v), t=float(t))
        hosts.append(mine.payload())
        ref_hosts.append(ref.payload())
        pooled.append(vals)
    pooled = np.concatenate(pooled)
    merged = merge_registry_payloads(hosts, device="cpu")
    want = jax_merge_registry_payloads(ref_hosts)
    a, b = merged["lat_ms"], want["lat_ms"]
    assert [(r["i"], r["c"], r["mn"], r["mx"]) for r in a["buckets"]] == [
        (r["i"], r["c"], r["mn"], r["mx"]) for r in b["buckets"]
    ]
    s = registry_from_payload(merged, device="cpu").get("lat_ms")
    now = T0 + 8
    assert s.count(20, now=now) == len(pooled)
    assert s.total(20, now=now) == pytest.approx(float(pooled.sum()), rel=1e-9)
    bound = rank_error_bound(len(pooled), 64) / len(pooled)
    for q in (0.5, 0.95, 0.99):
        assert _rank_err(pooled, s.quantile(q, window_s=20, now=now), q) <= bound
    clone = series_from_payload(hosts[0]["lat_ms"], device="cpu")
    assert clone.to_payload() == hosts[0]["lat_ms"]


def test_merge_heterogeneous_and_stale_hosts():
    a = TimeSeriesRegistry(n_buckets=8, device="cpu")
    a.observe("only_a", 1.0, t=T0)
    a.observe("shared", 2.0, t=T0)
    b = TimeSeriesRegistry(n_buckets=8, device="cpu")
    b.observe("shared", 3.0, t=T0)
    reg = registry_from_payload(merge_registry_payloads([a.payload(), b.payload(), {}], device="cpu"), device="cpu")
    assert reg.get("only_a").count(None, now=T0) == 1 and reg.get("shared").total(None, now=T0) == 5.0
    fresh = TimeSeriesRegistry(n_buckets=10, device="cpu")
    fresh.observe("s", 5.0, t=T0 + 100)
    stale = TimeSeriesRegistry(n_buckets=10, device="cpu")
    stale.observe("s", 7.0, t=T0 + 90)
    for order in ([fresh, stale], [stale, fresh]):
        s = registry_from_payload(merge_registry_payloads([r.payload() for r in order], device="cpu"), device="cpu").get("s")
        assert s.count(5, now=T0 + 100) == 1 and s.total(5, now=T0 + 100) == 5.0


def test_ring_expiry_sub_bucket_windows_and_empty_windows():
    s = TelemetrySeries("x", kind="counter", n_buckets=4, device="cpu")
    for i in range(10):
        s.record(1.0, t=T0 + i)
    assert s.count(None, now=T0 + 9) == 4  # the ring holds its last four buckets
    assert s.count(0.2, now=T0 + 9.5) == 1  # a sub-bucket window still covers the current bucket
    d = TelemetrySeries("d", n_buckets=4, device="cpu")
    assert d.quantile(0.5, now=T0) is None and d.window_sketch(now=T0) is None and d.mean(now=T0) is None
    with pytest.raises(ValueError):
        s.quantile(0.5, now=T0)
    for bad in ({"kind": "gauge"}, {"bucket_seconds": 0}, {"n_buckets": 1}, {"sketch_capacity": 4}):
        with pytest.raises(ValueError):
            TelemetrySeries("x", device="cpu", **bad)


def test_registry_get_or_create_reset_and_housekeep():
    reg = TimeSeriesRegistry(n_buckets=8, device="cpu")
    s = reg.series("a", kind="counter")
    assert reg.series("a", kind="distribution") is s and s.kind == "counter"
    reg.observe("b", 2.0, t=T0)
    assert reg.names() == ["a", "b"] and reg.housekeep() == 1
    reg.reset()
    assert reg.get("b").count(None, now=T0) == 0 and reg.names() == ["a", "b"]


# ---------------------------------------------------------------------------
# the recorder's feeds
# ---------------------------------------------------------------------------


def test_lifecycle_and_recompile_feeds(recorder):
    m = tm.MeanMetric(device="cpu")
    for n in (4, 4, 5):
        m.update(torch.ones(n))
    reg = recorder.timeseries
    assert reg.get(SERIES_UPDATE_MS).count() == 3
    assert reg.get(SERIES_RECOMPILES).total() == 2  # two distinct signatures
    assert reg.get(SERIES_RECOMPILES).kind == "counter"


def test_disabled_recorder_feeds_nothing():
    rec = get_recorder()
    reg = rec.attach_timeseries(device="cpu")
    try:
        tm.MeanMetric(device="cpu").update(torch.ones(3))
        rec.record_scores(np.ones(10))
        assert reg.names() == []
    finally:
        rec.detach_timeseries()


def test_reset_clears_series_but_keeps_the_registry(recorder):
    tm.MeanMetric(device="cpu").update(torch.ones(3))
    reg = recorder.timeseries
    recorder.reset()
    assert recorder.timeseries is reg and reg.get(SERIES_UPDATE_MS).count() == 0
    recorder.detach_timeseries()
    tm.MeanMetric(device="cpu").update(torch.ones(3))
    assert reg.get(SERIES_UPDATE_MS).count() == 0


def test_fused_async_and_sketch_fill_feeds(recorder):
    col = tm.MetricCollection([tm.MeanSquaredError(device="cpu")])
    col.compile_update()
    for _ in range(3):
        col.update(torch.rand(12), torch.rand(12))
    reg = recorder.timeseries
    assert reg.get(SERIES_FUSED_DISPATCH_MS).count() == 3
    assert reg.get(SERIES_INGEST_ROWS).total() == 36
    h = col.compile_update_async(queue_depth=4)
    h.update_async(torch.rand(12), torch.rand(12))
    h.flush()
    h.close()
    assert reg.get(SERIES_ASYNC_ENQUEUED).total() == 1
    a = tm.AUROC(sketch_capacity=16, device="cpu")
    a.update(torch.rand(8), torch.tensor([0, 1] * 4))
    a.compute()
    assert reg.get(SERIES_SKETCH_FILL).value_max() == 0.5


def test_record_scores_samples_the_whole_batch(recorder):
    recorder.record_scores(torch.arange(100.0), max_samples=10)
    s = recorder.timeseries.get(SERIES_SCORES)
    assert s.count() == 10 and s.value_max() == 90.0 and s.value_min() == 0.0


def test_aggregate_payload_carries_the_series(recorder):
    recorder.timeseries.observe("lat", 3.0, t=T0)
    payload = counter_payload(recorder)
    assert payload["timeseries"]["lat"]["buckets"][0]["c"] == 1
    merged = merge_payloads([payload, payload], device="cpu")
    assert merged["timeseries"]["lat"]["buckets"][0]["c"] == 2


def test_window_families_on_the_page_and_in_the_summary(recorder):
    clock = [T0]
    reg = recorder.attach_timeseries(device="cpu", clock=lambda: clock[0], sketch_capacity=64)
    for v in (0.002, 0.02, 0.2, 2.0):
        reg.observe("lat", v)
    reg.observe("hits", 1.0, kind="counter")
    page = render_prometheus(recorder)
    assert 'metrics_tpu_window_count{series="lat",window_s="60"} 4' in page
    assert 'metrics_tpu_window_quantile{series="lat",q="0.5",window_s="60"}' in page
    assert 'metrics_tpu_window_hist_bucket{le="+Inf",series="lat",window_s="60"} 4' in page
    assert 'metrics_tpu_window_hist_bucket{le="0.025",series="lat",window_s="60"} 2' in page
    text = summary(recorder)
    assert "lat: n=4" in text and "hits: n=1" in text
