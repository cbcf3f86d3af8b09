"""The port's drift scores, health rules and monitor, memory observatory
and capture profiling (``metrics_tpu_torch.observability``) on the CPU.

The contracts of the JAX package's ``tests/bases/test_{health,drift,
memory,profiling}.py``, and the port held to the JAX package: the same
histograms, sketches and observation timelines (every one at an injected
time) go into both packages, and the drift scores must agree within 1e-6
with the sketch histograms' counts bit-equal, and the health monitors must
fire and clear the same alarms in the same order with the same values.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metrics_tpu.observability import drift as jax_drift
from metrics_tpu.observability.health import DriftRule as JaxDriftRule
from metrics_tpu.observability.health import HealthMonitor as JaxHealthMonitor
from metrics_tpu.observability.health import default_rules as jax_default_rules
from metrics_tpu.observability.memory import MemoryLedger as JaxMemoryLedger
from metrics_tpu.observability.timeseries import TimeSeriesRegistry as JaxRegistry
from metrics_tpu.sketches.quantile import qsketch_histogram as jax_qsketch_histogram
from metrics_tpu.sketches.quantile import qsketch_init as jax_qsketch_init
from metrics_tpu.sketches.quantile import qsketch_insert as jax_qsketch_insert
import metrics_tpu as jm
import metrics_tpu_torch as tm
from metrics_tpu_torch.observability import (
    BurnRateRule,
    DriftRule,
    HealthMonitor,
    MemoryBudget,
    MemoryLeak,
    MemoryLedger,
    MemoryObservatory,
    ThresholdRule,
    backend_memory_stats,
    cache_plane_inventory,
    cache_plane_total,
    categorical_drift,
    compiled_cost,
    default_rules,
    get_recorder,
    histogram_drift,
    host_rss_bytes,
    js_divergence_hist,
    kl_divergence_hist,
    live_metrics,
    metric_compile_cost,
    psi_divergence,
    reference_edges,
    register_cache_plane,
    render_health,
    sketch_drift,
    state_drift,
    total_variation,
    unregister_cache_plane,
)
from metrics_tpu_torch.observability import drift as drift_mod
from metrics_tpu_torch.observability.recorder import (
    SERIES_ASYNC_DROPPED,
    SERIES_ASYNC_ENQUEUED,
    SERIES_ASYNC_QUEUE_DEPTH,
    SERIES_ASYNC_STALENESS,
    SERIES_FRESHNESS_AGE_S,
    SERIES_HOT_SLICE_SHARE,
    SERIES_MEM_BYTES_PER_TENANT,
    SERIES_MEM_UNACCOUNTED,
    SERIES_READ_MS,
    SERIES_RECOMPILES,
    SERIES_SCORES,
    SERIES_SKETCH_FILL,
)
from metrics_tpu_torch.observability.timeseries import TimeSeriesRegistry
from metrics_tpu_torch.sketches.quantile import qsketch_histogram, qsketch_init, qsketch_insert

torch.set_num_threads(2)

T0 = 50_000.0


@pytest.fixture
def recorder():
    rec = get_recorder()
    rec.reset()
    rec.enable()
    try:
        yield rec
    finally:
        rec.disable()
        rec.detach_timeseries()
        rec.reset()


def _registries(cap=64):
    return (
        TimeSeriesRegistry(bucket_seconds=1.0, n_buckets=60, sketch_capacity=cap, device="cpu"),
        JaxRegistry(bucket_seconds=1.0, n_buckets=60, sketch_capacity=cap),
    )


def _observe(regs, name, value, t, kind="distribution"):
    for reg in regs:
        reg.observe(name, value, kind=kind, t=t)


# ---------------------------------------------------------------------------
# drift scores
# ---------------------------------------------------------------------------


_HISTS = [
    (np.array([5, 5, 5, 5.0]), np.array([5, 5, 5, 5.0])),
    (np.array([10, 0, 3, 7.0]), np.array([1, 9, 9, 1.0])),
    (np.zeros(6), np.array([0, 0, 4, 0, 0, 0.0])),
    (np.arange(16.0), np.arange(16.0)[::-1].copy()),
]


@pytest.mark.parametrize("case", range(len(_HISTS)))
def test_drift_scores_match_jax(case):
    p, q = _HISTS[case]
    got = histogram_drift(p, q)
    want = jax_drift.histogram_drift(jnp.asarray(p), jnp.asarray(q))
    assert set(got) == set(want) == {"psi", "kl", "js", "tv"}
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-6, k
    for mine, ref in ((psi_divergence, jax_drift.psi_divergence), (kl_divergence_hist, jax_drift.kl_divergence_hist),
                      (js_divergence_hist, jax_drift.js_divergence_hist), (total_variation, jax_drift.total_variation)):
        assert abs(mine(p, q) - ref(jnp.asarray(p), jnp.asarray(q))) <= 1e-6
    assert all(np.isfinite(v) for v in got.values())
    assert got["tv"] <= 1.0 and got["js"] <= np.log(2) + 1e-6


def test_drift_epsilon_floor_is_the_jax_packages():
    assert drift_mod.DRIFT_EPS == jax_drift.DRIFT_EPS
    p = drift_mod.normalize_histogram(np.array([1.0, 0.0]))
    assert p.dtype == torch.float32 and float(p.min()) > 0


def _sketch_pair(values, cap=256):
    mine = qsketch_insert(qsketch_init(cap, device="cpu"), torch.from_numpy(values))
    ref = jax_qsketch_insert(jax_qsketch_init(cap), jnp.asarray(values))
    return mine, ref


def test_sketch_histograms_bit_equal_and_sketch_drift_matches_jax():
    rng = np.random.default_rng(0)
    ref_vals = np.clip(rng.normal(0.3, 0.1, 200), 0, 1).astype(np.float32)
    live_vals = np.clip(rng.normal(0.7, 0.1, 200), 0, 1).astype(np.float32)
    (r_t, r_j), (l_t, l_j) = _sketch_pair(ref_vals), _sketch_pair(live_vals)
    edges = reference_edges(r_t, n_bins=12)
    np.testing.assert_array_equal(edges, jax_drift.reference_edges(np.asarray(r_j), n_bins=12))
    for mine, ref in ((r_t, r_j), (l_t, l_j)):
        np.testing.assert_array_equal(
            qsketch_histogram(mine, torch.from_numpy(edges.astype(np.float32))).numpy(),
            np.asarray(jax_qsketch_histogram(ref, jnp.asarray(edges, jnp.float32))),
        )
    got, want = sketch_drift(r_t, l_t, edges), jax_drift.sketch_drift(r_j, l_j, edges)
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-6
    assert got["psi"] > 1.0
    same = sketch_drift(r_t, r_t, edges)
    assert same["psi"] == 0.0
    with pytest.raises(ValueError):
        reference_edges(qsketch_init(8, device="cpu"))
    with pytest.raises(ValueError):
        reference_edges(r_t, n_bins=1)


def test_categorical_and_state_drift_match_jax():
    a = np.array([[5, 1], [2, 8]], np.float32)
    b = np.array([[1, 5], [6, 2]], np.float32)
    got, want = categorical_drift(a, b), jax_drift.categorical_drift(jnp.asarray(a), jnp.asarray(b))
    assert all(abs(got[k] - want[k]) <= 1e-6 for k in got)
    with pytest.raises(ValueError):
        categorical_drift(a, a.T.reshape(1, 4))
    rng = np.random.default_rng(3)
    jw = jm.WindowedMetric(jm.ConfusionMatrix(num_classes=3), window=4)
    w = tm.WindowedMetric(tm.ConfusionMatrix(num_classes=3, device="cpu"), window=4)
    for i in range(4):
        p = rng.integers(0, 3, 40) if i < 2 else np.zeros(40, np.int64)
        t = rng.integers(0, 3, 40)
        jw.update(jnp.asarray(p), jnp.asarray(t))
        w.update(torch.from_numpy(p), torch.from_numpy(t))
    got = state_drift(w, w.window_state(2, before=2), w.window_state(2))
    want = jax_drift.state_drift(jw, jw.window_state(2, before=2), jw.window_state(2))
    assert set(got) == set(want) == {"confmat"}
    assert all(abs(got["confmat"][k] - want["confmat"][k]) <= 1e-6 for k in got["confmat"])


# ---------------------------------------------------------------------------
# rules and the monitor against the JAX package
# ---------------------------------------------------------------------------


def _faults(regs, t):
    for i in range(6):
        ti = t + i * 0.1
        _observe(regs, SERIES_ASYNC_QUEUE_DEPTH, 9.0, ti)
        _observe(regs, SERIES_ASYNC_STALENESS, 8.0, ti)
        _observe(regs, SERIES_ASYNC_ENQUEUED, 1.0, ti, kind="counter")
        _observe(regs, SERIES_ASYNC_DROPPED, 5.0, ti, kind="counter")
        _observe(regs, SERIES_RECOMPILES, 3.0, ti, kind="counter")
        _observe(regs, SERIES_SKETCH_FILL, 0.97, ti)
        _observe(regs, SERIES_HOT_SLICE_SHARE, 0.9, ti)
        _observe(regs, SERIES_FRESHNESS_AGE_S, 40.0, ti)
        _observe(regs, SERIES_READ_MS, 900.0, ti)
        _observe(regs, SERIES_MEM_BYTES_PER_TENANT, 64.0 * 1024, ti)


def _healthy(regs, t):
    for i in range(6):
        ti = t + i * 0.1
        _observe(regs, SERIES_ASYNC_QUEUE_DEPTH, 1.0, ti)
        _observe(regs, SERIES_ASYNC_STALENESS, 0.0, ti)
        _observe(regs, SERIES_ASYNC_ENQUEUED, 10.0, ti, kind="counter")
        _observe(regs, SERIES_SKETCH_FILL, 0.1, ti)
        _observe(regs, SERIES_HOT_SLICE_SHARE, 0.05, ti)
        _observe(regs, SERIES_FRESHNESS_AGE_S, 0.5, ti)
        _observe(regs, SERIES_READ_MS, 3.0, ti)
        _observe(regs, SERIES_MEM_BYTES_PER_TENANT, 1024.0, ti)


def _scores(regs, rng, t, seconds, mean, n_per_s=60):
    for k in range(int(seconds * n_per_s)):
        v = float(np.clip(rng.normal(mean, 0.08), 0, 1))
        _observe(regs, SERIES_SCORES, v, t + k / n_per_s)
    return t + seconds


def _leak(regs, t, start, step):
    for i in range(8):
        _observe(regs, SERIES_MEM_UNACCOUNTED, float(start + i * step), t + i * 0.5)


def test_default_rules_fire_and_clear_in_the_jax_packages_order(tmp_path):
    regs = _registries()
    mine = HealthMonitor(default_rules(window_s=5.0, drift_freeze_after=120, unaccounted_growth_bytes=1e6),
                         registry=regs[0], alarm_log_path=str(tmp_path / "alarms.jsonl"))
    ref = JaxHealthMonitor(jax_default_rules(window_s=5.0, drift_freeze_after=120, unaccounted_growth_bytes=1e6),
                           registry=regs[1])
    rng = np.random.RandomState(5)
    snaps = []
    t = _scores(regs, rng, T0, 2.0, 0.3)
    for now in (t, t):  # the first evaluation freezes the drift reference
        snaps.append((mine.evaluate(now=now), ref.evaluate(now=now)))
    t2 = _scores(regs, rng, t + 1, 3.0, 0.8)
    _faults(regs, t2 - 0.8)  # inside the burn rule's short window too
    _leak(regs, t2 - 4.0, 1e6, 5e6)
    snaps.append((mine.evaluate(now=t2), ref.evaluate(now=t2)))
    _healthy(regs, t2 + 10)
    _leak(regs, t2 + 10, 5e7, 0.0)
    t3 = _scores(regs, rng, t2 + 10, 4.0, 0.3)
    snaps.append((mine.evaluate(now=t3), ref.evaluate(now=t3)))
    for a, b in snaps:
        assert a.status == b.status
        assert [(x.name, x.firing) for x in a.alarms] == [(x.name, x.firing) for x in b.alarms]
        for x, y in zip(a.alarms, b.alarms):
            assert (x.value is None) == (y.value is None), x.name
            if x.value is not None:
                assert abs(x.value - y.value) <= 1e-6 * max(1.0, abs(y.value)), (x.name, x.value, y.value)
    strip = lambda rows: [(r["event"], r["alarm"], r["severity"]) for r in rows]  # noqa: E731
    assert strip(mine.transitions()) == strip(ref.transitions())
    classes = {"queue_saturation", "queue_saturation_critical", "staleness", "drop_rate", "recompile_storm",
               "sketch_fill", "hot_slice_skew", "score_drift", "freshness_slo", "read_latency", "memory_budget",
               "memory_leak"}
    assert classes <= set(mine.fired_and_cleared())
    rows = [json.loads(x) for x in (tmp_path / "alarms.jsonl").read_text().splitlines()]
    assert {r["alarm"] for r in rows if r["event"] == "cleared"} >= classes
    assert snaps[2][0].status == "critical" and snaps[3][0].status == "ok"


def test_drift_rule_scores_match_jax_and_land_on_the_recorder(recorder):
    regs = _registries(cap=128)
    mine = DriftRule("d", SERIES_SCORES, stat="js", threshold=0.05, window_s=3.0, freeze_after=100, min_count=16)
    ref = JaxDriftRule("d", SERIES_SCORES, stat="js", threshold=0.05, window_s=3.0, freeze_after=100, min_count=16)
    rng = np.random.RandomState(2)
    t = _scores(regs, rng, T0, 2.0, 0.3, n_per_s=50)
    assert mine.evaluate(regs[0], now=t)[2].startswith("reference frozen") and ref.evaluate(regs[1], now=t)[0] is False
    np.testing.assert_array_equal(mine._edges, ref._edges)
    np.testing.assert_array_equal(mine._ref_hist.numpy(), np.asarray(ref._ref_hist))
    for mean in (0.3, 0.75, 0.3):
        t = _scores(regs, rng, t + 5, 2.0, mean, n_per_s=50)
        a, b = mine.evaluate(regs[0], now=t), ref.evaluate(regs[1], now=t)
        assert a[0] == b[0] and abs(a[1] - b[1]) <= 1e-6
    assert f"{SERIES_SCORES}|js" in recorder.drift_scores()
    mine.reset_reference()
    assert "collecting reference" in mine.evaluate(regs[0], now=t + 100)[2]


def test_drift_rule_explicit_freeze_and_validation():
    reg = TimeSeriesRegistry(device="cpu")
    rule = DriftRule("d", "s", freeze_after=10**6)
    assert not rule.freeze_reference(reg, now=T0)  # absent series
    for i in range(40):
        reg.observe("s", float(i), t=T0)
    assert rule.freeze_reference(reg, now=T0) and rule._ref_hist is not None
    for bad in ({"stat": "x"}, {"window_s": 0}, {"freeze_after": 0}, {"n_bins": 1}):
        with pytest.raises(ValueError):
            DriftRule("d", **bad)


def test_threshold_burn_rate_and_memory_rules():
    reg = TimeSeriesRegistry(device="cpu")
    for i in range(5):
        reg.observe("lat", 10.0 * i, t=T0 + i)
    assert ThresholdRule("r", "lat", "max", 30.0, window_s=10).evaluate(reg, now=T0 + 5)[0]
    assert not ThresholdRule("r", "lat", "max", 30.0, window_s=1.5).evaluate(reg, now=T0 + 20)[0]
    assert ThresholdRule("r", "missing", "p95", 1.0).evaluate(reg, now=T0)[2] == "series `missing` absent"
    for stat in ("p50", "p90", "p99", "mean", "min", "rate", "count", "total"):
        assert ThresholdRule("r", "lat", stat, -1.0, window_s=10).evaluate(reg, now=T0 + 5)[0]
    with pytest.raises(ValueError):
        ThresholdRule("r", "lat", "median", 1.0)
    for i in range(10):
        reg.observe("bad", 1.0, kind="counter", t=T0 + i)
        reg.observe("ok", 1.0, kind="counter", t=T0 + i)
    burn = BurnRateRule("b", "bad", ("ok", "bad"), budget=0.1, short_window_s=2, long_window_s=8)
    firing, value, _ = burn.evaluate(reg, now=T0 + 9)
    assert firing and value == pytest.approx(5.0)
    with pytest.raises(ValueError):
        BurnRateRule("b", "a", "b", budget=1.5)
    budget = MemoryBudget(2048.0, window_s=5.0)
    reg.observe(SERIES_MEM_BYTES_PER_TENANT, 4096.0, t=T0)
    assert budget.evaluate(reg, now=T0 + 1)[0] and not budget.evaluate(reg, now=T0 + 30)[0]
    leak = MemoryLeak(growth_bytes=100.0, window_s=4.0, min_count=4)
    for i in range(8):  # flat-but-noisy: never fires
        reg.observe(SERIES_MEM_UNACCOUNTED, 1000.0 + (i % 2) * 50, t=T0 + 100 + i * 0.5)
    assert not leak.evaluate(reg, now=T0 + 104)[0]
    for i in range(8):
        reg.observe(SERIES_MEM_UNACCOUNTED, 1000.0 + i * 400, t=T0 + 200 + i * 0.5)
    assert leak.evaluate(reg, now=T0 + 204)[0]


def test_monitor_snapshot_exports_and_broken_rules(recorder):
    class Broken(ThresholdRule):
        def evaluate(self, registry, now=None):
            raise RuntimeError("boom")

    reg = TimeSeriesRegistry(device="cpu")
    reg.observe("s", 10.0, t=T0)
    mon = HealthMonitor([ThresholdRule("w", "s", "max", 5.0, window_s=5.0),
                         ThresholdRule("c", "s", "max", 5.0, window_s=5.0, severity="critical"),
                         Broken("b", "s", "max", 1.0)], registry=reg)
    snap = mon.evaluate(now=T0 + 1)
    assert snap.status == "critical" and {a.name for a in snap.firing} == {"w", "c"}
    assert "rule evaluation failed" in [a for a in snap.alarms if a.name == "b"][0].detail
    text = render_health(snap)
    assert text.startswith("health: CRITICAL (2/3 alarms firing")
    lines = mon.prometheus_lines()
    assert "metrics_tpu_health_status 2" in lines and 'metrics_tpu_alarm_firing{alarm="w",severity="warn"} 1' in lines
    assert json.loads(json.dumps(snap.to_json()))["status"] == "critical"
    with pytest.raises(ValueError, match="duplicate"):
        HealthMonitor([ThresholdRule("x", "s", "max", 1.0), ThresholdRule("x", "s", "max", 2.0)])


# ---------------------------------------------------------------------------
# the memory observatory
# ---------------------------------------------------------------------------


def test_ledger_counts_shared_group_state_once_like_jax():
    (p, t) = (np.random.default_rng(4).integers(0, 3, 20), np.random.default_rng(5).integers(0, 3, 20))
    jcol = jm.MetricCollection([jm.Precision(num_classes=3, average="macro"), jm.Recall(num_classes=3, average="macro")])
    col = tm.MetricCollection([tm.Precision(num_classes=3, average="macro", device="cpu"),
                               tm.Recall(num_classes=3, average="macro", device="cpu")])
    for c in (jcol, col):
        c.update(p, t)
        c.update(p, t)
        c.compute()
    got = MemoryLedger(list(col.values())).measure()
    want = JaxMemoryLedger(list(jcol.values())).measure()
    for key in ("total_bytes", "n_metrics", "n_buffers", "n_shared", "per_metric", "bytes_per_tenant"):
        assert got[key] == want[key], key
    assert sum(got["per_device"].values()) == got["total_bytes"] and set(got["per_device"]) == {"cpu"}


def test_ledger_sliced_bytes_per_tenant_and_live_metrics():
    sl = tm.SlicedMetric(tm.MeanSquaredError(device="cpu"), 8)
    report = MemoryLedger([sl]).measure()
    assert report["num_tenants"] == 8 and report["bytes_per_tenant"] == report["sliced_bytes"] / 8
    assert any(m is sl for m in live_metrics())
    boot = tm.BootStrapper(tm.MeanSquaredError(device="cpu"), num_bootstraps=3)
    assert MemoryLedger([boot]).measure()["n_buffers"] >= 3  # the copies are walked


def test_cache_planes_and_the_fused_plane():
    register_cache_plane("test_plane", lambda: 123)
    register_cache_plane("test_broken", lambda: 1 // 0)
    try:
        inv = cache_plane_inventory()
        assert inv["test_plane"] == 123 and inv["test_broken"] == 0 and "fused_compile" in inv
        assert cache_plane_total() >= 123
    finally:
        assert unregister_cache_plane("test_plane") and unregister_cache_plane("test_broken")
    assert not unregister_cache_plane("test_plane")
    col = tm.MetricCollection([tm.MeanSquaredError(device="cpu")])
    col.compile_update()
    col.update(torch.rand(4), torch.rand(4))
    assert cache_plane_inventory()["fused_compile"] == 0  # no graph pool on the CPU


def test_observatory_off_the_card_falls_back_to_host_rss(recorder):
    if not torch.cuda.is_available():
        assert backend_memory_stats() == {}
    assert host_rss_bytes() > 0
    m = tm.SlicedMetric(tm.MeanSquaredError(device="cpu"), 4)
    recorder.attach_timeseries(device="cpu", clock=lambda: T0)
    report = MemoryObservatory(ledger=MemoryLedger([m])).observe(phase="test")
    assert report["source"] == "host_rss" and report["device_bytes_in_use"] > 0
    assert report["unaccounted_bytes"] == report["device_bytes_in_use"] - report["total_bytes"] - report["cache_plane_bytes"]
    ev = [e for e in recorder.events() if e["type"] == "memory" and e["kind"] == "observe"][0]
    assert ev["source"] == "host_rss" and ev["phase"] == "test" and ev["bytes_per_tenant"] == report["bytes_per_tenant"]
    assert recorder.timeseries.get(SERIES_MEM_UNACCOUNTED).count() == 1
    strict = MemoryObservatory(ledger=MemoryLedger([m]), use_host_rss=False).observe()
    assert (strict["source"] is None) == (not torch.cuda.is_available())


def test_memory_boundaries_count_every_update_and_pace_the_rows(recorder):
    m = tm.SumMetric(device="cpu")
    for _ in range(5):
        m.update(torch.tensor(1.0))
    m.compute()
    m.reset()
    totals = recorder.memory_totals()
    assert (totals["update_boundaries"], totals["compute_boundaries"], totals["reset_boundaries"]) == (5, 1, 1)
    rows = [e for e in recorder.events() if e["type"] == "memory"]
    assert [e["kind"] for e in rows][:1] == ["update"] and len(rows) <= 3


# ---------------------------------------------------------------------------
# capture profiling
# ---------------------------------------------------------------------------


def test_compiled_cost_off_the_card_reports_the_warm_up_and_flops(recorder):
    a, b = torch.rand(16, 8), torch.rand(8, 4)
    report = compiled_cost(torch.matmul, a, b, entry="mm")
    assert report["captured"] is False and report["reason"] and report["entry"] == "mm"
    assert report["flops"] == 2 * 16 * 8 * 4
    assert report["trace_s"] >= 0 and report["compile_s"] == 0.0
    ev = [e for e in recorder.events() if e["type"] == "compile"][0]
    assert ev["entry"] == "mm" and ev["cost_analysis"]["flops"] == report["flops"]
    none = compiled_cost(torch.flip, a, (0,))
    assert none["flops"] is None and "no FLOPs" in none["flops_reason"]
    assert recorder.compile_counts() == {"mm": 1, "flip": 1}


def test_metric_compile_cost_declines_where_jax_does():
    assert metric_compile_cost(tm.CatMetric(device="cpu"), (torch.ones(3),)) is None  # list state
    with pytest.warns(UserWarning):
        exact = tm.AUROC(exact=True, device="cpu")
    assert metric_compile_cost(exact, (torch.rand(4), torch.tensor([0, 1, 0, 1]))) is None
    m = tm.MeanSquaredError(device="cpu")
    report = metric_compile_cost(m, (torch.rand(4), torch.rand(4)))
    assert report["entry"] == "MeanSquaredError.update" and report["captured"] is False
    assert float(m.total) == 0  # the metric's own states were not touched


def test_profile_compiles_bills_every_new_signature(recorder):
    recorder.enable(profile_compiles=True)
    m = tm.MeanSquaredError(device="cpu")
    for n in (4, 4, 6):
        m.update(torch.rand(n), torch.rand(n))
    bills = [e for e in recorder.events() if e["type"] == "compile"]
    assert [e["entry"] for e in bills] == ["MeanSquaredError.update"] * 2
    assert recorder.compile_counts() == {"MeanSquaredError.update": 2}
