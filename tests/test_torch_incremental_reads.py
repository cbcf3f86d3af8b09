"""The port's incremental read plane on the CPU: bit parity with a cold read,
cache accounting held to the JAX package's, and the reader cache.

Each test of ``tests/bases/test_incremental_reads.py`` has a case here:
interleaved updates and reads served through the caches (the epoch-keyed
compute cache, the sliced dirty-slice folds through the ``sliced_subset``
and ``sliced_topk`` readers, the window fold memos and the ``window_fold``
reader, the retrieval layout memo) return the bits of a cold read of the
same state (a lockstep twin forced cold through ``_mark_state_written``);
and each read reports ``cache_hit`` and ``fanin`` as the JAX package's read
of the same seeded stream does. Beyond them: a bucket-padded subset read
equals the unpadded cold fold for every sliced template the tests and the
card's read-plane phase use; a memo never keeps a buffer that the next
replay overwrites (on the CPU, a reader whose output tensor is reused);
the layout memo's eviction totals and events; the four memory planes.
"""
import copy
import pickle
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import metrics_tpu as jm
import metrics_tpu.core.readers as jreaders
import metrics_tpu.retrieval.base as jretrieval_base
import metrics_tpu_torch as tm
import metrics_tpu_torch.core.readers as readers
import metrics_tpu_torch.retrieval.base as retrieval_base
from metrics_tpu.observability import get_recorder as jax_get_recorder
from metrics_tpu_torch.observability import cache_plane_inventory, get_recorder
from metrics_tpu_torch.sliced import SlicedMetric
from metrics_tpu_torch.windowed import WindowedMetric

torch.set_num_threads(2)

CPU = {"device": "cpu"}


@pytest.fixture
def recorders():
    recs = (get_recorder(), jax_get_recorder())
    for rec in recs:
        rec.reset()
        rec.enable(recompile_threshold=rec.DEFAULT_RECOMPILE_THRESHOLD, footprint_warn_bytes=None)
    try:
        yield recs
    finally:
        for rec in recs:
            rec.disable()
            rec.detach_timeseries()
            rec.reset()


def _bits_equal(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()


def _tree_bits_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _bits_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _tree_bits_equal(x, y)
    else:
        _bits_equal(a, b)


def _reads(rec, kind):
    return [(e.get("cache_hit"), e.get("fanin")) for e in rec.events() if e["type"] == "read" and e["kind"] == kind]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# core: the epoch-keyed compute cache
# ---------------------------------------------------------------------------


def test_epoch_cache_serves_hit_until_any_write(recorders):
    port, ref = tm.aggregation.SumMetric(**CPU), jm.aggregation.SumMetric()
    for m, x in ((port, _t), (ref, jnp.asarray)):
        m.update(x(np.asarray([1.0, 2.0], np.float32)))
        v1, v2 = m.compute(), m.compute()
        _bits_equal(v1, v2)
        m.update(x(np.asarray([3.0], np.float32)))
        m.compute()
        m._mark_state_written()
        m.compute()
    got, want = _reads(recorders[0], "compute"), _reads(recorders[1], "compute")
    assert [hit for hit, _ in got] == [False, True, False, False]
    assert [hit for hit, _ in got] == [hit for hit, _ in want]


# ---------------------------------------------------------------------------
# sliced: dirty-set folds through the readers against cold
# ---------------------------------------------------------------------------


def test_sliced_interleaved_reads_bit_identical_to_cold():
    S = 1000
    rng = np.random.default_rng(17)
    inc = SlicedMetric(tm.MeanSquaredError(**CPU), num_slices=S)
    cold = SlicedMetric(tm.MeanSquaredError(**CPU), num_slices=S)
    for step in range(30):
        n = int(rng.integers(4, 32))
        batch = (_t(rng.integers(0, S, n)), _t(rng.random(n, dtype=np.float32)), _t(rng.random(n, dtype=np.float32)))
        inc.update(*batch)
        cold.update(*batch)
        kind = step % 3
        cold._mark_state_written()  # the reference folds every slice cold
        if kind == 0:
            req = _t(rng.choice(S, size=int(rng.integers(1, 40)), replace=False))
            _tree_bits_equal(inc.compute(slice_ids=req), cold.compute(slice_ids=req))
        elif kind == 1:
            _tree_bits_equal(inc.compute(), cold.compute())
        else:
            k = int(rng.integers(1, 9))
            ids_i, vals_i = inc.compute(top_k=k)
            ids_c, vals_c = cold.compute(top_k=k)
            _bits_equal(ids_i, ids_c)
            _tree_bits_equal(vals_i, vals_c)
    assert {key[0] for key in inc._readers._cache} == {"sliced_subset", "sliced_topk"}


def test_sliced_repeat_subset_read_is_pure_cache_hit(recorders):
    S = 64
    rng = np.random.default_rng(5)
    ids, preds, target = rng.integers(0, S, 32), rng.random(32, dtype=np.float32), rng.random(32, dtype=np.float32)
    port = SlicedMetric(tm.MeanSquaredError(**CPU), num_slices=S)
    ref = jm.sliced.SlicedMetric(jm.MeanSquaredError(), num_slices=S)
    for m, x in ((port, _t), (ref, jnp.asarray)):
        m.update(x(ids), x(preds), x(target))
        req = x(np.asarray([3, 7, 11]))
        _tree_bits_equal(m.compute(slice_ids=req), m.compute(slice_ids=req))
        m.update(x(np.asarray([7])), x(np.asarray([0.5], np.float32)), x(np.asarray([0.25], np.float32)))
        m.compute(slice_ids=req)
    got, want = _reads(recorders[0], "sliced"), _reads(recorders[1], "sliced")
    assert got[0][0] is False and got[0][1] >= 1
    assert got[1][0] is True and (got[1][1] or 0) == 0
    assert got[2] == (False, 1)
    assert got == want


@pytest.mark.parametrize(
    "make",
    [
        lambda: tm.PeakSignalNoiseRatio(**CPU),
        lambda: tm.ScaleInvariantSignalDistortionRatio(**CPU),
        lambda: tm.MeanSquaredError(**CPU),
        lambda: tm.MeanAbsoluteError(**CPU),
        lambda: tm.aggregation.SumMetric(**CPU),
    ],
    ids=["psnr", "si-sdr", "mse", "mae", "sum"],
)
@pytest.mark.parametrize("n_ids", [5, 60, 500], ids=lambda n: f"ids{n}")
def test_bucket_padded_subset_read_equals_the_unpadded_cold_fold(make, n_ids):
    """The read pads its ids to a bucket (repeating the last) and folds the
    bucket's rows in one vmapped compute; the values of the real ids equal
    a fold of exactly those rows, slice for slice."""
    S = 2000
    rng = np.random.default_rng(n_ids)
    m = SlicedMetric(make(), num_slices=S)
    for _ in range(3):
        n = 256
        ids = _t(rng.zipf(1.3, n) % S)
        if isinstance(m.wrapped, tm.aggregation.SumMetric):
            m.update(ids, _t(rng.random(n, dtype=np.float32)))
        else:
            m.update(ids, _t(rng.random((n, 16), dtype=np.float32)), _t(rng.random((n, 16), dtype=np.float32)))
    req = rng.choice(S, size=n_ids, replace=False)
    assert readers.round_up_bucket(n_ids, S) > n_ids
    got = m.compute(slice_ids=_t(req))
    index = _t(req).long()
    unpadded = torch.func.vmap(m.wrapped.compute_state)({k: getattr(m, k)[index] for k in m.wrapped._defaults})
    _tree_bits_equal(got, unpadded)


# ---------------------------------------------------------------------------
# windowed: the fold memos against cold, across wraps and evictions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wrap", [lambda: tm.MeanSquaredError(**CPU), lambda: SlicedMetric(tm.MeanSquaredError(**CPU), 16)], ids=["mse", "sliced-mse"])
def test_windowed_interleaved_reads_bit_identical_to_cold(wrap):
    R, K = 6, 2
    rng = np.random.default_rng(23)
    inc = WindowedMetric(wrap(), window=R, updates_per_bucket=K)
    cold = WindowedMetric(wrap(), window=R, updates_per_bucket=K)
    sliced = isinstance(inc.wrapped, SlicedMetric)
    for step in range(3 * R * K):
        batch = (_t(rng.random(8, dtype=np.float32)), _t(rng.random(8, dtype=np.float32)))
        if sliced:
            batch = (_t(rng.integers(0, 16, 8)),) + batch
        inc.update(*batch)
        cold.update(*batch)
        cold._mark_state_written()
        _tree_bits_equal(inc.window_state(), cold.window_state())
        w = int(rng.integers(1, R + 1))
        filled = (step + 1 + K - 1) // K
        b = int(rng.integers(0, R - w + 1))
        if filled - b >= 1:
            cold._mark_state_written()
            _tree_bits_equal(inc.window_state(w, before=b), cold.window_state(w, before=b))
            cold._mark_state_written()
            _tree_bits_equal(inc.compute(window=w), cold.compute(window=w))
    assert len(inc._fold_memo) <= 8 and len(inc._wstate_memo) <= 8


def test_windowed_same_clock_read_is_pure_cache_hit(recorders):
    rng = np.random.default_rng(2)
    batches = [(rng.random(4, dtype=np.float32), rng.random(4, dtype=np.float32)) for _ in range(7)]
    port = WindowedMetric(tm.MeanSquaredError(**CPU), window=4, updates_per_bucket=2)
    ref = jm.windowed.WindowedMetric(jm.MeanSquaredError(), window=4, updates_per_bucket=2)
    for m, x in ((port, _t), (ref, jnp.asarray)):
        for p, t in batches[:6]:
            m.update(x(p), x(t))
        _tree_bits_equal(m.window_state(), m.window_state())
        m.update(x(batches[6][0]), x(batches[6][1]))
        m.window_state()
    got, want = _reads(recorders[0], "window"), _reads(recorders[1], "window")
    assert got[0][0] is False and got[0][1] >= 1
    assert got[1][0] is True and (got[1][1] or 0) == 0
    assert got[2] == (False, 2) and got[2][1] < got[0][1]
    assert got == want


def test_window_memo_survives_a_fused_update_and_is_cleared_by_writes():
    rng = np.random.default_rng(4)
    col = tm.MetricCollection([WindowedMetric(tm.MeanSquaredError(**CPU), window=4, updates_per_bucket=1)])
    twin = WindowedMetric(tm.MeanSquaredError(**CPU), window=4, updates_per_bucket=1)
    batches = [(_t(rng.random(8, dtype=np.float32)), _t(rng.random(8, dtype=np.float32))) for _ in range(6)]
    col.update(*batches[0])
    twin.update(*batches[0])
    col.compile_update()
    metric = col["WindowedMetric"]
    for b in batches[1:]:
        col.update(*b)
        twin.update(*b)
        metric.window_state()
        twin._mark_state_written()
        _tree_bits_equal(metric.window_state(), twin.window_state())
    assert metric._fold_memo  # fused replays kept the prefix memo
    metric.reset()
    assert not metric._fold_memo and not metric._wstate_memo
    metric.update(*batches[0])
    metric.window_state()
    metric.set_dtype(torch.float64)
    assert not metric._fold_memo and not metric._wstate_memo


# ---------------------------------------------------------------------------
# no memo keeps a buffer that the next replay overwrites
# ---------------------------------------------------------------------------


def _reusing_get(cache_get):
    """``ReaderCache.get`` whose readers write every result into one output
    buffer, as a CUDA graph's replays do."""

    wrapped = set()

    def get(self, kind, build, *example_args, bucket=None):
        entry = cache_get(self, kind, build, *example_args, bucket=bucket)
        if id(entry) in wrapped:
            return entry
        wrapped.add(id(entry))
        fn = entry.fn
        held = {}

        def reused(*args):
            out = fn(*args)
            flat, spec = torch.utils._pytree.tree_flatten(out)
            if "bufs" not in held:
                held["bufs"] = [x.clone() for x in flat]
            for buf, x in zip(held["bufs"], flat):
                buf.copy_(x)
            return torch.utils._pytree.tree_unflatten(held["bufs"], spec)

        entry.fn = reused
        return entry

    return get


def test_memos_keep_copies_of_reused_reader_outputs(monkeypatch):
    monkeypatch.setattr(readers.ReaderCache, "get", _reusing_get(readers.ReaderCache.get))
    rng = np.random.default_rng(9)
    # the window: each new window_fold read overwrites the previous output
    win = WindowedMetric(tm.MeanSquaredError(**CPU), window=6, updates_per_bucket=1)
    cold = WindowedMetric(tm.MeanSquaredError(**CPU), window=6, updates_per_bucket=1)
    for _ in range(5):
        b = (_t(rng.random(8, dtype=np.float32)), _t(rng.random(8, dtype=np.float32)))
        win.update(*b)
        cold.update(*b)
    first = win.window_state(3)  # a window_fold of two completed buckets
    kept = {k: v.clone() for k, v in first.items()}
    win.window_state(4)  # the same reader kind, another output
    win.window_state(3, before=1)
    _tree_bits_equal(first, kept)
    _tree_bits_equal(win.window_state(3), cold.window_state(3))
    # the sliced value cache
    S = 64
    m = SlicedMetric(tm.MeanSquaredError(**CPU), num_slices=S)
    m.update(_t(np.arange(S)), _t(rng.random(S, dtype=np.float32)), _t(rng.random(S, dtype=np.float32)))
    a = m.compute(slice_ids=_t(np.arange(5)))
    a_kept = a.clone()
    m.compute(slice_ids=_t(np.arange(5, 10)))  # same bucket: the reader's output is overwritten
    _bits_equal(a, a_kept)
    _bits_equal(m.compute(slice_ids=_t(np.arange(5))), a_kept)


# ---------------------------------------------------------------------------
# retrieval: the layout memo against cold, its accounting and evictions
# ---------------------------------------------------------------------------


def _retrieval_batch(rng, n, queries):
    return rng.random(n, dtype=np.float32), rng.integers(0, 2, n), rng.integers(0, queries, n)


def test_retrieval_interleaved_reads_bit_identical_to_cold():
    rng = np.random.default_rng(31)
    inc = tm.RetrievalMAP(max_queries=64, max_docs=16, **CPU)
    cold = tm.RetrievalMAP(max_queries=64, max_docs=16, **CPU)
    for _ in range(12):
        preds, target, idx = _retrieval_batch(rng, 24, 40)
        inc.update(_t(preds), _t(target), indexes=_t(idx))
        cold.update(_t(preds), _t(target), indexes=_t(idx))
        v_inc = inc.compute()
        retrieval_base._LAYOUT_CACHE.clear()
        cold._mark_state_written()
        _bits_equal(v_inc, cold.compute())


def test_retrieval_layout_cache_hit_accounting(recorders):
    rng = np.random.default_rng(7)
    preds, target, idx = _retrieval_batch(rng, 20, 16)
    port = tm.RetrievalMAP(max_queries=32, max_docs=8, **CPU)
    ref = jm.RetrievalMAP(max_queries=32, max_docs=8)
    for m, x in ((port, _t), (ref, jnp.asarray)):
        m.update(x(preds), x(target), indexes=x(idx))
        m.compute()
        m._computed = None  # drop the value cache, keep the layout memo
        m.compute()
        m.update(x(preds), x(target), indexes=x(idx))
        m.compute()
    got, want = _reads(recorders[0], "compute"), _reads(recorders[1], "compute")
    assert [hit for hit, _ in got] == [False, True, False]
    assert [hit for hit, _ in got] == [hit for hit, _ in want]


def test_retrieval_layout_cache_stays_bounded_and_counts_its_evictions(recorders):
    rng = np.random.default_rng(11)
    preds, target, idx = _retrieval_batch(rng, 16, 12)
    m = tm.RetrievalMAP(max_queries=32, max_docs=8, **CPU)
    before = retrieval_base.layout_cache_totals()
    for _ in range(3 * retrieval_base._LAYOUT_CACHE_MAX):
        m.update(_t(preds), _t(target), indexes=_t(idx))
        m.compute()
    assert len(retrieval_base._LAYOUT_CACHE) <= retrieval_base._LAYOUT_CACHE_MAX
    after = retrieval_base.layout_cache_totals()
    assert after["entries"] == len(retrieval_base._LAYOUT_CACHE) and after["nbytes"] > 0
    assert after["evictions"] > before["evictions"] and after["evicted_bytes"] > before["evicted_bytes"]
    events = [e for e in recorders[0].events() if e["type"] == "cache_plane" and e["plane"] == "retrieval_layout"]
    assert len(events) == after["evictions"] - before["evictions"]
    assert all(e["evictions"] == 1 and e["evicted_bytes"] > 0 for e in events)
    assert set(after) == set(jretrieval_base.layout_cache_totals())


def test_layout_eviction_from_a_finalizer_never_raises(monkeypatch, recorders):
    def broken(*args, **kwargs):
        raise RuntimeError("recorder down")

    monkeypatch.setattr(recorders[0], "record_cache_plane", broken)
    rng = np.random.default_rng(12)
    m = tm.RetrievalMAP(max_queries=32, max_docs=8, **CPU)
    preds, target, idx = _retrieval_batch(rng, 16, 12)
    m.update(_t(preds), _t(target), indexes=_t(idx))
    m.compute()
    n0 = retrieval_base.layout_cache_totals()["evictions"]
    del m  # the table dies: its finalizer evicts the entry
    import gc

    gc.collect()
    assert retrieval_base.layout_cache_totals()["evictions"] > n0


def test_table_subset_reads_equal_the_row_gather():
    rng = np.random.default_rng(13)
    m = tm.RetrievalNormalizedDCG(max_queries=128, max_docs=8, **CPU)
    preds, target, idx = _retrieval_batch(rng, 300, 100)
    m.update(_t(preds), _t(target), indexes=_t(idx))
    from metrics_tpu_torch.retrieval.table import retrieval_table_layout_rows

    for n in (3, 40, 100):
        rows = rng.choice(128, size=n, replace=False)
        got = m.table_rows_layout(rows)
        want = retrieval_table_layout_rows(m.qtable, _t(rows))
        assert len(got) == len(want) == 8
        for g, w in zip(got, want):
            _bits_equal(g, w)
    assert {key[1] for key in m._readers._cache} == {8, 64, 128}


# ---------------------------------------------------------------------------
# deferred telemetry housekeeping, and the reader cache itself
# ---------------------------------------------------------------------------


def test_recorder_tick_folds_pending_telemetry(recorders):
    rec = recorders[0]
    assert rec.tick() == 0
    registry = rec.attach_timeseries(bucket_seconds=60.0, n_buckets=4, sketch_capacity=64, device="cpu")
    for v in range(10):
        registry.observe("probe_ms", float(v))
    assert rec.tick() == 10
    assert rec.tick() == 0
    payload = registry.payload()["probe_ms"]
    assert sum(b["c"] for b in payload["buckets"]) == 10
    rec.detach_timeseries()
    assert rec.tick() == 0


def test_reader_cache_fast_probe_tracks_get_and_clear():
    cache = readers.ReaderCache()
    assert cache.fast("double", 8) is None
    x = torch.arange(8, dtype=torch.float32)
    fn = cache.get("double", lambda: lambda a: a * 2.0, x, bucket=8)
    assert cache.fast("double", 8) is fn
    assert cache.fast("double", 64) is None
    np.testing.assert_array_equal(fn(x).numpy(), np.arange(8, dtype=np.float32) * 2.0)
    assert fn.graph is None and cache.nbytes() == 0 and cache.declined == {}  # the CPU captures nothing
    cache.clear()
    assert cache.fast("double", 8) is None and len(cache) == 0


def test_reader_cache_copies_and_pickles_start_cold():
    cache = readers.ReaderCache()
    cache.get("double", lambda: lambda a: a * 2.0, torch.ones(8), bucket=8)
    for other in (copy.deepcopy(cache), pickle.loads(pickle.dumps(cache))):
        assert len(other) == 0 and other.fast("double", 8) is None
    m = SlicedMetric(tm.MeanSquaredError(**CPU), num_slices=16)
    m.update(_t(np.arange(16)), _t(np.ones(16, np.float32)), _t(np.zeros(16, np.float32)))
    m.compute(slice_ids=_t(np.arange(3)))
    assert len(m._readers) == 1 and len(m.clone()._readers) == 0


def test_reader_cache_warns_once_at_its_entry_limit(recorders):
    cache = readers.ReaderCache()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for b in range(readers.READER_CACHE_WARN_ENTRIES + 3):
            cache.get("k", lambda: lambda a: a, torch.ones(b + 1), bucket=b)
    assert len([w for w in caught if "ReaderCache" in str(w.message)]) == 1
    events = [e for e in recorders[0].events() if e["type"] == "cache_plane" and e["plane"] == "reader_cache"]
    assert len(events) == 1 and events[0]["entries"] == readers.READER_CACHE_WARN_ENTRIES
    assert events[0]["reason"] == "growth_warning"


@pytest.mark.parametrize("n", [1, 5, 8, 9, 64, 65, 500, 4096, 4097, 10000])
def test_buckets_and_padding_are_the_jax_packages(n):
    for cap in (None, 2000, n):
        assert readers.round_up_bucket(n, cap) == jreaders.round_up_bucket(n, cap)
    ids = np.arange(n) * 3
    bucket = readers.round_up_bucket(n)
    np.testing.assert_array_equal(readers.pad_ids(ids, bucket), jreaders.pad_ids(ids, bucket))
    with pytest.raises(ValueError):
        readers.pad_ids(np.zeros(0), 8)


def test_the_four_read_plane_memory_planes_report_bytes():
    rng = np.random.default_rng(3)
    s = SlicedMetric(tm.MeanSquaredError(**CPU), num_slices=32)
    s.update(_t(rng.integers(0, 32, 16)), _t(rng.random(16, dtype=np.float32)), _t(rng.random(16, dtype=np.float32)))
    s.compute()
    w = WindowedMetric(tm.MeanSquaredError(**CPU), window=4)
    for _ in range(3):
        w.update(_t(rng.random(4, dtype=np.float32)), _t(rng.random(4, dtype=np.float32)))
    w.window_state()
    r = tm.RetrievalMAP(max_queries=16, max_docs=4, **CPU)
    preds, target, idx = _retrieval_batch(rng, 16, 8)
    r.update(_t(preds), _t(target), indexes=_t(idx))
    r.compute()
    planes = cache_plane_inventory()
    assert {"reader_cache", "sliced_value_cache", "windowed_fold_memo", "retrieval_layout"} <= set(planes)
    for name in ("sliced_value_cache", "windowed_fold_memo", "retrieval_layout"):
        assert planes[name] > 0, name
    assert planes["reader_cache"] == 0  # the CPU holds no graphs


def test_psnr_logs_are_float64_rounded_once():
    """The read plane holds the card's reads to the CPU's bit for bit; PSNR
    takes its logs in float64 and rounds once, as float32 logs differ
    between the card and the CPU in the last bit."""
    from metrics_tpu_torch.functional.image.psnr import _psnr_compute

    rng = np.random.default_rng(21)
    sse = (rng.random(20000) * 1e3 + 1e-3).astype(np.float32)
    n = rng.integers(1, 1 << 20, 20000).astype(np.int32)
    dr = (rng.random(20000) * 4 + 0.05).astype(np.float32)
    got = _psnr_compute(_t(sse), _t(n), _t(dr), reduction="none").numpy()
    want = ((2 * np.log(dr.astype(np.float64)) - np.log(sse.astype(np.float64) / n)) * (10 / np.log(10.0))).astype(np.float32)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # the JAX package takes them in float32: within 1e-6 relative
    from metrics_tpu.functional.image.psnr import _psnr_compute as jax_psnr_compute

    ref = np.asarray(jax_psnr_compute(jnp.asarray(sse), jnp.asarray(n), jnp.asarray(dr), reduction="none"))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
