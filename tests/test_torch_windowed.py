"""The port's WindowedMetric (ring and decay, over MeanSquaredError and
SlicedMetric(PeakSignalNoiseRatio)) against the JAX package's, on seeded
numpy inputs.

States are held bit for bit across a ring wrap on dyadic data (every sum
exact); window reads are held against the JAX package's and against a
fresh SlicedMetric fed the window's updates. The JAX package's
``WindowedMetric(SlicedMetric(...))`` serves a stale value on every read
after the first (its ``compute_state`` does not mark the template's slices
dirty, so the sliced template returns the per-slice values of its previous
fold); ``test_reference_windowed_sliced_read_is_stale`` pins that, so that
the port is held to fresh SlicedMetrics there, never to the reference.

The ring of sketch leaves (a windowed sketched ``AUROC``) is held bit for
bit to the JAX package's ring and to a fresh metric fed the window's
batches inside the sketch's lossless window, and within 1e-6 of the JAX
package's value past it (the compaction's ``asin`` differs by an ulp,
ROADMAP.md C).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metrics_tpu import AUROC as JaxAUROC
from metrics_tpu import MeanSquaredError as JaxMSE
from metrics_tpu import MetricCollection as JaxCollection
from metrics_tpu import PeakSignalNoiseRatio as JaxPSNR
from metrics_tpu.sliced import SlicedMetric as JaxSliced
from metrics_tpu.windowed import WindowedMetric as JaxWindowed
from metrics_tpu_torch import AUROC, MeanSquaredError, MetricCollection, PeakSignalNoiseRatio, SlicedMetric, WindowedMetric
from metrics_tpu_torch.windowed.reducers import ring_merge_fx
from metrics_tpu_torch.convert import state_from_jax
from metrics_tpu_torch.utils.exceptions import MetricsUserError

torch.set_num_threads(2)

IMAGE = (3, 4, 4)


def _psnr_batch(rng, b, s, scale=1.0, dyadic=True):
    ids = rng.integers(-1, s + 1, b).astype(np.int32)
    if dyadic:
        target = (rng.integers(0, 16, (b,) + IMAGE) / 16).astype(np.float32)
        preds = (rng.integers(0, 16, (b,) + IMAGE) / 16).astype(np.float32)
    else:
        target = rng.random((b,) + IMAGE, dtype=np.float32)
        preds = (target + scale * rng.standard_normal((b,) + IMAGE)).astype(np.float32)
    return ids, preds, target


def _mse_batch(rng, b):
    return (rng.integers(0, 8, b) / 4).astype(np.float32), (rng.integers(0, 8, b) / 4).astype(np.float32)


def _feed(jax_metric, metric, batch):
    jax_metric.update(*(jnp.asarray(x) for x in batch))
    metric.update(*(torch.from_numpy(x) for x in batch))


def _assert_states_equal(jax_metric, metric):
    want = {k: np.asarray(v) for k, v in jax_metric.state_dict().items()}
    got = {k: v.numpy() for k, v in metric.state_dict().items()}
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype and got[name].shape == want[name].shape, name
        np.testing.assert_array_equal(got[name].view(np.int32), want[name].view(np.int32), err_msg=name)


CONFIGS = {
    "mse-ring": (lambda: JaxWindowed(JaxMSE(), window=3, updates_per_bucket=2),
                 lambda: WindowedMetric(MeanSquaredError(device="cpu"), window=3, updates_per_bucket=2)),
    "mse-decay": (lambda: JaxWindowed(JaxMSE(), mode="decay", decay=0.9),
                  lambda: WindowedMetric(MeanSquaredError(device="cpu"), mode="decay", decay=0.9)),
    "sliced-psnr-ring": (lambda: JaxWindowed(JaxSliced(JaxPSNR(), 6), window=4, updates_per_bucket=2),
                         lambda: WindowedMetric(SlicedMetric(PeakSignalNoiseRatio(device="cpu"), 6), window=4, updates_per_bucket=2)),
    "sliced-mse-decay": (lambda: JaxWindowed(JaxSliced(JaxMSE(), 6), mode="decay", decay=0.75),
                         lambda: WindowedMetric(SlicedMetric(MeanSquaredError(device="cpu"), 6), mode="decay", decay=0.75)),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_states_bit_identical_to_jax_across_a_ring_wrap(config):
    make_jax, make = CONFIGS[config]
    jax_metric, metric = make_jax(), make()
    rng = np.random.default_rng(len(config))
    sliced = config.startswith("sliced")
    for i in range(11):  # past two laps of the smaller ring
        batch = _psnr_batch(rng, 12, 6) if sliced else _mse_batch(rng, 9)
        if config == "sliced-mse-decay":
            batch = (batch[0], batch[1][:, 0, 0, :], batch[2][:, 0, 0, :])
        _feed(jax_metric, metric, batch)
        _assert_states_equal(jax_metric, metric)
    np.testing.assert_allclose(metric.compute().numpy(), np.asarray(jax_metric.compute()), rtol=1e-6, atol=1e-6)
    if metric.mode == "ring":
        np.testing.assert_array_equal(metric.bucket_counts.numpy(), np.asarray(jax_metric.bucket_counts))
    else:
        np.testing.assert_array_equal(metric.decay_weight.numpy(), np.asarray(jax_metric.decay_weight))


def test_ring_window_reads_and_eviction_errors_match_jax():
    jax_metric = JaxWindowed(JaxMSE(), window=4, updates_per_bucket=2)
    metric = WindowedMetric(MeanSquaredError(device="cpu"), window=4, updates_per_bucket=2)
    rng = np.random.default_rng(3)
    batches = [_mse_batch(rng, 16) for _ in range(11)]
    for batch in batches:
        _feed(jax_metric, metric, batch)
    # 11 updates, 2 per bucket: buckets 0-5, the ring of 4 holds 2-5
    for kw in ({}, {"window": 1}, {"window": 2}, {"window": 3, "before": 1}, {"window": 2, "before": 2}, {"window": 1, "before": 9}):
        np.testing.assert_array_equal(metric.compute(**kw).numpy(), np.asarray(jax_metric.compute(**kw)), err_msg=str(kw))
    # the whole ring is exactly updates 4-10
    fresh = MeanSquaredError(device="cpu")
    for batch in batches[4:]:
        fresh.update(*(torch.from_numpy(x) for x in batch))
    assert torch.equal(metric.compute(), fresh.compute())
    for kw, match in (
        ({"window": 5}, "exceeds the ring span"),
        ({"window": 4, "before": 1}, "already evicted"),
        ({"window": 0}, "positive int"),
        ({"window": 2, "before": -1}, "non-negative int"),
    ):
        with pytest.raises(Exception, match=match):  # the JAX package's own MetricsUserError
            jax_metric.compute(**kw)
        with pytest.raises(MetricsUserError, match=match):
            metric.compute(**kw)


def test_windowed_sliced_reads_in_either_order_match_fresh_sliced_metrics():
    s = 20
    rng = np.random.default_rng(21)
    batches = [_psnr_batch(rng, 40, s, scale=0.02 * (i + 1), dyadic=False) for i in range(10)]
    windows = {"ring": ({}, range(0, 10)), "last2": ({"window": 2}, range(4, 10)), "shifted": ({"window": 1, "before": 1}, range(4, 8))}
    fresh = {}
    for name, (_, updates) in windows.items():
        m = SlicedMetric(PeakSignalNoiseRatio(device="cpu"), s)
        for i in updates:
            m.update(*(torch.from_numpy(x) for x in batches[i]))
        fresh[name] = m
    for order in (list(windows), list(windows)[::-1]):
        metric = WindowedMetric(SlicedMetric(PeakSignalNoiseRatio(device="cpu"), s), window=8, updates_per_bucket=4)
        for batch in batches:
            metric.update(*(torch.from_numpy(x) for x in batch))
        for _ in range(2):  # and each read again
            for name in order:
                kw, _ = windows[name]
                got = metric.compute(**kw)
                want = fresh[name].compute()
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6, err_msg=name)
                state = metric.window_state(kw.get("window"), before=kw.get("before", 0))
                for leaf in ("min_target", "max_target", "total", "_slice_rows"):
                    assert torch.equal(state[leaf], fresh[name].state_dict()[leaf]), (name, leaf)


def test_reference_windowed_sliced_read_is_stale():
    """Fault of the JAX package, pinned: after a first read of
    WindowedMetric(SlicedMetric(PSNR())), a second read with another window
    returns the first one's value (its SlicedMetric.compute_state serves the
    template's per-slice values of the previous fold). The port's reads are
    each within 1e-6 of a fresh SlicedMetric over the window's updates."""
    s = 100
    rng = np.random.default_rng(2024)
    batches = [_psnr_batch(rng, 64, s, scale=0.02 * (i + 1), dyadic=False) for i in range(10)]

    def fresh_jax(updates):
        m = JaxSliced(JaxPSNR(), s)
        for i in updates:
            m.update(*(jnp.asarray(x) for x in batches[i]))
        return np.asarray(m.compute())

    def fresh_port(updates):
        m = SlicedMetric(PeakSignalNoiseRatio(device="cpu"), s)
        for i in updates:
            m.update(*(torch.from_numpy(x) for x in batches[i]))
        return m.compute().numpy()

    reads = {"full": ({}, range(0, 10)), "window=2": ({"window": 2}, range(4, 10))}
    for first, second in (("full", "window=2"), ("window=2", "full")):
        jax_metric = JaxWindowed(JaxSliced(JaxPSNR(), s), window=8, updates_per_bucket=4)
        metric = WindowedMetric(SlicedMetric(PeakSignalNoiseRatio(device="cpu"), s), window=8, updates_per_bucket=4)
        for batch in batches:
            _feed(jax_metric, metric, batch)
        jax_first = np.asarray(jax_metric.compute(**reads[first][0]))
        jax_second = np.asarray(jax_metric.compute(**reads[second][0]))
        want_second = fresh_jax(reads[second][1])
        finite = ~np.isnan(want_second) & ~np.isnan(jax_second)
        # the reference's first read is right, its second is the first's value
        np.testing.assert_allclose(jax_first, fresh_jax(reads[first][1]), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(jax_second, jax_first)
        assert np.abs(jax_second - want_second)[finite].max() > 1.0
        # the port's reads are both right
        for name in (first, second):
            np.testing.assert_allclose(metric.compute(**reads[name][0]).numpy(), fresh_port(reads[name][1]), rtol=1e-6, atol=1e-6)


def test_decay_follows_a_float64_recurrence():
    metric = WindowedMetric(MeanSquaredError(device="cpu"), mode="decay", decay=0.95)
    rng = np.random.default_rng(6)
    sse = total = weight = 0.0
    for _ in range(40):
        preds, target = rng.random(50, dtype=np.float32), rng.random(50, dtype=np.float32)
        metric.update(torch.from_numpy(preds), torch.from_numpy(target))
        sse = 0.95 * sse + float(((preds.astype(np.float64) - target) ** 2).sum())
        total = 0.95 * total + 50
        weight = 0.95 * weight + 1
    assert abs(float(metric.compute()) - sse / total) < 1e-5
    assert abs(float(metric.decay_weight) - weight) < 1e-5
    assert metric.total.dtype == torch.float32  # a decayed count is fractional


def test_construction_and_mode_errors():
    mse = MeanSquaredError(device="cpu")
    for kw, match in (
        ({"mode": "sliding"}, "`mode` must be one of"),
        ({"window": 1}, "int >= 2"),
        ({"updates_per_bucket": 0}, "positive int"),
        ({"decay": 0.9}, "only applies to mode='decay'"),
        ({"mode": "decay", "window": 4}, "only apply to mode='ring'"),
        ({"mode": "decay", "decay": 1.5}, "float in \\(0, 1\\)"),
    ):
        with pytest.raises(Exception, match=match):  # the JAX package's own MetricsUserError
            JaxWindowed(JaxMSE(), **kw)
        with pytest.raises(MetricsUserError, match=match):
            WindowedMetric(mse, **kw)
    with pytest.raises(MetricsUserError, match="exponential decay is only exact"):
        WindowedMetric(PeakSignalNoiseRatio(device="cpu"), mode="decay")
    with pytest.raises(MetricsUserError, match="list \\('cat'\\) state"):
        WindowedMetric(PeakSignalNoiseRatio(data_range=1.0, dim=1, device="cpu"))
    with pytest.raises(MetricsUserError, match="reducer `dim_zero_mean`"):
        WindowedMetric(PeakSignalNoiseRatio(data_range=1.0, device="cpu"))
    with pytest.raises(MetricsUserError, match="cannot wrap another WindowedMetric"):
        WindowedMetric(WindowedMetric(mse))
    # sketch leaves window in ring mode only: their weights must not be scaled
    with pytest.raises(MetricsUserError, match="mode='ring'"):
        WindowedMetric(AUROC(device="cpu"), mode="decay")
    ring = WindowedMetric(mse)
    # the fused update's pad-and-mask contract: the third row is an edge pad
    ring.update(torch.ones(3), torch.zeros(3), n_valid=2)
    assert int(ring.window_state()["total"]) == 2 and float(ring.compute()) == 1.0
    with pytest.raises(MetricsUserError, match="ring-mode query"):
        WindowedMetric(mse, mode="decay").compute(window=2)
    with pytest.raises(MetricsUserError, match="decay-mode query"):
        ring.decay_weight


def test_windowed_state_from_jax_round_trip():
    jax_metric = JaxWindowed(JaxSliced(JaxPSNR(), 5), window=3, updates_per_bucket=1)
    metric = WindowedMetric(SlicedMetric(PeakSignalNoiseRatio(device="cpu"), 5), window=3, updates_per_bucket=1)
    rng = np.random.default_rng(12)
    for _ in range(4):
        jax_metric.update(*(jnp.asarray(x) for x in _psnr_batch(rng, 10, 5)))
    state = state_from_jax({k: np.asarray(v) for k, v in jax_metric.state_dict().items()}, metric)
    assert state["sum_squared_error"].shape == (3, 5) and state["_ring_count"].dtype == torch.int32
    metric.load_state_dict(state)
    batch = _psnr_batch(rng, 10, 5)
    _feed(jax_metric, metric, batch)
    _assert_states_equal(jax_metric, metric)
    np.testing.assert_allclose(metric.compute(window=2).numpy(), np.asarray(jax_metric.compute(window=2)), rtol=1e-6)


# ---------------------------------------------------------------------------
# the ring of sketch leaves
# ---------------------------------------------------------------------------


def _curve_batches(seed, sizes):
    rng = np.random.RandomState(seed)
    return [(rng.rand(n).astype(np.float32), (rng.rand(n) < 0.4).astype(np.int32)) for n in sizes]


@pytest.mark.parametrize("updates_per_bucket", [1, 2])
def test_windowed_sketched_auroc_bit_identical_in_lossless_window(updates_per_bucket):
    batches = _curve_batches(7, [32] * 6)
    jax_metric = JaxWindowed(JaxAUROC(pos_label=1, sketch_capacity=512), window=3, updates_per_bucket=updates_per_bucket)
    metric = WindowedMetric(AUROC(pos_label=1, sketch_capacity=512, device="cpu"), window=3, updates_per_bucket=updates_per_bucket)
    for batch in batches:
        _feed(jax_metric, metric, batch)
    _assert_states_equal(jax_metric, metric)
    assert isinstance(metric._reductions["csketch"], type(ring_merge_fx(None)))
    assert tuple(metric.csketch.shape) == (3, 512, 3)
    for window in (1, 2, 3):
        fresh = AUROC(pos_label=1, sketch_capacity=512, device="cpu")
        for preds, target in batches[len(batches) - window * updates_per_bucket :]:
            fresh.update(torch.from_numpy(preds), torch.from_numpy(target))
        got = metric.compute(window=window)
        assert got.numpy().view(np.int32) == fresh.compute().numpy().view(np.int32)
        # the exact AUROC kernels agree with the JAX package's to float32 rounding
        np.testing.assert_allclose(float(got), float(jax_metric.compute(window=window)), atol=1e-6)


def test_windowed_sketch_past_capacity_matches_jax():
    """Buckets of two 48-row batches overflow a capacity-64 sketch: each
    bucket compacts on its second update, and reads compact as they fold."""
    batches = _curve_batches(9, [48] * 7)
    jax_metric = JaxWindowed(JaxAUROC(pos_label=1, sketch_capacity=64), window=3, updates_per_bucket=2)
    metric = WindowedMetric(AUROC(pos_label=1, sketch_capacity=64, device="cpu"), window=3, updates_per_bucket=2)
    for batch in batches:
        _feed(jax_metric, metric, batch)
    ring, want = metric.csketch.numpy(), np.asarray(jax_metric.csketch)
    # occupancy and mass per slot are exact; centroids differ by float32
    # rounding where an asin ulp moves a row across a bucket edge
    np.testing.assert_array_equal((ring[..., 0] > 0).sum(axis=1), (want[..., 0] > 0).sum(axis=1))
    np.testing.assert_array_equal(ring[..., 0].sum(axis=1), want[..., 0].sum(axis=1))
    np.testing.assert_array_equal(metric.n_seen.numpy(), np.asarray(jax_metric.n_seen))
    for window in (1, 2, 3):
        np.testing.assert_allclose(float(metric.compute(window=window)), float(jax_metric.compute(window=window)), atol=1e-6)


def test_bucketed_windowed_auroc_corrects_sum_companions():
    """A masking template pad-masks its sketch leaf itself, but its sum
    companion (``n_seen``) counts the padded batch: the wrapper's slot-aware
    correction removes the pad rows from it, so the bucketed fused update
    equals the eager one bit for bit (and the JAX package's)."""
    batches = _curve_batches(12, (48, 64, 57))

    def make():
        return MetricCollection({"auroc": WindowedMetric(AUROC(pos_label=1, sketch_capacity=512, device="cpu"), window=3)})

    fused = make()
    handle = fused.compile_update(buckets=(64,))
    eager = WindowedMetric(AUROC(pos_label=1, sketch_capacity=512, device="cpu"), window=3)
    jax_metric = JaxCollection({"auroc": JaxWindowed(JaxAUROC(pos_label=1, sketch_capacity=512), window=3)})
    jax_metric.compile_update(buckets=(64,))
    for preds, target in batches:
        fused.update(torch.from_numpy(preds), torch.from_numpy(target))
        eager.update(torch.from_numpy(preds), torch.from_numpy(target))
        jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
    assert handle.n_compiles == 1 and not handle.declined
    for name in eager._defaults:
        assert torch.equal(getattr(fused["auroc"], name), getattr(eager, name)), name
    assert fused["auroc"].n_seen.tolist() == [48, 64, 57] == np.asarray(jax_metric["auroc"].n_seen).tolist()
    assert float(fused.compute()["auroc"]) == float(eager.compute()) == float(jax_metric.compute()["auroc"])


def test_ring_sketch_merges_per_slot():
    """``merge_states`` of two rings merges slot by slot with the sketch's
    own merge: the mass doubles in the written slot, the others stay empty."""
    metric = WindowedMetric(AUROC(pos_label=1, sketch_capacity=64, device="cpu"), window=3)
    preds, target = _curve_batches(11, [16])[0]
    metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    state = metric.state_dict()
    merged = metric.merge_states(state, state)
    sk_in, sk_out = state["csketch"], merged["csketch"]
    assert float(sk_out[..., 0].sum()) == 2 * float(sk_in[..., 0].sum()) == 32.0
    assert int((sk_out[1:, :, 0] > 0).sum()) == 0
    # inside the window a merge is the concatenation, in order
    torch.testing.assert_close(sk_out[0, 16:32], sk_in[0, :16], rtol=0, atol=0)
    assert merged["n_seen"].tolist() == [32, 0, 0]
    # the reducer itself, over stacked rings of two processes
    red = metric._reductions["csketch"]
    assert torch.equal(red(torch.stack([sk_in, sk_in])), sk_out)
    assert torch.equal(red(sk_in), sk_in)
