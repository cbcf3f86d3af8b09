"""``dtype``/``set_dtype`` and the half-precision sketch leaves: the port
against the JAX package.

* ``Metric.set_dtype`` over every ported family casts the floating states
  and defaults (list states too) and keeps the integer ones, with the JAX
  package's state dtypes after the cast and after a later update; a cached
  ``compute()`` value is cast and kept; ``SlicedMetric`` refolds its kept
  per-slice values and ``WindowedMetric`` casts its rings.
* ``MetricCollection.set_dtype`` drains an open async handle first, and a
  compiled update captures anew over the cast states (on the CPU: a new
  cache entry), with states equal to the eager update's bit for bit.
* Half-precision sketch leaves (ROADMAP.md, C, "Properties"): a bfloat16
  sketch compacts widened to float32 and rounded back once, so its value
  stays within 1e-4 of the float32 run's (measured 8.2e-6 over 16 of
  curve-binary's batches); the JAX package compacts in bfloat16, whose
  running weight sum stalls, and lands 1.4e-2 off (pinned). Inside the
  lossless window no compaction runs and the two packages' bfloat16
  sketches and values are equal bit for bit.
"""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import metrics_tpu
import metrics_tpu_torch
from metrics_tpu.sliced import SlicedMetric as JaxSliced
from metrics_tpu.windowed import WindowedMetric as JaxWindowed
from metrics_tpu_torch import MetricCollection, SlicedMetric, WindowedMetric
from metrics_tpu_torch.ops.qsketch import compact_rows_reference, qsketch_compact_dispatch

torch.set_num_threads(2)

_JAX_DTYPES = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16, torch.float64: jnp.float32}


def _cls_inputs(seed, n=64, c=4):
    rng = np.random.RandomState(seed)
    preds = rng.rand(n, c).astype(np.float32)
    return preds / preds.sum(-1, keepdims=True), rng.randint(0, c, n).astype(np.int32)


def _reg_inputs(seed, n=64):
    rng = np.random.RandomState(seed)
    preds = rng.rand(n).astype(np.float32) + 0.1
    return preds, (preds + rng.rand(n).astype(np.float32)).astype(np.float32)


def _bin_inputs(seed, n=64):
    rng = np.random.RandomState(seed)
    return rng.rand(n).astype(np.float32), (rng.rand(n) < 0.4).astype(np.int32)


# (class name, kwargs, inputs)
FAMILIES = [
    ("Accuracy", {}, _cls_inputs),
    ("F1Score", {"num_classes": 4, "average": "macro"}, _cls_inputs),
    ("ConfusionMatrix", {"num_classes": 4}, _cls_inputs),
    ("MatthewsCorrCoef", {"num_classes": 4}, _cls_inputs),
    ("AUROC", {}, _bin_inputs),
    ("AUROC", {"exact": True}, _bin_inputs),
    ("AUROC", {"capacity": 256}, _bin_inputs),
    ("AveragePrecision", {}, _bin_inputs),
    ("CalibrationError", {}, _bin_inputs),
    ("BinnedAveragePrecision", {"num_classes": 1, "thresholds": 10}, _bin_inputs),
    ("HingeLoss", {}, _bin_inputs),
    ("MeanSquaredError", {}, _reg_inputs),
    ("MeanAbsoluteError", {}, _reg_inputs),
    ("MeanAbsolutePercentageError", {}, _reg_inputs),
    ("TweedieDevianceScore", {"power": 1.5}, _reg_inputs),
    ("ExplainedVariance", {}, _reg_inputs),
    ("R2Score", {}, _reg_inputs),
    ("PearsonCorrCoef", {}, _reg_inputs),
    ("SpearmanCorrCoef", {}, _reg_inputs),
    ("SpearmanCorrCoef", {"exact": True}, _reg_inputs),
    ("CosineSimilarity", {"reduction": "mean", "exact": True}, _reg_inputs),
    ("PeakSignalNoiseRatio", {}, _reg_inputs),
]
IDS = [f"{c}-{'-'.join(f'{k}={v}' for k, v in kw.items()) or 'default'}" for c, kw, _ in FAMILIES]


def _pair(name, kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return getattr(metrics_tpu, name)(**kwargs), getattr(metrics_tpu_torch, name)(device="cpu", **kwargs)


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


def _assert_dtypes_match(jax_metric, metric):
    want = jax_metric.state_dict()
    got = metric.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        if isinstance(w, list):
            assert [_dtype_name(g) for g in got[name]] == [str(np.asarray(x).dtype) for x in w], name
        else:
            assert _dtype_name(got[name]) == str(np.asarray(w).dtype), name


@pytest.mark.parametrize("name, kwargs, inputs", FAMILIES, ids=IDS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_set_dtype_casts_float_leaves_like_jax(name, kwargs, inputs, dtype):
    jax_metric, metric = _pair(name, kwargs)
    preds, target = inputs(0)
    jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
    metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    before = {k: getattr(metric, k) for k in metric._defaults}
    assert metric.dtype == torch.float32
    assert metric.set_dtype(dtype) is metric and metric.dtype == dtype
    jax_metric.set_dtype(_JAX_DTYPES[dtype])
    for state, old in before.items():
        new, default = getattr(metric, state), metric._defaults[state]
        for o, n in zip(old if isinstance(old, list) else [old], new if isinstance(new, list) else [new]):
            if not isinstance(o, torch.Tensor):
                continue
            assert n.dtype == (dtype if o.is_floating_point() else o.dtype), state
            assert torch.equal(n, o.to(n.dtype)), state
        if isinstance(default, torch.Tensor) and default.is_floating_point():
            assert default.dtype == dtype, state
    _assert_dtypes_match(jax_metric, metric)
    # a later update follows the JAX package's promotions
    preds, target = inputs(1)
    jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
    metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    _assert_dtypes_match(jax_metric, metric)
    np.testing.assert_allclose(
        np.asarray(metric.compute().float()), np.asarray(jax_metric.compute(), np.float32), rtol=2e-2, atol=2e-2
    )


def test_computed_value_is_cast_and_kept():
    jax_metric, metric = _pair("MeanSquaredError", {})
    preds, target = _reg_inputs(2)
    jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
    metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    value = metric.compute()
    jax_value = jax_metric.compute()
    epoch = metric._write_epoch
    metric.set_dtype(torch.bfloat16)
    jax_metric.set_dtype(jnp.bfloat16)
    assert metric._write_epoch == epoch + 1 and metric._computed_epoch == metric._write_epoch
    cached = metric.compute()
    assert cached is metric._computed and cached.dtype == torch.bfloat16
    assert torch.equal(cached, value.to(torch.bfloat16))
    assert np.asarray(jax_metric.compute()).view(np.uint16) == np.asarray(jax_value.astype(jnp.bfloat16)).view(np.uint16)
    assert cached.view(torch.int16).item() == np.asarray(jax_metric.compute()).view(np.int16).item()


def test_sliced_and_windowed_set_dtype_match_jax():
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 4, 32).astype(np.int32)
    preds, target = _reg_inputs(6, 32)
    jax_sliced = JaxSliced(metrics_tpu.MeanSquaredError(), 4)
    sliced = SlicedMetric(metrics_tpu_torch.MeanSquaredError(device="cpu"), 4)
    jax_ring = JaxWindowed(metrics_tpu.MeanSquaredError(), window=3)
    ring = WindowedMetric(metrics_tpu_torch.MeanSquaredError(device="cpu"), window=3)
    jax_sliced.update(jnp.asarray(ids), jnp.asarray(preds), jnp.asarray(target))
    sliced.update(torch.from_numpy(ids), torch.from_numpy(preds), torch.from_numpy(target))
    jax_ring.update(jnp.asarray(preds), jnp.asarray(target))
    ring.update(torch.from_numpy(preds), torch.from_numpy(target))
    f32_values = sliced.compute()
    assert sliced._values is not None
    for jax_metric, metric in ((jax_sliced, sliced), (jax_ring, ring)):
        metric.set_dtype(torch.bfloat16)
        jax_metric.set_dtype(jnp.bfloat16)
        _assert_dtypes_match(jax_metric, metric)
    # the kept per-slice values were dropped: every slice refolds from the
    # cast states
    assert sliced._values is None
    np.testing.assert_allclose(sliced.compute().float().numpy(), f32_values.numpy(), rtol=2e-2)
    # the template stays float32, as in the JAX package
    assert ring.wrapped._defaults["sum_squared_error"].dtype == torch.float32
    preds, target = _reg_inputs(7, 32)
    jax_ring.update(jnp.asarray(preds), jnp.asarray(target))
    ring.update(torch.from_numpy(preds), torch.from_numpy(target))
    _assert_dtypes_match(jax_ring, ring)
    np.testing.assert_allclose(float(ring.compute(window=1)), float(jax_ring.compute(window=1)), rtol=1e-6)


def test_windowed_sketch_ring_set_dtype_matches_jax():
    """A bfloat16 ring of sketches: each bucket's update runs in the
    template's float32 and lands in the bfloat16 ring, as in the JAX
    package; rings and reads inside the window equal the JAX package's."""
    jax_ring = JaxWindowed(metrics_tpu.AUROC(pos_label=1, sketch_capacity=64), window=3)
    ring = WindowedMetric(metrics_tpu_torch.AUROC(pos_label=1, sketch_capacity=64, device="cpu"), window=3)
    jax_ring.set_dtype(jnp.bfloat16)
    ring.set_dtype(torch.bfloat16)
    for i in range(4):
        preds, target = _bin_inputs(40 + i, 48)
        jax_ring.update(jnp.asarray(preds), jnp.asarray(target))
        ring.update(torch.from_numpy(preds), torch.from_numpy(target))
    _assert_dtypes_match(jax_ring, ring)
    np.testing.assert_array_equal(ring.csketch.view(torch.int16).numpy(), np.asarray(jax_ring.csketch).view(np.int16))
    got, want = ring.compute(window=1), jax_ring.compute(window=1)
    assert _dtype_name(got) == str(np.asarray(want).dtype)
    np.testing.assert_allclose(got.float().item(), float(want), atol=1e-6)


def test_collection_set_dtype_drains_async():
    collection = MetricCollection([metrics_tpu_torch.MeanSquaredError(device="cpu"), metrics_tpu_torch.MeanAbsoluteError(device="cpu")])
    blocking = MetricCollection([metrics_tpu_torch.MeanSquaredError(device="cpu"), metrics_tpu_torch.MeanAbsoluteError(device="cpu")])
    handle = collection.compile_update_async(queue_depth=4)
    batches = [_reg_inputs(10 + i) for i in range(4)]
    for preds, target in batches:
        assert collection.update_async(torch.from_numpy(preds), torch.from_numpy(target))
        blocking.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert collection.set_dtype(torch.bfloat16) is collection
    assert not handle.closed and handle.pending == 0
    for name, metric in blocking.items():
        for state in metric._defaults:
            want = getattr(metric, state)
            got = getattr(collection[name], state)
            if want.is_floating_point():
                want = want.to(torch.bfloat16)
            assert got.dtype == want.dtype and torch.equal(got, want), (name, state)


@pytest.mark.parametrize("buckets", [None, (64,)])
def test_fused_update_captures_anew_after_set_dtype(buckets):
    """The fused cache keys on the states' dtypes: the update after the
    cast compiles a new entry over the bfloat16 states (on the card, a new
    graph), the next one another, because the sum states come back float32
    (bfloat16 + float32 promotes, as in the JAX package) while the sketch
    stays bfloat16; then the cache is stable. Every state equals the eager
    update's bit for bit."""
    def make():
        return MetricCollection(
            [
                metrics_tpu_torch.MeanSquaredError(device="cpu"),
                metrics_tpu_torch.MeanAbsoluteError(device="cpu"),
                metrics_tpu_torch.AUROC(sketch_capacity=64, device="cpu"),
            ]
        )

    eager, fused = make(), make()
    handle = fused.compile_update(buckets=buckets)
    compiles = []
    # dyadic scores: every sum is exact, so the bucketed pad correction
    # (k * delta of the last row) leaves the eager bits
    rng = np.random.RandomState(20)
    batches = [((rng.randint(0, 64, 48) / 64).astype(np.float32), rng.randint(0, 2, 48).astype(np.int32)) for _ in range(6)]
    for i, (preds, target) in enumerate(batches):
        if i == 2:
            eager.set_dtype(torch.bfloat16)
            fused.set_dtype(torch.bfloat16)
        eager.update(torch.from_numpy(preds), torch.from_numpy(target))
        fused.update(torch.from_numpy(preds), torch.from_numpy(target))
        compiles.append(handle.n_compiles)
    assert compiles == [1, 1, 2, 3, 3, 3]
    assert fused["AUROC"].csketch.dtype == torch.bfloat16
    assert fused["MeanSquaredError"].sum_squared_error.dtype == torch.float32
    for name, metric in eager.items():
        for state in metric._defaults:
            got, want = getattr(fused[name], state), getattr(metric, state)
            assert torch.as_tensor(got).dtype == torch.as_tensor(want).dtype, (name, state)
            assert torch.equal(torch.as_tensor(got), torch.as_tensor(want)), (name, state)


# ---------------------------------------------------------------------------
# half-precision sketch leaves
# ---------------------------------------------------------------------------


def _curve_stream(batches):
    """curve-binary's stream (bench.py's bench_sketch: RandomState(10),
    4096 uniform scores, then labels positive at rate 0.35)."""
    rng = np.random.RandomState(10)
    out = []
    for _ in range(batches):
        scores = rng.rand(4096).astype(np.float32)
        out.append((scores, (rng.rand(4096) < 0.35).astype(np.int32)))
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_compaction_widens_compacts_and_rounds_once(dtype):
    rng = np.random.RandomState(3)
    rows = torch.from_numpy(np.stack([rng.randint(1, 4, 300), rng.rand(300), rng.rand(300) < 0.3], 1).astype(np.float32))
    rows[250:, 0] = 0
    half = rows.to(dtype)
    got = qsketch_compact_dispatch(half, 64)
    assert got.dtype == dtype
    assert torch.equal(got, compact_rows_reference(half.float(), 64).to(dtype))
    # float32 rows keep the plain path as it was
    assert torch.equal(qsketch_compact_dispatch(rows, 64), compact_rows_reference(rows, 64))


def test_bf16_sketch_inside_the_window_equals_jax_bit_for_bit():
    jax_metric, metric = _pair("AUROC", {})
    jax_metric.set_dtype(jnp.bfloat16)
    metric.set_dtype(torch.bfloat16)
    for preds, target in _curve_stream(2):  # 8192 rows: no compaction
        jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
        metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    got, want = metric.csketch, np.asarray(jax_metric.csketch)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    value, jax_value = metric.compute(), np.asarray(jax_metric.compute())
    assert _dtype_name(value) == str(jax_value.dtype)
    assert value.float().item() == float(jax_value)


def test_bf16_sketch_past_the_window_is_a_property_of_the_reference():
    """16 of curve-binary's batches (65,536 rows, 7 compactions of a
    capacity-8192 sketch). The port's bfloat16 value stays with its float32
    value; the JAX package's own-dtype compaction (a bfloat16 running sum
    of the weights, which stops growing at 256 units) loses weight and
    drifts. Both are pinned; the port is not bent toward the reference."""
    batches = _curve_stream(16)
    runs = {}
    for label, dtype, jdtype in (("bf16", torch.bfloat16, jnp.bfloat16), ("f32", None, None)):
        jax_metric, metric = _pair("AUROC", {})
        if dtype is not None:
            jax_metric.set_dtype(jdtype)
            metric.set_dtype(dtype)
        for preds, target in batches:
            jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
            metric.update(torch.from_numpy(preds), torch.from_numpy(target))
        runs[label] = (metric, jax_metric)
    port_bf16, jax_bf16 = runs["bf16"]
    port_f32, jax_f32 = runs["f32"]
    assert float(port_f32.compute()) == pytest.approx(float(jax_f32.compute()), abs=1e-6)
    port_err = abs(float(port_bf16.compute()) - float(port_f32.compute()))
    jax_err = abs(float(jax_bf16.compute()) - float(jax_f32.compute()))
    assert port_err < 1e-4, port_err
    assert jax_err > 1e-2, jax_err
    # total weight: the port keeps every row to bfloat16 rounding of its
    # centroid weights; the reference's stalls
    assert abs(float(port_bf16.csketch[:, 0].float().sum()) - 65536) < 64
    assert float(np.asarray(jax_bf16.csketch[:, 0], np.float32).sum()) < 65000


def test_bf16_sketch_fuses_with_the_eager_bits():
    """A bfloat16 sketch in a compiled update past the window: the fused
    compaction (the plain version on the CPU) gives the eager bits."""
    def make():
        collection = MetricCollection([metrics_tpu_torch.AUROC(sketch_capacity=256, device="cpu")])
        collection.set_dtype(torch.bfloat16)
        return collection

    eager, fused = make(), make()
    fused.compile_update(buckets=(128,))
    for preds, target in (_bin_inputs(30 + i, 100) for i in range(6)):
        eager.update(torch.from_numpy(preds), torch.from_numpy(target))
        fused.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert torch.equal(fused["AUROC"].csketch.view(torch.int16), eager["AUROC"].csketch.view(torch.int16))
    assert torch.equal(fused.compute()["AUROC"], eager.compute()["AUROC"])
