"""The wrappers and the child registry: the port against the JAX package.

The JAX package's wrapper contract (``tests/wrappers/test_wrappers.py``) on
the same seeded numpy inputs: ``BootStrapper`` (its index vectors and every
copy's states bit-equal to the JAX package's under both sampling
strategies, through ``update`` and through ``forward``, which draws twice;
each copy's value, mean, std and quantile within rtol 1e-6 / atol 1e-6), ``ClasswiseWrapper``,
``MinMaxMetric`` (bit-equal; ``forward`` keeps the extremes),
``MultioutputWrapper`` (NaN rows removed per output, within rtol 1e-5) and
``MetricTracker`` (``compute_all`` and ``best_metric(return_step=True)``).
Also: ``state_dict``/``load_state_dict`` round trips under the JAX
package's keys, ``set_dtype``/``to_device``/``clone`` recursing into
children, ``SlicedMetric``/``WindowedMetric`` refusing wrapper and
composition templates with the JAX package's message, a ``SlicedMetric``
whose template is no child and still fuses, a wrapper sent to a fused
update's eager leg with its name in ``declined``, and ``carry_from_jax``
continuing a JAX epoch bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
from metrics_tpu.wrappers.bootstrapping import _bootstrap_sampler as jax_sampler
import metrics_tpu_torch as tm
from metrics_tpu_torch.convert import carry_from_jax
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from metrics_tpu_torch.wrappers.bootstrapping import _bootstrap_sampler

torch.set_num_threads(2)

_rng = np.random.RandomState(42)
LABELS = [(_rng.randint(0, 4, 48), _rng.randint(0, 4, 48)) for _ in range(3)]
FLOATS = [(_rng.rand(64).astype(np.float32), _rng.rand(64).astype(np.float32)) for _ in range(3)]


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _bits_equal(got, want):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    assert got.tobytes() == want.tobytes()


def _child_states_equal(tmetric, jmetric, exact=True):
    tchildren, jchildren = dict(tmetric._iter_child_metrics()), dict(jmetric._iter_child_metrics())
    assert tchildren.keys() == jchildren.keys()
    for name, child in tchildren.items():
        for key in child._defaults:
            got, want = getattr(child, key), getattr(jchildren[name], key)
            if exact:
                _bits_equal(got, want)
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# BootStrapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
def test_bootstrap_sampler_draws_the_jax_indices(strategy):
    got = _bootstrap_sampler(50, strategy, np.random.RandomState(0))
    want = jax_sampler(50, strategy, np.random.RandomState(0))
    assert np.array_equal(got, np.asarray(want)) and got.min() >= 0 and got.max() < 50


@pytest.mark.parametrize("through", ["update", "forward"])
@pytest.mark.parametrize("strategy", ["poisson", "multinomial"])
def test_bootstrapper_copies_are_bit_equal_to_jax(strategy, through):
    # poisson resamples differ in length: the JAX package compiles each
    kw = dict(num_bootstraps=7 if strategy == "multinomial" else 4, quantile=0.95, raw=True, sampling_strategy=strategy, seed=3)
    jb = metrics_tpu.BootStrapper(metrics_tpu.CohenKappa(num_classes=4), **kw)
    tb = tm.BootStrapper(tm.CohenKappa(num_classes=4, device="cpu"), **kw)
    for preds, target in LABELS:
        jout = getattr(jb, through)(*_j(preds, target))
        tout = getattr(tb, through)(*_t(preds, target))
        if through == "forward":
            for key in jout:
                np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]), rtol=1e-6, atol=1e-6)
    _child_states_equal(tb, jb)
    jout, tout = jb.compute(), tb.compute()
    assert tout.keys() == jout.keys() == {"mean", "std", "quantile", "raw"}
    # each copy's kappa from bit-equal confusion matrices, in each package's
    # float order: 1 - p_o / p_e cancels near 0, so 1 ulp of 1 (atol 1e-6)
    for key in ("raw", "mean", "std", "quantile"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]), rtol=1e-6, atol=1e-6)
    assert tb._rng.randint(0, 2**31) == jb._rng.randint(0, 2**31)  # the streams stay in step


def test_bootstrapper_float_metric_and_forward_accumulates():
    jb = metrics_tpu.BootStrapper(metrics_tpu.MeanSquaredError(), num_bootstraps=20, raw=True, seed=0)
    tb = tm.BootStrapper(tm.MeanSquaredError(device="cpu"), num_bootstraps=20, raw=True, seed=0)
    preds, target = FLOATS[0]
    jb.update(*_j(preds, target))
    tb.update(*_t(preds, target))
    _child_states_equal(tb, jb, exact=False)
    out = tb.compute()
    assert out["raw"].shape == (20,)
    assert abs(float(out["mean"]) - float(np.mean((preds - target) ** 2))) < 0.05
    acc = tm.BootStrapper(tm.MeanSquaredError(device="cpu"), num_bootstraps=4, seed=0)
    acc(*_t(preds, target))
    acc(*_t(preds + 1.0, target))
    assert float(acc.compute()["mean"]) > float(np.mean((preds - target) ** 2))


def test_bootstrapper_invalid():
    with pytest.raises(ValueError):
        tm.BootStrapper("not a metric")
    with pytest.raises(ValueError):
        tm.BootStrapper(tm.MeanSquaredError(device="cpu"), sampling_strategy="bad")
    with pytest.raises(ValueError, match="could not determine the sampling size"):
        tm.BootStrapper(tm.SumMetric(device="cpu")).update()


# ---------------------------------------------------------------------------
# ClasswiseWrapper, MinMaxMetric, MultioutputWrapper
# ---------------------------------------------------------------------------


def test_classwise_wrapper_matches_jax():
    kw = dict(labels=["horse", "fish", "dog", "cat"])
    jw = metrics_tpu.ClasswiseWrapper(metrics_tpu.JaccardIndex(num_classes=4, reduction="none"), **kw)
    tw = tm.ClasswiseWrapper(tm.JaccardIndex(num_classes=4, reduction="none", device="cpu"), **kw)
    for preds, target in LABELS:
        jout, tout = jw(*_j(preds, target)), tw(*_t(preds, target))
        assert tout.keys() == jout.keys()
        for key in jout:
            _bits_equal(tout[key], jout[key])
    jout, tout = jw.compute(), tw.compute()
    for key in jout:
        _bits_equal(tout[key], jout[key])
    nolabels = tm.ClasswiseWrapper(tm.Accuracy(num_classes=3, average="none", device="cpu"))
    assert set(nolabels(*_t([0, 1, 2, 1], [0, 1, 1, 1]))) == {"accuracy_0", "accuracy_1", "accuracy_2"}
    with pytest.raises(ValueError):
        tm.ClasswiseWrapper("nope")
    with pytest.raises(ValueError):
        tm.ClasswiseWrapper(tm.Accuracy(device="cpu"), labels=[1, 2])
    mc = tm.MetricCollection({"acc": tm.ClasswiseWrapper(tm.Accuracy(num_classes=3, average="none", device="cpu"), labels=["a", "b", "c"])})
    assert set(mc(*_t([0, 1, 2], [0, 1, 1]))) == {"accuracy_a", "accuracy_b", "accuracy_c"}


def test_minmax_matches_jax_and_forward_keeps_extremes():
    jm, tmm = metrics_tpu.MinMaxMetric(metrics_tpu.Accuracy()), tm.MinMaxMetric(tm.Accuracy(device="cpu"))
    labels = np.array([0, 1, 0, 1])
    for preds in ([0, 1, 0, 1], [1, 0, 1, 0], [1, 1, 0, 1]):
        jout, tout = jm(*_j(np.array(preds), labels)), tmm(*_t(np.array(preds), labels))
        for key in ("raw", "min", "max"):
            _bits_equal(tout[key], jout[key])
    jout, tout = jm.compute(), tmm.compute()
    for key in ("raw", "min", "max"):
        _bits_equal(tout[key], jout[key])
    assert float(tout["max"]) == 1.0 and float(tout["min"]) == 0.0
    assert float(tout["raw"]) == pytest.approx(7 / 12)
    tmm.reset()
    assert float(tmm.min_val) == float("inf") and float(tmm.max_val) == -float("inf")
    with pytest.raises(ValueError):
        tm.MinMaxMetric("nope")
    with pytest.raises(RuntimeError, match="scalar"):
        bad = tm.MinMaxMetric(tm.Accuracy(num_classes=3, average=None, device="cpu"))
        bad.update(*_t([0, 1, 2], [0, 1, 1]))
        bad.compute()


def test_multioutput_matches_jax_with_nan_rows():
    rng = np.random.RandomState(5)
    batches = []
    for _ in range(3):
        target = rng.randn(40, 3).astype(np.float32)
        preds = (target + 0.3 * rng.randn(40, 3)).astype(np.float32)
        target[rng.rand(40) < 0.1, rng.randint(0, 3)] = np.nan
        preds[rng.rand(40) < 0.1, rng.randint(0, 3)] = np.nan
        batches.append((preds, target))
    for base in ("R2Score", "MeanAbsoluteError"):
        jw = metrics_tpu.MultioutputWrapper(getattr(metrics_tpu, base)(), 3)
        tw = tm.MultioutputWrapper(getattr(tm, base)(device="cpu"), 3)
        for i, (preds, target) in enumerate(batches):
            if i == 0:
                jout, tout = jw(*_j(preds, target)), tw(*_t(preds, target))
                np.testing.assert_allclose([float(v) for v in tout], [float(v) for v in jout], rtol=1e-5)
            else:
                jw.update(*_j(preds, target))
                tw.update(*_t(preds, target))
        _child_states_equal(tw, jw, exact=False)
        np.testing.assert_allclose([float(v) for v in tw.compute()], [float(v) for v in jw.compute()], rtol=1e-5)
    r2 = tm.MultioutputWrapper(tm.R2Score(device="cpu"), 2)
    out = r2(*_t(np.array([[0.0, 2.0], [-1.0, 2.0], [8.0, -5.0]], np.float32), np.array([[0.5, 1.0], [-1.0, 1.0], [7.0, -6.0]], np.float32)))
    np.testing.assert_allclose([float(v) for v in out], [0.9654, 0.9082], atol=1e-4)


# ---------------------------------------------------------------------------
# MetricTracker
# ---------------------------------------------------------------------------


def test_tracker_single_metric_matches_jax():
    jt = metrics_tpu.MetricTracker(metrics_tpu.Accuracy(num_classes=10), maximize=True)
    tt = tm.MetricTracker(tm.Accuracy(num_classes=10, device="cpu"), maximize=True)
    rng = np.random.RandomState(0)
    for _ in range(5):
        jt.increment()
        tt.increment()
        preds, target = rng.randint(0, 10, 100), rng.randint(0, 10, 100)
        jt.update(*_j(preds, target))
        tt.update(*_t(preds, target))
        _bits_equal(tt.compute(), jt.compute())
    _bits_equal(tt.compute_all(), jt.compute_all())
    assert tt.best_metric(return_step=True) == jt.best_metric(return_step=True)
    assert tt.n_steps == 5
    assert tt.state_footprint() == jt.state_footprint() and tt.total_state_bytes() == jt.total_state_bytes()


def test_tracker_collection_matches_jax():
    def collection(pkg, **kw):
        return pkg.MetricCollection([pkg.MeanSquaredError(**kw), pkg.ExplainedVariance(**kw)])

    jt = metrics_tpu.MetricTracker(collection(metrics_tpu), maximize=[False, True])
    tt = tm.MetricTracker(collection(tm, device="cpu"), maximize=[False, True])
    rng = np.random.RandomState(0)
    for _ in range(3):
        jt.increment()
        tt.increment()
        preds, target = rng.randn(100).astype(np.float32), rng.randn(100).astype(np.float32)
        jt.update(*_j(preds, target))
        tt.update(*_t(preds, target))
    jres, tres = jt.compute_all(), tt.compute_all()
    assert tres.keys() == jres.keys() == {"MeanSquaredError", "ExplainedVariance"}
    for key in jres:
        np.testing.assert_allclose(tres[key].numpy(), np.asarray(jres[key]), rtol=1e-5)
    (tbest, tsteps), (jbest, jsteps) = tt.best_metric(return_step=True), jt.best_metric(return_step=True)
    assert tsteps == jsteps and tbest.keys() == jbest.keys()
    for key in jbest:
        assert tbest[key] == pytest.approx(jbest[key], rel=1e-5)


def test_tracker_non_scalar_best_and_errors():
    tt = tm.MetricTracker(tm.ConfusionMatrix(num_classes=2, device="cpu"))
    tt.increment()
    tt.update(*_t([0, 1], [0, 1]))
    with pytest.warns(UserWarning, match="best"):
        assert tt.best_metric(return_step=True) == (None, None)
    fresh = tm.MetricTracker(tm.Accuracy(device="cpu"))
    with pytest.raises(ValueError, match="increment"):
        fresh.update(*_t([1], [1]))
    with pytest.raises(TypeError):
        tm.MetricTracker("nope")
    with pytest.raises(ValueError):
        tm.MetricTracker(tm.MetricCollection([tm.Accuracy(device="cpu")]), maximize=[True, False])


# ---------------------------------------------------------------------------
# the child registry
# ---------------------------------------------------------------------------


def _wrappers(pkg, **kw):
    return {
        "bootstrap": pkg.BootStrapper(pkg.CohenKappa(num_classes=4, **kw), num_bootstraps=3, seed=1),
        "classwise": pkg.ClasswiseWrapper(pkg.Accuracy(num_classes=4, average=None, **kw)),
        "minmax": pkg.MinMaxMetric(pkg.Accuracy(**kw)),
        "composition": pkg.Accuracy(num_classes=4, **kw) * 2 + pkg.Precision(num_classes=4, average="macro", **kw),
    }


@pytest.mark.parametrize("name", ["bootstrap", "classwise", "minmax", "composition"])
def test_state_dict_round_trip_under_the_jax_keys(name):
    jw, tw = _wrappers(metrics_tpu)[name], _wrappers(tm, device="cpu")[name]
    for preds, target in LABELS:
        jw.update(*_j(preds, target))
        tw.update(*_t(preds, target))
    if name == "minmax":
        jw.compute()
        tw.compute()
    jsd, tsd = jw.state_dict(), tw.state_dict()
    assert tsd.keys() == jsd.keys() and tsd
    for key in jsd:
        _bits_equal(tsd[key], jsd[key])
    fresh = _wrappers(tm, device="cpu")[name]
    fresh.load_state_dict(tsd)
    assert fresh.state_dict().keys() == tsd.keys()
    for key in tsd:
        assert torch.equal(fresh.state_dict()[key], tsd[key])
    got, want = fresh.compute(), tw.compute()
    if isinstance(want, dict):
        for key in want:
            assert torch.equal(got[key], want[key])
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["bootstrap", "classwise", "minmax", "composition"])
def test_set_dtype_to_device_clone_and_persistent_recurse(name):
    wrapper = _wrappers(tm, device="cpu")[name]
    children = dict(wrapper._iter_child_metrics())
    assert children
    wrapper.set_dtype(torch.float64)
    assert all(c.dtype == torch.float64 for c in children.values())
    wrapper.to_device("cpu")
    assert all(c.device.type == "cpu" for c in children.values())
    wrapper.persistent(True)
    assert all(all(c._persistent.values()) for c in children.values() if c._persistent)
    preds, target = LABELS[0]
    wrapper.update(*_t(preds, target))
    copy = wrapper.clone()
    copies = dict(copy._iter_child_metrics())
    assert copies.keys() == children.keys()
    for key, child in children.items():
        assert copies[key] is not child
        for state in child._defaults:
            assert torch.equal(getattr(copies[key], state), getattr(child, state))
    wrapper.reset()
    assert not any(c._update_called for c in children.values())


def test_forward_keeps_the_childrens_accumulation():
    minmax = tm.MinMaxMetric(tm.Accuracy(device="cpu"))
    labels = np.array([0, 1, 0, 1])
    minmax(*_t(np.array([0, 1, 0, 1]), labels))
    minmax(*_t(np.array([1, 0, 1, 0]), labels))
    out = minmax.compute()
    assert float(out["raw"]) == pytest.approx(0.5)  # accumulated over 8 samples
    assert float(out["max"]) == 1.0 and float(out["min"]) == 0.0


@pytest.mark.parametrize("wrap", ["sliced", "windowed"])
def test_sliced_and_windowed_refuse_wrapper_and_composition_templates(wrap):
    def build(metric):
        return tm.SlicedMetric(metric, 4) if wrap == "sliced" else tm.WindowedMetric(metric, window=2)

    composition = tm.MeanSquaredError(device="cpu") * 2
    assert not composition.__jit_unsafe__
    with pytest.raises(MetricsUserError, match="is a wrapper metric"):
        build(composition)
    for wrapper in (tm.MinMaxMetric(tm.MeanSquaredError(device="cpu")), tm.BootStrapper(tm.MeanSquaredError(device="cpu"))):
        with pytest.raises(MetricsUserError, match="__jit_unsafe__"):
            build(wrapper)
    jax_wrap = metrics_tpu.SlicedMetric if wrap == "sliced" else metrics_tpu.WindowedMetric
    with pytest.raises(Exception, match="is a wrapper metric"):
        jax_wrap(metrics_tpu.MeanSquaredError() * 2, 4) if wrap == "sliced" else jax_wrap(metrics_tpu.MeanSquaredError() * 2, window=2)


def test_sliced_template_is_no_child_and_still_fuses():
    sliced = tm.SlicedMetric(tm.MeanSquaredError(device="cpu"), 5)
    windowed = tm.WindowedMetric(tm.SlicedMetric(tm.MeanSquaredError(device="cpu"), 5), window=2)
    assert not sliced._children and not windowed._children
    assert "_template" not in sliced.state_footprint() and all(k.startswith("sliced/") for k in sliced.state_footprint())
    rng = np.random.RandomState(9)
    batches = [(rng.randint(0, 5, 16), rng.rand(16).astype(np.float32), rng.rand(16).astype(np.float32)) for _ in range(3)]
    eager = tm.MetricCollection({"s": tm.SlicedMetric(tm.MeanSquaredError(device="cpu"), 5)})
    fused = tm.MetricCollection({"s": tm.SlicedMetric(tm.MeanSquaredError(device="cpu"), 5)})
    handle = fused.compile_update()
    for b in batches:
        eager.update(*_t(*b))
        fused.update(*_t(*b))
    assert not handle._eager_names and not handle.declined
    for key in eager["s"]._defaults:
        assert torch.equal(getattr(eager["s"], key), getattr(fused["s"], key))


def test_wrappers_take_the_eager_leg_and_are_named_in_declined():
    members = {"acc": tm.Accuracy(num_classes=4, device="cpu"), **_wrappers(tm, device="cpu")}
    collection = tm.MetricCollection(members)
    reference = tm.MetricCollection(_wrappers(tm, device="cpu"))
    handle = collection.compile_update()
    for preds, target in LABELS:
        collection.update(*_t(preds, target))
        reference.update(*_t(preds, target))
    assert set(handle.declined) == {"bootstrap", "classwise", "minmax", "composition"}
    assert "acc" not in handle._eager_names
    for name in reference:
        got, want = collection[name].compute(), reference[name].compute()
        for key in (want if isinstance(want, dict) else {"v": want}):
            a = got[key] if isinstance(got, dict) else got
            b = want[key] if isinstance(want, dict) else want
            assert torch.equal(a, b)
    groups = collection.compute_groups
    assert all(len(g) == 1 for g in groups.values() if set(g) & set(_wrappers(tm, device="cpu")))


# ---------------------------------------------------------------------------
# the carry of convert.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["bootstrap", "classwise", "minmax", "composition", "cat", "mean"])
def test_carry_from_jax_continues_an_epoch_bit_equal(name):
    def make(pkg, **kw):
        if name == "cat":
            return pkg.CatMetric(**kw)
        if name == "mean":
            return pkg.MeanMetric(**kw)
        return _wrappers(pkg, **kw)[name]

    float_input = name in ("cat", "mean")
    data = [(FLOATS[i][0],) for i in range(3)] if float_input else LABELS
    jw, tw, reference = make(metrics_tpu), make(tm, device="cpu"), make(metrics_tpu)
    for args in data[:2]:
        jw.update(*_j(*args))
        reference.update(*_j(*args))
    if name == "minmax":
        jw.compute()
        reference.compute()
    carry_from_jax(jw, tw)
    assert tw._update_called
    reference.update(*_j(*data[2]))
    tw.update(*_t(*data[2]))
    want, got = reference.compute(), tw.compute()
    for key in (want if isinstance(want, dict) else {"v": want}):
        a = got[key] if isinstance(got, dict) else got
        b = want[key] if isinstance(want, dict) else want
        if name in ("mean", "bootstrap"):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
        else:
            _bits_equal(a, b)
    if name == "bootstrap":
        _child_states_equal(tw, reference)
    with pytest.raises(ValueError, match="child metrics"):
        carry_from_jax(metrics_tpu.MinMaxMetric(metrics_tpu.Accuracy()), tm.ClasswiseWrapper(tm.Accuracy(device="cpu")))
