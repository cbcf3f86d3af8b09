"""The aggregators: the port against the JAX package.

``MaxMetric``, ``MinMetric``, ``SumMetric``, ``CatMetric`` and
``MeanMetric`` over the same seeded numpy streams in both packages, under
every ``nan_strategy`` (``"error"``, ``"warn"``, ``"ignore"``, a float),
with and without NaNs. Max, min and concatenation are held bit for bit
(state and value); sums and means within rtol 1e-6 (float32 sums in the
two libraries' orders). Also: the zero-valued update, ``MeanMetric``'s
joint value/weight filtering, ``merge_states``, the capture-rule branch
(``compile_update`` on the CPU, the probe and the fused function, against
``jax.jit(m.update_state)``), and signed zeros and NaN in max and min.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.aggregation as jagg
import metrics_tpu_torch.aggregation as tagg
from metrics_tpu_torch import MetricCollection
from metrics_tpu_torch.utils.checks import capturing_checks

torch.set_num_threads(2)

CLASSES = ["MaxMetric", "MinMetric", "SumMetric", "CatMetric", "MeanMetric"]
STRATEGIES = ["error", "warn", "ignore", 2.0]
EXACT = {"MaxMetric", "MinMetric", "CatMetric"}

_rng = np.random.RandomState(11)
CLEAN = [(_rng.randn(4, 6) * 3).astype(np.float32) for _ in range(3)]
WITH_NAN = [x.copy() for x in CLEAN]
WITH_NAN[1][0, 2] = np.nan
WITH_NAN[2][3, :] = np.nan
WEIGHTS = [(_rng.rand(4, 6) + 0.5).astype(np.float32) for _ in range(3)]


def _pair(name, **kw):
    return getattr(jagg, name)(**kw), getattr(tagg, name)(device="cpu", **kw)


def _assert_same(name, got, want):
    got = np.asarray(got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, got.dtype, want.shape, want.dtype)
    if name in EXACT:
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _states(metric):
    return {k: getattr(metric, k) for k in metric._defaults}


def _feed(j, t, stream, weighted=False):
    for i, x in enumerate(stream):
        if weighted:
            j.update(jnp.asarray(x), weight=jnp.asarray(WEIGHTS[i]))
            t.update(torch.from_numpy(x), weight=torch.from_numpy(WEIGHTS[i]))
        else:
            j.update(jnp.asarray(x))
            t.update(torch.from_numpy(x))


@pytest.mark.parametrize("strategy", STRATEGIES, ids=str)
@pytest.mark.parametrize("name", CLASSES)
@pytest.mark.parametrize("stream", ["clean", "nan"])
def test_aggregator_matches_jax(name, strategy, stream):
    data = CLEAN if stream == "clean" else WITH_NAN
    j, t = _pair(name, nan_strategy=strategy)
    if stream == "nan" and strategy == "error":
        with pytest.raises(RuntimeError, match="nan"):
            _feed(j, t, data[1:2])
        with pytest.raises(RuntimeError, match="nan"):
            t.update(torch.from_numpy(data[1]))
        return
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _feed(j, t, data)
    warned = [w for w in caught if "nan" in str(w.message)]
    if stream == "nan" and strategy == "warn":
        assert len(warned) == 4  # two NaN updates, each package warns once
    for key, value in _states(t).items():
        jv = getattr(j, key)
        if isinstance(value, list):
            assert len(value) == len(jv)
            for a, b in zip(value, jv):
                _assert_same(name, a, b)
        else:
            _assert_same(name, value, jv)
    if name == "CatMetric" and stream == "nan" and strategy in ("warn", "ignore"):
        # a removal flattens a 2-D update: neither package concatenates it
        # with the 2-D ones
        with pytest.raises(TypeError, match="concatenate"):
            j.compute()
        with pytest.raises(RuntimeError, match="same number of dimensions"):
            t.compute()
        return
    _assert_same(name, t.compute(), j.compute())


def test_zero_valued_update_is_not_skipped():
    for name, value in (("MaxMetric", 0.0), ("SumMetric", np.zeros(3, np.float32)), ("MinMetric", 0.0)):
        j, t = _pair(name)
        j.update(jnp.asarray(value))
        t.update(torch.as_tensor(value))
        _assert_same(name, t.compute(), j.compute())
        assert float(t.compute()) == 0.0
    j, t = _pair("CatMetric")
    j.update(0.0)
    t.update(0.0)
    _assert_same("CatMetric", t.compute(), j.compute())


@pytest.mark.parametrize("strategy", ["ignore", "warn", 0.5])
def test_mean_metric_filters_value_and_weight_jointly(strategy):
    value = np.array([1.0, np.nan, 3.0, 4.0, 5.0], np.float32)
    weight = np.array([1.0, 5.0, 2.0, np.nan, 2.0], np.float32)
    j, t = _pair("MeanMetric", nan_strategy=strategy)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j.update(jnp.asarray(value), weight=jnp.asarray(weight))
        t.update(torch.from_numpy(value), weight=torch.from_numpy(weight))
    _assert_same("MeanMetric", t.value, j.value)
    _assert_same("MeanMetric", t.weight, j.weight)
    _assert_same("MeanMetric", t.compute(), j.compute())
    if strategy != 0.5:
        assert float(t.compute()) == pytest.approx((1 * 1 + 3 * 2 + 5 * 2) / (1 + 2 + 2))


def test_mean_metric_weighted_stream_and_scalars():
    j, t = _pair("MeanMetric")
    _feed(j, t, CLEAN, weighted=True)
    j.update(4.0, weight=2.0)
    t.update(4.0, weight=2.0)
    _assert_same("MeanMetric", t.compute(), j.compute())


@pytest.mark.parametrize("name", CLASSES)
def test_merge_states_matches_jax(name):
    j, t = _pair(name)
    ja, jb = j.init_state(), j.init_state()
    ta, tb = t.init_state(), t.init_state()
    for x in CLEAN[:2]:
        ja = j.update_state(ja, jnp.asarray(x))
        ta = t.update_state(ta, torch.from_numpy(x))
    jb = j.update_state(jb, jnp.asarray(CLEAN[2]))
    tb = t.update_state(tb, torch.from_numpy(CLEAN[2]))
    _assert_same(name, t.compute_state(t.merge_states(ta, tb)), j.compute_state(j.merge_states(ja, jb)))


@pytest.mark.parametrize("strategy", STRATEGIES, ids=str)
@pytest.mark.parametrize("name", ["MaxMetric", "MinMetric", "SumMetric", "MeanMetric"])
def test_capture_branch_matches_jax_jit(name, strategy):
    """compile_update on the CPU runs the probe and the fused function
    under the capture rule: the traced branch, as ``jax.jit`` takes it."""
    j, _ = _pair(name, nan_strategy=strategy)
    jstate = j.init_state()
    update = jax.jit(j.update_state)
    collection = MetricCollection({"m": getattr(tagg, name)(nan_strategy=strategy, device="cpu")})
    handle = collection.compile_update()
    for x in WITH_NAN:
        jstate = update(jstate, jnp.asarray(x))
        collection.update(torch.from_numpy(x))
    assert not handle._eager_names and not handle.declined
    t = collection["m"]
    for key in t._defaults:
        _assert_same(name, getattr(t, key), jstate[key])
    _assert_same(name, t.compute(), j.compute_state(jstate))


@pytest.mark.parametrize("strategy", ["warn", 2.0])
def test_cat_metric_capture_branch_matches_jax_jit(strategy):
    """CatMetric has no identity: under the capture rule a string strategy
    passes NaNs through, as the JAX package's traced branch does."""
    j, t = _pair("CatMetric", nan_strategy=strategy)
    jstate = jax.jit(j.update_state)(j.init_state(), jnp.asarray(WITH_NAN[2]))
    with capturing_checks():
        tstate = t.update_state(t.init_state(), torch.from_numpy(WITH_NAN[2]))
    assert len(tstate["value"]) == len(jstate["value"]) == 1
    np.testing.assert_array_equal(tstate["value"][0].numpy(), np.asarray(jstate["value"][0]))


@pytest.mark.parametrize("name", ["MaxMetric", "MinMetric"])
def test_signed_zeros_and_nan_fold_as_jax(name):
    """+0.0 over -0.0 for max and -0.0 for min in either order; a NaN that
    reaches the fold (the float strategy imputes NaN itself) wins."""
    for stream in ([-0.0, 0.0], [0.0, -0.0], [np.array([0.0, -0.0], np.float32)], [np.array([-0.0, 0.0], np.float32)]):
        j, t = _pair(name)
        for x in stream:
            j.update(jnp.asarray(x, jnp.float32))
            t.update(torch.as_tensor(np.asarray(x, np.float32)))
        _assert_same(name, t.compute(), j.compute())
    j, t = _pair(name, nan_strategy=float("nan"))
    for x in (np.array([1.0, np.nan], np.float32), np.array([2.0], np.float32)):
        j.update(jnp.asarray(x))
        t.update(torch.from_numpy(x))
    assert np.isnan(float(t.compute())) and np.isnan(float(j.compute()))


def test_invalid_strategy_and_reset():
    for name in CLASSES:
        with pytest.raises(ValueError, match="nan_strategy"):
            getattr(tagg, name)(nan_strategy="invalid", device="cpu")
        with pytest.raises(ValueError, match="nan_strategy"):
            getattr(tagg, name)(nan_strategy=2, device="cpu")
    t = tagg.SumMetric(device="cpu")
    t.update(5.0)
    t.reset()
    t.update(2.0)
    assert float(t.compute()) == 2.0
    assert tagg.CatMetric(device="cpu").compute().shape == (0,)
