"""The regression family: the port against the JAX package.

Every functional and class of ``metrics_tpu/regression`` and
``metrics_tpu/functional/regression`` (MSE, MAE, MAPE, SMAPE, MSLE, the
Tweedie deviance at powers 0, 1, 1.5, 2, 3 and -1, cosine similarity in its
streaming and list modes, explained variance and R² over one and two
outputs in the three multioutput modes and adjusted, Pearson, and Spearman
in its rank-sketch default and ``exact=True``) on the same seeded numpy
inputs (the shapes of the JAX package's own regression tests: 4 batches of
32, so both sides compile once per shape). Values, states, ``forward``,
``reset``, the pure-state API, ``merge_states`` and ``state_from_jax`` are
held within rtol 1e-5 / atol 1e-6 (float32 sums in the two libraries'
orders: the port's fixed-order tree against ``jnp.sum``); integer counts,
state dtypes and shapes exactly. Plain torch: no kernel is involved.
"""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import metrics_tpu
import metrics_tpu.functional as jax_functional
import metrics_tpu_torch
import metrics_tpu_torch.functional as torch_functional
from metrics_tpu_torch.convert import state_from_jax
from metrics_tpu_torch.utils.checks import capturing_checks

torch.set_num_threads(2)

BATCHES, BATCH = 4, 32
RTOL, ATOL = 1e-5, 1e-6

_rng = np.random.RandomState(42)
_POS = (_rng.rand(BATCHES, BATCH).astype(np.float32) + 0.1, _rng.rand(BATCHES, BATCH).astype(np.float32) + 0.1)
_CORR = (_rng.rand(BATCHES, BATCH).astype(np.float32),)
_CORR = (_CORR[0], (_rng.rand(BATCHES, BATCH) + 0.3 * _CORR[0]).astype(np.float32))
_TIES = (_rng.randint(0, 10, (BATCHES, BATCH)).astype(np.float32), _rng.randint(0, 10, (BATCHES, BATCH)).astype(np.float32))
_COS = (_rng.rand(BATCHES, BATCH, 4).astype(np.float32), _rng.rand(BATCHES, BATCH, 4).astype(np.float32))
_SIGNED = ((_rng.randn(BATCHES, BATCH) * 2).astype(np.float32), (_rng.randn(BATCHES, BATCH) * 2).astype(np.float32))
_MULTI = (_rng.rand(BATCHES, BATCH, 2).astype(np.float32), (_rng.rand(BATCHES, BATCH, 2) * 2).astype(np.float32))

INPUTS = {"pos": _POS, "corr": _CORR, "ties": _TIES, "cos": _COS, "signed": _SIGNED, "multi": _MULTI}

# (class name, functional name, kwargs of the class, kwargs of the functional, inputs)
CASES = [
    ("MeanSquaredError", "mean_squared_error", {}, {}, "signed"),
    ("MeanSquaredError", "mean_squared_error", {"squared": False}, {"squared": False}, "signed"),
    ("MeanAbsoluteError", "mean_absolute_error", {}, {}, "signed"),
    ("MeanAbsolutePercentageError", "mean_absolute_percentage_error", {}, {}, "signed"),
    ("SymmetricMeanAbsolutePercentageError", "symmetric_mean_absolute_percentage_error", {}, {}, "signed"),
    ("MeanSquaredLogError", "mean_squared_log_error", {}, {}, "pos"),
    ("TweedieDevianceScore", "tweedie_deviance_score", {"power": 0}, {"power": 0}, "signed"),
    ("TweedieDevianceScore", "tweedie_deviance_score", {"power": 1}, {"power": 1}, "pos"),
    ("TweedieDevianceScore", "tweedie_deviance_score", {"power": 1.5}, {"power": 1.5}, "pos"),
    ("TweedieDevianceScore", "tweedie_deviance_score", {"power": 2}, {"power": 2}, "pos"),
    ("TweedieDevianceScore", "tweedie_deviance_score", {"power": 3}, {"power": 3}, "pos"),
    ("TweedieDevianceScore", "tweedie_deviance_score", {"power": -1}, {"power": -1}, "pos"),
    ("CosineSimilarity", "cosine_similarity", {}, {}, "cos"),
    ("CosineSimilarity", "cosine_similarity", {"reduction": "mean"}, {"reduction": "mean"}, "cos"),
    ("CosineSimilarity", "cosine_similarity", {"reduction": "none"}, {"reduction": "none"}, "cos"),
    ("CosineSimilarity", "cosine_similarity", {"reduction": "mean", "exact": True}, {"reduction": "mean"}, "cos"),
    ("ExplainedVariance", "explained_variance", {}, {}, "signed"),
    ("ExplainedVariance", "explained_variance", {"multioutput": "raw_values"}, {"multioutput": "raw_values"}, "multi"),
    ("ExplainedVariance", "explained_variance", {"multioutput": "variance_weighted"}, {"multioutput": "variance_weighted"}, "multi"),
    ("ExplainedVariance", "explained_variance", {}, {}, "multi"),
    ("R2Score", "r2_score", {}, {}, "signed"),
    ("R2Score", "r2_score", {"adjusted": 3}, {"adjusted": 3}, "signed"),
    ("R2Score", "r2_score", {"num_outputs": 2, "multioutput": "raw_values"}, {"multioutput": "raw_values"}, "multi"),
    ("R2Score", "r2_score", {"num_outputs": 2, "multioutput": "variance_weighted"}, {"multioutput": "variance_weighted"}, "multi"),
    ("R2Score", "r2_score", {"num_outputs": 2}, {}, "multi"),
    ("PearsonCorrCoef", "pearson_corrcoef", {}, {}, "corr"),
    ("SpearmanCorrCoef", "spearman_corrcoef", {}, {}, "corr"),
    ("SpearmanCorrCoef", "spearman_corrcoef", {}, {}, "ties"),
    ("SpearmanCorrCoef", "spearman_corrcoef", {"exact": True}, {}, "ties"),
]
IDS = [f"{c}-{i}-{'-'.join(f'{k}={v}' for k, v in kw.items()) or 'default'}" for c, _, kw, _, i in CASES]


def assert_priorities_close(got, want):
    """Gumbel priorities within 2 ulp of ``max(|want|, 1)``; empty slots
    (-inf) in the same places."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    empty = np.isneginf(want)
    np.testing.assert_array_equal(np.isneginf(got), empty)
    ulp = np.spacing(np.maximum(np.abs(want[~empty]), np.float32(1)))
    assert np.all(np.abs(got[~empty].astype(np.float64) - want[~empty]) <= 2 * ulp)


def _close(got, want, what=""):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def _pair(cls_name, kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the exact modes' memory warning
        return getattr(metrics_tpu, cls_name)(**kwargs), getattr(metrics_tpu_torch, cls_name)(device="cpu", **kwargs)


def _batch(inputs, i):
    preds, target = INPUTS[inputs]
    return (jnp.asarray(preds[i]), jnp.asarray(target[i])), (torch.from_numpy(preds[i]), torch.from_numpy(target[i]))


def _jax_states(metric):
    return {k: ([np.asarray(x) for x in v] if isinstance(v, list) else np.asarray(v)) for k, v in metric.state_dict().items()}


def _assert_states_close(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        if isinstance(w, list):
            assert len(g) == len(w), name
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
            continue
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (name, g.dtype, w.dtype, g.shape, w.shape)
        if name == "rsketch":
            # payload bit for bit; the Gumbel priorities within 2 ulp
            # (tests/test_torch_rank_sketch.py pins the log difference)
            np.testing.assert_array_equal(g[:, 1:], w[:, 1:])
            assert_priorities_close(g[:, 0], w[:, 0])
        elif np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("cls_name, fn_name, kwargs, fkwargs, inputs", CASES, ids=IDS)
def test_functional_matches_jax(cls_name, fn_name, kwargs, fkwargs, inputs):
    for i in range(BATCHES):
        (jp, jt), (tp, tt) = _batch(inputs, i)
        want = getattr(jax_functional, fn_name)(jp, jt, **fkwargs)
        got = getattr(torch_functional, fn_name)(tp, tt, **fkwargs)
        _close(got, want, f"batch {i}")
        assert str(got.dtype).replace("torch.", "") == str(np.asarray(want).dtype)


@pytest.mark.parametrize("cls_name, fn_name, kwargs, fkwargs, inputs", CASES, ids=IDS)
def test_module_matches_jax(cls_name, fn_name, kwargs, fkwargs, inputs):
    """forward's batch values, the accumulated states and value, reset, and
    the pure-state API, against the JAX package and the functional."""
    jax_metric, metric = _pair(cls_name, kwargs)
    for i in range(BATCHES):
        (jp, jt), (tp, tt) = _batch(inputs, i)
        _close(metric(tp, tt), jax_metric(jp, jt), f"forward {i}")
    _assert_states_close(metric.state_dict(), _jax_states(jax_metric))
    value = metric.compute()
    _close(value, jax_metric.compute(), "compute")
    # the functional over the whole stream
    preds, target = INPUTS[inputs]
    flat = torch.from_numpy(preds.reshape((-1,) + preds.shape[2:])), torch.from_numpy(target.reshape((-1,) + target.shape[2:]))
    _close(value, getattr(torch_functional, fn_name)(*flat, **fkwargs), "functional")
    # the pure-state API gives the stateful result
    state = metric.init_state()
    for i in range(BATCHES):
        state = metric.update_state(state, *_batch(inputs, i)[1])
    _close(metric.compute_state(state), value, "pure state")
    metric.reset()
    for name, default in metric._defaults.items():
        current = getattr(metric, name)
        if isinstance(default, list):
            assert current == []
        else:
            assert torch.equal(current, default), name


@pytest.mark.parametrize("cls_name, fn_name, kwargs, fkwargs, inputs", CASES, ids=IDS)
def test_merge_states_and_state_from_jax(cls_name, fn_name, kwargs, fkwargs, inputs):
    """Two halves of the stream merged equal the JAX package's merge, and a
    JAX state carried over computes and keeps updating like the JAX metric."""
    jax_metric, metric = _pair(cls_name, kwargs)
    halves, jax_halves = [], []
    for lo, hi in ((0, 2), (2, BATCHES)):
        s, js = metric.init_state(), jax_metric.init_state()
        for i in range(lo, hi):
            (jp, jt), (tp, tt) = _batch(inputs, i)
            s, js = metric.update_state(s, tp, tt), jax_metric.update_state(js, jp, jt)
        halves.append(s)
        jax_halves.append(js)
    merged, jax_merged = metric.merge_states(*halves), jax_metric.merge_states(*jax_halves)
    _close(metric.compute_state(merged), jax_metric.compute_state(jax_merged), "merged")
    carried = state_from_jax(
        {k: ([np.asarray(x) for x in v] if isinstance(v, list) else np.asarray(v)) for k, v in jax_halves[0].items()},
        metric,
    )
    for i in range(2, BATCHES):
        (jp, jt), (tp, tt) = _batch(inputs, i)
        carried, jax_halves[0] = metric.update_state(carried, tp, tt), jax_metric.update_state(jax_halves[0], jp, jt)
    _close(metric.compute_state(carried), jax_metric.compute_state(jax_halves[0]), "carried")


def test_half_precision_inputs_widen_first():
    """bfloat16 and float16 inputs are widened to float32 before the
    differences: the port's value equals its float32 run on the same
    (rounded) values, and stays within 1e-3 of the JAX package's."""
    preds, target = _SIGNED
    for dtype in (torch.bfloat16, torch.float16):
        tp, tt = torch.from_numpy(preds[0]).to(dtype), torch.from_numpy(target[0]).to(dtype)
        for fn in ("mean_absolute_error", "mean_squared_error", "r2_score", "explained_variance", "pearson_corrcoef"):
            got = getattr(torch_functional, fn)(tp, tt)
            assert got.dtype == torch.float32, fn
            assert torch.equal(got, getattr(torch_functional, fn)(tp.float(), tt.float())), fn
            want = getattr(jax_functional, fn)(jnp.asarray(tp.float().numpy()), jnp.asarray(tt.float().numpy()))
            np.testing.assert_allclose(float(got), float(want), rtol=1e-3, atol=1e-3)


def test_domain_and_shape_errors_match_jax():
    bad = np.array([-1.0, 2.0], np.float32), np.array([1.0, 2.0], np.float32)
    for power in (1, 2, 1.5, 3, -1):
        with pytest.raises(ValueError, match=f"power={power}"):
            jax_functional.tweedie_deviance_score(*(jnp.asarray(x) for x in bad), power=power)
        with pytest.raises(ValueError, match=f"power={power}"):
            torch_functional.tweedie_deviance_score(*(torch.from_numpy(x) for x in bad), power=power)
        # the capture rule: the domain check reads nothing and is skipped
        with capturing_checks():
            torch_functional.tweedie_deviance_score(*(torch.from_numpy(x) for x in bad), power=power)
    with pytest.raises(ValueError, match="not defined for power=0.5"):
        metrics_tpu_torch.TweedieDevianceScore(power=0.5, device="cpu")
    with pytest.raises(ValueError, match="at least two samples"):
        torch_functional.r2_score(torch.tensor([1.0]), torch.tensor([1.0]))
    with capturing_checks():
        torch_functional.r2_score(torch.tensor([1.0]), torch.tensor([1.0]))
    with pytest.raises(ValueError, match="1 dimensional"):
        torch_functional.pearson_corrcoef(torch.ones(4, 2, 2), torch.ones(4, 2, 2))
    with pytest.raises(ValueError, match="1 dimensional"):
        torch_functional.spearman_corrcoef(torch.ones(4, 2, 2), torch.ones(4, 2, 2))
    with pytest.raises(TypeError, match="same data type"):
        torch_functional.spearman_corrcoef(torch.ones(4), torch.ones(4, dtype=torch.float16))
    with pytest.raises(ValueError, match="2D tensors"):
        torch_functional.r2_score(torch.ones(2, 2, 2), torch.ones(2, 2, 2))
    for cls in ("R2Score", "ExplainedVariance"):
        with pytest.raises(ValueError, match="multioutput"):
            getattr(metrics_tpu_torch, cls)(multioutput="invalid", device="cpu")
    with pytest.raises(ValueError, match="reduction"):
        metrics_tpu_torch.CosineSimilarity(reduction="max", device="cpu")


def test_adjusted_r2_fallbacks_warn_like_jax():
    preds, target = (torch.from_numpy(x[0][:4]) for x in _SIGNED)
    for adjusted, match in ((5, "More independent regressions"), (3, "Division by zero")):
        with pytest.warns(UserWarning, match=match):
            got = torch_functional.r2_score(preds, target, adjusted=adjusted)
        with pytest.warns(UserWarning, match=match):
            want = jax_functional.r2_score(jnp.asarray(preds.numpy()), jnp.asarray(target.numpy()), adjusted=adjusted)
        _close(got, want)
    # under the capture rule the fall-back is a select, without a warning
    with capturing_checks(), warnings.catch_warnings():
        warnings.simplefilter("error")
        _close(torch_functional.r2_score(preds, target, adjusted=5), torch_functional.r2_score(preds, target))


def test_regression_collection_fuses():
    """The streaming members fuse on the CPU (the plain version of the
    fused update) and equal the eager members bit for bit; the list modes
    take the eager leg, as in the JAX package."""
    def make():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return metrics_tpu_torch.MetricCollection(
                [
                    metrics_tpu_torch.MeanAbsoluteError(device="cpu"),
                    metrics_tpu_torch.MeanSquaredLogError(device="cpu"),
                    metrics_tpu_torch.TweedieDevianceScore(power=1.5, device="cpu"),
                    metrics_tpu_torch.R2Score(device="cpu"),
                    metrics_tpu_torch.PearsonCorrCoef(device="cpu"),
                    metrics_tpu_torch.SpearmanCorrCoef(device="cpu"),
                    metrics_tpu_torch.CosineSimilarity(reduction="none", device="cpu"),
                ]
            )

    eager, fused = make(), make()
    handle = fused.compile_update()
    preds, target = _POS
    for i in range(BATCHES):
        eager.update(torch.from_numpy(preds[i]), torch.from_numpy(target[i]))
        fused.update(torch.from_numpy(preds[i]), torch.from_numpy(target[i]))
    assert not handle.declined
    assert [name for name in fused if handle._static_unfusible(fused[name])] == ["CosineSimilarity"]
    for name, metric in eager.items():
        for state in metric._defaults:
            got, want = getattr(fused[name], state), getattr(metric, state)
            if isinstance(want, list):
                assert all(torch.equal(a, b) for a, b in zip(got, want))
            else:
                assert torch.equal(torch.as_tensor(got), torch.as_tensor(want)), (name, state)
