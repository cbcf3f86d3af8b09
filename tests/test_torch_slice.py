"""The flagship slice as a whole, JAX package against the port, on the CPU.

The epoch runs as ``bench.py``'s ``bench_tpu`` runs it (ConfusionMatrix
through the pure-state API plus the exact rank AUROC per step, over
pre-stacked independent batches), at C=16, B=64 and 5 steps. Around it:
MetricCollection compute groups, ``merge_states``, the Metric base's mean
counter, and the carry-over of a JAX state into the port.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metrics_tpu import AUROC as JaxAUROC
from metrics_tpu.classification import ConfusionMatrix as JaxConfusionMatrix
from metrics_tpu.collections import MetricCollection as JaxMetricCollection
from metrics_tpu.core.metric import Metric as JaxMetric
from metrics_tpu.functional.classification.auroc import auroc_rank_multiclass as jax_auroc
from metrics_tpu_torch import AUROC, ConfusionMatrix, Metric, MetricCollection
from metrics_tpu_torch.convert import state_from_jax
from metrics_tpu_torch.functional import auroc_rank_multiclass
from metrics_tpu_torch.utils.exceptions import MetricsUserError

torch.set_num_threads(2)

C, B, STEPS = 16, 64, 5


def _data(seed=42, steps=STEPS):
    """bench.py's fixture at a small size: softmax rows, integer labels."""
    rng = np.random.RandomState(seed)
    logits = rng.rand(steps, B, C).astype(np.float32) * 4
    preds = np.exp(logits - logits.max(axis=-1, keepdims=True))
    preds /= preds.sum(axis=-1, keepdims=True)
    target = rng.randint(0, C, size=(steps, B)).astype(np.int64)
    return preds.astype(np.float32), target


def test_flagship_epoch_matches_jax():
    preds, target = _data()
    jax_confmat = JaxConfusionMatrix(num_classes=C)

    @jax.jit
    def epoch(state, preds_all, target_all):
        def step(state, xs):
            p, t = xs
            return jax_confmat.update_state(state, p, t), jax_auroc(p, t, C, average="macro")

        state, aucs = jax.lax.scan(step, state, (preds_all, target_all))
        return state, aucs

    want_state, want_aucs = epoch(jax_confmat.init_state(), jnp.asarray(preds), jnp.asarray(target, jnp.int32))

    confmat = ConfusionMatrix(num_classes=C, device="cpu")
    state, aucs = confmat.init_state(), []
    for i in range(STEPS):
        p, t = torch.from_numpy(preds[i]), torch.from_numpy(target[i])
        state = confmat.update_state(state, p, t)
        aucs.append(auroc_rank_multiclass(p, t, C, average="macro"))

    assert state["confmat"].dtype == torch.int32
    np.testing.assert_array_equal(state["confmat"].numpy(), np.asarray(want_state["confmat"]))
    np.testing.assert_allclose(torch.stack(aucs).numpy(), np.asarray(want_aucs), rtol=0, atol=1e-6)
    assert int(state["confmat"].sum()) == STEPS * B


def test_collection_compute_groups_match_jax():
    preds, target = _data(seed=1)

    def members(pkg_confmat, pkg_auroc, **kw):
        return {
            "cm": pkg_confmat(num_classes=C, **kw),
            "cm_again": pkg_confmat(num_classes=C, **kw),
            "cm_norm": pkg_confmat(num_classes=C, normalize="true", **kw),
            "auroc": pkg_auroc(num_classes=C, capacity=STEPS * B, **kw),
        }

    want = JaxMetricCollection(members(JaxConfusionMatrix, JaxAUROC), prefix="val_")
    got = MetricCollection(members(ConfusionMatrix, AUROC, device="cpu"), prefix="val_")
    for i in range(STEPS):
        want.update(jnp.asarray(preds[i]), jnp.asarray(target[i]))
        got.update(torch.from_numpy(preds[i]), torch.from_numpy(target[i]))
    assert got.compute_groups == want.compute_groups
    # equal states and equal hyperparameters share a group; `normalize` differs
    assert ["cm", "cm_again"] in got.compute_groups.values()
    want_values, got_values = want.compute(), got.compute()
    assert sorted(got_values) == sorted(want_values) == ["val_auroc", "val_cm", "val_cm_again", "val_cm_norm"]
    for key in ("val_cm", "val_cm_again", "val_cm_norm"):
        np.testing.assert_array_equal(got_values[key].numpy(), np.asarray(want_values[key]))
    np.testing.assert_allclose(float(got_values["val_auroc"]), float(want_values["val_auroc"]), atol=1e-6)

    clone = got.clone(prefix="test_")
    assert list(clone.keys()) == ["test_auroc", "test_cm", "test_cm_again", "test_cm_norm"]
    restored = MetricCollection(members(ConfusionMatrix, AUROC, device="cpu"))
    restored.load_state_dict(got.state_dict())
    with pytest.warns(UserWarning, match="before"):  # restored, never updated
        restored_values = restored.compute()
    np.testing.assert_array_equal(restored_values["cm"].numpy(), got_values["val_cm"].numpy())
    got.reset()
    assert int(got["cm"].confmat.sum()) == 0
    # the fused update (its plain version on the CPU) after the reset
    handle = got.compile_update()
    got.update(torch.from_numpy(preds[0]), torch.from_numpy(target[0]))
    want.reset()
    want.update(jnp.asarray(preds[0]), jnp.asarray(target[0]))
    assert got.fused_update is handle and handle.cache_size == 1
    np.testing.assert_array_equal(got["cm"].confmat.numpy(), np.asarray(want["cm"].confmat))


def test_forward_returns_the_batch_value():
    preds, target = _data(seed=2)
    want, got = JaxMetricCollection([JaxConfusionMatrix(num_classes=C)]), MetricCollection([ConfusionMatrix(num_classes=C, device="cpu")])
    for i in range(2):
        batch_want = want(jnp.asarray(preds[i]), jnp.asarray(target[i]))
        batch_got = got(torch.from_numpy(preds[i]), torch.from_numpy(target[i]))
        np.testing.assert_array_equal(batch_got["ConfusionMatrix"].numpy(), np.asarray(batch_want["ConfusionMatrix"]))
    np.testing.assert_array_equal(got.compute()["ConfusionMatrix"].numpy(), np.asarray(want.compute()["ConfusionMatrix"]))


@pytest.mark.parametrize("which", ["confmat", "auroc"])
def test_merge_states_matches_jax(which):
    preds, target = _data(seed=3)
    if which == "confmat":
        jax_metric, metric = JaxConfusionMatrix(num_classes=C), ConfusionMatrix(num_classes=C, device="cpu")
    else:
        jax_metric = JaxAUROC(num_classes=C, capacity=2 * B, average="none")
        metric = AUROC(num_classes=C, capacity=2 * B, average="none", device="cpu")
    ja = jax_metric.update_state(jax_metric.init_state(), jnp.asarray(preds[0]), jnp.asarray(target[0]))
    jb = jax_metric.update_state(jax_metric.init_state(), jnp.asarray(preds[1]), jnp.asarray(target[1]))
    a = metric.update_state(metric.init_state(), torch.from_numpy(preds[0]), torch.from_numpy(target[0]))
    b = metric.update_state(metric.init_state(), torch.from_numpy(preds[1]), torch.from_numpy(target[1]))
    jm, m = jax_metric.merge_states(ja, jb), metric.merge_states(a, b)
    assert sorted(m) == sorted(jm)
    if which == "confmat":
        np.testing.assert_array_equal(m["confmat"].numpy(), np.asarray(jm["confmat"]))
    else:  # cat states merge to lists of the two sides' buffers
        assert len(m["preds"]) == 2
        np.testing.assert_array_equal(torch.cat(m["valid"]).numpy(), np.asarray(jnp.concatenate(jm["valid"])))


def test_state_from_jax_carry_over():
    """Three batches in JAX, the state carried over, then two more batches
    in both packages: the same counts and the same AUROC."""
    preds, target = _data(seed=4)
    for jax_metric, metric in (
        (JaxConfusionMatrix(num_classes=C), ConfusionMatrix(num_classes=C, device="cpu")),
        (JaxAUROC(num_classes=C, capacity=STEPS * B), AUROC(num_classes=C, capacity=STEPS * B, device="cpu")),
    ):
        jax_state = jax_metric.init_state()
        for i in range(3):
            jax_state = jax_metric.update_state(jax_state, jnp.asarray(preds[i]), jnp.asarray(target[i]))
        state = state_from_jax({k: np.asarray(v) for k, v in jax_state.items()}, metric)
        assert {k: v.dtype for k, v in state.items()} == {k: v.dtype for k, v in metric.init_state().items()}
        for i in range(3, STEPS):
            jax_state = jax_metric.update_state(jax_state, jnp.asarray(preds[i]), jnp.asarray(target[i]))
            state = metric.update_state(state, torch.from_numpy(preds[i]), torch.from_numpy(target[i]))
        want, got = np.asarray(jax_metric.compute_state(jax_state)), metric.compute_state(state).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 if got.dtype == np.float32 else 0)


def test_state_from_jax_rejects_mismatches():
    metric = ConfusionMatrix(num_classes=C, device="cpu")
    with pytest.raises(ValueError, match="do not match"):
        state_from_jax({"cm": np.zeros((C, C), np.int32)}, metric)
    with pytest.raises(ValueError, match="expected"):
        state_from_jax({"confmat": np.zeros((C, C), np.int64)}, metric)
    with pytest.raises(ValueError, match="expected"):
        state_from_jax({"confmat": np.zeros((C + 1, C), np.int32)}, metric)


class _JaxRunningMean(JaxMetric):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("mean", default=jnp.asarray(0.0), dist_reduce_fx="mean")
        self.add_state("peak", default=jnp.asarray(-jnp.inf), dist_reduce_fx="max")

    def _update(self, x):
        self.mean = jnp.mean(jnp.asarray(x))
        self.peak = jnp.maximum(self.peak, jnp.max(jnp.asarray(x)))

    def _compute(self):
        return self.mean


class _RunningMean(Metric):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("mean", default=0.0, dist_reduce_fx="mean")
        self.add_state("peak", default=float("-inf"), dist_reduce_fx="max")

    def _update(self, x):
        self.mean = torch.mean(x)
        self.peak = torch.maximum(self.peak, x.max())

    def _compute(self):
        return self.mean


def test_mean_state_counter_and_weighted_merge_match_jax():
    rng = np.random.RandomState(5)
    xs = [rng.rand(7).astype(np.float32) for _ in range(5)]
    jax_metric, metric = _JaxRunningMean(), _RunningMean(device="cpu")
    ja, a = jax_metric.init_state(), metric.init_state()
    assert sorted(a) == sorted(ja) == ["_n_updates", "mean", "peak"]
    assert a["_n_updates"].dtype == torch.int32 and a["mean"].dtype == torch.float32
    for x in xs[:3]:
        ja, a = jax_metric.update_state(ja, jnp.asarray(x)), metric.update_state(a, torch.from_numpy(x))
    jb, b = jax_metric.update_state(jax_metric.init_state(), jnp.asarray(xs[3])), metric.update_state(
        metric.init_state(), torch.from_numpy(xs[3])
    )
    jm, m = jax_metric.merge_states(ja, jb), metric.merge_states(a, b)
    for key in ("_n_updates", "mean", "peak"):
        np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]), rtol=1e-6)
    assert int(m["_n_updates"]) == 4

    # a checkpoint without the counter restores it as "history unknown"
    metric.load_state_dict({"mean": torch.tensor(0.5), "peak": torch.tensor(1.0)})
    jax_metric.load_state_dict({"mean": jnp.asarray(0.5), "peak": jnp.asarray(1.0)})
    assert int(metric._n_updates) == int(jax_metric._n_updates) == -1
    metric.update(torch.from_numpy(xs[4]))
    assert metric._n_updates == -1
    assert metric.state_dict()["_n_updates"].dtype == torch.int32


def test_metric_lifecycle_errors():
    with pytest.raises(ValueError, match="empty list"):
        _RunningMean(device="cpu").add_state("bad", default=[1])
    with pytest.raises(ValueError, match="dist_reduce_fx"):
        _RunningMean(device="cpu").add_state("bad", default=0, dist_reduce_fx="median")
    for reducer in ("ring", "decay"):
        windowed = _RunningMean(device="cpu")
        windowed.add_state("window", default=torch.zeros(4), dist_reduce_fx=reducer)
        red = windowed._reductions["window"]
        assert (red.windowed_kind, red.inner_reduce) == (reducer, "sum")
    sketched = _RunningMean(device="cpu")
    sketched.add_state("sketch", default=torch.zeros((8, 2)), dist_reduce_fx="merge")
    assert getattr(sketched._reductions["sketch"], "merge_like", False)
    with pytest.raises(MetricsUserError, match="reduction None"):
        metric = _RunningMean(device="cpu")
        metric.add_state("gathered", default=0.0, dist_reduce_fx=None)
        state = metric.init_state()
        metric.merge_states(state, state)


def test_compute_is_cached_until_the_next_write():
    preds, target = _data(seed=6)
    metric = ConfusionMatrix(num_classes=C, device="cpu")
    with pytest.warns(UserWarning, match="before"):
        metric.compute()
    metric.update(torch.from_numpy(preds[0]), torch.from_numpy(target[0]))
    first = metric.compute()
    assert metric.compute() is first
    metric.update(torch.from_numpy(preds[1]), torch.from_numpy(target[1]))
    assert metric.compute() is not first and int(metric.compute().sum()) == 2 * B
