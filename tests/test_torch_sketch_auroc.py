"""The port's AUROC modes against the JAX package's, on the CPU.

* The sketched default (``AUROC()``): binary, ``num_classes=5`` one-vs-rest
  and multilabel, fed the same seeded batches as the JAX ``AUROC``. Inside
  the lossless window both compute the exact curve: within 1e-6 (the curve
  sums run in another order). Past it (``sketch_capacity=256``) the sketch
  states are bit-identical, since every compaction is, and the weighted
  AUROC agrees within 1e-5 (its cumulative sums run in another order).
* The binary capacity mode (``AUROC(capacity=N)``): within 1e-6.
* Mode changes, ``merge_states``, compute groups, and an epoch begun in JAX
  and continued in the port through ``state_from_jax``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metrics_tpu.classification import AUROC as JaxAUROC
from metrics_tpu.functional.classification.auroc import auroc as jax_auroc
from metrics_tpu_torch import AUROC, MetricCollection
from metrics_tpu_torch.convert import state_from_jax
from metrics_tpu_torch.functional import auroc
from metrics_tpu_torch.sketches import qsketch_fill

torch.set_num_threads(2)

C = 5
WINDOW, PAST = (3, 50), (20, 50)  # (batches, batch size): 150 rows fit 256, 1000 do not


def _batches(kind, n_batches, batch, seed=0, ties=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        if kind == "binary":
            p = rng.rand(batch).astype(np.float32)
            t = (rng.rand(batch) < 0.3).astype(np.int64)
        elif kind == "multiclass":
            p = rng.rand(batch, C).astype(np.float32)
            p /= p.sum(1, keepdims=True)
            t = rng.randint(0, C, batch)
        else:
            p = rng.rand(batch, C).astype(np.float32)
            t = (rng.rand(batch, C) < 0.4).astype(np.int64)
        if ties:
            p = (np.round(p * 8) / 8).astype(np.float32)
        out.append((p, t))
    return out


def _pair(batches, **kwargs):
    want, got = JaxAUROC(**kwargs), AUROC(device="cpu", **kwargs)
    for p, t in batches:
        want.update(jnp.asarray(p), jnp.asarray(t))
        got.update(torch.from_numpy(p), torch.from_numpy(t))
    return want, got


CONFIGS = [
    ("binary", {}),
    ("binary", {"max_fpr": 0.3}),
    ("binary", {"pos_label": 0}),
    ("multiclass", {"num_classes": C}),
    ("multiclass", {"num_classes": C, "average": "weighted"}),
    ("multiclass", {"num_classes": C, "average": None}),
    ("multilabel", {"num_classes": C, "average": "micro"}),
    ("multilabel", {"num_classes": C, "average": "macro"}),
]


@pytest.mark.parametrize("kind,kwargs", CONFIGS)
@pytest.mark.parametrize("ties", [False, True])
def test_sketched_default_inside_the_window(kind, kwargs, ties):
    want, got = _pair(_batches(kind, *WINDOW, ties=ties), sketch_capacity=256, **kwargs)
    assert int(qsketch_fill(got.csketch)) == WINDOW[0] * WINDOW[1]  # nothing compacted
    np.testing.assert_array_equal(got.csketch.numpy(), np.asarray(want.csketch))
    np.testing.assert_allclose(got.compute().numpy(), np.asarray(want.compute()), atol=1e-6)


@pytest.mark.parametrize("kind,kwargs", CONFIGS)
@pytest.mark.parametrize("ties", [False, True])
def test_sketched_default_past_the_window(kind, kwargs, ties):
    want, got = _pair(_batches(kind, *PAST, seed=1, ties=ties), sketch_capacity=256, **kwargs)
    assert int(got.n_seen) == PAST[0] * PAST[1] > int(qsketch_fill(got.csketch))  # compacted
    np.testing.assert_array_equal(got.csketch.numpy(), np.asarray(want.csketch))
    np.testing.assert_allclose(got.compute().numpy(), np.asarray(want.compute()), atol=1e-5)


def test_default_capacity_and_state_layouts():
    binary, multiclass = AUROC(device="cpu"), AUROC(num_classes=C, device="cpu")
    assert binary.csketch.shape == (8192, 3) and multiclass.csketch.shape == (8192, 2 + 2 * C)
    assert binary.csketch.dtype == torch.float32 and binary.n_seen.dtype == torch.int32


def test_shape_stable_reads_take_the_weighted_kernels():
    want, got = _pair(_batches("binary", *WINDOW), sketch_capacity=256, shape_stable_reads=True)
    np.testing.assert_allclose(float(got.compute()), float(want.compute()), atol=1e-6)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("pos_label", [None, 1])
def test_binary_capacity_mode(ties, pos_label):
    want, got = _pair(_batches("binary", 4, 25, seed=2, ties=ties), capacity=128, pos_label=pos_label)
    np.testing.assert_allclose(float(got.compute()), float(want.compute()), atol=1e-6)
    assert got.preds.shape == (128,) and int(got.valid.sum()) == 100


def test_binary_capacity_overflow_raises_like_jax():
    batches = _batches("binary", 3, 25, seed=3)
    got = AUROC(capacity=60, device="cpu")
    got.update(*(torch.from_numpy(x) for x in batches[0]))
    got.update(*(torch.from_numpy(x) for x in batches[1]))
    with pytest.raises(Exception, match="capacity"):
        got.update(*(torch.from_numpy(x) for x in batches[2]))


def test_mode_changes_raise():
    binary, multiclass = _batches("binary", 1, 10)[0], _batches("multiclass", 1, 10)[0]
    multilabel = _batches("multilabel", 1, 10)[0]
    metric = AUROC(device="cpu")
    metric.update(torch.from_numpy(binary[0]), torch.from_numpy(binary[1]))
    with pytest.raises(ValueError, match="should be constant"):
        metric.update(torch.from_numpy(multiclass[0]), torch.from_numpy(multiclass[1]))
    metric = AUROC(num_classes=C, device="cpu")
    metric.update(torch.from_numpy(multiclass[0]), torch.from_numpy(multiclass[1]))
    with pytest.raises(ValueError, match="should be constant"):
        metric.update(torch.from_numpy(multilabel[0]), torch.from_numpy(multilabel[1]))
    # a sketch made for C classes re-registers for the binary case its first
    # batch has, as the JAX package's does
    metric = AUROC(num_classes=C, device="cpu")
    metric.update(torch.from_numpy(binary[0]), torch.from_numpy(binary[1]))
    assert metric.csketch.shape == (8192, 3)
    with pytest.raises(RuntimeError, match="determined mode"):
        AUROC(device="cpu").compute_state(AUROC(device="cpu").init_state())


def test_constructor_errors():
    # exact=True is a state mode now (unbounded list states), with the
    # reference's memory warning
    with pytest.warns(UserWarning, match="memory footprint"):
        assert AUROC(exact=True, device="cpu").preds == []
    with pytest.raises(ValueError, match="mutually exclusive"):
        AUROC(exact=True, capacity=8, device="cpu")
    with pytest.raises(ValueError, match="sketch_capacity"):
        AUROC(sketch_capacity=0, device="cpu")
    with pytest.raises(ValueError, match="max_fpr"):
        AUROC(capacity=8, max_fpr=0.5, device="cpu")
    with pytest.raises(ValueError, match="max_fpr"):
        AUROC(max_fpr=2.0, device="cpu")
    metric = AUROC(num_classes=C, max_fpr=0.5, sketch_capacity=64, device="cpu")
    for p, t in _batches("multiclass", 3, 30):
        metric.update(torch.from_numpy(p), torch.from_numpy(t))
    with pytest.raises(ValueError, match="Partial AUC"):
        metric.compute()


@pytest.mark.parametrize("kind,kwargs", [("binary", {}), ("multiclass", {"num_classes": C})])
def test_merge_states_matches_jax(kind, kwargs):
    first, second = _batches(kind, 6, 50, seed=5), _batches(kind, 6, 50, seed=6)
    wa, ga = _pair(first, sketch_capacity=256, **kwargs)
    wb, gb = _pair(second, sketch_capacity=256, **kwargs)
    jax_merged = wa.merge_states({"csketch": wa.csketch, "n_seen": wa.n_seen}, {"csketch": wb.csketch, "n_seen": wb.n_seen})
    merged = ga.merge_states({"csketch": ga.csketch, "n_seen": ga.n_seen}, {"csketch": gb.csketch, "n_seen": gb.n_seen})
    np.testing.assert_array_equal(merged["csketch"].numpy(), np.asarray(jax_merged["csketch"]))
    assert int(merged["n_seen"]) == 600
    np.testing.assert_allclose(
        ga.compute_state(merged).numpy(), np.asarray(wa.compute_state(jax_merged)), atol=1e-5
    )


@pytest.mark.parametrize("kind,kwargs", [("binary", {}), ("multiclass", {"num_classes": C}), ("multilabel", {"num_classes": C})])
def test_epoch_begun_in_jax_continues_through_state_from_jax(kind, kwargs):
    batches = _batches(kind, 12, 40, seed=7)
    jax_metric = JaxAUROC(sketch_capacity=128, **kwargs)
    jax_state = jax_metric.init_state()
    for p, t in batches[:6]:
        jax_state = jax_metric.update_state(jax_state, jnp.asarray(p), jnp.asarray(t))
    metric = AUROC(sketch_capacity=128, device="cpu", **kwargs)
    state = state_from_jax({k: np.asarray(v) for k, v in jax_state.items()}, metric, host_from=jax_metric)
    assert metric.mode == jax_metric.mode and metric._sketch_cols == jax_metric._sketch_cols
    for p, t in batches[6:]:
        jax_state = jax_metric.update_state(jax_state, jnp.asarray(p), jnp.asarray(t))
        state = metric.update_state(state, torch.from_numpy(p), torch.from_numpy(t))
    np.testing.assert_array_equal(state["csketch"].numpy(), np.asarray(jax_state["csketch"]))
    np.testing.assert_allclose(
        metric.compute_state(state).numpy(), np.asarray(jax_metric.compute_state(jax_state)), atol=1e-5
    )


def test_state_from_jax_without_the_host_mode_cannot_compute():
    """The mode is host state: carried without ``host_from``, the state
    cannot be read, as a fresh metric cannot."""
    jax_metric = JaxAUROC(sketch_capacity=64)
    jax_state = jax_metric.init_state()
    p, t = _batches("binary", 1, 20)[0]
    jax_state = jax_metric.update_state(jax_state, jnp.asarray(p), jnp.asarray(t))
    metric = AUROC(sketch_capacity=64, device="cpu")
    state = state_from_jax({k: np.asarray(v) for k, v in jax_state.items()}, metric)
    with pytest.raises(RuntimeError, match="determined mode"):
        metric.compute_state(state)
    with pytest.raises(ValueError, match="host state"):
        metric._set_host_state({"average": "macro"})


def test_sketched_metrics_share_a_compute_group():
    batches = _batches("binary", 10, 40, seed=8)
    collection = MetricCollection(
        {"a": AUROC(sketch_capacity=128, device="cpu"), "b": AUROC(sketch_capacity=128, device="cpu")}
    )
    single = AUROC(sketch_capacity=128, device="cpu")
    for p, t in batches:
        collection.update(torch.from_numpy(p), torch.from_numpy(t))
        single.update(torch.from_numpy(p), torch.from_numpy(t))
    assert collection.compute_groups == {0: ["a", "b"]}
    values = collection.compute()
    assert float(values["a"]) == float(values["b"]) == float(single.compute())


def test_state_dict_round_trip_keeps_the_sketch():
    batches = _batches("multiclass", 8, 40, seed=9)
    metric = AUROC(num_classes=C, sketch_capacity=128, device="cpu")
    for p, t in batches:
        metric.update(torch.from_numpy(p), torch.from_numpy(t))
    restored = AUROC(num_classes=C, sketch_capacity=128, device="cpu")
    restored.load_state_dict(metric.state_dict())
    restored.mode = metric.mode
    np.testing.assert_array_equal(restored.csketch.numpy(), metric.csketch.numpy())
    with pytest.warns(UserWarning, match="before"):  # restored, never updated
        assert float(restored.compute()) == float(metric.compute())


@pytest.mark.parametrize("kind,kwargs", CONFIGS[:1] + CONFIGS[1:2] + CONFIGS[3:])
def test_functional_auroc_matches_jax(kind, kwargs):
    p, t = _batches(kind, 1, 200, seed=10, ties=True)[0]
    num_classes = kwargs.get("num_classes")
    rest = {k: v for k, v in kwargs.items() if k != "num_classes"}
    want = jax_auroc(jnp.asarray(p), jnp.asarray(t), num_classes=num_classes, **rest)
    got = auroc(torch.from_numpy(p), torch.from_numpy(t), num_classes=num_classes, device="cpu", **rest)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_functional_auroc_multidim_multiclass_matches_jax():
    rng = np.random.RandomState(11)
    p = rng.rand(6, C, 7).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    t = rng.randint(0, C, (6, 7))
    want = jax_auroc(jnp.asarray(p), jnp.asarray(t), num_classes=C)
    got = auroc(torch.from_numpy(p), torch.from_numpy(t), num_classes=C, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("ties", [False, True])
def test_functional_roc_and_auc_match_jax(ties):
    from metrics_tpu.functional.classification.auc import auc as jax_auc
    from metrics_tpu.functional.classification.roc import roc as jax_roc
    from metrics_tpu_torch.functional import auc, roc

    p, t = _batches("binary", 1, 120, seed=12, ties=ties)[0]
    want = jax_roc(jnp.asarray(p), jnp.asarray(t), pos_label=1)
    got = roc(torch.from_numpy(p), torch.from_numpy(t), pos_label=1, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    np.testing.assert_allclose(
        float(auc(got[0], got[1], device="cpu")), float(jax_auc(want[0], want[1])), atol=1e-6
    )
    p, t = _batches("multiclass", 1, 120, seed=13, ties=ties)[0]
    want = jax_roc(jnp.asarray(p), jnp.asarray(t), num_classes=C)
    got = roc(torch.from_numpy(p), torch.from_numpy(t), num_classes=C, device="cpu")
    for g_list, w_list in zip(got, want):
        for g, w in zip(g_list, w_list):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


@pytest.mark.parametrize(
    "preds_shape,target_shape",
    [((8,), (8,)), ((8, 1), (8,)), ((8, 4), (8,)), ((8, 4), (8, 4)), ((8, 4, 3), (8, 3)), ((8, 4, 3), (8, 4, 3))],
)
def test_score_mode_static_matches_jax(preds_shape, target_shape):
    from metrics_tpu.utils.checks import _score_mode_static as jax_mode
    from metrics_tpu_torch.utils.checks import _score_mode_static

    got = _score_mode_static(torch.zeros(preds_shape), torch.zeros(target_shape, dtype=torch.int64))
    want = jax_mode(jnp.zeros(preds_shape), jnp.zeros(target_shape, jnp.int32))
    assert got.value == want.value


def test_curve_buffers_and_fixed_auroc_match_jax():
    """The functional capacity buffers: updates into the first free slots of
    a merged buffer with holes, then the tie-exact binary AUROC over it."""
    from metrics_tpu.functional.classification import exact_curve as jec
    from metrics_tpu_torch.functional.classification import exact_curve as tec

    batches = _batches("binary", 4, 12, seed=14, ties=True)
    jstate = jec.curve_buffer_merge(jec.curve_buffer_init(16), jec.curve_buffer_init(24))
    tstate = tec.curve_buffer_merge(tec.curve_buffer_init(16, "cpu"), tec.curve_buffer_init(24, "cpu"))
    for p, t in batches[:3]:
        jstate = jec.curve_buffer_update(jstate, jnp.asarray(p), jnp.asarray(t))
        tstate = tec.curve_buffer_update(tstate, torch.from_numpy(p), torch.from_numpy(t))
    jstate = jec.curve_buffer_merge(jstate, jec.curve_buffer_update(jec.curve_buffer_init(16), *map(jnp.asarray, batches[3])))
    tstate = tec.curve_buffer_merge(
        tstate, tec.curve_buffer_update(tec.curve_buffer_init(16, "cpu"), *map(torch.from_numpy, batches[3]))
    )
    for key in ("preds", "target", "valid"):
        np.testing.assert_array_equal(tstate[key].numpy(), np.asarray(jstate[key]))
    np.testing.assert_allclose(
        float(tec.binary_auroc_fixed(tstate["preds"], tstate["target"], tstate["valid"])),
        float(jec.binary_auroc_fixed(jstate["preds"], jstate["target"], jstate["valid"])),
        atol=1e-6,
    )
