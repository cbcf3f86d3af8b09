"""The port's curve family against the JAX package's, on the CPU.

``roc``, ``precision_recall_curve``, ``average_precision`` and ``auc``
(functional and modular), and ``ROC``, ``PrecisionRecallCurve``,
``AveragePrecision`` and ``AUROC`` in their three state modes (the
sketched default, ``exact=True``, ``capacity=N``) over binary, multiclass
and multilabel inputs, fed the same seeded numpy batches as the JAX
package.

Tolerances:

* curve points (fpr, tpr, precision, recall, thresholds, point masks) are
  bit-equal, on distinct scores and on scores tied on a grid of eighths:
  their counts are whole float32 numbers, and each point is one IEEE
  division of them;
* the states are bit-equal: list states, capacity buffers and the sketch
  (inside its lossless window and past it, where every compaction is);
* a value that sums over the curve (AP, AUROC, AUC) is within 1e-6: both
  packages add the same terms, in another order; past the sketch's window
  within 1e-5 (weighted cumulative sums);
* the sketched default equals its ``exact=True`` twin bit for bit while the
  stream fits ``sketch_capacity``, and stays within 5e-3 of it past the
  window (the JAX package's bound, ``tests/sketches/test_sketch_metrics.py``).
"""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import metrics_tpu
import metrics_tpu.functional as jfn
import metrics_tpu_torch
import metrics_tpu_torch.functional as tfn
from metrics_tpu_torch.convert import state_from_jax
from metrics_tpu_torch.sketches import qsketch_fill

torch.set_num_threads(2)
pytestmark = pytest.mark.filterwarnings("ignore:Metric `.*` with `exact=True` will save all")

C = 4
CURVES = ("ROC", "PrecisionRecallCurve", "AveragePrecision", "AUROC")
ATOL = 1e-6


def _batches(kind, n_batches=3, batch=40, seed=0, ties=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        if kind == "binary":
            p = rng.rand(batch).astype(np.float32)
            t = (rng.rand(batch) < 0.35).astype(np.int64)
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


def _flatten(x):
    """Nested tuples/lists of arrays to a flat list of numpy arrays."""
    if isinstance(x, (list, tuple)):
        return [a for item in x for a in _flatten(item)]
    return [x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)]


def _assert_outputs(got, want, summed):
    """Curves bit-equal; a value that sums over the curve within ``ATOL``."""
    got, want = _flatten(got), _flatten(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        if summed:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
        else:
            np.testing.assert_array_equal(g, w)


def _pair(name, batches, **kwargs):
    want = getattr(metrics_tpu, name)(**kwargs)
    got = getattr(metrics_tpu_torch, name)(device="cpu", **kwargs)
    for p, t in batches:
        want.update(jnp.asarray(p), jnp.asarray(t))
        got.update(torch.from_numpy(p), torch.from_numpy(t))
    return want, got


def _summed(name):
    return name in ("AveragePrecision", "AUROC")


# ---------------------------------------------------------------------------
# functionals
# ---------------------------------------------------------------------------

FUNCTIONAL_CASES = [
    ("binary", {"pos_label": 1}),
    ("binary", {"pos_label": 0}),
    ("multiclass", {"num_classes": C}),
    ("multilabel", {"num_classes": C}),
]


@pytest.mark.parametrize("fn", ["roc", "precision_recall_curve"])
@pytest.mark.parametrize("kind,kwargs", FUNCTIONAL_CASES)
@pytest.mark.parametrize("ties", [False, True])
def test_functional_curves(fn, kind, kwargs, ties):
    p, t = _batches(kind, 1, 120, seed=1, ties=ties)[0]
    want = getattr(jfn, fn)(jnp.asarray(p), jnp.asarray(t), **kwargs)
    got = getattr(tfn, fn)(torch.from_numpy(p), torch.from_numpy(t), device="cpu", **kwargs)
    _assert_outputs(got, want, summed=False)


@pytest.mark.parametrize(
    "kind,kwargs",
    FUNCTIONAL_CASES
    + [
        ("multiclass", {"num_classes": C, "average": "weighted"}),
        ("multiclass", {"num_classes": C, "average": None}),
        ("multilabel", {"num_classes": C, "average": "micro"}),
        ("multilabel", {"num_classes": C, "average": "weighted"}),
    ],
)
@pytest.mark.parametrize("ties", [False, True])
def test_functional_average_precision(kind, kwargs, ties):
    p, t = _batches(kind, 1, 120, seed=2, ties=ties)[0]
    want = jfn.average_precision(jnp.asarray(p), jnp.asarray(t), **kwargs)
    got = tfn.average_precision(torch.from_numpy(p), torch.from_numpy(t), device="cpu", **kwargs)
    _assert_outputs(got, want, summed=True)


def test_functional_average_precision_nan_class_warns_and_is_left_out():
    # class C-1 never occurs: its AP is NaN, left out of the macro average
    p, t = _batches("multiclass", 1, 60, seed=3)[0]
    t = np.minimum(t, C - 2)
    with pytest.warns(UserWarning, match="nan"):
        want = jfn.average_precision(jnp.asarray(p), jnp.asarray(t), num_classes=C)
    with pytest.warns(UserWarning, match="nan"):
        got = tfn.average_precision(torch.from_numpy(p), torch.from_numpy(t), num_classes=C, device="cpu")
    np.testing.assert_allclose(float(got), float(want), atol=ATOL)


def test_functional_sample_weights_and_auc():
    p, t = _batches("binary", 1, 80, seed=4, ties=True)[0]
    w = np.random.RandomState(5).rand(80).astype(np.float32)
    for fn in ("roc", "precision_recall_curve", "average_precision"):
        want = getattr(jfn, fn)(jnp.asarray(p), jnp.asarray(t), pos_label=1, sample_weights=w)
        got = getattr(tfn, fn)(torch.from_numpy(p), torch.from_numpy(t), pos_label=1, sample_weights=w, device="cpu")
        # weighted cumulative sums add in another order: float32 tolerance
        _assert_outputs(got, want, summed=True)
    fpr, tpr, _ = tfn.roc(torch.from_numpy(p), torch.from_numpy(t), pos_label=1, device="cpu")
    jfpr, jtpr, _ = jfn.roc(jnp.asarray(p), jnp.asarray(t), pos_label=1)
    np.testing.assert_allclose(float(tfn.auc(fpr, tpr)), float(jfn.auc(jfpr, jtpr)), atol=ATOL)
    x = np.array([3.0, 1.0, 2.0, 0.0], np.float32)
    y = np.array([1.0, 0.5, 2.0, 0.0], np.float32)
    np.testing.assert_allclose(
        float(tfn.auc(x, y, reorder=True, device="cpu")), float(jfn.auc(jnp.asarray(x), jnp.asarray(y), reorder=True)), atol=0
    )


# ---------------------------------------------------------------------------
# modular: the three state modes
# ---------------------------------------------------------------------------

MODULAR_CASES = [
    ("binary", {}),
    ("binary", {"pos_label": 0}),
    ("multiclass", {"num_classes": C}),
    ("multilabel", {"num_classes": C}),
]


@pytest.mark.parametrize("name", CURVES)
@pytest.mark.parametrize("kind,kwargs", MODULAR_CASES)
def test_exact_mode(name, kind, kwargs):
    want, got = _pair(name, _batches(kind, ties=True), exact=True, **kwargs)
    for key in ("preds", "target"):
        assert len(getattr(got, key)) == len(getattr(want, key))
        for g, w in zip(getattr(got, key), getattr(want, key)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _assert_outputs(got.compute(), want.compute(), summed=_summed(name))


@pytest.mark.parametrize("name", CURVES)
@pytest.mark.parametrize("kind,kwargs", MODULAR_CASES)
def test_sketched_default_inside_the_window(name, kind, kwargs):
    want, got = _pair(name, _batches(kind), sketch_capacity=256, **kwargs)
    assert int(qsketch_fill(got.csketch)) == 120  # nothing compacted
    np.testing.assert_array_equal(got.csketch.numpy(), np.asarray(want.csketch))
    _assert_outputs(got.compute(), want.compute(), summed=_summed(name))


@pytest.mark.parametrize("name", CURVES)
@pytest.mark.parametrize("kind,kwargs", MODULAR_CASES[:1] + MODULAR_CASES[2:])
def test_sketched_default_past_the_window(name, kind, kwargs):
    want, got = _pair(name, _batches(kind, 4, 60, seed=6), sketch_capacity=128, **kwargs)
    assert int(got.n_seen) == 240 > int(qsketch_fill(got.csketch))  # compacted
    np.testing.assert_array_equal(got.csketch.numpy(), np.asarray(want.csketch))
    got_flat, want_flat = _flatten(got.compute()), _flatten(want.compute())
    assert len(got_flat) == len(want_flat)
    for g, w in zip(got_flat, want_flat):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


CAPACITY_CASES = [
    ("binary", {}),
    ("binary", {"pos_label": 0}),
    ("multiclass", {"num_classes": C}),
    ("multilabel", {"num_classes": C, "multilabel": True}),
]


@pytest.mark.parametrize("name", CURVES[:3])
@pytest.mark.parametrize("kind,kwargs", CAPACITY_CASES)
def test_capacity_mode(name, kind, kwargs):
    want, got = _pair(name, _batches(kind, ties=True), capacity=160, **kwargs)
    for key in ("preds", "target", "valid", "overflow"):
        np.testing.assert_array_equal(getattr(got, key).numpy(), np.asarray(getattr(want, key)))
    _assert_outputs(got.compute(), want.compute(), summed=_summed(name))


@pytest.mark.parametrize("average", ["macro", "weighted", "micro", None])
def test_capacity_average_precision_averages(average):
    kind = "multilabel" if average == "micro" else "multiclass"
    kwargs = {"multilabel": True} if average == "micro" else {}
    want, got = _pair("AveragePrecision", _batches(kind, seed=7), num_classes=C, capacity=160, average=average, **kwargs)
    _assert_outputs(got.compute(), want.compute(), summed=True)


def test_capacity_config_errors_match_jax():
    for kwargs in ({"multilabel": True}, {"capacity": 8, "multilabel": True}, {"capacity": 8, "exact": True}):
        for name in CURVES[:3]:
            with pytest.raises(ValueError):
                getattr(metrics_tpu, name)(**kwargs)
            with pytest.raises(ValueError):
                getattr(metrics_tpu_torch, name)(device="cpu", **kwargs)
    with pytest.raises(ValueError, match="micro"):
        metrics_tpu_torch.AveragePrecision(num_classes=C, capacity=8, average="micro", device="cpu")


def test_capacity_overflow_raises():
    got = metrics_tpu_torch.ROC(capacity=50, device="cpu")
    batches = _batches("binary", 2, 30, seed=8)
    got.update(*map(torch.from_numpy, batches[0]))
    with pytest.raises(Exception, match="capacity"):
        got.update(*map(torch.from_numpy, batches[1]))


def test_exact_mode_warns_only_on_exact():
    for name in CURVES:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            getattr(metrics_tpu_torch, name)(device="cpu")
        with pytest.warns(UserWarning, match="memory footprint"):
            getattr(metrics_tpu_torch, name)(exact=True, device="cpu")


def test_auroc_exact_modes_of_the_reference():
    for kind, kwargs in (("binary", {"max_fpr": 0.5}), ("multiclass", {"num_classes": C, "average": "weighted"})):
        want, got = _pair("AUROC", _batches(kind, seed=9), exact=True, **kwargs)
        _assert_outputs(got.compute(), want.compute(), summed=True)


def test_modular_auc():
    rng = np.random.RandomState(10)
    want, got = metrics_tpu.AUC(), metrics_tpu_torch.AUC(device="cpu")
    x = np.sort(rng.rand(3, 20).astype(np.float32).reshape(-1))
    y = rng.rand(60).astype(np.float32)
    for lo in range(0, 60, 20):
        want.update(jnp.asarray(x[lo : lo + 20]), jnp.asarray(y[lo : lo + 20]))
        got.update(torch.from_numpy(x[lo : lo + 20]), torch.from_numpy(y[lo : lo + 20]))
    np.testing.assert_allclose(float(got.compute()), float(want.compute()), atol=ATOL)


# ---------------------------------------------------------------------------
# the lossless window, and the bound past it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CURVES)
@pytest.mark.parametrize("kind,kwargs", MODULAR_CASES[:1] + MODULAR_CASES[2:])
def test_sketched_equals_exact_inside_the_window(name, kind, kwargs):
    batches = _batches(kind, 3, 50, seed=11, ties=True)
    sketched = getattr(metrics_tpu_torch, name)(sketch_capacity=150, device="cpu", **kwargs)
    exact = getattr(metrics_tpu_torch, name)(exact=True, device="cpu", **kwargs)
    for p, t in batches:
        sketched.update(torch.from_numpy(p), torch.from_numpy(t))
        exact.update(torch.from_numpy(p), torch.from_numpy(t))
    for g, w in zip(_flatten(sketched.compute()), _flatten(exact.compute())):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["AUROC", "AveragePrecision"])
def test_sketched_within_bound_past_the_window(name):
    rng = np.random.RandomState(12)
    n, cap = 20_000, 1024
    preds = rng.rand(n).astype(np.float32)
    target = (rng.rand(n) < 0.3).astype(np.int64)
    sketched = getattr(metrics_tpu_torch, name)(sketch_capacity=cap, device="cpu")
    exact = getattr(metrics_tpu_torch, name)(exact=True, device="cpu")
    for lo in range(0, n, 2000):
        sketched.update(torch.from_numpy(preds[lo : lo + 2000]), torch.from_numpy(target[lo : lo + 2000]))
        exact.update(torch.from_numpy(preds[lo : lo + 2000]), torch.from_numpy(target[lo : lo + 2000]))
    assert int(qsketch_fill(sketched.csketch)) < n
    assert abs(float(sketched.compute()) - float(exact.compute())) < 5e-3


# ---------------------------------------------------------------------------
# compute groups and state_from_jax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,kwargs", [("binary", {}), ("multiclass", {"num_classes": C})])
@pytest.mark.parametrize("mode", [{}, {"exact": True}])
def test_compute_groups_match_jax(kind, kwargs, mode):
    batches = _batches(kind, 2, 30, seed=13)
    want = metrics_tpu.MetricCollection([getattr(metrics_tpu, n)(**kwargs, **mode) for n in CURVES])
    got = metrics_tpu_torch.MetricCollection([getattr(metrics_tpu_torch, n)(device="cpu", **kwargs, **mode) for n in CURVES])
    for p, t in batches:
        want.update(jnp.asarray(p), jnp.asarray(t))
        got.update(torch.from_numpy(p), torch.from_numpy(t))
    assert {tuple(v) for v in got.compute_groups.values()} == {tuple(v) for v in want.compute_groups.values()}
    values_want, values_got = want.compute(), got.compute()
    for name in CURVES:
        _assert_outputs(values_got[name], values_want[name], summed=_summed(name))


@pytest.mark.parametrize("name", CURVES)
@pytest.mark.parametrize(
    "kind,mode",
    [
        ("binary", {}),
        ("multilabel", {"num_classes": C, "exact": True}),
        ("multiclass", {"num_classes": C, "capacity": 160}),
    ],
)
def test_state_from_jax_round_trip(name, kind, mode):
    """An epoch accumulated in JAX, carried into the port and computed (and
    continued) there, against the JAX package's own."""
    batches = _batches(kind, 3, 40, seed=14)
    want = getattr(metrics_tpu, name)(**mode)
    got = getattr(metrics_tpu_torch, name)(device="cpu", **mode)
    jstate = want.init_state()
    for p, t in batches[:2]:
        jstate = want.update_state(jstate, jnp.asarray(p), jnp.asarray(t))
    leaves = {k: ([np.asarray(x) for x in v] if isinstance(v, list) else np.asarray(v)) for k, v in jstate.items()}
    state = state_from_jax(leaves, got, host_from=want)
    _assert_outputs(got.compute_state(state), want.compute_state(jstate), summed=_summed(name))
    p, t = batches[2]
    jstate = want.update_state(jstate, jnp.asarray(p), jnp.asarray(t))
    state = got.update_state(state, torch.from_numpy(p), torch.from_numpy(t))
    _assert_outputs(got.compute_state(state), want.compute_state(jstate), summed=_summed(name))


def test_fixed_order_scan_of_the_weighted_kernels():
    """The weighted kernels' prefix sums take a fixed order (the same bits on
    every device): exact on whole numbers, within float32 rounding of a
    float64 scan otherwise, at lengths 1 to 2**k + 1."""
    from metrics_tpu_torch.utils.data import _scan_fixed

    rng = np.random.RandomState(15)
    for n in (1, 2, 3, 7, 8, 9, 100, 1025):
        whole = torch.from_numpy(rng.randint(0, 5, (3, n)).astype(np.float32))
        np.testing.assert_array_equal(_scan_fixed(whole).numpy(), np.cumsum(whole.numpy(), axis=-1))
        x = rng.rand(n).astype(np.float32)
        np.testing.assert_allclose(_scan_fixed(torch.from_numpy(x)).numpy(), np.cumsum(x.astype(np.float64)), rtol=1e-5)
