"""The port's binned curves, calibration error and fixed-edge histogram
against the JAX package's, on the CPU.

Tolerances:

* the binned ``TPs``/``FPs``/``FNs`` are bit-equal (whole numbers in
  float32), and so are the binned precision and recall (elementwise IEEE
  operations on them) and ``BinnedRecallAtFixedPrecision``;
  ``BinnedAveragePrecision`` sums over the curve: within 1e-6;
* CalibrationError's per-bin sums (``bin_count``, ``bin_conf``,
  ``bin_acc``) and the histogram are bit-equal over several updates: the
  segment sum adds each bin in row order, after the bin's old sum, as
  XLA's scatter into the state does; the values sum over 15 bins in
  another order: within 1e-6;
* ``linspace_f32`` equals ``jnp.linspace(0, 1, n, dtype=float32)`` bit for
  bit for every n from 2 to 1024;
* ``searchsorted`` and ``argmax`` place NaN, +-0 and values equal to an
  edge where the JAX package does.
"""
from importlib import import_module

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import metrics_tpu
import metrics_tpu.functional as jfn
import metrics_tpu_torch
import metrics_tpu_torch.functional as tfn
from metrics_tpu.sketches import histogram as jhist
from metrics_tpu_torch.convert import state_from_jax
from metrics_tpu_torch.sketches import histogram as thist
from metrics_tpu_torch.utils.data import linspace_f32

# the modules (their packages export functions of the same name)
jce = import_module("metrics_tpu.functional.classification.calibration_error")
tce = import_module("metrics_tpu_torch.functional.classification.calibration_error")

torch.set_num_threads(2)
pytestmark = pytest.mark.filterwarnings("ignore:Metric `.*` with `exact=True` will save all")

C = 5
EDGE_VALUES = np.array([0.0, -0.0, 0.25, 0.5, 1.0, 1.5, -0.5, np.nan, 1 / 3, 0.7], np.float32)


def _batches(kind, n_batches=3, batch=64, seed=0, edges=False):
    """Seeded batches; ``edges`` mixes in NaN, +-0, 1 and values equal to
    a bin edge (binary scores only)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        if kind == "binary":
            p = rng.rand(batch).astype(np.float32)
            t = (rng.rand(batch) < 0.4).astype(np.int64)
            if edges:
                p[: EDGE_VALUES.size] = EDGE_VALUES
        elif kind == "multiclass":
            p = rng.rand(batch, C).astype(np.float32)
            p /= p.sum(1, keepdims=True)
            t = rng.randint(0, C, batch)
        else:  # multidim multiclass
            p = rng.rand(batch // 4, C, 4).astype(np.float32)
            p /= p.sum(1, keepdims=True)
            t = rng.randint(0, C, (batch // 4, 4))
        out.append((p, t))
    return out


def _pair(name, batches, **kwargs):
    want = getattr(metrics_tpu, name)(**kwargs)
    got = getattr(metrics_tpu_torch, name)(device="cpu", **kwargs)
    for p, t in batches:
        want.update(jnp.asarray(p), jnp.asarray(t))
        got.update(torch.from_numpy(p), torch.from_numpy(t))
    return want, got


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# the linspace helper and the edge conventions
# ---------------------------------------------------------------------------


def test_linspace_f32_is_jnp_linspace_bit_for_bit():
    # every jnp.linspace of n = 2..1024 in one compiled program (1023 eager
    # calls would compile each of their operations once per n: minutes)
    sizes = range(2, 1025)
    want = jax.jit(lambda: [jnp.linspace(0, 1, n, dtype=jnp.float32) for n in sizes])()
    differ = [
        n
        for n, w in zip(sizes, want)
        if not np.array_equal(linspace_f32(n, device="cpu").numpy().view(np.int32), np.asarray(w).view(np.int32))
    ]
    assert differ == []
    # the eager calls agree with the program (the sizes of the binned curves
    # and of CalibrationError's edges among them)
    for n in (2, 3, 11, 16, 101, 201, 1001):
        np.testing.assert_array_equal(np.asarray(jnp.linspace(0, 1, n, dtype=jnp.float32)), np.asarray(want[n - 2]))
    # torch.linspace is not: at CalibrationError's 16 edges six differ
    assert int((torch.linspace(0, 1, 16) != linspace_f32(16, device="cpu")).sum()) == 6


@pytest.mark.parametrize("right", [False, True])
def test_searchsorted_places_edge_values_as_jax(right):
    edges = np.array(jnp.linspace(0, 1, 5, dtype=jnp.float32))
    values = np.concatenate([EDGE_VALUES, edges, -edges])
    want = np.asarray(jnp.searchsorted(jnp.asarray(edges), jnp.asarray(values), side="right" if right else "left"))
    got = torch.searchsorted(torch.from_numpy(edges), torch.from_numpy(values), right=right)
    np.testing.assert_array_equal(got.numpy(), want)


def test_argmax_and_max_of_nan_zero_and_tied_rows_as_jax():
    rows = np.array(
        [[0.1, np.nan, 0.3, np.nan], [0.2, 0.2, 0.1, 0.0], [-0.0, 0.0, -0.0, 0.0], [0.0, -0.0, 0.0, -0.0], [0.5, 0.1, 0.5, 0.2]],
        np.float32,
    )
    target = np.array([1, 0, 1, 0, 2])
    want = jce._ce_update(jnp.asarray(np.nan_to_num(rows)), jnp.asarray(target))
    got = tce._ce_update(torch.from_numpy(np.nan_to_num(rows)), torch.from_numpy(target))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.int32), np.asarray(w).view(np.int32))
    # the NaN rows themselves (which the value checks would refuse)
    np.testing.assert_array_equal(torch.from_numpy(rows).argmax(1).numpy(), np.asarray(jnp.argmax(jnp.asarray(rows), 1)))


# ---------------------------------------------------------------------------
# the binned curves
# ---------------------------------------------------------------------------

BINNED_CASES = [
    ("binary", {"num_classes": 1, "thresholds": 11}),
    ("binary", {"num_classes": 1, "thresholds": 101}),
    ("binary", {"num_classes": 1, "thresholds": [0.0, 0.1, 0.25, 0.5, 0.9, 1.0]}),
    ("multiclass", {"num_classes": C, "thresholds": 16}),
]


@pytest.mark.parametrize("kind,kwargs", BINNED_CASES)
@pytest.mark.parametrize("name", ["BinnedPrecisionRecallCurve", "BinnedAveragePrecision"])
def test_binned_states_and_values(name, kind, kwargs):
    want, got = _pair(name, _batches(kind, edges=True), **kwargs)
    for key in ("TPs", "FPs", "FNs"):
        np.testing.assert_array_equal(getattr(got, key).numpy(), np.asarray(getattr(want, key)))
    np.testing.assert_array_equal(got.thresholds.numpy(), np.asarray(want.thresholds))
    g, w = got.compute(), want.compute()
    g, w = (g, w) if isinstance(g, (list, tuple)) else ([g], [w])
    for gi, wi in zip(g, w):
        gi, wi = (gi, wi) if isinstance(gi, (list, tuple)) else ([gi], [wi])
        for a, b in zip(gi, wi):
            if name == "BinnedAveragePrecision":
                np.testing.assert_allclose(_np(a), _np(b), atol=1e-6)
            else:
                np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("kind,kwargs", BINNED_CASES[:1] + BINNED_CASES[3:])
@pytest.mark.parametrize("min_precision", [0.3, 0.99])
def test_binned_recall_at_fixed_precision(kind, kwargs, min_precision):
    want, got = _pair("BinnedRecallAtFixedPrecision", _batches(kind, seed=1), min_precision=min_precision, **kwargs)
    for g, w in zip(got.compute(), want.compute()):
        np.testing.assert_array_equal(_np(g), _np(w))


def test_binned_pr_curve_matches_exact_at_fine_thresholds():
    """Thresholds at the distinct prediction values: the binned counts are
    the exact curve's (the JAX package's own contract, on the port)."""
    rng = np.random.RandomState(42)
    preds = np.round(rng.rand(512).astype(np.float32), 2)
    target = rng.randint(0, 2, 512)
    metric = metrics_tpu_torch.BinnedPrecisionRecallCurve(num_classes=1, thresholds=101, device="cpu")
    metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    precision, recall, _ = metric.compute()
    thr = metric.thresholds.numpy()
    tp = np.array([(preds >= t)[target == 1].sum() for t in thr])
    fp = np.array([(preds >= t)[target == 0].sum() for t in thr])
    fn = np.array([(preds < t)[target == 1].sum() for t in thr])
    np.testing.assert_array_equal(metric.TPs[0].numpy(), tp)
    np.testing.assert_array_equal(metric.FPs[0].numpy(), fp)
    np.testing.assert_array_equal(metric.FNs[0].numpy(), fn)
    np.testing.assert_allclose(precision.numpy()[:-1], (tp + 1e-6) / (tp + fp + 1e-6), atol=1e-4)
    np.testing.assert_allclose(recall.numpy()[:-1], tp / (tp + fn + 1e-6), atol=1e-4)


def test_binned_shapes_close_to_exact_and_fixed_precision_contract():
    rng = np.random.RandomState(3)
    mc = metrics_tpu_torch.BinnedPrecisionRecallCurve(num_classes=C, thresholds=11, device="cpu")
    p, t = _batches("multiclass", 1, seed=4)[0]
    mc.update(torch.from_numpy(p), torch.from_numpy(t))
    precision, _, thresholds = mc.compute()
    assert len(precision) == C and precision[0].shape == (12,) and thresholds[0].shape == (11,)

    preds = rng.rand(4096).astype(np.float32)
    target = (preds + 0.3 * rng.randn(4096) > 0.5).astype(np.int64)
    ap = metrics_tpu_torch.BinnedAveragePrecision(num_classes=1, thresholds=201, device="cpu")
    ap.update(torch.from_numpy(preds), torch.from_numpy(target))
    exact = tfn.average_precision(torch.from_numpy(preds), torch.from_numpy(target), pos_label=1)
    assert abs(float(ap.compute()) - float(exact)) < 0.01

    rfp = metrics_tpu_torch.BinnedRecallAtFixedPrecision(num_classes=1, thresholds=10, min_precision=0.5, device="cpu")
    recall, threshold = rfp(torch.tensor([0.0, 0.2, 0.5, 0.8]), torch.tensor([0, 1, 1, 0]))
    assert float(recall) == pytest.approx(1.0, abs=1e-4) and float(threshold) == pytest.approx(1 / 9, abs=1e-4)
    none = metrics_tpu_torch.BinnedRecallAtFixedPrecision(num_classes=1, thresholds=5, min_precision=0.99, device="cpu")
    recall, threshold = none(torch.tensor([0.9, 0.9]), torch.tensor([0, 0]))
    assert float(recall) == 0.0 and float(threshold) == pytest.approx(1e6)


def test_binned_merge_and_state_from_jax():
    metric = metrics_tpu_torch.BinnedPrecisionRecallCurve(num_classes=1, thresholds=21, device="cpu")
    (p1, t1), (p2, t2) = _batches("binary", 2, seed=5)
    s1 = metric.update_state(metric.init_state(), torch.from_numpy(p1), torch.from_numpy(t1))
    s2 = metric.update_state(metric.init_state(), torch.from_numpy(p2), torch.from_numpy(t2))
    both = metric.update_state(s1, torch.from_numpy(p2), torch.from_numpy(t2))
    for g, w in zip(metric.compute_state(metric.merge_states(s1, s2)), metric.compute_state(both)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    jmetric = metrics_tpu.BinnedPrecisionRecallCurve(num_classes=1, thresholds=21)
    jstate = jmetric.update_state(jmetric.init_state(), jnp.asarray(p1), jnp.asarray(t1))
    state = state_from_jax({k: np.asarray(v) for k, v in jstate.items()}, metric)
    for key in ("TPs", "FPs", "FNs"):
        np.testing.assert_array_equal(state[key].numpy(), s1[key].numpy())


def test_binned_rejects_unsorted_and_bad_thresholds():
    with pytest.raises(ValueError, match="sorted"):
        metrics_tpu_torch.BinnedPrecisionRecallCurve(num_classes=1, thresholds=[0.5, 0.1], device="cpu")
    with pytest.raises(ValueError, match="thresholds"):
        metrics_tpu_torch.BinnedPrecisionRecallCurve(num_classes=1, thresholds=None, device="cpu")


# ---------------------------------------------------------------------------
# calibration error
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
@pytest.mark.parametrize("kind", ["binary", "multiclass", "multidim"])
@pytest.mark.parametrize("exact", [False, True])
def test_calibration_error(norm, kind, exact):
    want, got = _pair("CalibrationError", _batches(kind, edges=True), n_bins=15, norm=norm, exact=exact)
    np.testing.assert_array_equal(got.bin_boundaries.numpy(), np.asarray(want.bin_boundaries))
    states = ("confidences", "accuracies") if exact else ("bin_count", "bin_conf", "bin_acc")
    for key in states:
        g, w = getattr(got, key), getattr(want, key)
        g, w = (torch.cat(g), jnp.concatenate(w)) if exact else (g, w)
        np.testing.assert_array_equal(g.numpy().view(np.int32), np.asarray(w).view(np.int32))
    np.testing.assert_allclose(float(got.compute()), float(want.compute()), atol=1e-6, rtol=0)


@pytest.mark.parametrize("n_bins", [2, 10, 15])
@pytest.mark.parametrize("debias", [False, True])
def test_calibration_error_functional_and_debias(n_bins, debias):
    p, t = _batches("multiclass", 1, 200, seed=6)[0]
    if not debias:
        want = jfn.calibration_error(jnp.asarray(p), jnp.asarray(t), n_bins=n_bins, norm="l1")
        got = tfn.calibration_error(p, t, n_bins=n_bins, norm="l1", device="cpu")
        np.testing.assert_allclose(float(got), float(want), atol=1e-6)
    conf, acc = tce._ce_update(torch.from_numpy(p), torch.from_numpy(t))
    jconf, jacc = jce._ce_update(jnp.asarray(p), jnp.asarray(t))
    edges = linspace_f32(n_bins + 1, device="cpu")
    jedges = jnp.linspace(0, 1, n_bins + 1, dtype=jnp.float32)
    for g, w in zip(tce._binning_bucketize(conf, acc, edges), jce._binning_bucketize(jconf, jacc, jedges)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(
        float(tce._ce_compute(conf, acc, edges, norm="l2", debias=debias)),
        float(jce._ce_compute(jconf, jacc, jedges, norm="l2", debias=debias)),
        atol=1e-6,
    )


def test_calibration_error_state_from_jax_and_errors():
    batches = _batches("multiclass", 3, seed=7)
    want = metrics_tpu.CalibrationError(n_bins=15)
    got = metrics_tpu_torch.CalibrationError(n_bins=15, device="cpu")
    jstate = want.init_state()
    for p, t in batches[:2]:
        jstate = want.update_state(jstate, jnp.asarray(p), jnp.asarray(t))
    state = state_from_jax({k: np.asarray(v) for k, v in jstate.items()}, got)
    p, t = batches[2]
    jstate = want.update_state(jstate, jnp.asarray(p), jnp.asarray(t))
    state = got.update_state(state, torch.from_numpy(p), torch.from_numpy(t))
    for key in ("bin_count", "bin_conf", "bin_acc"):
        np.testing.assert_array_equal(state[key].numpy(), np.asarray(jstate[key]))
    np.testing.assert_allclose(float(got.compute_state(state)), float(want.compute_state(jstate)), atol=1e-6)
    with pytest.raises(ValueError, match="Norm"):
        metrics_tpu_torch.CalibrationError(norm="l3", device="cpu")
    with pytest.raises(ValueError, match="n_bins"):
        metrics_tpu_torch.CalibrationError(n_bins=0, device="cpu")
    with pytest.raises(ValueError, match="not well-defined"):
        tfn.calibration_error(torch.rand(4, 3), torch.randint(0, 2, (4, 3)), device="cpu")


# ---------------------------------------------------------------------------
# the fixed-edge histogram
# ---------------------------------------------------------------------------


def test_histogram_matches_jax():
    rng = np.random.RandomState(8)
    edges = np.array(jnp.linspace(0, 1, 11, dtype=jnp.float32))
    jh, th = jhist.hist_init(10, 2), thist.hist_init(10, 2, device="cpu")
    assert th.shape == (2, 10) and th.dtype == torch.float32
    for step in range(3):
        x = np.concatenate([EDGE_VALUES, rng.rand(40).astype(np.float32)])
        stats = np.stack([x, rng.rand(x.size).astype(np.float32)])
        weights = rng.rand(x.size).astype(np.float32) if step else None
        n_valid = 30 if step == 2 else None
        jidx = jhist.hist_bin_index(jnp.asarray(edges), jnp.asarray(x))
        tidx = thist.hist_bin_index(torch.from_numpy(edges), torch.from_numpy(x))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        jh = jhist.hist_insert(jh, jidx, jnp.asarray(stats), None if weights is None else jnp.asarray(weights), n_valid)
        th = thist.hist_insert(th, tidx, torch.from_numpy(stats), None if weights is None else torch.from_numpy(weights), n_valid)
        np.testing.assert_array_equal(th.numpy().view(np.int32), np.asarray(jh).view(np.int32))
    np.testing.assert_array_equal(thist.hist_merge(th, th).numpy(), np.asarray(jhist.hist_merge(jh, jh)))
    one = thist.hist_insert(thist.hist_init(4, device="cpu"), torch.tensor([0, 3, 3]), torch.tensor([1.0, 2.0, 3.0]))
    np.testing.assert_array_equal(one.numpy(), [[1.0, 0.0, 0.0, 5.0]])
    with pytest.raises(ValueError):
        thist.hist_init(0, device="cpu")
