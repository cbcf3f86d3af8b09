"""The port's confusion-matrix family against the JAX package's, on the CPU.

CohenKappa (weights None, linear, quadratic), JaccardIndex (``ignore_index``,
``absent_score``, reductions) and MatthewsCorrCoef: functional, modular
(forward, update, compute) and pure-state (``init_state`` /
``update_state`` / ``compute_state`` / ``merge_states``). The same seeded
numpy inputs go to both packages. The int32 confusion matrices agree bit
for bit; Jaccard values hold to rtol 1e-6 and atol 1e-7, kappa and MCC to
atol 1e-5 (float32 sums of products that cancel near 0, reduced in another
order on XLA's CPU than in torch).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import metrics_tpu.classification as jcls
import metrics_tpu.functional as jfn
import metrics_tpu_torch.classification as tcls
import metrics_tpu_torch.functional as tfn

torch.set_num_threads(2)

C = 5
N = 48
BATCHES = 4


def _probs(rng, n, c):
    logits = rng.rand(n, c).astype(np.float32) * 4
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _inputs(kind, seed=0):
    """``BATCHES`` batches of one input style."""
    rng = np.random.RandomState(seed)
    if kind == "probs":
        return [(_probs(rng, N, C), rng.randint(0, C, N)) for _ in range(BATCHES)]
    if kind == "labels":
        return [(rng.randint(0, C, N), rng.randint(0, C, N)) for _ in range(BATCHES)]
    if kind == "missing":  # class 3 never appears: its union is 0
        return [(np.where(p == 3, 0, p), np.where(t == 3, 1, t)) for p, t in _inputs("labels", seed)]
    if kind == "agree":  # predictions equal to the targets
        return [(t, t) for _, t in _inputs("labels", seed)]
    if kind == "binary":
        return [(rng.rand(N).astype(np.float32), rng.randint(0, 2, N)) for _ in range(BATCHES)]
    raise ValueError(kind)


KINDS = ["probs", "labels", "missing", "agree", "binary"]

# name -> (functional, class, keyword arguments); value tolerance
CASES = {
    "kappa": ("cohen_kappa", "CohenKappa", {}),
    "kappa-linear": ("cohen_kappa", "CohenKappa", {"weights": "linear"}),
    "kappa-quadratic": ("cohen_kappa", "CohenKappa", {"weights": "quadratic"}),
    "jaccard": ("jaccard_index", "JaccardIndex", {}),
    "jaccard-ignore": ("jaccard_index", "JaccardIndex", {"ignore_index": 0}),
    "jaccard-absent": ("jaccard_index", "JaccardIndex", {"absent_score": 0.5, "reduction": "none"}),
    "jaccard-sum": ("jaccard_index", "JaccardIndex", {"reduction": "sum", "ignore_index": 2}),
    "mcc": ("matthews_corrcoef", "MatthewsCorrCoef", {}),
}


def _tolerance(case):
    return dict(rtol=0, atol=1e-5) if case.startswith(("kappa", "mcc")) else dict(rtol=1e-6, atol=1e-7)


def _num_classes(kind):
    return 2 if kind == "binary" else C


def _assert_value(got, want, case):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, equal_nan=True, **_tolerance(case))


def _args(case, kind):
    kw = dict(CASES[case][2])
    if kind == "binary" and "ignore_index" in kw:
        kw["ignore_index"] = 1
    return kw


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", list(CASES))
def test_functional_matches_jax(case, kind):
    fn, _, _ = CASES[case]
    preds, target = _inputs(kind)[0]
    c, kw = _num_classes(kind), _args(case, kind)
    want = getattr(jfn, fn)(jnp.asarray(preds), jnp.asarray(target), c, **kw)
    _assert_value(getattr(tfn, fn)(preds, target, c, device="cpu", **kw), want, case)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", list(CASES))
def test_modular_matches_jax(case, kind):
    """forward (the batch value) and update, then compute; the confusion
    matrix bit for bit after every batch."""
    _, cls_name, _ = CASES[case]
    c, kw = _num_classes(kind), _args(case, kind)
    jm, tm = getattr(jcls, cls_name)(c, **kw), getattr(tcls, cls_name)(c, device="cpu", **kw)
    for i, (preds, target) in enumerate(_inputs(kind)):
        if i % 2:
            jm.update(jnp.asarray(preds), jnp.asarray(target))
            tm.update(preds, target)
        else:
            _assert_value(tm(preds, target), jm(jnp.asarray(preds), jnp.asarray(target)), case)
        assert tm.confmat.dtype == torch.int32
        np.testing.assert_array_equal(tm.confmat.numpy(), np.asarray(jm.confmat))
    _assert_value(tm.compute(), jm.compute(), case)


@pytest.mark.parametrize("case", ["kappa-quadratic", "jaccard-ignore", "mcc"])
def test_pure_state_api_matches_jax(case):
    """Two halves of the batches accumulated apart and merged: the same
    state and value as the JAX package's, and the input states untouched."""
    _, cls_name, kw = CASES[case]
    jm, tm = getattr(jcls, cls_name)(C, **kw), getattr(tcls, cls_name)(C, device="cpu", **kw)
    batches = _inputs("probs", seed=7)
    halves = []
    for part in (batches[:2], batches[2:]):
        jstate, tstate = jm.init_state(), tm.init_state()
        for preds, target in part:
            jstate = jm.update_state(jstate, jnp.asarray(preds), jnp.asarray(target))
            before = tstate["confmat"].clone()
            new = tm.update_state(tstate, torch.from_numpy(preds), torch.from_numpy(target))
            assert torch.equal(tstate["confmat"], before)  # the input state is never modified
            tstate = new
        np.testing.assert_array_equal(tstate["confmat"].numpy(), np.asarray(jstate["confmat"]))
        _assert_value(tm.compute_state(tstate), jm.compute_state(jstate), case)
        halves.append((jstate, tstate))
    jmerged = jm.merge_states(halves[0][0], halves[1][0])
    tmerged = tm.merge_states(halves[0][1], halves[1][1])
    np.testing.assert_array_equal(tmerged["confmat"].numpy(), np.asarray(jmerged["confmat"]))
    _assert_value(tm.compute_state(tmerged), jm.compute_state(jmerged), case)
    assert int(tm.confmat.sum()) == 0  # the bound state was restored


def test_mcc_near_zero_holds_to_the_absolute_tolerance():
    """Random labels past s = 4096: MCC and kappa near 0 carry float32
    cancellation in both packages; the absolute tolerance holds."""
    rng = np.random.RandomState(11)
    preds, target = rng.randint(0, 10, 6000), rng.randint(0, 10, 6000)
    for fn in ("matthews_corrcoef", "cohen_kappa"):
        want = getattr(jfn, fn)(jnp.asarray(preds), jnp.asarray(target), 10)
        got = getattr(tfn, fn)(preds, target, 10, device="cpu")
        assert abs(float(want)) < 0.05
        _assert_value(got, want, "mcc")


def test_jaccard_zeroes_the_ignored_row_in_a_copy():
    metric = tcls.JaccardIndex(C, ignore_index=0, device="cpu")
    preds, target = _inputs("labels")[0]
    metric.update(preds, target)
    before = metric.confmat.clone()
    metric.compute()
    assert torch.equal(metric.confmat, before) and int(before[0].sum()) > 0


@pytest.mark.parametrize(
    "cls_name, kw, match",
    [
        ("CohenKappa", {"weights": "cubic"}, "Argument weights needs to one of the following"),
        ("JaccardIndex", {"reduction": "median"}, "Reduction parameter unknown"),
    ],
)
def test_errors_match_jax(cls_name, kw, match):
    preds, target = _inputs("labels")[0]
    for cls, wrap, extra in ((getattr(jcls, cls_name), jnp.asarray, {}), (getattr(tcls, cls_name), torch.from_numpy, {"device": "cpu"})):
        with pytest.raises(ValueError, match=match):
            cls(C, **kw, **extra).forward(wrap(preds), wrap(target))


def test_kappa_functional_weights_error_matches_jax():
    preds, target = _inputs("labels")[0]
    match = "should be either None, 'linear' or 'quadratic'"
    with pytest.raises(ValueError, match=match):
        jfn.cohen_kappa(jnp.asarray(preds), jnp.asarray(target), C, weights="cubic")
    with pytest.raises(ValueError, match=match):
        tfn.cohen_kappa(preds, target, C, weights="cubic", device="cpu")


def test_metrics_default_to_the_card():
    for cls in (tcls.CohenKappa, tcls.JaccardIndex, tcls.MatthewsCorrCoef):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(3)
