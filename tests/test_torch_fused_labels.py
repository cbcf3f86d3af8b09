"""The fused update on label inputs: the confusion-matrix family,
HammingDistance and R2Score under the port's ``compile_update`` against the
JAX package's, on the CPU.

For each member the port takes the JAX package's decision (fused, or the
eager leg after a failed probe), gives no stale-manifest warning where the
JAX package gives none, and computes the same values (counts bit for bit,
floats within 1e-6). On the CPU the port's fused entry runs its plain
function under the capture rule of ``utils/checks.py``, as the JAX package
traces under jit: integer labels cannot tell their class count there, so
the confusion family formats them with its own ``num_classes`` (the retry
both packages take), and a member without one (``Accuracy()``,
``HammingDistance`` on integer rows) goes to the eager leg in both.
"""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import metrics_tpu as mt
import metrics_tpu_torch as tm
from metrics_tpu_torch.analysis.manifest import manifest_verdict

torch.set_num_threads(2)

ROWS = 16
BATCHES = 4


def label_inputs(case: str, seed: int):
    """``(num_classes, batches)``: binary ints, multiclass [N] labels over
    4 classes, multidim [N, 3] labels, integer multilabel [N, 4] rows, or
    float multilabel [N, 4] scores with binary targets."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(BATCHES):
        if case == "binary":
            out.append((rng.integers(0, 2, ROWS), rng.integers(0, 2, ROWS)))
        elif case == "multiclass":
            out.append((rng.integers(0, 4, ROWS), rng.integers(0, 4, ROWS)))
        elif case == "multidim":
            out.append((rng.integers(0, 4, (ROWS, 3)), rng.integers(0, 4, (ROWS, 3))))
        elif case == "multilabel-int":
            out.append((rng.integers(0, 2, (ROWS, 4)), rng.integers(0, 2, (ROWS, 4))))
        else:  # multilabel-float
            out.append((rng.random((ROWS, 4)).astype(np.float32), rng.integers(0, 2, (ROWS, 4))))
    return (2 if case == "binary" else 4), out


def run_fused(pkg, members, batches, to_tensor):
    """A collection of ``members``: one eager update, ``compile_update()``,
    then the other batches. Returns (members on the eager leg, values, the
    warning messages)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        col = pkg.MetricCollection(members)
        col.update(*map(to_tensor, batches[0]))
        handle = col.compile_update()
        for batch in batches[1:]:
            col.update(*map(to_tensor, batch))
        values = col.compute()
    return set(handle._eager_names), values, [str(w.message) for w in caught]


def stale(messages):
    return [m for m in messages if "fusibility manifest" in m]


def assert_same_values(got, want):
    assert set(got) == set(want)
    for key in want:
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape, key
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=1e-6, atol=1e-6, equal_nan=True, err_msg=key)


#: name -> (JAX maker, port maker) over num_classes
FAMILY = {
    "ConfusionMatrix": (lambda c: mt.ConfusionMatrix(num_classes=c), lambda c: tm.ConfusionMatrix(num_classes=c, device="cpu")),
    "ConfusionMatrix-normalize": (
        lambda c: mt.ConfusionMatrix(num_classes=c, normalize="true"),
        lambda c: tm.ConfusionMatrix(num_classes=c, normalize="true", device="cpu"),
    ),
    "CohenKappa": (lambda c: mt.CohenKappa(num_classes=c), lambda c: tm.CohenKappa(num_classes=c, device="cpu")),
    "JaccardIndex": (lambda c: mt.JaccardIndex(num_classes=c), lambda c: tm.JaccardIndex(num_classes=c, device="cpu")),
    "MatthewsCorrCoef": (lambda c: mt.MatthewsCorrCoef(num_classes=c), lambda c: tm.MatthewsCorrCoef(num_classes=c, device="cpu")),
}


@pytest.mark.parametrize("case", ["binary", "multiclass", "multidim"])
@pytest.mark.parametrize("which", sorted(FAMILY))
def test_confusion_family_fuses_on_labels_as_jax_does(which, case):
    num_classes, batches = label_inputs(case, sorted(FAMILY).index(which) + 3 * len(case))
    jax_make, port_make = FAMILY[which]
    jax_eager, jax_values, jax_warned = run_fused(mt, [jax_make(num_classes)], batches, jnp.asarray)
    eager, values, warned = run_fused(tm, [port_make(num_classes)], batches, torch.from_numpy)
    assert eager == jax_eager == set()
    assert not stale(warned) and not stale(jax_warned)
    assert_same_values(values, jax_values)


@pytest.mark.parametrize("case", ["binary", "multiclass", "multidim", "multilabel-int", "multilabel-float"])
def test_hamming_distance_takes_the_jax_decision(case):
    _, batches = label_inputs(case, 20 + len(case))
    jax_eager, jax_values, jax_warned = run_fused(mt, [mt.HammingDistance()], batches, jnp.asarray)
    eager, values, warned = run_fused(tm, [tm.HammingDistance(device="cpu")], batches, torch.from_numpy)
    assert eager == jax_eager
    # integer rows cannot be formatted without num_classes under capture:
    # both packages' probes send the member to the eager leg
    assert eager == ({"HammingDistance"} if case != "multilabel-float" else set())
    assert not stale(warned) and not stale(jax_warned)
    assert_same_values(values, jax_values)


def test_hamming_distance_verdict_agrees_with_its_capture():
    """The manifest no longer proves HammingDistance fusible (its capture
    refuses integer rows), so the handle probes it, as the JAX package's
    ``unknown`` verdict does."""
    assert manifest_verdict(tm.HammingDistance) == "unknown"
    for cls in (tm.ConfusionMatrix, tm.CohenKappa, tm.JaccardIndex, tm.MatthewsCorrCoef):
        assert manifest_verdict(cls) == "fusible", cls.__name__


@pytest.mark.parametrize("case", ["binary", "multiclass"])
def test_mixed_collection_on_labels_takes_the_jax_decisions(case):
    """fused_collection's eight metrics of the card's fused phases on labels:
    Accuracy() (no num_classes) goes to the eager leg in both packages, the
    other seven fuse, with no stale-manifest warning."""
    c = 4
    _, batches = label_inputs(case, 31 + len(case))
    if case == "binary":
        batches = [(p * 3, t * 2) for p, t in batches]  # labels over 4 classes

    def members(pkg, **kw):
        return [
            pkg.Accuracy(**kw),
            pkg.Precision(num_classes=c, average="macro", **kw),
            pkg.Recall(num_classes=c, average="macro", **kw),
            pkg.F1Score(num_classes=c, average="macro", **kw),
            pkg.ConfusionMatrix(num_classes=c, **kw),
            pkg.CohenKappa(num_classes=c, **kw),
            pkg.MatthewsCorrCoef(num_classes=c, **kw),
            pkg.JaccardIndex(num_classes=c, **kw),
        ]

    jax_eager, jax_values, jax_warned = run_fused(mt, members(mt), batches, jnp.asarray)
    eager, values, warned = run_fused(tm, members(tm, device="cpu"), batches, torch.from_numpy)
    assert eager == jax_eager == {"Accuracy"}
    assert not stale(warned) and not stale(jax_warned)
    assert_same_values(values, jax_values)


@pytest.mark.parametrize("adjusted", [0, 1])
def test_r2_score_fuses_as_jax_does(adjusted):
    rng = np.random.default_rng(50 + adjusted)
    batches = [((rng.integers(-16, 16, ROWS) / 8).astype(np.float32), (rng.integers(-16, 16, ROWS) / 8).astype(np.float32)) for _ in range(BATCHES)]
    jax_eager, jax_values, jax_warned = run_fused(mt, [mt.R2Score(adjusted=adjusted)], batches, jnp.asarray)
    eager, values, warned = run_fused(tm, [tm.R2Score(adjusted=adjusted, device="cpu")], batches, torch.from_numpy)
    assert eager == jax_eager == set()
    assert not stale(warned) and not stale(jax_warned)
    assert_same_values(values, jax_values)


@pytest.mark.parametrize("which", sorted(FAMILY))
def test_eager_label_errors_are_unchanged(which):
    """The retry keys on the capture rule's refusal only: an eager negative
    label still raises the formatter's error, in both packages."""
    jax_make, port_make = FAMILY[which]
    for metric, as_array in ((jax_make(3), jnp.asarray), (port_make(3), torch.as_tensor)):
        with pytest.raises(ValueError, match="has to be a non-negative tensor"):
            metric.update(as_array(np.array([0, 1, 2])), as_array(np.array([0, -1, 2])))
