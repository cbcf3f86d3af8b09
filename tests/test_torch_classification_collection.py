"""bench.py's classification collection in the port and the JAX package.

The six metrics of ``bench_fused`` (Accuracy, macro Precision, Recall and
F1Score, ConfusionMatrix, CohenKappa) plus MatthewsCorrCoef and
JaccardIndex, at a small size: its seed-7 softmax data over 10 classes in
ragged batches, through each package's eager ``MetricCollection.update``.
Both packages form the same compute groups; the leaders' states agree bit
for bit and the values within rtol 1e-6 and atol 1e-7 (kappa and MCC
within atol 1e-5).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import metrics_tpu
import metrics_tpu_torch

torch.set_num_threads(2)

N_CLASSES = 10
SHAPES = (190, 200, 205)


def _batches(seed=7, repeats=2):
    """bench_fused's batch maker (``rng.rand`` rows normalised, then the
    labels), over smaller ragged shapes."""
    rng = np.random.RandomState(seed)
    batches = []
    for n in SHAPES:
        p = rng.rand(n, N_CLASSES).astype(np.float32)
        p /= p.sum(-1, keepdims=True)
        batches.append((p, rng.randint(0, N_CLASSES, n)))
    return batches * repeats


def _collection(pkg, **kw):
    return pkg.MetricCollection(
        [
            pkg.Accuracy(**kw),
            pkg.Precision(num_classes=N_CLASSES, average="macro", **kw),
            pkg.Recall(num_classes=N_CLASSES, average="macro", **kw),
            pkg.F1Score(num_classes=N_CLASSES, average="macro", **kw),
            pkg.ConfusionMatrix(num_classes=N_CLASSES, **kw),
            pkg.CohenKappa(num_classes=N_CLASSES, **kw),
            pkg.MatthewsCorrCoef(num_classes=N_CLASSES, **kw),
            pkg.JaccardIndex(num_classes=N_CLASSES, **kw),
        ]
    )


def _run(updates=None):
    jc, tc = _collection(metrics_tpu), _collection(metrics_tpu_torch, device="cpu")
    for preds, target in _batches()[:updates]:
        jc.update(jnp.asarray(preds), jnp.asarray(target))
        tc.update(preds, target)
    return jc, tc


EXPECTED_GROUPS = [
    ["Accuracy"],
    ["Precision", "Recall", "F1Score"],
    ["ConfusionMatrix", "CohenKappa", "MatthewsCorrCoef", "JaccardIndex"],
]


def test_compute_groups_equal_jax():
    jc, tc = _run(updates=1)
    assert sorted(map(sorted, tc.compute_groups.values())) == sorted(map(sorted, jc.compute_groups.values()))
    assert sorted(map(sorted, tc.compute_groups.values())) == sorted(map(sorted, EXPECTED_GROUPS))


@pytest.mark.parametrize("updates", [1, 6])
def test_values_and_states_match_jax(updates):
    jc, tc = _run(updates)
    for group in tc.compute_groups.values():
        leader = tc[group[0]]
        for name in leader._defaults:
            got, want = getattr(leader, name), np.asarray(getattr(jc[group[0]], name))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{group[0]}.{name}")
    want, got = jc.compute(), tc.compute()
    assert set(want) == set(got)
    for key in want:
        tol = dict(rtol=0, atol=1e-5) if key in ("CohenKappa", "MatthewsCorrCoef") else dict(rtol=1e-6, atol=1e-7)
        w = np.asarray(want[key])
        assert got[key].numpy().dtype == w.dtype, key
        np.testing.assert_allclose(got[key].numpy(), w, err_msg=key, **tol)


def test_the_group_leaders_alone_update():
    """After the first update only one metric per group counts a batch: the
    members' own states stay at the first batch until compute lends them
    the leader's."""
    _, tc = _run(updates=3)
    for group in tc.compute_groups.values():
        for member in group[1:]:
            leader_total = sum(int(getattr(tc[group[0]], s).sum()) for s in tc[group[0]]._defaults)
            member_total = sum(int(getattr(tc[member], s).sum()) for s in tc[member]._defaults)
            assert member_total < leader_total
    values = tc.compute()
    first = _collection(metrics_tpu_torch, device="cpu")
    for preds, target in _batches()[:3]:
        first.update(preds, target)
    for key, value in first.compute().items():
        assert torch.equal(values[key], value), key


def test_accuracy_mode_is_a_public_attribute():
    """Compute groups compare public attributes, so the mode the first
    update fixes is one, as in the JAX package."""
    _, tc = _run(updates=1)
    assert tc["Accuracy"].mode == "multi-class"
    assert "mode" in vars(tc["Accuracy"])
