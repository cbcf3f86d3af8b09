"""Explicit compute groups of the port against the JAX package's, on the CPU.

A group whose members cannot take the leader's states as they are (a macro
average grouped under a micro leader: the leader's counts are 0-d, the
member's are per class) raises ``ValueError`` in the port when the
collection is built. The JAX package raises at ``compute()`` instead, by
accident of an axis check; the test pins that difference of when. A valid
explicit group (macro Precision with macro Recall) computes bit-equal to
each member alone, in both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu_torch as tm

torch.set_num_threads(2)

NUM_CLASSES = 4


def _batches(seed=3, n=4, rows=32):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        logits = rng.random((rows, NUM_CLASSES)).astype(np.float32)
        out.append((logits / logits.sum(-1, keepdims=True), rng.integers(0, NUM_CLASSES, rows).astype(np.int32)))
    return out


def _members(pkg, **kw):
    return [
        pkg.Accuracy(num_classes=NUM_CLASSES, **kw),
        pkg.Precision(num_classes=NUM_CLASSES, average="macro", **kw),
        pkg.Recall(num_classes=NUM_CLASSES, average="macro", **kw),
        pkg.ConfusionMatrix(num_classes=NUM_CLASSES, **kw),
    ]


BAD_GROUPS = [["Accuracy", "Precision"], ["Recall"]]


def test_mismatched_group_raises_at_construction_in_the_port():
    with pytest.raises(ValueError, match=r"\['Precision'\].*differ from the leader"):
        tm.MetricCollection(_members(tm, device="cpu"), compute_groups=BAD_GROUPS)


def test_mismatched_group_raises_at_compute_in_the_jax_package():
    """The difference of when: the JAX package builds the collection, takes
    the batches and raises only when the macro member reads the micro
    leader's 0-d counts."""
    col = metrics_tpu.MetricCollection(_members(metrics_tpu), compute_groups=BAD_GROUPS)
    for preds, target in _batches():
        col.update(jnp.asarray(preds), jnp.asarray(target))
    with pytest.raises(ValueError, match="out of bounds"):
        col.compute()


@pytest.mark.parametrize("pkg_name", ["torch", "jax"])
def test_valid_group_equals_each_member_alone(pkg_name):
    pkg, kw = (tm, {"device": "cpu"}) if pkg_name == "torch" else (metrics_tpu, {})
    conv = (lambda a: torch.from_numpy(a)) if pkg_name == "torch" else jnp.asarray
    group = [["Precision", "Recall"]]
    col = pkg.MetricCollection(
        [pkg.Precision(num_classes=NUM_CLASSES, average="macro", **kw), pkg.Recall(num_classes=NUM_CLASSES, average="macro", **kw)],
        compute_groups=group,
    )
    alone = {
        "Precision": pkg.Precision(num_classes=NUM_CLASSES, average="macro", **kw),
        "Recall": pkg.Recall(num_classes=NUM_CLASSES, average="macro", **kw),
    }
    for preds, target in _batches():
        col.update(conv(preds), conv(target))
        for m in alone.values():
            m.update(conv(preds), conv(target))
    values = col.compute()
    for name, m in alone.items():
        got, want = np.asarray(values[name]), np.asarray(m.compute())
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), name


def test_valid_group_agrees_across_packages():
    group = [["Precision", "Recall"]]
    cols = {
        "torch": tm.MetricCollection(
            [tm.Precision(num_classes=NUM_CLASSES, average="macro", device="cpu"), tm.Recall(num_classes=NUM_CLASSES, average="macro", device="cpu")],
            compute_groups=group,
        ),
        "jax": metrics_tpu.MetricCollection(
            [metrics_tpu.Precision(num_classes=NUM_CLASSES, average="macro"), metrics_tpu.Recall(num_classes=NUM_CLASSES, average="macro")],
            compute_groups=group,
        ),
    }
    for preds, target in _batches(seed=5):
        cols["torch"].update(torch.from_numpy(preds), torch.from_numpy(target))
        cols["jax"].update(jnp.asarray(preds), jnp.asarray(target))
    got, want = cols["torch"].compute(), cols["jax"].compute()
    for name in ("Precision", "Recall"):
        # float32 averages of integer counts: the same bits
        np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(want[name]), err_msg=name)
