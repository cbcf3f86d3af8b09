"""The port's ConfusionMatrix against the JAX package's, on the CPU.

Same seeded numpy inputs to both packages, through the stateful API
(forward/update/compute) and the pure-state API (init_state/update_state/
compute_state). Counts are int32 on both sides and must agree bit for
bit; normalized matrices are the same float32 divisions of those counts.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metrics_tpu.classification import ConfusionMatrix as JaxConfusionMatrix
from metrics_tpu.functional.classification.confusion_matrix import confusion_matrix as jax_confusion_matrix
from metrics_tpu_torch import ConfusionMatrix
from metrics_tpu_torch.functional import confusion_matrix

torch.set_num_threads(2)

C = 5
N = 40


def _probs(rng, n=N, c=C):
    logits = rng.rand(n, c).astype(np.float32) * 4
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _inputs(kind, rng):
    if kind == "probs":
        return _probs(rng), rng.randint(0, C, N)
    if kind == "labels":
        return rng.randint(0, C, N), rng.randint(0, C, N)
    if kind == "ties":
        # rows with tied maxima (the lower index wins), an all-equal row, signed zeros
        p = np.round(rng.rand(N, C) * 2).astype(np.float32) / 2
        p[0] = 0.25
        p[1] = [0.0, -0.0, -1.0, -0.0, 0.0]
        return p, rng.randint(0, C, N)
    if kind == "binary":
        return rng.rand(N).astype(np.float32), rng.randint(0, 2, N)
    if kind == "multidim":
        return rng.rand(N, C, 3).astype(np.float32), rng.randint(0, C, (N, 3))
    raise ValueError(kind)


def _num_classes(kind):
    return 2 if kind == "binary" else C


@pytest.mark.parametrize("kind", ["probs", "labels", "ties", "binary", "multidim"])
@pytest.mark.parametrize("normalize", [None, "true", "pred", "all"])
def test_functional_matches_jax(kind, normalize):
    rng = np.random.RandomState(sum(map(ord, f"{kind}{normalize}")))
    preds, target = _inputs(kind, rng)
    c = _num_classes(kind)
    want = np.asarray(jax_confusion_matrix(jnp.asarray(preds), jnp.asarray(target), c, normalize=normalize))
    got = confusion_matrix(preds, target, c, normalize=normalize, device="cpu").numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_multilabel_matches_jax():
    rng = np.random.RandomState(11)
    preds = rng.rand(N, C).astype(np.float32)
    target = rng.randint(0, 2, (N, C))
    want = JaxConfusionMatrix(num_classes=C, multilabel=True)
    got = ConfusionMatrix(num_classes=C, multilabel=True, device="cpu")
    for lo in (0, 20):
        want.update(jnp.asarray(preds[lo : lo + 20]), jnp.asarray(target[lo : lo + 20]))
        got.update(preds[lo : lo + 20], target[lo : lo + 20])
    assert got.compute().shape == (C, 2, 2)
    np.testing.assert_array_equal(got.compute().numpy(), np.asarray(want.compute()))


@pytest.mark.parametrize("kind", ["probs", "labels", "ties"])
def test_stateful_forward_update_compute_match_jax(kind):
    rng = np.random.RandomState(5)
    want = JaxConfusionMatrix(num_classes=C)
    got = ConfusionMatrix(num_classes=C, device="cpu")
    for _ in range(3):
        preds, target = _inputs(kind, rng)
        batch_want = want(jnp.asarray(preds), jnp.asarray(target))
        batch_got = got(torch.from_numpy(np.asarray(preds)), torch.from_numpy(np.asarray(target)))
        np.testing.assert_array_equal(batch_got.numpy(), np.asarray(batch_want))
    np.testing.assert_array_equal(got.compute().numpy(), np.asarray(want.compute()))
    assert got.compute().dtype == torch.int32
    got.reset()
    assert int(got.confmat.sum()) == 0


def test_pure_state_api_matches_jax():
    rng = np.random.RandomState(9)
    jax_metric = JaxConfusionMatrix(num_classes=C, normalize="true")
    metric = ConfusionMatrix(num_classes=C, normalize="true", device="cpu")
    jax_state, state = jax_metric.init_state(), metric.init_state()
    for _ in range(4):
        preds, target = _inputs("probs", rng)
        jax_state = jax_metric.update_state(jax_state, jnp.asarray(preds), jnp.asarray(target))
        before = state["confmat"].clone()
        new_state = metric.update_state(state, torch.from_numpy(preds), torch.from_numpy(target))
        assert torch.equal(state["confmat"], before)  # the input state is never modified
        state = new_state
    np.testing.assert_array_equal(state["confmat"].numpy(), np.asarray(jax_state["confmat"]))
    np.testing.assert_array_equal(metric.compute_state(state).numpy(), np.asarray(jax_metric.compute_state(jax_state)))
    assert int(metric.confmat.sum()) == 0  # the bound state was restored


def test_nan_rows_pick_what_jax_top1_picks():
    """Rows holding NaNs: the JAX package's top-1 ranks by IEEE totalOrder
    (+NaN above everything, -NaN below everything), and so does the port."""
    preds = np.array(
        [
            [0.1, np.nan, 0.5, np.nan],
            [np.nan, np.nan, np.nan, np.nan],
            [0.2, 0.9, -np.nan, 0.9],
            [-np.nan, 0.3, np.nan, 0.1],
            [-np.nan, -np.nan, -np.nan, -np.nan],
        ],
        np.float32,
    )
    target = np.array([0, 1, 2, 3, 0])
    want = np.asarray(jax_confusion_matrix(jnp.asarray(preds), jnp.asarray(target), 4))
    got = confusion_matrix(preds, target, 4, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


_SCORES = np.random.RandomState(2).rand(6, 3).astype(np.float32)


@pytest.mark.parametrize(
    "preds,target,match",
    [
        (_SCORES, np.array([0, 1, 2, 0, 1, 3]), "smaller than the size"),
        (_SCORES, np.array([0, 1, -2, 0, 1, 1]), "non-negative"),
        (_SCORES, _SCORES[:, 0], "integer tensor"),
        (np.array([0, 1, -1]), np.array([0, 1, 1]), "non-negative"),
    ],
)
def test_value_errors_match_jax(preds, target, match):
    with pytest.raises(ValueError, match=match):
        jax_confusion_matrix(jnp.asarray(preds), jnp.asarray(target), 3)
    with pytest.raises(ValueError, match=match):
        confusion_matrix(preds, target, 3, device="cpu")


def test_bad_normalize_raises():
    with pytest.raises(ValueError, match="Argument average"):
        ConfusionMatrix(num_classes=3, normalize="rows", device="cpu")


def test_metric_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ConfusionMatrix(num_classes=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        confusion_matrix(np.array([0, 1]), np.array([0, 1]), 2)
