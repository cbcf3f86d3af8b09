"""The classification losses and the dice score: the port against the JAX package.

``hinge_loss``/``HingeLoss`` (binary, Crammer-Singer, one-vs-all, squared),
``kl_divergence``/``KLDivergence`` (probabilities and ``log_prob``, the
reductions "mean", "sum" and none) and ``dice_score`` (with and without the
background class, the reductions) on the same seeded numpy inputs, within
rtol 1e-6 / atol 1e-6 (float32 sums in the two libraries' orders); the
modular metrics over several batches, ``forward``, the pure-state API and
the state dtypes. Plain torch: no kernel is involved.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import metrics_tpu
import metrics_tpu.functional as jax_functional
import metrics_tpu_torch
import metrics_tpu_torch.functional as torch_functional

torch.set_num_threads(2)

BATCHES, BATCH, CLASSES = 3, 32, 5
RTOL = ATOL = 1e-6


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert str(got.dtype).replace("torch.", "") == str(np.asarray(want).dtype)


def _hinge_inputs(kind, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "binary":
        preds = (rng.rand(BATCHES, BATCH).astype(np.float32) - 0.5) * 4
        target = rng.randint(0, 2, (BATCHES, BATCH))
    else:
        preds = rng.randn(BATCHES, BATCH, CLASSES).astype(np.float32)
        target = rng.randint(0, CLASSES, (BATCHES, BATCH))
    return preds, target


HINGE_CASES = [
    ("binary", {}),
    ("binary", {"squared": True}),
    ("multiclass", {}),
    ("multiclass", {"multiclass_mode": "crammer-singer", "squared": True}),
    ("multiclass", {"multiclass_mode": "one-vs-all"}),
    ("multiclass", {"multiclass_mode": "one-vs-all", "squared": True}),
]


@pytest.mark.parametrize("kind, kwargs", HINGE_CASES)
def test_hinge_loss_functional_matches_jax(kind, kwargs):
    preds, target = _hinge_inputs(kind)
    for i in range(BATCHES):
        got = torch_functional.hinge_loss(torch.from_numpy(preds[i]), torch.from_numpy(target[i]), **kwargs)
        want = jax_functional.hinge_loss(jnp.asarray(preds[i]), jnp.asarray(target[i]), **kwargs)
        _close(got, want)


@pytest.mark.parametrize("kind, kwargs", HINGE_CASES)
def test_hinge_loss_module_matches_jax(kind, kwargs):
    preds, target = _hinge_inputs(kind, seed=1)
    got_metric = metrics_tpu_torch.HingeLoss(device="cpu", **kwargs)
    want_metric = metrics_tpu.HingeLoss(**kwargs)
    for i in range(BATCHES):
        got_batch = got_metric(torch.from_numpy(preds[i]), torch.from_numpy(target[i]))
        want_batch = want_metric(jnp.asarray(preds[i]), jnp.asarray(target[i]))
        _close(got_batch, want_batch)
    _close(got_metric.compute(), want_metric.compute())
    assert got_metric.measure.dtype == torch.float32 and got_metric.total.dtype == torch.int32
    assert int(got_metric.total) == int(want_metric.total) == BATCHES * BATCH


def test_hinge_loss_squeezes_and_rejects_like_jax():
    preds = torch.tensor([[-2.2], [2.4], [0.1]])  # (N, 1) squeezes to binary
    target = torch.tensor([[0], [1], [1]])
    want = jax_functional.hinge_loss(jnp.asarray(preds.numpy()), jnp.asarray(target.numpy()))
    _close(torch_functional.hinge_loss(preds, target), want)
    with pytest.raises(ValueError, match="one or two dimensional"):
        torch_functional.hinge_loss(torch.zeros(2, 3, 4), torch.zeros(2, dtype=torch.long))
    with pytest.raises(ValueError, match="multiclass_mode"):
        metrics_tpu_torch.HingeLoss(multiclass_mode="bogus", device="cpu")


def test_hinge_loss_float64_inputs_give_float32():
    preds, target = _hinge_inputs("multiclass", seed=2)
    got = torch_functional.hinge_loss(torch.from_numpy(preds[0]).double(), torch.from_numpy(target[0]))
    want = jax_functional.hinge_loss(jnp.asarray(preds[0].astype(np.float64)), jnp.asarray(target[0]))
    _close(got, want)


def _kl_inputs(seed=3):
    rng = np.random.RandomState(seed)
    p = rng.rand(BATCHES, BATCH, CLASSES).astype(np.float32) + 0.1
    q = rng.rand(BATCHES, BATCH, CLASSES).astype(np.float32) + 0.1
    return p, q


@pytest.mark.parametrize("log_prob", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none", None])
def test_kl_divergence_functional_matches_jax(log_prob, reduction):
    p, q = _kl_inputs()
    if log_prob:
        p = np.log(p / p.sum(-1, keepdims=True))
        q = np.log(q / q.sum(-1, keepdims=True))
    for i in range(BATCHES):
        got = torch_functional.kl_divergence(torch.from_numpy(p[i]), torch.from_numpy(q[i]), log_prob=log_prob, reduction=reduction)
        want = jax_functional.kl_divergence(jnp.asarray(p[i]), jnp.asarray(q[i]), log_prob=log_prob, reduction=reduction)
        _close(got, want)


@pytest.mark.parametrize("log_prob", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_kl_divergence_module_matches_jax(log_prob, reduction):
    p, q = _kl_inputs(seed=4)
    if log_prob:
        p = np.log(p / p.sum(-1, keepdims=True))
        q = np.log(q / q.sum(-1, keepdims=True))
    got_metric = metrics_tpu_torch.KLDivergence(log_prob=log_prob, reduction=reduction, device="cpu")
    want_metric = metrics_tpu.KLDivergence(log_prob=log_prob, reduction=reduction)
    for i in range(BATCHES):
        _close(
            got_metric(torch.from_numpy(p[i]), torch.from_numpy(q[i])),
            want_metric(jnp.asarray(p[i]), jnp.asarray(q[i])),
        )
    _close(got_metric.compute(), want_metric.compute())
    assert isinstance(got_metric.measures, list) == (reduction == "none")


def test_kl_divergence_contract():
    p = torch.tensor([[0.36, 0.48, 0.16]])
    q = torch.tensor([[1 / 3, 1 / 3, 1 / 3]])
    assert float(torch_functional.kl_divergence(p, q)) == pytest.approx(0.085300, abs=1e-5)
    assert float(torch_functional.kl_divergence(p.log(), q.log(), log_prob=True)) == pytest.approx(0.085300, abs=1e-5)
    with pytest.raises(RuntimeError, match="same shape"):
        torch_functional.kl_divergence(p, q[:, :2])
    with pytest.raises(ValueError, match="2D"):
        torch_functional.kl_divergence(p[0], q[0])
    with pytest.raises(TypeError, match="log_prob"):
        metrics_tpu_torch.KLDivergence(log_prob=1, device="cpu")
    with pytest.raises(ValueError, match="reduction"):
        metrics_tpu_torch.KLDivergence(reduction="max", device="cpu")


@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_dice_score_matches_jax(bg, reduction):
    rng = np.random.RandomState(5)
    for i in range(BATCHES):
        probs = rng.rand(BATCH, CLASSES).astype(np.float32)
        target = rng.randint(0, CLASSES - 1, BATCH)  # the last class never a target: its no_fg_score
        got = torch_functional.dice_score(torch.from_numpy(probs), torch.from_numpy(target), bg=bg, reduction=reduction, no_fg_score=0.25)
        want = jax_functional.dice_score(jnp.asarray(probs), jnp.asarray(target), bg=bg, reduction=reduction, no_fg_score=0.25)
        _close(got, want)


def test_dice_score_contract():
    pred = torch.tensor([[0.85, 0.05, 0.05, 0.05], [0.05, 0.85, 0.05, 0.05], [0.05, 0.05, 0.85, 0.05], [0.05, 0.05, 0.05, 0.85]])
    target = torch.tensor([0, 1, 3, 2])
    assert float(torch_functional.dice_score(pred, target)) == pytest.approx(0.3333333, abs=1e-5)
    assert float(torch_functional.dice_score(pred, target, bg=True)) == pytest.approx(0.5, abs=1e-5)


def test_losses_fuse_in_a_collection():
    """HingeLoss and KLDivergence run inside the fused update (its plain
    version on the CPU) with the eager update's bits."""
    preds, target = _hinge_inputs("multiclass", seed=6)
    make = lambda: metrics_tpu_torch.MetricCollection([metrics_tpu_torch.HingeLoss(device="cpu")])
    eager, fused = make(), make()
    handle = fused.compile_update(buckets=(BATCH,))
    for i in range(BATCHES):
        n = BATCH - i  # ragged: padded to the bucket
        batch = (torch.from_numpy(preds[i, :n]), torch.from_numpy(target[i, :n]))
        eager.update(*batch)
        fused.update(*batch)
    assert handle.cache_size == 1 and not handle.declined
    assert torch.equal(eager["HingeLoss"].total, fused["HingeLoss"].total)
    torch.testing.assert_close(eager.compute()["HingeLoss"], fused.compute()["HingeLoss"], rtol=1e-6, atol=1e-6)
