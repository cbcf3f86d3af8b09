"""The port's exact rank AUROC against the JAX package's, on the CPU.

Per-class values must agree bit for bit: midranks are half-integers and the
rank sums stay far below 2**23 at these sizes, so both packages' sums are
exact whatever their order, and the remaining float32 operations are the
same. The macro/weighted averages sum the per-class values in another
order: they agree to 1e-6.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metrics_tpu.classification import AUROC as JaxAUROC
from metrics_tpu.functional.classification.auroc import (
    auroc_rank_multiclass as jax_auroc,
    auroc_rank_multiclass_masked as jax_auroc_masked,
)
from metrics_tpu_torch import AUROC
from metrics_tpu_torch.functional import auroc_rank_multiclass, auroc_rank_multiclass_masked
from metrics_tpu_torch.utils.exceptions import MetricsUserError

torch.set_num_threads(2)

C = 6
AVERAGES = ["macro", "weighted", "none", None]


def _scores(rng, n, c=C, ties=False):
    if ties:  # few distinct values: long tie runs in every class column
        return (rng.randint(0, 4, (n, c)) / 4).astype(np.float32)
    return rng.rand(n, c).astype(np.float32)


def _compare(got, want, average):
    got, want = got.numpy(), np.asarray(want)
    if average in ("none", None):
        np.testing.assert_array_equal(got, want)  # bit-exact per class
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("case", ["plain", "ties", "missing_classes"])
def test_rank_auroc_matches_jax(average, case):
    rng = np.random.RandomState(len(case) * 10 + AVERAGES.index(average))
    n = 97
    preds = _scores(rng, n, ties=case == "ties")
    # "missing_classes": classes 4 and 5 never occur (no positives: undefined, excluded)
    target = rng.randint(0, 4 if case == "missing_classes" else C, n)
    want = jax_auroc(jnp.asarray(preds), jnp.asarray(target), C, average=average)
    got = auroc_rank_multiclass(torch.from_numpy(preds), torch.from_numpy(target), C, average=average)
    _compare(got, want, average)
    if case == "missing_classes" and average in ("none", None):
        assert torch.isnan(got[4:]).all() and not torch.isnan(got[:4]).any()


@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("fill", ["partial", "holes", "all_invalid"])
def test_masked_rank_auroc_matches_jax(average, fill):
    rng = np.random.RandomState(3 + AVERAGES.index(average))
    n = 120
    preds = _scores(rng, n, ties=True)
    target = rng.randint(0, C, n)
    if fill == "partial":
        valid = np.arange(n) < 70
    elif fill == "holes":
        valid = rng.rand(n) < 0.6
    else:
        valid = np.zeros(n, bool)
    want = jax_auroc_masked(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(valid), C, average=average)
    got = auroc_rank_multiclass_masked(preds, target, valid, C, average=average, device="cpu")
    _compare(got, want, average)
    if fill == "all_invalid":
        assert torch.isnan(got).all()  # never a plausible value from an empty buffer


def test_shape_and_average_errors():
    preds = np.random.RandomState(0).rand(8, C).astype(np.float32)
    target = np.arange(8) % C
    with pytest.raises(ValueError, match="shape"):
        auroc_rank_multiclass(preds, target, C + 1, device="cpu")
    with pytest.raises(ValueError, match="average"):
        auroc_rank_multiclass(preds, target, C, average="micro", device="cpu")


@pytest.mark.parametrize("average", ["macro", "weighted", "none"])
def test_capacity_metric_matches_jax(average):
    rng = np.random.RandomState(21)
    want = JaxAUROC(num_classes=C, capacity=100, average=average)
    got = AUROC(num_classes=C, capacity=100, average=average, device="cpu")
    for n in (30, 25, 40):
        preds, target = _scores(rng, n), rng.randint(0, C, n)
        want.update(jnp.asarray(preds), jnp.asarray(target))
        got.update(torch.from_numpy(preds), torch.from_numpy(target))
    _compare(got.compute(), want.compute(), average)
    assert int(got.valid.sum()) == 95 and got.preds.shape == (100, C)


def test_capacity_fills_the_holes_of_a_restored_buffer():
    """A merged or restored buffer may have holes: new rows go into the
    first free slots, as in the JAX package."""
    rng = np.random.RandomState(4)
    want = JaxAUROC(num_classes=C, capacity=10)
    got = AUROC(num_classes=C, capacity=10, device="cpu")
    valid = np.array([1, 0, 1, 1, 0, 0, 1, 0, 0, 0], bool)
    preds, target = _scores(rng, 10), rng.randint(0, C, 10)
    want.load_state_dict({"preds": preds, "target": target.astype(np.int32), "valid": valid, "overflow": np.int32(0)})
    got.load_state_dict(
        {"preds": torch.from_numpy(preds), "target": torch.from_numpy(target.astype(np.int32)),
         "valid": torch.from_numpy(valid), "overflow": torch.tensor(0, dtype=torch.int32)}
    )
    batch, labels = _scores(rng, 4), rng.randint(0, C, 4)
    want.update(jnp.asarray(batch), jnp.asarray(labels))
    got.update(batch, labels)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.preds.numpy(), np.asarray(want.preds))
    np.testing.assert_array_equal(got.target.numpy(), np.asarray(want.target))


def test_capacity_overflow_raises_and_reset_empties():
    rng = np.random.RandomState(8)
    metric = AUROC(num_classes=C, capacity=50, device="cpu")
    metric.update(_scores(rng, 40), rng.randint(0, C, 40))
    with pytest.raises(MetricsUserError, match="capacity overflow"):
        metric.update(_scores(rng, 11), rng.randint(0, C, 11))
    assert int(metric.valid.sum()) == 40  # the refused batch wrote nothing
    metric.reset()
    assert int(metric.valid.sum()) == 0 and float(metric.preds.abs().sum()) == 0.0
    metric.update(_scores(rng, 50), rng.randint(0, C, 50))
    assert int(metric.valid.sum()) == 50


def test_capacity_label_range_is_checked():
    metric = AUROC(num_classes=C, capacity=10, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        metric.update(np.random.rand(2, C).astype(np.float32), np.array([0, C]))


def test_carried_overflow_tally_raises_at_compute():
    metric = AUROC(num_classes=C, capacity=10, device="cpu")
    state = metric.init_state()
    state["overflow"] = torch.tensor(3, dtype=torch.int32)
    with pytest.raises(MetricsUserError, match="3 sample"):
        metric.compute_state(state)


@pytest.mark.parametrize(
    "kwargs",
    [{"num_classes": C}, {"num_classes": C, "exact": True}, {"capacity": 10}, {"num_classes": 1, "capacity": 10}],
)
def test_modes_of_later_slices_raise_naming_the_roadmap(kwargs):
    """Only ``exact=True`` is left to a later slice; the sketched default
    and the binary capacity mode construct and compute like the JAX
    package's."""
    if kwargs.get("exact"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            AUROC(device="cpu", **kwargs)
        return
    rng = np.random.RandomState(3)
    if kwargs.get("num_classes", 1) >= 2:
        preds, target = _scores(rng, 8), rng.randint(0, C, 8)
    else:
        preds, target = rng.rand(8).astype(np.float32), np.array([0, 1] * 4)
    got, want = AUROC(device="cpu", **kwargs), JaxAUROC(**kwargs)
    got.update(torch.from_numpy(preds), torch.from_numpy(target))
    want.update(jnp.asarray(preds), jnp.asarray(target))
    np.testing.assert_allclose(float(got.compute()), float(want.compute()), atol=1e-6)
