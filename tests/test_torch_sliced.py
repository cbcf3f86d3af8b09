"""The port's SlicedMetric (with MeanSquaredError and PeakSignalNoiseRatio)
against the JAX package's, on seeded numpy inputs.

States are held bit for bit on dyadic data (every pixel a multiple of
1/16, so every partial sum is exact in float32 whatever the order: the port
sums squared error by a fixed pairwise tree, XLA in its own order), and
within rtol 1e-6 on uniform float data. Values (``compute()`` and its subset
and top-k reads, ``hot_slices``) are held within 1e-6; slice ids exactly,
ties included. The JAX side runs as its own tests run it on the CPU (its
segment max/min route takes ``jax.ops.segment_max/min`` there).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metrics_tpu import MeanSquaredError as JaxMSE
from metrics_tpu import PeakSignalNoiseRatio as JaxPSNR
from metrics_tpu.functional import mean_squared_error as jax_mean_squared_error
from metrics_tpu.functional import peak_signal_noise_ratio as jax_peak_signal_noise_ratio
from metrics_tpu.sliced import SlicedMetric as JaxSliced
from metrics_tpu.windowed import WindowedMetric as JaxWindowed
from metrics_tpu_torch import MeanSquaredError, MetricCollection, PeakSignalNoiseRatio, SlicedMetric, WindowedMetric
from metrics_tpu_torch.convert import state_from_jax
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_max, dim_zero_min
from metrics_tpu_torch.utils.exceptions import MetricsUserError

torch.set_num_threads(2)

IMAGE = (3, 8, 8)
METRICS = {
    "mse": (JaxMSE, lambda: MeanSquaredError(device="cpu")),
    "psnr": (JaxPSNR, lambda: PeakSignalNoiseRatio(device="cpu")),
}


def _batch(rng: np.random.Generator, b: int, s: int, dyadic: bool):
    """Row-aligned (slice ids, preds, target): ids over [-1, s + 1), so some
    drop; dyadic pixels are multiples of 1/16 in [0, 1)."""
    ids = rng.integers(-1, s + 1, b).astype(np.int32)
    if dyadic:
        preds = (rng.integers(0, 16, (b,) + IMAGE) / 16).astype(np.float32)
        target = (rng.integers(0, 16, (b,) + IMAGE) / 16).astype(np.float32)
    else:
        target = rng.random((b,) + IMAGE, dtype=np.float32)
        preds = (target + 0.05 * rng.standard_normal((b,) + IMAGE)).astype(np.float32)
    return ids, preds, target


def _pair(which: str, s: int):
    jax_cls, port = METRICS[which]
    return JaxSliced(jax_cls(), num_slices=s), SlicedMetric(port(), num_slices=s)


def _feed(jax_metric, metric, batches):
    for ids, preds, target in batches:
        jax_metric.update(jnp.asarray(ids), jnp.asarray(preds), jnp.asarray(target))
        metric.update(torch.from_numpy(ids), torch.from_numpy(preds), torch.from_numpy(target))


def _states(metric) -> dict:
    return {k: np.asarray(v) for k, v in metric.state_dict().items()}


@pytest.mark.parametrize("which", ["mse", "psnr"])
@pytest.mark.parametrize("s", [3, 100])
@pytest.mark.parametrize("b", [7, 300])
def test_states_bit_identical_to_jax(which, s, b):
    rng = np.random.default_rng(s * 1000 + b)
    jax_metric, metric = _pair(which, s)
    _feed(jax_metric, metric, [_batch(rng, b, s, dyadic=True) for _ in range(3)])
    want, got = _states(jax_metric), {k: v.numpy() for k, v in metric.state_dict().items()}
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype and got[name].shape == want[name].shape, name
        np.testing.assert_array_equal(got[name].view(np.int32), want[name].view(np.int32), err_msg=name)
    np.testing.assert_allclose(metric.compute().numpy(), np.asarray(jax_metric.compute()), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("which", ["mse", "psnr"])
def test_reads_match_jax_on_float_data(which):
    s = 40
    rng = np.random.default_rng(5)
    jax_metric, metric = _pair(which, s)
    batches = [_batch(rng, 64, s, dyadic=False) for _ in range(3)]
    # equal counts on several slices, so top-k has ties to break
    batches.append((np.repeat(np.arange(s, dtype=np.int32), 2), *_batch(rng, 2 * s, s, dyadic=False)[1:]))
    _feed(jax_metric, metric, batches)
    for name, want in _states(jax_metric).items():
        np.testing.assert_allclose(metric.state_dict()[name].numpy(), want, rtol=1e-6, atol=0, err_msg=name)
    values = metric.compute().numpy()
    np.testing.assert_allclose(values, np.asarray(jax_metric.compute()), rtol=1e-6, atol=1e-6)
    subset = np.array([3, 0, 39, 3, 17], np.int32)
    np.testing.assert_allclose(
        metric.compute(slice_ids=torch.from_numpy(subset)).numpy(),
        np.asarray(jax_metric.compute(slice_ids=jnp.asarray(subset))),
        rtol=1e-6,
        atol=1e-6,
    )
    np.testing.assert_array_equal(metric.compute(slice_ids=torch.from_numpy(subset)).numpy(), values[subset])
    counts = metric.slice_counts.numpy()
    assert len(set(counts.tolist())) < s  # tied counts
    for k in (1, 5, 40, 64):
        jax_ids, jax_values = jax_metric.compute(top_k=k)
        ids, top_values = metric.compute(top_k=k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jax_ids))
        np.testing.assert_allclose(top_values.numpy(), np.asarray(jax_values), rtol=1e-6, atol=1e-6)
        jax_hot, jax_share = jax_metric.hot_slices(k)
        hot, share = metric.hot_slices(k)
        np.testing.assert_array_equal(hot.numpy(), np.asarray(jax_hot))
        np.testing.assert_allclose(share.numpy(), np.asarray(jax_share), rtol=1e-6)


def test_subset_reads_reject_out_of_range_ids():
    _, metric = _pair("mse", 5)
    metric.update(torch.tensor([0, 4]), torch.ones(2, 3), torch.zeros(2, 3))
    for bad in ([0, 5], [-1]):
        with pytest.raises(MetricsUserError, match="out of range"):
            metric.compute(slice_ids=torch.tensor(bad))
    with pytest.raises(MetricsUserError, match="either"):
        metric.compute(slice_ids=torch.tensor([0]), top_k=1)
    with pytest.raises(MetricsUserError, match="positive int"):
        metric.compute(top_k=0)
    assert metric.compute(slice_ids=torch.tensor([], dtype=torch.int64)).shape == (0,)


@pytest.mark.parametrize(
    "make_jax,make,match",
    [
        (lambda: JaxPSNR(data_range=1.0, dim=1), lambda: PeakSignalNoiseRatio(data_range=1.0, dim=1, device="cpu"), "list \\('cat'\\) state"),
        (lambda: JaxPSNR(data_range=1.0), lambda: PeakSignalNoiseRatio(data_range=1.0, device="cpu"), "reducer `dim_zero_mean`"),
        (lambda: JaxSliced(JaxMSE(), 2), lambda: SlicedMetric(MeanSquaredError(device="cpu"), 2), "cannot wrap another SlicedMetric"),
        (lambda: JaxWindowed(JaxMSE()), lambda: WindowedMetric(MeanSquaredError(device="cpu")), "reducer `ring_sum`"),
    ],
)
def test_construction_errors_match_jax(make_jax, make, match):
    with pytest.raises(Exception, match=match):  # the JAX package's own MetricsUserError
        JaxSliced(make_jax(), 4)
    with pytest.raises(MetricsUserError, match=match):
        SlicedMetric(make(), 4)


def test_construction_argument_errors():
    with pytest.raises(MetricsUserError, match="wraps a Metric"):
        SlicedMetric(object(), 3)
    for bad in (0, -1, 2.0, True):
        with pytest.raises(MetricsUserError, match="positive int"):
            SlicedMetric(MeanSquaredError(device="cpu"), bad)


def test_update_argument_errors():
    _, metric = _pair("mse", 3)
    with pytest.raises(MetricsUserError, match="1-D"):
        metric.update(torch.zeros((2, 1), dtype=torch.int64), torch.ones(2), torch.ones(2))
    with pytest.raises(MetricsUserError, match="integer-typed"):
        metric.update(torch.zeros(2), torch.ones(2), torch.ones(2))
    with pytest.raises(MetricsUserError, match="row-aligned"):
        metric.update(torch.zeros(3, dtype=torch.int64), torch.ones(2), torch.ones(2))


class _HostReadMean(Metric):
    """A metric whose update reads a value back to the host: it cannot vmap."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("total", default=0.0, dist_reduce_fx="sum")

    def _update(self, x):
        self.total = self.total + float(x.sum())

    def _compute(self):
        return self.total


def test_a_template_that_cannot_vmap_raises():
    metric = SlicedMetric(_HostReadMean(device="cpu"), 3)
    with pytest.raises(MetricsUserError, match="cannot be vmapped"):
        metric.update(torch.tensor([0, 1]), torch.ones(2))


def test_merge_states_reset_and_state_dict_match_jax():
    s = 10
    rng = np.random.default_rng(9)
    halves = [[_batch(rng, 30, s, dyadic=True) for _ in range(2)] for _ in range(2)]
    jax_parts, parts = zip(*(_pair("psnr", s) for _ in range(2)))
    for jm, m, batches in zip(jax_parts, parts, halves):
        _feed(jm, m, batches)
    merged = parts[0].merge_states(parts[0].state_dict(), parts[1].state_dict())
    jax_merged = jax_parts[0].merge_states(jax_parts[0].state_dict(), jax_parts[1].state_dict())
    for name, want in jax_merged.items():
        np.testing.assert_array_equal(merged[name].numpy(), np.asarray(want), err_msg=name)
    whole = SlicedMetric(PeakSignalNoiseRatio(device="cpu"), s)
    for ids, preds, target in halves[0] + halves[1]:
        whole.update(torch.from_numpy(ids), torch.from_numpy(preds), torch.from_numpy(target))
    for name, value in whole.state_dict().items():
        assert torch.equal(merged[name], value), name
    np.testing.assert_allclose(whole.compute_state(merged).numpy(), whole.compute().numpy(), rtol=0, atol=0)
    # reset restores the defaults and a fresh read folds every slice again
    parts[0].reset()
    for name, value in parts[0].state_dict().items():
        assert torch.equal(value, SlicedMetric(PeakSignalNoiseRatio(device="cpu"), s).state_dict()[name])
    assert bool(parts[0]._dirty.all())
    # a restored state dict reads like the original
    restored = SlicedMetric(PeakSignalNoiseRatio(device="cpu"), s)
    restored.load_state_dict(whole.state_dict())
    np.testing.assert_array_equal(restored.compute().numpy(), whole.compute().numpy())


def test_state_from_jax_round_trip():
    s = 6
    rng = np.random.default_rng(4)
    jax_metric, metric = _pair("psnr", s)
    batches = [_batch(rng, 20, s, dyadic=True) for _ in range(3)]
    _feed(jax_metric, SlicedMetric(PeakSignalNoiseRatio(device="cpu"), s), batches[:2])
    for ids, preds, target in batches[:2]:
        jax_metric.update(jnp.asarray(ids), jnp.asarray(preds), jnp.asarray(target))
    state = state_from_jax({k: np.asarray(v) for k, v in jax_metric.state_dict().items()}, metric)
    assert state["min_target"].shape == (s,) and state["_slice_rows"].dtype == torch.int32
    np.testing.assert_allclose(metric.compute_state(state).numpy(), np.asarray(jax_metric.compute()), rtol=1e-6)
    # continue the epoch in the port
    ids, preds, target = batches[2]
    state = metric.update_state(state, torch.from_numpy(ids), torch.from_numpy(preds), torch.from_numpy(target))
    jax_metric.update(jnp.asarray(ids), jnp.asarray(preds), jnp.asarray(target))
    for name, want in jax_metric.state_dict().items():
        np.testing.assert_array_equal(state[name].numpy(), np.asarray(want), err_msg=name)


def test_compute_state_folds_the_given_state_not_the_kept_values():
    """The JAX package's compute_state can serve the per-slice values of an
    earlier fold (see test_torch_windowed.py); the port's folds the state
    it is given."""
    rng = np.random.default_rng(8)
    metric = SlicedMetric(PeakSignalNoiseRatio(device="cpu"), 4)
    other = SlicedMetric(PeakSignalNoiseRatio(device="cpu"), 4)
    for m in (metric, other):
        ids, preds, target = _batch(rng, 40, 4, dyadic=False)
        m.update(torch.from_numpy(ids), torch.from_numpy(preds), torch.from_numpy(target))
    first = metric.compute()
    assert not bool(metric._dirty[:4].any())
    got = metric.compute_state(other.state_dict())
    assert torch.equal(got, other.compute())
    assert not torch.equal(got, first)
    assert torch.equal(metric.compute(), first)


def test_updates_mark_exactly_the_written_slices_dirty():
    metric = SlicedMetric(MeanSquaredError(device="cpu"), 6)
    metric.update(torch.tensor([0, 1, 2, 3, 4, 5]), torch.ones(6), torch.zeros(6))
    metric.compute()
    metric.update(torch.tensor([4, 1, -1, 6, 4]), torch.ones(5), torch.zeros(5))
    assert metric._dirty[:6].tolist() == [False, True, False, False, True, False]
    _, folded = metric._fold_slices(np.arange(6))
    assert folded == 2
    np.testing.assert_array_equal(metric.compute().numpy(), np.ones(6, np.float32))


@pytest.mark.parametrize("which", sorted(METRICS))
def test_reads_between_updates_fold_only_the_dirty_slices(which):
    """A read after each update folds the written slices among those it
    asks for and leaves the others dirty; every read equals the same read
    of a fresh metric fed the same updates."""
    s = 100
    rng = np.random.default_rng(21)
    batches = [_batch(rng, 40, s, dyadic=False) for _ in range(4)]
    make = METRICS[which][1]
    metric = SlicedMetric(make(), s)
    subset = np.array([0, 5, 50, 99, 5, 63])
    dirty = np.ones(s, bool)
    for i, (ids, preds, target) in enumerate(batches):
        metric.update(torch.from_numpy(ids), torch.from_numpy(preds), torch.from_numpy(target))
        dirty[ids[(ids >= 0) & (ids < s)]] = True
        fresh = SlicedMetric(make(), s)
        for batch in batches[: i + 1]:
            fresh.update(*(torch.from_numpy(x) for x in batch))
        for name, value in fresh.state_dict().items():
            assert torch.equal(metric.state_dict()[name], value), name
        want = fresh.compute().numpy()
        np.testing.assert_array_equal(metric._dirty[:s].numpy(), dirty)
        np.testing.assert_allclose(metric.compute(slice_ids=torch.from_numpy(subset)).numpy(), want[subset], rtol=1e-6)
        dirty[subset] = False
        np.testing.assert_array_equal(metric._dirty[:s].numpy(), dirty)
        if i % 2:  # every other update is read in full as well
            np.testing.assert_allclose(metric.compute().numpy(), want, rtol=1e-6)
            dirty[:] = False
            assert not bool(metric._dirty[:s].any())


def test_signed_zero_folds_follow_jax():
    """jnp.max/jnp.maximum give +0.0 over -0.0 and jnp.min/jnp.minimum -0.0
    over +0.0, in either order; torch.amax/torch.maximum keep the first zero
    they meet. The port's dim_zero_max/min and merge_states follow JAX."""
    both_orders = torch.tensor([[-0.0, 0.0], [0.0, -0.0]])
    assert torch.signbit(dim_zero_max(both_orders)).tolist() == [False, False]
    assert torch.signbit(dim_zero_min(both_orders)).tolist() == [True, True]
    metric = PeakSignalNoiseRatio(device="cpu")
    jax_metric = JaxPSNR()
    a = dict(metric.init_state(), min_target=torch.tensor(0.0), max_target=torch.tensor(-0.0))
    b = dict(metric.init_state(), min_target=torch.tensor(-0.0), max_target=torch.tensor(0.0))
    for first, second in ((a, b), (b, a)):
        merged = metric.merge_states(first, second)
        jax_merged = jax_metric.merge_states(
            {k: jnp.asarray(v.numpy()) for k, v in first.items()}, {k: jnp.asarray(v.numpy()) for k, v in second.items()}
        )
        for name in ("min_target", "max_target"):
            assert bool(torch.signbit(merged[name])) == bool(np.signbit(np.asarray(jax_merged[name]))), name
        assert bool(torch.signbit(merged["min_target"])) and not bool(torch.signbit(merged["max_target"]))
    nan = metric.merge_states(dict(a, max_target=torch.tensor(float("nan"))), b)
    assert torch.isnan(nan["max_target"])


def test_collection_keeps_differently_configured_templates_apart():
    members = {
        "rmse": SlicedMetric(MeanSquaredError(squared=False, device="cpu"), 4),
        "mse": SlicedMetric(MeanSquaredError(device="cpu"), 4),
        "mse_again": SlicedMetric(MeanSquaredError(device="cpu"), 4),
    }
    collection = MetricCollection(members)
    collection.update(torch.tensor([0, 1, 3]), torch.ones(3, 2), torch.zeros(3, 2))
    groups = sorted(sorted(g) for g in collection.compute_groups.values())
    assert groups == [["mse", "mse_again"], ["rmse"]]
    values = collection.compute()
    np.testing.assert_array_equal(values["mse"].numpy(), values["mse_again"].numpy())
    np.testing.assert_array_equal(values["rmse"].numpy(), np.sqrt(values["mse"].numpy()))


@pytest.mark.parametrize("which", ["mse", "psnr"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_precision_states_match_jax(which, dtype):
    """Half-precision images (the card's natural output dtype) through the
    sliced MSE/PSNR parity. The JAX package turns a torch bfloat16 input into
    float32 before anything else, so on dyadic data the states are equal bit
    for bit. A float16 input stays float16 there and its sums are float16
    (a property of the reference); the port widens both dtypes to float32,
    so its float16 states are float32 and agree within 2e-3 relative."""
    s = 20
    rng = np.random.default_rng(17)
    jax_metric, metric = _pair(which, s)
    for ids, preds, target in (_batch(rng, 60, s, dyadic=True) for _ in range(3)):
        ids, preds, target = torch.from_numpy(ids), torch.from_numpy(preds).to(dtype), torch.from_numpy(target).to(dtype)
        jax_metric.update(ids, preds, target)  # torch tensors: the reference's own coercion
        metric.update(ids, preds, target)
    want, got = _states(jax_metric), {k: v.numpy() for k, v in metric.state_dict().items()}
    assert got["sum_squared_error"].dtype == np.float32
    for name in want:
        if dtype == torch.bfloat16 or want[name].dtype != np.float16:
            assert got[name].dtype == want[name].dtype, name
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        else:
            np.testing.assert_allclose(got[name], want[name].astype(np.float32), rtol=2e-3, atol=0, err_msg=name)
    np.testing.assert_allclose(
        metric.compute().numpy(), np.asarray(jax_metric.compute(), np.float32), rtol=2e-3 if dtype == torch.float16 else 1e-6
    )


def _c1_pair(dtype=torch.bfloat16, n=65536):
    """The half-precision recipe: ``n`` uniform pairs from seed 0, preds first."""
    rng = np.random.default_rng(0)
    preds = torch.as_tensor(rng.random(n), dtype=dtype)
    target = torch.as_tensor(rng.random(n), dtype=dtype)
    return preds, target


@pytest.mark.parametrize("which", ["mse", "psnr"])
def test_bfloat16_recipe_matches_jax(which):
    """MSE and PSNR of bfloat16 inputs are taken in float32, as the JAX
    package takes them: within float32 summation order (rtol 1e-6), where
    squaring and summing in bfloat16 was 0.39% off."""
    from metrics_tpu_torch.functional import mean_squared_error, peak_signal_noise_ratio

    preds, target = _c1_pair()
    jax_cls, port = METRICS[which]
    jax_metric, metric = jax_cls(), port()
    jax_metric.update(preds, target)
    metric.update(preds, target)
    want = np.asarray(jax_metric.compute())
    assert want.dtype == np.float32
    got = metric.compute()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # the functional form against the reference's, on the float32 arrays its
    # coercion makes of the same tensors
    jax_fn = jax_mean_squared_error if which == "mse" else jax_peak_signal_noise_ratio
    want_functional = np.asarray(jax_fn(jnp.asarray(preds.float().numpy()), jnp.asarray(target.float().numpy())))
    functional = (mean_squared_error if which == "mse" else peak_signal_noise_ratio)(preds, target)
    assert functional.dtype == torch.float32
    np.testing.assert_allclose(functional.numpy(), want_functional, rtol=1e-6)
    exact = np.mean((preds.double().numpy() - target.double().numpy()) ** 2)
    if which == "mse":
        np.testing.assert_allclose(got.numpy(), exact, rtol=1e-6)


@pytest.mark.parametrize("which", ["mse", "psnr"])
def test_float16_value_dtype_differs_from_jax(which):
    """A property of the reference: on float16 inputs the JAX package keeps
    float16 states and returns a float16 value (its float default is weakly
    typed). The port sums in float32 and returns float32; the values agree
    within 2e-3 relative. (At 4096 pairs: at the recipe's 65,536 the
    reference's float16 sum of squared error passes float16's largest
    value, 65,504.)"""
    preds, target = _c1_pair(torch.float16, 4096)
    jax_cls, port = METRICS[which]
    jax_metric, metric = jax_cls(), port()
    jax_metric.update(preds, target)
    metric.update(preds, target)
    want = np.asarray(jax_metric.compute())
    assert want.dtype == np.float16
    assert np.asarray(jax_metric.sum_squared_error).dtype == np.float16
    got = metric.compute()
    assert got.dtype == torch.float32 and metric.sum_squared_error.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.astype(np.float32), rtol=2e-3)
