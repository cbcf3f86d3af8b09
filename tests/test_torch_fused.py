"""The fused collection update (``core/fused.py``) on the CPU, against the
eager update and the JAX package's ``compile_update``.

On the CPU the handle runs its fused function directly (the plain version
of the CUDA graph it captures on the card): the same member set, bucket
padding, pad correction, in-program counter bump and capture rule. The
contracts of the JAX package's ``tests/bases/test_fused.py`` that need no
telemetry, manifest or mesh: parity with compute groups, one cache entry for
three bucketed shapes, the eager leg for a jit-unsafe member and for a
member that fails the probe, the in-program ``_n_updates`` bump, buckets
declined for mean states, the handle dropped on ``clone``/``add_metrics``,
the reset/update/compute cycle; then the sketch, sliced, windowed
(``n_valid``), capacity and retrieval members, and the capture rule of
``utils/checks.py``. Integer counts, sketch and table states are bit-equal
to the eager update and, where the JAX package's are bit-equal to its
eager ones, to the JAX package's fused update.
"""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import metrics_tpu
import metrics_tpu_torch as tm
from metrics_tpu.core.metric import Metric as JaxMetric
from metrics_tpu_torch import MetricCollection, ops
from metrics_tpu_torch.core.fused import _NoHostReads
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.sliced import SlicedMetric
from metrics_tpu_torch.utils.checks import (
    _input_format_classification,
    _value_stats,
    capturing_checks,
    checks_read_nothing,
)
from metrics_tpu_torch.windowed import WindowedMetric

torch.set_num_threads(2)


def _cls_batch(rng, n, c=3):
    preds = rng.rand(n, c).astype(np.float32)
    preds /= preds.sum(-1, keepdims=True)
    return preds, rng.randint(0, c, n)


def _cls_members(pkg, **kw):
    return [
        pkg.Accuracy(**kw),
        pkg.Precision(num_classes=3, average="macro", **kw),
        pkg.Recall(num_classes=3, average="macro", **kw),
        pkg.ConfusionMatrix(num_classes=3, **kw),
    ]


def _torch_cls(**kw):
    return MetricCollection(_cls_members(tm, device="cpu"), **kw)


def _jax_cls(**kw):
    return metrics_tpu.MetricCollection(_cls_members(metrics_tpu), **kw)


def _t(batch):
    return tuple(torch.from_numpy(x) for x in batch)


def _j(batch):
    return tuple(jnp.asarray(x) for x in batch)


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _flat(item)]
    return [torch.as_tensor(x)]


def _assert_bit_parity(eager, fused):
    res_e, res_f = eager.compute(), fused.compute()
    assert res_e.keys() == res_f.keys()
    for key in res_e:
        a, b = _flat(res_e[key]), _flat(res_f[key])
        assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b)), key
    for name, metric in eager.items(keep_base=True):
        for state in metric._defaults:
            a, b = _flat(getattr(metric, state)), _flat(getattr(fused[name], state))
            assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b)), f"{name}.{state}"


class _MeanState(Metric):
    """A mean-reduced state: the in-program counter bump, and no buckets."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("avg", default=torch.tensor(0.0), dist_reduce_fx="mean")

    def _update(self, preds, target):
        self.avg = (self.avg + preds.mean()) / 2

    def _compute(self):
        return self.avg


class _JaxMeanState(JaxMetric):
    def __init__(self):
        super().__init__()
        self.add_state("avg", default=jnp.asarray(0.0), dist_reduce_fx="mean")

    def _update(self, preds, target):
        self.avg = (self.avg + jnp.mean(preds)) / 2

    def _compute(self):
        return self.avg


class _JitUnsafeSum(Metric):
    __jit_unsafe__ = True

    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def _update(self, preds, target):
        self.total = self.total + preds.sum()

    def _compute(self):
        return self.total


class _HostRead(Metric):
    """Passes every static filter but reads a value on the host: the probe
    sends it to the eager leg."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def _update(self, preds, target):
        if float(preds.max()) >= 0:
            self.total = self.total + preds.sum()

    def _compute(self):
        return self.total


class _Weighted(Metric):
    """A float keyword argument (dynamic) and an int one (static)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def _update(self, preds, target, weight=1.0, power=1):
        self.total = self.total + weight * (preds**power).sum()

    def _compute(self):
        return self.total


def test_fused_parity_classification_with_compute_group():
    rng = np.random.RandomState(0)
    eager, fused, jax_fused = _torch_cls(), _torch_cls(), _jax_cls()
    fused.compile_update()
    jax_fused.compile_update()
    for _ in range(3):
        batch = _cls_batch(rng, 64)
        eager.update(*_t(batch))
        fused.update(*_t(batch))
        jax_fused.update(*_j(batch))
    assert eager.compute_groups == fused.compute_groups == jax_fused.compute_groups
    assert any(len(cg) > 1 for cg in fused.compute_groups.values())
    _assert_bit_parity(eager, fused)
    want = jax_fused.compute()
    for key, value in fused.compute().items():
        np.testing.assert_allclose(value.numpy(), np.asarray(want[key]), rtol=1e-6, atol=1e-7, err_msg=key)
    for group in fused.compute_groups.values():
        leader = group[0]
        for state in fused[leader]._defaults:
            np.testing.assert_array_equal(getattr(fused[leader], state).numpy(), np.asarray(getattr(jax_fused[leader], state)))


def test_bucketed_shapes_share_one_cache_entry():
    rng = np.random.RandomState(5)
    groups = [["Accuracy"], ["Precision", "Recall"], ["ConfusionMatrix"]]
    eager, fused, jax_fused = _torch_cls(compute_groups=groups), _torch_cls(compute_groups=groups), _jax_cls(compute_groups=groups)
    handle = fused.compile_update(buckets=(128,))
    jax_handle = jax_fused.compile_update(buckets=(128,))
    for n in (100, 120, 128):
        batch = _cls_batch(rng, n)
        eager.update(*_t(batch))
        fused.update(*_t(batch))
        jax_fused.update(*_j(batch))
    assert handle.cache_size == handle.n_compiles == 1
    assert jax_handle.cache_size == 1
    _assert_bit_parity(eager, fused)
    for name in ("Accuracy", "Precision", "ConfusionMatrix"):
        for state in fused[name]._defaults:
            np.testing.assert_array_equal(getattr(fused[name], state).numpy(), np.asarray(getattr(jax_fused[name], state)))


def test_jit_unsafe_member_takes_the_eager_leg():
    rng = np.random.RandomState(3)
    make = lambda: MetricCollection([tm.Accuracy(device="cpu"), _JitUnsafeSum(device="cpu")])
    eager, fused = make(), make()
    handle = fused.compile_update()
    batch = _t(_cls_batch(rng, 32))
    eager.update(*batch)
    fused.update(*batch)
    _assert_bit_parity(eager, fused)
    assert handle.n_compiles == 1  # Accuracy alone fused
    assert handle._never_fused("_JitUnsafeSum") and not handle._never_fused("Accuracy")


def test_member_failing_the_probe_takes_the_eager_leg():
    rng = np.random.RandomState(4)
    make = lambda: MetricCollection([tm.ConfusionMatrix(num_classes=3, device="cpu"), _HostRead(device="cpu")])
    eager, fused = make(), make()
    handle = fused.compile_update()
    for _ in range(2):
        batch = _t(_cls_batch(rng, 32))
        eager.update(*batch)
        fused.update(*batch)
    _assert_bit_parity(eager, fused)
    assert handle._eager_names == {"_HostRead"}
    assert "__float__" in handle.declined["_HostRead"]
    assert handle.donated_state_bytes() == 0  # nothing donated on the CPU


def test_mean_state_counter_bumped_in_the_program():
    eager, fused = MetricCollection([_MeanState(device="cpu")]), MetricCollection([_MeanState(device="cpu")])
    jax_fused = metrics_tpu.MetricCollection([_JaxMeanState()])
    fused.compile_update()
    jax_fused.compile_update()
    for i in range(3):
        x = np.asarray([float(i), float(i + 1)], np.float32)
        eager.update(torch.from_numpy(x), torch.from_numpy(x))
        fused.update(torch.from_numpy(x), torch.from_numpy(x))
        jax_fused.update(jnp.asarray(x), jnp.asarray(x))
    counter_e = getattr(eager["_MeanState"], "_n_updates")
    counter_f = getattr(fused["_MeanState"], "_n_updates")
    assert int(counter_e) == int(counter_f) == int(getattr(jax_fused["_JaxMeanState"], "_n_updates")) == 3
    assert isinstance(counter_e, int) and isinstance(counter_f, torch.Tensor) and counter_f.dtype == torch.int32
    assert float(fused.compute()["_MeanState"]) == float(eager.compute()["_MeanState"])
    np.testing.assert_allclose(float(fused.compute()["_MeanState"]), float(jax_fused.compute()["_JaxMeanState"]), rtol=1e-6)


def test_bucketing_declined_for_mean_states():
    fused = MetricCollection([_MeanState(device="cpu")])
    handle = fused.compile_update(buckets=(64,))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fused.update(torch.ones(10), torch.ones(10))
        fused.update(torch.ones(20), torch.ones(20))
    assert any("bucketing is disabled" in str(w.message) for w in caught)
    assert handle.n_compiles == 2  # one per exact shape


def test_handle_dropped_on_clone_add_and_to_device():
    fused = _torch_cls()
    handle = fused.compile_update()
    assert fused.fused_update is handle
    clone = fused.clone(prefix="val_")
    assert clone.fused_update is None
    clone.update(*_t(_cls_batch(np.random.RandomState(7), 16)))
    fused.to_device("cpu")
    assert fused.fused_update is None  # its graphs would live on the old device
    fused.compile_update()
    fused.add_metrics(tm.MeanSquaredError(device="cpu"))
    assert fused.fused_update is None


def test_reset_keeps_a_matching_handle_and_the_cycle_holds():
    rng = np.random.RandomState(4)
    eager, fused = _torch_cls(), _torch_cls()
    handle = fused.compile_update(buckets=(64,))
    for _ in range(2):
        batch = _t(_cls_batch(rng, 64))
        eager.update(*batch)
        fused.update(*batch)
    _assert_bit_parity(eager, fused)
    eager.reset()
    fused.reset()
    assert fused.compile_update(buckets=(64,)) is handle  # warm reuse
    assert fused.compile_update(buckets=(32, 64)) is not handle
    fused.compile_update(buckets=(64,))
    batch = _t(_cls_batch(rng, 50))
    eager.update(*batch)
    fused.update(*batch)
    _assert_bit_parity(eager, fused)


def test_donation_defaults_off_on_the_cpu():
    fused = _torch_cls()
    handle = fused.compile_update()
    assert handle.donating is False and handle.config_matches()
    assert fused.compile_update(donate=True).donating is True


def _same_storage(a, b):
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


@pytest.mark.parametrize("donate", [True, False])
def test_compute_hands_out_no_donated_state(donate):
    """ConfusionMatrix's compute returns its state itself. Under a donating
    handle (whose replays overwrite the states in place on the card) the
    value is a copy; without donation the state is its own, as eagerly."""
    rng = np.random.RandomState(13)
    fused = _torch_cls()
    fused.update(*_t(_cls_batch(rng, 64)))
    fused.compile_update(donate=donate)
    fused.update(*_t(_cls_batch(rng, 64)))
    kept = fused.compute()["ConfusionMatrix"]
    frozen = kept.clone()
    assert _same_storage(kept, fused["ConfusionMatrix"].confmat) is not donate
    for _ in range(2):
        fused.update(*_t(_cls_batch(rng, 64)))
    assert torch.equal(kept, frozen)
    assert not torch.equal(fused.compute()["ConfusionMatrix"], frozen)


def test_windowed_compute_of_a_window_hands_out_no_donated_row():
    """compute(window=1) folds one ring row, a view of the ring state."""
    rng = np.random.RandomState(14)
    col = MetricCollection([WindowedMetric(tm.ConfusionMatrix(num_classes=3, device="cpu"), window=4)])
    col.update(*_t(_cls_batch(rng, 32)))
    col.compile_update(donate=True)
    col.update(*_t(_cls_batch(rng, 32)))
    metric = col["WindowedMetric"]
    kept = metric.compute(window=1)
    assert not _same_storage(kept, metric.confmat)
    # the window's fold memo keeps a copy of a lone row, donated or not,
    # and the value is that row's
    plain = MetricCollection([WindowedMetric(tm.ConfusionMatrix(num_classes=3, device="cpu"), window=4)])
    plain.compile_update(donate=False)
    plain.update(*_t(_cls_batch(rng, 32)))
    value = plain["WindowedMetric"].compute(window=1)
    assert not _same_storage(value, plain["WindowedMetric"].confmat)
    assert torch.equal(value, plain["WindowedMetric"].confmat[0])


def test_float_arguments_are_dynamic_and_ints_key_the_cache():
    fused = MetricCollection([_Weighted(device="cpu")])
    handle = fused.compile_update()
    x = torch.arange(4.0)
    fused.update(x, x, weight=0.5)
    fused.update(x, x, weight=2.0)
    assert handle.cache_size == 1
    fused.update(x, x, weight=1.0, power=2)
    assert handle.cache_size == 2
    assert float(fused.compute()["_Weighted"]) == pytest.approx(0.5 * 6 + 2.0 * 6 + 14)


def test_cache_growth_warns_once_at_sixteen_entries():
    fused = MetricCollection([tm.ConfusionMatrix(num_classes=3, device="cpu")])
    fused.compile_update()
    rng = np.random.RandomState(8)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for n in range(8, 26):
            fused.update(*_t(_cls_batch(rng, n)))
    assert sum("16 entries" in str(w.message) for w in caught) == 1


def test_sketch_member_matches_eager_and_jax_in_the_window():
    """AUROC()'s sketch takes n_valid (weight-0 pad rows); past the window
    every fused absorb compacts and selects, with the eager bits."""
    rng = np.random.RandomState(9)
    make = lambda: MetricCollection([tm.Accuracy(device="cpu"), tm.AUROC(sketch_capacity=64, device="cpu")])
    eager, fused = make(), make()
    jax_fused = metrics_tpu.MetricCollection([metrics_tpu.Accuracy(), metrics_tpu.AUROC(sketch_capacity=64)])
    handle = fused.compile_update(buckets=(32,))
    jax_fused.compile_update(buckets=(32,))
    batches = [(rng.rand(n).astype(np.float32), rng.randint(0, 2, n)) for n in (20, 31, 32, 25, 30, 32)]
    for i, batch in enumerate(batches):
        eager.update(*_t(batch))
        fused.update(*_t(batch))
        jax_fused.update(*_j(batch))
        if i == 1:  # 51 rows: inside the window, the sketch is the stream
            np.testing.assert_array_equal(fused["AUROC"].csketch.numpy(), np.asarray(jax_fused["AUROC"].csketch))
    assert handle.cache_size == 1 and not handle._eager_names
    _assert_bit_parity(eager, fused)
    assert int(fused["AUROC"].n_seen) == sum(len(b[0]) for b in batches)


def test_sliced_member_matches_eager_and_jax():
    rng = np.random.RandomState(10)
    make = lambda: MetricCollection([SlicedMetric(tm.MeanSquaredError(device="cpu"), 7)])
    eager, fused = make(), make()
    jax_fused = metrics_tpu.MetricCollection([metrics_tpu.SlicedMetric(metrics_tpu.MeanSquaredError(), 7)])
    handle = fused.compile_update(buckets=(16,))
    jax_fused.compile_update(buckets=(16,))
    for n in (9, 16, 12, 16):
        ids = rng.randint(-1, 8, n)  # -1 and 7 drop
        preds, target = rng.randint(0, 9, n).astype(np.float32), rng.randint(0, 9, n).astype(np.float32)
        eager.update(torch.from_numpy(ids), torch.from_numpy(preds), torch.from_numpy(target))
        fused.update(torch.from_numpy(ids), torch.from_numpy(preds), torch.from_numpy(target))
        jax_fused.update(jnp.asarray(ids), jnp.asarray(preds), jnp.asarray(target))
    assert handle.cache_size == 1 and not handle._eager_names
    _assert_bit_parity(eager, fused)
    for state in ("sum_squared_error", "total", "_slice_rows"):
        np.testing.assert_array_equal(getattr(fused["SlicedMetric"], state).numpy(), np.asarray(getattr(jax_fused["SlicedMetric"], state)))


@pytest.mark.parametrize("mode", ["ring", "decay"])
def test_windowed_member_corrects_its_pads_through_n_valid(mode):
    rng = np.random.RandomState(11)
    kw = {"window": 3, "updates_per_bucket": 2} if mode == "ring" else {"mode": "decay", "decay": 0.5}
    make = lambda: MetricCollection([WindowedMetric(tm.MeanSquaredError(device="cpu"), **kw)])
    eager, fused = make(), make()
    jax_fused = metrics_tpu.MetricCollection([metrics_tpu.WindowedMetric(metrics_tpu.MeanSquaredError(), **kw)])
    handle = fused.compile_update(buckets=(8,))
    jax_fused.compile_update(buckets=(8,))
    for n in (5, 6, 7, 8) * 3:
        preds, target = rng.randint(0, 2, n).astype(np.float32), rng.randint(0, 2, n).astype(np.float32)
        eager.update(torch.from_numpy(preds), torch.from_numpy(target))
        fused.update(torch.from_numpy(preds), torch.from_numpy(target))
        jax_fused.update(jnp.asarray(preds), jnp.asarray(target))
    assert handle.cache_size == 1 and not handle._eager_names
    _assert_bit_parity(eager, fused)
    for state in fused["WindowedMetric"]._defaults:
        np.testing.assert_array_equal(getattr(fused["WindowedMetric"], state).numpy(), np.asarray(getattr(jax_fused["WindowedMetric"], state)))


def test_capacity_member_fuses_and_counts_its_overflow():
    rng = np.random.RandomState(12)
    make = lambda: MetricCollection([tm.ConfusionMatrix(3, device="cpu"), tm.AUROC(num_classes=3, capacity=96, device="cpu")])
    eager, fused = make(), make()
    handle = fused.compile_update()
    for _ in range(3):
        batch = _t(_cls_batch(rng, 32))
        eager.update(*batch)
        fused.update(*batch)
    assert not handle._eager_names
    _assert_bit_parity(eager, fused)
    fused.update(*_t(_cls_batch(rng, 32)))  # past the capacity: dropped and counted, no host read
    assert int(fused["AUROC"].overflow) == 32 and int(fused["AUROC"].valid.sum()) == 96
    with pytest.raises(Exception, match="capacity overflow"):
        fused["AUROC"].compute()


def test_retrieval_table_member_fuses_with_the_eager_bits():
    rng = np.random.RandomState(13)
    make = lambda: MetricCollection([tm.RetrievalNormalizedDCG(max_queries=32, device="cpu"), tm.RetrievalMAP(max_queries=32, device="cpu")])
    eager, fused = make(), make()
    handle = fused.compile_update(buckets=(64,))
    for n in (50, 64, 40):
        preds, target, idx = rng.rand(n).astype(np.float32), rng.randint(0, 2, n), rng.randint(0, 40, n)
        for col in (eager, fused):
            col.update(torch.from_numpy(preds), torch.from_numpy(target), indexes=torch.from_numpy(idx))
    assert handle.cache_size == 1 and not handle._eager_names
    _assert_bit_parity(eager, fused)


def test_exact_curve_members_take_the_eager_leg():
    rng = np.random.RandomState(14)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        make = lambda: MetricCollection([tm.AUROC(exact=True, device="cpu"), tm.ROC(device="cpu")])
        eager, fused = make(), make()
    handle = fused.compile_update()
    for _ in range(2):
        batch = (torch.rand(16, generator=torch.Generator().manual_seed(int(rng.randint(1000)))), torch.from_numpy(rng.randint(0, 2, 16)))
        eager.update(*batch)
        fused.update(*batch)
    assert handle._never_fused("AUROC") and not handle._never_fused("ROC")
    assert fused["AUROC"].__jit_unsafe__ is True
    _assert_bit_parity(eager, fused)


def test_capture_rule_reads_nothing():
    """A fake capturing flag on the CPU: the value checks return no values,
    the formatting decides from shapes and static arguments, and a
    classification update reads nothing (the probe's function mode would
    raise on any read)."""
    preds, target = torch.rand(8, 3), torch.randint(0, 3, (8,))
    assert not checks_read_nothing()
    assert set(_value_stats(preds, target)) == {"tmin", "tmax"}
    with _NoHostReads(), pytest.raises(RuntimeError, match="reads tensor values"):
        _value_stats(preds, target)
    with capturing_checks():
        assert checks_read_nothing()
        with _NoHostReads():
            assert _value_stats(preds, target) == {}
            metric = tm.Accuracy(device="cpu")
            metric._update(preds, target)
            metric = tm.CohenKappa(num_classes=3, device="cpu")
            metric._update(preds, target)
        # an out-of-range label is not seen under capture, as under jit
        _input_format_classification(preds, torch.full((8,), 5))
        with pytest.raises(ValueError, match="num_classes"):  # label inputs need it, as under jit
            _input_format_classification(target, target)
    assert not checks_read_nothing()
    with pytest.raises(ValueError, match="smaller than the size of the `C` dimension"):
        _input_format_classification(preds, torch.full((8,), 5))


def test_launches_recorded_then_added_per_replay():
    ops.reset_launch_counts()
    with ops.dispatch.recording_launches() as recorded:
        ops.count_launch("bincount_i32")
        ops.count_launch("bincount_i32")
    assert recorded == {"bincount_i32": 2} and ops.launch_counts().get("bincount_i32", 0) == 0
    for _ in range(3):
        ops.dispatch.add_launches(recorded)
    assert ops.launch_counts()["bincount_i32"] == 6
    ops.reset_launch_counts()


def test_ignore_index_sentinel_declines_buckets():
    """A macro stat score with ``ignore_index`` writes the ignored class's
    counts as a -1 sentinel each update, which the pad correction would
    move: the port declines buckets for it and keeps the eager value. The
    JAX package corrects it (a fault of the reference: its bucketed value
    differs from its eager one), so the port does not follow it here."""
    rng = np.random.RandomState(15)
    batches = [_cls_batch(rng, n, c=4) for n in (12, 16, 9, 16)]
    kw = dict(num_classes=4, average="macro", ignore_index=0)
    eager, fused = MetricCollection([tm.Precision(device="cpu", **kw)]), MetricCollection([tm.Precision(device="cpu", **kw)])
    jax_eager, jax_fused = metrics_tpu.MetricCollection([metrics_tpu.Precision(**kw)]), metrics_tpu.MetricCollection([metrics_tpu.Precision(**kw)])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        handle = fused.compile_update(buckets=(16,))
        jax_fused.compile_update(buckets=(16,))
        for batch in batches:
            for col in (eager, fused):
                col.update(*_t(batch))
            for col in (jax_eager, jax_fused):
                col.update(*_j(batch))
    assert any("bucketing is disabled" in str(w.message) for w in caught)
    assert handle.cache_size == 3  # one graph per exact shape
    _assert_bit_parity(eager, fused)
    np.testing.assert_allclose(float(fused.compute()["Precision"]), float(jax_eager.compute()["Precision"]), rtol=1e-6)
    assert float(jax_fused.compute()["Precision"]) != pytest.approx(float(jax_eager.compute()["Precision"]))


@pytest.mark.parametrize("kind", ["binary", "labels"])
def test_sliced_classification_templates_read_nothing_under_vmap(kind):
    """A sliced template's update runs per row under ``vmap``, where no
    value can be read: the value checks follow the capture rule, as the JAX
    package's skip vmap's tracers."""
    rng = np.random.RandomState(16)
    ids = rng.randint(0, 5, 24)
    if kind == "binary":
        preds, target, kw = rng.rand(24).astype(np.float32), rng.randint(0, 2, 24), {}
    else:
        preds, target, kw = rng.randint(0, 4, 24), rng.randint(0, 4, 24), {"num_classes": 4}
    got = SlicedMetric(tm.Accuracy(device="cpu", **kw), 5)
    want = metrics_tpu.SlicedMetric(metrics_tpu.Accuracy(**kw), 5)
    got.update(torch.from_numpy(ids), torch.from_numpy(preds), torch.from_numpy(target))
    want.update(jnp.asarray(ids), jnp.asarray(preds), jnp.asarray(target))
    np.testing.assert_allclose(got.compute().numpy(), np.asarray(want.compute()), rtol=1e-6, equal_nan=True)
    for state in ("tp", "fp", "tn", "fn"):
        np.testing.assert_array_equal(getattr(got, state).numpy(), np.asarray(getattr(want, state)))
