"""Cross-process sync of the port against the JAX package's, on the CPU.

Simulated worlds: every rank runs in a thread of its own, and a rank's
gather (``dist_sync_fn``) deposits its tensor and returns every rank's at a
barrier, so each rank enters the same gathers in the same order, as in a
process group.

* The sync state machine: ``tests/bases/test_ddp.py``'s host-level cases on
  both packages (sum, mean, max, min and cat states, uneven list states,
  ``compute`` restoring the local states, a synced ``state_dict`` while
  accumulation continues), the error states and the constructor's checks,
  message for message.
* Families: per-rank states built in both packages from the same shards,
  synced in worlds of 2 and 3 ranks: the synced states bit for bit (float
  sums within rtol 1e-6: the fold adds in another order; the Gumbel
  priorities within the 2 ulp of ``tests/test_torch_rank_sketch.py``) and
  ``compute()`` on every rank.
* ``sync_pytree`` against ``sync_pytree_in_mesh`` over an 8-device CPU
  mesh, on the same per-rank states.
* The sketch occupancy bounds through a sync (a union that fits compacts
  nothing), a fused collection's states across ``sync``/``unsync``, and
  every exported class whose JAX counterpart takes ``**kwargs``.
"""
import inspect
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import metrics_tpu
import metrics_tpu.sliced
import metrics_tpu.windowed
import metrics_tpu.wrappers
import metrics_tpu_torch as tm
import metrics_tpu_torch.sliced
import metrics_tpu_torch.windowed
import metrics_tpu_torch.wrappers
from metrics_tpu.detection import MeanAveragePrecision as JaxMAP
from metrics_tpu.functional.classification.auroc import auroc as jax_auroc
from metrics_tpu.parallel.distributed import sync_pytree_in_mesh
from metrics_tpu.sketches import sketch_merge_fx as jax_sketch_merge_fx
from metrics_tpu.utils.compat import shard_map
from metrics_tpu.utils.exceptions import MetricsUserError as JaxMetricsUserError
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.parallel.distributed import sync_pytree
from metrics_tpu_torch.sketches import quantile, sketch_merge_fx
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from tests.test_torch_regression import assert_priorities_close

torch.set_num_threads(2)


class World:
    """A simulated process group of ``n`` ranks, one thread each."""

    def __init__(self, n):
        self.n = n
        self._slots = [None] * n
        self._barrier = threading.Barrier(n, timeout=60)

    def gather(self, rank):
        def fn(x, group=None):
            self._slots[rank] = x
            self._barrier.wait()
            out = list(self._slots)
            self._barrier.wait()
            return out

        return fn

    def run(self, body):
        """``body(rank, gather)`` on every rank; the first error raises."""
        results, errors = [None] * self.n, []

        def target(rank):
            try:
                results[rank] = body(rank, self.gather(rank))
            except BaseException as e:  # noqa: BLE001 -- raised below
                errors.append(e)
                self._barrier.abort()

        threads = [threading.Thread(target=target, args=(r,)) for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads), "a simulated rank hung"
        if errors:
            raise errors[0]
        return results


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, int):
        return np.asarray(x, np.int32)
    return np.asarray(x)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8) if a.dtype != np.bool_ else a


def _assert_equal(got, want, rtol=0.0, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (what, set(got), set(want))
        for k in want:
            _assert_equal(got[k], want[k], rtol, f"{what}.{k}")
        return
    if isinstance(want, list):
        got = np.concatenate([np.atleast_1d(g) for g in got]) if got else np.zeros(0)
        want = np.concatenate([np.atleast_1d(w) for w in want]) if want else np.zeros(0)
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if rtol and np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7, err_msg=what)
    else:
        assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _synced(world, metrics, jax_side):
    """Every rank's synced states and ``compute()`` value."""

    def body(rank, gather):
        m = metrics[rank]
        if jax_side:
            m.sync(dist_sync_fn=gather, distributed_available=lambda: True)
        else:
            m.sync(dist_sync_fn=gather)
        states = {k: _np(getattr(m, k)) for k in m._defaults}
        m.unsync()
        m.dist_sync_fn = gather
        value = m.compute()
        m.dist_sync_fn = None
        return states, _np(value)

    return world.run(body)


# ---------------------------------------------------------------------------
# the sync state machine
# ---------------------------------------------------------------------------


class _JaxAll(metrics_tpu.Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("s", jnp.array(0.0), dist_reduce_fx="sum")
        self.add_state("m", jnp.array(0.0), dist_reduce_fx="mean")
        self.add_state("mx", jnp.array(-jnp.inf), dist_reduce_fx="max")
        self.add_state("mn", jnp.array(jnp.inf), dist_reduce_fx="min")
        self.add_state("c", [], dist_reduce_fx="cat")

    def _update(self, x):
        x = jnp.asarray(x, jnp.float32)
        self.s = self.s + x.sum()
        self.m = x.mean()
        self.mx = jnp.maximum(self.mx, x.max())
        self.mn = jnp.minimum(self.mn, x.min())
        self.c.append(x)

    def _compute(self):
        return self.s + self.m + self.mx - self.mn


class _All(Metric):
    def __init__(self, **kwargs):
        super().__init__(device="cpu", **kwargs)
        self.add_state("s", torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("m", torch.tensor(0.0), dist_reduce_fx="mean")
        self.add_state("mx", torch.tensor(-float("inf")), dist_reduce_fx="max")
        self.add_state("mn", torch.tensor(float("inf")), dist_reduce_fx="min")
        self.add_state("c", [], dist_reduce_fx="cat")

    def _update(self, x):
        x = torch.as_tensor(x, dtype=torch.float32)
        self.s = self.s + x.sum()
        self.m = x.mean()
        self.mx = torch.maximum(self.mx, x.max())
        self.mn = torch.minimum(self.mn, x.min())
        self.c.append(x)

    def _compute(self):
        return self.s + self.m + self.mx - self.mn


RANK_DATA = [np.array([1.0, 2.0, -3.0], np.float32), np.array([4.0, 5.0], np.float32), np.array([-7.0], np.float32)]


@pytest.mark.parametrize("n_ranks", [2, 3])
def test_every_reduction_matches_jax(n_ranks):
    jax_metrics, metrics = [_JaxAll() for _ in range(n_ranks)], [_All() for _ in range(n_ranks)]
    for r in range(n_ranks):
        for _ in range(r + 1):  # uneven list states: r + 1 entries on rank r
            jax_metrics[r].update(jnp.asarray(RANK_DATA[r]))
            metrics[r].update(torch.from_numpy(RANK_DATA[r]))
    got = _synced(World(n_ranks), metrics, jax_side=False)
    want = _synced(World(n_ranks), jax_metrics, jax_side=True)
    for r in range(n_ranks):
        (gs, gv), (ws, wv) = got[r], want[r]
        for key in ws:
            # the sum and the mean fold in another order; max, min and cat are exact
            _assert_equal(gs[key], ws[key], rtol=1e-6 if key in ("s", "m") else 0.0, what=f"rank {r} {key}")
        _assert_equal(gv, wv, rtol=1e-6, what=f"value rank {r}")
    # the local states are back
    for r, m in enumerate(metrics):
        assert float(m.s) == RANK_DATA[r].sum() * (r + 1) and len(m.c) == r + 1 and not m._is_synced


def test_host_sync_sum_two_ranks_restores_the_local_states():
    rank_vals = [3.0, 5.0]
    for pkg in ("jax", "port"):
        metrics = [_JaxAll() if pkg == "jax" else _All() for _ in rank_vals]
        for m, v in zip(metrics, rank_vals):
            m.update(np.float32(v))

        def body(rank, gather, metrics=metrics, pkg=pkg):
            m = metrics[rank]
            m.sync(dist_sync_fn=gather, **({"distributed_available": lambda: True} if pkg == "jax" else {}))
            synced = float(np.asarray(m.s))
            m.unsync()
            return synced, float(np.asarray(m.s))

        assert World(2).run(body) == [(8.0, 3.0), (8.0, 5.0)]


def test_cat_uneven_sizes_match_jax():
    rank_data = [np.array([1.0, 2.0], np.float32), np.array([3.0, 4.0, 5.0], np.float32)]
    out = {}
    for pkg in ("jax", "port"):
        m = _JaxAll() if pkg == "jax" else _All()
        m.update(rank_data[0])
        peer = jnp.asarray(rank_data[1]) if pkg == "jax" else torch.from_numpy(rank_data[1])

        def gather(x, group=None, peer=peer):
            return [x, peer if x.ndim == 1 else x]

        kw = {"distributed_available": lambda: True} if pkg == "jax" else {}
        m.sync(dist_sync_fn=gather, **kw)
        out[pkg] = np.asarray(m.c)
        m.unsync()
        assert len(m.c) == 1
    np.testing.assert_array_equal(out["port"], out["jax"])
    np.testing.assert_array_equal(out["port"], [1, 2, 3, 4, 5])


def test_compute_with_dist_sync_fn_restores_the_local_state():
    for m in (_JaxAll(dist_sync_fn=lambda x, group=None: [x, x]), _All(dist_sync_fn=lambda x, group=None: [x, x])):
        m.update(np.float32(2.0))
        assert float(np.asarray(m.compute())) == 4.0 + 2.0 + 2.0 - 2.0
        assert float(np.asarray(m.s)) == 2.0 and len(m.c) == 1


def test_state_dict_is_synced_while_accumulation_continues():
    for m in (_JaxAll(dist_sync_fn=lambda x, group=None: [x, x]), _All(dist_sync_fn=lambda x, group=None: [x, x])):
        for step in range(3):
            m.update(np.float32(1.0))
            with m.sync_context():
                sd = m.state_dict()
                assert float(np.asarray(sd["s"])) == 2.0 * (step + 1)
            assert float(np.asarray(m.s)) == step + 1.0


def _raises_same(fn_jax, fn_port, jax_exc, port_exc):
    with pytest.raises(jax_exc) as want:
        fn_jax()
    with pytest.raises(port_exc) as got:
        fn_port()
    assert str(got.value) == str(want.value)


def test_error_states_match_jax():
    fn = lambda x, group=None: [x, x]  # noqa: E731
    jm, m = _JaxAll(), _All()
    jm.update(np.float32(1.0))
    m.update(np.float32(1.0))
    # unsync before sync
    _raises_same(jm.unsync, m.unsync, JaxMetricsUserError, MetricsUserError)
    jm.sync(dist_sync_fn=fn, distributed_available=lambda: True)
    m.sync(dist_sync_fn=fn)
    # sync twice
    _raises_same(
        lambda: jm.sync(dist_sync_fn=fn, distributed_available=lambda: True),
        lambda: m.sync(dist_sync_fn=fn),
        JaxMetricsUserError,
        MetricsUserError,
    )
    # forward while synced; the port's update raises the same
    _raises_same(lambda: jm(np.float32(1.0)), lambda: m(np.float32(1.0)), JaxMetricsUserError, MetricsUserError)
    with pytest.raises(MetricsUserError, match="shouldn't be synced"):
        m.update(np.float32(1.0))
    m.unsync()
    jm.unsync()
    _raises_same(jm.unsync, m.unsync, JaxMetricsUserError, MetricsUserError)
    # a lost cache
    jm.sync(dist_sync_fn=fn, distributed_available=lambda: True)
    m.sync(dist_sync_fn=fn)
    jm._cache = m._cache = None
    _raises_same(jm.unsync, m.unsync, JaxMetricsUserError, MetricsUserError)


def test_one_process_without_a_sync_fn_does_not_sync():
    m = _All()
    m.update(np.float32(1.0))
    m.sync()
    assert not m._is_synced and m._cache is None
    m.sync(distributed_available=lambda: True)  # a world of one: each state with itself
    assert m._is_synced and float(m.s) == 1.0 and float(m.m) == 1.0
    m.unsync()


@pytest.mark.parametrize(
    "kwargs",
    [{"dist_sync_on_step": 1}, {"dist_sync_on_step": "yes"}, {"dist_sync_fn": 3}, {"dist_sync_fn": "gather"}],
)
def test_constructor_checks_match_jax(kwargs):
    _raises_same(lambda: _JaxAll(**kwargs), lambda: _All(**kwargs), ValueError, ValueError)


def test_compute_on_step_warns_as_jax():
    with pytest.warns(DeprecationWarning) as want:
        _JaxAll(compute_on_step=False)
    with pytest.warns(DeprecationWarning) as got:
        _All(compute_on_step=False)
    assert [str(w.message) for w in got] == [str(w.message) for w in want]
    m = tm.MeanSquaredError(device="cpu", dist_sync_on_step=True, process_group="g", dist_sync_fn=None)
    assert m.dist_sync_on_step and m.process_group == "g" and m.dist_sync_fn is None


@pytest.mark.parametrize("sync_on_step", [False, True])
def test_forward_batch_value_with_dist_sync_on_step(sync_on_step):
    """Each rank's ``forward`` value: its own batch, or with
    ``dist_sync_on_step`` the global batch; the accumulation stays local."""
    batches = [(np.array([0, 1, 1, 2]), np.array([0, 1, 2, 2])), (np.array([1, 1, 0]), np.array([1, 0, 0]))]
    world = World(2)

    def body(rank, gather):
        jm = metrics_tpu.Accuracy(num_classes=3, dist_sync_on_step=sync_on_step, dist_sync_fn=gather)
        m = tm.Accuracy(num_classes=3, device="cpu", dist_sync_on_step=sync_on_step, dist_sync_fn=gather)
        p, t = batches[rank]
        out = []
        for _ in range(2):
            out.append((float(np.asarray(jm(jnp.asarray(p), jnp.asarray(t)))), float(m(torch.from_numpy(p), torch.from_numpy(t)))))
        assert not m._is_synced and m._cache is None
        return out

    for rank_out in world.run(body):
        for want, got in rank_out:
            assert got == want
    if sync_on_step:
        assert rank_out[0][1] == pytest.approx(5 / 7)


# ---------------------------------------------------------------------------
# families
# ---------------------------------------------------------------------------


def _binary(seed, n):
    rng = np.random.RandomState(seed)
    return rng.rand(n).astype(np.float32), (rng.rand(n) < 0.35).astype(np.int64)


def _feed_both(jax_m, m, batches):
    for args in batches:
        jax_m.update(*[jnp.asarray(a) for a in args])
        m.update(*[torch.from_numpy(a) for a in args])


def _cm_batches(rank):
    rng = np.random.RandomState(rank)
    return [(rng.randint(0, 4, 30), rng.randint(0, 4, 30)) for _ in range(2)]


def _binary_batches(rank, n_batches, size):
    return [_binary(100 * rank + i, size) for i in range(n_batches)]


def _retrieval_batches(rank):
    # the same query ids on every rank: the table merge joins them
    rng = np.random.default_rng(rank)
    out = []
    for _ in range(2):
        idx = rng.integers(0, 6, 24).astype(np.int64)
        out.append(((rng.integers(0, 32, 24) / 32.0).astype(np.float32), rng.integers(0, 2, 24).astype(np.int64), idx))
    return out


def _psnr_batches(rank):
    rng = np.random.default_rng(10 + rank)
    out = []
    for _ in range(2):
        ids = rng.integers(-1, 6, 6).astype(np.int32)  # tenants on every rank, -1 drops
        target = rng.random((6, 3, 4, 4), dtype=np.float32)
        preds = (target + 0.05 * rng.standard_normal((6, 3, 4, 4))).astype(np.float32)
        out.append((ids, preds, target))
    return out


def _regression_batches(rank):
    rng = np.random.default_rng(20 + rank)
    out = []
    for _ in range(3):
        target = rng.standard_normal(16).astype(np.float32)
        out.append(((target + 0.3 * rng.standard_normal(16)).astype(np.float32), target))
    return out


FAMILIES = {
    "confusion-matrix": (
        lambda: (metrics_tpu.ConfusionMatrix(num_classes=4), tm.ConfusionMatrix(num_classes=4, device="cpu")),
        _cm_batches,
        {},
    ),
    "auroc-capacity": (
        lambda: (metrics_tpu.AUROC(capacity=64), tm.AUROC(capacity=64, device="cpu")),
        lambda r: _binary_batches(r, 2, 20),
        {},
    ),
    "auroc-sketch-window": (
        lambda: (metrics_tpu.AUROC(sketch_capacity=256), tm.AUROC(sketch_capacity=256, device="cpu")),
        lambda r: _binary_batches(r, 2, 40),
        {},
    ),
    "auroc-sketch-past": (
        lambda: (metrics_tpu.AUROC(sketch_capacity=256), tm.AUROC(sketch_capacity=256, device="cpu")),
        lambda r: _binary_batches(r, 6, 60),
        {"value_rtol": 1e-5},
    ),
    "retrieval-table": (
        lambda: (metrics_tpu.RetrievalMAP(max_queries=8, max_docs=16), tm.RetrievalMAP(max_queries=8, max_docs=16, device="cpu")),
        _retrieval_batches,
        {"value_rtol": 1e-6},
    ),
    "sliced-psnr": (
        lambda: (
            metrics_tpu.sliced.SlicedMetric(metrics_tpu.PeakSignalNoiseRatio(), 5),
            tm.SlicedMetric(tm.PeakSignalNoiseRatio(device="cpu"), 5),
        ),
        _psnr_batches,
        {"state_rtol": 1e-6, "value_rtol": 1e-6},
    ),
    "windowed-ring": (
        lambda: (
            metrics_tpu.windowed.WindowedMetric(metrics_tpu.MeanSquaredError(), window=3),
            tm.WindowedMetric(tm.MeanSquaredError(device="cpu"), window=3),
        ),
        _regression_batches,
        {"state_rtol": 1e-6, "value_rtol": 1e-6},
    ),
    "windowed-ring-of-sketches": (
        lambda: (
            metrics_tpu.windowed.WindowedMetric(metrics_tpu.AUROC(pos_label=1, sketch_capacity=64), window=3),
            tm.WindowedMetric(tm.AUROC(pos_label=1, sketch_capacity=64, device="cpu"), window=3),
        ),
        lambda r: _binary_batches(r, 3, 40),
        {"value_rtol": 1e-5},
    ),
    "spearman-rank-sketch": (
        lambda: (metrics_tpu.SpearmanCorrCoef(sketch_capacity=64), tm.SpearmanCorrCoef(sketch_capacity=64, device="cpu")),
        _regression_batches,
        {"priorities": True, "value_rtol": 1e-5},
    ),
}


def _family_states(name, n_ranks):
    make, batches, tol = FAMILIES[name]
    pairs = [make() for _ in range(n_ranks)]
    for r, (jax_m, m) in enumerate(pairs):
        _feed_both(jax_m, m, batches(r))
    got = _synced(World(n_ranks), [p[1] for p in pairs], jax_side=False)
    want = _synced(World(n_ranks), [p[0] for p in pairs], jax_side=True)
    return got, want, tol


@pytest.mark.parametrize("n_ranks", [2, 3])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_synced_states_and_values_match_jax(name, n_ranks):
    got, want, tol = _family_states(name, n_ranks)
    for r in range(n_ranks):
        (gs, gv), (ws, wv) = got[r], want[r]
        for key in ws:
            if tol.get("priorities") and key == "rsketch":
                np.testing.assert_array_equal(gs[key][:, 1:], ws[key][:, 1:])
                assert_priorities_close(gs[key][:, 0], ws[key][:, 0])
            else:
                _assert_equal(gs[key], ws[key], rtol=tol.get("state_rtol", 0.0), what=f"{name} rank {r} {key}")
        _assert_equal(gv, wv, rtol=tol.get("value_rtol", 1e-6), what=f"{name} value rank {r}")
        # every rank holds the same synced states
        _assert_equal(got[r][0], got[0][0], what=f"{name} rank {r} against rank 0")


def test_map_synced_table_matches_jax():
    kw = dict(det_slots=8, gt_slots=8, max_detection_thresholds=[1, 4, 8], max_images=32)
    rng = np.random.RandomState(0)

    def images(n):
        out = []
        for _ in range(n):
            nd, ng = int(rng.randint(1, 7)), int(rng.randint(1, 5))

            def boxes(k):
                xy = rng.randint(0, 4, (k, 2)).astype(np.float64) * 6.0 + rng.rand(k, 2)
                return np.concatenate([xy, xy + 4.0 + rng.rand(k, 2) * 4.0], axis=1).astype(np.float32)

            out.append(
                (
                    dict(boxes=boxes(nd), scores=rng.rand(nd).astype(np.float32), labels=rng.randint(0, 3, nd).astype(np.int32)),
                    dict(boxes=boxes(ng), labels=rng.randint(0, 3, ng).astype(np.int32)),
                )
            )
        return out

    shards = [images(6), images(5)]
    pairs = [(JaxMAP(**kw), tm.MeanAveragePrecision(device="cpu", **kw)) for _ in shards]
    for (jax_m, m), shard in zip(pairs, shards):
        jax_m.update([{k: jnp.asarray(v) for k, v in p.items()} for p, _ in shard], [{k: jnp.asarray(v) for k, v in t.items()} for _, t in shard])
        m.update([{k: torch.from_numpy(v) for k, v in p.items()} for p, _ in shard], [{k: torch.from_numpy(v) for k, v in t.items()} for _, t in shard])
    got = _synced(World(2), [p[1] for p in pairs], jax_side=False)
    want = _synced(World(2), [p[0] for p in pairs], jax_side=True)
    for r in range(2):
        _assert_equal(got[r][0], want[r][0], what=f"mAP states rank {r}")
        _assert_equal(got[r][1], want[r][1], what=f"mAP value rank {r}")


def test_bootstrapper_children_sync_as_jax():
    world = World(2)
    batches = {r: _regression_batches(r) for r in range(2)}

    def make_and_feed(rank, pkg):
        base = metrics_tpu.MeanSquaredError() if pkg == "jax" else tm.MeanSquaredError(device="cpu")
        boot = (metrics_tpu.BootStrapper if pkg == "jax" else tm.BootStrapper)(base, num_bootstraps=3, raw=True, seed=rank)
        for p, t in batches[rank]:
            boot.update(*((jnp.asarray(p), jnp.asarray(t)) if pkg == "jax" else (torch.from_numpy(p), torch.from_numpy(t))))
        return boot

    def body(pkg):
        def run(rank, gather):
            boot = make_and_feed(rank, pkg)
            for child in boot.metrics:
                child.dist_sync_fn = gather
            return _np(boot.compute())

        return run

    got, want = world.run(body("port")), World(2).run(body("jax"))
    for r in range(2):
        _assert_equal(got[r], want[r], rtol=1e-6, what=f"bootstrap rank {r}")


def test_exact_list_state_with_an_empty_rank():
    """An ``exact=True`` rank that saw no batch still gathers (zero rows):
    no rank waits on it. Rank 0 computes over the union (its own rows);
    rank 1 (no input mode yet, so it cannot compute) syncs alongside and
    holds rank 0's rows."""
    p, t = _binary(3, 40)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        metrics = [tm.AUROC(exact=True, device="cpu") for _ in range(2)]
    metrics[0].update(torch.from_numpy(p), torch.from_numpy(t))

    def body(rank, gather):
        m = metrics[rank]
        if rank == 0:
            m.dist_sync_fn = gather
            return float(m.compute())
        m.sync(dist_sync_fn=gather)
        rows = (m.preds.numpy(), m.target.numpy())
        m.unsync()
        return rows

    value, rows = World(2).run(body)
    assert abs(value - float(np.asarray(jax_auroc(jnp.asarray(p), jnp.asarray(t))))) < 1e-6
    np.testing.assert_array_equal(rows[0], p)
    np.testing.assert_array_equal(rows[1], t)
    assert metrics[1].preds == [] and metrics[0].preds[0].shape == (40,)


def test_retrieval_exact_lists_keep_their_entries_rank_by_rank():
    world = World(2)
    batches = {r: _retrieval_batches(r) for r in range(2)}

    def body(rank, gather):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m = tm.RetrievalMAP(exact=True, device="cpu")
        for p, t, i in batches[rank][: rank + 1]:
            m.update(torch.from_numpy(p), torch.from_numpy(t), indexes=torch.from_numpy(i))
        m.sync(dist_sync_fn=gather)
        return [x.numpy() for x in m.indexes]

    out = world.run(body)
    want = [batches[0][0][2], batches[1][0][2], batches[1][1][2]]
    for got in out:
        assert len(got) == 3 and all(np.array_equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# the sketch occupancy bounds through a sync
# ---------------------------------------------------------------------------


def _count_compactions(monkeypatch):
    calls = []
    inner = quantile.qsketch_compact_dispatch

    def counting(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    monkeypatch.setattr(quantile, "qsketch_compact_dispatch", counting)
    return calls


@pytest.mark.parametrize("n_ranks", [2, 3])
def test_a_union_that_fits_compacts_nothing(monkeypatch, n_ranks):
    metrics = [tm.AUROC(sketch_capacity=256, device="cpu") for _ in range(n_ranks)]
    for r, m in enumerate(metrics):
        p, t = _binary(r, 80)
        m.update(torch.from_numpy(p), torch.from_numpy(t))
    stacks = [m.csketch for m in metrics]
    calls = _count_compactions(monkeypatch)
    World(n_ranks).run(lambda r, g: metrics[r].sync(dist_sync_fn=g))
    assert calls == []  # the bounds came with the gathered sketches
    merged = metrics[0].csketch
    want = torch.cat([s[: 80] for s in stacks])
    assert torch.equal(merged[: 80 * n_ranks], want) and not merged[80 * n_ranks :].any()
    # without the bounds (a bare stack), each merge compacts: same bits
    bare = sketch_merge_fx()(torch.stack(stacks))
    assert len(calls) == n_ranks - 1 and torch.equal(bare, merged)


def test_an_overflowing_union_still_compacts(monkeypatch):
    metrics = [tm.AUROC(sketch_capacity=256, device="cpu") for _ in range(2)]
    for r, m in enumerate(metrics):
        p, t = _binary(r, 200)
        m.update(torch.from_numpy(p), torch.from_numpy(t))
    calls = _count_compactions(monkeypatch)
    World(2).run(lambda r, g: metrics[r].sync(dist_sync_fn=g))
    # one merge on each rank
    assert len(calls) == 2 and quantile.fill_bound(metrics[0].csketch) == 256


# ---------------------------------------------------------------------------
# fused and async updates across a sync; the sliced read
# ---------------------------------------------------------------------------


def test_fused_states_come_back_as_the_same_objects():
    col = tm.MetricCollection([tm.MeanSquaredError(device="cpu"), tm.MeanAbsoluteError(device="cpu")])
    preds, target = torch.tensor([0, 1, 2, 1]), torch.tensor([0, 2, 2, 1])
    col.update(preds.float(), target.float())  # discovers the groups
    col.compile_update()
    col.update(preds.float(), target.float())
    members = list(col.values())
    before = [{k: getattr(m, k) for k in m._defaults} for m in members]
    for m in members:
        m.sync(dist_sync_fn=lambda x, group=None: [x, x])
    with pytest.raises(MetricsUserError, match="shouldn't be synced"):
        col.update(preds.float(), target.float())
    for m, states in zip(members, before):
        m.unsync()
        assert all(getattr(m, k) is v for k, v in states.items())
    col.update(preds.float(), target.float())


def test_async_compute_drains_before_a_sync():
    col = tm.MetricCollection([tm.SumMetric(device="cpu", dist_sync_fn=lambda x, group=None: [x, x])])
    handle = col.compile_update_async(max_staleness=8)
    for v in range(5):
        col.update_async(torch.tensor(float(v)))
    out = col.compute()
    assert handle.pending == 0 and float(out["SumMetric"]) == 2 * 10.0
    handle.close()


def test_sliced_synced_read_folds_every_slice_and_keeps_the_local_cache():
    ids = [torch.tensor([0, 1]), torch.tensor([2, 3])]
    metrics = [tm.SlicedMetric(tm.MeanSquaredError(device="cpu"), 4) for _ in range(2)]
    for r, m in enumerate(metrics):
        m.update(ids[r], torch.tensor([1.0, 2.0]), torch.tensor([0.0, 0.0]))
        m.compute()  # local values kept, dirty bitmap clear
    synced = World(2).run(lambda r, g: (metrics[r].__setattr__("dist_sync_fn", g), metrics[r].compute())[1])
    for values in synced:
        assert values.tolist() == [1.0, 4.0, 1.0, 4.0]
    for r, m in enumerate(metrics):
        m.dist_sync_fn = None
        local = m.compute()
        assert torch.isnan(local).tolist() == [r == 1, r == 1, r == 0, r == 0]
        assert not m._dirty[:4].any()


# ---------------------------------------------------------------------------
# one-round sync against the JAX package's mesh sync
# ---------------------------------------------------------------------------


def _pytree_ranks(n):
    rng = np.random.RandomState(5)
    ranks = []
    for r in range(n):
        sk = np.zeros((128, 3), np.float32)
        sk[: 5 + r, 0] = 1.0
        sk[: 5 + r, 1] = rng.rand(5 + r)
        sk[: 5 + r, 2] = rng.randint(0, 2, 5 + r)
        mx = rng.randn(4).astype(np.float32)
        mx[r % 4] = -0.0 if r % 2 else 0.0
        ranks.append(
            {
                "a": {
                    "s": rng.randn(5).astype(np.float32),
                    "s2": rng.randn(2, 3).astype(np.float32),
                    "i": rng.randint(-5, 5, 6).astype(np.int32),
                    "m": rng.randn(3).astype(np.float32),
                    "mx": mx,
                    "mn": rng.randn(4).astype(np.float32),
                },
                "sk": {"csketch": sk, "n_seen": np.asarray(5 + r, np.int32)},
            }
        )
    return ranks


def _pytree_reductions(sketch_fx):
    return {
        "a": {"s": "sum", "s2": "sum", "i": "sum", "m": "mean", "mx": "max", "mn": "min"},
        "sk": {"csketch": sketch_fx, "n_seen": "sum"},
    }


def test_sync_pytree_matches_sync_pytree_in_mesh():
    n = 8
    ranks = _pytree_ranks(n)
    leaves = [("a", k) for k in ("s", "s2", "i", "m", "mx", "mn")] + [("sk", "csketch"), ("sk", "n_seen")]
    stacked = [jnp.stack([jnp.asarray(r[a][b]) for r in ranks]) for a, b in leaves]
    reds = _pytree_reductions(jax_sketch_merge_fx())
    mesh = Mesh(np.array(jax.devices()[:n]), ("rank",))

    def body(*xs):
        state = {}
        for (a, b), x in zip(leaves, xs):
            state.setdefault(a, {})[b] = x[0]
        out = sync_pytree_in_mesh(state, reds, "rank")
        return tuple(out[a][b] for a, b in leaves)

    want = jax.jit(
        shard_map(body, mesh=mesh, in_specs=tuple(P("rank") for _ in leaves), out_specs=tuple(P() for _ in leaves))
    )(*stacked)

    def run(rank, gather):
        state = {a: {b: torch.from_numpy(np.asarray(v)) for b, v in d.items()} for a, d in ranks[rank].items()}
        quantile.with_fill_bound(state["sk"]["csketch"], 5 + rank)
        return sync_pytree(state, _pytree_reductions(sketch_merge_fx()), dist_sync_fn=gather)

    got = World(n).run(run)
    for r in range(n):
        for (a, b), w in zip(leaves, want):
            rtol = 1e-6 if b in ("s", "s2", "m") else 0.0
            _assert_equal(got[r][a][b].numpy(), np.asarray(w), rtol=rtol, what=f"rank {r} {a}/{b}")
            # every rank holds the same bits, the rank-order fold's
            assert np.array_equal(_bits(got[r][a][b].numpy()), _bits(got[0][a][b].numpy()))
    s = np.stack([r["a"]["s"] for r in ranks])
    fold = s[0]
    for row in s[1:]:
        fold = fold + row
    assert np.array_equal(got[0]["a"]["s"].numpy(), fold)


def test_sync_pytree_extrema_take_the_jax_semantics():
    """NaN wins and +0.0 ranks above -0.0 (``jnp.maximum``/``jnp.minimum``
    folded in rank order). The JAX package's mesh all-reduce drops a NaN on
    the CPU; the port's fold follows the elementwise semantics instead."""
    ranks = [
        np.array([np.nan, -0.0, 0.0, 1.0], np.float32),
        np.array([1.0, 0.0, -0.0, -np.inf], np.float32),
        np.array([2.0, -0.0, -0.0, np.inf], np.float32),
    ]
    for red, fold in (("max", jnp.maximum), ("min", jnp.minimum)):
        want = jnp.asarray(ranks[0])
        for x in ranks[1:]:
            want = fold(want, jnp.asarray(x))
        got = World(3).run(
            lambda r, g, red=red: sync_pytree({"x": torch.from_numpy(ranks[r])}, {"x": red}, dist_sync_fn=g)["x"]
        )
        for out in got:
            _assert_equal(out.numpy(), np.asarray(want), what=red)


def test_sync_pytree_collection_and_fallback_leaves_match_metric_sync():
    """A collection's nested states: one gather per (reduction, dtype)
    group and per sketch dtype, a gather each for the cat and list leaves;
    the result equals each member's own ``sync``."""
    n = 3

    def make():
        return tm.MetricCollection(
            {
                "mse": tm.MeanSquaredError(device="cpu"),
                "cm": tm.ConfusionMatrix(num_classes=3, device="cpu"),
                "max": tm.MaxMetric(device="cpu"),
                "sketch": tm.AUROC(sketch_capacity=64, device="cpu"),
                "buffer": tm.AUROC(capacity=16, device="cpu"),
            },
            compute_groups=False,
        )

    cols = [make() for _ in range(n)]
    for r, col in enumerate(cols):
        p, t = _binary(r, 12)
        for name, m in col.items():
            if name == "cm":
                m.update(torch.from_numpy(t), torch.from_numpy((p > 0.5).astype(np.int64)))
            elif name == "max":
                m.update(torch.from_numpy(p))
            else:
                m.update(torch.from_numpy(p), torch.from_numpy(t.astype(np.float32) if name == "mse" else t))
    calls = []

    def run(rank, gather):
        def counted(x, group=None):
            calls.append(rank)
            return gather(x, group)

        col = cols[rank]
        state = {name: {k: getattr(m, k) for k in m._defaults} for name, m in col.items()}
        return sync_pytree(state, col.state_reductions(), dist_sync_fn=counted)

    got = World(n).run(run)
    # the float32 sum (MSE), the int32 sums (MSE total, confmat, the
    # sketch's n_seen and the buffer's overflow), the max; one sketch
    # dtype; three cat leaves (the capacity buffers)
    assert calls.count(0) == 3 + 1 + 3
    want = World(n).run(lambda r, g: [(m.sync(dist_sync_fn=g), {k: getattr(m, k) for k in m._defaults})[1] for m in cols[r].values()])
    for r in range(n):
        for (name, _), states in zip(cols[r].items(), want[r]):
            for k, v in states.items():
                # a cat tensor leaf: concatenated here, stacked by the
                # member's sync (as the JAX package's two paths do)
                flat = name == "buffer" and k in ("preds", "target", "valid")
                g, w = _np(got[r][name][k]), _np(v)
                if flat:
                    g, w = g.reshape(-1), w.reshape(-1)
                _assert_equal(g, w, rtol=1e-6, what=f"{name}.{k}")


# ---------------------------------------------------------------------------
# the sync arguments through every class
# ---------------------------------------------------------------------------


def _classes(modules, base):
    out = {}
    for mod in modules:
        for name in dir(mod):
            obj = getattr(mod, name)
            if inspect.isclass(obj) and issubclass(obj, base) and not inspect.isabstract(obj):
                out[name] = obj
    return out


def _takes_kwargs(cls):
    return any(p.kind == p.VAR_KEYWORD for p in inspect.signature(cls.__init__).parameters.values())


#: the constructor arguments each class needs besides the sync ones
_NEEDS = {
    "BootStrapper": lambda: (tm.MeanSquaredError(device="cpu"),),
    "MinMaxMetric": lambda: (tm.MeanSquaredError(device="cpu"),),
    "SlicedMetric": lambda: (tm.MeanSquaredError(device="cpu"), 3),
    "WindowedMetric": lambda: (tm.MeanSquaredError(device="cpu"),),
    "ConfusionMatrix": lambda: (3,),
    "CohenKappa": lambda: (3,),
    "MatthewsCorrCoef": lambda: (3,),
    "JaccardIndex": lambda: (3,),
    "BinnedAveragePrecision": lambda: (3, 10),
    "BinnedPrecisionRecallCurve": lambda: (3, 10),
    "BinnedRecallAtFixedPrecision": lambda: (3, 0.5, 10),
    "PermutationInvariantTraining": lambda: (tm.functional.signal_noise_ratio,),
}


def test_every_class_whose_jax_counterpart_takes_kwargs_takes_the_sync_arguments():
    jax_classes = _classes(
        [metrics_tpu, metrics_tpu.sliced, metrics_tpu.windowed, metrics_tpu.wrappers, metrics_tpu.detection],
        metrics_tpu.Metric,
    )
    port_classes = _classes(
        [tm, metrics_tpu_torch.sliced, metrics_tpu_torch.windowed, metrics_tpu_torch.wrappers], Metric
    )
    checked = []
    for name, cls in sorted(port_classes.items()):
        if name not in jax_classes or not _takes_kwargs(jax_classes[name]):
            continue
        assert _takes_kwargs(cls), name
        args = _NEEDS.get(name, lambda: ())()
        kw = {} if name in ("BootStrapper", "MinMaxMetric", "SlicedMetric", "WindowedMetric") else {"device": "cpu"}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m = cls(*args, dist_sync_on_step=True, dist_sync_fn=lambda x, group=None: [x], **kw)
        assert m.dist_sync_on_step is True and m.dist_sync_fn is not None, name
        checked.append(name)
    assert len(checked) >= 50, checked
    for name in ("SlicedMetric", "WindowedMetric", "BootStrapper", "MinMaxMetric", "RetrievalMAP", "MeanMetric", "MeanAveragePrecision"):
        assert name in checked
