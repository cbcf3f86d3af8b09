"""The async update pipeline (``core/pipeline.py``) on the CPU.

The contracts of the JAX package's ``tests/bases/test_pipeline.py`` that
need no telemetry: bit parity with the blocking fused update across
reducers (sum, max, mean with the in-program counter bump, a custom
reducer, compute groups), FIFO interleaving of blocking and async updates,
the ``block``/``drop``/``error`` policies, bounded-staleness compute, worker
errors surfacing with their batch index and poisoning the handle until
``reset()``, flush/close/drain, the invalidations (reset, add_metrics,
setitem, clone, to_device), the state-access guards (state_dict,
load_state_dict, clone drain) and the freshness stamp. On the CPU the
worker runs the fused update's plain version; on the card it replays the
graphs on its own CUDA stream (``chip_smoke.py``'s async phase).
"""
import gc
import threading
import time

import numpy as np
import pytest
import torch

import metrics_tpu_torch as tm
from metrics_tpu_torch import MetricCollection
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.core.pipeline import _SHUTDOWN, AsyncQueueFull, AsyncWorkerError
from metrics_tpu_torch.observability.freshness import IDENTITY, FreshnessStamp
from metrics_tpu_torch.utils.exceptions import MetricsUserError

torch.set_num_threads(2)

_SLOW = 0.05

_WORKER_NAME = "metrics-tpu-torch-async-update"


def _threads_since(before):
    """The live threads that were not in ``before`` (a set taken from
    ``threading.enumerate()``). Threads that other tests in the same process
    left behind, or that end meanwhile, do not change the answer; a worker
    this test started and leaked does."""
    return [t for t in threading.enumerate() if t not in before]


def _cls_batch(rng, n=64, c=3):
    preds = rng.rand(n, c).astype(np.float32)
    preds /= preds.sum(-1, keepdims=True)
    return torch.from_numpy(preds), torch.from_numpy(rng.randint(0, c, n))


class _MaxAbs(Metric):
    def __init__(self):
        super().__init__(device="cpu")
        self.add_state("biggest", default=torch.tensor(0.0), dist_reduce_fx="max")

    def _update(self, preds, target):
        self.biggest = torch.maximum(self.biggest, preds.abs().max())

    def _compute(self):
        return self.biggest


class _RunningMean(Metric):
    def __init__(self):
        super().__init__(device="cpu")
        self.add_state("avg", default=torch.tensor(0.0), dist_reduce_fx="mean")

    def _update(self, preds, target):
        self.avg = (self.avg + preds.mean()) / 2

    def _compute(self):
        return self.avg


def _colsum(stacked):
    return stacked.sum(dim=0)


class _CustomReduced(Metric):
    def __init__(self):
        super().__init__(device="cpu")
        self.add_state("cols", default=torch.zeros(3), dist_reduce_fx=_colsum)

    def _update(self, preds, target):
        self.cols = self.cols + preds.sum(dim=0)

    def _compute(self):
        return self.cols


class _SlowSum(Metric):
    """Counts applied batches with a slow eager update."""

    __jit_unsafe__ = True

    def __init__(self, delay=_SLOW):
        super().__init__(device="cpu")
        self.delay = delay
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def _update(self, preds, target):
        time.sleep(self.delay)
        self.total = self.total + 1.0

    def _compute(self):
        return self.total


class _ExplodingSum(Metric):
    """Raises on the poison marker (first element negative)."""

    __jit_unsafe__ = True

    def __init__(self):
        super().__init__(device="cpu")
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def _update(self, preds, target):
        if float(preds.reshape(-1)[0]) < 0:
            raise ValueError("poison batch")
        self.total = self.total + 1.0

    def _compute(self):
        return self.total


def _reducer_collection():
    return MetricCollection(
        [tm.Accuracy(device="cpu"), tm.ConfusionMatrix(num_classes=3, device="cpu"), _MaxAbs(), _RunningMean(), _CustomReduced()]
    )


def _state_items(col):
    for name, m in col.items(keep_base=True):
        for sname in m._defaults:
            yield f"{name}.{sname}", torch.as_tensor(getattr(m, sname))


def _poison_batch(rng):
    preds, target = _cls_batch(rng)
    preds[0, 0] = -1.0
    return preds, target


# ---------------------------------------------------------------------------
# parity with the blocking fused update
# ---------------------------------------------------------------------------


def test_bit_identical_states_across_reducers():
    rng = np.random.RandomState(0)
    batches = [_cls_batch(rng) for _ in range(6)]
    blocking, asynchronous = _reducer_collection(), _reducer_collection()
    blocking.update(*batches[0])
    asynchronous.update(*batches[0])
    blocking.compile_update()
    handle = asynchronous.compile_update_async(queue_depth=2)
    for b in batches[1:]:
        blocking.update(*b)
        assert handle.update_async(*b) is True
    handle.flush()
    for (ka, va), (kb, vb) in zip(_state_items(asynchronous), _state_items(blocking)):
        assert ka == kb and torch.equal(va, vb), ka
    res_b, res_a = blocking.compute(), asynchronous.compute()
    assert res_b.keys() == res_a.keys() and all(torch.equal(res_b[k], res_a[k]) for k in res_b)
    handle.close()


def test_blocking_update_interleaves_fifo():
    rng = np.random.RandomState(1)
    batches = [_cls_batch(rng) for _ in range(5)]
    reference, mixed = _reducer_collection(), _reducer_collection()
    reference.update(*batches[0])
    mixed.update(*batches[0])
    reference.compile_update()
    handle = mixed.compile_update_async()
    for i, b in enumerate(batches[1:]):
        reference.update(*b)
        if i % 2 == 0:
            handle.update_async(*b)
        else:
            mixed.update(*b)  # through the handle, in FIFO order
    handle.flush()
    for (ka, va), (_, vb) in zip(_state_items(mixed), _state_items(reference)):
        assert torch.equal(va, vb), ka
    handle.close()


def test_compute_default_drains_everything():
    rng = np.random.RandomState(2)
    col = MetricCollection([_SlowSum(delay=0.01)])
    col.update(*_cls_batch(rng))
    handle = col.compile_update_async(queue_depth=4)
    for _ in range(4):
        handle.update_async(*_cls_batch(rng))
    assert float(col.compute()["_SlowSum"]) == 5.0
    assert handle.pending == 0
    handle.close()


# ---------------------------------------------------------------------------
# backpressure
# ---------------------------------------------------------------------------


def test_block_policy_is_lossless_and_blocks():
    rng = np.random.RandomState(3)
    col = MetricCollection([_SlowSum()])
    col.update(*_cls_batch(rng))
    handle = col.compile_update_async(queue_depth=1, policy="block")
    t0 = time.perf_counter()
    for _ in range(4):
        handle.update_async(*_cls_batch(rng))
    assert time.perf_counter() - t0 >= _SLOW
    handle.flush()
    assert (handle.enqueued, handle.applied, handle.dropped) == (4, 4, 0)
    assert float(col.compute()["_SlowSum"]) == 5.0
    handle.close()


def test_drop_policy_discards_and_counts():
    rng = np.random.RandomState(4)
    col = MetricCollection([_SlowSum()])
    col.update(*_cls_batch(rng))
    handle = col.compile_update_async(queue_depth=1, policy="drop")
    accepted = sum(handle.update_async(*_cls_batch(rng)) for _ in range(8))
    handle.flush()
    assert accepted < 8
    assert handle.dropped == 8 - accepted and handle.enqueued == handle.applied == accepted
    assert float(col.compute()["_SlowSum"]) == accepted + 1
    handle.close()


def test_error_policy_raises_queue_full():
    rng = np.random.RandomState(5)
    col = MetricCollection([_SlowSum()])
    col.update(*_cls_batch(rng))
    handle = col.compile_update_async(queue_depth=1, policy="error")
    with pytest.raises(AsyncQueueFull):
        for _ in range(10):
            handle.update_async(*_cls_batch(rng))
    handle.flush()
    handle.close()


def test_block_policy_raises_when_worker_dead():
    rng = np.random.RandomState(34)
    col = MetricCollection([_SlowSum(delay=0.0)])
    col.update(*_cls_batch(rng))
    handle = col.compile_update_async(queue_depth=1, policy="block")
    handle.flush()
    handle._queue.put(_SHUTDOWN)  # stop the worker out of band
    handle._thread.join(timeout=5.0)
    assert not handle._thread.is_alive()
    assert handle.update_async(*_cls_batch(rng))  # an empty queue: accepted
    with pytest.raises(MetricsUserError):
        handle.update_async(*_cls_batch(rng))  # full queue, dead worker
    handle.close()
    assert handle.closed


def test_invalid_policy_depth_and_bound_rejected():
    col = MetricCollection([tm.Accuracy(device="cpu")])
    for kw in ({"policy": "spill"}, {"queue_depth": 0}, {"max_staleness": -1}):
        with pytest.raises(ValueError):
            col.compile_update_async(**kw)
    assert col.async_update is None


# ---------------------------------------------------------------------------
# bounded staleness
# ---------------------------------------------------------------------------


def test_bounded_staleness_returns_early():
    rng = np.random.RandomState(6)
    delay = 0.1
    col = MetricCollection([_SlowSum(delay=delay)])
    col.update(*_cls_batch(rng))
    handle = col.compile_update_async(queue_depth=8)
    for _ in range(6):
        handle.update_async(*_cls_batch(rng))
    t0 = time.perf_counter()
    res = handle.compute(max_staleness=4)
    t_bounded = time.perf_counter() - t0
    assert float(res["_SlowSum"]) >= 3.0 and handle.pending <= 4
    t1 = time.perf_counter()
    handle.flush()
    t_flush = time.perf_counter() - t1
    assert t_bounded < 5 * delay or t_flush > delay
    assert float(handle.compute()["_SlowSum"]) == 7.0 and handle.pending == 0
    handle.close()


def test_stale_compute_cache_invalidated_by_inflight_batches():
    class _SlowCompute(Metric):
        __jit_unsafe__ = True

        def __init__(self):
            super().__init__(device="cpu")
            self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

        def _update(self, preds, target):
            time.sleep(0.02)
            self.total = self.total + 1.0

        def _compute(self):
            snap = self.total
            time.sleep(0.15)  # batches land while this compute runs
            return snap

    rng = np.random.RandomState(22)
    col = MetricCollection([_SlowCompute()])
    col.update(*_cls_batch(rng))
    handle = col.compile_update_async(queue_depth=8)
    for _ in range(6):
        handle.update_async(*_cls_batch(rng))
    assert float(handle.compute(max_staleness=4)["_SlowCompute"]) <= 7.0
    handle.flush()
    assert float(col.compute()["_SlowCompute"]) == 7.0
    handle.close()


def test_compute_never_overlaps_an_inflight_update():
    rng = np.random.RandomState(30)
    col = MetricCollection([tm.Accuracy(device="cpu")])
    col.update(*_cls_batch(rng))
    handle = col.compile_update_async(queue_depth=4, max_staleness=8)
    in_dispatch, release = threading.Event(), threading.Event()
    real = handle._fused.dispatch

    def gated(args, kwargs):
        in_dispatch.set()
        assert release.wait(5)
        real(args, kwargs)

    handle._fused.dispatch = gated
    try:
        handle.update_async(*_cls_batch(rng))
        assert in_dispatch.wait(5)
        out = {}
        t = threading.Thread(target=lambda: out.setdefault("res", col.compute()))
        t.start()
        t.join(0.3)
        assert t.is_alive(), "compute() overlapped an in-flight update"
        release.set()
        t.join(5)
        assert not t.is_alive() and "res" in out
    finally:
        release.set()
        handle._fused.dispatch = real
    handle.flush()
    handle.close()


def test_stale_handle_compute_rejected():
    rng = np.random.RandomState(43)
    col = MetricCollection([_SlowSum(delay=0.0)])
    col.update(*_cls_batch(rng))
    h1 = col.compile_update_async()
    h2 = col.compile_update_async()  # drains and replaces h1
    with pytest.raises(MetricsUserError):
        h1.compute(max_staleness=0)
    assert "_SlowSum" in h2.compute()
    with pytest.raises(ValueError):
        h2.compute(max_staleness=-2)
    h2.close()
    with pytest.raises(MetricsUserError):
        h2.compute()


# ---------------------------------------------------------------------------
# worker errors
# ---------------------------------------------------------------------------


def test_worker_error_reraised_with_batch_index_and_cause():
    rng = np.random.RandomState(8)
    col = MetricCollection([_ExplodingSum()])
    col.update(*_cls_batch(rng))
    handle = col.compile_update_async(queue_depth=8)
    with pytest.raises(AsyncWorkerError) as err:
        for i in range(5):
            handle.update_async(*(_poison_batch(rng) if i == 3 else _cls_batch(rng)))
        handle.flush()
    assert err.value.batch_index == 3 and isinstance(err.value.__cause__, ValueError)
    with pytest.raises(AsyncWorkerError):  # the poison sticks
        handle.update_async(*_cls_batch(rng))
    assert handle.applied == 3
    handle.close()


def test_compute_reraises_and_reset_recovers():
    rng = np.random.RandomState(9)
    col = MetricCollection([_ExplodingSum()])
    col.update(*_cls_batch(rng))
    handle = col.compile_update_async(queue_depth=8)
    handle.update_async(*_poison_batch(rng))
    with pytest.raises(AsyncWorkerError):
        col.compute()
    with pytest.raises(AsyncWorkerError) as err:  # a re-compile surfaces it too
        col.compile_update_async()
    assert err.value.batch_index == 0
    col.reset()
    h2 = col.compile_update_async()
    assert h2 is not handle and not h2.closed
    h2.update_async(*_cls_batch(rng))
    assert float(col.compute()["_ExplodingSum"]) == 1.0
    h2.close()


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------


def test_flush_is_idempotent_and_close_joins_the_worker():
    rng = np.random.RandomState(10)
    before = set(threading.enumerate())
    col = _reducer_collection()
    col.update(*_cls_batch(rng))
    handle = col.compile_update_async()
    assert _threads_since(before) == [handle._thread] and handle._thread.name == _WORKER_NAME
    for _ in range(3):
        handle.update_async(*_cls_batch(rng))
    assert handle.flush() >= 0
    assert handle.flush() == 0 and handle.applied == 3
    handle.close()
    handle.close()
    assert not handle._thread.is_alive() and _threads_since(before) == []


def test_close_drains_by_default_and_discards_when_flagged():
    rng = np.random.RandomState(12)
    col = MetricCollection([_SlowSum(delay=0.01)])
    col.update(*_cls_batch(rng))
    handle = col.compile_update_async(queue_depth=8)
    for _ in range(4):
        handle.update_async(*_cls_batch(rng))
    handle.close()
    assert handle.applied == 4 and float(col.compute()["_SlowSum"]) == 5.0
    handle = col.compile_update_async(queue_depth=4)
    handle._discard = True  # the close(drain=False) race window
    handle.update_async(*_cls_batch(rng))
    handle.flush()
    assert handle.applied == 0
    handle._discard = False
    assert float(col.compute()["_SlowSum"]) == 5.0
    handle.close()


def test_abandoned_handle_does_not_leak_its_worker():
    rng = np.random.RandomState(33)
    before = set(threading.enumerate())
    col = _reducer_collection()
    col.update(*_cls_batch(rng))
    handle = col.compile_update_async()
    handle.update_async(*_cls_batch(rng))
    handle.flush()
    thread = handle._thread
    assert thread.name == _WORKER_NAME and _threads_since(before) == [thread]
    del handle, col
    gc.collect()
    thread.join(timeout=5.0)
    assert not thread.is_alive() and _threads_since(before) == []


def test_closed_handle_rejects_updates_and_the_collection_goes_on():
    rng = np.random.RandomState(13)
    col = _reducer_collection()
    col.update(*_cls_batch(rng))
    handle = col.compile_update_async()
    handle.close()
    with pytest.raises(MetricsUserError):
        handle.update_async(*_cls_batch(rng))
    col.update(*_cls_batch(rng))  # the blocking fused update
    with pytest.raises(MetricsUserError):
        MetricCollection([tm.Accuracy(device="cpu")]).update_async(*_cls_batch(rng))


def test_reset_invalidates_and_discards():
    rng = np.random.RandomState(14)
    before = set(threading.enumerate())
    col = MetricCollection([_SlowSum()])
    col.update(*_cls_batch(rng))
    handle = col.compile_update_async(queue_depth=8)
    assert handle._thread.name == _WORKER_NAME and _threads_since(before) == [handle._thread]
    fused = col.fused_update
    for _ in range(4):
        handle.update_async(*_cls_batch(rng))
    col.reset()
    assert col.async_update is None and handle.closed
    assert not handle._thread.is_alive() and _threads_since(before) == []
    assert col.fused_update is fused  # reset keeps the fused handle
    with pytest.raises(MetricsUserError):
        handle.update_async(*_cls_batch(rng))
    col.update(*_cls_batch(rng))
    assert float(col.compute()["_SlowSum"]) == 1.0


def test_membership_changes_clone_and_to_device_invalidate():
    rng = np.random.RandomState(15)
    col = _reducer_collection()
    col.update(*_cls_batch(rng))
    handle = col.compile_update_async()
    col.add_metrics({"extra": _SlowSum(delay=0.0)})
    assert handle.closed and col.async_update is None and col.fused_update is None
    handle = col.compile_update_async()
    col["more"] = _MaxAbs()  # dict-style insert
    assert handle.closed and col.async_update is None
    handle = col.compile_update_async()
    clone = col.clone(prefix="c_")
    assert clone.async_update is None and clone.fused_update is None
    clone.update(*_cls_batch(rng))
    col.to_device("cpu")
    assert handle.closed and col.fused_update is None


def test_compile_update_config_change_rejected_while_async_open():
    rng = np.random.RandomState(44)
    col = MetricCollection([_SlowSum(delay=0.0)])
    col.update(*_cls_batch(rng))
    handle = col.compile_update_async()
    assert col.compile_update() is col.fused_update
    # use_manifest is part of the config, as in the JAX package
    with pytest.raises(MetricsUserError):
        col.compile_update(use_manifest=False)
    with pytest.raises(MetricsUserError):
        col.compile_update(buckets=(64,))
    handle.close()
    assert col.compile_update(buckets=(64,)) is col.fused_update
    assert col.compile_update(buckets=(64,), use_manifest=False) is col.fused_update


def test_async_compute_hands_out_no_donated_state():
    """The value compute() returns through a donating async handle is a
    copy, so the worker's later batches cannot change it."""
    rng = np.random.RandomState(45)
    col = MetricCollection([tm.ConfusionMatrix(num_classes=3, device="cpu")])
    col.update(*_cls_batch(rng))
    handle = col.compile_update_async(donate=True)
    handle.update_async(*_cls_batch(rng))
    kept = handle.compute()["ConfusionMatrix"]
    frozen = kept.clone()
    state = col["ConfusionMatrix"].confmat
    assert kept.untyped_storage().data_ptr() != state.untyped_storage().data_ptr()
    for _ in range(3):
        handle.update_async(*_cls_batch(rng))
    handle.flush()
    assert torch.equal(kept, frozen)
    assert int(handle.compute()["ConfusionMatrix"].sum()) == 5 * 64
    handle.close()


def test_epoch_resume_reuses_the_warm_fused_handle():
    rng = np.random.RandomState(30)
    col = _reducer_collection()
    col.update(*_cls_batch(rng))
    h1 = col.compile_update_async()
    fused = col.fused_update
    h1.update_async(*_cls_batch(rng))
    col.reset()
    h2 = col.compile_update_async()
    assert h2 is not h1 and h1.closed and col.fused_update is fused
    h2.update_async(*_cls_batch(rng))
    h2.flush()
    h2.close()


# ---------------------------------------------------------------------------
# state-access guards and freshness
# ---------------------------------------------------------------------------


def test_state_dict_load_and_clone_drain_first():
    rng = np.random.RandomState(36)
    col = MetricCollection([_SlowSum(delay=0.02)])
    col.update(*_cls_batch(rng))
    handle = col.compile_update_async(queue_depth=8)
    for _ in range(4):
        handle.update_async(*_cls_batch(rng))
    assert float(col.state_dict()["_SlowSum.total"]) == 5.0 and handle.pending == 0
    for _ in range(3):
        handle.update_async(*_cls_batch(rng))
    mc = col.clone()
    assert mc.async_update is None and float(mc.compute()["_SlowSum"]) == 8.0
    handle.update_async(*_cls_batch(rng))
    col.load_state_dict(MetricCollection([_SlowSum(delay=0.0)]).state_dict())
    assert handle.pending == 0 and float(col.compute()["_SlowSum"]) == 0.0
    handle.close()


def test_freshness_stamp():
    rng = np.random.RandomState(39)
    col = MetricCollection([_SlowSum(delay=0.05)])
    col.update(*_cls_batch(rng))
    assert col.freshness() == IDENTITY
    handle = col.compile_update_async(queue_depth=8)
    assert handle.freshness().is_identity
    t0 = time.time()
    for _ in range(3):
        handle.update_async(*_cls_batch(rng))
    stamp = handle.freshness(now=t0 + 10.0)
    assert stamp.async_age_s > 0.0  # batches accepted but not yet applied
    handle.flush()
    stamp = col.freshness(now=t0 + 10.0)
    assert stamp.async_age_s == 0.0 and t0 <= stamp.min_event_t <= stamp.max_event_t
    merged = stamp.merge(FreshnessStamp(min_event_t=t0 - 1.0, ring_span_s=2.0))
    assert merged.min_event_t == t0 - 1.0 and merged.ring_span_s == 2.0
    assert FreshnessStamp.from_payload(stamp.to_payload()) == stamp
    handle.close()


def test_stress_producer_reader_and_worker():
    """One producer, a thread of bounded-staleness readers and the worker,
    with a short switch interval: every accepted batch lands exactly once,
    and each snapshot sits between whole batches (the count and the
    confusion matrix agree)."""
    import sys

    rng = np.random.RandomState(45)
    batches = [_cls_batch(rng, n=8) for _ in range(16)]
    col = MetricCollection([tm.ConfusionMatrix(num_classes=3, device="cpu"), _SlowSum(delay=0.0)])
    col.update(*batches[0])
    handle = col.compile_update_async(queue_depth=2, max_staleness=3)
    errors, snapshots = [], []
    stop = threading.Event()

    def reader():
        try:
            while not stop.is_set():
                values = handle.compute()
                snapshots.append((int(values["ConfusionMatrix"].sum()), float(values["_SlowSum"])))
        except Exception as err:  # noqa: BLE001 -- reported below
            errors.append(err)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=reader) for _ in range(3)]
        for t in threads:
            t.start()
        for i in range(200):
            handle.update_async(*batches[i % len(batches)])
        handle.flush()
        stop.set()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
        stop.set()
    assert not errors
    assert handle.applied == handle.enqueued == 200
    assert all(total == 8 * count for total, count in snapshots)
    values = col.compute()
    assert int(values["ConfusionMatrix"].sum()) == 8 * 201 and float(values["_SlowSum"]) == 201.0
    handle.close()
