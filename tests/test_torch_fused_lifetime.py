"""A fused handle's lifetime is its collection's (the port's own contract).

The collection holds its ``FusedUpdate`` and ``AsyncUpdateHandle``; the
handles hold the collection weakly, so dropping the last reference to a
collection frees the handles, their graphs, private pools and static
buffers by reference count. Every test here runs with Python's cyclic
collector off: a handle that only ``gc.collect()`` frees is the fault
(on the card such handles held 37.8 GiB of graph pools late in one
whole-script run of ``chip_smoke.py``). On the CPU there is no graph, so
``_fused_plane_nbytes()`` reads 0 whatever lives; the tests hold the
handles themselves through ``_LIVE_FUSED`` and weak references.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

import metrics_tpu_torch as tm
from metrics_tpu_torch import MetricCollection
from metrics_tpu_torch.core import fused
from metrics_tpu_torch.sliced import SlicedMetric
from metrics_tpu_torch.utils.exceptions import MetricsUserError
from metrics_tpu_torch.windowed import WindowedMetric

torch.set_num_threads(2)

_rng = np.random.default_rng(0)
_PROBS = torch.from_numpy(_rng.random((64, 10)).astype(np.float32)).softmax(-1)
_LABELS = torch.from_numpy(_rng.integers(0, 10, 64))
_SCORES = torch.from_numpy(_rng.random(64).astype(np.float32))
_BINARY = torch.from_numpy(_rng.integers(0, 2, 64))
_IDS = torch.from_numpy(_rng.integers(0, 5, 64))
_IMG = torch.from_numpy(_rng.random((64, 3, 8, 8)).astype(np.float32))
_IMG_T = torch.from_numpy(_rng.random((64, 3, 8, 8)).astype(np.float32))

#: name -> (members, one batch as (args, kwargs))
COLLECTIONS = {
    "classification": (
        lambda: [
            tm.Accuracy(device="cpu"),
            tm.ConfusionMatrix(10, device="cpu"),
            tm.F1Score(num_classes=10, average="macro", device="cpu"),
            tm.AUROC(num_classes=10, device="cpu"),
        ],
        ((_PROBS, _LABELS), {}),
    ),
    "curves": (
        lambda: [tm.ROC(device="cpu"), tm.AveragePrecision(device="cpu"), tm.BinnedAveragePrecision(num_classes=1, thresholds=8, device="cpu")],
        ((_SCORES, _BINARY), {}),
    ),
    "regression": (
        lambda: [tm.MeanSquaredError(device="cpu"), tm.PearsonCorrCoef(device="cpu"), tm.SpearmanCorrCoef(device="cpu")],
        ((_SCORES, _SCORES * 2 + 1), {}),
    ),
    "sliced": (lambda: [SlicedMetric(tm.PeakSignalNoiseRatio(device="cpu"), 5)], ((_IDS, _IMG, _IMG_T), {})),
    "windowed": (
        lambda: [WindowedMetric(SlicedMetric(tm.PeakSignalNoiseRatio(device="cpu"), 5), window=4)],
        ((_IDS, _IMG, _IMG_T), {}),
    ),
    "retrieval": (
        lambda: [tm.RetrievalNormalizedDCG(device="cpu"), tm.RetrievalMAP(device="cpu")],
        ((_SCORES, _BINARY), {"indexes": _IDS}),
    ),
}


@pytest.fixture
def no_cyclic_collector():
    gc.collect()
    assert len(fused._LIVE_FUSED) == 0  # no handle of an earlier test
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def _drive(name, compile_async):
    members, (args, kwargs) = COLLECTIONS[name]
    collection = MetricCollection(members())
    handle = collection.compile_update_async(buckets=(64,)) if compile_async else collection.compile_update(buckets=(64,))
    for _ in range(3):
        collection.update(*args, **kwargs)
    collection.compute()
    return collection, handle


def _assert_freed(refs):
    assert len(fused._LIVE_FUSED) == 0
    assert fused._fused_plane_nbytes() == 0
    assert [r() for r in refs] == [None] * len(refs)


@pytest.mark.parametrize("name", list(COLLECTIONS))
def test_dropped_collection_frees_its_fused_handle(no_cyclic_collector, name):
    collection, handle = _drive(name, compile_async=False)
    assert len(fused._LIVE_FUSED) == 1 and handle.cache_size >= 1
    refs = [weakref.ref(handle), weakref.ref(collection)] + [weakref.ref(m) for m in collection.values()]
    del collection, handle
    _assert_freed(refs)


@pytest.mark.parametrize("name", list(COLLECTIONS))
def test_dropped_collection_frees_its_closed_async_handle(no_cyclic_collector, name):
    collection, handle = _drive(name, compile_async=True)
    handle.close()
    refs = [weakref.ref(handle), weakref.ref(collection._fused), weakref.ref(collection)]
    del collection, handle
    _assert_freed(refs)


def test_dropped_collection_stops_an_open_async_handle(no_cyclic_collector):
    collection, handle = _drive("classification", compile_async=True)
    thread = handle._thread
    refs = [weakref.ref(handle), weakref.ref(collection._fused)]
    del collection, handle
    _assert_freed(refs)
    thread.join(timeout=10.0)
    assert not thread.is_alive()


def test_a_poisoned_async_handle_is_freed_too(no_cyclic_collector):
    """The worker's kept error held the frame that caught it, and that frame
    the handle: the error's frames are cleared once the batch is done."""
    collection, handle = _drive("classification", compile_async=True)
    collection.update_async(_PROBS, _LABELS[:5])  # a batch of another length fails in the worker
    with pytest.raises(Exception):
        handle.flush()
    handle.close()
    refs = [weakref.ref(handle), weakref.ref(collection._fused)]
    del collection, handle
    _assert_freed(refs)


def test_handles_the_collection_replaces_are_freed_at_once(no_cyclic_collector):
    collection, first = _drive("classification", compile_async=False)
    ref = weakref.ref(first)
    del first
    second = collection.compile_update(buckets=(32, 64))  # another config: a new handle
    assert ref() is None and len(fused._LIVE_FUSED) == 1
    collection.add_metrics({"extra": tm.MeanSquaredError(device="cpu")})  # a membership change drops it
    ref = weakref.ref(second)
    del second
    assert ref() is None and len(fused._LIVE_FUSED) == 0


def test_a_handle_outliving_its_collection_refuses_with_a_user_error(no_cyclic_collector):
    collection, handle = _drive("classification", compile_async=False)
    del collection
    with pytest.raises(MetricsUserError, match="MetricCollection is gone"):
        handle(_PROBS, _LABELS)


def test_a_live_collection_keeps_its_handle_and_states(no_cyclic_collector):
    """The weak back-reference changes nothing while the collection lives:
    a fused update gives the eager update's states."""
    collection, handle = _drive("classification", compile_async=False)
    eager = MetricCollection(COLLECTIONS["classification"][0]())
    for _ in range(3):
        eager.update(_PROBS, _LABELS)
    assert collection.fused_update is handle and len(fused._LIVE_FUSED) == 1
    for name, metric in collection.items(keep_base=True):
        for state in metric._defaults:
            got, want = getattr(metric, state), getattr(eager[name], state)
            if isinstance(got, torch.Tensor):
                assert torch.equal(got, want), (name, state)


class _Graph:
    """A stand-in for ``torch.cuda.CUDAGraph``: ``capture_end`` may fail
    before the capture ends (an invalidated capture) or after (a warning
    turned error), and ``pool()`` answers only once the capture has ended,
    as torch's does."""

    def __init__(self, end_error=None, ends=True):
        self.end_error, self.ends, self.ended = end_error, ends, False

    def capture_begin(self, pool=None, capture_error_mode=None):
        self.pool_id = pool

    def capture_end(self):
        self.ended = self.ends
        if self.end_error is not None:
            raise self.end_error

    def pool(self):
        if not self.ended:
            raise RuntimeError("Called CUDAGraph::pool() without a preceding successful capture.")
        return self.pool_id


class _Stream:
    device = torch.device("cuda", 0)


@pytest.mark.parametrize(
    "case, block_error, graph, released",
    [
        ("captured", None, _Graph(), False),
        ("invalidated by the block", RuntimeError("operation not permitted when stream is capturing"), _Graph(RuntimeError("invalidated"), ends=False), True),
        ("a Python error in the block", ValueError("a check"), _Graph(), False),
        ("a warning turned error at the end", None, _Graph(UserWarning("The CUDA Graph is empty")), False),
        ("the end fails", None, _Graph(RuntimeError("capture failed"), ends=False), True),
    ],
)
def test_a_failed_capture_gives_its_pool_back_once(monkeypatch, case, block_error, graph, released):
    """torch gives a graph's pool back when the graph goes, and stops
    routing allocations to it, only if its capture ended; ``_capturing``
    does both where the capture never ended, and never twice (an
    over-release aborts the process)."""
    import contextlib

    calls = []
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 7))
    monkeypatch.setattr(torch._C, "_cuda_releasePool", lambda device, pool: calls.append(("release", device, pool)), raising=False)
    monkeypatch.setattr(torch._C, "_cuda_endAllocateToPool", lambda device, pool: calls.append(("end", device, pool)), raising=False)
    raised = block_error if block_error is not None else graph.end_error
    ctx = pytest.raises(type(raised)) if raised is not None else contextlib.nullcontext()
    with ctx:
        with fused._capturing(graph, _Stream()):
            if block_error is not None:
                raise block_error
    assert calls == ([("end", 0, (0, 7)), ("release", 0, (0, 7))] if released else [])
