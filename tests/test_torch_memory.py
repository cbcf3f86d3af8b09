"""State memory accounting: the port against the JAX package.

``state_footprint`` (keys and bytes), ``total_state_bytes``,
``theoretical_state_bytes`` and ``sketch_fill_ratios`` of the same metric
in both packages after the same seeded updates, over every ported family:
classification counts, the curves in their sketched, capacity, exact and
binned modes, calibration, the losses, the regression family (the rank
sketch, the Gumbel reservoir of Spearman's exact mode excluded: a list),
PSNR, retrieval (table and exact), detection, sliced and windowed state
(their key prefixes, a ring of sketches), the aggregators, the wrappers and
a composition (children under dotted keys). Byte counts are equal, and so
are the fill ratios. Also the collection's dedupe: compute-group members
counted once, and an async handle's in-flight bytes.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu
import metrics_tpu_torch as tm
from metrics_tpu.detection import MeanAveragePrecision as JaxMAP
from metrics_tpu_torch.core.metric import SKETCH_FOOTPRINT_PREFIX

torch.set_num_threads(2)

_rng = np.random.RandomState(17)
N = 96
BINARY = (_rng.rand(N).astype(np.float32), _rng.randint(0, 2, N))
MULTI = (_rng.dirichlet(np.ones(5), N).astype(np.float32), _rng.randint(0, 5, N))
REG = (_rng.rand(N).astype(np.float32) + 0.1, _rng.rand(N).astype(np.float32) + 0.1)
IMAGES = (_rng.rand(4, 3, 8, 8).astype(np.float32), _rng.rand(4, 3, 8, 8).astype(np.float32))
IDS = _rng.randint(0, 6, N)
RETRIEVAL = (_rng.rand(N).astype(np.float32), _rng.randint(0, 2, N), np.repeat(np.arange(12), 8))

# (name, constructor taking (package, device kwargs), inputs, keyword inputs)
CASES = [
    ("Accuracy", lambda p, kw: p.Accuracy(num_classes=5, **kw), MULTI, {}),
    ("StatScores-samples", lambda p, kw: p.StatScores(num_classes=5, reduce="samples", **kw), MULTI, {}),
    ("ConfusionMatrix", lambda p, kw: p.ConfusionMatrix(num_classes=5, **kw), MULTI, {}),
    ("CohenKappa", lambda p, kw: p.CohenKappa(num_classes=5, **kw), MULTI, {}),
    ("AUROC-sketch", lambda p, kw: p.AUROC(sketch_capacity=64, **kw), BINARY, {}),
    ("AUROC-sketch-multiclass", lambda p, kw: p.AUROC(num_classes=5, sketch_capacity=64, **kw), MULTI, {}),
    ("AUROC-capacity", lambda p, kw: p.AUROC(num_classes=5, capacity=256, **kw), MULTI, {}),
    ("ROC-exact", lambda p, kw: p.ROC(exact=True, **kw), BINARY, {}),
    ("AveragePrecision-sketch", lambda p, kw: p.AveragePrecision(sketch_capacity=128, **kw), BINARY, {}),
    ("BinnedAveragePrecision", lambda p, kw: p.BinnedAveragePrecision(num_classes=5, thresholds=10, **kw), MULTI, {}),
    ("CalibrationError", lambda p, kw: p.CalibrationError(**kw), BINARY, {}),
    ("HingeLoss", lambda p, kw: p.HingeLoss(**kw), BINARY, {}),
    ("MeanSquaredError", lambda p, kw: p.MeanSquaredError(**kw), REG, {}),
    ("R2Score", lambda p, kw: p.R2Score(**kw), REG, {}),
    ("SpearmanCorrCoef", lambda p, kw: p.SpearmanCorrCoef(sketch_capacity=64, **kw), REG, {}),
    ("PearsonCorrCoef", lambda p, kw: p.PearsonCorrCoef(**kw), REG, {}),
    ("PeakSignalNoiseRatio", lambda p, kw: p.PeakSignalNoiseRatio(**kw), IMAGES, {}),
    ("RetrievalNormalizedDCG", lambda p, kw: p.RetrievalNormalizedDCG(max_queries=16, max_docs=8, **kw), RETRIEVAL[:2], {"indexes": RETRIEVAL[2]}),
    ("RetrievalMAP-exact", lambda p, kw: p.RetrievalMAP(exact=True, **kw), RETRIEVAL[:2], {"indexes": RETRIEVAL[2]}),
    ("SlicedMetric", lambda p, kw: p.SlicedMetric(p.MeanSquaredError(**kw), 6), (IDS,) + REG, {}),
    ("WindowedMetric-ring", lambda p, kw: p.WindowedMetric(p.MeanSquaredError(**kw), window=3), REG, {}),
    ("WindowedMetric-sketch", lambda p, kw: p.WindowedMetric(p.AUROC(sketch_capacity=64, **kw), window=2), BINARY, {}),
    ("WindowedMetric-decay", lambda p, kw: p.WindowedMetric(p.MeanSquaredError(**kw), mode="decay"), REG, {}),
    ("MaxMetric", lambda p, kw: p.MaxMetric(**kw), REG[:1], {}),
    ("CatMetric", lambda p, kw: p.CatMetric(**kw), REG[:1], {}),
    ("MeanMetric", lambda p, kw: p.MeanMetric(**kw), REG[:1], {}),
    ("BootStrapper", lambda p, kw: p.BootStrapper(p.AUROC(sketch_capacity=64, **kw), num_bootstraps=3, seed=0), BINARY, {}),
    ("ClasswiseWrapper", lambda p, kw: p.ClasswiseWrapper(p.Accuracy(num_classes=5, average=None, **kw)), MULTI, {}),
    ("MinMaxMetric", lambda p, kw: p.MinMaxMetric(p.Accuracy(num_classes=5, **kw)), MULTI, {}),
    ("MultioutputWrapper", lambda p, kw: p.MultioutputWrapper(p.MeanSquaredError(**kw), 2), (np.stack(REG, 1), np.stack(REG[::-1], 1)), {}),
    ("Composition", lambda p, kw: p.Accuracy(num_classes=5, **kw) + p.CohenKappa(num_classes=5, **kw), MULTI, {}),
]


def _x64_off(a):
    """Integer inputs as int32, the width the JAX package gives them (the
    port keeps a caller's int64, and a list state holds what it is given)."""
    a = np.asarray(a)
    return a.astype(np.int32) if a.dtype == np.int64 else a


def _update(metric, arrays, kwargs, as_array, times=2):
    for _ in range(times):
        metric.update(*(as_array(_x64_off(a)) for a in arrays), **{k: as_array(_x64_off(v)) for k, v in kwargs.items()})


def _pair(build):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return build(metrics_tpu, {}), build(tm, {"device": "cpu"})


@pytest.mark.parametrize("name, build, arrays, kwargs", CASES, ids=[c[0] for c in CASES])
def test_accounting_matches_jax(name, build, arrays, kwargs):
    j, t = _pair(build)
    assert t.state_footprint() == j.state_footprint()  # before any update
    assert t.theoretical_state_bytes() == j.theoretical_state_bytes()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _update(j, arrays, kwargs, jnp.asarray)
        _update(t, arrays, kwargs, torch.from_numpy)
    footprint = t.state_footprint()
    assert footprint == j.state_footprint()
    assert t.total_state_bytes() == j.total_state_bytes() == sum(footprint.values())
    assert t.state_footprint(include_children=False) == j.state_footprint(include_children=False)
    assert t.theoretical_state_bytes() == j.theoretical_state_bytes()
    assert t.sketch_fill_ratios() == j.sketch_fill_ratios()
    if name.startswith(("AUROC-sketch", "SpearmanCorr")):
        assert any(k.startswith(SKETCH_FOOTPRINT_PREFIX) for k in footprint)
        assert t.sketch_fill_ratios()
    if name.startswith(("SlicedMetric", "WindowedMetric")):
        assert all(k.startswith(("sliced/", "windowed/")) for k in footprint)
    if name in ("BootStrapper", "ClasswiseWrapper", "MinMaxMetric", "MultioutputWrapper", "Composition"):
        assert all("." in k for k in footprint)


def test_detection_accounting_matches_jax():
    rng = np.random.RandomState(0)
    images = []
    for _ in range(6):
        nd, ng = int(rng.randint(1, 4)), int(rng.randint(1, 3))
        boxes = lambda k: np.concatenate([rng.rand(k, 2) * 8, rng.rand(k, 2) * 8 + 9], 1).astype(np.float32)
        images.append(
            (
                dict(boxes=boxes(nd), scores=rng.rand(nd).astype(np.float32), labels=rng.randint(0, 3, nd).astype(np.int32)),
                dict(boxes=boxes(ng), labels=rng.randint(0, 3, ng).astype(np.int32)),
            )
        )
    kw = dict(det_slots=4, gt_slots=4, max_images=16, max_detection_thresholds=[1, 2, 4])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j, t = JaxMAP(**kw), tm.MeanAveragePrecision(device="cpu", **kw)
    for as_array, m in ((jnp.asarray, j), (torch.from_numpy, t)):
        m.update([{k: as_array(v) for k, v in p.items()} for p, _ in images], [{k: as_array(v) for k, v in g.items()} for _, g in images])
    assert t.state_footprint() == j.state_footprint()
    assert t.theoretical_state_bytes() == j.theoretical_state_bytes()
    assert t.sketch_fill_ratios() == j.sketch_fill_ratios()


def test_host_counter_counts_four_bytes():
    """A mean-reduced state brings the ``_n_updates`` counter, a host int
    after an eager update: 4 bytes, as the JAX package counts it."""

    class JaxMean(metrics_tpu.Metric):
        def __init__(self):
            super().__init__()
            self.add_state("avg", jnp.zeros(3), dist_reduce_fx="mean")

        def _update(self, x):
            self.avg = x

        def _compute(self):
            return self.avg

    class TorchMean(tm.Metric):
        def __init__(self):
            super().__init__(device="cpu")
            self.add_state("avg", torch.zeros(3), dist_reduce_fx="mean")

        def _update(self, x):
            self.avg = x

        def _compute(self):
            return self.avg

    j, t = JaxMean(), TorchMean()
    j.update(jnp.ones(3))
    t.update(torch.ones(3))
    assert isinstance(t._n_updates, int)
    assert t.state_footprint() == j.state_footprint() == {"avg": 12, "_n_updates": 4}


def test_collection_counts_group_leaders_once():
    def members(p, kw):
        return [p.Precision(num_classes=5, average="macro", **kw), p.Recall(num_classes=5, average="macro", **kw), p.ConfusionMatrix(num_classes=5, **kw)]

    jc, tc = metrics_tpu.MetricCollection(members(metrics_tpu, {})), tm.MetricCollection(members(tm, {"device": "cpu"}))
    _update(jc, MULTI, {}, jnp.asarray, times=1)
    _update(tc, MULTI, {}, torch.from_numpy, times=1)
    assert tc.compute_groups == jc.compute_groups and len(tc.compute_groups) < 3
    assert tc.state_footprint() == jc.state_footprint()
    assert tc.total_state_bytes() == jc.total_state_bytes()
    assert tc.total_state_bytes() < sum(sum(v.values()) for v in tc.state_footprint().values())


def test_async_handle_in_flight_bytes_count_in_the_collection():
    tc = tm.MetricCollection([tm.MeanSquaredError(device="cpu")])
    tc.update(*(torch.from_numpy(a) for a in REG))
    handle = tc.compile_update_async(queue_depth=4)
    try:
        assert handle.in_flight_bytes == 0
        base = tc.total_state_bytes()
        with handle.state_lock:  # the worker cannot apply: the batches stay queued
            for _ in range(2):
                handle.update_async(*(torch.from_numpy(a) for a in REG))
            queued = 2 * 2 * N * 4
            assert handle.in_flight_bytes == queued
            assert tc.total_state_bytes() == base + queued
        handle.flush()
        assert handle.in_flight_bytes == 0 and tc.total_state_bytes() == base
    finally:
        handle.close()
