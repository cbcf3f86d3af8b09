"""The port's COCO mAP against the JAX package's, on the CPU.

* The device matcher ``_match_units`` against the JAX package's
  ``_match_units_kernel`` on random units: the match matrices, the
  area-out masks and the unignored ground-truth counts are equal.
* The copied host packing: ``_pack_units`` equals ``_pack_units_loop``.
* ``MeanAveragePrecision`` against the JAX package's on every result key,
  bit for bit, fed the same seeded images: inside the table's window, past
  its capacity, ``exact=True``, the xywh and cxcywh formats, the per-image
  detection cap, padded dict batches with ``n_valid``, ``class_metrics``,
  and a state carried from JAX by ``state_from_jax`` and continued. (The
  IoU, the matching and the float64 reduction are the same arithmetic in
  the same order on both sides.)
* The pycocotools fixture within the JAX test's tolerance of the official
  numbers (atol 1e-1, ``tests/detection/test_map.py``), and equal to the
  JAX package's values.
* The input validator's and the capacity errors, message for message.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu.detection import MeanAveragePrecision as JaxMAP
from metrics_tpu.functional.detection.mean_ap import _match_units_kernel
from metrics_tpu_torch import MeanAveragePrecision
from metrics_tpu_torch.convert import state_from_jax
from metrics_tpu_torch.functional.detection.mean_ap import _match_units, _pack_units, _pack_units_loop

torch.set_num_threads(2)

KW = dict(det_slots=8, gt_slots=8, max_detection_thresholds=[1, 4, 8], class_metrics=True)


def _images(rng, n, max_det=6, max_gt=4, n_cls=3, grid=6.0):
    """Images whose boxes sit on a coarse grid with jitter, so detections
    overlap ground truths and the PR grids are not trivial."""
    out = []
    for _ in range(n):
        nd = int(rng.randint(0, max_det + 1))
        ng = int(rng.randint(1, max_gt + 1))

        def boxes(k):
            xy = rng.randint(0, 4, (k, 2)).astype(np.float64) * grid + rng.rand(k, 2)
            wh = 4.0 + rng.rand(k, 2) * 4.0
            return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)

        out.append(
            (
                dict(boxes=boxes(nd), scores=rng.rand(nd).astype(np.float32), labels=rng.randint(0, n_cls, nd).astype(np.int32)),
                dict(boxes=boxes(ng), labels=rng.randint(0, n_cls, ng).astype(np.int32)),
            )
        )
    return out


IMAGES = _images(np.random.RandomState(0), 24)


def _lists(images, as_array):
    preds = [{k: as_array(v) for k, v in p.items()} for p, _ in images]
    target = [{k: as_array(v) for k, v in t.items()} for _, t in images]
    return preds, target


def _padded(images, det_slots, gt_slots, as_array, extra=0):
    """The padded dict batch, with ``extra`` trailing pad images."""
    n = len(images) + extra
    pb, ps = np.zeros((n, det_slots, 4), np.float32), np.zeros((n, det_slots), np.float32)
    pl, pn = np.zeros((n, det_slots), np.int32), np.zeros((n,), np.int32)
    gb, gl, gn = np.zeros((n, gt_slots, 4), np.float32), np.zeros((n, gt_slots), np.int32), np.zeros((n,), np.int32)
    for i, (p, t) in enumerate(images):
        nd, ng = len(p["scores"]), len(t["labels"])
        pb[i, :nd], ps[i, :nd], pl[i, :nd], pn[i] = p["boxes"], p["scores"], p["labels"], nd
        gb[i, :ng], gl[i, :ng], gn[i] = t["boxes"], t["labels"], ng
    preds = dict(boxes=as_array(pb), scores=as_array(ps), labels=as_array(pl), n=as_array(pn))
    target = dict(boxes=as_array(gb), labels=as_array(gl), n=as_array(gn))
    return preds, target


def _pair(**kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return JaxMAP(**kw), MeanAveragePrecision(device="cpu", **kw)


def _feed_lists(pair, images, batch=8):
    jm, tm = pair
    for lo in range(0, len(images), batch):
        jm.update(*_lists(images[lo : lo + batch], jnp.asarray))
        tm.update(*_lists(images[lo : lo + batch], torch.from_numpy))


def _assert_results_equal(want, got):
    assert list(want) == list(got)
    for key in want:
        w = np.asarray(want[key], np.float32).ravel()
        g = got[key].numpy().ravel()
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32), err_msg=key)


# ---------------------------------------------------------------------------
# the matcher and the packing
# ---------------------------------------------------------------------------


def test_matcher_matches_jax():
    rng = np.random.RandomState(1)
    U, D, G = 40, 8, 4
    xy = rng.randint(0, 3, (U, D + G, 2)) * 5.0 + rng.rand(U, D + G, 2)
    boxes = np.concatenate([xy, xy + 3 + rng.rand(U, D + G, 2) * 40], -1).astype(np.float32)
    det, gt = boxes[:, :D], boxes[:, D:]
    det_valid = np.arange(D)[None] < rng.randint(0, D + 1, (U, 1))
    gt_valid = np.arange(G)[None] < rng.randint(1, G + 1, (U, 1))
    det[~det_valid], gt[~gt_valid] = 0, 0
    thr = np.asarray([0.5 + 0.05 * i for i in range(10)], np.float32)
    areas = np.asarray([(0.0, 1e10), (0.0, 32.0**2), (32.0**2, 96.0**2), (96.0**2, 1e10)], np.float32)
    want = _match_units_kernel(*(jnp.asarray(x) for x in (det, det_valid, gt, gt_valid, thr, areas)))
    got = _match_units(*(torch.from_numpy(x) for x in (det, det_valid, gt, gt_valid, thr, areas)))
    assert got[0].any() and not got[0].all()
    for name, w, g in zip(("det_matches", "det_area_out", "npig"), want, got):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("max_det", [2, 100])
def test_pack_units_equals_the_loop(max_det):
    images = _images(np.random.RandomState(5), 30, max_det=9, n_cls=4)
    det_boxes = [p["boxes"] for p, _ in images]
    det_scores = [p["scores"].astype(np.float64) for p, _ in images]
    det_labels = [p["labels"] for p, _ in images]
    gt_boxes = [t["boxes"] for _, t in images]
    gt_labels = [t["labels"] for _, t in images]
    args = (det_boxes, det_scores, det_labels, gt_boxes, gt_labels, [0, 1, 2, 3], max_det)
    fast, loop = _pack_units(*args), _pack_units_loop(*args)
    for name, a, b in zip(fast._fields, fast, loop):
        np.testing.assert_array_equal(a, b, err_msg=name)


# ---------------------------------------------------------------------------
# the metric
# ---------------------------------------------------------------------------

CONFIGS = {
    "in-window": dict(KW),
    "past-capacity": dict(KW, max_images=10),
    "exact": dict(KW, exact=True),
    "xywh": dict(KW, box_format="xywh"),
    "cxcywh": dict(KW, box_format="cxcywh"),
    "detection-cap": dict(det_slots=4, gt_slots=4, max_detection_thresholds=[1, 2, 4]),
    "default-grid": dict(max_images=64),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_results_match_jax_bitwise(name):
    pair = _pair(**CONFIGS[name])
    _feed_lists(pair, IMAGES)
    if not CONFIGS[name].get("exact"):
        np.testing.assert_array_equal(pair[1].table.numpy(), np.asarray(pair[0].table))
    _assert_results_equal(pair[0].compute(), pair[1].compute())


def test_padded_batches_with_n_valid_match_jax_bitwise():
    jm, tm = _pair(**KW)
    for lo in range(0, len(IMAGES), 8):
        chunk = IMAGES[lo : lo + 8]
        jm.update(*_padded(chunk, 8, 8, jnp.asarray, extra=3), n_valid=len(chunk))
        tm.update(*_padded(chunk, 8, 8, torch.from_numpy, extra=3), n_valid=len(chunk))
    assert int(tm.images_seen) == len(IMAGES)
    np.testing.assert_array_equal(tm.table.numpy(), np.asarray(jm.table))
    _assert_results_equal(jm.compute(), tm.compute())
    # the list form of the same images gives the same table
    lists = _pair(**KW)[1]
    _feed_lists((JaxMAP(**KW), lists), IMAGES)
    assert torch.equal(lists.table, tm.table)


def test_state_from_jax_continues_the_epoch():
    jm, tm = _pair(**KW)
    _feed_lists((jm, tm), IMAGES[:12])
    carried = MeanAveragePrecision(device="cpu", **KW)
    state = state_from_jax({k: np.asarray(v) for k, v in jm.state_dict().items()}, carried)
    carried.load_state_dict(state)
    _feed_lists((jm, carried), IMAGES[12:])
    _assert_results_equal(jm.compute(), carried.compute())
    # the exact mode's list states carry over element by element
    jex, first_half = _pair(**CONFIGS["exact"])
    _feed_lists((jex, first_half), IMAGES[:12])
    exact = _pair(**CONFIGS["exact"])[1]
    state = state_from_jax({k: [np.asarray(x) for x in v] for k, v in jex.state_dict().items()}, exact)
    exact.load_state_dict(state)
    _feed_lists((jex, exact), IMAGES[12:])
    _assert_results_equal(jex.compute(), exact.compute())
    with pytest.raises(ValueError, match="list state"):
        state_from_jax({k: np.zeros(3) for k in exact.init_state()}, exact)


def test_exact_mode_warns_and_keeps_no_table():
    with pytest.warns(UserWarning, match="will save all detections and ground truths in buffer"):
        metric = MeanAveragePrecision(exact=True, device="cpu")
    assert not hasattr(metric, "table")


# ---------------------------------------------------------------------------
# the pycocotools fixture (tests/detection/test_map.py)
# ---------------------------------------------------------------------------

_PREDS = [
    [
        dict(boxes=[[258.15, 41.29, 606.41, 285.07]], scores=[0.236], labels=[4]),
        dict(boxes=[[61.00, 22.75, 565.00, 632.42], [12.66, 3.32, 281.26, 275.23]], scores=[0.318, 0.726], labels=[3, 2]),
    ],
    [
        dict(
            boxes=[
                [87.87, 276.25, 384.29, 379.43],
                [0.00, 3.66, 142.15, 316.06],
                [296.55, 93.96, 314.97, 152.79],
                [328.94, 97.05, 342.49, 122.98],
                [356.62, 95.47, 372.33, 147.55],
                [464.08, 105.09, 495.74, 146.99],
                [276.11, 103.84, 291.44, 150.72],
            ],
            scores=[0.546, 0.3, 0.407, 0.611, 0.335, 0.805, 0.953],
            labels=[4, 1, 0, 0, 0, 0, 0],
        ),
        dict(boxes=[[0.00, 2.87, 601.00, 421.52]], scores=[0.699], labels=[5]),
    ],
]
_TARGET = [
    [
        dict(boxes=[[214.1500, 41.2900, 562.4100, 285.0700]], labels=[4]),
        dict(boxes=[[13.00, 22.75, 548.98, 632.42], [1.66, 3.32, 270.26, 275.23]], labels=[2, 2]),
    ],
    [
        dict(
            boxes=[
                [61.87, 276.25, 358.29, 379.43],
                [2.75, 3.66, 162.15, 316.06],
                [295.55, 93.96, 313.97, 152.79],
                [326.94, 97.05, 340.49, 122.98],
                [356.62, 95.47, 372.33, 147.55],
                [462.08, 105.09, 493.74, 146.99],
                [277.11, 103.84, 292.44, 150.72],
            ],
            labels=[4, 1, 0, 0, 0, 0, 0],
        ),
        dict(boxes=[[13.99, 2.87, 640.00, 421.52]], labels=[5]),
    ],
]
_PYCOCO_EXPECTED = {
    "map": 0.706,
    "map_50": 0.901,
    "map_75": 0.846,
    "map_small": 0.689,
    "map_medium": 0.800,
    "map_large": 0.701,
    "mar_1": 0.592,
    "mar_10": 0.716,
    "mar_100": 0.716,
    "mar_small": 0.767,
    "mar_medium": 0.800,
    "mar_large": 0.700,
    "map_per_class": [0.725, 0.800, 0.454, -1.000, 0.650, 0.900],
    "mar_100_per_class": [0.780, 0.800, 0.450, -1.000, 0.650, 0.900],
}


def _as_arrays(sample, as_array):
    out = {k: as_array(np.asarray(v, np.float32)) for k, v in sample.items() if k != "labels"}
    out["labels"] = as_array(np.asarray(sample["labels"], np.int32))
    return out


def test_pycocotools_fixture():
    jm, tm = _pair(class_metrics=True)
    for preds, target in zip(_PREDS, _TARGET):
        jm.update([_as_arrays(p, jnp.asarray) for p in preds], [_as_arrays(t, jnp.asarray) for t in target])
        tm.update([_as_arrays(p, torch.from_numpy) for p in preds], [_as_arrays(t, torch.from_numpy) for t in target])
    got = tm.compute()
    for key, expected in _PYCOCO_EXPECTED.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(expected, np.float32), atol=1e-1, err_msg=key)
    _assert_results_equal(jm.compute(), got)


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------


def _one(nd=1, ng=1, n_labels=None, n_scores=None):
    boxes = lambda k: np.tile(np.asarray([[0, 0, 4, 4]], np.float32), (k, 1))
    pred = dict(boxes=boxes(nd), scores=np.ones(n_scores if n_scores is not None else nd, np.float32), labels=np.zeros(nd, np.int32))
    target = dict(boxes=boxes(ng), labels=np.zeros(n_labels if n_labels is not None else ng, np.int32))
    return pred, target


def _bad_inputs():
    pred, target = _one()
    return {
        "length": ([pred, pred], [target]),
        "preds key": ([{k: v for k, v in pred.items() if k != "scores"}], [target]),
        "target key": ([pred], [{k: v for k, v in target.items() if k != "labels"}]),
        "boxes type": ([dict(pred, boxes=[[0, 0, 1, 1]])], [target]),
        "target labels type": ([pred], [dict(target, labels=[0])]),
        "target lengths": ([pred], [_one(ng=2, n_labels=1)[1]]),
        "pred lengths": ([_one(nd=2, n_scores=1)[0]], [target]),
        "gt overflow": ([pred], [_one(ng=5)[1]]),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_input_errors_match_jax(case):
    preds, target = _bad_inputs()[case]

    def convert(x, as_array):
        if isinstance(x, dict):
            return {k: as_array(v) if isinstance(v, np.ndarray) else v for k, v in x.items()}
        return [convert(i, as_array) for i in x]

    kw = dict(det_slots=4, gt_slots=4, max_detection_thresholds=[1, 4])
    with pytest.raises(ValueError) as want:
        JaxMAP(**kw).update(convert(preds, jnp.asarray), convert(target, jnp.asarray))
    with pytest.raises(ValueError) as got:
        MeanAveragePrecision(device="cpu", **kw).update(convert(preds, torch.from_numpy), convert(target, torch.from_numpy))
    assert str(got.value) == str(want.value)


def test_validator_rejects_what_is_not_a_sequence_like_jax():
    from metrics_tpu.detection.mean_ap import _input_validator as jax_validator
    from metrics_tpu_torch.detection.mean_ap import _input_validator

    for preds, target in ((5, []), ([], 5)):
        with pytest.raises(ValueError) as want:
            jax_validator(preds, target)
        with pytest.raises(ValueError) as got:
            _input_validator(preds, target)
        assert str(got.value) == str(want.value)


def test_padded_gt_overflow_and_constructor_errors_match_jax():
    kw = dict(det_slots=4, gt_slots=4, max_detection_thresholds=[1, 4])
    preds, target = _padded(IMAGES[:2], 4, 6, np.asarray)
    messages = []
    for metric, as_array in ((JaxMAP(**kw), jnp.asarray), (MeanAveragePrecision(device="cpu", **kw), torch.from_numpy)):
        with pytest.raises(ValueError) as err:
            metric.update({k: as_array(v) for k, v in preds.items()}, {k: as_array(v) for k, v in target.items()})
        messages.append(str(err.value))
    assert messages[0] == messages[1] and "raise `gt_slots`" in messages[1]
    for bad in (dict(box_format="yxyx"), dict(class_metrics=1), dict(max_images=0), dict(det_slots=50)):
        with pytest.raises(ValueError) as want:
            JaxMAP(**bad)
        with pytest.raises(ValueError) as got:
            MeanAveragePrecision(device="cpu", **bad)
        assert str(got.value) == str(want.value)
