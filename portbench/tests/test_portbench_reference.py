"""The frozen reference against plain numpy and against the port on the
CPU at small sizes (inputs handed over as numpy arrays), and the frozen
byte counts."""
import numpy as np
import pytest
import torch
from scipy.stats import rankdata

from portbench import generators, roofline
from portbench import reference as ref

CPU = torch.device("cpu")


def _softmax_rows(seed, rows=400, classes=12):
    g = generators.generator(seed, CPU)
    preds, target = generators.softmax_classes(g, rows, classes, 1.5, CPU)
    return preds.numpy(), target.numpy()


def _numpy_auroc(scores, target, classes):
    n = scores.shape[0]
    ranks = rankdata(scores.astype(np.float64), axis=0)
    own = ranks[np.arange(n), target]
    rank_sum = np.bincount(target, weights=own, minlength=classes)
    n_pos = np.bincount(target, minlength=classes).astype(np.float64)
    n_neg = n - n_pos
    defined = (n_pos > 0) & (n_neg > 0)
    per_class = (rank_sum - n_pos * (n_pos + 1) / 2) / np.where(defined, n_pos * n_neg, 1)
    return float(np.mean(per_class[defined]))


@pytest.mark.parametrize("seed", [0, 1, 2**40 + 3])
def test_multiclass_reference_against_numpy(seed):
    preds, target = _softmax_rows(seed)
    p, t = torch.from_numpy(preds), torch.from_numpy(target)
    # ties: round some scores so that midranks matter
    tied = preds.copy()
    tied[::7] = np.round(tied[::7], 2)
    assert ref.multiclass_auroc(torch.from_numpy(tied), t, 12, block=5)[1] == pytest.approx(_numpy_auroc(tied, target, 12), abs=1e-12)
    want = np.bincount(target * 12 + preds.argmax(1), minlength=144).reshape(12, 12)
    np.testing.assert_array_equal(ref.confusion_matrix(p, t, 12).numpy(), want)
    assert ref.topk_accuracy(p, t, 1) == pytest.approx(np.mean(preds.argmax(1) == target))
    top3 = np.argsort(-preds, axis=1, kind="stable")[:, :3]
    assert ref.topk_accuracy(p, t, 3) == pytest.approx(np.mean((top3 == target[:, None]).any(1)))


def test_binary_references_against_numpy():
    g = generators.generator(5, CPU)
    score, y = generators.click_stream(g, 3000, 0.26, 1.2, CPU)
    s, yy = score.numpy().astype(np.float64), y.numpy()
    r = rankdata(s)
    n_pos = yy.sum()
    want = (r[yy == 1].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * (len(yy) - n_pos))
    assert ref.binary_auroc(score, y) == pytest.approx(want, abs=1e-12)
    # exact AP: mean precision at each positive (no ties in these scores)
    order = np.argsort(-s, kind="stable")
    hits = yy[order]
    prec = np.cumsum(hits) / np.arange(1, len(hits) + 1)
    assert ref.binary_average_precision(score, y) == pytest.approx(float(np.mean(prec[hits == 1])), abs=1e-12)
    # unit weights: the weighted curves are the exact ones
    w = torch.ones_like(score, dtype=torch.float64)
    assert ref.weighted_auroc(score, y, w) == pytest.approx(ref.binary_auroc(score, y), abs=1e-12)


def test_sketch_insert_matches_the_port_on_the_cpu():
    """The frozen absorb against the program's, fed the same numpy inputs:
    the sketches agree to float32 rounding, and the values to it."""
    from metrics_tpu_torch.classification import AUROC, AveragePrecision

    g = np.random.default_rng(11)
    clicked = g.random(6000) < 0.26
    score = (1 / (1 + np.exp(-(g.standard_normal(6000) + 1.2 * clicked)))).astype(np.float32)
    auroc, ap = AUROC(sketch_capacity=256, device="cpu"), AveragePrecision(sketch_capacity=256, device="cpu")
    sketch = ref.sketch_init(256, 1, CPU)
    for lo in range(0, 6000, 1000):
        s, y = torch.from_numpy(score[lo : lo + 1000]), torch.from_numpy(clicked[lo : lo + 1000].astype(np.int64))
        auroc.update(s, y)
        ap.update(s, y)
        sketch = ref.sketch_insert(sketch, s, y.to(torch.float64)[:, None])
    assert ref.sketch_w1_gap(auroc.csketch, sketch) < 1e-6
    assert ref.sketch_mass_gap(auroc.csketch, sketch) < 1e-6
    w, key, yy = sketch[:, 0], sketch[:, 1], sketch[:, 2]
    assert float(auroc.compute()) == pytest.approx(ref.weighted_auroc(key, yy, w), abs=1e-6)
    assert float(ap.compute()) == pytest.approx(ref.weighted_average_precision(key, yy, w), abs=1e-6)
    # a sketch kept in bfloat16 lies far off
    low = ref.sketch_init(256, 1, CPU)
    for lo in range(0, 6000, 1000):
        s, y = torch.from_numpy(score[lo : lo + 1000]), torch.from_numpy(clicked[lo : lo + 1000].astype(np.float64))
        low = ref.sketch_insert(low, s, y[:, None], torch.bfloat16)
    assert ref.sketch_w1_gap(low, sketch) > 1e-4


def test_multiclass_values_match_the_port_on_the_cpu():
    from metrics_tpu_torch.classification import AUROC, Accuracy, ConfusionMatrix

    preds, target = _softmax_rows(9, rows=500, classes=10)
    p, t = torch.from_numpy(preds), torch.from_numpy(target)
    cm, au = ConfusionMatrix(num_classes=10, device="cpu"), AUROC(num_classes=10, capacity=512, device="cpu")
    a1, a5 = Accuracy(device="cpu"), Accuracy(top_k=5, device="cpu")
    for m in (cm, au, a1, a5):
        for lo in range(0, 500, 128):
            m.update(p[lo : lo + 128], t[lo : lo + 128])
    np.testing.assert_array_equal(cm.compute().numpy(), ref.confusion_matrix(p, t, 10).numpy())
    assert float(au.compute()) == pytest.approx(ref.multiclass_auroc(p, t, 10)[1], abs=1e-6)
    assert float(a1.compute()) == pytest.approx(ref.topk_accuracy(p, t, 1), abs=1e-7)
    assert float(a5.compute()) == pytest.approx(ref.topk_accuracy(p, t, 5), abs=1e-7)


def test_frozen_byte_counts():
    # the confusion matrix's bincount: 4096 int64 ids, 3500 bins touched
    assert roofline.bincount_i32_bytes(4096, 8, 3500) == 4096 * 8 + 3500 * 4
    # compute's rank sums: [65536, 2] float32, int64 labels, 1000 classes
    assert roofline.segment_sum_f32_bytes(65536, 2, 8, 1000) == 65536 * 8 + 65536 * 8 + 8000
    # K3 at a compaction of [16384, 3] rows, and at a ragged [12288, 3]
    assert roofline.qsketch_sort_bucket_bytes(16384, 3) == 16384 * 12 * 2 + 16384 * 8
    assert roofline.qsketch_sort_bucket_bytes(12288, 3) == 12288 * 12 + 16384 * 12 + 16384 * 8
    assert roofline.roofline_pct(3.35e12, 1.0, "NVIDIA H100 80GB HBM3") == pytest.approx(100.0)


def test_criteo_compaction_count_follows_the_occupancy_bound():
    from portbench import harness

    cell = harness.Cell(harness.load_benchmark(), "criteo-kaggle.eval-fused")
    rows = cell.code._compactions(cell.config, [65536] * 100)
    # the first chunk after a reset fits; every later chunk compacts
    assert len(rows) == 7 + 99 * 8 and set(rows) == {16384}
