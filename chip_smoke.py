"""Drive the PyTorch/CUDA port (metrics_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, with one CUDA card:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. build   -- compile csrc/segment_sum.cu, csrc/qsketch.cu and csrc/box_iou.cu
   with nvcc, one process per source, started together (seconds, ptxas
   report);
2. parity  -- each kernel against its plain PyTorch version on the same card
   tensors: bincount_i32 at the ConfusionMatrix shape (4096 ids, 10**6
   bins) plus negative and out-of-range ids, bit-exact; segment_sum_f32 at
   [4096,2]->1000 (the rank-AUROC sums), [4096,1]->10**6, [32768,16]->2052
   and [4096,130]->1000, bit-exact on integer-valued data and within the
   float32 summation bound otherwise, bit-identical to the plain version run
   on the CPU (both add each output in row order), and bit-identical across
   two runs; qsketch_sort_bucket (the sketch compaction's sort, prefix sum
   and bucket map) at [1024,3], [16384,3], [32768,16], [12288,2002] and a
   ragged [5001,4] with tied keys and zero-weight rows, on integer weights:
   weighted rows, bucket ids and permutation bit-exact against the plain
   version on the card and on the CPU and across two runs, and the whole
   compaction chain bit-exact against its plain version; parity_box_iou:
   box_iou_pairwise (K5) at [1024,1024], [4096,4096] and [1000,3000] and
   box_iou_batched (K6) at [65536,8,8], [4096,128,32], [1024,128,128],
   [16384,64,16] and [1000,100,30], with zero-area, touching, inverted and
   zero-padded boxes, bit-exact against the plain version on the card and
   on the CPU and across two runs, ms per call for each shape;
3. flagship -- the main path: 50 pre-stacked 4096x1000 softmax batches
   (seed 42, the fixture of bench.py), per step ConfusionMatrix.update_state
   plus auroc_rank_multiclass; launch counters reset just before and read
   just after; the confusion matrix checked bit-exactly against np.bincount
   and the last batch's AUROC against scipy midranks to 1e-6; then three
   steps under torch.profiler: device time per step, the device's idle
   share, and a table by kernel on standard error;
4. stateful -- MetricCollection(ConfusionMatrix, AUROC(capacity=65536)) over
   12 batches (49,152 rows), launch counters reset and read likewise,
   computed values checked against the same numpy references;
5. sketch-binary -- the sketched default AUROC() (capacity 8192) streams
   800 batches of 8192 (6,553,600 samples, seed 42: y = rand < 0.26, score
   = sigmoid(randn + 1.2 y)); launch counters reset and read likewise (every
   batch after the first compacts once: 799 launches of each kernel); ms per
   update, warm compute() ms (median of 5 after a cold one), state bytes,
   and five updates under torch.profiler; gates: AUROC within 5e-3 of the
   float64 midrank AUROC of the whole stream, total sketch weight exactly
   6,553,600, and within 1e-6 of the same stream through the port on the
   CPU (the count of sketch rows that differ bitwise is printed);
6. sketch-window -- AUROC() over the first 8192 samples (inside the
   lossless window: no compaction) within 1e-6 of scipy, and the binary
   capacity mode AUROC(capacity=8192) on the same samples likewise;
7. sketch-multiclass -- AUROC(num_classes=1000) over 12 flagship batches
   (sketch rows of 2002 columns, 10 compactions), checked against the port
   on the CPU within the float32 summation bound; its error against scipy
   is printed;
8. map-coco -- the main path of K6: COCO mAP over the COCO-shaped fixture
   of bench.py at the size of COCO val2017 (5000 images, seed 3, 91
   classes, 10-100 detections and 1-30 ground truths per image), fed as
   lists of per-image card tensors, 16 images per update (313 updates),
   through MeanAveragePrecision(class_metrics=True, max_images=8192);
   launch counters reset before the updates and read after the cold
   compute(); ms per update, cold and warm (median of 3) compute seconds,
   images/s, table bytes, peak device memory; gates: every result key equal
   bit for bit to the port's CPU run of the same stream and to an
   exact=True run on the card, and images_seen 5000;
9. map-default -- the same stream through the default capacity (4096
   images, past capacity): the admitted images equal the 4096 ids of
   highest hash key computed in numpy, and card and CPU results are equal
   bit for bit;
10. map-pycoco -- the two-batch COCO fixture of the JAX package's tests
   within its tolerance (1e-1) of pycocotools' official numbers; the
   largest deviation per key is printed;
11. the kernels line: per kernel its launches on its main path (flagship for
   K1, sketch-binary for K3, map-coco for K6, the entry point ops.box_iou
   on 2-D boxes for K5), its error against the plain version, and its
   time, the plain version's time, the library call's time (none computes
   box IoU) and the byte bound, all at the main paths' shapes.

Then the card's name and power limit as nvidia-smi reports them, and last
``{"ok": true, "device": {"platform": "gpu", ...}}``. Any failed check
raises, so the script exits non-zero and prints no result line; it does the
same without CUDA, or without the metrics_tpu_torch package beside it.
"""
import json
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from importlib import import_module

import numpy as np

BATCH = 4096
NUM_CLASSES = 1000
ITERS = 50
WARMUP = 1
CAPACITY = 65536
STATEFUL_BATCHES = 12
#: H100 SXM HBM3 bandwidth (NVIDIA data sheet), for the byte bounds
HBM_BYTES_PER_S = 3.35e12
KERNEL_SOURCE = "metrics_tpu_torch/csrc/segment_sum.cu"
REPLACES = "metrics_tpu/ops/scatter_pallas.py:68"
QSKETCH_SOURCE = "metrics_tpu_torch/csrc/qsketch.cu"
QSKETCH_REPLACES = "metrics_tpu/ops/qsketch_pallas.py:149"
TIMING_LAUNCHES = 200
#: the sketched default: capacity, batch, batches (one test day of a
#: display-ads click log) and the positive rate of that stream
SKETCH_CAPACITY = 8192
SKETCH_BATCH = 8192
SKETCH_BATCHES = 800
CTR_POSITIVE_RATE = 0.26
SKETCH_MC_BATCHES = 12
COMPUTE_REPEATS = 5
#: box IoU: the sources and TPU kernels, the parity shapes ([N, M] for K5;
#: [U, D, G] for K6: the COCO fixture's chunk, the TPU route's measured
#: shapes and a ragged one) and the byte-bound shapes of the kernels line
BOX_IOU_SOURCE = "metrics_tpu_torch/csrc/box_iou.cu"
K5_REPLACES = "metrics_tpu/ops/box_iou_pallas.py:54"
K6_REPLACES = "metrics_tpu/ops/box_iou_pallas.py:104"
K5_PARITY_SHAPES = ((1024, 1024), (4096, 4096), (1000, 3000))
K6_PARITY_SHAPES = ((65536, 8, 8), (4096, 128, 32), (1024, 128, 128), (16384, 64, 16), (1000, 100, 30))
K5_LINE_SHAPE = (4096, 4096)
K6_LINE_SHAPE = (65536, 8, 8)
#: the COCO-val-sized detection stream: images, images per update, classes,
#: seed, and a table capacity that holds them all
MAP_IMAGES = 5000
MAP_BATCH = 16
MAP_CLASSES = 91
MAP_SEED = 3
MAP_LOSSLESS_CAPACITY = 8192
#: K3 parity cases: (name, rows, columns, share of zero-weight rows, tied keys)
QSKETCH_PARITY_CASES = (
    ("[1024,3]", 1024, 3, 0.0, False),
    ("[16384,3]", 16384, 3, 0.0, False),
    ("[32768,16]", 32768, 16, 0.0, False),
    ("[12288,2002]", 12288, 2002, 0.0, False),
    ("[5001,4] tied keys, zero-weight rows", 5001, 4, 0.3, True),
)


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def make_data(n_batches):
    """The seed-42 softmax fixture of bench.py (``_make_data``)."""
    rng = np.random.RandomState(42)
    shape = (n_batches, BATCH, NUM_CLASSES)
    logits = rng.rand(*shape).astype(np.float32) * 4
    preds = np.exp(logits - logits.max(axis=-1, keepdims=True))
    preds /= preds.sum(axis=-1, keepdims=True)
    target = rng.randint(0, NUM_CLASSES, size=shape[:-1]).astype(np.int64)
    return preds, target


def time_ms(torch, fn, launches=TIMING_LAUNCHES):
    """Mean device time of ``fn()`` over ``launches`` back-to-back calls (CUDA events)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def _self_device_us(evt):
    return getattr(evt, "self_device_time_total", None) or evt.self_cuda_time_total


def kernel_device_ms(torch, fn, kernel_names, launches=50):
    """Device time of one call of ``fn`` spent in the kernels named
    ``kernel_names`` (a name or a tuple of the names a wrapper launches
    once each), from torch.profiler; the wrappers' host work and the output
    zeroing are not in it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    total_ms = 0.0
    for kernel_name in (kernel_names,) if isinstance(kernel_names, str) else kernel_names:
        rows = [evt for evt in averages if kernel_name in evt.key]
        # the profiler may miss an event at the edge of its window: average
        # over the launches it saw
        count = sum(evt.count for evt in rows)
        check(count > 0, f"the profiler saw no launch of {kernel_name}")
        total_ms += sum(_self_device_us(evt) for evt in rows) / count / 1e3
    return total_ms


def device_profile(torch, step, steps):
    """``step(i)`` for ``i < steps`` under torch.profiler: wall and device
    time per step and the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    # device rows (kernels, memsets, copies) have no CPU time of their own
    device = [evt for evt in prof.key_averages() if evt.self_cpu_time_total == 0 and _self_device_us(evt) > 0]
    device_us = sum(_self_device_us(evt) for evt in device)
    top = sorted(device, key=_self_device_us, reverse=True)[:8]
    return {
        "profiled_wall_ms_per_step": wall_s / steps * 1e3,
        "device_busy_ms_per_step": device_us / steps / 1e3,
        "device_us_per_step_by_kernel": {evt.key[:80]: _self_device_us(evt) / steps for evt in top},
    }


def host_us_per_call(torch, fn, calls=200):
    """Host time to issue one call (no synchronisation inside the window)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def numpy_auroc(scores, target, num_classes):
    """Per-class one-vs-rest AUROC from scipy midranks, in float64."""
    from scipy.stats import rankdata

    n = scores.shape[0]
    ranks = rankdata(scores.astype(np.float64), axis=0)
    own = ranks[np.arange(n), target]
    rank_sum = np.bincount(target, weights=own, minlength=num_classes)
    n_pos = np.bincount(target, minlength=num_classes).astype(np.float64)
    n_neg = n - n_pos
    defined = (n_pos > 0) & (n_neg > 0)
    with np.errstate(invalid="ignore", divide="ignore"):
        per_class = np.where(defined, (rank_sum - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg), np.nan)
    return per_class, float(np.mean(per_class[defined]))


def midrank_auroc(score, y):
    """Binary AUROC from scipy midranks of the whole stream, in float64."""
    from scipy.stats import rankdata

    ranks = rankdata(score.astype(np.float64))
    positive = y.astype(bool)
    n_pos = int(positive.sum())
    n_neg = positive.size - n_pos
    return float((ranks[positive].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def make_ctr_stream(rows):
    """A click log of ``rows`` samples from seed 42: a click with
    probability 0.26, the model's score sigmoid(randn + 1.2 * click), float32
    scores and int64 labels."""
    rng = np.random.default_rng(42)
    clicked = rng.random(rows) < CTR_POSITIVE_RATE
    score = 1.0 / (1.0 + np.exp(-(rng.standard_normal(rows) + 1.2 * clicked)))
    return score.astype(np.float32), clicked.astype(np.int64)


def median_ms(torch, fn, repeats=COMPUTE_REPEATS):
    """Median wall time of ``fn()`` with a synchronise, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def bitwise_rows_differ(torch, a, b):
    """Rows of two float32 sketches that differ in any bit."""
    return int((a.cpu().view(torch.int32) != b.cpu().view(torch.int32)).any(dim=1).sum())


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def qsketch_rows(torch, gen, n, cols, zero_share=0.0, tied=False):
    """Sketch rows ``[w, key, payload...]``: integer weights 1..4 (0 for about
    ``zero_share`` of the rows), float keys (integers with many ties when
    ``tied``), integer payloads."""
    rows = torch.zeros(n, cols)
    rows[:, 0] = torch.randint(1, 5, (n,), generator=gen).float()
    rows[:, 0][torch.rand(n, generator=gen) < zero_share] = 0
    rows[:, 1] = torch.randint(0, 50, (n,), generator=gen).float() if tied else torch.randn(n, generator=gen)
    rows[:, 2:] = torch.randint(0, 3, (n, cols - 2), generator=gen).float()
    return rows


def qsketch_parity_phase(torch, ops, card):
    """qsketch_sort_bucket against its plain version; launches here are not counted."""
    gen = torch.Generator(device="cpu").manual_seed(1)
    results = []
    for name, n, cols, zero_share, tied in QSKETCH_PARITY_CASES:
        host = qsketch_rows(torch, gen, n, cols, zero_share, tied)
        rows = host.cuda()
        got = ops.qsketch_sort_bucket(rows, SKETCH_CAPACITY)
        again = ops.qsketch_sort_bucket(rows, SKETCH_CAPACITY)
        plain = ops.qsketch_sort_bucket_reference(rows, SKETCH_CAPACITY)
        plain_cpu = ops.qsketch_sort_bucket_reference(host, SKETCH_CAPACITY)
        torch.cuda.synchronize()
        for part, a, b, c, d in zip(("weighted rows", "bucket ids", "permutation"), got, again, plain, plain_cpu):
            check(torch.equal(a, b), f"qsketch_sort_bucket {name}: two runs differ in the {part}")
            check(torch.equal(a, c), f"qsketch_sort_bucket {name}: the {part} differ from the plain version")
            check(torch.equal(a.cpu(), d), f"qsketch_sort_bucket {name}: the {part} differ from the plain version on the CPU")
        # the whole compaction (K3, K1's float form, the epilogue) at a
        # capacity these rows overflow
        capacity = min(SKETCH_CAPACITY, n // 16 * 8)
        compacted = ops.qsketch_compact_dispatch(rows, capacity)
        check(
            torch.equal(compacted.cpu(), ops.compact_rows_reference(host, capacity)),
            f"qsketch compaction {name}: differs from its plain version",
        )
        results.append(
            {
                "case": name,
                "max_abs_err": float((got[0] - plain[0]).abs().max()),
                "buckets_differ": int((got[1] != plain[1]).sum()),
                "compaction_capacity": capacity,
                "ms": time_ms(torch, lambda: ops.qsketch_sort_bucket(rows, SKETCH_CAPACITY), launches=20),
                "card": card,
            }
        )
    emit({"phase": "parity_qsketch", "qsketch_sort_bucket": results})


def sketch_binary_phase(torch, ops, card, AUROC):
    """The sketched default over one day of a click log (the main path of K3)."""
    rows = SKETCH_BATCH * SKETCH_BATCHES
    t0 = time.perf_counter()
    score_np, y_np = make_ctr_stream(rows)
    score, y = torch.from_numpy(score_np).cuda(), torch.from_numpy(y_np).cuda()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def batch(i):
        return score[i * SKETCH_BATCH : (i + 1) * SKETCH_BATCH], y[i * SKETCH_BATCH : (i + 1) * SKETCH_BATCH]

    metric = AUROC()
    check(metric.device.type == "cuda", f"AUROC() defaults to {metric.device}, not the card")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(SKETCH_BATCHES):
        metric.update(*batch(i))
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    # the first batch fills the empty sketch; every later one may overflow
    # it, so each compacts once
    compactions = SKETCH_BATCHES - 1
    for name in ("qsketch_sort_bucket", "segment_sum_f32"):
        check(launches.get(name) == compactions, f"sketch-binary launched {name} {launches.get(name)} times, expected {compactions}")

    t0 = time.perf_counter()
    value = float(metric.compute())
    cold_compute_ms = (time.perf_counter() - t0) * 1e3
    state = {name: getattr(metric, name) for name in ("csketch", "n_seen")}
    warm_compute_ms = median_ms(torch, lambda: metric.compute_state(state))
    total_weight = float(metric.csketch[:, 0].double().sum())
    check(total_weight == rows, f"sketch total weight {total_weight}, expected {rows}")
    reference = midrank_auroc(score_np, y_np)
    err = abs(value - reference)
    check(err <= 5e-3, f"sketched AUROC {value} is {err} off the float64 midrank AUROC {reference}")

    cpu_metric = AUROC(device="cpu")
    for i in range(SKETCH_BATCHES):
        lo, hi = i * SKETCH_BATCH, (i + 1) * SKETCH_BATCH
        cpu_metric.update(torch.from_numpy(score_np[lo:hi]), torch.from_numpy(y_np[lo:hi]))
    cpu_value = float(cpu_metric.compute())
    check(abs(value - cpu_value) <= 1e-6, f"sketch-binary: card {value} and CPU {cpu_value} differ")
    rows_differ = bitwise_rows_differ(torch, metric.csketch, cpu_metric.csketch)
    ms_per_update = update_s / SKETCH_BATCHES * 1e3
    profile = device_profile(torch, lambda i: metric.update(*batch(i)), 5)
    emit(
        {
            "phase": "sketch-binary",
            "card": card,
            "rows": rows,
            "batch": SKETCH_BATCH,
            "sketch_capacity": SKETCH_CAPACITY,
            "setup_s": setup_s,
            "ms_per_update": ms_per_update,
            "samples_per_s": rows / update_s,
            "cold_compute_ms": cold_compute_ms,
            "warm_compute_ms": warm_compute_ms,
            "state_bytes": sum(t.numel() * t.element_size() for t in state.values()),
            "launches": launches,
            "auroc": value,
            "float64_midrank_auroc": reference,
            "abs_err_vs_midrank": err,
            "cpu_auroc": cpu_value,
            "abs_diff_card_cpu": abs(value - cpu_value),
            "sketch_rows_differ_bitwise": rows_differ,
            "total_weight": total_weight,
            **profile,
            "device_idle_share": 1 - profile["device_busy_ms_per_step"] / ms_per_update,
        }
    )
    return launches, score_np, y_np, metric, batch


def sketch_window_phase(torch, ops, card, AUROC, score_np, y_np):
    """The default inside its lossless window: exact, no compaction; and the
    binary capacity mode on the same samples."""
    score = torch.from_numpy(score_np[:SKETCH_CAPACITY]).cuda()
    y = torch.from_numpy(y_np[:SKETCH_CAPACITY]).cuda()
    metric = AUROC()
    ops.reset_launch_counts()
    metric.update(score, y)
    value = float(metric.compute())
    launches = ops.launch_counts()
    check(launches.get("qsketch_sort_bucket", 0) == 0, f"sketch-window compacted: {launches}")
    reference = midrank_auroc(score_np[:SKETCH_CAPACITY], y_np[:SKETCH_CAPACITY])
    err = abs(value - reference)
    check(err <= 1e-6, f"sketch-window AUROC {value} is {err} off scipy's {reference}")
    capacity_metric = AUROC(capacity=SKETCH_CAPACITY)
    capacity_metric.update(score, y)
    capacity_err = abs(float(capacity_metric.compute()) - reference)
    check(capacity_err <= 1e-6, f"binary AUROC(capacity) is {capacity_err} off scipy's {reference}")
    emit(
        {
            "phase": "sketch-window",
            "card": card,
            "rows": SKETCH_CAPACITY,
            "auroc": value,
            "abs_err_vs_scipy": err,
            "binary_capacity_abs_err_vs_scipy": capacity_err,
            "launches": launches,
        }
    )


def sketch_multiclass_phase(torch, ops, card, AUROC, preds_all, target_all, preds_np, target_np):
    """AUROC(num_classes=1000) in the sketched default: 2002-column rows."""
    metric = AUROC(num_classes=NUM_CLASSES)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(SKETCH_MC_BATCHES):
        metric.update(preds_all[i], target_all[i])
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    # two batches fill the empty sketch; each later one compacts once
    compactions = SKETCH_MC_BATCHES - SKETCH_CAPACITY // BATCH
    check(launches.get("qsketch_sort_bucket") == compactions, f"sketch-multiclass launches {launches}")
    t0 = time.perf_counter()
    value = float(metric.compute())
    cold_compute_ms = (time.perf_counter() - t0) * 1e3
    state = {name: getattr(metric, name) for name in ("csketch", "n_seen")}
    warm_compute_ms = median_ms(torch, lambda: metric.compute_state(state))

    cpu_metric = AUROC(num_classes=NUM_CLASSES, device="cpu")
    for i in range(SKETCH_MC_BATCHES):
        cpu_metric.update(torch.from_numpy(preds_np[i]), torch.from_numpy(target_np[i]))
    cpu_value = float(cpu_metric.compute())
    # the weighted kernels read at most `capacity` rows per class: the card's
    # and the CPU's cumulative sums of n float32 terms differ by at most
    # (n - 1) 2**-24 of their totals, in each rate and in the trapezoid sum
    bound = 3 * SKETCH_CAPACITY * 2.0**-24
    diff = abs(value - cpu_value)
    check(diff <= bound, f"sketch-multiclass: card {value} and CPU {cpu_value} differ by {diff} > {bound}")
    rows = SKETCH_MC_BATCHES * BATCH
    _, reference = numpy_auroc(preds_np[:SKETCH_MC_BATCHES].reshape(rows, -1), target_np[:SKETCH_MC_BATCHES].reshape(-1), NUM_CLASSES)
    emit(
        {
            "phase": "sketch-multiclass",
            "card": card,
            "rows": rows,
            "sketch_cols": int(metric.csketch.shape[1]),
            "ms_per_update": update_s / SKETCH_MC_BATCHES * 1e3,
            "cold_compute_ms": cold_compute_ms,
            "warm_compute_ms": warm_compute_ms,
            "state_bytes": sum(t.numel() * t.element_size() for t in state.values()),
            "launches": launches,
            "macro_auroc": value,
            "cpu_macro_auroc": cpu_value,
            "abs_diff_card_cpu": diff,
            "summation_bound": bound,
            "sketch_rows_differ_bitwise": bitwise_rows_differ(torch, metric.csketch, cpu_metric.csketch),
            "scipy_macro_auroc": reference,
            "abs_err_vs_scipy": abs(value - reference),
        }
    )


def parity_phase(torch, ops, card, flagship_ids, rank_vals, auroc_ids):
    """Kernels against their plain versions on the card; launches here are not counted."""
    results = {}
    # bincount_i32: the ConfusionMatrix ids plus ids the kernel must drop
    extra = torch.tensor([-1, -5, NUM_CLASSES**2, 2**40, NUM_CLASSES**2 - 1, 0], device=flagship_ids.device)
    for name, ids in (("flagship", flagship_ids), ("flagship+dropped", torch.cat([flagship_ids, extra]))):
        for dtype in (torch.int64, torch.int32):
            if dtype == torch.int32 and name != "flagship":
                continue  # 2**40 does not fit; int32 ids are covered in range
            got = ops.bincount_i32(ids.to(dtype), NUM_CLASSES**2)
            want = ops.bincount_reference(ids, NUM_CLASSES**2)
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            check(torch.equal(got, want), f"bincount_i32 {name} {dtype} differs from its plain version")
            results.setdefault("bincount_i32", []).append({"case": f"{name} {str(dtype)[6:]}", "max_abs_err": err})

    gen = torch.Generator(device="cpu").manual_seed(0)
    cases = [("rank-auroc sums", rank_vals, auroc_ids, NUM_CLASSES)]
    for b, d, s in ((4096, 1, NUM_CLASSES**2), (32768, 16, 2052), (4096, 130, 1000)):
        ids = torch.randint(-3, s + 3, (b,), generator=gen)
        cases.append((f"[{b},{d}]->{s} integer", torch.randint(-9, 9, (b, d), generator=gen).float(), ids, s))
        cases.append((f"[{b},{d}]->{s} float", torch.rand((b, d), generator=gen), ids, s))
    for name, vals, ids, s in cases:
        vals, ids = vals.cuda(), ids.cuda()
        got = ops.segment_sum_f32(vals, ids, s)
        again = ops.segment_sum_f32(vals, ids, s)
        plain = ops.segment_sum_reference(vals, ids, s)
        plain_cpu = ops.segment_sum_reference(vals.cpu(), ids.cpu(), s)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"segment_sum_f32 {name}: two runs differ")
        check(torch.equal(got.cpu(), plain_cpu), f"segment_sum_f32 {name}: differs from the row-order plain version")
        err = float((got - plain).abs().max())
        row = {"case": name, "max_abs_err": err}
        if "float" in name:
            row["max_rel_err"] = float(((got - plain).abs() / plain.abs().clamp(min=1e-30)).max())
            # any two summation orders of k float32 terms differ by at most
            # 2 (k - 1) 2**-24 sum|v| (the card's index_add_ adds with atomics)
            k = ops.segment_sum_reference(torch.ones_like(vals[:, :1]), ids, s).double()
            bound = 2 * (k - 1).clamp(min=0) * 2.0**-24 * ops.segment_sum_reference(vals.abs().double(), ids, s)
            check(bool(((got - plain).abs().double() <= bound).all()), f"segment_sum_f32 {name}: past the bound")
        else:
            check(torch.equal(got, plain), f"segment_sum_f32 {name}: differs on integer-valued data")
        row["ms"] = time_ms(torch, lambda: ops.segment_sum_f32(vals, ids, s), launches=20)
        row["card"] = card
        results.setdefault("segment_sum_f32", []).append(row)
    emit({"phase": "parity", **results})
    # the error at the main path's own inputs (the first case of each kernel)
    return {name: rows[0]["max_abs_err"] for name, rows in results.items()}


def iou_boxes(torch, gen, n, scale=500.0):
    """``[n, 4]`` xyxy boxes (float32, CPU) with the degenerate kinds the
    kernels must take: zero width and height, a touching pair, an inverted
    box, and zero padding at the end."""
    xy = torch.rand((n, 2), generator=gen) * scale
    boxes = torch.cat([xy, xy + torch.rand((n, 2), generator=gen) * scale / 3], dim=1)
    if n >= 8:
        boxes[0] = torch.tensor([10.0, 10.0, 10.0, 30.0])
        boxes[1] = torch.tensor([10.0, 10.0, 30.0, 10.0])
        boxes[2] = torch.tensor([30.0, 30.0, 10.0, 10.0])
        boxes[3] = boxes[4] + torch.stack([boxes[4, 2] - boxes[4, 0], torch.tensor(0.0)]).repeat(2)
        boxes[-2:] = 0
    return boxes


def box_iou_parity_phase(torch, ops, card):
    """K5 and K6 against their plain version, on card tensors and on the CPU,
    bit for bit; launches here are not counted."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cpu").manual_seed(2)
    results = {"box_iou_pairwise": [], "box_iou_batched": []}
    cases = [("box_iou_pairwise", f"[{n},{m}]", (n,), (m,)) for n, m in K5_PARITY_SHAPES]
    cases += [("box_iou_batched", f"[{u},{d},{g}]", (u, d), (u, g)) for u, d, g in K6_PARITY_SHAPES]
    for kernel, name, lead1, lead2 in cases:
        host1 = iou_boxes(torch, gen, int(np.prod(lead1))).reshape(*lead1, 4)
        host2 = iou_boxes(torch, gen, int(np.prod(lead2))).reshape(*lead2, 4)
        if kernel == "box_iou_batched":
            # each unit's ground truths zero-padded past a random count, as the mAP packing leaves them
            live = torch.arange(lead2[1])[None, :] < torch.randint(1, lead2[1] + 1, (lead2[0], 1), generator=gen)
            host2 = host2 * live[:, :, None]
        b1, b2 = host1.cuda(), host2.cuda()
        fn = getattr(ops, kernel)
        got = fn(b1, b2)
        again = fn(b1, b2)
        plain = ops.box_iou_reference(b1, b2)
        plain_cpu = ops.box_iou_reference(host1, host2)
        torch.cuda.synchronize()
        check(torch.equal(got.view(torch.int32), again.view(torch.int32)), f"{kernel} {name}: two runs differ")
        check(torch.equal(got.view(torch.int32), plain.view(torch.int32)), f"{kernel} {name}: differs from the plain version")
        check(
            torch.equal(got.cpu().view(torch.int32), plain_cpu.view(torch.int32)),
            f"{kernel} {name}: differs from the plain version on the CPU",
        )
        results[kernel].append(
            {
                "case": name,
                "max_abs_err": float((got - plain).abs().max()),
                "ms": time_ms(torch, lambda: fn(b1, b2), launches=20),
                "card": card,
            }
        )
    # float64 keeps float64 through the same kernel
    b1, b2 = (iou_boxes(torch, gen, 256).double().reshape(16, 16, 4).cuda() for _ in range(2))
    check(torch.equal(ops.box_iou_batched(b1, b2), ops.box_iou_reference(b1, b2)), "box_iou_batched float64 differs")
    emit({"phase": "parity_box_iou", "seconds": time.perf_counter() - t_phase, **results})


def make_detection_data(n_imgs, n_classes=MAP_CLASSES, seed=MAP_SEED):
    """The COCO-shaped fixture of bench.py (``_make_detection_data``): 91
    classes, 10-100 detections and 1-30 ground truths per image, float32
    boxes, scores and int32 labels."""
    rng = np.random.default_rng(seed)
    preds, target = [], []
    for _ in range(n_imgs):
        nd = int(rng.integers(10, 101))
        ng = int(rng.integers(1, 31))

        def boxes(n):
            x1 = rng.uniform(0, 500, n)
            y1 = rng.uniform(0, 500, n)
            w = rng.uniform(4, 150, n)
            h = rng.uniform(4, 150, n)
            return np.stack([x1, y1, x1 + w, y1 + h], 1).astype(np.float32)

        preds.append(
            dict(
                boxes=boxes(nd),
                scores=rng.uniform(0, 1, nd).astype(np.float32),
                labels=rng.integers(0, n_classes, nd).astype(np.int32),
            )
        )
        target.append(dict(boxes=boxes(ng), labels=rng.integers(0, n_classes, ng).astype(np.int32)))
    return preds, target


def images_on(torch, images, device):
    """Per-image dicts of tensors on ``device``: each field concatenated on
    the host, moved in one copy and split back into per-image views."""
    out = [dict() for _ in images]
    for key in images[0]:
        parts = [image[key] for image in images]
        whole = torch.from_numpy(np.concatenate(parts)).to(device)
        for image, view in zip(out, torch.split(whole, [len(p) for p in parts])):
            image[key] = view
    return out


def feed_map(metric, preds, target):
    for lo in range(0, len(preds), MAP_BATCH):
        metric.update(preds[lo : lo + MAP_BATCH], target[lo : lo + MAP_BATCH])


def keys_that_differ(torch, a, b):
    """Keys whose float32 values differ in any bit."""
    check(list(a) == list(b), f"result keys differ: {list(a)} and {list(b)}")
    return [k for k in a if not torch.equal(a[k].cpu().reshape(-1).view(torch.int32), b[k].cpu().reshape(-1).view(torch.int32))]


def numpy_reservoir_key(ids):
    """The reservoir's hash priority, computed independently in numpy uint32."""
    x = ids.astype(np.uint32)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    x = x ^ (x >> np.uint32(16))
    return ((x >> np.uint32(8)).astype(np.float32) + np.float32(1.0)) / np.float32(1 << 24)


def map_phases(torch, ops, card, MeanAveragePrecision):
    """map-coco (the main path of K6), map-default and map-pycoco."""
    t_phase = t0 = time.perf_counter()
    preds_np, target_np = make_detection_data(MAP_IMAGES)
    preds, target = images_on(torch, preds_np, "cuda"), images_on(torch, target_np, "cuda")
    preds_cpu, target_cpu = images_on(torch, preds_np, "cpu"), images_on(torch, target_np, "cpu")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_updates = -(-MAP_IMAGES // MAP_BATCH)

    # map-coco: lossless capacity, the K6 main path
    torch.cuda.synchronize()
    memory_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    metric = MeanAveragePrecision(class_metrics=True, max_images=MAP_LOSSLESS_CAPACITY)
    check(metric.device.type == "cuda", f"MeanAveragePrecision() defaults to {metric.device}, not the card")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    feed_map(metric, preds, target)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    result = metric.compute()
    torch.cuda.synchronize()
    cold_compute_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    check(launches.get("box_iou_batched", 0) > 0, f"map-coco launched no box_iou_batched: {launches}")
    check(int(metric.images_seen) == MAP_IMAGES, f"images_seen {int(metric.images_seen)}, expected {MAP_IMAGES}")
    peak = torch.cuda.max_memory_allocated()
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        metric.compute_state(metric.state_dict())
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    breakdown = compute_breakdown(torch, metric)
    compute_profile = device_profile(torch, lambda i: metric.compute_state(metric.state_dict()), 1)

    t0 = time.perf_counter()
    cpu_metric = MeanAveragePrecision(class_metrics=True, max_images=MAP_LOSSLESS_CAPACITY, device="cpu")
    feed_map(cpu_metric, preds_cpu, target_cpu)
    cpu_result = cpu_metric.compute()
    cpu_s = time.perf_counter() - t0
    differ_cpu = keys_that_differ(torch, result, cpu_result)
    check(not differ_cpu, f"map-coco: card and CPU differ in {differ_cpu}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        exact = MeanAveragePrecision(class_metrics=True, exact=True)
    feed_map(exact, preds, target)
    t0 = time.perf_counter()
    exact_result = exact.compute()
    exact_compute_s = time.perf_counter() - t0
    differ_exact = keys_that_differ(torch, result, exact_result)
    check(not differ_exact, f"map-coco: table and exact=True differ in {differ_exact}")
    table = metric.table
    emit(
        {
            "phase": "map-coco",
            "seconds": time.perf_counter() - t_phase,
            "card": card,
            "images": MAP_IMAGES,
            "batch_images": MAP_BATCH,
            "updates": n_updates,
            "max_images": MAP_LOSSLESS_CAPACITY,
            "setup_s": setup_s,
            "ms_per_update": update_s / n_updates * 1e3,
            "cold_compute_s": cold_compute_s,
            "warm_compute_s_median_of_3": float(np.median(warm)),
            "images_per_s": MAP_IMAGES / (update_s + cold_compute_s),
            "launches": launches,
            "table_bytes": table.numel() * table.element_size(),
            "peak_memory_bytes": peak,
            "memory_before_phase_bytes": memory_before,
            "peak_memory_of_phase_bytes": peak - memory_before,
            "warm_compute_breakdown_s": breakdown,
            "compute_device_busy_ms": compute_profile["device_busy_ms_per_step"],
            "compute_device_idle_share": 1 - compute_profile["device_busy_ms_per_step"] / compute_profile["profiled_wall_ms_per_step"],
            "compute_device_us_by_kernel": compute_profile["device_us_per_step_by_kernel"],
            "map": float(result["map"]),
            "map_50": float(result["map_50"]),
            "mar_100": float(result["mar_100"]),
            "keys_differ_card_cpu": differ_cpu,
            "keys_differ_table_exact": differ_exact,
            "cpu_run_s": cpu_s,
            "exact_compute_s": exact_compute_s,
        }
    )

    # map-default: the default capacity (4096) past capacity
    t_phase = time.perf_counter()
    default = MeanAveragePrecision(class_metrics=True)
    t0 = time.perf_counter()
    feed_map(default, preds, target)
    torch.cuda.synchronize()
    default_update_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    default_result = default.compute()
    default_compute_s = time.perf_counter() - t0
    capacity = default.table.shape[0]
    leaf = default.table.cpu().numpy()
    admitted = np.sort(leaf[leaf[:, 0] > -np.inf, 1].astype(np.int64))
    ids = np.arange(MAP_IMAGES, dtype=np.int64)
    want = np.sort(ids[np.lexsort((ids, -numpy_reservoir_key(ids)))[:capacity]])
    check(np.array_equal(admitted, want), "map-default: the admitted images are not the top ids by hash")
    cpu_default = MeanAveragePrecision(class_metrics=True, device="cpu")
    feed_map(cpu_default, preds_cpu, target_cpu)
    differ_default = keys_that_differ(torch, default_result, cpu_default.compute())
    check(not differ_default, f"map-default: card and CPU differ in {differ_default}")
    emit(
        {
            "phase": "map-default",
            "seconds": time.perf_counter() - t_phase,
            "card": card,
            "images": MAP_IMAGES,
            "max_images": capacity,
            "admitted": int(admitted.size),
            "admitted_equal_numpy_top_by_hash": True,
            "ms_per_update": default_update_s / n_updates * 1e3,
            "compute_s": default_compute_s,
            "images_per_s": MAP_IMAGES / (default_update_s + default_compute_s),
            "map": float(default_result["map"]),
            "map_50": float(default_result["map_50"]),
            "mar_100": float(default_result["mar_100"]),
            "keys_differ_card_cpu": differ_default,
        }
    )

    # map-pycoco: the two-batch COCO fixture with pycocotools' numbers
    t_phase = time.perf_counter()
    pycoco = MeanAveragePrecision(class_metrics=True)
    for batch_preds, batch_target in zip(PYCOCO_PREDS, PYCOCO_TARGET):
        pycoco.update([pycoco_sample(torch, p) for p in batch_preds], [pycoco_sample(torch, t) for t in batch_target])
    got = pycoco.compute()
    deviation = {
        key: float(np.max(np.abs(got[key].cpu().numpy() - np.asarray(expected, np.float32))))
        for key, expected in PYCOCO_EXPECTED.items()
    }
    worst = max(deviation.values())
    check(worst <= PYCOCO_ATOL, f"map-pycoco: {worst} off pycocotools (atol {PYCOCO_ATOL})")
    emit(
        {
            "phase": "map-pycoco",
            "seconds": time.perf_counter() - t_phase,
            "card": card,
            "atol": PYCOCO_ATOL,
            "max_abs_dev_by_key": deviation,
        }
    )
    return launches


def compute_breakdown(torch, metric):
    """Seconds of one warm ``compute()`` in its stages: the host unit
    packing, the matching on the card (chunk copies, matcher, K6, reads
    back), the host float64 PR reduction, and the rest (the table read,
    the unpack, the summaries). The stages are timed by wrapping them for
    this one call."""
    module = import_module("metrics_tpu_torch.detection.mean_ap")
    seconds = {"pack_units": 0.0, "match": 0.0, "precision_recall": 0.0}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name] += time.perf_counter() - t0
            return out

        return wrapper

    saved = (module._pack_units, module._calculate_precision_recall, module.MeanAveragePrecision._match)
    module._pack_units = timed("pack_units", saved[0])
    module._calculate_precision_recall = timed("precision_recall", saved[1])
    module.MeanAveragePrecision._match = timed("match", saved[2])
    try:
        t0 = time.perf_counter()
        metric.compute_state(metric.state_dict())
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        module._pack_units, module._calculate_precision_recall, module.MeanAveragePrecision._match = saved
    return {**seconds, "rest": total - sum(seconds.values()), "total": total}


def pycoco_sample(torch, sample):
    out = {k: torch.tensor(v, dtype=torch.float32, device="cuda") for k, v in sample.items() if k != "labels"}
    out["labels"] = torch.tensor(sample["labels"], dtype=torch.int32, device="cuda")
    return out


#: the COCO subset of the JAX package's test suite (tests/detection/test_map.py,
#: from pycocotools' instances_val2014_fakebbox100 results) and the official
#: pycocotools values, held at that test's tolerance
PYCOCO_PREDS = [
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
PYCOCO_TARGET = [
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
PYCOCO_EXPECTED = {
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
PYCOCO_ATOL = 1e-1


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a CUDA card", file=sys.stderr)
        return 2
    card = card_line()

    from metrics_tpu_torch import AUROC, ConfusionMatrix, MeanAveragePrecision, MetricCollection
    from metrics_tpu_torch import ops
    from metrics_tpu_torch.functional import auroc_rank_multiclass
    from metrics_tpu_torch.ops.build import build
    from metrics_tpu_torch.ops.qsketch import pack_rows

    device = torch.device("cuda")
    torch.manual_seed(0)

    # 1. build: one nvcc per source, all started together
    modules = [import_module(f"metrics_tpu_torch.ops.{name}") for name in ("segment_sum", "qsketch", "box_iou")]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modules)) as pool:
        built = list(pool.map(build, [module.SOURCE for module in modules]))
    build_wall_s = time.perf_counter() - t0
    for module in modules:
        module.load_library()
    emit(
        {
            "phase": "build",
            "wall_seconds": build_wall_s,
            "libraries": [
                {"library": path.name, "seconds": seconds, "ptxas": [line.strip() for line in log.splitlines() if "Used" in line]}
                for path, seconds, log in built
            ],
        }
    )

    # set-up: the fixture, made on the host and moved to the card once
    t0 = time.perf_counter()
    preds_np, target_np = make_data(ITERS)
    preds_all = torch.from_numpy(preds_np).to(device)
    target_all = torch.from_numpy(target_np).to(device)
    torch.cuda.synchronize()
    emit({"phase": "data", "seconds": time.perf_counter() - t0, "bytes_on_card": preds_all.numel() * 4})

    # the main path's kernel inputs, for parity and timing
    flagship_ids = target_all[0] * NUM_CLASSES + preds_all[0].argmax(dim=1)
    rank_vals = torch.stack(
        [torch.randint(2, 2 * BATCH + 1, (BATCH,), device=device).float() / 2, torch.ones(BATCH, device=device)], dim=1
    )
    auroc_ids = target_all[0]

    # 2. kernel parity
    max_err = parity_phase(torch, ops, card, flagship_ids, rank_vals, auroc_ids)
    qsketch_parity_phase(torch, ops, card)
    box_iou_parity_phase(torch, ops, card)

    # 3. the flagship epoch (the main path)
    confmat = ConfusionMatrix(num_classes=NUM_CLASSES)

    def epoch():
        state = confmat.init_state()
        auc = None
        for i in range(ITERS):
            state = confmat.update_state(state, preds_all[i], target_all[i])
            auc = auroc_rank_multiclass(preds_all[i], target_all[i], NUM_CLASSES, average="macro")
        return state, auc

    for _ in range(WARMUP):
        epoch()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, auc = epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    main_launches = ops.launch_counts()
    for name in ("bincount_i32", "segment_sum_f32"):
        check(main_launches.get(name) == ITERS, f"{name} launched {main_launches.get(name)} times, expected {ITERS}")

    # split: the same 50 steps, confmat update alone and rank AUROC alone
    t0 = time.perf_counter()
    split_state = confmat.init_state()
    for i in range(ITERS):
        split_state = confmat.update_state(split_state, preds_all[i], target_all[i])
    torch.cuda.synchronize()
    confmat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(ITERS):
        auroc_rank_multiclass(preds_all[i], target_all[i], NUM_CLASSES, average="macro")
    torch.cuda.synchronize()
    auroc_s = time.perf_counter() - t0

    pred_labels = preds_np.argmax(axis=-1)
    want_cm = np.bincount((target_np * NUM_CLASSES + pred_labels).ravel(), minlength=NUM_CLASSES**2)
    got_cm = state["confmat"].cpu().numpy()
    check(got_cm.dtype == np.int32, f"confmat dtype {got_cm.dtype}")
    check(np.array_equal(got_cm.reshape(-1), want_cm), "flagship confusion matrix differs from np.bincount")
    ref_per_class, ref_macro = numpy_auroc(preds_np[-1], target_np[-1], NUM_CLASSES)
    per_class = auroc_rank_multiclass(preds_all[-1], target_all[-1], NUM_CLASSES, average=None).cpu().numpy()
    defined = ~np.isnan(ref_per_class)
    check(np.array_equal(np.isnan(per_class), ~defined), "AUROC undefined classes differ")
    auc_err = float(np.max(np.abs(per_class[defined] - ref_per_class[defined])))
    macro_err = abs(float(auc) - ref_macro)
    check(auc_err <= 1e-6 and macro_err <= 1e-6, f"AUROC off the scipy reference: {auc_err}, {macro_err}")
    emit(
        {
            "phase": "flagship",
            "card": card,
            "steps": ITERS,
            "batch": BATCH,
            "num_classes": NUM_CLASSES,
            "epoch_s": epoch_s,
            "samples_per_s": ITERS * BATCH / epoch_s,
            "ms_per_step": epoch_s / ITERS * 1e3,
            "confmat_update_ms_per_step": confmat_s / ITERS * 1e3,
            "rank_auroc_ms_per_step": auroc_s / ITERS * 1e3,
            "launches": main_launches,
            "macro_auroc": float(auc),
            "auroc_max_abs_err_vs_scipy": auc_err,
            "macro_abs_err_vs_scipy": macro_err,
            "confmat_total": int(got_cm.sum()),
        }
    )

    write_profile(torch, confmat, preds_all, target_all, auroc_rank_multiclass, epoch_s / ITERS)

    # 4. the stateful path: AUROC(capacity) and ConfusionMatrix in a collection
    torch.cuda.reset_peak_memory_stats()
    collection = MetricCollection(
        [ConfusionMatrix(num_classes=NUM_CLASSES), AUROC(num_classes=NUM_CLASSES, capacity=CAPACITY)]
    )
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(STATEFUL_BATCHES):
        collection.update(preds_all[i], target_all[i])
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    values = collection.compute()
    torch.cuda.synchronize()
    compute_s = time.perf_counter() - t0
    stateful_launches = ops.launch_counts()
    check(stateful_launches.get("bincount_i32") == STATEFUL_BATCHES, f"stateful bincount launches {stateful_launches}")
    check(stateful_launches.get("segment_sum_f32") == 1, f"stateful segment_sum launches {stateful_launches}")
    rows = STATEFUL_BATCHES * BATCH
    flat_preds, flat_target = preds_np[:STATEFUL_BATCHES].reshape(rows, -1), target_np[:STATEFUL_BATCHES].reshape(-1)
    _, ref_macro = numpy_auroc(flat_preds, flat_target, NUM_CLASSES)
    stateful_err = abs(float(values["AUROC"]) - ref_macro)
    check(stateful_err <= 1e-6, f"stateful AUROC off the scipy reference by {stateful_err}")
    want_cm = np.bincount(
        (flat_target * NUM_CLASSES + flat_preds.argmax(axis=-1)), minlength=NUM_CLASSES**2
    ).reshape(NUM_CLASSES, NUM_CLASSES)
    check(np.array_equal(values["ConfusionMatrix"].cpu().numpy(), want_cm), "stateful confusion matrix differs")
    auroc_metric = collection["AUROC"]
    state_bytes = sum(getattr(auroc_metric, k).numel() * getattr(auroc_metric, k).element_size() for k in ("preds", "target", "valid"))
    emit(
        {
            "phase": "stateful",
            "card": card,
            "rows": rows,
            "capacity": CAPACITY,
            "auroc_state_bytes": state_bytes,
            "update_ms_per_batch": update_s / STATEFUL_BATCHES * 1e3,
            "compute_ms": compute_s * 1e3,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "launches": stateful_launches,
            "macro_auroc": float(values["AUROC"]),
            "macro_abs_err_vs_scipy": stateful_err,
            "compute_groups": {str(k): v for k, v in collection.compute_groups.items()},
        }
    )

    # 5-7. the sketched default: binary (the main path of K3), inside its
    # window, and at 1000 classes
    sketch_launches, score_np, y_np, sketch_metric, sketch_batch = sketch_binary_phase(torch, ops, card, AUROC)
    sketch_window_phase(torch, ops, card, AUROC, score_np, y_np)
    sketch_multiclass_phase(torch, ops, card, AUROC, preds_all, target_all, preds_np, target_np)

    # 9-11. COCO mAP: the main path of K6, past capacity, and pycocotools
    map_launches = map_phases(torch, ops, card, MeanAveragePrecision)
    # K5 is reached by 2-D boxes through the entry point ops.box_iou
    gen = torch.Generator(device="cpu").manual_seed(5)
    k5_inputs = [(iou_boxes(torch, gen, n).cuda(), iou_boxes(torch, gen, m).cuda()) for n, m in K5_PARITY_SHAPES]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for b1, b2 in k5_inputs:
        ops.box_iou(b1, b2)
    torch.cuda.synchronize()
    pairwise_launches = ops.launch_counts().get("box_iou_pairwise", 0)
    check(pairwise_launches == len(K5_PARITY_SHAPES), f"ops.box_iou launched box_iou_pairwise {pairwise_launches} times")

    # K3's input on its main path: the sketch and one batch of unit rows,
    # packed occupied-first, as an absorb hands them to the compaction
    batch_score, batch_y = sketch_batch(0)
    unit_rows = torch.stack([torch.ones_like(batch_score), batch_score, batch_y.float()], dim=1)
    k3_rows = pack_rows(torch.cat([sketch_metric.csketch, unit_rows]))
    k3_keys = torch.where(k3_rows[:, 0] > 0, k3_rows[:, 1], torch.inf)
    k3_got = ops.qsketch_sort_bucket(k3_rows, SKETCH_CAPACITY)
    k3_plain = ops.qsketch_sort_bucket_reference(k3_rows, SKETCH_CAPACITY)
    check(all(torch.equal(a, b) for a, b in zip(k3_got[1:], k3_plain[1:])), "K3 on its main-path input: buckets or order differ")

    def qsketch_call():
        return ops.qsketch_sort_bucket(k3_rows, SKETCH_CAPACITY)

    n_pad = k3_got[0].shape[0]
    # rows read once; weighted rows, bucket ids and permutation written once
    k3_bytes = k3_rows.numel() * 4 + n_pad * (k3_rows.shape[1] * 4 + 4 + 4)

    # 8. kernel times at the main path's shapes (these launches are not
    # counted). "ms", "plain_ms" and "library_ms" are CUDA-event times per
    # call over back-to-back calls, so they include any host time the card
    # waits for; "device_ms" is the kernel alone (profiler) and
    # "host_us_per_call" the wrapper's issue time.
    def bincount_call():
        return ops.bincount_i32(flagship_ids, NUM_CLASSES**2)

    def segment_sum_call():
        return ops.segment_sum_f32(rank_vals, auroc_ids, NUM_CLASSES)

    def index_add_call():
        return torch.zeros((NUM_CLASSES, 2), device=device).index_add_(0, auroc_ids, rank_vals)

    bincount_bytes = flagship_ids.numel() * flagship_ids.element_size() + NUM_CLASSES**2 * 4
    seg_bytes = rank_vals.numel() * 4 + auroc_ids.numel() * auroc_ids.element_size() + NUM_CLASSES * 2 * 4
    kernels = [
        {
            "name": "bincount_i32",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES,
            "launches": main_launches["bincount_i32"],
            "max_abs_err": max_err["bincount_i32"],
            "ms": time_ms(torch, bincount_call),
            "plain_ms": time_ms(torch, lambda: ops.bincount_reference(flagship_ids, NUM_CLASSES**2)),
            "bound_ms": bincount_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": time_ms(torch, lambda: torch.bincount(flagship_ids, minlength=NUM_CLASSES**2)),
            "host_us_per_call": host_us_per_call(torch, bincount_call),
            "device_ms": kernel_device_ms(torch, bincount_call, "bincount_i32_kernel"),
        },
        {
            "name": "segment_sum_f32",
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": REPLACES,
            "launches": main_launches["segment_sum_f32"],
            "max_abs_err": max_err["segment_sum_f32"],
            "ms": time_ms(torch, segment_sum_call),
            "plain_ms": time_ms(torch, lambda: ops.segment_sum_reference(rank_vals, auroc_ids, NUM_CLASSES)),
            "bound_ms": seg_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": time_ms(torch, index_add_call),
            "host_us_per_call": host_us_per_call(torch, segment_sum_call),
            "device_ms": kernel_device_ms(torch, segment_sum_call, "segment_sum_f32_kernel"),
        },
        {
            "name": "qsketch_sort_bucket",
            "route": "cuda",
            "source": QSKETCH_SOURCE,
            "replaces": QSKETCH_REPLACES,
            "shape": list(k3_rows.shape),
            "launches": sketch_launches["qsketch_sort_bucket"],
            "max_abs_err": float((k3_got[0] - k3_plain[0]).abs().max()),
            "ms": time_ms(torch, qsketch_call),
            "plain_ms": time_ms(torch, lambda: ops.qsketch_sort_bucket_reference(k3_rows, SKETCH_CAPACITY)),
            "bound_ms": k3_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": time_ms(torch, lambda: torch.sort(k3_keys, stable=True)),
            "host_us_per_call": host_us_per_call(torch, qsketch_call),
            "device_ms": kernel_device_ms(
                torch, qsketch_call, ("sort_runs_kernel", "scan_bucket_kernel", "gather_rows_kernel")
            ),
        },
    ]
    k5_b1, k5_b2 = (iou_boxes(torch, gen, n).cuda() for n in K5_LINE_SHAPE)
    u, d, g = K6_LINE_SHAPE
    k6_b1 = iou_boxes(torch, gen, u * d).reshape(u, d, 4).cuda()
    k6_b2 = iou_boxes(torch, gen, u * g).reshape(u, g, 4).cuda()
    iou_note = "no single PyTorch call computes box IoU: torchvision is absent, and the plain broadcast is not a library kernel"
    for name, replaces, launches, b1, b2, read_boxes, outputs in (
        ("box_iou_pairwise", K5_REPLACES, pairwise_launches, k5_b1, k5_b2, sum(K5_LINE_SHAPE), int(np.prod(K5_LINE_SHAPE))),
        ("box_iou_batched", K6_REPLACES, map_launches["box_iou_batched"], k6_b1, k6_b2, u * (d + g), u * d * g),
    ):
        fn = getattr(ops, name)
        got, plain = fn(b1, b2), ops.box_iou_reference(b1, b2)
        check(torch.equal(got.view(torch.int32), plain.view(torch.int32)), f"{name} at its line shape differs from the plain version")
        kernels.append(
            {
                "name": name,
                "route": "cuda",
                "source": BOX_IOU_SOURCE,
                "replaces": replaces,
                "shape": [list(b1.shape), list(b2.shape)],
                "launches": launches,
                "max_abs_err": float((got - plain).abs().max()),
                "ms": time_ms(torch, lambda: fn(b1, b2)),
                "plain_ms": time_ms(torch, lambda: ops.box_iou_reference(b1, b2), launches=20),
                # boxes read once (16 bytes each), IoUs written once
                "bound_ms": (read_boxes * 16 + outputs * 4) / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes",
                "library_ms": None,
                "library_note": iou_note,
                "host_us_per_call": host_us_per_call(torch, lambda: fn(b1, b2)),
                "device_ms": kernel_device_ms(torch, lambda: fn(b1, b2), "box_iou_kernel"),
            }
        )
    emit({"phase": "kernel_times", "card": card})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit(
        {
            "ok": True,
            "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
        }
    )
    return 0


def write_profile(torch, confmat, preds_all, target_all, auroc_fn, step_s):
    """Device time by kernel over three flagship steps (torch.profiler), and
    the device's idle share of the unprofiled step time ``step_s``."""
    from torch.profiler import ProfilerActivity, profile

    steps = 3
    state = confmat.init_state()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            state = confmat.update_state(state, preds_all[i], target_all[i])
            auroc_fn(preds_all[i], target_all[i], NUM_CLASSES, average="macro")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()
    # device rows (kernels, memsets, copies) have no CPU time of their own
    device_us = sum(_self_device_us(evt) for evt in averages if evt.self_cpu_time_total == 0)
    print(averages.table(sort_by="cuda_time_total", row_limit=25), file=sys.stderr, flush=True)
    emit(
        {
            "phase": "profile",
            "steps": steps,
            "profiled_wall_ms_per_step": wall_us / steps / 1e3,
            "device_busy_ms_per_step": device_us / steps / 1e3,
            "device_idle_share": 1 - device_us / steps / 1e6 / step_s,
        }
    )


if __name__ == "__main__":
    sys.exit(main())
