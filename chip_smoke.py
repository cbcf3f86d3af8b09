"""Drive the PyTorch/CUDA port (metrics_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, with one CUDA card:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. build   -- compile csrc/segment_sum.cu with nvcc (seconds, ptxas report);
2. parity  -- each kernel against its plain PyTorch version on the same card
   tensors: bincount_i32 at the ConfusionMatrix shape (4096 ids, 10**6
   bins) plus negative and out-of-range ids, bit-exact; segment_sum_f32 at
   [4096,2]->1000 (the rank-AUROC sums), [4096,1]->10**6, [32768,16]->2052
   and [4096,130]->1000, bit-exact on integer-valued data and within the
   float32 summation bound otherwise, bit-identical to the plain version run
   on the CPU (both add each output in row order), and bit-identical across
   two runs;
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
5. the kernels line: per kernel its launches on the main path, its error
   against the plain version, and its time, the plain version's time, the
   library call's time and the byte bound, all at the main path's shapes.

Then the card's name and power limit as nvidia-smi reports them, and last
``{"ok": true, "device": {"platform": "gpu", ...}}``. Any failed check
raises, so the script exits non-zero and prints no result line; it does the
same without CUDA, or without the metrics_tpu_torch package beside it.
"""
import json
import subprocess
import sys
import time

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
TIMING_LAUNCHES = 200


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


def kernel_device_ms(torch, fn, kernel_name, launches=50):
    """Device time of one launch of the kernel named ``kernel_name`` alone,
    from torch.profiler; the wrappers' host work and the output zeroing are
    not in it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    rows = [evt for evt in prof.key_averages() if kernel_name in evt.key]
    # the profiler may miss an event at the edge of its window: average over
    # the launches it saw
    count = sum(evt.count for evt in rows)
    check(count > 0, f"the profiler saw no launch of {kernel_name}")
    return sum(_self_device_us(evt) for evt in rows) / count / 1e3


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


def check(cond, what):
    if not cond:
        raise AssertionError(what)


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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a CUDA card", file=sys.stderr)
        return 2
    card = card_line()

    from metrics_tpu_torch import AUROC, ConfusionMatrix, MetricCollection
    from metrics_tpu_torch import ops
    from metrics_tpu_torch.functional import auroc_rank_multiclass
    from metrics_tpu_torch.ops.build import build
    from metrics_tpu_torch.ops.segment_sum import SOURCE, load_library

    device = torch.device("cuda")
    torch.manual_seed(0)

    # 1. build
    path, build_s, log = build(SOURCE)
    load_library()
    ptxas = [line.strip() for line in log.splitlines() if "Used" in line]
    emit({"phase": "build", "library": path.name, "seconds": build_s, "ptxas": ptxas})

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

    # 5. kernel times at the main path's shapes (these launches are not
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
    ]
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
