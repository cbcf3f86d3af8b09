#!/usr/bin/env python
"""Host time of the segment kernels' wrappers and of three host-bound eager
loops, for the metrics_tpu_torch package of one tree, on one CUDA card.

Run from the root of a checkout, with one card:

    python3 scripts/bench_wrapper_overhead.py [--root TREE] [--label NAME]

``--root`` is the directory that holds the ``metrics_tpu_torch`` package
(default: this checkout), so two trees (a parent commit unpacked with
``git archive`` and a change) can be measured on one card in turns. It
prints one JSON object:

* ``host_us_per_call``: host time to launch one call of ``bincount_i32`` ([4096]
  ids, 10**6 bins), ``segment_sum_f32`` ([4096, 2] -> 1000),
  ``segment_sum_i32`` and ``segment_max_f32`` ([256] -> 1000), median of
  three windows of 2000 calls with no synchronisation inside;
* ``classification_ms_per_update``: bench_fused's eight metrics over its
  1900/2000/2048-row batches (30 eager updates, median of five runs);
* ``sketch_ms_per_update``: ``AUROC()`` over 8192-row batches (200 updates
  past its capacity, each compacting through K3 and K1; median of three);
* ``sliced_psnr_ms_per_update``: ``SlicedMetric(PeakSignalNoiseRatio(),
  1000)`` over 256 images of 3 x 64 x 64 (30 updates, median of five).

Exits non-zero without CUDA.
"""
import argparse
import json
import os
import statistics
import sys
import time


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=".", help="the tree whose metrics_tpu_torch is measured")
    parser.add_argument("--label", default="tree")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_wrapper_overhead: CUDA is not available", file=sys.stderr)
        return 2
    import metrics_tpu_torch as tm
    from metrics_tpu_torch import ops
    from metrics_tpu_torch.ops.build import build

    if not tm.__file__.startswith(root):
        raise RuntimeError(f"imported {tm.__file__}, not the package under {root}")
    for src in ("segment_sum.cu", "segment_extremum.cu", "qsketch.cu"):
        build(src)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def host_us(fn, calls=2000):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        return out

    ids = torch.randint(0, 1000, (4096,), device=dev, generator=gen)
    vals2 = torch.rand(4096, 2, device=dev, generator=gen)
    ids256 = torch.randint(0, 1000, (256,), device=dev, generator=gen)
    vals256 = torch.rand(256, device=dev, generator=gen)
    ones256 = torch.ones(256, dtype=torch.int32, device=dev)
    calls = {
        "bincount_i32": lambda: ops.bincount_i32(ids, 10**6),
        "segment_sum_f32": lambda: ops.segment_sum_f32(vals2, ids, 1000),
        "segment_sum_i32": lambda: ops.segment_sum_i32(ones256, ids256, 1000),
        "segment_max_f32": lambda: ops.segment_max_f32(vals256, ids256, 1000),
    }
    out = {"label": args.label, "host_us_per_call": {k: statistics.median(host_us(f) for _ in range(3)) for k, f in calls.items()}}

    rng = np.random.RandomState(7)
    batches = []
    for n in (1900, 2000, 2048):
        p = rng.rand(n, 10).astype(np.float32)
        p /= p.sum(-1, keepdims=True)
        batches.append((torch.from_numpy(p).to(dev), torch.from_numpy(rng.randint(0, 10, n)).to(dev)))

    def classification_ms():
        c = 10
        col = tm.MetricCollection(
            [tm.Accuracy(), tm.Precision(num_classes=c, average="macro"), tm.Recall(num_classes=c, average="macro"),
             tm.F1Score(num_classes=c, average="macro"), tm.ConfusionMatrix(num_classes=c), tm.CohenKappa(num_classes=c),
             tm.MatthewsCorrCoef(num_classes=c), tm.JaccardIndex(num_classes=c)]
        )
        col.update(*batches[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(30):
            col.update(*batches[i % 3])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 30 * 1e3

    scores = [torch.rand(8192, device=dev, generator=gen) for _ in range(8)]
    labels = [torch.randint(0, 2, (8192,), device=dev, generator=gen) for _ in range(8)]

    def sketch_ms():
        m = tm.AUROC()
        for i in range(3):
            m.update(scores[i], labels[i])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(200):
            m.update(scores[i % 8], labels[i % 8])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 200 * 1e3

    img = torch.rand(256, 3, 64, 64, device=dev, generator=gen)

    def sliced_ms():
        m = tm.SlicedMetric(tm.PeakSignalNoiseRatio(), 1000)
        m.update(ids256, img, img * 0.9)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(30):
            m.update(ids256, img, img * 0.9)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 30 * 1e3

    out["classification_ms_per_update"] = statistics.median(classification_ms() for _ in range(5))
    out["sketch_ms_per_update"] = statistics.median(sketch_ms() for _ in range(3))
    out["sliced_psnr_ms_per_update"] = statistics.median(sliced_ms() for _ in range(5))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
