#!/usr/bin/env python
"""Time the row-order segment kernels of a metrics_tpu_torch tree on one
CUDA card: segment_sum_f32, segment_sum_i32, segment_max_f32 and
segment_min_f32 at the shapes their main paths give them, skewed ones
included.

Run from the root of a checkout, with one card:

    python3 scripts/bench_segment_fold.py [--root TREE] [--label NAME] [--out FILE]

``--root`` is the directory that holds the ``metrics_tpu_torch`` package to
time (default: this checkout), so two trees (a parent commit unpacked with
``git archive`` and a change) can be timed on one card in turns. Each shape
is made on the host from a fixed seed, checked bit for bit against the
plain version on the CPU, and timed:

* ``ms``: CUDA-event time per call over back-to-back calls (host issue
  included when it is longer than the kernel);
* ``device_ms``: the kernels alone per call (torch.profiler, every kernel
  whose name starts with the wrapper's, so a fold and its combine add up);
* ``host_us_per_call``: the wrapper's issue time, no synchronisation;
* ``library_ms``: one ``index_add_`` (sums) or ``scatter_reduce_`` (max/min)
  on the same inputs, ids mapped past S beforehand;
* ``bound_ms``: values and ids read once and the output written once over
  3.35 TB/s.

Prints one JSON object per shape, then the card's name and power limit,
and writes the list to ``--out`` when given. Exits non-zero without CUDA.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12
CALLS = 50


def sketch_ids(rng, rows=16384, real=12292, segments=4100, pad_bucket=4097):
    """A sketch compaction's buckets: the rows sorted by key, so the real
    rows' buckets rise through [0, pad_bucket) and every pad row (weight 0,
    keyed +inf) lands in ``pad_bucket``."""
    ids = np.full(rows, pad_bucket, np.int64)
    ids[:real] = np.sort(rng.integers(0, pad_bucket, real))
    return ids, segments


def retrieval_ids(rng, rows=2048, segments=8192):
    """An insert chunk's table rows: each query's documents in a run of
    40-199 rows on one row, some rows dropped (id == S)."""
    ids = np.empty(rows, np.int64)
    at = 0
    while at < rows:
        n = int(rng.integers(40, 200))
        ids[at : at + n] = rng.integers(0, segments)
        at += n
    ids[rng.random(rows) < 0.05] = segments
    return ids, segments


def skewed_ids(rng, rows, segments, share):
    """``share`` of the rows in segment 0, the rest uniform."""
    ids = rng.integers(0, segments, rows)
    ids[rng.random(rows) < share] = 0
    return ids, segments


def cases(rng):
    """(name, wrapper, values, ids, S) at the main paths' shapes."""
    out = []

    def floats(b, d):
        return rng.standard_normal((b, d) if d > 1 else b).astype(np.float32)

    ids, s = sketch_ids(rng)
    out.append(("sketch [16384,3]->4100", "segment_sum_f32", floats(16384, 3), ids, s))
    ids, s = retrieval_ids(rng)
    out.append(("retrieval [2048]->8192", "segment_sum_f32", (rng.random(2048) < 0.5).astype(np.float32), ids, s))
    out.append(("rank sums [4096,2]->1000", "segment_sum_f32", floats(4096, 2), rng.integers(0, 1000, 4096), 1000))
    ids, s = skewed_ids(rng, 65536, 4100, 0.9)
    out.append(("90% one segment [65536,3]->4100", "segment_sum_f32", floats(65536, 3), ids, s))
    out.append(("[1048576]->64", "segment_sum_f32", floats(1 << 20, 1), rng.integers(0, 64, 1 << 20), 64))
    ids, s = sketch_ids(rng)
    out.append(("multiclass sketch [16384,2002]->4100", "segment_sum_f32", floats(16384, 2002), ids, s))
    for b, d, s in ((32768, 16, 2052), (4096, 130, 1000), (4096, 1, 1_000_000)):
        out.append((f"[{b},{d}]->{s}", "segment_sum_f32", floats(b, d), rng.integers(-3, s + 3, b), s))
    ints = rng.integers(-(2**31), 2**31 - 1, 256).astype(np.int32)
    out.append(("sliced [256]->1000", "segment_sum_i32", ints, rng.integers(0, 1000, 256), 1000))
    ints = rng.integers(-(2**31), 2**31 - 1, 1 << 20).astype(np.int32)
    out.append(("[1048576]->64", "segment_sum_i32", ints, rng.integers(0, 64, 1 << 20), 64))
    for name, b, d, s in (
        ("sliced [256]->1000", 256, 1, 1000),
        ("[4096]->1000", 4096, 1, 1000),
        ("[4096]->100000", 4096, 1, 100_000),
        ("[8192,256]->128", 8192, 256, 128),
        ("[4096,1000]->64", 4096, 1000, 64),
        ("[1048576]->64", 1 << 20, 1, 64),
        ("all rows one segment [1048576]->64", 1 << 20, 1, 64),
    ):
        ids = np.zeros(b, np.int64) if "one segment" in name else rng.integers(0, s, b)
        out.append((name, "segment_max_f32", floats(b, d), ids, s))
    out.append(("[1048576]->64", "segment_min_f32", floats(1 << 20, 1), rng.integers(0, 64, 1 << 20), 64))
    return out


def time_ms(torch, fn, calls=CALLS):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def device_ms(torch, fn, prefix, calls=CALLS):
    """Device time per call of the kernels named ``<prefix>_*``. A profiling
    window now and then records no kernel at all: such a window is taken
    again, at most three times in all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total, kernels = 0.0, {}
        for evt in prof.key_averages():
            if f"{prefix}_" in evt.key:
                us = getattr(evt, "self_device_time_total", None) or evt.self_cuda_time_total
                kernels[evt.key[:60]] = evt.count
                total += us / evt.count / 1e3
        if kernels:
            return total, kernels
    raise RuntimeError(f"the profiler saw no kernel named {prefix}_* in three windows")


def host_us(torch, fn, calls=200):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def library_fn(torch, wrapper, vals, ids, s):
    rows = vals.reshape(vals.shape[0], -1)
    index = torch.where((ids >= 0) & (ids < s), ids, s)
    if wrapper.startswith("segment_sum"):
        out = torch.zeros((s + 1,) + tuple(vals.shape[1:]), dtype=vals.dtype, device=vals.device)
        return lambda: out.zero_().index_add_(0, index, vals)
    is_max = wrapper == "segment_max_f32"
    fill = -torch.inf if is_max else torch.inf
    index2 = index.reshape(-1, 1).expand(rows.shape).contiguous()
    out = torch.full((s + 1, rows.shape[1]), fill, device=vals.device)
    mode = "amax" if is_max else "amin"
    return lambda: out.fill_(fill).scatter_reduce_(0, index2, rows, mode, include_self=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--root", default=str(Path(__file__).resolve().parent.parent), help="directory holding the metrics_tpu_torch package to time"
    )
    parser.add_argument("--label", default="tree")
    parser.add_argument("--kernels", default=None, help="comma-separated wrappers to time (default: all)")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("bench_segment_fold: CUDA is not available", file=sys.stderr)
        return 2
    from metrics_tpu_torch import ops

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(6)
    rows = []
    wanted = set(args.kernels.split(",")) if args.kernels else None
    for name, wrapper, vals_np, ids_np, s in cases(rng):
        if wanted is not None and wrapper not in wanted:
            continue
        vals, ids = torch.from_numpy(vals_np).cuda(), torch.from_numpy(ids_np).cuda()
        kernel = getattr(ops, wrapper)
        if wrapper.startswith("segment_sum"):
            plain = ops.segment_sum_reference(vals.cpu(), ids.cpu(), s)
        else:
            plain = ops.segment_extremum_reference(vals.cpu(), ids.cpu(), s, wrapper == "segment_max_f32")
        got = kernel(vals, ids, s)
        again = kernel(vals, ids.to(torch.int32), s)
        torch.cuda.synchronize()
        bits = (lambda t: t.cpu().view(torch.int32)) if got.is_floating_point() else (lambda t: t.cpu())
        equal = torch.equal(bits(got), bits(plain)) and torch.equal(bits(got), bits(again))
        if not equal:
            raise SystemExit(f"{wrapper} {name}: differs from the plain version on the CPU or across id dtypes")
        d = vals.shape[1] if vals.ndim == 2 else 1
        nbytes = vals.numel() * vals.element_size() + ids.numel() * ids.element_size() + s * d * vals.element_size()
        dev, seen = device_ms(torch, lambda: kernel(vals, ids, s), wrapper)
        row = {
            "label": args.label,
            "card": card,
            "kernel": wrapper,
            "case": name,
            "bit_equal": equal,
            "ms": time_ms(torch, lambda: kernel(vals, ids, s)),
            "device_ms": dev,
            "device_kernels": seen,
            "host_us_per_call": host_us(torch, lambda: kernel(vals, ids, s)),
            "library_ms": time_ms(torch, library_fn(torch, wrapper, vals, ids, s)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        }
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
