#!/usr/bin/env python
"""Time the box IoU kernels of a metrics_tpu_torch tree on one CUDA card:
box_iou_pairwise (K5, [N, 4] x [M, 4]) and box_iou_batched (K6,
[U, D, 4] x [U, G, 4], the mAP matcher's shape), at the parity shapes of
``chip_smoke.py``, in float32 and, at the main shapes, float64.

Run from the root of a checkout, with one card:

    python3 scripts/bench_box_iou.py [--root TREE] [--label NAME] [--out FILE]

``--root`` is the directory that holds the ``metrics_tpu_torch`` package to
time (default: this checkout), so two trees (a parent commit unpacked with
``git archive`` and a change) can be timed on one card in turns. Each case
is made on the host from a fixed seed (degenerate, zero-padded and, in the
edge cases, NaN, signed-zero and infinite boxes), checked bit for bit
against the plain version on the CPU and across two runs (``differ``
counts the elements that do not; the script exits 1 after all cases if any
did), and timed:

* ``ms``: CUDA-event time per call over back-to-back calls (host issue
  included when it is longer than the kernel);
* ``device_ms``: the kernel alone per call (torch.profiler);
* ``host_us_per_call``: the wrapper's issue time, no synchronisation;
* ``plain_ms``: the plain version (the broadcast) on the card;
* ``bound_ms``: the boxes read once (16 bytes each, 32 in float64) and the
  IoUs written once over 3.35 TB/s.

No single PyTorch call computes box IoU, so there is no library time.
Prints one JSON object per case, then the card's name and power limit,
and writes the list to ``--out`` when given. Exits non-zero without CUDA.

``--sweep`` times instead the kernel's geometries at the main shapes, in
float32 and float64, through the C launcher of a tree whose launcher takes
``(vec, row_threads, wide)``: every run width the dtype allows and every
walk of 1 to 16 rows, each bit-checked against the plain version on the
card, beside the geometry the wrapper chooses (``device_us`` per call).
"""
import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12
CALLS = 50
#: (kernel, lead dims of boxes1, lead dims of boxes2): K5 [N, M], K6 [U, D, G]
MAIN_SHAPES = (
    ("box_iou_pairwise", (1024,), (1024,)),
    ("box_iou_pairwise", (4096,), (4096,)),
    ("box_iou_pairwise", (1000,), (3000,)),
    ("box_iou_batched", (65536, 8), (65536, 8)),
    ("box_iou_batched", (4096, 128), (4096, 32)),
    ("box_iou_batched", (1024, 128), (1024, 128)),
    ("box_iou_batched", (16384, 64), (16384, 16)),
    ("box_iou_batched", (1000, 100), (1000, 30)),
)
#: widths not a multiple of 4, one-box rows and units
EDGE_SHAPES = (
    ("box_iou_pairwise", (1000,), (3001,)),
    ("box_iou_pairwise", (999,), (3002,)),
    ("box_iou_pairwise", (1001,), (3003,)),
    ("box_iou_pairwise", (1,), (4096,)),
    ("box_iou_pairwise", (4096,), (1,)),
    ("box_iou_batched", (4096, 16), (4096, 5)),
    ("box_iou_batched", (4096, 16), (4096, 7)),
    ("box_iou_batched", (65536, 1), (65536, 8)),
    ("box_iou_batched", (65536, 8), (65536, 1)),
    ("box_iou_batched", (65536, 1), (65536, 1)),
)
EDGE_VALUES = (0.0, -0.0, 1.0, -1.0, 7.5, 1e-40, 3e38, np.inf, -np.inf, np.nan, -np.nan)


def boxes(rng, lead, dtype, edge=False):
    """xyxy boxes of shape ``lead + (4,)``: random ones with zero-width,
    zero-height, inverted and zero-padded rows; with ``edge``, a third of
    the coordinates drawn from NaN, +-0, +-inf, a subnormal and a huge
    value."""
    n = int(np.prod(lead))
    xy = rng.uniform(0, 500, (n, 2))
    out = np.concatenate([xy, xy + rng.uniform(0, 500 / 3, (n, 2))], axis=1)
    if n >= 8:
        out[0] = [10, 10, 10, 30]
        out[1] = [10, 10, 30, 10]
        out[2] = [30, 30, 10, 10]
        out[-2:] = 0
    if edge:
        pick = rng.random((n, 4)) < 1 / 3
        out[pick] = rng.choice(np.array(EDGE_VALUES), int(pick.sum()))
    return out.astype(dtype).reshape(*lead, 4)


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


def device_ms(torch, fn, calls=CALLS):
    """Device time per call of the box IoU kernel, from torch.profiler. A
    window that records no launch of it is taken again, at most three
    times in all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        found = [evt for evt in prof.key_averages() if evt.count > 0 and "box_iou_kernel" in evt.key]
        if found:
            return sum(getattr(evt, "self_device_time_total", 0) / evt.count for evt in found) / 1e3
    raise RuntimeError("the profiler saw no box_iou_kernel launch in three windows")


def host_us(torch, fn, calls=200):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def bits(torch, x):
    x = x.detach().cpu().contiguous()
    return x.view(torch.int64 if x.dtype == torch.float64 else torch.int32)


def sweep(torch, ops, emit):
    """Device µs per call of every (run width, rows walked) at the main shapes."""
    from importlib import import_module

    module = import_module("metrics_tpu_torch.ops.box_iou")
    lib = module.load_library()
    rng = np.random.default_rng(5)
    ok = True
    for kernel, lead1, lead2 in MAIN_SHAPES:
        for dtype in (np.float32, np.float64):
            b1 = torch.from_numpy(boxes(rng, lead1, dtype)).cuda()
            b2 = torch.from_numpy(boxes(rng, lead2, dtype)).cuda()
            units, d, g = (1, lead1[0], lead2[0]) if len(lead1) == 1 else (lead1[0], lead1[1], lead2[1])
            plain = ops.box_iou_reference(b1, b2).reshape(units, d, g)
            fn = lib.box_iou_f64 if dtype == np.float64 else lib.box_iou_f32
            vec, row_threads, _ = module.box_iou_geometry(units, d, g, plain.dtype)
            row = {"kernel": kernel, "shape": [units, d, g], "dtype": np.dtype(dtype).name}
            row["chosen"] = {"vec": vec, "rows": math.ceil(d / row_threads)}
            row["chosen_device_us"] = device_ms(torch, lambda: getattr(ops, kernel)(b1, b2)) * 1e3
            timings = {}
            for v in (4, 2, 1) if dtype == np.float32 else (1,):
                for rows in (1, 2, 4, 8, 16):
                    if g % v or rows > d:
                        continue
                    rt = math.ceil(d / rows)

                    def call(v=v, rt=rt):
                        out = torch.empty_like(plain)
                        stream = torch.cuda.current_stream().cuda_stream
                        code = fn(b1.data_ptr(), b2.data_ptr(), out.data_ptr(), units, d, g, v, rt, 0, stream)
                        if code:
                            raise RuntimeError(f"box IoU launch failed: CUDA error {code}")
                        return out

                    ok &= bool(torch.equal(call(), plain))
                    timings[f"vec{v}_rows{rows}"] = device_ms(torch, call) * 1e3
            row["device_us"] = timings
            emit(row)
    return ok


def cases():
    """(kernel, lead1, lead2, dtype, edge values)."""
    out = [(k, a, b, np.float32, False) for k, a, b in MAIN_SHAPES + EDGE_SHAPES]
    out += [(k, a, b, np.float64, False) for k, a, b in MAIN_SHAPES]
    out += [("box_iou_pairwise", (2048,), (2047,), dt, True) for dt in (np.float32, np.float64)]
    out += [("box_iou_batched", (8192, 8), (8192, 6), dt, True) for dt in (np.float32, np.float64)]
    return out


def time_cases(torch, ops, emit):
    """Each case of :func:`cases` checked and timed; True when every case is bit-equal."""
    rng = np.random.default_rng(8)
    ok = True
    for kernel, lead1, lead2, dtype, edge in cases():
        host1 = torch.from_numpy(boxes(rng, lead1, dtype, edge))
        host2 = torch.from_numpy(boxes(rng, lead2, dtype, edge))
        if kernel == "box_iou_batched" and not edge:
            # each unit's ground truths zero-padded past a random count, as the mAP packing leaves them
            live = np.arange(lead2[1])[None, :] < rng.integers(1, lead2[1] + 1, (lead2[0], 1))
            host2 = host2 * torch.from_numpy(live)[:, :, None]
        b1, b2 = host1.cuda(), host2.cuda()
        fn = getattr(ops, kernel)
        call = lambda: fn(b1, b2)  # noqa: E731
        got, again = call(), call()
        plain_cpu = ops.box_iou_reference(host1, host2)
        torch.cuda.synchronize()
        differ = {}
        vs_plain = int((bits(torch, got) != bits(torch, plain_cpu)).sum())
        vs_again = int((bits(torch, got) != bits(torch, again)).sum())
        if vs_plain or vs_again:
            differ = {"vs_plain_cpu": vs_plain, "vs_second_run": vs_again}
        size = np.dtype(dtype).itemsize
        nbytes = (host1.numel() + host2.numel()) * size + got.numel() * size
        row = {
            "kernel": kernel,
            "case": f"[{','.join(map(str, lead1[:-1] + (lead1[-1], lead2[-1])))}]",
            "dtype": np.dtype(dtype).name,
            "edge_values": edge,
            "bit_equal": not differ,
            "differ": differ,
            "host_us_per_call": host_us(torch, call),
            "ms": time_ms(torch, call),
            "device_ms": device_ms(torch, call),
            "plain_ms": time_ms(torch, lambda: ops.box_iou_reference(b1, b2), calls=10),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        }
        emit(row)
        ok &= row["bit_equal"]
    return ok


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--root", default=str(Path(__file__).resolve().parent.parent), help="directory holding the metrics_tpu_torch package to time"
    )
    parser.add_argument("--label", default="tree")
    parser.add_argument("--out", default=None)
    parser.add_argument("--sweep", action="store_true", help="time every geometry at the main shapes instead")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("bench_box_iou: CUDA is not available", file=sys.stderr)
        return 2
    from metrics_tpu_torch import ops

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    results = []

    def emit(row):
        row = {"label": args.label, "card": card, **row}
        print(json.dumps(row), flush=True)
        results.append(row)

    ok = sweep(torch, ops, emit) if args.sweep else time_cases(torch, ops, emit)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
