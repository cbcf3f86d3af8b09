#!/usr/bin/env python
"""Count the kernel launches that torch.profiler records in short windows on
one CUDA card.

Run from the root of a checkout, with one card:

    python3 scripts/profiler_windows.py [--rounds 6] [--windows 10] [--out FILE]

chip_smoke.py reads a kernel's device time from profiler windows that hold
only the measured calls and a synchronise. A window of that kind sometimes
records none of its launches. This script takes many windows of two calls
at chip_smoke's shapes: ``bincount_i32`` of [4096] ids into 10**6 bins (50
calls of about 1 us each) and ``segment_sum_f32`` of [4096000, 2] rows into
100,000 segments (5 calls of about 6.5 ms each), in rounds that alternate
the two calls. Each window is taken three ways: ``bare`` (CUDA activity,
the calls and a synchronise), ``margin`` (the same with a host pause of
``--margin-ms`` after the window opens and before it closes) and ``cpu``
(CPU and CUDA activity). Per call and variant it prints the windows, those
whose ``key_averages()`` held no launch, those that held some but not all,
the launches seen out of those made and the launches in the raw
``events()`` list; then every window that held none, by round, call,
variant and place in its round. Exits non-zero without CUDA.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

VARIANTS = ("bare", "margin", "cpu")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    )
    return out.stdout.strip().splitlines()[0]


def window(torch, fn, launches, variant, margin_s, name):
    """``(seen, raw)``: the launches of kernels whose name holds ``name`` in
    one window's ``key_averages()`` and in its raw ``events()``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if variant == "cpu" else [])
    pause = margin_s if variant == "margin" else 0.0
    with profile(activities=activities) as prof:
        time.sleep(pause)
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
        time.sleep(pause)
    seen = sum(evt.count for evt in prof.key_averages() if name in evt.key)
    raw = sum(1 for evt in prof.events() if name in evt.name and evt.device_type == torch.autograd.DeviceType.CUDA)
    return seen, raw


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=6)
    parser.add_argument("--windows", type=int, default=10)
    parser.add_argument("--margin-ms", type=float, default=20.0)
    parser.add_argument("--out")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profiler_windows: CUDA is not available; this script needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from metrics_tpu_torch import ops

    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 10**6, 4096)).cuda()
    rows_ids = torch.from_numpy(rng.integers(-1, 100_000, 4_096_000)).cuda()
    rows = torch.from_numpy(rng.integers(0, 2, (4_096_000, 2)).astype(np.float32)).cuda()
    calls = {
        "bincount_i32": (lambda: ops.bincount_i32(ids, 10**6), 50, "bincount_i32_kernel"),
        "segment_sum_f32": (lambda: ops.segment_sum_f32(rows, rows_ids, 100_000), 5, "segment_sum_f32_kernel"),
    }
    for fn, _, _ in calls.values():
        fn()
    torch.cuda.synchronize()

    tally = {
        (call, variant): {"windows": 0, "none_seen": 0, "partial": 0, "seen": 0, "raw": 0, "made": 0}
        for call in calls
        for variant in VARIANTS
    }
    misses = []
    t0 = time.perf_counter()
    for r in range(args.rounds):
        for call, (fn, launches, name) in calls.items():
            for i in range(args.windows):
                for variant in VARIANTS:
                    seen, raw = window(torch, fn, launches, variant, args.margin_ms / 1e3, name)
                    t = tally[(call, variant)]
                    t["windows"] += 1
                    t["none_seen"] += seen == 0
                    t["partial"] += 0 < seen < launches
                    t["seen"] += seen
                    t["raw"] += raw
                    t["made"] += launches
                    if seen == 0:
                        misses.append(
                            {"round": r, "call": call, "variant": variant, "window": i, "raw": raw, "seconds": time.perf_counter() - t0}
                        )
    result = {
        "card": card_line(),
        "margin_ms": args.margin_ms,
        "tally": [{"call": call, "variant": variant, **t} for (call, variant), t in tally.items()],
        "misses": misses,
        "seconds": time.perf_counter() - t0,
    }
    for line in result["tally"] + misses:
        print(json.dumps(line))
    print(json.dumps({"seconds": result["seconds"]}))
    print(result["card"])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
