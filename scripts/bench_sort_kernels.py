#!/usr/bin/env python
"""Time the sorting kernels of a metrics_tpu_torch tree on one CUDA card:
qsketch_sort_bucket (K3, the sketch compaction's sort, prefix sum and
bucket map) and row_topk (K4, the retrieval table's per-row top-k), at the
shapes their main paths give them and at the edges of their designs.

Run from the root of a checkout, with one card:

    python3 scripts/bench_sort_kernels.py [--root TREE] [--label NAME] [--out FILE]

``--root`` is the directory that holds the ``metrics_tpu_torch`` package to
time (default: this checkout), so two trees (a parent commit unpacked with
``git archive`` and a change) can be timed on one card in turns. Each case
is made on the host from a fixed seed, checked bit for bit against the
plain version on the CPU and across two runs (``differ`` counts the
elements that do not; the script exits 1 after all cases if any did), and
timed:

* ``ms``: CUDA-event time per call over back-to-back calls (host issue
  included when it is longer than the kernels);
* ``device_ms``: every kernel the call launches, summed, per call
  (torch.profiler; the wrappers launch no other kernel);
* ``host_us_per_call``: the wrapper's issue time, no synchronisation;
* ``library_ms``: ``torch.sort(stable=True)`` of the same keys (K3), or of
  the active rows' keys with the two gathers that carry payload and
  validity (K4);
* ``plain_ms``: the plain version on the card;
* ``bound_ms``: the inputs read once and the outputs written once over
  3.35 TB/s (K4: the active rows' inputs and outputs, and the row mask).

Prints one JSON object per case, then the card's name and power limit,
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
CAPACITY = 8192


def sketch_rows(rng, n, cols, occupied):
    """Rows as a sketch compaction receives them: ``occupied`` rows first
    (centroids of integer weight up to 1600 and unit rows, keys in (0, 1),
    0/1 payload), then zero rows."""
    rows = np.zeros((n, cols), np.float32)
    centroids = occupied // 3
    # integer weights whose sum stays below 2**24, so every prefix sum is exact
    rows[:centroids, 0] = rng.integers(1, min(1600, 2**24 // occupied), centroids)
    rows[centroids:occupied, 0] = 1.0
    rows[:occupied, 1] = rng.random(occupied)
    rows[:occupied, 2:] = rng.integers(0, 2, (occupied, cols - 2))
    return rows


def topk_rows(rng, r, n):
    """Widened retrieval rows: uniform scores (ties from rounding to 1/4096),
    about 70% valid slots, integer payloads."""
    preds = (np.floor(rng.random((r, n)) * 4096) / 4096).astype(np.float32)
    valid = (rng.random((r, n)) < 0.7).astype(np.float32)
    payload = rng.integers(0, 2, (r, n)).astype(np.float32)
    return preds, payload, valid


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
    """Device time per call of every kernel in the window, and each kernel's
    launches and device microseconds per call. A window that records no kernel is taken
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
            us = getattr(evt, "self_device_time_total", 0)
            if us <= 0 or "Memset" in evt.key or "Memcpy" in evt.key:
                continue
            name = evt.key.split("(")[-2].split("::")[-1] if "(" in evt.key else evt.key
            kernels[name] = {"launches_per_call": evt.count / calls, "us_per_call": us / calls}
            total += us / calls / 1e3
        if kernels:
            return total, kernels
    raise RuntimeError("the profiler saw no kernel in three windows")


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
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def differing(torch, names, got, again, plain):
    """The outputs that differ from the plain version on the CPU or across
    two runs, with the count of differing elements."""
    out = {}
    for name, g, a, p in zip(names, got, again, plain):
        vs_plain = int((bits(torch, g) != bits(torch, p)).sum())
        vs_again = int((bits(torch, g) != bits(torch, a)).sum())
        if vs_plain or vs_again:
            out[name] = {"vs_plain_cpu": vs_plain, "vs_second_run": vs_again}
    return out


def k3_cases(rng):
    return [
        ("sketch [16384,3]", sketch_rows(rng, 16384, 3, 12292)),
        ("[1024,3]", sketch_rows(rng, 1024, 3, 1000)),
        ("multiclass [12288,2002]", sketch_rows(rng, 12288, 2002, 12288)),
        ("[131072,3]", sketch_rows(rng, 131072, 3, 100000)),
    ]


def k4_cases(rng):
    """(name, preds, payload, valid, k, active rows or None)."""
    out = []
    for name, r, n, k, active in (
        ("insert [2048,2176] k=64 masked", 2048, 2176, 64, 8),
        ("insert [2048,2176] k=64 all rows", 2048, 2176, 64, None),
        ("merge [4096,256] k=128", 4096, 256, 128, None),
        ("[8192,2048] k=1024", 8192, 2048, 1024, None),
        ("[16,40000] k=10", 16, 40000, 10, None),
        ("[16,40000] k=20000", 16, 40000, 20000, None),
    ):
        preds, payload, valid = topk_rows(rng, r, n)
        mask = None
        if active is not None:
            mask = np.zeros(r, bool)
            mask[rng.permutation(r)[:active]] = True
        out.append((name, preds, payload, valid, k, mask))
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--root", default=str(Path(__file__).resolve().parent.parent), help="directory holding the metrics_tpu_torch package to time"
    )
    parser.add_argument("--label", default="tree")
    parser.add_argument("--kernels", default="k3,k4", help="k3, k4 or both (default)")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("bench_sort_kernels: CUDA is not available", file=sys.stderr)
        return 2
    from metrics_tpu_torch import ops

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(7)
    results = []
    wanted = set(args.kernels.split(","))

    def emit(row):
        row = {"label": args.label, "card": card, **row}
        print(json.dumps(row), flush=True)
        results.append(row)

    for name, rows_np in k3_cases(rng) if "k3" in wanted else ():
        host = torch.from_numpy(rows_np)
        rows = host.cuda()
        call = lambda: ops.qsketch_sort_bucket(rows, CAPACITY)  # noqa: E731
        got, again = call(), call()
        plain_cpu = ops.qsketch_sort_bucket_reference(host, CAPACITY)
        torch.cuda.synchronize()
        differ = differing(torch, ("weighted rows", "bucket ids", "permutation"), got, again, plain_cpu)
        keys = torch.where(rows[:, 0] > 0, rows[:, 1], torch.inf)
        n_pad = got[0].shape[0]
        nbytes = rows.numel() * 4 + n_pad * (rows.shape[1] * 4 + 8)
        issue_us = host_us(torch, call)
        dev, seen = device_ms(torch, call)
        emit(
            {
                "kernel": "qsketch_sort_bucket",
                "case": name,
                "bit_equal": not differ,
                "differ": differ,
                "host_us_per_call": issue_us,
                "ms": time_ms(torch, call),
                "device_ms": dev,
                "device_kernels": seen,
                "plain_ms": time_ms(torch, lambda: ops.qsketch_sort_bucket_reference(rows, CAPACITY), calls=10),
                "library_ms": time_ms(torch, lambda: torch.sort(keys, stable=True)),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            }
        )
    for name, preds_np, payload_np, valid_np, k, mask_np in k4_cases(rng) if "k4" in wanted else ():
        host = [torch.from_numpy(x) for x in (preds_np, payload_np, valid_np)]
        card_in = [x.cuda() for x in host]
        mask_host = None if mask_np is None else torch.from_numpy(mask_np)
        mask = None if mask_host is None else mask_host.cuda()
        call = lambda: ops.row_topk_f32(*card_in, k, rows=mask)  # noqa: E731
        got, again = call(), call()
        plain_cpu = ops.row_topk_reference(*host, k, rows=mask_host)
        torch.cuda.synchronize()
        differ = differing(torch, ("keys", "payload", "valid"), got, again, plain_cpu)
        r, n = preds_np.shape
        active = torch.arange(r, device="cuda") if mask is None else mask.nonzero()[:, 0]
        preds, payload, valid = card_in
        keys = torch.where(valid > 0, preds, -torch.inf)

        def library():
            sel = keys[active]
            order = torch.sort(sel, dim=-1, descending=True, stable=True).indices[:, :k]
            return sel.gather(-1, order), payload[active].gather(-1, order), valid[active].gather(-1, order)

        nbytes = int(active.numel()) * (n + k) * 4 * 3 + (0 if mask is None else r)
        issue_us = host_us(torch, call)
        dev, seen = device_ms(torch, call)
        emit(
            {
                "kernel": "row_topk",
                "case": name,
                "active_rows": int(active.numel()),
                "bit_equal": not differ,
                "differ": differ,
                "host_us_per_call": issue_us,
                "ms": time_ms(torch, call),
                "device_ms": dev,
                "device_kernels": seen,
                "plain_ms": time_ms(torch, lambda: ops.row_topk_reference(*card_in, k, rows=mask), calls=10),
                "library_ms": time_ms(torch, library),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            }
        )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(card, flush=True)
    return 0 if all(row["bit_equal"] for row in results) else 1


if __name__ == "__main__":
    sys.exit(main())
