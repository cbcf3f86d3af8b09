#!/usr/bin/env python
"""Measure, on the CPU, properties of the JAX package that the port does
not copy: its bfloat16 sketch compaction, its float32 Gumbel logs, and its
half-precision arithmetic beside float32 inputs.

Run from the root of a checkout (JAX and the JAX package on the CPU):

    JAX_PLATFORMS=cpu python scripts/reference_properties.py [--batches 2 16 245] [--draws 1048576]

1. ``AUROC()`` over bench.py's bench_sketch stream (RandomState(10),
   batches of 4096 uniform scores, positives at rate 0.35; curve-binary in
   chip_smoke.py), for each prefix of ``--batches``: the JAX package in
   float32 and after ``set_dtype(jnp.bfloat16)`` (it compacts in bfloat16:
   a bfloat16 running sum of the weights), the port in float32 and after
   ``set_dtype(torch.bfloat16)`` (it widens the rows to float32, compacts
   and rounds back once), the exact AUROC (float64 midranks), and each
   sketch's surviving total weight.
2. ``jax.random.gumbel`` against the port's draw
   (``metrics_tpu_torch.utils.prng.gumbel``: each log correctly rounded)
   over ``--draws`` draws of ``fold_in(PRNGKey(0), 0)``: the share of inner
   logs where XLA's float32 ``log`` differs from the correctly rounded one,
   the share of priorities that differ, and the largest difference in ulps
   counted at ``max(|g|, 1)``.
3. Every half-precision gap of ``tests/test_torch_input_dtypes.py``
   (``HALF_GAPS``): on the grid's seeded inputs, the functional's first
   values in both packages and in float64 (the JAX package with x64 on, on
   the same rounded inputs), and each package's largest relative distance
   from float64.

Prints one JSON object per measurement.
"""
import argparse
import importlib.util
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from scipy.stats import rankdata  # noqa: E402

import metrics_tpu  # noqa: E402
import metrics_tpu_torch  # noqa: E402
from metrics_tpu_torch.utils import prng  # noqa: E402


def curve_stream(batches):
    rng = np.random.RandomState(10)
    out = []
    for _ in range(batches):
        scores = rng.rand(4096).astype(np.float32)
        out.append((scores, (rng.rand(4096) < 0.35).astype(np.int32)))
    return out


def exact_auroc(stream):
    s = np.concatenate([b[0] for b in stream]).astype(np.float64)
    y = np.concatenate([b[1] for b in stream])
    ranks = rankdata(s)
    npos = y.sum()
    return float((ranks[y == 1].sum() - npos * (npos + 1) / 2) / (npos * (len(y) - npos)))


def bf16_sketch(batches):
    t0 = time.perf_counter()
    stream = curve_stream(batches)
    jax_f32, jax_bf16 = metrics_tpu.AUROC(), metrics_tpu.AUROC()
    jax_bf16.set_dtype(jnp.bfloat16)
    port_f32, port_bf16 = metrics_tpu_torch.AUROC(device="cpu"), metrics_tpu_torch.AUROC(device="cpu")
    port_bf16.set_dtype(torch.bfloat16)
    for scores, labels in stream:
        for m in (jax_f32, jax_bf16):
            m.update(jnp.asarray(scores), jnp.asarray(labels))
        for m in (port_f32, port_bf16):
            m.update(torch.from_numpy(scores), torch.from_numpy(labels))
    values = {
        "jax_f32": float(jax_f32.compute()),
        "jax_bf16": float(jax_bf16.compute()),
        "port_f32": float(port_f32.compute()),
        "port_bf16": float(port_bf16.compute()),
        "exact": exact_auroc(stream),
    }
    return {
        "measurement": "bf16_sketch_auroc",
        "batches": batches,
        "rows": batches * 4096,
        **values,
        "jax_bf16_minus_f32": values["jax_bf16"] - values["jax_f32"],
        "port_bf16_minus_f32": values["port_bf16"] - values["port_f32"],
        "jax_bf16_total_weight": float(np.asarray(jax_bf16.csketch[:, 0], np.float32).sum()),
        "port_bf16_total_weight": float(port_bf16.csketch[:, 0].float().sum()),
        "seconds": time.perf_counter() - t0,
    }


def gumbel_logs(n):
    key, jax_key = prng.fold_in(prng.prng_key(0), 0), jax.random.fold_in(jax.random.PRNGKey(0), jnp.asarray(0, jnp.int32))
    u = prng.uniform(key, n).numpy()
    want_u = np.asarray(jax.random.uniform(jax_key, (n,), jnp.float32, minval=np.finfo(np.float32).tiny, maxval=1.0))
    xla_inner = np.asarray(jnp.log(jnp.asarray(u)))
    inner = np.log(u.astype(np.float64)).astype(np.float32)
    got = prng.gumbel(key, n).numpy()
    want = np.asarray(jax.random.gumbel(jax_key, (n,), jnp.float32))
    torch_f32 = (-torch.log(-torch.log(torch.from_numpy(u)))).numpy()
    ulp = np.spacing(np.maximum(np.abs(want), np.float32(1))).astype(np.float64)
    return {
        "measurement": "gumbel_logs",
        "draws": n,
        "uniform_bits_equal": bool(np.array_equal(u.view(np.int32), want_u.view(np.int32))),
        "xla_inner_log_differs_share": float(np.mean(xla_inner != inner)),
        "priorities_differ_share": float(np.mean(got != want)),
        "torch_float32_priorities_differ_share": float(np.mean(torch_f32 != want)),
        "max_ulps_at_max_abs_g_1": float((np.abs(got.astype(np.float64) - want) / ulp).max()),
    }


def half_gaps():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "test_torch_input_dtypes.py")
    spec = importlib.util.spec_from_file_location("input_dtype_grid", path)
    grid = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(grid)
    for (name, pd, td), kind in sorted(grid.HALF_GAPS.items()):
        _, input_kind, cls, ckw, fn, fkw = grid.SPECS[name]
        (preds, jax_preds), (target, jax_target) = (grid._both(v, d) for v, d in zip(grid.KINDS[input_kind](pd, td), (pd, td)))
        port = grid._port_functional(fn, fkw, preds, target)
        ref = grid._float64_evaluation("functional", cls, ckw, fn, fkw, preds, target)
        jax_value = getattr(metrics_tpu.functional, fn)(jax_preds, jax_target, **grid._resolve(fkw, metrics_tpu.functional))
        port, jax_value, ref = (grid._float64(grid._leaves(v)[0]).reshape(-1) for v in (port, jax_value, ref))

        def rel(x):
            return float(np.max(np.abs(x - ref) / np.maximum(np.abs(ref), 1e-6)))

        yield {
            "measurement": "half_gap", "case": name, "preds": pd, "target": td, "computed_in_half_by": kind,
            "jax": jax_value[:2].tolist(), "port": port[:2].tolist(), "float64": ref[:2].tolist(),
            "jax_rel_from_float64": rel(jax_value), "port_rel_from_float64": rel(port),
        }


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batches", type=int, nargs="+", default=[2, 16, 245])
    parser.add_argument("--draws", type=int, default=1 << 20)
    args = parser.parse_args()
    for batches in args.batches:
        print(json.dumps(bf16_sketch(batches)), flush=True)
    print(json.dumps(gumbel_logs(args.draws)), flush=True)
    for line in half_gaps():
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
