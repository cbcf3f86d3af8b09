"""Run one benchmark cell once and print its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``. The run makes
its inputs on the card from ``--seed``, warms up the cell's shapes, measures
evaluation passes for ``--seconds``, checks what they produced against the
plain reference, and prints one JSON object: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics (and the
trace's breakdown). The numbers compared with the reference are printed
beside their limits as the last lines of standard error and under the last
key of the result. Without the cards the cell asks for, it prints no result
and exits with 2.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def _environment() -> None:
    """Caches inside the checkout at fixed paths; no library pulls in JAX;
    one host thread for PyTorch's CPU operations, so that the load is one
    process's and idle worker threads do not compete with the issuing one."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(REPO / "portbench" / ".cache" / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[name] = "1"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _environment()
    if str(HERE) in sys.path:
        sys.path.remove(str(HERE))
    sys.path.insert(0, str(REPO))
    from portbench import harness

    bench = harness.load_benchmark(REPO)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"portbench: no workload {args.workload!r}; known: {sorted(cells)}", file=sys.stderr)
        return 2
    import torch

    torch.set_num_threads(1)
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA device(s), found {found}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t_start=T_START, root=REPO)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; the benchmark measures metrics_tpu_torch alone", file=sys.stderr)
        return 3
    print(f"correct = {result['correct']} over {result['attempted']} passes", file=sys.stderr)
    for name, number in result["checks"].items():
        print(f"check {name} = {number['value']!r} (limit {number['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
