"""Readings that set a cell's limits: the program's numbers over many seeds
and the control's over a few, in one process.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 ... --control-seeds 1 2 3 --seconds 2

For each of ``--seeds`` the cell runs as the benchmark runs it (a short
window at its own load) and its compared numbers are read: the largest over
those seeds is each number's lower reading. For each of ``--control-seeds``
the reference is put in the program's place one precision down (the
configuration's ``control``) and compared with the reference at the cell's
own size: the smallest over those seeds is each number's upper reading.
Prints one JSON object with every reading.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def control_numbers(cell, seed, device):
    """The control's numbers over each prediction set of one seed."""
    sets = cell.code.make_sets(cell.config, seed, int(cell.traffic["prediction_sets"]), device, 0, 1)
    rows = []
    for data in sets:
        expected = cell.code.reference(cell.config, data)
        out = cell.code.control(cell.config, data)
        rows.append(cell.code.compare(cell.config, out["values"], out["snapshot"], expected))
    return {name: max(r[name] for r in rows) for name in rows[0]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if str(HERE) in sys.path:
        sys.path.remove(str(HERE))
    sys.path.insert(0, str(REPO))
    import torch

    from portbench import harness

    program = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        result = harness.run_cell(args.workload, seed, args.seconds, False, args.device, root=REPO)
        program[seed] = {k: v["value"] for k, v in result["checks"].items()}
        print(f"program seed {seed}: {program[seed]} correct={result['correct']} ({time.perf_counter() - t0:.1f} s)", file=sys.stderr, flush=True)
    cell = harness.Cell(harness.load_benchmark(REPO), args.workload, REPO)
    device = torch.device(args.device)
    control = {}
    for seed in args.control_seeds:
        control[seed] = control_numbers(cell, seed, device)
        print(f"control seed {seed}: {control[seed]}", file=sys.stderr, flush=True)
    names = sorted(cell.config["limits"])
    summary = {
        name: {
            "lower": max((p[name] for p in program.values()), default=None),
            "upper": min((c[name] for c in control.values()), default=None),
            "limit": cell.config["limits"][name],
        }
        for name in names
    }
    print(json.dumps({"workload": args.workload, "program": program, "control": control, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
