"""Spread of each metric over runs of one cell, as the bounds are set.

    python3 portbench/spread.py results.jsonl [more.jsonl ...]

Each file holds result lines (the last line of ``run.py``'s output), one
set of runs per file. For each metric: the median, and the spread (the
distance between the first and third quartiles of
``statistics.quantiles(values, n=4)``, over the median) of each set.
"""
import json
import statistics
import sys


def spread(values):
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else 0.0


def main(paths):
    for path in paths:
        with open(path) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        names = sorted({k for r in rows for k in r["metrics"]})
        print(f"{path}: {len(rows)} runs, correct {sum(r['correct'] for r in rows)}")
        for name in names:
            values = [r["metrics"][name]["value"] for r in rows if name in r["metrics"]]
            line = f"  {name}: median {statistics.median(values)!r}"
            if len(values) >= 2:
                line += f", spread {spread(values)!r}"
            print(line)


if __name__ == "__main__":
    main(sys.argv[1:])
