"""tracelint command line for the port: ``python -m metrics_tpu_torch.analysis
[paths...]``.

Exit status: 0 when every violation is baselined or suppressed, 1 when new
violations exist (or, with ``--check``, when the baseline is stale), 2 on
usage errors. ``--baseline-update`` rewrites the baseline to the current
violation set and always exits 0.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
from typing import List, Optional

from .baseline import load_baseline, save_baseline, split_by_baseline
from .engine import Violation, analyze_paths, default_package_root
from .layout import default_layout_manifest_path
from .manifest import default_manifest_path
from .reporters import render_github, render_json, render_text
from .rules import all_rules, get_rules

#: the committed baseline's file name, beside this module (and the two
#: manifests)
DEFAULT_BASELINE = "tracelint_baseline.json"


def _analysis_dir() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parent


def _baseline_entry_violation(rule: str, path: str, snippet: str) -> Violation:
    """Reconstruct a carry-over Violation from a baseline key (line/col are
    informational only and not part of the key)."""
    return Violation(rule=rule, path=path, line=0, col=0, message="", snippet=snippet)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="tracelint",
        description="Static analyzer for metrics_tpu_torch's capture-safety, state, and recompile invariants.",
    )
    parser.add_argument(
        "paths",
        nargs="*",
        type=pathlib.Path,
        help="files/directories to lint (default: the metrics_tpu_torch package)",
    )
    parser.add_argument(
        "--rules",
        help="comma-separated rule ids to run (default: all)",
    )
    parser.add_argument(
        "--baseline",
        type=pathlib.Path,
        default=None,
        help=f"baseline file (default: metrics_tpu_torch/analysis/{DEFAULT_BASELINE})",
    )
    parser.add_argument(
        "--no-baseline",
        action="store_true",
        help="ignore the baseline: report every violation as new",
    )
    parser.add_argument(
        "--baseline-update",
        action="store_true",
        help="rewrite the baseline to the current violation set and exit 0",
    )
    parser.add_argument(
        "--check",
        action="store_true",
        help="CI mode: additionally fail (exit 1) on stale baseline entries",
    )
    parser.add_argument(
        "--format",
        choices=("text", "json", "github"),
        default=None,
        help="report format: text (default), json (schema v2), or github "
        "(GitHub Actions ::error annotations for inline PR diffs)",
    )
    parser.add_argument(
        "--json",
        action="store_true",
        help="alias for --format=json (kept for script compatibility)",
    )
    parser.add_argument("--list-rules", action="store_true", help="list registered rules and exit")
    parser.add_argument(
        "--manifest",
        action="store_true",
        help="manifest mode: write BOTH committed analyzer manifests -- the "
        "fusibility manifest (per-metric verdicts) and the layout manifest "
        "(per-leaf reducer/shard-axis/reshard recipes) -- always full-package; "
        "with --check, fail instead if either committed file is stale",
    )
    parser.add_argument(
        "--manifest-path",
        type=pathlib.Path,
        default=None,
        help="fusibility manifest file (default: metrics_tpu_torch/analysis/fusibility_manifest.json)",
    )
    parser.add_argument(
        "--layout-manifest-path",
        type=pathlib.Path,
        default=None,
        help="layout manifest file (default: metrics_tpu_torch/analysis/layout_manifest.json)",
    )
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            sys.stdout.write(f"{rule.id}: {rule.description}\n")
        return 0

    if args.manifest:
        return _manifest_mode(args)

    try:
        rules = get_rules(args.rules.split(",")) if args.rules else all_rules()
    except KeyError as err:
        sys.stderr.write(f"tracelint: {err.args[0]}\n")
        return 2

    paths = args.paths or [default_package_root()]
    result = analyze_paths(paths, rules)
    for err in result.parse_errors:
        sys.stderr.write(f"tracelint: parse error: {err}\n")

    analyzed = set(result.relpaths)
    baseline_path = args.baseline or (_analysis_dir() / DEFAULT_BASELINE)
    if args.baseline_update:
        # scope the rewrite to the ANALYZED files: entries for files outside
        # this run's paths are carried over untouched, so a partial-path
        # update can never wipe other files' grandfathered violations
        carried = [
            v
            for (rule, vpath, snippet), count in load_baseline(baseline_path).items()
            for v in [_baseline_entry_violation(rule, vpath, snippet)] * count
            if vpath not in analyzed
        ]
        entries = carried + list(result.violations)
        save_baseline(baseline_path, entries)
        sys.stdout.write(
            f"tracelint: baseline {baseline_path} updated with "
            f"{len(entries)} entr{'y' if len(entries) == 1 else 'ies'}"
            f" ({len(carried)} carried over from outside the analyzed paths)\n"
        )
        return 0

    baseline = load_baseline(baseline_path) if not args.no_baseline else None
    if baseline is not None:
        new, grandfathered, stale = split_by_baseline(result.violations, baseline)
        # staleness is only meaningful for files this run actually looked at
        stale = {k: n for k, n in stale.items() if k[1] in analyzed}
    else:
        new, grandfathered, stale = list(result.violations), [], {}

    stale_count = sum(stale.values()) if stale else 0
    fmt = args.format or ("json" if args.json else "text")
    if fmt == "json":
        sys.stdout.write(
            render_json(
                new,
                grandfathered,
                suppressed_count=len(result.suppressed),
                n_files=result.n_files,
                rules=[r.id for r in rules],
                stale_count=stale_count,
            )
        )
    elif fmt == "github":
        sys.stdout.write(render_github(new, grandfathered))
    else:
        sys.stdout.write(
            render_text(
                new,
                grandfathered,
                suppressed_count=len(result.suppressed),
                n_files=result.n_files,
                stale_count=stale_count,
            )
        )

    if new or result.parse_errors:
        return 1
    if args.check and stale_count:
        return 1
    return 0


def _manifest_mode(args) -> int:
    """``--manifest``: regenerate BOTH committed manifests (fusibility +
    layout) from one interp walk; ``--manifest --check``: CI freshness gate
    (byte-compare each against its committed file -- no torch import)."""
    from .interp import Project
    from .layout import build_layout_manifest, render_layout_manifest
    from .manifest import build_manifest, render_manifest

    project = Project()
    fus_path = args.manifest_path or default_manifest_path()
    lay_path = args.layout_manifest_path or default_layout_manifest_path()
    fus = render_manifest(build_manifest(project))
    lay = render_layout_manifest(build_layout_manifest(project))
    targets = (
        ("fusibility", fus_path, fus, fus.count('"verdict"'), "metrics"),
        ("layout", lay_path, lay, lay.count('"reducer"'), "leaves"),
    )
    if args.check:
        stale = False
        for kind, path, rendered, n, unit in targets:
            committed = path.read_text() if path.is_file() else None
            if committed != rendered:
                stale = True
                sys.stderr.write(
                    f"tracelint: {kind} manifest {path} is "
                    f"{'missing' if committed is None else 'STALE'} -- regenerate with "
                    "`python -m metrics_tpu_torch.analysis --manifest` and commit the result\n"
                )
            else:
                sys.stdout.write(f"tracelint: {kind} manifest {path} is fresh ({n} {unit})\n")
        return 1 if stale else 0
    for kind, path, rendered, n, unit in targets:
        path.write_text(rendered)
        sys.stdout.write(f"tracelint: {kind} manifest written to {path} ({n} {unit})\n")
    return 0
