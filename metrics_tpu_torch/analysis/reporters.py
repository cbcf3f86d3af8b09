"""tracelint reporters: human text, machine JSON, GitHub annotations (the
JAX package's, over the port's paths).

The JSON schema is stable (version-tagged) so CI annotators and editors can
consume it:

```json
{
  "version": 2,
  "tool": "tracelint",
  "violations": [
    {"rule": "TL-TRACE", "path": "a.py", "file": "metrics_tpu_torch/a.py",
     "line": 3, "col": 4, "message": "...", "snippet": "...",
     "baselined": false}
  ],
  "summary": {"files": 10, "new": 1, "baselined": 0, "suppressed": 0,
              "stale_baseline_entries": 0,
              "rules": ["TL-COLLECTIVE", "..."],
              "by_rule": {"TL-TRACE": 1}}
}
```

Schema history:

- **v2** -- every violation gains ``file``, the REPO-relative path
  (``metrics_tpu_torch/<path>``) matching what ``--format=github`` annotates and
  what CI diff views key on; ``path`` stays the package-relative form the
  baseline and pragma machinery use. No fields were removed, so v1
  consumers that ignore unknown keys keep working; consumers that pin
  ``version == 1`` must accept 2.
- **v1** -- initial schema.

``by_rule`` counts NEW violations per rule id (omitting zero-count rules),
so CI annotators can tell WHICH invariant regressed without walking the
violation list.

``render_github`` emits GitHub Actions workflow commands (``::error
file=...,line=...,col=...``) so lint failures land inline on the PR diff;
baselined violations surface as ``::warning`` (visible but non-blocking,
matching their exit-status semantics).
"""
from __future__ import annotations

import json
from collections import Counter
from typing import List, Sequence

from .engine import PACKAGE_NAME, Violation

JSON_SCHEMA_VERSION = 2


def _repo_relative(path: str) -> str:
    """Violation paths are package-relative; CI annotations and the v2
    ``file`` field need the repo-relative form."""
    return f"{PACKAGE_NAME}/{path}"


def render_text(
    new: Sequence[Violation],
    baselined: Sequence[Violation] = (),
    suppressed_count: int = 0,
    n_files: int = 0,
    stale_count: int = 0,
) -> str:
    """Human report: new violations with fix hints, then a summary line."""
    out: List[str] = []
    if new:
        out.append("tracelint: NEW violations (fix, suppress with a justified")
        out.append("`# tracelint: disable=RULE-ID` pragma, or re-baseline):")
        for v in new:
            out.append(f"  {v.render()}")
            if v.snippet:
                out.append(f"      {v.snippet}")
    summary = (
        f"tracelint: {n_files} files, {len(new)} new, {len(baselined)} baselined,"
        f" {suppressed_count} suppressed"
    )
    if new:
        by_rule = Counter(v.rule for v in new)
        summary += " (" + ", ".join(f"{r}: {n}" for r, n in sorted(by_rule.items())) + ")"
    if stale_count:
        summary += f", {stale_count} stale baseline entr{'y' if stale_count == 1 else 'ies'} (run --baseline-update)"
    out.append(summary)
    return "\n".join(out) + "\n"


def render_json(
    new: Sequence[Violation],
    baselined: Sequence[Violation] = (),
    suppressed_count: int = 0,
    n_files: int = 0,
    rules: Sequence[str] = (),
    stale_count: int = 0,
) -> str:
    payload = {
        "version": JSON_SCHEMA_VERSION,
        "tool": "tracelint",
        "violations": [
            {**v.to_dict(), "file": _repo_relative(v.path), "baselined": False}
            for v in new
        ] + [
            {**v.to_dict(), "file": _repo_relative(v.path), "baselined": True}
            for v in baselined
        ],
        "summary": {
            "files": n_files,
            "new": len(new),
            "baselined": len(baselined),
            "suppressed": suppressed_count,
            "stale_baseline_entries": stale_count,
            "rules": sorted(rules),
            "by_rule": dict(sorted(Counter(v.rule for v in new).items())),
        },
    }
    return json.dumps(payload, indent=2) + "\n"


def _gh_escape(value: str, *, property_value: bool = False) -> str:
    """GitHub workflow-command escaping: ``%``/newlines always; ``:`` and
    ``,`` additionally inside property values (file=..., title=...)."""
    out = value.replace("%", "%25").replace("\r", "%0D").replace("\n", "%0A")
    if property_value:
        out = out.replace(":", "%3A").replace(",", "%2C")
    return out


def render_github(
    new: Sequence[Violation],
    baselined: Sequence[Violation] = (),
) -> str:
    """GitHub Actions annotation report: one ``::error`` workflow command
    per new violation (``::warning`` per baselined one), each anchored to
    the repo-relative file/line/col so it lands inline on the PR diff."""
    out: List[str] = []
    for level, violations in (("error", new), ("warning", baselined)):
        for v in violations:
            props = (
                f"file={_gh_escape(_repo_relative(v.path), property_value=True)},"
                f"line={v.line},col={v.col},"
                f"title={_gh_escape('tracelint ' + v.rule, property_value=True)}"
            )
            out.append(f"::{level} {props}::{_gh_escape(v.message)}")
    return "\n".join(out) + "\n" if out else ""
