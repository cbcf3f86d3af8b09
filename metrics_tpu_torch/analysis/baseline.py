"""tracelint baseline: checked-in grandfathered violations.

Entries are keyed on ``(rule, path, snippet)`` -- the stripped source line,
not the line number -- so edits elsewhere in a file never invalidate the
baseline, while any change to the offending line itself (including a fix)
surfaces immediately. Duplicate identical lines are handled by count.
"""
from __future__ import annotations

import json
import pathlib
from collections import Counter
from typing import Dict, Iterable, List, Tuple

from .engine import Violation

BASELINE_VERSION = 1

BaselineKey = Tuple[str, str, str]


def load_baseline(path: pathlib.Path) -> Counter:
    """Load a baseline file into a ``Counter[(rule, path, snippet)]``.

    A missing file is an empty baseline (fresh checkouts lint strictly).
    """
    path = pathlib.Path(path)
    if not path.exists():
        return Counter()
    data = json.loads(path.read_text())
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path} has version {data.get('version')!r}; this tracelint "
            f"reads version {BASELINE_VERSION} -- regenerate with --baseline-update"
        )
    counts: Counter = Counter()
    for entry in data.get("entries", []):
        key = (entry["rule"], entry["path"], entry["snippet"])
        counts[key] += int(entry.get("count", 1))
    return counts


def save_baseline(path: pathlib.Path, violations: Iterable[Violation], notes: Dict[BaselineKey, str] = None) -> None:
    """Write the baseline for ``violations`` (sorted, deterministic)."""
    counts: Counter = Counter(v.key() for v in violations)
    lines: Dict[BaselineKey, int] = {}
    for v in violations:
        lines.setdefault(v.key(), v.line)
    entries = []
    for key in sorted(counts):
        rule, vpath, snippet = key
        entry = {
            "rule": rule,
            "path": vpath,
            "snippet": snippet,
            "count": counts[key],
            # informational only (never matched): where the entry was last seen
            "last_seen_line": lines[key],
        }
        if notes and key in notes:
            entry["note"] = notes[key]
        entries.append(entry)
    payload = {"version": BASELINE_VERSION, "tool": "tracelint", "entries": entries}
    pathlib.Path(path).write_text(json.dumps(payload, indent=2) + "\n")


def split_by_baseline(
    violations: Iterable[Violation], baseline: Counter
) -> Tuple[List[Violation], List[Violation], Counter]:
    """Partition into (new, baselined, stale-baseline-remainder)."""
    remaining = Counter(baseline)
    new: List[Violation] = []
    grandfathered: List[Violation] = []
    for v in violations:
        key = v.key()
        if remaining.get(key, 0) > 0:
            remaining[key] -= 1
            grandfathered.append(v)
        else:
            new.append(v)
    stale = Counter({k: n for k, n in remaining.items() if n > 0})
    return new, grandfathered, stale
