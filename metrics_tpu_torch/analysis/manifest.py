"""Fusibility manifest: tracelint's static verdicts as a runtime input.

Counterpart of ``metrics_tpu/analysis/manifest.py``.
``python -m metrics_tpu_torch.analysis --manifest`` serializes the abstract
interpreter's per-metric verdicts (``interp.classify``), state-leaf
shape/dtype/reduction abstractions and declared ``__jit_unsafe__`` flags to
``metrics_tpu_torch/analysis/fusibility_manifest.json``. The fused update
(``core/fused.py``) consults it to seed its fusibility cache: a
``fusible``-verdict metric skips the per-(metric, signature) probe -- the
run on a scratch copy of its states under ``_NoHostReads`` and, on the
card, the throwaway trial capture; ``unsafe``/``unknown`` metrics keep the
probe as the authority. Static analysis stops being a linter and becomes
an input to the hot path.

Schema v1 (deterministic serialization -- byte-stable for freshness
checks)::

    {
      "version": 1,
      "tool": "tracelint",
      "metrics": {
        "classification/confusion_matrix.py::ConfusionMatrix": {
          "verdict": "fusible",
          "reason": null,                  # unsafe only: cat-growth |
                                           #   host-sync | data-dependent-shape
          "detail": null,
          "declared_jit_unsafe": null,     # explicit __jit_unsafe__ (null =
                                           #   undeclared, inherits False)
          "states": {
            "confmat": {"container": "array",
                         "shape": ["num_classes", "num_classes"],
                         "dtype": "int32", "dist_reduce_fx": "sum",
                         "sliceable": true}
          }
        }, ...
      }
    }

State shapes are abstract: dims are concrete ints or constructor-parameter
symbols (``"num_classes"``), ``"?"`` for unresolvable dims, ``null`` for an
unknown rank.

Runtime lookups key on the CLASS, derived from ``cls.__module__`` /
``cls.__qualname__``; classes outside ``metrics_tpu_torch`` (user
subclasses, test fixtures) have no entry and keep the probe. Environment
(the port's own, one set per package): ``METRICS_TPU_TORCH_MANIFEST=<path>``
points at another manifest, ``METRICS_TPU_TORCH_NO_MANIFEST=1`` disables
consultation entirely, ``METRICS_TPU_TORCH_VERIFY_MANIFEST=1`` makes the
fused update probe every member anyway and warn where a ``fusible`` verdict
fails its probe.

Stdlib-only, like the rest of the analysis package.
"""
from __future__ import annotations

import json
import os
import pathlib
from typing import Dict, Optional

from .engine import PACKAGE_NAME
from . import interp

MANIFEST_VERSION = 1

#: the committed manifest's file name, beside this module
DEFAULT_MANIFEST = "fusibility_manifest.json"

#: env var naming an alternate manifest file
ENV_MANIFEST_PATH = "METRICS_TPU_TORCH_MANIFEST"
#: env var disabling manifest consultation (runtime probes only)
ENV_NO_MANIFEST = "METRICS_TPU_TORCH_NO_MANIFEST"
#: env var enabling the probe cross-check of manifest verdicts
ENV_VERIFY_MANIFEST = "METRICS_TPU_TORCH_VERIFY_MANIFEST"


# ---------------------------------------------------------------------------
# build (analysis side)
# ---------------------------------------------------------------------------

def build_manifest(project: Optional[interp.Project] = None) -> Dict[str, object]:
    """Classify every metric-like class in the package into a manifest dict.

    Always a FULL-package analysis (partial-path manifests would silently
    drop entries, and freshness checks diff the whole file).
    """
    project = project or interp.Project()
    root = project.root
    metrics: Dict[str, Dict[str, object]] = {}
    for path in sorted(root.rglob("*.py")):
        rel = "/".join(path.relative_to(root).parts)
        if rel.startswith("analysis/"):
            continue  # the analyzer does not classify itself
        ctx = project.ctx(rel)
        if ctx is None:
            continue
        for node in interp.iter_metric_classes(ctx):
            verdict, facts = interp.classify(project, ctx, node)
            if not facts.is_metric:
                continue
            key = f"{rel}::{node.name}"
            metrics[key] = {
                "verdict": verdict.status,
                "reason": verdict.reason,
                "detail": verdict.detail,
                "declared_jit_unsafe": facts.declared,
                "states": {e.name: e.to_dict() for e in facts.entries},
            }
    return {
        "version": MANIFEST_VERSION,
        "tool": "tracelint",
        "metrics": {k: metrics[k] for k in sorted(metrics)},
    }


def render_manifest(manifest: Dict[str, object]) -> str:
    """Deterministic, diff-friendly serialization (sorted keys, newline-
    terminated) -- ``--manifest --check`` compares these bytes."""
    return json.dumps(manifest, indent=2, sort_keys=True) + "\n"


def load_manifest(path: pathlib.Path) -> Optional[Dict[str, object]]:
    """Parse a manifest file; None when missing/invalid/wrong version."""
    path = pathlib.Path(path)
    if not path.is_file():
        return None
    try:
        data = json.loads(path.read_text())
    except (json.JSONDecodeError, UnicodeDecodeError):
        return None
    if not isinstance(data, dict) or data.get("version") != MANIFEST_VERSION:
        return None
    return data


# ---------------------------------------------------------------------------
# runtime consumption (imported by core/fused.py -- keep import-light)
# ---------------------------------------------------------------------------

def default_manifest_path() -> pathlib.Path:
    override = os.environ.get(ENV_MANIFEST_PATH)
    if override:
        return pathlib.Path(override)
    return pathlib.Path(__file__).resolve().parent / DEFAULT_MANIFEST


_runtime_cache: Dict[str, Optional[Dict[str, object]]] = {}


def runtime_manifest(path: Optional[pathlib.Path] = None) -> Dict[str, Dict[str, object]]:
    """The committed manifest's metrics map, cached per path; empty when the
    file is absent or ``METRICS_TPU_TORCH_NO_MANIFEST`` is set -- every
    metric then reads as ``unknown`` and the runtime probe keeps full
    authority."""
    if os.environ.get(ENV_NO_MANIFEST):
        return {}
    path = pathlib.Path(path) if path is not None else default_manifest_path()
    key = str(path)
    if key not in _runtime_cache:
        _runtime_cache[key] = load_manifest(path)
    data = _runtime_cache[key]
    if data is None:
        return {}
    metrics = data.get("metrics")
    return metrics if isinstance(metrics, dict) else {}


def invalidate_runtime_cache() -> None:
    """Drop cached manifest files (tests and long-lived sessions that
    regenerate the manifest on disk)."""
    _runtime_cache.clear()


def class_key(cls: type) -> Optional[str]:
    """Manifest key for a metric class, or None when the class lives outside
    the package (or is not a top-level class)."""
    module = getattr(cls, "__module__", "") or ""
    qualname = getattr(cls, "__qualname__", "") or ""
    if not module.startswith(PACKAGE_NAME + ".") or "." in qualname:
        return None
    rel = module[len(PACKAGE_NAME) + 1:].replace(".", "/") + ".py"
    return f"{rel}::{qualname}"


def lookup_class(cls: type, path: Optional[pathlib.Path] = None) -> Optional[Dict[str, object]]:
    """The manifest entry for ``cls`` (exact class only -- verdicts do not
    inherit: a subclass may override update with different behavior)."""
    key = class_key(cls)
    if key is None:
        return None
    return runtime_manifest(path).get(key)


def manifest_verdict(cls: type, path: Optional[pathlib.Path] = None) -> str:
    """``fusible`` / ``unsafe`` / ``unknown`` for a class; absent entries
    read as ``unknown`` (probe decides)."""
    entry = lookup_class(cls, path)
    if not entry:
        return interp.VERDICT_UNKNOWN
    verdict = entry.get("verdict")
    if verdict in (interp.VERDICT_FUSIBLE, interp.VERDICT_UNSAFE):
        return str(verdict)
    return interp.VERDICT_UNKNOWN
