"""Layout manifest: per-leaf shard/reshard contracts as a runtime input.

Counterpart of ``metrics_tpu/analysis/layout.py``. The fusibility manifest
(``analysis/manifest.py``) records WHETHER a metric's update can fuse; this
manifest records WHERE each state leaf lives across ranks and HOW it moves
when the layout changes -- the static source of truth a sharded slice
state restores against, instead of re-deriving layout from live objects.
``python -m metrics_tpu_torch.analysis --manifest`` writes both files from
the same interp walk; ``--manifest --check`` freshness-gates both.

Schema v1 (deterministic serialization -- byte-stable)::

    {
      "version": 1,
      "tool": "tracelint",
      "classes": {
        "classification/confusion_matrix.py::ConfusionMatrix": {
          "sliceable": true,               # admits SlicedMetric wrapping
          "declared_jit_unsafe": null,
          "leaves": {
            "confmat": {
              "reducer": "sum",            # add_state dist_reduce_fx class
              "shard_axis": "[S]",         # [S] | [R] | replicated
              "partition_spec": ["slices"],# template for the leading dim
              "reshard": "reshape",        # reshape | fold | gather | opaque
              "container": "array", "dtype": "int32",
              "shape": ["num_classes", "num_classes"],
              "wire": "array"              # array | list | opaque
            }
          }
        }, ...
      }
    }

Field semantics:

* ``shard_axis`` -- ``"[S]"``: the leaf's leading axis becomes the slice
  axis under ``SlicedMetric`` wrapping (every ``sum``/``max``/``min``
  tensor leaf of a sliceable class), so it may be split disjointly across
  ranks and a sync legitimately skips reducing it. ``"[R]"``: the leading
  axis is a windowed ring-slot axis (time buckets, replicated across ranks
  but never foldable ACROSS slots). ``"replicated"``: every rank holds the
  whole leaf and a cross-rank reduction is REQUIRED -- a shard placement
  claiming such a leaf makes a sync silently skip that reduction (the
  TL-SHARD bug class).
* ``partition_spec`` -- leading-dim template naming the slice axis
  (``"slices"``); ``[]`` replicates.
* ``reshard`` -- what a change of world size does to the leaf:
  ``"reshape"`` (re-slice the ``[S]`` axis over the new ranks),
  ``"fold"`` (re-fold through the leaf's own reducer -- merge/sum-family
  leaves reshard by folding per-rank snapshots, not by reshaping),
  ``"gather"`` (cat/list leaves concatenate), ``"opaque"`` (no static
  recipe -- custom reducer, runtime owns it).
* ``wire`` -- the wire codec class (``observability/wire.py``):
  ``"array"`` dtype+bytes, ``"list"`` element-wise, ``"opaque"``
  statically unresolvable container.

Runtime consumers look classes up via :func:`layout_for_class`; the fleet
wire's ``manifest_fingerprint`` hashes the file. Environment:
``METRICS_TPU_TORCH_LAYOUT_MANIFEST=<path>`` points at another file;
``METRICS_TPU_TORCH_NO_MANIFEST=1`` (shared with the fusibility manifest)
disables consultation entirely.

Stdlib-only, like the rest of the analysis package.
"""
from __future__ import annotations

import json
import os
import pathlib
from typing import Dict, Optional, Set

from . import interp
from .manifest import ENV_NO_MANIFEST, class_key

LAYOUT_VERSION = 1

#: the committed layout manifest's file name, beside this module
DEFAULT_LAYOUT_MANIFEST = "layout_manifest.json"

#: env var naming an alternate layout manifest file
ENV_LAYOUT_MANIFEST_PATH = "METRICS_TPU_TORCH_LAYOUT_MANIFEST"

#: shard-axis classes (see module docstring)
AXIS_SLICE = "[S]"
AXIS_RING = "[R]"
AXIS_REPLICATED = "replicated"

#: reshard recipes
RESHARD_RESHAPE = "reshape"
RESHARD_FOLD = "fold"
RESHARD_GATHER = "gather"
RESHARD_OPAQUE = "opaque"

#: reducer classes with a registered cross-shard fold: the string
#: reducers plus the tagged merge families (interp._reducer_of's
#: abstraction of ``*merge_fx()`` / ``moments_merge_fx()`` /
#: ``ring_*_fx()`` / ``decay_sum_fx()``)
FOLD_REDUCERS = {"sum", "mean", "max", "min", "merge", "moments", "decay", "ring"}

#: stdlib-only mirrors of the runtime constants (this package never
#: imports them; the cross-module agreement is pinned by the port's
#: analysis tests)
SLICED_PREFIX = "sliced/"  # observability/recorder.SLICED_FOOTPRINT_PREFIX
SKETCH_PREFIX = "sketch/"  # observability/recorder.SKETCH_FOOTPRINT_PREFIX
WINDOWED_PREFIX = "windowed/"  # observability/recorder.WINDOWED_FOOTPRINT_PREFIX
SLICE_ROWS = "_slice_rows"  # sliced/metric.SLICE_ROWS
SLICE_AXIS_NAME = "slices"  # sliced/sharding.SLICE_AXIS

#: manifest key of the one class whose leaves are registered dynamically
#: (broadcast from the wrapped template's): its entry carries the
#: synthetic row-counter leaf plus the ``dynamic_leaves`` marker
SLICED_METRIC_KEY = "sliced/metric.py::SlicedMetric"


# ---------------------------------------------------------------------------
# build (analysis side)
# ---------------------------------------------------------------------------

def class_is_sliceable(facts: interp.ClassFacts) -> bool:
    """Static mirror of ``SlicedMetric._validate_sliceable``: every leaf is
    a sum/max/min-reduced ARRAY state and the class is not declared
    jit-unsafe. (The runtime check additionally rejects wrapper metrics
    with live children -- invisible statically, so the runtime keeps
    authority and the consumers fall back on any disagreement.)"""
    if not facts.entries or facts.declared is True:
        return False
    return all(e.sliceable for e in facts.entries)


def _leaf_record(entry: interp.StateEntry, sliceable_class: bool) -> Dict[str, object]:
    reducer = entry.dist_reduce_fx
    if reducer == "ring":
        axis = AXIS_RING
    elif sliceable_class and entry.sliceable:
        axis = AXIS_SLICE
    else:
        axis = AXIS_REPLICATED
    if axis == AXIS_SLICE:
        reshard = RESHARD_RESHAPE
    elif reducer in FOLD_REDUCERS:
        reshard = RESHARD_FOLD
    elif reducer == "cat" or entry.container == "list":
        reshard = RESHARD_GATHER
    else:
        reshard = RESHARD_OPAQUE
    if entry.container == "array":
        wire = "array"
    elif entry.container == "list":
        wire = "list"
    else:
        wire = "opaque"
    return {
        "reducer": reducer,
        "shard_axis": axis,
        "partition_spec": [SLICE_AXIS_NAME] if axis == AXIS_SLICE else [],
        "reshard": reshard,
        "container": entry.container,
        "dtype": entry.dtype,
        "shape": entry.shape,
        "wire": wire,
    }


def _sliced_metric_entry() -> Dict[str, object]:
    """The synthetic ``SlicedMetric`` entry: its per-template leaves are
    registered dynamically (every template leaf broadcast to a
    ``(num_slices,) + shape`` ``[S]``-leading row block, keeping the
    template's reducer) so the interp walk cannot enumerate them; the one
    statically-known leaf is the reserved row counter."""
    return {
        "sliceable": False,  # wrapping a SlicedMetric collides on SLICE_ROWS
        "declared_jit_unsafe": None,
        "dynamic_leaves": "template-broadcast",
        "leaves": {
            SLICE_ROWS: {
                "reducer": "sum",
                "shard_axis": AXIS_SLICE,
                "partition_spec": [SLICE_AXIS_NAME],
                "reshard": RESHARD_RESHAPE,
                "container": "array",
                "dtype": "int32",
                "shape": ["num_slices"],
                "wire": "array",
            }
        },
    }


def build_layout_manifest(project: Optional[interp.Project] = None) -> Dict[str, object]:
    """Derive the per-leaf layout contract for every state-registering
    metric class in the package. Always a FULL-package walk (freshness
    checks diff the whole file)."""
    project = project or interp.Project()
    root = project.root
    classes: Dict[str, Dict[str, object]] = {}
    for path in sorted(root.rglob("*.py")):
        rel = "/".join(path.relative_to(root).parts)
        if rel.startswith("analysis/"):
            continue  # the analyzer does not classify itself
        ctx = project.ctx(rel)
        if ctx is None:
            continue
        for node in interp.iter_metric_classes(ctx):
            facts = interp.class_facts(project, ctx, node)
            if not facts.is_metric or not facts.entries:
                continue
            sliceable = class_is_sliceable(facts)
            classes[f"{rel}::{node.name}"] = {
                "sliceable": sliceable,
                "declared_jit_unsafe": facts.declared,
                "leaves": {
                    e.name: _leaf_record(e, sliceable) for e in facts.entries
                },
            }
    # synthetic SlicedMetric entry (dynamically-registered leaves)
    sliced_ctx = project.ctx("sliced/metric.py")
    if sliced_ctx is not None and any(
        getattr(n, "name", None) == "SlicedMetric" for n in sliced_ctx.tree.body
    ):
        classes[SLICED_METRIC_KEY] = _sliced_metric_entry()
    return {
        "version": LAYOUT_VERSION,
        "tool": "tracelint",
        "classes": {k: classes[k] for k in sorted(classes)},
    }


def render_layout_manifest(manifest: Dict[str, object]) -> str:
    """Deterministic, diff-friendly serialization (sorted keys, newline-
    terminated) -- ``--manifest --check`` compares these bytes."""
    return json.dumps(manifest, indent=2, sort_keys=True) + "\n"


def load_layout_manifest(path: pathlib.Path) -> Optional[Dict[str, object]]:
    """Parse a layout manifest file; None when missing/invalid/wrong
    version."""
    path = pathlib.Path(path)
    if not path.is_file():
        return None
    try:
        data = json.loads(path.read_text())
    except (json.JSONDecodeError, UnicodeDecodeError):
        return None
    if not isinstance(data, dict) or data.get("version") != LAYOUT_VERSION:
        return None
    return data


# ---------------------------------------------------------------------------
# path universe (consumed by the TL-SHARD rule)
# ---------------------------------------------------------------------------

def shard_path_universe(layout: Dict[str, object]) -> Dict[str, Set[str]]:
    """Every state-leaf path a committed partition-rule set can be asked to
    match -- the footprint-prefixed forms ``shard_sliced_states`` produces
    plus the plain state names -- mapped to the set of shard-axis tags
    that admit a named-axis spec there (empty set = the leaf must
    replicate, so a named-axis spec on it silently skips a REQUIRED
    reduction)."""
    universe: Dict[str, Set[str]] = {}

    def add(path: str, *axes: str) -> None:
        universe.setdefault(path, set()).update(axes)

    classes = layout.get("classes") if isinstance(layout, dict) else None
    if not isinstance(classes, dict):
        return universe
    for key, ent in classes.items():
        leaves = ent.get("leaves", {}) if isinstance(ent, dict) else {}
        sliceable = bool(ent.get("sliceable")) if isinstance(ent, dict) else False
        for name, rec in leaves.items():
            axis = rec.get("shard_axis") if isinstance(rec, dict) else None
            reducer = rec.get("reducer") if isinstance(rec, dict) else None
            if axis == AXIS_SLICE:
                # the [S] plane: only the sliced/-prefixed footprint form
                # carries the slice axis -- a PLAIN name in a footprint
                # belongs to an unwrapped metric, whose leading axis is a
                # batch/class dim the sync path must still reduce. (The
                # synthetic `_slice_rows` leaf keeps [S] in plain form too:
                # it exists only inside SlicedMetric and the shipped rule
                # pattern matches it suffix-anchored.)
                if name == SLICE_ROWS:
                    add(name, AXIS_SLICE)
                else:
                    add(name)
                add(SLICED_PREFIX + name, AXIS_SLICE)
                continue
            ring = AXIS_RING if axis == AXIS_RING else None
            add(name, *([ring] if ring else []))
            if reducer in ("merge", "moments", "ring"):
                # merge-tagged leaves footprint under the sketch prefix
                add(SKETCH_PREFIX + name, *([ring] if ring else []))
            if reducer in ("ring", "decay"):
                # windowed wrappers footprint under the windowed prefix
                add(WINDOWED_PREFIX + name, *([ring] if ring else []))
            if sliceable:
                add(SLICED_PREFIX + name, AXIS_SLICE)
    return universe


# ---------------------------------------------------------------------------
# runtime consumption (imported by sliced/sharding.py and
# parallel/distributed.py -- keep import-light)
# ---------------------------------------------------------------------------

def default_layout_manifest_path() -> pathlib.Path:
    override = os.environ.get(ENV_LAYOUT_MANIFEST_PATH)
    if override:
        return pathlib.Path(override)
    return pathlib.Path(__file__).resolve().parent / DEFAULT_LAYOUT_MANIFEST


_runtime_cache: Dict[str, Optional[Dict[str, object]]] = {}
_axis_index_cache: Dict[str, Dict[str, Set[str]]] = {}


def runtime_layout(path: Optional[pathlib.Path] = None) -> Dict[str, Dict[str, object]]:
    """The committed layout manifest's classes map, cached per path; empty
    when the file is absent (installed package without the repo checkout)
    or ``METRICS_TPU_NO_MANIFEST`` is set -- consumers then keep their
    live-object probes as the sole authority."""
    if os.environ.get(ENV_NO_MANIFEST):
        return {}
    path = pathlib.Path(path) if path is not None else default_layout_manifest_path()
    key = str(path)
    if key not in _runtime_cache:
        _runtime_cache[key] = load_layout_manifest(path)
    data = _runtime_cache[key]
    if data is None:
        return {}
    classes = data.get("classes")
    return classes if isinstance(classes, dict) else {}


def invalidate_layout_cache() -> None:
    """Drop cached layout manifests (tests and long-lived sessions that
    regenerate the manifest on disk)."""
    _runtime_cache.clear()
    _axis_index_cache.clear()


def layout_for_class(cls: type, path: Optional[pathlib.Path] = None) -> Optional[Dict[str, object]]:
    """The layout entry for ``cls`` (exact class only -- layouts do not
    inherit: a subclass may register different states)."""
    key = class_key(cls)
    if key is None:
        return None
    return runtime_layout(path).get(key)


def _axis_index(path: Optional[pathlib.Path] = None) -> Dict[str, Set[str]]:
    """Leaf name -> union of ``[S]``/``[R]`` tags any manifest class
    assigns it; EVERY manifest leaf name has an entry (replicated-only
    names map to the empty set), so membership distinguishes
    known-replicated from never-seen."""
    key = str(pathlib.Path(path) if path is not None else default_layout_manifest_path())
    index = _axis_index_cache.get(key)
    if index is None:
        index = {}
        for ent in runtime_layout(path).values():
            leaves = ent.get("leaves", {}) if isinstance(ent, dict) else {}
            for leaf, rec in leaves.items():
                axis = rec.get("shard_axis") if isinstance(rec, dict) else None
                entry = index.setdefault(leaf, set())
                if axis in (AXIS_SLICE, AXIS_RING):
                    entry.add(axis)
        _axis_index_cache[key] = index
    return index


def leaf_shard_axes(name: str, path: Optional[pathlib.Path] = None) -> Set[str]:
    """Union of shard-axis tags any class in the manifest assigns to a
    state leaf named ``name`` -- the sync path's cheap plausibility index
    for a sharded-claimed spec (a name NO class tags ``[S]``/``[R]``
    cannot legitimately skip its cross-rank reduction). Empty when the
    manifest is absent/disabled (callers must then trust the spec)."""
    return set(_axis_index(path).get(name, ()))


def leaf_may_shard(name: str, path: Optional[pathlib.Path] = None) -> Optional[bool]:
    """Whether a sharded-claimed spec on a leaf named ``name`` is
    manifest-plausible: True when some class tags it ``[S]``/``[R]``,
    False when the manifest covers the name only as replicated, and None
    when the manifest is absent/disabled or has never seen the name (no
    verdict either way). ``name`` may be a footprint path -- only its
    basename is consulted (a ``sliced/``-prefixed form shards whenever
    the bare leaf can)."""
    if not runtime_layout(path):
        return None
    base = name.rsplit("/", 1)[-1]
    if base == SLICE_ROWS:
        return True
    index = _axis_index(path)
    if base not in index:
        return None
    axes = index[base]
    prefixed = name != base
    if AXIS_RING in axes:
        return True
    if AXIS_SLICE in axes:
        # the slice axis only exists on the sliced/-prefixed (template-
        # broadcast) form of the leaf; a BARE name in a footprint belongs
        # to an unwrapped metric whose leading axis still needs reducing.
        # Bare claims arrive from sliced_partition_specs' name-keyed spec
        # dicts though, so only a known-replicated name is refutable.
        return True if prefixed else None
    return False
