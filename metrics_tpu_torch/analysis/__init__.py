"""tracelint for the port: static analysis of the CUDA-graph update contract.

Counterpart of ``metrics_tpu/analysis/``, retargeted from a jitted JAX
update to the port's fused update (``core/fused.py``), which captures each
fusible member's ``update`` once per batch signature as a CUDA graph. The
runtime enforces that contract late: a host read in an ``update`` surfaces
as a declined probe (the member runs on the eager leg), a Python int in a
fused handle's arguments as a new captured graph per value, a stray
collective as a multi-process hang. ``tracelint`` moves those checks to
review time: an AST engine with a pluggable rule registry, per-line
suppression pragmas (``# tracelint: disable=RULE-ID``), a committed
baseline, and text/JSON/GitHub reporters.

Rule catalog:

* **TL-TRACE** -- host reads (``.item()``/``.tolist()``/``.cpu()``/
  ``.numpy()``, ``float``/``int``/``bool`` of a tensor, ``np.asarray`` of
  one), ``torch.cuda.synchronize()``, Python ``if``/``while`` on tensor
  values, and ``torch.tensor(<Python scalar>, device=...)`` (a synchronous
  copy) inside ``update`` of metrics not declared ``__jit_unsafe__``, and
  hard syncs inside functional kernels. Code behind the capture rule's
  guard (``checks_read_nothing()``, ``capturing_checks()``) is exempt.
* **TL-RECOMPILE** -- Python ints and ``.shape``-derived values reaching a
  fused handle's static cache key (each is a new captured graph).
* **TL-STATE** -- registered-state attributes assigned outside
  update/reset/sync contexts, ``add_state`` with an unknown
  ``dist_reduce_fx``, and list-state / wrapper metrics missing an explicit
  ``__jit_unsafe__`` declaration.
* **TL-COLLECTIVE** -- ``torch.distributed`` collectives outside
  ``metrics_tpu_torch/parallel/`` and ``observability/aggregate.py``.
* **TL-BLOCK** -- ``.item()``/``.tolist()``/``synchronize()`` and casts of
  batch values on the async hot path (``*_async``, the worker).
* **TL-PRINT** -- raw ``print()`` / bare ``warnings.warn()`` in library
  code.
* **TL-DECL** -- ``__jit_unsafe__`` declarations contradicted or made
  redundant by the abstract interpreter's verdict (``interp.py``).
* **TL-FLOW** -- state-lifecycle dataflow (``stateflow.py``).
* **TL-SHARD** / **TL-MERGE** / **TL-WIRE** / **TL-LOCK** -- shard
  placements against the layout manifest, fold-algebra soundness of
  ``merge_like`` reducers, wire coverage of every state leaf, and the
  guarded-by lock discipline of ``core/pipeline.py`` and
  ``observability/collector.py`` (``layout_rules.py``).

The **abstract interpreter** (``interp.py``) resolves calls from metric
updates into ``functional/`` and ``utils/``, models torch ops (static
metadata, data-dependent shapes, host reads, uncapturable calls) and
classifies every metric as ``fusible`` / ``unsafe(cat-growth | host-sync |
data-dependent-shape)`` / ``unknown``.
``python -m metrics_tpu_torch.analysis --manifest`` writes the verdicts and
per-leaf abstractions to ``analysis/fusibility_manifest.json``
(``manifest.py``), which ``core/fused.py`` consults to skip its probe for
``fusible`` classes, and the per-leaf reducer, shard axis and reshard
recipe to ``analysis/layout_manifest.json`` (``layout.py``);
``--manifest --check`` freshness-gates both.

The package is stdlib-only and never imports torch, ``metrics_tpu`` or the
metrics it analyses: it parses the port's sources as text.
"""
from .engine import (  # noqa: F401
    FileContext,
    LintResult,
    Violation,
    analyze_paths,
    analyze_source,
    default_package_root,
    file_suppressed_rules,
    package_relpath,
    suppressed_rules,
)
from .baseline import load_baseline, save_baseline, split_by_baseline  # noqa: F401
from .reporters import render_github, render_json, render_text  # noqa: F401
from .rules import RULE_REGISTRY, Rule, all_rules, get_rules, register_rule  # noqa: F401
from .layout import (  # noqa: F401
    build_layout_manifest,
    layout_for_class,
    leaf_may_shard,
    leaf_shard_axes,
    load_layout_manifest,
    render_layout_manifest,
    runtime_layout,
    shard_path_universe,
)
from .interp import (  # noqa: F401
    Project,
    Signal,
    StateEntry,
    Verdict,
    classify,
    class_facts,
    summarize_function,
    verdict_from_signals,
)
from .manifest import (  # noqa: F401
    build_manifest,
    class_key,
    load_manifest,
    lookup_class,
    manifest_verdict,
    render_manifest,
    runtime_manifest,
)
from .stateflow import analyze_class as analyze_state_flows  # noqa: F401

__all__ = [
    "FileContext",
    "LintResult",
    "Project",
    "RULE_REGISTRY",
    "Rule",
    "Signal",
    "StateEntry",
    "Verdict",
    "Violation",
    "all_rules",
    "analyze_paths",
    "analyze_source",
    "analyze_state_flows",
    "build_layout_manifest",
    "build_manifest",
    "class_facts",
    "class_key",
    "classify",
    "default_package_root",
    "file_suppressed_rules",
    "get_rules",
    "layout_for_class",
    "leaf_may_shard",
    "leaf_shard_axes",
    "load_baseline",
    "load_layout_manifest",
    "load_manifest",
    "lookup_class",
    "manifest_verdict",
    "package_relpath",
    "register_rule",
    "render_github",
    "render_json",
    "render_layout_manifest",
    "render_manifest",
    "render_text",
    "runtime_layout",
    "runtime_manifest",
    "shard_path_universe",
    "save_baseline",
    "split_by_baseline",
    "suppressed_rules",
    "summarize_function",
    "verdict_from_signals",
]
