"""Layout/collective soundness rules: TL-SHARD, TL-MERGE, TL-WIRE, TL-LOCK.

Counterpart of ``metrics_tpu/analysis/layout_rules.py`` over the port's
reducers (``windowed/reducers.py``'s ``"ring"``/``"decay"`` tags and the
sketches' ``merge_like`` folds). The distributed correctness of the whole
library rests on per-leaf reducer semantics: a shard placement claiming a
replicated leaf sharded makes a sync silently SKIP a required cross-rank
reduction, a non-commutative merge fold breaks the fleet collector's
arrival-order-independence contract, and a state leaf without a
wire-serializable dtype/shape/reducer triple cannot ride the snapshot
wire at all. These rules make those contracts static, checked against the
layout manifest (``analysis/layout.py``) derived from the same interp walk
-- plus TL-LOCK, a guarded-by discipline check for the two host-side
concurrency planes (``core/pipeline.py``, ``observability/collector.py``).

Registered from ``rules.py`` (import at module bottom) so ``all_rules()``
and the CLI pick them up; same pragma and empty-baseline contract as every
other rule.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .engine import FileContext, Violation
from .rules import (
    Rule,
    _attr_chain,
    _is_metric_like,
    _last_name,
    _shared_project,
    collect_classes,
    register_rule,
)

# ---------------------------------------------------------------------------
# shared layout universe (built once per process, like _shared_project)
# ---------------------------------------------------------------------------

_UNIVERSE: Optional[Dict[str, Set[str]]] = None


def _shared_universe() -> Dict[str, Set[str]]:
    """Path -> admissible-shard-axes map over the whole package, derived
    from a fresh in-memory layout-manifest build (never the committed
    file: the rules must see the CURRENT source, not a stale artifact)."""
    global _UNIVERSE
    if _UNIVERSE is None:
        from .layout import build_layout_manifest, shard_path_universe

        _UNIVERSE = shard_path_universe(build_layout_manifest(_shared_project()))
    return _UNIVERSE


# ---------------------------------------------------------------------------
# TL-SHARD
# ---------------------------------------------------------------------------

#: names whose ``re.escape(<name>)`` interpolation inside an f-string rule
#: pattern is statically resolvable (mirrors of the runtime constants --
#: see layout.py)
_PATTERN_CONSTANTS = {
    "SLICED_FOOTPRINT_PREFIX": "sliced/",
    "SKETCH_FOOTPRINT_PREFIX": "sketch/",
    "WINDOWED_FOOTPRINT_PREFIX": "windowed/",
    "SLICE_ROWS": "_slice_rows",
}

#: spec constructors: a ``PartitionSpec``-style template (``None`` places
#: no axis) and the ``torch.distributed`` tensor placements (``Shard(d)``
#: always claims a sharded leaf, ``Replicate()`` never does)
_SPEC_NAMES = {"PartitionSpec", "P", "Shard", "Replicate"}


def _eval_pattern(node: ast.AST) -> Optional[str]:
    """Statically evaluate a partition-rule regex expression: a plain
    string constant, or an f-string whose interpolations are
    ``re.escape(<known constant>)``. None when beyond the lattice."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts: List[str] = []
        for value in node.values:
            if isinstance(value, ast.Constant) and isinstance(value.value, str):
                parts.append(value.value)
            elif isinstance(value, ast.FormattedValue):
                inner = value.value
                if (
                    isinstance(inner, ast.Call)
                    and _attr_chain(inner.func)[-1:] == ["escape"]
                    and len(inner.args) == 1
                ):
                    arg = inner.args[0]
                    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                        parts.append(re.escape(arg.value))
                        continue
                    name = _last_name(arg)
                    if name in _PATTERN_CONSTANTS:
                        parts.append(re.escape(_PATTERN_CONSTANTS[name]))
                        continue
                return None
            else:
                return None
        return "".join(parts)
    return None


def _spec_call(node: ast.AST) -> Optional[ast.Call]:
    """The ``PartitionSpec(...)`` call a rule-pair's second element is."""
    if isinstance(node, ast.Call) and _last_name(node.func) in _SPEC_NAMES:
        return node
    return None


def _spec_names_axis(call: ast.Call) -> bool:
    """True when the spec places a sharded axis: a ``Shard(...)``
    placement, or a ``PartitionSpec`` with any non-None argument."""
    name = _last_name(call.func)
    if name == "Replicate":
        return False
    if name == "Shard":
        return True
    return any(
        not (isinstance(a, ast.Constant) and a.value is None) for a in call.args
    )


def _rule_pairs(node: ast.AST) -> Optional[List[Tuple[ast.AST, Optional[str], ast.Call]]]:
    """Extract a partition-rule set from a tuple/list literal of
    ``(pattern, PartitionSpec(...))`` pairs; None when the literal is not
    one. A pair's pattern slot is None when statically unevaluable."""
    if not isinstance(node, (ast.Tuple, ast.List)) or not node.elts:
        return None
    pairs = []
    for elt in node.elts:
        if not (isinstance(elt, (ast.Tuple, ast.List)) and len(elt.elts) == 2):
            return None
        spec = _spec_call(elt.elts[1])
        if spec is None:
            return None
        pattern_node = elt.elts[0]
        if not isinstance(pattern_node, (ast.Constant, ast.JoinedStr)):
            return None
        pairs.append((elt, _eval_pattern(pattern_node), spec))
    return pairs


def _axis_claim(node: ast.AST) -> Optional[ast.Call]:
    """The named-axis ``PartitionSpec`` call a spec-producing expression
    bottoms out in, unwrapping ``.spec`` attributes and ``NamedSharding``
    wrappers; None when the expression routes through a helper call (the
    helper owns the divisibility guard) or places no axis."""
    while isinstance(node, ast.Attribute):
        node = node.value
    spec = _spec_call(node)
    if spec is not None:
        return spec if _spec_names_axis(spec) else None
    if isinstance(node, ast.Call) and _last_name(node.func) in ("NamedSharding", "distribute_tensor"):
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            inner = _spec_call(arg)
            if inner is not None and _spec_names_axis(inner):
                return inner
    return None


_STATE_ITER_ATTRS = {"_defaults", "_reductions", "_state_names", "state_footprint"}


@register_rule
class ShardRule(Rule):
    """Partition-rule coverage and spec/reducer agreement, checked against
    the layout manifest's path universe (every footprint path any
    state-registering class can produce).

    A sharded placement (``Shard(0)``, or a ``PartitionSpec`` naming an
    axis) tells a sync that the leaf is owned DISJOINTLY across ranks, so
    it passes the leaf through with no collective. That is only true for
    ``[S]`` slice rows (and ``[R]`` ring slots); on a replicated leaf the
    claim silently drops a REQUIRED cross-rank reduction and every rank
    keeps its local partial. Checked statically: committed rule sets
    must give every leaf path a first-match (the runtime raises on
    unmatched), named-axis rules must only ever first-match ``[S]``/``[R]``
    paths, spec dict literals must not claim replicated leaves sharded,
    and per-leaf spec comprehensions must route through a divisibility
    guard instead of claiming every leaf unconditionally.
    """

    id = "TL-SHARD"
    description = "partition spec/rule claims a shard layout the leaf's reducer cannot honor"

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        universe = _shared_universe()
        seen_sets: Set[int] = set()
        for node in ast.walk(ctx.tree):
            pairs = _rule_pairs(node) if id(node) not in seen_sets else None
            if pairs is not None:
                seen_sets.update(id(p[0]) for p in pairs)
                yield from self._check_rule_set(ctx, node, pairs, universe)
            elif isinstance(node, ast.Dict):
                yield from self._check_spec_dict(ctx, node, universe)
            elif isinstance(node, ast.DictComp):
                yield from self._check_spec_comp(ctx, node)

    def _check_rule_set(self, ctx, node, pairs, universe) -> Iterator[Violation]:
        if any(pattern is None for _, pattern, _ in pairs):
            return  # an unevaluable pattern breaks first-match reasoning
        compiled = []
        for pair_node, pattern, spec in pairs:
            try:
                compiled.append((pair_node, re.compile(pattern), spec))
            except re.error:
                return
        unmatched: List[str] = []
        bad_by_pair: Dict[int, Tuple[ast.AST, List[str]]] = {}
        for path in sorted(universe):
            for pair_node, rx, spec in compiled:
                if rx.search(path) is None:
                    continue
                if _spec_names_axis(spec) and not universe[path]:
                    entry = bad_by_pair.setdefault(id(pair_node), (pair_node, []))
                    entry[1].append(path)
                break
            else:
                unmatched.append(path)
        if unmatched:
            sample = ", ".join(unmatched[:3])
            yield self.violation(
                ctx,
                node,
                f"partition-rule set leaves {len(unmatched)} state-leaf path(s) unmatched "
                f"(e.g. {sample}); match_partition_rules raises on the first one -- add a "
                "catch-all replicate rule",
            )
        for pair_node, paths in bad_by_pair.values():
            sample = ", ".join(paths[:3])
            yield self.violation(
                ctx,
                pair_node,
                f"named-axis partition rule first-matches {len(paths)} leaf path(s) whose "
                f"reducer requires a cross-rank reduction (e.g. {sample}); the sync path "
                "would pass them through unreduced -- scope the pattern to [S]/[R] paths "
                "or replicate",
            )

    def _check_spec_dict(self, ctx, node, universe) -> Iterator[Violation]:
        for key, value in zip(node.keys, node.values):
            if not (isinstance(key, ast.Constant) and isinstance(key.value, str)):
                continue
            claim = _axis_claim(value)
            if claim is None:
                continue
            axes = universe.get(key.value)
            if axes is not None and not axes:
                yield self.violation(
                    ctx,
                    value,
                    f"spec claims state leaf `{key.value}` sharded, but every class "
                    "registering that leaf needs a cross-rank reduction for it "
                    "(replicated in the layout manifest); the sync path would skip "
                    "the reduction and keep per-rank partials",
                )

    def _check_spec_comp(self, ctx, node) -> Iterator[Violation]:
        claim = _axis_claim(node.value)
        if claim is None:
            return
        if any(gen.ifs for gen in node.generators):
            return
        if any(isinstance(sub, ast.IfExp) for sub in ast.walk(node.value)):
            return
        iters_states = any(
            isinstance(sub, ast.Attribute) and sub.attr in _STATE_ITER_ATTRS
            for gen in node.generators
            for sub in ast.walk(gen.iter)
        )
        if not iters_states:
            return
        yield self.violation(
            ctx,
            node,
            "claims EVERY state leaf sharded unconditionally; leaves the divisibility "
            "fallback leaves replicated would skip their required cross-rank reduction "
            "-- route the spec through get_naive_slice_sharding (or an equivalent guard)",
        )


# ---------------------------------------------------------------------------
# TL-MERGE
# ---------------------------------------------------------------------------

_NONCOMMUTATIVE_OPS = (ast.Sub, ast.Div, ast.FloorDiv, ast.Mod, ast.Pow, ast.MatMult)

_HOST_STATE_ROOTS = {"time", "random", "os", "datetime"}


def _merge_like_classes(tree: ast.Module) -> Iterator[ast.ClassDef]:
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for stmt in node.body:
            if (
                isinstance(stmt, ast.Assign)
                and any(
                    isinstance(t, ast.Name) and t.id == "merge_like" for t in stmt.targets
                )
                and isinstance(stmt.value, ast.Constant)
                and stmt.value.value is True
            ):
                yield node
                break


def _class_attr_constant(node: ast.ClassDef, name: str) -> object:
    for stmt in node.body:
        if (
            isinstance(stmt, ast.Assign)
            and any(isinstance(t, ast.Name) and t.id == name for t in stmt.targets)
            and isinstance(stmt.value, ast.Constant)
        ):
            return stmt.value.value
    return None


def _tainted(node: ast.AST, taint: Set[str]) -> bool:
    return any(
        isinstance(sub, ast.Name) and sub.id in taint for sub in ast.walk(node)
    )


def _fold_taint(fn: ast.FunctionDef) -> Set[str]:
    """Names derived from the stacked-leaves argument of a merge fold
    (forward may-taint over simple assignments, fixed-point)."""
    args = [a.arg for a in fn.args.args if a.arg != "self"]
    taint: Set[str] = set(args[:1])
    changed = True
    while changed:
        changed = False
        for sub in ast.walk(fn):
            targets: List[ast.AST] = []
            value: Optional[ast.AST] = None
            if isinstance(sub, ast.Assign):
                targets, value = sub.targets, sub.value
            elif isinstance(sub, ast.AugAssign):
                targets, value = [sub.target], sub.value
            if value is None or not _tainted(value, taint):
                continue
            for target in targets:
                if isinstance(target, ast.Name) and target.id not in taint:
                    taint.add(target.id)
                    changed = True
    return taint


_REDUCTIONS = ("sum", "max", "min", "mean", "prod", "amax", "amin")


def _full_reduce(node: ast.Call, taint: Set[str]) -> bool:
    """A reduction over every element of stack-derived data: ``torch.sum(x)``
    or ``x.sum()`` with no ``dim`` (``axis``) argument."""
    name = _last_name(node.func)
    if name not in _REDUCTIONS:
        return False
    if any(kw.arg in ("dim", "axis") for kw in node.keywords):
        return False
    chain = _attr_chain(node.func)
    if isinstance(node.func, ast.Attribute) and not (len(chain) == 2 and chain[0] in ("torch", "np", "numpy")):
        # the method spelling: `stacked.sum()`
        return not node.args and _tainted(node.func.value, taint)
    return len(node.args) == 1 and _tainted(node.args[0], taint)


def _flattens(node: ast.Call) -> bool:
    """``.ravel()`` / ``.flatten()`` / ``.reshape(-1)`` / ``.view(-1)``."""
    name = node.func.attr
    if name in ("ravel", "flatten"):
        return True
    if name in ("reshape", "view") and len(node.args) == 1:
        arg = node.args[0]
        return (
            isinstance(arg, ast.UnaryOp)
            and isinstance(arg.operand, ast.Constant)
            and arg.operand.value == 1
        )
    return False


@register_rule
class MergeRule(Rule):
    """Fold-algebra soundness for ``merge_like``-tagged reducers.

    The fleet collector folds per-publisher snapshots through these
    callables in ARRIVAL order and pins the result byte-identical under
    any arrival permutation -- so a fold step that subtracts/divides two
    stack-derived operands (non-commutative), reads host state (time,
    RNG, environment), or mutates the reducer instance breaks the
    contract invisibly until two fleets disagree. Ring folds
    (``windowed_kind = "ring"``) must additionally fold slot-aligned:
    a full reduce or flatten over the stacked rings mixes time buckets
    across ranks.
    """

    id = "TL-MERGE"
    description = "merge-tagged fold is order-dependent, host-stateful, or mixes ring slots"

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        for cls in _merge_like_classes(ctx.tree):
            call_fn = next(
                (
                    s
                    for s in cls.body
                    if isinstance(s, ast.FunctionDef) and s.name == "__call__"
                ),
                None,
            )
            if call_fn is None:
                continue
            taint = _fold_taint(call_fn)
            is_ring = _class_attr_constant(cls, "windowed_kind") == "ring"
            for node in ast.walk(call_fn):
                if (
                    isinstance(node, ast.BinOp)
                    and isinstance(node.op, _NONCOMMUTATIVE_OPS)
                    and _tainted(node.left, taint)
                    and _tainted(node.right, taint)
                ):
                    yield self.violation(
                        ctx,
                        node,
                        f"`{cls.name}.__call__` folds stacked leaves through a "
                        f"non-commutative `{type(node.op).__name__}` step; the collector "
                        "folds snapshots in arrival order, so the merged result depends "
                        "on which rank arrived first",
                    )
                elif isinstance(node, ast.Call):
                    chain = _attr_chain(node.func)
                    if chain and (
                        chain[0] in _HOST_STATE_ROOTS
                        or (len(chain) >= 2 and chain[1] == "random")
                    ):
                        yield self.violation(
                            ctx,
                            node,
                            f"`{cls.name}.__call__` reads host state "
                            f"(`{'.'.join(chain)}`); a merge fold must be a pure "
                            "function of the stacked leaves or two collectors folding "
                            "the same snapshots diverge",
                        )
                    elif is_ring and _full_reduce(node, taint):
                        yield self.violation(
                            ctx,
                            node,
                            f"`{cls.name}.__call__` full-reduces the stacked rings "
                            f"(`{_last_name(node.func)}` with no dim); ring folds must stay "
                            "slot-aligned -- reduce over dim 0 or fold the inner merge "
                            "slot by slot",
                        )
                    elif (
                        is_ring
                        and isinstance(node.func, ast.Attribute)
                        and _flattens(node)
                        and _tainted(node.func.value, taint)
                    ):
                        yield self.violation(
                            ctx,
                            node,
                            f"`{cls.name}.__call__` flattens stack-derived ring state "
                            f"(`.{node.func.attr}()`), mixing time-bucket slots across ranks",
                        )
                elif (
                    isinstance(node, (ast.Assign, ast.AugAssign))
                    and any(
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                        for t in (
                            node.targets
                            if isinstance(node, ast.Assign)
                            else [node.target]
                        )
                    )
                ):
                    yield self.violation(
                        ctx,
                        node,
                        f"`{cls.name}.__call__` mutates the reducer instance; merge "
                        "folds are shared process-wide singletons and must stay "
                        "stateless",
                    )


# ---------------------------------------------------------------------------
# TL-WIRE
# ---------------------------------------------------------------------------

def _own_add_state_calls(cls: ast.ClassDef) -> List[Tuple[ast.Call, Optional[ast.FunctionDef]]]:
    """``self.add_state(...)`` calls in THIS class body, each with its
    enclosing method (for parameter-derived exemptions)."""
    out: List[Tuple[ast.Call, Optional[ast.FunctionDef]]] = []

    def walk(node: ast.AST, fn: Optional[ast.FunctionDef]) -> None:
        for child in ast.iter_child_nodes(node):
            child_fn = child if isinstance(child, ast.FunctionDef) else fn
            if (
                isinstance(child, ast.Call)
                and isinstance(child.func, ast.Attribute)
                and child.func.attr == "add_state"
                and isinstance(child.func.value, ast.Name)
                and child.func.value.id == "self"
            ):
                out.append((child, fn))
            walk(child, child_fn)

    walk(cls, None)
    return out


def _fn_params(fn: Optional[ast.FunctionDef]) -> Set[str]:
    if fn is None:
        return set()
    args = list(fn.args.posonlyargs) + list(fn.args.args) + list(fn.args.kwonlyargs)
    out = {a.arg for a in args if a.arg != "self"}
    if fn.args.vararg:
        out.add(fn.args.vararg.arg)
    if fn.args.kwarg:
        out.add(fn.args.kwarg.arg)
    return out


def _references_params(node: Optional[ast.AST], params: Set[str]) -> bool:
    if node is None or not params:
        return False
    return any(
        isinstance(sub, ast.Name) and sub.id in params for sub in ast.walk(node)
    )


def _locally_bound(node: Optional[ast.AST], fn: Optional[ast.FunctionDef]) -> bool:
    """True when the expression is a local variable assigned in the
    enclosing method, or a call of one (the ``default()`` thunk idiom) --
    the layout or reducer is chosen at construction time and ``add_state``
    validates it at registration."""
    if isinstance(node, ast.Call) and not node.args and not node.keywords:
        node = node.func
    if fn is None or not isinstance(node, ast.Name):
        return False
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == node.id for t in sub.targets
        ):
            return True
        if isinstance(sub, (ast.AugAssign, ast.AnnAssign)) and isinstance(
            sub.target, ast.Name
        ) and sub.target.id == node.id:
            return True
    return False


@register_rule
class WireRule(Rule):
    """Checkpoint/wire coverage: every ``add_state`` leaf needs a
    wire-serializable dtype/shape/reducer triple
    (``observability/wire.py``).

    The snapshot wire encodes array leaves dtype-stable (bit-exact) and
    folds them through the leaf's reducer under the ``states_key``
    contract; a leaf whose layout is statically opaque rides the wire as
    an untyped JSON value, a bare-callable reducer has no registered fold
    the collector can honor, and a class mixing device states with
    exact-mode cat lists must declare the ``__exact_mode_attr__`` escape
    hatch so consumers can tell the modes apart. Constructor-parameterized
    registrations (the reducer/default chosen by the caller) keep runtime
    authority -- ``add_state`` validates them at registration.
    """

    id = "TL-WIRE"
    description = "state leaf lacks a wire-serializable dtype/shape/reducer contract"

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        from . import interp

        classes = collect_classes(ctx)
        project = _shared_project()
        for info in classes.values():
            if not _is_metric_like(info, classes):
                continue
            facts = interp.class_facts(project, ctx, info.node)
            enclosing = {id(call): fn for call, fn in _own_add_state_calls(info.node)}
            # state names as the interpreter reads them (constant-name loops
            # unrolled, module constants resolved)
            calls = [
                (call, name, enclosing.get(id(call)))
                for call, name in interp.add_state_calls(info.node, interp.module_constants(ctx.tree))
                if name is not None
            ]
            names_count: Dict[str, int] = {}
            for _call, name, _fn in calls:
                names_count[name] = names_count.get(name, 0) + 1
            for call, name, fn in calls:
                params = _fn_params(fn)
                default = call.args[1] if len(call.args) >= 2 else None
                fx: Optional[ast.AST] = call.args[2] if len(call.args) >= 3 else None
                for kw in call.keywords:
                    if kw.arg == "default":
                        default = kw.value
                    elif kw.arg == "dist_reduce_fx":
                        fx = kw.value
                # W2: a reducer with no registered fold for the states_key
                # contract -- an untagged callable (not a known string, not a
                # tagged *merge_fx), unless constructor-parameterized
                if (
                    interp._reducer_of(call) == "custom"
                    and not _references_params(fx, params)
                    and not _locally_bound(fx, fn)
                ):
                    yield self.violation(
                        ctx,
                        call,
                        f"state `{name}` registers an untagged callable reducer; the "
                        "wire fold and the cross-rank sync only honor the known string reducers "
                        "and `merge_like`-tagged callables -- tag the fold (see "
                        "sketches/quantile.py) or use a string reducer",
                    )
                # W1: statically wire-opaque layout -- a single registration
                # whose container cannot be resolved and is not
                # config-parameterized; the leaf would ride the wire as an
                # untyped JSON value with no dtype-stable contract
                container, _shape, _dtype = interp._infer_default(default)
                if (
                    container == "unknown"
                    and names_count.get(name, 0) == 1
                    and not _references_params(default, params)
                    and not _locally_bound(default, fn)
                ):
                    yield self.violation(
                        ctx,
                        call,
                        f"state `{name}` has a statically wire-opaque default (neither "
                        "an array constructor, a list, nor constructor-parameterized); "
                        "the snapshot wire cannot guarantee a dtype-stable round-trip "
                        "for it",
                    )
            # W3: exact-mode cat lists without the declared escape hatch -- a
            # class mixing fixed-shape device states with list states must
            # declare __exact_mode_attr__ (or __jit_unsafe__) so wire
            # consumers and the fused path can tell the modes apart
            own_entries = interp.state_entries_of(info.node, interp.module_constants(ctx.tree))
            containers = {e.container for e in facts.entries}
            if (
                any(e.container == "list" for e in own_entries)
                and "array" in containers
                and "list" in containers
                and facts.declared is not True
                and facts.exact_attr is None
            ):
                yield self.violation(
                    ctx,
                    info.node,
                    f"`{info.name}` mixes fixed-shape device states with cat-list "
                    "states but declares neither `__exact_mode_attr__` nor "
                    "`__jit_unsafe__`; wire consumers cannot tell which mode a "
                    "snapshot carries",
                )


# ---------------------------------------------------------------------------
# TL-LOCK
# ---------------------------------------------------------------------------

#: guarded-by registry (the port's ``core/pipeline.py`` and
#: ``observability/collector.py`` keep the JAX package's field names):
#: relpath -> class -> lock attr -> fields whose every
#: read/write outside ``__init__``/``*_locked`` methods must sit inside a
#: lexical ``with self.<lock>:`` scope. Registered fields are VERIFIED
#: lock-clean -- growing the registry is the way to pin a new field's
#: discipline; deliberately-unlocked fields (racy-but-benign reads like
#: ``watermark``'s ``_max_t``) stay out with the reason documented at the
#: read site.
GUARDED_FIELDS: Dict[str, Dict[str, Dict[str, Set[str]]]] = {
    "core/pipeline.py": {
        "AsyncUpdateHandle": {
            "_cond": {
                "_pending",
                "_in_flight_bytes",
                "_attempts",
                "_enqueued",
                "_applied",
                "_dropped",
                "_pending_wall",
                "_first_apply_wall",
                "_last_apply_wall",
                "_snapshot_waiters",
            },
        },
    },
    "observability/collector.py": {
        "FleetCollector": {
            "_lock": {
                "_pubs",
                "fold_errors",
                "fold_error_details",
                "clock_skew_clamps",
            },
        },
    },
}


@register_rule
class LockRule(Rule):
    """Guarded-by discipline for the host-side concurrency planes.

    ``AsyncUpdateHandle`` (producer threads + worker) and
    ``FleetCollector`` (ingest + readers) each document a lock that owns
    their counters and queues; a read or write that slips outside the
    ``with`` scope is a torn counter or a lost update. The registry
    (:data:`GUARDED_FIELDS`) names the
    verified fields; ``__init__`` (construction happens-before publication)
    and ``*_locked``-suffixed methods (the documented called-with-lock-held
    convention) are exempt. Closures and nested functions inherit the
    lexical ``with`` scope they are defined in.
    """

    id = "TL-LOCK"
    description = "guarded field accessed outside its lock's `with` scope"

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        registry = GUARDED_FIELDS.get(ctx.relpath)
        if not registry:
            return
        for node in ctx.tree.body:
            if not isinstance(node, ast.ClassDef) or node.name not in registry:
                continue
            locks = registry[node.name]
            field_to_lock = {
                field: lock for lock, fields in locks.items() for field in fields
            }
            for stmt in node.body:
                if not isinstance(stmt, ast.FunctionDef):
                    continue
                if stmt.name == "__init__" or stmt.name.endswith("_locked"):
                    continue
                yield from self._scan(ctx, stmt, frozenset(), field_to_lock, stmt.name)

    def _scan(
        self,
        ctx: FileContext,
        node: ast.AST,
        held: frozenset,
        field_to_lock: Dict[str, str],
        method: str,
    ) -> Iterator[Violation]:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired = set(held)
            for item in node.items:
                expr = item.context_expr
                if (
                    isinstance(expr, ast.Attribute)
                    and isinstance(expr.value, ast.Name)
                    and expr.value.id == "self"
                ):
                    acquired.add(expr.attr)
                yield from self._scan(ctx, expr, held, field_to_lock, method)
            for stmt in node.body:
                yield from self._scan(ctx, stmt, frozenset(acquired), field_to_lock, method)
            return
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and node.attr in field_to_lock
            and field_to_lock[node.attr] not in held
        ):
            yield self.violation(
                ctx,
                node,
                f"`{method}` accesses `self.{node.attr}` outside `with "
                f"self.{field_to_lock[node.attr]}:`; the field's guarded-by contract "
                "(GUARDED_FIELDS) makes unlocked access a torn read/lost update -- "
                "take the lock, or rename the method `*_locked` if callers hold it",
            )
        for child in ast.iter_child_nodes(node):
            yield from self._scan(ctx, child, held, field_to_lock, method)
