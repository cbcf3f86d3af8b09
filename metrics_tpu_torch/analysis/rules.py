"""tracelint rule registry and the built-in rule set, retargeted to the
port's contract.

Counterpart of ``metrics_tpu/analysis/rules.py``. The JAX package's rules
guard a jitted update; the port's guard the CUDA-graph update contract of
``core/fused.py``: a fused member's ``update`` is captured once per batch
signature, so it may not read a tensor on the host, synchronise, copy a
host constant to the card, or key a new graph per Python scalar. Every
rule encodes an invariant whose source of truth is the module docstring
of ``core/metric.py``, ``core/fused.py``, ``core/pipeline.py`` or
``parallel/distributed.py``. Rules are registered via
:func:`register_rule`.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set

from .engine import FileContext, Violation
from .interp import _always_raises, _capture_value, _is_literal, _mentions_guard

RULE_REGISTRY: Dict[str, "Rule"] = {}


class Rule:
    """Base class for tracelint rules. Subclasses set ``id``/``description``
    and implement ``check(ctx) -> Iterator[Violation]``."""

    id: str = ""
    description: str = ""

    def check(self, ctx: FileContext) -> Iterator[Violation]:  # pragma: no cover - interface
        raise NotImplementedError

    def violation(self, ctx: FileContext, node: ast.AST, message: str) -> Violation:
        return ctx.violation(self.id, node, message)


def register_rule(cls):
    """Class decorator: instantiate and add to the registry (id-keyed)."""
    instance = cls()
    if not instance.id:
        raise ValueError(f"rule {cls.__name__} must set an id")
    RULE_REGISTRY[instance.id] = instance
    return cls


def all_rules() -> List[Rule]:
    return [RULE_REGISTRY[k] for k in sorted(RULE_REGISTRY)]


def get_rules(ids: Optional[Iterable[str]] = None) -> List[Rule]:
    if ids is None:
        return all_rules()
    out = []
    for rule_id in ids:
        key = rule_id.strip().upper()
        if key not in RULE_REGISTRY:
            raise KeyError(f"unknown tracelint rule {rule_id!r}; known: {sorted(RULE_REGISTRY)}")
        out.append(RULE_REGISTRY[key])
    return out


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------

def _last_name(node: ast.AST) -> Optional[str]:
    """Rightmost identifier of a Name / dotted Attribute chain."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _attr_chain(node: ast.AST) -> List[str]:
    """``torch.distributed.all_reduce`` -> ["torch", "distributed",
    "all_reduce"]; empty if not a pure chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return []


#: string reducers ``add_state`` accepts (core/metric.py:244-272)
KNOWN_REDUCERS = {"sum", "mean", "max", "min", "cat", "merge", "ring", "decay"}

#: methods whose bodies are captured (the fusion surface): a fused update
#: captures ``update`` into a CUDA graph; ``compute`` runs eagerly in the
#: port, where its one host read per call is the design
TRACED_METHODS = {"_update", "update", "update_state"}

#: method-name patterns allowed to assign registered state
_STATE_WRITE_TOKENS = (
    "update", "reset", "sync", "bind", "restore", "merge", "load", "init", "insert",
)
_STATE_WRITE_METHODS = {"__init__", "set_dtype", "to_device", "shard_states", "state_dict"}

#: the epoch-keyed result-cache fields (core/metric.py): the write-epoch
#: clock and the cached compute value/epoch stamp. Outside the lifecycle,
#: mutating them directly bypasses ``_mark_state_written()`` -- the hook
#: subclasses override to degrade their incremental read caches (dirty
#: slices, window fold memos) -- so a bare ``self._write_epoch += 1``
#: silently leaves a partial-fold cache claiming to be current.
_CACHE_PLANE_FIELDS = {"_computed", "_computed_epoch", "_write_epoch"}

#: method-name patterns additionally allowed to touch the cache-plane
#: fields: the compute cycle itself stamps them, and the ``_mark_*`` hooks
#: ARE the sanctioned out-of-band write path
_CACHE_PLANE_TOKENS = _STATE_WRITE_TOKENS + ("compute", "mark")

#: host-side incremental-read bookkeeping: epoch/dirty-set counters, fold
#: memos, per-slice value caches, last-read stats. These are NOT registered
#: state -- they never enter ``_defaults``, sync, or merge; they live on the
#: host and the read plane rebuilds them from real state on any degrade --
#: so writing them from ANY method (including traced ones, where they are
#: Python-level trace-time no-ops) is legal. TL-STATE must never flag them;
#: the carve-out is pinned by tests/analysis fixtures.
HOST_COUNTER_ATTRS = {
    "_dirty",
    "_svc",
    "_fold_memo",
    "_wstate_memo",
    "_borrowed_epoch",
    "_last_fold_fanin",
    "_last_fold_buckets",
    "_last_fold_oldest_wall",
    "_last_read_cache_hit",
    "_last_layout_cache_hit",
    "_last_table_rows",
    "_readers",
}

#: attributes that are static under capture -- touching them is NOT a host
#: read (shape/dtype/device-derived control flow is decided on the host)
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout", "requires_grad", "_version"}

#: tensor methods returning host metadata
_STATIC_METHODS = {
    "is_floating_point",
    "is_complex",
    "is_signed",
    "dim",
    "ndimension",
    "numel",
    "nelement",
    "size",
    "element_size",
    "get_device",
    "is_contiguous",
    "stride",
}

#: torch module members that are host-static METADATA, not tensor
#: producers: branching on `torch.finfo(x.dtype).bits` or
#: `torch.is_floating_point(x)` is decided on the host like a `.dtype` read
_STATIC_MODULE_CALLS = {
    "finfo",
    "iinfo",
    "is_tensor",
    "is_floating_point",
    "is_complex",
    "get_default_dtype",
    "promote_types",
    "result_type",
    "can_cast",
    "device",
}

#: builtins whose results are host/static values, not tensor reads
_STATIC_CALLS = {"isinstance", "len", "getattr", "hasattr", "type", "range", "enumerate", "zip"}

#: tensor methods that copy a tensor to the host or wait for the card
_HOST_READ_METHODS = {"item", "tolist", "cpu", "numpy"}


def _is_torch_cuda_sync(ctx: FileContext, func: ast.AST) -> bool:
    """``torch.cuda.synchronize`` through any torch alias."""
    chain = _attr_chain(func)
    return len(chain) == 3 and chain[0] in ctx.torch_aliases and chain[1:] == ["cuda", "synchronize"]


def _is_host_constant_copy(ctx: FileContext, node: ast.Call) -> bool:
    """``torch.tensor(<Python constant>, device=...)`` (or ``as_tensor``):
    a synchronous host-to-device copy, which a capture cannot hold."""
    func = node.func
    chain = _attr_chain(func)
    if len(chain) == 2 and chain[0] in ctx.torch_aliases:
        member = chain[1]
    elif isinstance(func, ast.Name) and func.id in ctx.torch_member_imports:
        member = ctx.torch_member_imports[func.id]
    else:
        return False
    return (
        member in ("tensor", "as_tensor", "asarray")
        and bool(node.args)
        and _is_literal(node.args[0])
        and any(kw.arg == "device" for kw in node.keywords)
    )


class ClassInfo:
    """Per-class facts the stateful rules share."""

    def __init__(self, node: ast.ClassDef) -> None:
        self.node = node
        self.name = node.name
        self.base_names = [n for n in (_last_name(b) for b in node.bases) if n]
        self.state_names: Set[str] = set()
        self.list_state_names: Set[str] = set()
        self.has_list_state = False
        self.add_state_calls: List[ast.Call] = []
        self.jit_unsafe_declared = False
        self.jit_unsafe_truthy = False
        self._scan()

    def _scan(self) -> None:
        for stmt in self.node.body:
            target = None
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                target = _last_name(stmt.targets[0]) if isinstance(stmt.targets[0], ast.Name) else None
            elif isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
                target = stmt.target.id
            if target == "__jit_unsafe__":
                self._record_decl(getattr(stmt, "value", None))
        for node in ast.walk(self.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt = node.targets[0]
                # self.__jit_unsafe__ = ... (instance-level declaration)
                if (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                    and tgt.attr == "__jit_unsafe__"
                ):
                    self._record_decl(node.value)
                # self.__dict__["__jit_unsafe__"] = ... (shadows the class attr)
                if (
                    isinstance(tgt, ast.Subscript)
                    and isinstance(tgt.value, ast.Attribute)
                    and isinstance(tgt.value.value, ast.Name)
                    and tgt.value.value.id == "self"
                    and tgt.value.attr == "__dict__"
                    and isinstance(tgt.slice, ast.Constant)
                    and tgt.slice.value == "__jit_unsafe__"
                ):
                    self._record_decl(node.value)
            if isinstance(node, ast.Call):
                func = node.func
                if (
                    isinstance(func, ast.Attribute)
                    and func.attr == "add_state"
                    and isinstance(func.value, ast.Name)
                    and func.value.id == "self"
                ):
                    self.add_state_calls.append(node)
                    if node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
                        self.state_names.add(node.args[0].value)
                    default = None
                    if len(node.args) >= 2:
                        default = node.args[1]
                    for kw in node.keywords:
                        if kw.arg == "default":
                            default = kw.value
                    if isinstance(default, ast.List):
                        self.has_list_state = True
                        if node.args and isinstance(node.args[0], ast.Constant):
                            self.list_state_names.add(node.args[0].value)

    def _record_decl(self, value: Optional[ast.AST]) -> None:
        self.jit_unsafe_declared = True
        if isinstance(value, ast.Constant):
            self.jit_unsafe_truthy = self.jit_unsafe_truthy or bool(value.value)
        else:
            # a computed declaration: treat as possibly-unsafe (exempts
            # TL-TRACE conservatively; still counts as declared for TL-STATE)
            self.jit_unsafe_truthy = True

    def methods(self) -> Iterator[ast.FunctionDef]:
        for stmt in self.node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield stmt


def collect_classes(ctx: FileContext) -> Dict[str, ClassInfo]:
    return {
        node.name: ClassInfo(node)
        for node in ctx.tree.body
        if isinstance(node, ast.ClassDef)
    }


def _is_metric_like(info: ClassInfo, classes: Dict[str, ClassInfo], _seen: Optional[Set[str]] = None) -> bool:
    """Metric subclass by name heuristic + in-module transitive bases; any
    class registering state via ``add_state`` counts regardless of name."""
    if info.add_state_calls:
        return True
    _seen = _seen or set()
    for base in info.base_names:
        if base == "Metric" or base.endswith("Metric"):
            return True
        if base in classes and base not in _seen:
            _seen.add(base)
            if _is_metric_like(classes[base], classes, _seen):
                return True
    return False


def _resolved(info: ClassInfo, classes: Dict[str, ClassInfo], attr: str) -> bool:
    """OR-fold a boolean ClassInfo attribute over in-module ancestors."""
    seen: Set[str] = set()

    def walk(ci: ClassInfo) -> bool:
        if getattr(ci, attr):
            return True
        for base in ci.base_names:
            if base in classes and base not in seen:
                seen.add(base)
                if walk(classes[base]):
                    return True
        return False

    return walk(info)


def _resolved_states(info: ClassInfo, classes: Dict[str, ClassInfo], attr: str = "state_names") -> Set[str]:
    names: Set[str] = set()
    seen: Set[str] = set()

    def walk(ci: ClassInfo) -> None:
        names.update(getattr(ci, attr))
        for base in ci.base_names:
            if base in classes and base not in seen:
                seen.add(base)
                walk(classes[base])

    walk(info)
    return names


class _TracedNames:
    """Conservative taint set: function parameters, locals assigned from
    definitely-traced expressions, and ``self.<registered-state>`` reads.

    Deliberately strict -- a call to an unknown (host) helper BREAKS taint,
    so host metadata derived from tensors (input-format modes, shape cases)
    never flags. The cost is missing host reads laundered through helper
    returns; the fused path's runtime probe still owns those.
    """

    def __init__(self, params: Set[str], states: Set[str], list_states: Set[str], ctx: FileContext) -> None:
        self.names = set(params)
        self.states = states - list_states  # list states are host containers
        self.ctx = ctx

    def mentions(self, node: ast.AST) -> bool:
        """Does ``node`` read a definitely-traced value OTHER than via static
        attrs (``.shape``/``.ndim``/``.dtype``/``.device``), static methods
        (``.dim()``/``.numel()``/``.is_floating_point()``), static builtins,
        or identity (``is``/``is not``) comparisons?"""
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                return node.attr in self.states
            return self.mentions(node.value)
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in node.ops
        ):
            # identity and container-membership (dict-key, dtype-set)
            # checks are host structure reads, never value reads
            return False
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Name) and func.id in _STATIC_CALLS:
                return False
            # a torch.* call produces a tensor by construction -- whether
            # spelled via the module alias or a direct member import
            # (`from torch import cat`) -- EXCEPT the dtype/metadata
            # predicates, which are host-static by definition
            if (
                isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and func.value.id in self.ctx.torch_aliases
            ):
                return func.attr not in _STATIC_MODULE_CALLS
            if isinstance(func, ast.Name) and func.id in self.ctx.torch_member_imports:
                # the member-import spelling exempts the same predicates,
                # keyed on the ORIGINAL member name
                return self.ctx.torch_member_imports[func.id] not in _STATIC_MODULE_CALLS
            # a method on a tensor (x.to, x.sum) is a tensor, its metadata
            # methods are not; any OTHER call (host helper) breaks taint on
            # purpose
            if isinstance(func, ast.Attribute) and func.attr in _STATIC_METHODS:
                return False
            if isinstance(func, ast.Attribute) and self.mentions(func.value):
                return True
            return False
        return any(self.mentions(child) for child in ast.iter_child_nodes(node))

    def absorb_assign(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Assign) and self.mentions(stmt.value):
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name):
                    self.names.add(tgt.id)
                elif isinstance(tgt, ast.Tuple):
                    for el in tgt.elts:
                        if isinstance(el, ast.Name):
                            self.names.add(el.id)
        elif isinstance(stmt, ast.AugAssign) and isinstance(stmt.target, ast.Name):
            if self.mentions(stmt.value):
                self.names.add(stmt.target.id)


# ---------------------------------------------------------------------------
# TL-TRACE
# ---------------------------------------------------------------------------

@register_rule
class TraceRule(Rule):
    """Host reads and value-dependent control flow inside the captured
    surface (``update``/``compute`` of metrics not declared
    ``__jit_unsafe__``, and functional kernels).

    A ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``, a
    ``float``/``int``/``bool`` of a tensor or ``np.asarray`` of one copies
    it to the host and waits for the card: per batch on the eager leg, and
    inside a capture it fails the fused update's probe, so the member
    leaves the graph. ``torch.cuda.synchronize()`` does the same, and so
    does a Python ``if``/``while`` on a tensor value. The port's own
    hazard: ``torch.tensor(<Python scalar>, device=...)`` is a synchronous
    host-to-device copy (fill with ``torch.full``). Host checks that a
    captured update must skip belong behind the capture rule's guard
    (``utils/checks.py``): the side of an ``if`` that runs only when
    ``checks_read_nothing()`` is False, and the rest of a block after
    ``if checks_read_nothing(): return``, are exempt, as are
    ``with capturing_checks():`` bodies.
    """

    id = "TL-TRACE"
    description = (
        "host read, synchronisation or value-dependent control flow inside update/compute"
    )

    _CAST_BUILTINS = {"float", "int", "bool"}

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        classes = collect_classes(ctx)
        for info in classes.values():
            if not _is_metric_like(info, classes):
                continue
            if _resolved(info, classes, "jit_unsafe_truthy"):
                continue  # declared host-side: the eager path is its contract
            states = _resolved_states(info, classes)
            list_states = _resolved_states(info, classes, "list_state_names")
            for method in info.methods():
                if method.name in TRACED_METHODS:
                    yield from self._scan_function(ctx, method, states, list_states)
        # functional kernels: the pure (state, batch) -> state surface. Only
        # the unambiguous syncs are flagged here -- host-side reference
        # kernels (text tokenizers, audio DSP engines) legitimately read
        # tensors to the host
        if ctx.relpath.startswith("functional/"):
            for node in ctx.tree.body:
                if isinstance(node, ast.FunctionDef):
                    yield from self._scan_hard_syncs(ctx, node)

    # -- metric-method scan ------------------------------------------------
    def _scan_function(
        self, ctx: FileContext, fn: ast.FunctionDef, states: Set[str], list_states: Set[str]
    ) -> Iterator[Violation]:
        params = {a.arg for a in list(fn.args.args) + list(fn.args.kwonlyargs) if a.arg != "self"}
        if fn.args.vararg:
            params.add(fn.args.vararg.arg)
        if fn.args.kwarg:
            params.add(fn.args.kwarg.arg)
        traced = _TracedNames(params, states, list_states, ctx)
        yield from self._scan_stmts(ctx, fn.body, traced)

    def _scan_stmts(self, ctx: FileContext, stmts: Sequence[ast.stmt], traced: _TracedNames) -> Iterator[Violation]:
        for stmt in stmts:
            if isinstance(stmt, ast.If):
                captured = _capture_value(stmt.test)
                if captured is not None:
                    # the guard decides this test under capture: only that
                    # side runs in a captured update, the other is eager-only
                    yield from self._scan_stmts(ctx, stmt.body if captured else stmt.orelse, traced)
                    if captured and _always_raises(stmt.body):
                        # `if checks_read_nothing(): return` -- the rest of
                        # the block runs only when nothing is captured
                        return
                    continue
                # isinstance-bearing tests are host type-dispatch (the
                # list-vs-tensor state idiom), not value reads
                is_type_dispatch = any(
                    isinstance(sub, ast.Call) and _last_name(sub.func) == "isinstance"
                    for sub in ast.walk(stmt.test)
                )
                if not is_type_dispatch and traced.mentions(stmt.test):
                    yield self.violation(
                        ctx,
                        stmt,
                        "Python `if` on a tensor value reads it on the host; use torch.where, "
                        "hoist to a static (shape/dtype) check, or guard with the capture rule "
                        "(`if not checks_read_nothing():`)",
                    )
                yield from self._scan_expr_container(ctx, stmt.test, traced)
                yield from self._scan_stmts(ctx, stmt.body, traced)
                yield from self._scan_stmts(ctx, stmt.orelse, traced)
            elif isinstance(stmt, ast.While):
                if traced.mentions(stmt.test):
                    yield self.violation(
                        ctx,
                        stmt,
                        "Python `while` on a tensor value reads it on the host every "
                        "iteration; restructure to static bounds",
                    )
                yield from self._scan_expr_container(ctx, stmt.test, traced)
                yield from self._scan_stmts(ctx, stmt.body, traced)
                yield from self._scan_stmts(ctx, stmt.orelse, traced)
            elif isinstance(stmt, ast.With) and any(
                _last_name(item.context_expr.func) == "capturing_checks"
                for item in stmt.items
                if isinstance(item.context_expr, ast.Call)
            ):
                # the capture rule is on for the body: its checks read nothing
                continue
            elif isinstance(stmt, (ast.For, ast.With, ast.Try)):
                for field_name in ("body", "orelse", "finalbody"):
                    yield from self._scan_stmts(ctx, getattr(stmt, field_name, []) or [], traced)
                for handler in getattr(stmt, "handlers", []) or []:
                    yield from self._scan_stmts(ctx, handler.body, traced)
                if isinstance(stmt, ast.For):
                    yield from self._scan_expr_container(ctx, stmt.iter, traced)
                if isinstance(stmt, ast.With):
                    for item in stmt.items:
                        yield from self._scan_expr_container(ctx, item.context_expr, traced)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._scan_stmts(ctx, stmt.body, traced)
            else:
                yield from self._scan_expr_container(ctx, stmt, traced)
                traced.absorb_assign(stmt)

    def _scan_expr_container(self, ctx: FileContext, node: ast.AST, traced: _TracedNames) -> Iterator[Violation]:
        skip: Set[int] = set()
        for sub in ast.walk(node):
            if id(sub) in skip:
                continue
            if isinstance(sub, ast.BoolOp):
                # `not checks_read_nothing() and int(x) > 0`: the operands
                # after the guard decides do not run under capture
                for i, operand in enumerate(sub.values):
                    if _capture_value(operand) is isinstance(sub.op, ast.Or):
                        for rest in sub.values[i + 1 :]:
                            skip.update(id(n) for n in ast.walk(rest))
                        break
                continue
            if isinstance(sub, ast.IfExp):
                captured = _capture_value(sub.test)
                if captured is not None:
                    skip.update(id(n) for n in ast.walk(sub.orelse if captured else sub.body))
                continue
            if not isinstance(sub, ast.Call):
                continue
            func = sub.func
            if isinstance(func, ast.Attribute) and func.attr in _HOST_READ_METHODS:
                if func.attr in ("item", "tolist") or traced.mentions(func.value):
                    yield self.violation(
                        ctx,
                        sub,
                        f"`.{func.attr}()` copies a tensor to the host inside a captured "
                        "update/compute; keep the value on the card or move the read to the caller",
                    )
            elif isinstance(func, ast.Attribute) and func.attr == "synchronize" or _is_torch_cuda_sync(ctx, func):
                yield self.violation(
                    ctx,
                    sub,
                    "a synchronisation inside update/compute waits for the card on the host "
                    "every batch and cannot be captured",
                )
            elif _is_host_constant_copy(ctx, sub):
                yield self.violation(
                    ctx,
                    sub,
                    "`torch.tensor(<constant>, device=...)` is a synchronous host-to-device "
                    "copy every update, which a CUDA graph cannot hold; fill on the card "
                    "with torch.full",
                )
            elif isinstance(func, ast.Name) and func.id in self._CAST_BUILTINS:
                if any(traced.mentions(a) for a in sub.args):
                    yield self.violation(
                        ctx,
                        sub,
                        f"`{func.id}()` of a tensor reads it on the host and sends the member "
                        "to the fused update's eager leg; keep it a 0-d tensor",
                    )
            elif (
                isinstance(func, ast.Attribute)
                and func.attr in {"asarray", "array"}
                and isinstance(func.value, ast.Name)
                and func.value.id in ctx.numpy_aliases
            ):
                if any(traced.mentions(a) for a in sub.args) or any(
                    traced.mentions(kw.value) for kw in sub.keywords
                ):
                    yield self.violation(
                        ctx,
                        sub,
                        f"`{func.value.id}.{func.attr}` of a tensor copies it to the host; "
                        "keep it a torch tensor",
                    )
            elif isinstance(func, ast.Name) and ctx.numpy_member_imports.get(func.id) in {"asarray", "array"}:
                # direct-member import form: `from numpy import asarray`
                if any(traced.mentions(a) for a in sub.args) or any(
                    traced.mentions(kw.value) for kw in sub.keywords
                ):
                    yield self.violation(
                        ctx,
                        sub,
                        f"`{func.id}` (imported from numpy) of a tensor copies it to the host; "
                        "keep it a torch tensor",
                    )

    # -- functional-kernel scan (hard syncs only) --------------------------
    def _scan_hard_syncs(self, ctx: FileContext, fn: ast.FunctionDef) -> Iterator[Violation]:
        guarded: Set[int] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.If) and _mentions_guard(node.test):
                for sub in ast.walk(node):
                    guarded.add(id(sub))
        for node in ast.walk(fn):
            if id(node) in guarded or not isinstance(node, ast.Call):
                continue
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr == "item":
                yield self.violation(
                    ctx,
                    node,
                    "`.item()` in a functional kernel copies a tensor to the host; "
                    "functional kernels must stay pure (state, batch) -> state",
                )
            elif _is_torch_cuda_sync(ctx, func) or (isinstance(func, ast.Attribute) and func.attr == "synchronize"):
                yield self.violation(
                    ctx,
                    node,
                    "a synchronisation in a functional kernel waits for the card; "
                    "return the tensor instead",
                )


# ---------------------------------------------------------------------------
# TL-RECOMPILE
# ---------------------------------------------------------------------------

@register_rule
class RecompileRule(Rule):
    """Python scalars and ``.shape``-derived values reaching a fused
    handle's static cache key.

    ``FusedUpdate`` (``core/fused.py``) copies tensors and Python floats
    into a graph's static inputs, but ints, bools and strings stay static
    and key its cache: every new value captures a new CUDA graph (the
    16-entry warning). So a ``.shape[...]``, ``.size(...)``, ``.numel()``,
    ``.dim()``, ``len(...)`` or ``int(...)`` value passed to a handle that
    ``compile_update`` returned captures per value; pass it as a float or
    a 0-d tensor, or bucket the batch (``compile_update(buckets=...)``).
    """

    id = "TL-RECOMPILE"
    description = "Python int or .shape-derived value keying a fused handle's captured graphs"

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        handles = self._handles(ctx)
        if not handles:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            target = self._handle_ref(node.func)
            if target is None or target not in handles:
                continue
            for arg in self._leaves(list(node.args) + [kw.value for kw in node.keywords]):
                hazard = self._scalar_hazard(arg)
                if hazard:
                    yield self.violation(
                        ctx,
                        arg,
                        f"{hazard} reaches the static cache key of fused handle `{target}` and "
                        "captures a new CUDA graph per value; pass it as a float or a 0-d "
                        "tensor, or bucket the batch",
                    )

    @classmethod
    def _leaves(cls, nodes: Sequence[ast.AST]) -> Iterator[ast.AST]:
        """The arguments, with tuple/list/dict displays (``dispatch``'s
        ``(args, kwargs)``) and starred arguments opened."""
        for node in nodes:
            if isinstance(node, (ast.Tuple, ast.List)):
                yield from cls._leaves(node.elts)
            elif isinstance(node, ast.Dict):
                yield from cls._leaves(node.values)
            elif isinstance(node, ast.Starred):
                yield from cls._leaves([node.value])
            else:
                yield node

    @staticmethod
    def _handle_ref(func: ast.AST) -> Optional[str]:
        """``h`` for ``h(...)`` / ``h.dispatch(...)``; ``self.h`` likewise."""
        if isinstance(func, ast.Attribute) and func.attr == "dispatch":
            func = func.value
        chain = _attr_chain(func)
        if len(chain) == 1 or (len(chain) == 2 and chain[0] == "self"):
            return ".".join(chain)
        return None

    @classmethod
    def _handles(cls, ctx: FileContext) -> Set[str]:
        """Names bound to ``<collection>.compile_update(...)``."""
        out: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.value, ast.Call)
                and _last_name(node.value.func) == "compile_update"
            ):
                ref = cls._handle_ref(node.targets[0])
                if ref is not None:
                    out.add(ref)
        return out

    @staticmethod
    def _scalar_hazard(arg: ast.AST) -> Optional[str]:
        if isinstance(arg, ast.Subscript) and isinstance(arg.value, ast.Attribute) and arg.value.attr == "shape":
            return "a `.shape[...]` int"
        if isinstance(arg, ast.Attribute) and arg.attr == "ndim":
            return "a `.ndim` int"
        if isinstance(arg, ast.Call) and isinstance(arg.func, ast.Attribute) and arg.func.attr in ("size", "numel", "dim"):
            return f"a `.{arg.func.attr}()` int"
        if isinstance(arg, ast.Call) and isinstance(arg.func, ast.Name):
            if arg.func.id == "len":
                return "a `len(...)` int"
            if arg.func.id in ("int", "bool"):
                return f"a `{arg.func.id}(...)` scalar"
        return None


# ---------------------------------------------------------------------------
# TL-STATE
# ---------------------------------------------------------------------------

@register_rule
class StateRule(Rule):
    """State-registry discipline.

    Registered states carry a ``dist_reduce_fx`` contract that sync, merge,
    and the fused kernel all trust; writing one outside an
    update/reset/sync context desynchronizes ``_defaults``/``_cache``
    bookkeeping (a ``_compute`` that assigns state breaks compute-caching
    and double-update ``forward``). List-state and wrapper metrics must
    declare ``__jit_unsafe__`` explicitly -- the fused path sends them to
    its eager leg either way, but the declaration is the documented
    decision.
    """

    id = "TL-STATE"
    description = "metric state registry discipline (writes, reducers, declarations)"

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        classes = collect_classes(ctx)
        for info in classes.values():
            if not _is_metric_like(info, classes):
                continue
            yield from self._check_reducers(ctx, info)
            yield from self._check_state_writes(ctx, info, classes)
            yield from self._check_cache_plane_writes(ctx, info)
            yield from self._check_declarations(ctx, info, classes)

    def _check_reducers(self, ctx: FileContext, info: ClassInfo) -> Iterator[Violation]:
        for call in info.add_state_calls:
            fx = None
            if len(call.args) >= 3:
                fx = call.args[2]
            for kw in call.keywords:
                if kw.arg == "dist_reduce_fx":
                    fx = kw.value
            if isinstance(fx, ast.Constant) and isinstance(fx.value, str) and fx.value not in KNOWN_REDUCERS:
                yield self.violation(
                    ctx,
                    call,
                    f"add_state with unknown dist_reduce_fx {fx.value!r}; use one of "
                    f"{sorted(KNOWN_REDUCERS)}, None, or a callable",
                )

    def _check_state_writes(self, ctx: FileContext, info: ClassInfo, classes: Dict[str, ClassInfo]) -> Iterator[Violation]:
        states = _resolved_states(info, classes)
        if not states:
            return
        for method in info.methods():
            name = method.name
            if name in _STATE_WRITE_METHODS or any(tok in name for tok in _STATE_WRITE_TOKENS):
                continue
            for node in ast.walk(method):
                targets: List[ast.AST] = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    targets = [node.target]
                for tgt in targets:
                    if (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                        and tgt.attr in states
                        # host-side epoch/dirty/memo counters are legal
                        # non-leaf writes anywhere (see HOST_COUNTER_ATTRS)
                        and tgt.attr not in HOST_COUNTER_ATTRS
                    ):
                        yield self.violation(
                            ctx,
                            node,
                            f"registered state `{tgt.attr}` assigned in `{name}`, outside "
                            "the update/reset/sync lifecycle; state writes elsewhere "
                            "desync the reset defaults and the sync cache",
                        )

    def _check_cache_plane_writes(self, ctx: FileContext, info: ClassInfo) -> Iterator[Violation]:
        for method in info.methods():
            name = method.name
            if name in _STATE_WRITE_METHODS or any(tok in name for tok in _CACHE_PLANE_TOKENS):
                continue
            for node in ast.walk(method):
                targets: List[ast.AST] = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    targets = [node.target]
                for tgt in targets:
                    if (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                        and tgt.attr in _CACHE_PLANE_FIELDS
                    ):
                        yield self.violation(
                            ctx,
                            node,
                            f"epoch-cache field `{tgt.attr}` assigned in `{name}`, outside "
                            "the compute/update/reset lifecycle; call "
                            "`_mark_state_written()` (or `_mark_fused_written()`) instead "
                            "so subclass incremental read caches degrade with the epoch",
                        )

    def _check_declarations(self, ctx: FileContext, info: ClassInfo, classes: Dict[str, ClassInfo]) -> Iterator[Violation]:
        # a subclass that registers no list state itself inherits the
        # ancestor's declaration (or the ancestor is flagged on its own)
        is_wrapper = ctx.relpath.startswith("wrappers/")
        if not (is_wrapper or info.has_list_state):
            return
        if not _resolved(info, classes, "jit_unsafe_declared"):
            kind = "wrapper metric" if is_wrapper else "list-state metric"
            yield self.violation(
                ctx,
                info.node,
                f"{kind} `{info.name}` must declare `__jit_unsafe__` explicitly "
                "(True if update cannot trace, False if it can); the fused path "
                "and MetricTester key on the declaration",
            )


# ---------------------------------------------------------------------------
# TL-BLOCK
# ---------------------------------------------------------------------------

@register_rule
class BlockRule(Rule):
    """Host-blocking reads on the async-ingest hot path.

    The async update pipeline's contract (``core/pipeline.py``) is that the
    serving loop never stalls on metrics accounting: ``update_async`` must
    return in microseconds and the worker must hand batches to the card's
    stream without waiting on it. One ``.item()`` / ``.tolist()`` /
    ``torch.cuda.synchronize()`` / ``Event.synchronize()`` /
    ``Stream.synchronize()`` / ``float()``/``int()`` of a batch value there
    silently turns the pipeline back into the blocking path it exists to
    replace -- per batch, invisibly. Scope: every function named
    ``*_async`` anywhere in the package, plus the worker/enqueue/drain
    paths of ``core/pipeline.py`` (method-name keyed). Deliberate blocking
    entry points (``flush``, ``close``, ``update_blocking``) are outside
    the scope by naming convention; intentional hits take the standard
    ``# tracelint: disable=TL-BLOCK`` pragma with a reason.
    """

    id = "TL-BLOCK"
    description = (
        "host-blocking read or synchronisation on the async hot path (*_async functions, "
        "core/pipeline.py worker/enqueue paths)"
    )

    _SYNC_METHODS = {"item", "tolist", "synchronize"}
    _CAST_BUILTINS = {"float", "int"}
    _HOT_FILE = "core/pipeline.py"
    _HOT_NAME_TOKENS = ("worker", "enqueue", "drain")

    def _is_hot(self, ctx: FileContext, fn: ast.FunctionDef) -> bool:
        if fn.name.endswith("_async"):
            return True
        return ctx.relpath == self._HOT_FILE and any(
            tok in fn.name for tok in self._HOT_NAME_TOKENS
        )

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        hot = [
            node
            for node in ast.walk(ctx.tree)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and self._is_hot(ctx, node)
        ]
        hot_ids = {id(fn) for fn in hot}
        for fn in hot:
            # a hot function nested inside another hot function is scanned
            # once, as its own entry
            yield from self._scan(ctx, fn, hot_ids)

    def _scan(self, ctx: FileContext, fn: ast.FunctionDef, hot_ids: Set[int]) -> Iterator[Violation]:
        params = {a.arg for a in list(fn.args.args) + list(fn.args.kwonlyargs) if a.arg != "self"}
        if fn.args.vararg:
            params.add(fn.args.vararg.arg)
        if fn.args.kwarg:
            params.add(fn.args.kwarg.arg)
        tainted = _TracedNames(params, set(), set(), ctx)
        skip: Set[int] = set()
        for node in ast.walk(fn):
            if id(node) in skip:
                continue
            if (
                isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node is not fn
                and id(node) in hot_ids
            ):
                for sub in ast.walk(node):
                    skip.add(id(sub))
                continue
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                tainted.absorb_assign(node)
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if _is_torch_cuda_sync(ctx, func):
                yield self.violation(
                    ctx,
                    node,
                    "`torch.cuda.synchronize()` blocks the host on the card inside the async"
                    " hot path -- the serving loop stalls on every batch; flush() is the"
                    " sanctioned drain point",
                )
            elif isinstance(func, ast.Attribute) and func.attr in self._SYNC_METHODS:
                yield self.violation(
                    ctx,
                    node,
                    f"`.{func.attr}()` blocks the host on the card inside the async hot path"
                    " -- the serving loop stalls on every batch; keep reads out of"
                    " update_async/worker code (flush() is the sanctioned drain point)",
                )
            elif isinstance(func, ast.Name) and func.id in self._CAST_BUILTINS:
                if any(tainted.mentions(a) for a in node.args):
                    yield self.violation(
                        ctx,
                        node,
                        f"`{func.id}()` of a batch-derived value reads it on the host -- a"
                        " blocking read per batch on the async hot path; keep it a tensor"
                        " (or move the cast behind flush())",
                    )


# ---------------------------------------------------------------------------
# TL-COLLECTIVE
# ---------------------------------------------------------------------------

@register_rule
class CollectiveRule(Rule):
    """Raw ``torch.distributed`` collectives outside the transport layer.

    ``parallel/`` owns the collective counters (rounds, bytes, host reads),
    the padded all-gather and the reduction bundling; ``observability/
    aggregate.py`` owns the host-level counter all-gather. A raw
    ``dist.all_reduce`` (or any other collective) anywhere else bypasses
    that accounting, and a metric that calls one in ``update`` hangs every
    rank that does not -- route through ``parallel.distributed``
    (``gather_all_tensors`` / ``sync_pytree``) instead.
    """

    id = "TL-COLLECTIVE"
    description = "raw torch.distributed collective outside metrics_tpu_torch/parallel or observability/aggregate.py"

    COLLECTIVES = {
        "all_gather",
        "all_gather_into_tensor",
        "all_gather_object",
        "all_reduce",
        "all_to_all",
        "all_to_all_single",
        "broadcast",
        "broadcast_object_list",
        "reduce",
        "reduce_scatter",
        "reduce_scatter_tensor",
        "gather",
        "gather_object",
        "scatter",
        "scatter_object_list",
        "barrier",
        "monitored_barrier",
        "send",
        "recv",
        "isend",
        "irecv",
    }
    ALLOWED_PREFIXES = ("parallel/",)
    ALLOWED_FILES = {"observability/aggregate.py"}

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        rel = ctx.relpath
        if rel.startswith(self.ALLOWED_PREFIXES) or rel in self.ALLOWED_FILES:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            chain = _attr_chain(func)
            name = chain[-1] if chain else None
            if isinstance(func, ast.Name):
                name = ctx.dist_from_imports.get(func.id, name)
            if name not in self.COLLECTIVES:
                continue
            # dist.all_reduce / torch.distributed.all_reduce / from
            # torch.distributed import all_reduce / a same-file rebinding
            # (`mydist = torch.distributed`; engine alias maps)
            rooted_in_dist = (
                (len(chain) == 2 and chain[0] in ctx.dist_aliases)
                or (len(chain) == 3 and chain[0] in ctx.torch_aliases and chain[1] == "distributed")
                or (isinstance(func, ast.Name) and func.id in ctx.dist_from_imports)
            )
            if rooted_in_dist:
                yield self.violation(
                    ctx,
                    node,
                    f"raw collective `{'.'.join(chain)}` outside the transport layer; "
                    "route through parallel.distributed (gather_all_tensors/sync_pytree) "
                    "so the collective counters and byte accounting stay centralised",
                )


# ---------------------------------------------------------------------------
# TL-PRINT
# ---------------------------------------------------------------------------

@register_rule
class PrintRule(Rule):
    """Raw ``print()`` / bare ``warnings.warn()`` in library code.

    Multi-host jobs run one Python process per host: an unguarded print
    emits once per process. All user-facing output must route through the
    rank-zero helpers in ``utils/prints.py`` (the one module allowed to
    touch print/warnings directly).
    """

    id = "TL-PRINT"
    description = "raw print()/warnings.warn() in library code (use rank-zero helpers)"

    ALLOWED_FILES = {"utils/prints.py"}

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        if ctx.relpath in self.ALLOWED_FILES:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if isinstance(func, ast.Name) and func.id == "print":
                yield self.violation(
                    ctx,
                    node,
                    "raw print() in library code; use rank_zero_print/rank_zero_info "
                    "from metrics_tpu_torch.utils.prints",
                )
            elif (
                isinstance(func, ast.Attribute)
                and func.attr == "warn"
                and isinstance(func.value, ast.Name)
                and func.value.id in ctx.warnings_aliases
            ):
                yield self.violation(
                    ctx,
                    node,
                    "bare warnings.warn() in library code; use rank_zero_warn from "
                    "metrics_tpu_torch.utils.prints",
                )
            elif isinstance(func, ast.Name) and func.id in ctx.warn_fn_aliases:
                yield self.violation(
                    ctx,
                    node,
                    "bare warn() in library code; use rank_zero_warn from "
                    "metrics_tpu_torch.utils.prints",
                )


# ---------------------------------------------------------------------------
# TL-DECL
# ---------------------------------------------------------------------------

@register_rule
class DeclRule(Rule):
    """``__jit_unsafe__`` declarations cross-checked against the abstract
    interpreter's verdict (analysis/interp.py).

    The declaration is the contract the fused path keys on, and it goes
    stale in both directions: a metric declared ``True`` whose update
    became pure and fixed-shape silently keeps paying the eager leg, and a
    metric declared ``False`` that grew a host read is declined by the
    probe -- or, seeded from a stale manifest, fails its capture and takes
    the stale-manifest retry. Both are findings; ``unknown`` verdicts never
    fire (the runtime probe stays the authority), and cat-growth never
    contradicts ``False`` (list states are excluded from fusion by a
    separate runtime check, not the declaration).
    """

    id = "TL-DECL"
    description = "__jit_unsafe__ declaration contradicted or made redundant by the static verdict"

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        from . import interp

        classes = collect_classes(ctx)
        project = _shared_project()
        for info in classes.values():
            if not _is_metric_like(info, classes):
                continue
            verdict, facts = interp.classify(project, ctx, info.node)
            if facts.declared_here is None or facts.declared_computed:
                continue  # undeclared or computed declarations are not auditable
            if facts.declared_here and verdict.status == interp.VERDICT_FUSIBLE:
                yield self.violation(
                    ctx,
                    info.node,
                    f"`{info.name}` declares `__jit_unsafe__ = True` but its update is "
                    "statically fusible (pure, fixed-shape through every resolved call); "
                    "the stale declaration forces the eager leg -- remove it or document "
                    "the dynamic case the analysis cannot see with a pragma",
                )
            elif (
                not facts.declared_here
                and verdict.status == interp.VERDICT_UNSAFE
                and verdict.reason in (interp.REASON_HOST_SYNC, interp.REASON_DATA_SHAPE)
            ):
                yield self.violation(
                    ctx,
                    info.node,
                    f"`{info.name}` declares `__jit_unsafe__ = False` but its update is "
                    f"statically unsafe ({verdict.reason}): {verdict.detail}; the fused "
                    "update's probe declines it every signature -- fix the update or "
                    "declare True",
                )


#: one Project per process: parse-once resolution shared by TL-DECL/TL-FLOW
#: and the manifest builder (file contexts are immutable once parsed)
_PROJECT = None


def _shared_project():
    global _PROJECT
    if _PROJECT is None:
        from .interp import Project

        _PROJECT = Project()
    return _PROJECT


# ---------------------------------------------------------------------------
# TL-FLOW
# ---------------------------------------------------------------------------

@register_rule
class FlowRule(Rule):
    """State-lifecycle dataflow (analysis/stateflow.py): reducer-consistent
    accumulation, reset restoration, and live leaves.

    A ``"sum"``-reduced leaf mutated by anything other than additive
    assignment breaks the cross-rank reduction contract sync and
    ``merge_states`` trust; an overriding ``reset`` that misses a leaf
    leaks accumulation across epochs; a registered-but-never-touched leaf
    is dead sync weight. TL-STATE checks WHERE states are written -- this
    rule checks WHAT the writes mean.
    """

    id = "TL-FLOW"
    description = "state write inconsistent with its dist_reduce_fx / reset / liveness contract"

    def check(self, ctx: FileContext) -> Iterator[Violation]:
        from . import stateflow

        classes = collect_classes(ctx)
        for info in classes.values():
            if not _is_metric_like(info, classes):
                continue
            for finding in stateflow.analyze_class(ctx, info.node):
                yield self.violation(ctx, finding.node, finding.message)


# Layout/collective soundness rules (TL-SHARD, TL-MERGE, TL-WIRE, TL-LOCK)
# live in their own module but register into the same registry; imported
# last so they can reuse this module's helpers without circularity.
from . import layout_rules  # noqa: E402,F401
