"""tracelint's interprocedural abstract interpreter over the port's metric
updates.

Counterpart of ``metrics_tpu/analysis/interp.py``, retargeted from a jitted
JAX update to the port's contract: a member of a fused collection has its
``update`` captured once per batch signature as a CUDA graph
(``core/fused.py``), so it may launch device work only -- no value read on
the host, no output shape that depends on values, no state that grows. The
interpreter resolves calls from metric updates into ``functional/`` and
``utils/`` across files and classifies every metric class:

* ``fusible`` -- the update provably stays on the card with fixed shapes:
  every reachable operation is a torch op, a resolved in-package helper
  that is itself clean, a static builtin, a call into the port's ``ops/``
  kernels, or a method on a tensor. The fused path may skip its probe.
* ``unsafe`` -- a definitive violation on an unconditional path:
  - ``cat-growth`` -- list states (``default=[]``), ``self.<state>.append``
    or ``torch.cat``/``stack`` of a state onto itself;
  - ``host-sync`` -- a device-to-host read (``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()``, ``float/int/bool`` of a tensor, ``np.*`` of
    a tensor), Python control flow on tensor values, a synchronisation
    (``torch.cuda.synchronize``), a synchronous host-to-device copy
    (``torch.tensor(<host value>, device=...)``), or a call that cannot be
    captured (the batched LU behind ``torch.linalg.solve``);
  - ``data-dependent-shape`` -- ``torch.nonzero``/``argwhere``/``unique*``/
    ``masked_select``, boolean-mask indexing, tensor slice bounds,
    ``bincount`` (its length is ``max(minlength, max + 1)``) and
    ``repeat_interleave`` without ``output_size``.
* ``unknown`` -- something the analysis cannot bound (an unresolved call
  receiving tensors, a config-dependent state container, an unsafe signal
  on a conditional path). The runtime probe remains the authority.

Static metadata never taints: ``shape``, ``ndim``, ``dtype``, ``device``,
``is_cuda``, ``is_floating_point()``, ``is_complex()``, ``dim()``,
``numel()``, ``size()``, ``element_size()``, ``torch.finfo``/``iinfo``,
``torch.is_tensor``/``is_floating_point`` and dtype comparisons.

The value lattice tracks, per local name: taintedness (does it carry a
tensor), None-ness (``none``/``notnone``/``maybe``, used to kill
statically-dead ``if x is None`` branches) and bool-ness (a comparison
result, i.e. a potential boolean mask). ``isinstance(x, Tensor)`` tests
refine taint: the branch where ``x`` is not a tensor holds host data.
Function summaries are memoized per ``(function, argument binding)``.

The capture rule's guard is honoured: ``checks_read_nothing()`` is True
while an update is probed or captured (``utils/checks.py``), so the side of
an ``if`` that runs only when it is False is eager-only, and
``if checks_read_nothing(): return`` makes the rest of its block
eager-only. ``with capturing_checks():`` bodies are probed-path code.

Everything here is stdlib-only (ast): the CLI never imports torch.
"""
from __future__ import annotations

import ast
import pathlib
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterator, List, Optional, Sequence, Set, Tuple

from .engine import FileContext, PACKAGE_NAME, default_package_root

# ---------------------------------------------------------------------------
# verdict vocabulary (stable -- serialized into the fusibility manifest)
# ---------------------------------------------------------------------------

VERDICT_FUSIBLE = "fusible"
VERDICT_UNSAFE = "unsafe"
VERDICT_UNKNOWN = "unknown"

REASON_CAT_GROWTH = "cat-growth"
REASON_HOST_SYNC = "host-sync"
REASON_DATA_SHAPE = "data-dependent-shape"

#: signal kinds an update scan can raise; "unknown" and "trace-raise" never
#: make a metric unsafe, they only block the fusible verdict ("trace-raise"
#: marks a reachable, UNCAUGHT raise that the capture rule's guard selects:
#: an input configuration that fails under capture; a caller that wraps
#: the call in try/except has handled it)
_SIGNAL_KINDS = (REASON_HOST_SYNC, REASON_DATA_SHAPE, REASON_CAT_GROWTH, "unknown", "trace-raise")

#: ``_Scanner._scan_if``'s answer when the rest of the block runs for
#: host data only (the tensor side of an ``isinstance`` test returned)
_HOST_REST = "host-rest"

# None-ness lattice
_NONE = "none"
_NOT_NONE = "notnone"
_MAYBE = "maybe"

#: torch functions whose OUTPUT shape depends on data values -- poison for
#: a captured graph (``torch.where`` and ``repeat_interleave`` are handled
#: separately: only their one-argument / no-``output_size`` forms are)
_DATA_DEP_MEMBERS = {
    "nonzero",
    "argwhere",
    "unique",
    "unique_consecutive",
    "masked_select",
    "bincount",
}

#: torch functions returning HOST values (dtype predicates and metadata):
#: their results never taint, so ``if torch.finfo(x.dtype).bits < 32``
#: stays static
_HOST_RESULT_MEMBERS = {
    "finfo",
    "iinfo",
    "is_tensor",
    "is_floating_point",
    "is_complex",
    "is_storage",
    "numel",
    "get_default_dtype",
    "promote_types",
    "result_type",
    "can_cast",
    "is_grad_enabled",
    "is_inference_mode_enabled",
    "device",
    "dtype",
    "Size",
    "typename",
}

#: torch functions that read tensor values on the host by construction
#: (they return Python bools)
_HOST_SYNC_MEMBERS = {"is_nonzero", "equal", "allclose"}

#: torch.linalg members that cannot be captured on the card: the batched
#: LU behind them (MAGMA's) synchronises with the host
_UNCAPTURABLE_LINALG = {"solve", "solve_ex", "lu_factor", "lu_factor_ex", "inv", "inv_ex", "det", "slogdet"}

#: torch functions / tensor methods whose result is a boolean mask when
#: fed tensor data
_BOOLISH_MEMBERS = {
    "isnan",
    "isinf",
    "isfinite",
    "isneginf",
    "isposinf",
    "logical_and",
    "logical_or",
    "logical_not",
    "logical_xor",
    "gt",
    "ge",
    "lt",
    "le",
    "eq",
    "ne",
    "greater",
    "greater_equal",
    "less",
    "less_equal",
    "not_equal",
    "isclose",
    "isin",
    "signbit",
}

#: tensor-method names that read values on the host / give a value-dependent
#: shape / return host metadata
_HOST_SYNC_METHODS = {
    "item",
    "tolist",
    "cpu",
    "numpy",
    "__array__",
    "__bool__",
    "__int__",
    "__float__",
    "__index__",
    "synchronize",
}
_DATA_DEP_METHODS = {"nonzero", "argwhere", "unique", "unique_consecutive", "masked_select", "bincount"}
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
    "is_pinned",
    "stride",
    "storage_offset",
    "data_ptr",
}

#: the capture rule's guard (``utils/checks.py``): True while an update is
#: probed or captured
_GUARD_CALLS = {"checks_read_nothing"}
#: context managers that turn the capture rule on for their body
_GUARD_CONTEXTS = {"capturing_checks"}

#: class names an ``isinstance`` test reads as "is a tensor"
_TENSOR_TYPES = {"Tensor"}
#: Python scalar types: an ``isinstance`` test on them selects host data
#: (containers may hold tensors)
_HOST_TYPES = {"int", "float", "bool", "str", "complex"}

#: builtins whose results are host/static values (superset of the rule-side
#: set: pure readers plus shape-free constructors)
_SAFE_HOST_BUILTINS = {
    "isinstance",
    "len",
    "getattr",
    "hasattr",
    "type",
    "range",
    "enumerate",
    "zip",
    "max",
    "min",
    "abs",
    "sum",
    "sorted",
    "reversed",
    "list",
    "tuple",
    "dict",
    "set",
    "str",
    "repr",
    "format",
    "print",
    "id",
    "round",
    "all",
    "any",
    "map",
    "filter",
    "super",
    "ValueError",
    "TypeError",
    "RuntimeError",
    "KeyError",
    "NotImplementedError",
}

_CAST_BUILTINS = {"float", "int", "bool", "complex"}

#: attributes that are static under capture
_STATIC_ATTRS = {
    "shape",
    "ndim",
    "dtype",
    "device",
    "is_cuda",
    "layout",
    "requires_grad",
    "is_sparse",
    "itemsize",
    "nbytes",
    "is_leaf",
    "is_meta",
    "_version",
}

#: resolution depth budget -- deep enough for the longest real chain
#: (metric update -> functional kernel -> input formatter -> per-case
#: checker -> validator -> leaf predicate) with headroom
_DEPTH_BUDGET = 8


def _last_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _attr_chain(node: ast.AST) -> List[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return []


def _mentions_guard(node: ast.AST) -> bool:
    """True when an expression calls the capture rule's guard."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and _last_name(sub.func) in _GUARD_CALLS:
            return True
    return False


def _capture_value(
    node: ast.AST, guards: Optional[Dict[str, bool]] = None, empty: FrozenSet[str] = frozenset()
) -> Optional[bool]:
    """The value a test takes while the update is probed or captured, when
    the guard decides it: ``checks_read_nothing()`` is True there, so
    ``G``/``G or ...`` are True and ``not G``/``not G and ...`` are False;
    ``guards`` gives the locals bound to the guard's value (``in_jit =
    checks_read_nothing()``), ``empty`` the locals empty under capture (the
    value stats), so ``"pmax" not in stats`` is True there and ``"pmax" in
    stats`` False. None when the test does not decide on the guard alone."""
    if isinstance(node, ast.Call) and _last_name(node.func) in _GUARD_CALLS:
        return True
    if isinstance(node, ast.Name):
        return (guards or {}).get(node.id)
    if (
        isinstance(node, ast.Compare)
        and len(node.ops) == 1
        and isinstance(node.ops[0], (ast.In, ast.NotIn))
        and isinstance(node.comparators[0], ast.Name)
        and node.comparators[0].id in empty
    ):
        return isinstance(node.ops[0], ast.NotIn)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
        inner = _capture_value(node.operand, guards, empty)
        return None if inner is None else not inner
    if isinstance(node, ast.BoolOp):
        values = [_capture_value(v, guards, empty) for v in node.values]
        if isinstance(node.op, ast.Or) and any(v is True for v in values):
            return True
        if isinstance(node.op, ast.And) and any(v is False for v in values):
            return False
    return None


def _always_raises(stmts: Sequence[ast.stmt]) -> bool:
    """Every terminal path of ``stmts`` ends in raise/return (a guard body)."""
    if not stmts:
        return False
    last = stmts[-1]
    if isinstance(last, (ast.Raise, ast.Return)):
        return True
    if isinstance(last, ast.If) and last.orelse:
        return _always_raises(last.body) and _always_raises(last.orelse)
    return False


def _only_raises(stmts: Sequence[ast.stmt]) -> bool:
    """Every terminal path of ``stmts`` ends in a raise."""
    if not stmts:
        return False
    last = stmts[-1]
    if isinstance(last, ast.Raise):
        return True
    if isinstance(last, ast.If) and last.orelse:
        return _only_raises(last.body) and _only_raises(last.orelse)
    return False


def _type_test(test: ast.AST) -> Optional[Tuple[str, bool, bool]]:
    """``(name, tensor?, positive?)`` for ``isinstance(name, T)`` /
    ``not isinstance(name, T)`` where every class in ``T`` is a tensor
    type (``tensor?`` True) or every one a host type (False); None for any
    other test."""
    positive = True
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        positive, test = False, test.operand
    if not (
        isinstance(test, ast.Call)
        and isinstance(test.func, ast.Name)
        and test.func.id == "isinstance"
        and len(test.args) == 2
        and isinstance(test.args[0], ast.Name)
    ):
        return None
    spec = test.args[1]
    names = [_last_name(e) for e in (spec.elts if isinstance(spec, ast.Tuple) else [spec])]
    if names and all(n in _TENSOR_TYPES for n in names):
        return test.args[0].id, True, positive
    if names and all(n in _HOST_TYPES for n in names):
        return test.args[0].id, False, positive
    return None



#: torch.distributed calls that wait for every process
_DIST_COLLECTIVES = {
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


def _to_host(node: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` / ``x.to(torch.device("cpu"))``."""
    targets = list(node.args[:1]) + [kw.value for kw in node.keywords if kw.arg == "device"]
    for t in targets:
        if isinstance(t, ast.Constant) and isinstance(t.value, str) and t.value.split(":")[0] == "cpu":
            return True
        if (
            isinstance(t, ast.Call)
            and _last_name(t.func) == "device"
            and t.args
            and isinstance(t.args[0], ast.Constant)
            and t.args[0].value == "cpu"
        ):
            return True
    return False


def _repeats_unbounded(node: ast.Call, arg_values: List["_Value"], kw_values: Dict, pos: int) -> bool:
    """``repeat_interleave`` with tensor repeats and no ``output_size``."""
    if "output_size" in kw_values:
        return False
    repeats = arg_values[pos] if len(arg_values) > pos else kw_values.get("repeats")
    return repeats is not None and repeats.tainted


def _is_literal(node: ast.AST) -> bool:
    """A Python constant, a negated one, or a list/tuple of them."""
    if isinstance(node, ast.Constant):
        return not isinstance(node.value, str)
    if isinstance(node, ast.UnaryOp) and isinstance(node.operand, ast.Constant):
        return True
    if isinstance(node, (ast.List, ast.Tuple)):
        return all(_is_literal(e) for e in node.elts)
    return False

# ---------------------------------------------------------------------------
# signals and verdicts
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Signal:
    """One abstract-interpretation finding inside an update's call graph."""

    kind: str  # one of _SIGNAL_KINDS
    detail: str
    conditional: bool  # found under a host-config branch that may be dead
    line: int = 0


@dataclass(frozen=True)
class Verdict:
    """Static fusibility classification of one metric class."""

    status: str  # fusible | unsafe | unknown
    reason: Optional[str] = None  # unsafe reason (cat-growth | host-sync | data-dependent-shape)
    detail: Optional[str] = None  # human-readable context for the verdict

    def to_dict(self) -> Dict[str, Optional[str]]:
        return {"status": self.status, "reason": self.reason, "detail": self.detail}


def verdict_from_signals(signals: Sequence[Signal]) -> Verdict:
    """Definitive (unconditional) unsafe signals decide; anything weaker --
    conditional unsafety, unresolved calls, uncaught trace-time raises --
    degrades to ``unknown`` so the runtime probe stays the authority; a
    silent scan is ``fusible``."""
    for sig in signals:
        if sig.kind not in ("unknown", "trace-raise") and not sig.conditional:
            return Verdict(VERDICT_UNSAFE, sig.kind, sig.detail)
    if signals:
        first = signals[0]
        return Verdict(
            VERDICT_UNKNOWN,
            None,
            f"{first.kind}: {first.detail}" if first.kind != "unknown" else first.detail,
        )
    return Verdict(VERDICT_FUSIBLE)


# ---------------------------------------------------------------------------
# abstract values
# ---------------------------------------------------------------------------

@dataclass
class _Value:
    tainted: bool = False
    noneness: str = _MAYBE
    boolish: bool = False
    #: element-wise values when this abstracts a tuple (a canonicalizer's
    #: `(preds, target, mode)` return) -- lets tuple unpacking keep a host
    #: element (the mode enum) untainted beside traced tensors
    elts: Optional[List["_Value"]] = None
    #: a Python container (list, tuple, dict) of tensors: its truthiness is
    #: its length, a host fact
    container: bool = False
    #: a container that is empty while the update is probed or captured: an
    #: empty literal, or a value reader's result (``_value_stats`` returns
    #: ``{}`` under ``checks_read_nothing()``), so ``"k" in it`` is False there
    capture_empty: bool = False


_HOST = _Value(tainted=False, noneness=_NOT_NONE)


@dataclass
class _Env:
    """Per-function abstract store."""

    traced: Set[str] = field(default_factory=set)
    boolmask: Set[str] = field(default_factory=set)
    noneness: Dict[str, str] = field(default_factory=dict)
    states: Set[str] = field(default_factory=set)  # traced self.<attr> names
    list_states: Set[str] = field(default_factory=set)  # may-be-list self attrs
    #: locals bound to the guard's value (``in_jit = checks_read_nothing()``)
    #: -> the value they hold under capture
    guards: Dict[str, bool] = field(default_factory=dict)
    #: locals holding Python containers (see ``_Value.container``)
    containers: Set[str] = field(default_factory=set)
    #: locals empty under capture (see ``_Value.capture_empty``)
    capture_empty: Set[str] = field(default_factory=set)

    def value_of(self, name: str) -> _Value:
        return _Value(
            tainted=name in self.traced,
            noneness=self.noneness.get(name, _MAYBE),
            boolish=name in self.boolmask,
            container=name in self.containers,
            capture_empty=name in self.capture_empty,
        )

    def truthiness_reads_tensor(self, test: ast.AST, value: "_Value") -> bool:
        """Whether ``if test`` reads a tensor value: not for a container's
        truthiness (``if parts``, ``if not parts``), which is its length."""
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            test = test.operand
        if isinstance(test, ast.Name) and test.id in self.containers:
            return False
        return value.tainted

    def bind(self, name: str, value: _Value) -> None:
        if value.tainted:
            self.traced.add(name)
        else:
            self.traced.discard(name)
        if value.boolish:
            self.boolmask.add(name)
        else:
            self.boolmask.discard(name)
        self.noneness[name] = value.noneness
        self.guards.pop(name, None)
        if value.container:
            self.containers.add(name)
        else:
            self.containers.discard(name)
        if value.capture_empty:
            self.capture_empty.add(name)
        else:
            self.capture_empty.discard(name)

    def capture_value(self, node: ast.AST) -> Optional[bool]:
        """:func:`_capture_value` with this function's guard-valued locals
        and its locals that are empty under capture."""
        return _capture_value(node, self.guards, self.capture_empty)

    def snapshot(self) -> "_Env":
        return _Env(
            traced=set(self.traced),
            boolmask=set(self.boolmask),
            noneness=dict(self.noneness),
            states=self.states,  # shared: never mutated during a scan
            list_states=self.list_states,
            guards=dict(self.guards),
            containers=set(self.containers),
            capture_empty=set(self.capture_empty),
        )

    def absorb_branches(self, a: "_Env", b: "_Env") -> None:
        """Join two branch environments back into this one: taint unions
        (conservative), None-ness meets (agreement survives, disagreement
        decays to maybe) -- so a binding in ONE branch can never mask the
        other branch's path (`num_classes = preds.shape[1]` in the float
        branch must not kill the label branch's None check)."""
        self.traced.clear()
        self.traced.update(a.traced | b.traced)
        self.boolmask.clear()
        self.boolmask.update(a.boolmask | b.boolmask)
        merged: Dict[str, str] = {}
        for key in set(a.noneness) | set(b.noneness):
            va = a.noneness.get(key, _MAYBE)
            vb = b.noneness.get(key, _MAYBE)
            merged[key] = va if va == vb else _MAYBE
        self.noneness.clear()
        self.noneness.update(merged)
        guards = {k: v for k, v in a.guards.items() if b.guards.get(k) == v}
        self.guards.clear()
        self.guards.update(guards)
        containers = a.containers & b.containers
        self.containers.clear()
        self.containers.update(containers)
        empty = a.capture_empty & b.capture_empty
        self.capture_empty.clear()
        self.capture_empty.update(empty)


# ---------------------------------------------------------------------------
# cross-file resolution
# ---------------------------------------------------------------------------

class Project:
    """Parse-once view of the package for cross-file symbol resolution.

    Modules are addressed package-relative (``functional/classification/
    accuracy.py``); ``from metrics_tpu_torch.x.y import f`` (or the relative
    equivalent) resolves ``f`` to its def in ``x/y.py``, following one
    ``__init__.py`` re-export hop.
    """

    def __init__(self, root: Optional[pathlib.Path] = None) -> None:
        self.root = pathlib.Path(root) if root is not None else default_package_root()
        self._ctx_cache: Dict[str, Optional[FileContext]] = {}
        self._import_cache: Dict[int, Dict[str, Tuple[str, str]]] = {}
        self._summary_cache: Dict[Tuple, Tuple[List[Signal], bool, str]] = {}
        self._in_progress: Set[Tuple] = set()

    # -- file / module access ------------------------------------------
    def ctx(self, relpath: str) -> Optional[FileContext]:
        cached = self._ctx_cache.get(relpath, _MISSING)
        if cached is not _MISSING:
            return cached
        path = self.root / relpath
        ctx: Optional[FileContext] = None
        if path.is_file():
            try:
                ctx = FileContext(path, relpath, path.read_text())
            except (SyntaxError, UnicodeDecodeError):
                ctx = None
        self._ctx_cache[relpath] = ctx
        return ctx

    def module_relpath(self, module: str) -> Optional[str]:
        """``metrics_tpu.functional.x`` -> ``functional/x.py`` (or the
        package ``__init__.py``); None for out-of-package modules."""
        if module == PACKAGE_NAME:
            return "__init__.py"
        prefix = PACKAGE_NAME + "."
        if not module.startswith(prefix):
            return None
        tail = module[len(prefix):].replace(".", "/")
        if (self.root / (tail + ".py")).is_file():
            return tail + ".py"
        if (self.root / tail / "__init__.py").is_file():
            return tail + "/__init__.py"
        return None

    def imports_of(self, ctx: FileContext) -> Dict[str, Tuple[str, str]]:
        """bound name -> (absolute module, original name) for every
        ``from <in-package module> import name [as bound]`` in ``ctx``."""
        cached = self._import_cache.get(id(ctx))
        if cached is not None:
            return cached
        out: Dict[str, Tuple[str, str]] = {}
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ImportFrom):
                continue
            module = node.module or ""
            if node.level:
                # relative import: resolve against the file's package path
                parts = ctx.relpath.split("/")[:-1]
                if node.level - 1:
                    parts = parts[: -(node.level - 1)] if node.level - 1 <= len(parts) else []
                base = ".".join([PACKAGE_NAME] + parts)
                module = f"{base}.{module}" if module else base
            if not (module == PACKAGE_NAME or module.startswith(PACKAGE_NAME + ".")):
                continue
            for alias in node.names:
                out[alias.asname or alias.name] = (module, alias.name)
        self._import_cache[id(ctx)] = out
        return out

    def _find_def(self, ctx: FileContext, name: str, kind) -> Optional[Tuple[FileContext, ast.AST]]:
        for node in ctx.tree.body:
            if isinstance(node, kind) and node.name == name:
                return ctx, node
        return None

    def resolve_function(
        self, ctx: FileContext, name: str, _hops: int = 4
    ) -> Optional[Tuple[FileContext, ast.FunctionDef]]:
        """Find the def of ``name`` visible from ``ctx``: same module first,
        then module-level rebindings (``_kappa_update = _confmat_update``),
        then in-package ``from`` imports (one ``__init__`` hop)."""
        found = self._find_def(ctx, name, ast.FunctionDef)
        if found is not None:
            return found  # type: ignore[return-value]
        if _hops > 0:
            for node in ctx.tree.body:
                if (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == name
                    and isinstance(node.value, ast.Name)
                ):
                    return self.resolve_function(ctx, node.value.id, _hops - 1)
        target = self.imports_of(ctx).get(name)
        if target is None or _hops <= 0:
            return None
        relpath = self.module_relpath(target[0])
        if relpath is None:
            return None
        tctx = self.ctx(relpath)
        if tctx is None or tctx is ctx:
            return None
        return self.resolve_function(tctx, target[1], _hops - 1)

    def resolve_class(
        self, ctx: FileContext, name: str, _hops: int = 4
    ) -> Optional[Tuple[FileContext, ast.ClassDef]]:
        found = self._find_def(ctx, name, ast.ClassDef)
        if found is not None:
            return found  # type: ignore[return-value]
        target = self.imports_of(ctx).get(name)
        if target is None or _hops <= 0:
            return None
        relpath = self.module_relpath(target[0])
        if relpath is None:
            return None
        tctx = self.ctx(relpath)
        if tctx is None or tctx is ctx:
            return None
        return self.resolve_class(tctx, target[1], _hops - 1)


class _Missing:
    pass


_MISSING = _Missing()


# ---------------------------------------------------------------------------
# the abstract interpreter
# ---------------------------------------------------------------------------

class _Scanner:
    """Walks one function body collecting :class:`Signal`s, tracking the
    taint / None-ness / bool-ness lattice, resolving in-package calls."""

    def __init__(self, project: Project, ctx: FileContext, depth: int) -> None:
        self.project = project
        self.ctx = ctx
        self.depth = depth
        self.signals: List[Signal] = []
        self.return_value = _Value(tainted=False, noneness=_NOT_NONE)
        self._saw_return = False
        self._returned_once = False
        #: >0 while scanning a `try` body that has except handlers: callees'
        #: capture-time raises are caught here, so their "trace-raise"
        #: signals are dropped at this call site
        self._shielded = 0
        #: helpers defined in the scanned body, by name
        self._local_fns: Dict[str, ast.FunctionDef] = {}
        #: locals naming a torch function (`reduce = torch.amax`)
        self._fn_aliases: Dict[str, List[str]] = {}
        #: local helpers being scanned (recursion guard)
        self._local_active: FrozenSet[str] = frozenset()

    # -- entry points --------------------------------------------------
    def scan(self, fn: ast.FunctionDef, env: _Env) -> None:
        self._scan_stmts(fn.body, env, conditional=False)

    def _emit(self, kind: str, detail: str, conditional: bool, node: ast.AST) -> None:
        self.signals.append(
            Signal(kind=kind, detail=detail, conditional=conditional, line=getattr(node, "lineno", 0))
        )

    # -- statements ----------------------------------------------------
    def _scan_stmts(self, stmts: Sequence[ast.stmt], env: _Env, conditional: bool) -> None:
        for i, stmt in enumerate(stmts):
            if isinstance(stmt, ast.If):
                stop = self._scan_if(stmt, env, conditional)
                if stop == _HOST_REST:
                    # the rest of the block runs for host data only
                    self._scan_stmts(stmts[i + 1 :], env, True)
                    return
                if stop:
                    return  # remainder is eager-only (the guard's early return)
            elif isinstance(stmt, ast.While):
                test = self._eval(stmt.test, env, conditional)
                if test.tainted:
                    self._emit(
                        REASON_HOST_SYNC,
                        "Python `while` on a tensor value reads it on the host",
                        conditional,
                        stmt,
                    )
                self._scan_stmts(stmt.body, env, True)
                self._scan_stmts(stmt.orelse, env, True)
            elif isinstance(stmt, ast.For):
                it = self._eval(stmt.iter, env, conditional)
                self._bind_target(stmt.target, _Value(tainted=it.tainted, noneness=_NOT_NONE), env)
                self._scan_stmts(stmt.body, env, conditional)
                self._scan_stmts(stmt.orelse, env, conditional)
            elif isinstance(stmt, ast.Try):
                if stmt.handlers:
                    self._shielded += 1
                try:
                    self._scan_stmts(stmt.body, env, conditional)
                finally:
                    if stmt.handlers:
                        self._shielded -= 1
                for handler in stmt.handlers:
                    self._scan_stmts(handler.body, env, True)
                self._scan_stmts(stmt.orelse, env, conditional)
                self._scan_stmts(stmt.finalbody, env, conditional)
            elif isinstance(stmt, ast.With):
                for item in stmt.items:
                    self._eval(item.context_expr, env, conditional)
                self._scan_stmts(stmt.body, env, conditional)
            elif isinstance(stmt, ast.Assign):
                value = self._eval(stmt.value, env, conditional)
                for tgt in stmt.targets:
                    self._scan_state_write(tgt, stmt.value, env, conditional)
                    self._bind_target(tgt, value, env)
                if len(stmt.targets) == 1 and isinstance(stmt.targets[0], ast.Name):
                    target = stmt.targets[0].id
                    guard = env.capture_value(stmt.value)
                    if guard is not None:
                        env.guards[target] = guard
                    path = self._torch_function(stmt.value)
                    if path is not None:
                        self._fn_aliases[target] = path
                    else:
                        self._fn_aliases.pop(target, None)
            elif isinstance(stmt, ast.AugAssign):
                value = self._eval(stmt.value, env, conditional)
                if isinstance(stmt.target, ast.Name):
                    prev = env.value_of(stmt.target.id)
                    env.bind(
                        stmt.target.id,
                        _Value(tainted=prev.tainted or value.tainted, noneness=_NOT_NONE),
                    )
            elif isinstance(stmt, ast.AnnAssign):
                if stmt.value is not None:
                    value = self._eval(stmt.value, env, conditional)
                    self._scan_state_write(stmt.target, stmt.value, env, conditional)
                    self._bind_target(stmt.target, value, env)
            elif isinstance(stmt, ast.Return):
                self._saw_return = True
                if stmt.value is not None:
                    value = self._eval(stmt.value, env, conditional)
                    first = not self._returned_once
                    if first:
                        merged_elts = value.elts
                    elif (
                        self.return_value.elts is not None
                        and value.elts is not None
                        and len(self.return_value.elts) == len(value.elts)
                    ):
                        merged_elts = [
                            _Value(
                                tainted=a.tainted or b.tainted,
                                noneness=a.noneness if a.noneness == b.noneness else _MAYBE,
                                capture_empty=a.capture_empty and b.capture_empty,
                            )
                            for a, b in zip(self.return_value.elts, value.elts)
                        ]
                    else:
                        merged_elts = None  # mixed return shapes: whole-tuple taint
                    self.return_value = _Value(
                        tainted=self.return_value.tainted or value.tainted,
                        noneness=value.noneness if not self._saw_return else _MAYBE
                        if self.return_value.noneness != value.noneness
                        else value.noneness,
                        elts=merged_elts,
                        capture_empty=value.capture_empty and (first or self.return_value.capture_empty),
                    )
                    self._returned_once = True
            elif isinstance(stmt, ast.Expr):
                self._eval(stmt.value, env, conditional)
            elif isinstance(stmt, ast.Assert):
                test = self._eval(stmt.test, env, conditional)
                if test.tainted:
                    self._emit(
                        REASON_HOST_SYNC,
                        "`assert` on a tensor value reads it on the host",
                        conditional,
                        stmt,
                    )
            elif isinstance(stmt, ast.Raise):
                if stmt.exc is not None:
                    self._eval(stmt.exc, env, conditional)
            elif isinstance(stmt, ast.FunctionDef):
                # a local helper: scanned where it is called, with the
                # enclosing bindings it closes over
                self._local_fns[stmt.name] = stmt
            elif isinstance(stmt, (ast.AsyncFunctionDef, ast.ClassDef)):
                continue  # out of scope for the update surface
            else:
                continue

    #: when set (the class's __exact_mode_attr__), branches testing
    #: `self.<attr>` are the opt-in exact mode: runtime-guarded, excluded
    #: from the default-mode verdict this scan produces
    exact_attr: Optional[str] = None

    #: attribute names from __traced_callable_attrs__: `self.<attr>(...)`
    #: is modeled as a traced-pure array program (the ctor installs a
    #: traceable callable there by contract; a violating user install is
    #: caught at runtime by the fused dispatcher's stale-manifest demotion)
    traced_callable_attrs: FrozenSet[str] = frozenset()

    def _exact_branch_side(self, test: ast.AST) -> Optional[str]:
        """\"body\" when `if self.<exact_attr>:` selects the exact mode in
        its body, \"orelse\" for the negated spelling, None otherwise."""
        attr = self.exact_attr
        if attr is None:
            return None

        def is_exact_ref(node: ast.AST) -> bool:
            if isinstance(node, ast.Attribute) and node.attr == attr:
                return isinstance(node.value, ast.Name) and node.value.id == "self"
            return isinstance(node, ast.Name) and node.id == attr

        if is_exact_ref(test):
            return "body"
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not) and is_exact_ref(test.operand):
            return "orelse"
        return None

    def _scan_if(self, stmt: ast.If, env: _Env, conditional: bool) -> object:
        """Returns True when the remainder of the enclosing block is
        eager-only (the ``if checks_read_nothing(): return`` idiom),
        :data:`_HOST_REST` when it runs for host data only."""
        exact_side = self._exact_branch_side(stmt.test)
        if exact_side is not None:
            # declared mode split: only the default (sketch) side counts
            # toward the class verdict; the exact side is runtime-guarded
            self._scan_stmts(
                stmt.orelse if exact_side == "body" else stmt.body, env, conditional
            )
            return False
        captured = env.capture_value(stmt.test)
        if captured is not None:
            # the capture rule's guard decides this test in a probed or
            # captured update: only that side runs there, the other is
            # eager-only by contract
            if captured and _only_raises(stmt.body) and not self._shielded:
                # a raise the guard selects: this configuration FAILS in
                # every captured update; an enclosing try/except owns the
                # failure, otherwise the fusible verdict is blocked
                self._emit(
                    "trace-raise",
                    "reachable raise under `checks_read_nothing()` fails every captured update "
                    "for some input configurations",
                    conditional,
                    stmt,
                )
            self._scan_stmts(stmt.body if captured else stmt.orelse, env, conditional)
            # `if checks_read_nothing(): return ...`: the rest of the block
            # runs only when the update is not captured
            return captured and _always_raises(stmt.body)
        typed = _type_test(stmt.test)
        if typed is not None:
            # `isinstance(x, Tensor)` dispatch: on the side where `x` is
            # not a tensor it holds host data (a caller's list or scalar).
            # A tensor argument takes the tensor side: scanned as the path
            # it is; the host side is conditional
            name, is_tensor, positive = typed
            host_is_body = is_tensor != positive
            env_body = env.snapshot()
            env_orelse = env.snapshot()
            (env_body if host_is_body else env_orelse).bind(
                name, _Value(tainted=False, noneness=env.noneness.get(name, _MAYBE))
            )
            taken = is_tensor and env.value_of(name).tainted
            self._scan_stmts(stmt.body, env_body, conditional if taken and not host_is_body else True)
            self._scan_stmts(stmt.orelse, env_orelse, conditional if taken and host_is_body else True)
            if _always_raises(stmt.body) and not stmt.orelse:
                # the rest of the block runs on the orelse side only
                env.absorb_branches(env_orelse, env_orelse)
                return _HOST_REST if taken and not host_is_body else False
            env.absorb_branches(env_body, env_orelse)
            return False

        # statically-dead branch elimination on None-ness
        live = self._liveness(stmt.test, env)
        if live == "body":
            self._scan_stmts(stmt.body, env, conditional)
            return False
        if live == "orelse":
            self._scan_stmts(stmt.orelse, env, conditional)
            return False

        test = self._eval(stmt.test, env, conditional)
        is_type_dispatch = any(
            isinstance(sub, ast.Call) and _last_name(sub.func) == "isinstance"
            for sub in ast.walk(stmt.test)
        )
        if env.truthiness_reads_tensor(stmt.test, test) and not is_type_dispatch:
            self._emit(
                REASON_HOST_SYNC,
                "Python `if` on a tensor value reads it on the host",
                conditional,
                stmt,
            )
        # isolated branch environments, joined on exit -- bindings from one
        # branch must not leak into (and mask) the other
        env_body = env.snapshot()
        env_orelse = env.snapshot()
        self._scan_stmts(stmt.body, env_body, True)
        self._scan_stmts(stmt.orelse, env_orelse, True)
        env.absorb_branches(env_body, env_orelse)
        return False

    def _liveness(self, test: ast.AST, env: _Env) -> Optional[str]:
        """Which branch of ``if test`` is statically live, when decidable
        from None-ness: `x is None` / `x is not None` / bare `x` / `not x`
        with x's None-ness known."""
        def name_noneness(node: ast.AST) -> Optional[str]:
            if isinstance(node, ast.Name):
                return env.noneness.get(node.id, _MAYBE)
            return None

        if isinstance(test, ast.Compare) and len(test.ops) == 1 and len(test.comparators) == 1:
            left, right = test.left, test.comparators[0]
            is_none_cmp = isinstance(right, ast.Constant) and right.value is None
            if is_none_cmp:
                nn = name_noneness(left)
                if isinstance(test.ops[0], ast.Is):
                    if nn == _NONE:
                        return "body"
                    if nn == _NOT_NONE:
                        return "orelse"
                elif isinstance(test.ops[0], ast.IsNot):
                    if nn == _NONE:
                        return "orelse"
                    if nn == _NOT_NONE:
                        return "body"
        if isinstance(test, ast.Name) and env.noneness.get(test.id) == _NONE:
            return "orelse"  # `if x:` with x known-None is statically false
        if (
            isinstance(test, ast.UnaryOp)
            and isinstance(test.op, ast.Not)
            and isinstance(test.operand, ast.Name)
            and env.noneness.get(test.operand.id) == _NONE
        ):
            return "body"  # `if not x:` with x known-None
        return None

    def _bind_target(self, tgt: ast.AST, value: _Value, env: _Env) -> None:
        if isinstance(tgt, ast.Name):
            env.bind(tgt.id, value)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            if value.elts is not None and len(value.elts) == len(tgt.elts):
                # element-wise tuple taint (a resolved callee returning
                # `(traced, traced, host_mode)` must not taint the mode)
                for el, ev in zip(tgt.elts, value.elts):
                    self._bind_target(el, ev, env)
                return
            for el in tgt.elts:
                self._bind_target(el, _Value(tainted=value.tainted, noneness=_MAYBE), env)
        elif isinstance(tgt, ast.Starred):
            self._bind_target(tgt.value, value, env)
        # attribute/subscript targets carry no local binding

    def _scan_state_write(self, tgt: ast.AST, rhs: ast.AST, env: _Env, conditional: bool) -> None:
        """Assignment to a registered state: growing the array (concatenate
        with itself) is the array-state spelling of cat-growth."""
        if not (
            isinstance(tgt, ast.Attribute)
            and isinstance(tgt.value, ast.Name)
            and tgt.value.id == "self"
            and tgt.attr in env.states
        ):
            return
        for sub in ast.walk(rhs):
            if isinstance(sub, ast.Call) and _last_name(sub.func) in {
                "cat",
                "concat",
                "concatenate",
                "stack",
                "append",
                "hstack",
                "vstack",
            }:
                mentions_state = any(
                    isinstance(n, ast.Attribute)
                    and n.attr == tgt.attr
                    and isinstance(n.value, ast.Name)
                    and n.value.id == "self"
                    for a in list(sub.args) + [kw.value for kw in sub.keywords]
                    for n in ast.walk(a)
                )
                if mentions_state:
                    self._emit(
                        REASON_CAT_GROWTH,
                        f"state `{tgt.attr}` grows by concatenation each update",
                        conditional,
                        sub,
                    )

    # -- expressions ---------------------------------------------------
    def _eval(self, node: ast.AST, env: _Env, conditional: bool) -> _Value:
        if isinstance(node, ast.Constant):
            return _Value(tainted=False, noneness=_NONE if node.value is None else _NOT_NONE)
        if isinstance(node, ast.Name):
            return env.value_of(node.id)
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                self._eval(node.value, env, conditional)  # still visit for signals
                return _Value(tainted=False, noneness=_NOT_NONE)
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                return _Value(tainted=node.attr in env.states, noneness=_MAYBE)
            base = self._eval(node.value, env, conditional)
            return _Value(tainted=base.tainted, noneness=_MAYBE)
        if isinstance(node, ast.Call):
            return self._eval_call(node, env, conditional)
        if isinstance(node, (ast.Tuple, ast.List)) and not isinstance(node.ctx, ast.Store):
            elts = [self._eval(e, env, conditional) for e in node.elts]
            return _Value(
                tainted=any(v.tainted for v in elts),
                noneness=_NOT_NONE,
                elts=elts if isinstance(node, ast.Tuple) else None,
                container=True,
            )
        if isinstance(node, ast.Compare):
            values = [self._eval(node.left, env, conditional)] + [
                self._eval(c, env, conditional) for c in node.comparators
            ]
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in node.ops):
                return _Value(tainted=False, noneness=_NOT_NONE)
            tainted = any(v.tainted for v in values)
            return _Value(tainted=tainted, noneness=_NOT_NONE, boolish=tainted)
        if isinstance(node, (ast.BinOp,)):
            left = self._eval(node.left, env, conditional)
            right = self._eval(node.right, env, conditional)
            boolish = (left.boolish or right.boolish) and isinstance(
                node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)
            )
            return _Value(tainted=left.tainted or right.tainted, noneness=_NOT_NONE, boolish=boolish)
        if isinstance(node, ast.UnaryOp):
            operand = self._eval(node.operand, env, conditional)
            return _Value(tainted=operand.tainted, noneness=_NOT_NONE, boolish=operand.boolish)
        if isinstance(node, ast.BoolOp):
            values = []
            for operand in node.values:
                values.append(self._eval(operand, env, conditional))
                if env.capture_value(operand) is isinstance(node.op, ast.Or):
                    break  # the guard short-circuits the rest under capture
            return _Value(
                tainted=any(v.tainted for v in values),
                noneness=_MAYBE,
                boolish=any(v.boolish for v in values),
            )
        if isinstance(node, ast.IfExp):
            captured = env.capture_value(node.test)
            if captured is not None:
                # the guard picks the side a captured update evaluates
                return self._eval(node.body if captured else node.orelse, env, conditional)
            typed = _type_test(node.test)
            if typed is not None:
                # `a if isinstance(x, Tensor) else b`: `x` is host data in
                # the side where it is not a tensor
                name, is_tensor, positive = typed
                host_env = env.snapshot()
                host_env.bind(name, _Value(tainted=False, noneness=env.noneness.get(name, _MAYBE)))
                body_env, orelse_env = (env, host_env) if is_tensor == positive else (host_env, env)
                body = self._eval(node.body, body_env, conditional)
                orelse = self._eval(node.orelse, orelse_env, conditional)
                return _Value(
                    tainted=body.tainted or orelse.tainted,
                    noneness=body.noneness if body.noneness == orelse.noneness else _MAYBE,
                )
            test = self._eval(node.test, env, conditional)
            if env.truthiness_reads_tensor(node.test, test):
                self._emit(
                    REASON_HOST_SYNC,
                    "conditional expression on a tensor value reads it on the host",
                    conditional,
                    node,
                )
            body = self._eval(node.body, env, conditional)
            orelse = self._eval(node.orelse, env, conditional)
            return _Value(
                tainted=body.tainted or orelse.tainted,
                noneness=body.noneness if body.noneness == orelse.noneness else _MAYBE,
            )
        if isinstance(node, ast.Subscript):
            base = self._eval(node.value, env, conditional)
            self._scan_subscript(node, base, env, conditional)
            # `x.shape[i]` yields an int, never None; general subscripts
            # (dict lookups) stay maybe-None
            shape_like = (
                isinstance(node.value, ast.Attribute) and node.value.attr in _STATIC_ATTRS
            )
            return _Value(
                tainted=base.tainted, noneness=_NOT_NONE if shape_like else _MAYBE
            )
        if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
            values = [self._eval(el, env, conditional) for el in node.elts]
            return _Value(tainted=any(v.tainted for v in values), noneness=_NOT_NONE)
        if isinstance(node, ast.Dict):
            tainted = False
            for k, v in zip(node.keys, node.values):
                if k is not None:
                    tainted |= self._eval(k, env, conditional).tainted
                tainted |= self._eval(v, env, conditional).tainted
            return _Value(tainted=tainted, noneness=_NOT_NONE, container=True, capture_empty=not node.keys)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)):
            tainted = False
            for gen in node.generators:
                it = self._eval(gen.iter, env, conditional)
                self._bind_target(gen.target, _Value(tainted=it.tainted, noneness=_NOT_NONE), env)
                tainted |= it.tainted
                for cond in gen.ifs:
                    cv = self._eval(cond, env, conditional)
                    if cv.tainted:
                        self._emit(
                            REASON_DATA_SHAPE,
                            "comprehension filtered on a traced value has a data-dependent length",
                            conditional,
                            cond,
                        )
            if isinstance(node, ast.DictComp):
                tainted |= self._eval(node.key, env, conditional).tainted
                tainted |= self._eval(node.value, env, conditional).tainted
            else:
                tainted |= self._eval(node.elt, env, conditional).tainted
            return _Value(tainted=tainted, noneness=_NOT_NONE, container=not isinstance(node, ast.GeneratorExp))
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                if isinstance(v, ast.FormattedValue):
                    fv = self._eval(v.value, env, conditional)
                    if fv.tainted:
                        self._emit(
                            REASON_HOST_SYNC,
                            "f-string interpolation of a traced value reads it on host",
                            conditional,
                            v,
                        )
            return _Value(tainted=False, noneness=_NOT_NONE)
        if isinstance(node, ast.NamedExpr):
            value = self._eval(node.value, env, conditional)
            self._bind_target(node.target, value, env)
            return value
        if isinstance(node, ast.Starred):
            return self._eval(node.value, env, conditional)
        if isinstance(node, ast.Lambda):
            return _Value(tainted=False, noneness=_NOT_NONE)
        if isinstance(node, ast.Slice):
            for part in (node.lower, node.upper, node.step):
                if part is not None:
                    self._eval(part, env, conditional)
            return _Value(tainted=False, noneness=_NOT_NONE)
        # unhandled expression kinds: visit children conservatively
        tainted = False
        for child in ast.iter_child_nodes(node):
            tainted |= self._eval(child, env, conditional).tainted
        return _Value(tainted=tainted, noneness=_MAYBE)

    def _scan_subscript(self, node: ast.Subscript, base: _Value, env: _Env, conditional: bool) -> None:
        sl = node.slice
        parts: List[ast.AST]
        if isinstance(sl, ast.Tuple):
            parts = list(sl.elts)
        else:
            parts = [sl]
        for part in parts:
            if isinstance(part, ast.Slice):
                for bound in (part.lower, part.upper, part.step):
                    if bound is None:
                        continue
                    bv = self._eval(bound, env, conditional)
                    if bv.tainted and base.tainted:
                        self._emit(
                            REASON_DATA_SHAPE,
                            "slice bound derived from traced data gives a data-dependent shape",
                            conditional,
                            part,
                        )
            else:
                pv = self._eval(part, env, conditional)
                if base.tainted and pv.tainted and pv.boolish:
                    self._emit(
                        REASON_DATA_SHAPE,
                        "boolean-mask indexing selects a data-dependent number of elements",
                        conditional,
                        part,
                    )

    # -- calls ----------------------------------------------------------
    def _eval_call(self, node: ast.Call, env: _Env, conditional: bool) -> _Value:
        func = node.func
        arg_values = [self._eval(a, env, conditional) for a in node.args]
        kw_values = {kw.arg: self._eval(kw.value, env, conditional) for kw in node.keywords}
        any_taint = any(v.tainted for v in arg_values) or any(
            v.tainted for v in kw_values.values()
        )

        if isinstance(func, ast.Name):
            name = func.id
            if name in _GUARD_CALLS or name in _GUARD_CONTEXTS:
                return _Value(tainted=False, noneness=_NOT_NONE)
            if name in _CAST_BUILTINS:
                if any_taint:
                    self._emit(
                        REASON_HOST_SYNC,
                        f"`{name}()` on a tensor value reads it on the host",
                        conditional,
                        node,
                    )
                return _Value(tainted=False, noneness=_NOT_NONE)
            if name in _SAFE_HOST_BUILTINS:
                # container/iteration builtins preserve taint of their input
                keeps = name in {"sum", "max", "min", "abs", "list", "tuple", "sorted", "reversed"}
                return _Value(tainted=any_taint and keeps, noneness=_NOT_NONE)
            if name in self._local_fns:
                return self._local_call(name, node, arg_values, kw_values, env, conditional)
            if name in self._fn_aliases:
                return self._torch_module_call(self._fn_aliases[name], node, arg_values, kw_values, any_taint, conditional)
            if name == "setattr":
                return _Value(tainted=False, noneness=_NONE)
            if name in self.ctx.torch_member_imports:
                return self._torch_call(self.ctx.torch_member_imports[name], node, arg_values, kw_values, conditional)
            if name in self.ctx.numpy_member_imports:
                if any_taint:
                    self._emit(
                        REASON_HOST_SYNC,
                        f"numpy `{name}` on a tensor value copies it to the host",
                        conditional,
                        node,
                    )
                return _Value(tainted=False, noneness=_NOT_NONE)
            resolved = self.project.resolve_function(self.ctx, name)
            if resolved is not None:
                if resolved[0].relpath.startswith("ops/"):
                    # a kernel entry point of ops/: routed on host-static
                    # facts, a fixed-shape program on every route
                    return _Value(tainted=True, noneness=_NOT_NONE)
                return self._resolved_call(resolved, node, arg_values, kw_values, conditional)
            if any_taint:
                # an "unknown" signal already blocks the fusible verdict, so
                # the result is modeled untainted: propagating taint out of a
                # hole would cascade into FALSE unconditional unsafe signals
                # downstream (`if` on the artifact), turning unknown into a
                # wrong unsafe verdict
                self._emit(
                    "unknown",
                    f"unresolved call `{name}` receives traced values",
                    conditional,
                    node,
                )
            return _Value(tainted=False, noneness=_MAYBE)

        if isinstance(func, ast.Attribute):
            chain = _attr_chain(func)
            root = chain[0] if chain else None
            member = func.attr
            # module-rooted calls
            if root is not None and len(chain) >= 2:
                if root in self.ctx.torch_aliases:
                    return self._torch_module_call(chain[1:], node, arg_values, kw_values, any_taint, conditional)
                if root in self.ctx.functional_aliases:
                    return self._functional_call(member, node, kw_values, conditional)
                if root in self.ctx.dist_aliases:
                    return self._dist_call(chain, node, conditional)
                if root in self.ctx.numpy_aliases:
                    if any_taint:
                        self._emit(
                            REASON_HOST_SYNC,
                            f"`{root}.{member}` on a tensor value copies it to the host",
                            conditional,
                            node,
                        )
                    return _Value(tainted=False, noneness=_NOT_NONE)
                if chain == ["object", "__setattr__"]:
                    return _Value(tainted=False, noneness=_NONE)
                if len(chain) == 2:
                    # `module.fn(...)` through an in-package module import
                    # (`from metrics_tpu_torch.utils import prng`)
                    resolved = self._module_function(root, member)
                    if resolved is not None:
                        if resolved[0].relpath.startswith("ops/"):
                            return _Value(tainted=True, noneness=_NOT_NONE)
                        return self._resolved_call(resolved, node, arg_values, kw_values, conditional)
            # self.<method>(...) -- resolve within the class chain if bound
            # (resolved BEFORE the dispatched-ops name check: a class's own
            # method shadowing one of those names must still be descended)
            if (
                isinstance(func.value, ast.Name)
                and func.value.id == "self"
                and self._method_resolver is not None
            ):
                if member == "add_state":
                    return _Value(tainted=False, noneness=_NOT_NONE)  # the registry: host bookkeeping
                resolved = self._method_resolver(member)
                if resolved is not None:
                    return self._resolved_call(resolved, node, arg_values, kw_values, conditional, skip_self=True)
                if member in self.traced_callable_attrs:
                    # declared traced callable attribute (a torch feature
                    # extractor module): a pure tensor -> tensor program
                    return _Value(tainted=True, noneness=_NOT_NONE)
                if any_taint:
                    self._emit(
                        "unknown",
                        f"unresolved method `self.{member}` receives traced values",
                        conditional,
                        node,
                    )
                return _Value(tainted=False, noneness=_MAYBE)
            # method on an evaluated receiver
            receiver = self._eval(func.value, env, conditional)
            if (
                member == "append"
                and isinstance(func.value, ast.Attribute)
                and isinstance(func.value.value, ast.Name)
                and func.value.value.id == "self"
                and func.value.attr in (env.states | env.list_states)
            ):
                self._emit(
                    REASON_CAT_GROWTH,
                    f"state `{func.value.attr}` accumulates by append (unbounded concatenation)",
                    conditional,
                    node,
                )
                return _Value(tainted=False, noneness=_NOT_NONE)
            if (
                member in ("append", "extend", "insert")
                and isinstance(func.value, ast.Name)
                and not receiver.tainted
            ):
                # a local Python list collecting tensors: a host container
                if any_taint:
                    env.bind(func.value.id, _Value(tainted=True, noneness=_NOT_NONE))
                return _Value(tainted=False, noneness=_NONE)
            if member == "synchronize":
                # Stream/Event.synchronize: the host waits for the card
                self._emit(REASON_HOST_SYNC, "`.synchronize()` waits for the card on the host", conditional, node)
                return _Value(tainted=False, noneness=_NOT_NONE)
            if receiver.tainted:
                if member in _STATIC_METHODS or (member == "type" and not node.args and not node.keywords):
                    return _Value(tainted=False, noneness=_NOT_NONE)
                if member in _HOST_SYNC_METHODS or (member == "to" and _to_host(node)):
                    self._emit(
                        REASON_HOST_SYNC,
                        f"`.{member}()` copies a tensor to the host",
                        conditional,
                        node,
                    )
                    return _Value(tainted=False, noneness=_NOT_NONE)
                if member == "repeat_interleave" and _repeats_unbounded(node, arg_values, kw_values, 0):
                    self._emit(
                        REASON_DATA_SHAPE,
                        "`.repeat_interleave()` with tensor repeats and no `output_size` has a data-dependent shape",
                        conditional,
                        node,
                    )
                    return _Value(tainted=True, noneness=_NOT_NONE)
                if member in _DATA_DEP_METHODS:
                    self._emit(
                        REASON_DATA_SHAPE,
                        f"`.{member}()` has a data-dependent output shape",
                        conditional,
                        node,
                    )
                    return _Value(tainted=True, noneness=_NOT_NONE)
                return _Value(
                    tainted=True, noneness=_NOT_NONE, boolish=member in _BOOLISH_MEMBERS
                )
            if any_taint:
                self._emit(
                    "unknown",
                    f"unresolved call `{'.'.join(chain) or member}` receives traced values",
                    conditional,
                    node,
                )
            return _Value(tainted=False, noneness=_MAYBE)

        # call on an arbitrary expression (rare)
        self._eval(func, env, conditional)
        if any_taint:
            self._emit("unknown", "unresolved indirect call receives traced values", conditional, node)
        return _Value(tainted=False, noneness=_MAYBE)

    #: set by classify_* so `self.<method>()` resolves along the class chain
    _method_resolver = None

    #: the class context a `self.<method>()` callee is scanned in: the
    #: method resolver, the state names (and may-be-list ones), the exact
    #: mode attribute and the traced callable attributes of the class
    #: whose update is classified
    @property
    def _owner(self) -> Optional["_Owner"]:
        if self._method_resolver is None:
            return None
        return _Owner(
            self._method_resolver,
            frozenset(self._states),
            frozenset(self._list_states),
            self.exact_attr,
            self.traced_callable_attrs,
        )

    _states: FrozenSet[str] = frozenset()
    _list_states: FrozenSet[str] = frozenset()

    def _torch_function(self, node: ast.AST) -> Optional[List[str]]:
        """The torch path a function-valued expression names:
        ``torch.amax`` -> ["amax"]; ``torch.amax if m else torch.amin`` ->
        the first side's (both are tensor ops); None otherwise."""
        if isinstance(node, ast.IfExp):
            body = self._torch_function(node.body)
            return body if body is not None and self._torch_function(node.orelse) is not None else None
        chain = _attr_chain(node)
        if len(chain) >= 2 and chain[0] in self.ctx.torch_aliases:
            return chain[1:]
        return None

    def _module_function(self, root: str, member: str) -> Optional[Tuple[FileContext, ast.FunctionDef]]:
        """``member`` of the in-package module bound to ``root``."""
        target = self.project.imports_of(self.ctx).get(root)
        if target is None:
            return None
        relpath = self.project.module_relpath(f"{target[0]}.{target[1]}")
        if relpath is None:
            return None
        mctx = self.project.ctx(relpath)
        if mctx is None:
            return None
        return self.project.resolve_function(mctx, member)

    def _local_call(
        self,
        name: str,
        node: ast.Call,
        arg_values: List[_Value],
        kw_values: Dict[Optional[str], _Value],
        env: _Env,
        conditional: bool,
    ) -> _Value:
        """A call of a helper defined in the function being scanned: its
        body is scanned in the caller's bindings (its closure)."""
        fn = self._local_fns[name]
        if self.depth <= 0 or name in self._local_active:
            if self.depth <= 0 and (any(v.tainted for v in arg_values) or any(v.tainted for v in kw_values.values())):
                self._emit("unknown", f"call depth budget exhausted at `{name}`", conditional, node)
            return _Value(tainted=name in self._local_active, noneness=_MAYBE)
        tainted, noneness = _bind_params(fn, arg_values, kw_values, skip_self=False)
        inner_env = env.snapshot()
        for pname, nn in noneness.items():
            inner_env.bind(pname, _Value(tainted=pname in tainted, noneness=nn))
        inner = _Scanner(self.project, self.ctx, self.depth - 1)
        inner._method_resolver = self._method_resolver
        inner._states = self._states
        inner._list_states = self._list_states
        inner.exact_attr = self.exact_attr
        inner.traced_callable_attrs = self.traced_callable_attrs
        inner._local_fns = dict(self._local_fns)
        inner._fn_aliases = dict(self._fn_aliases)
        inner._local_active = self._local_active | {name}
        inner._shielded = self._shielded
        inner.scan(fn, inner_env)
        for sig in inner.signals:
            self.signals.append(
                Signal(sig.kind, f"{sig.detail} (via `{name}`)", sig.conditional or conditional, sig.line)
            )
        ret = inner.return_value
        return _Value(tainted=ret.tainted, noneness=ret.noneness, elts=ret.elts, capture_empty=ret.capture_empty)

    def _torch_module_call(
        self,
        path: List[str],
        node: ast.Call,
        arg_values: List[_Value],
        kw_values: Dict[Optional[str], _Value],
        any_taint: bool,
        conditional: bool,
    ) -> _Value:
        """``torch.<path>(...)``: a top-level op, or one of the
        ``cuda``/``linalg``/``nn.functional``/``distributed`` submodules."""
        member = path[-1]
        if len(path) == 1:
            return self._torch_call(member, node, arg_values, kw_values, conditional)
        head = path[0]
        if head == "cuda":
            if member == "synchronize":
                self._emit(REASON_HOST_SYNC, "`torch.cuda.synchronize()` waits for the card on the host", conditional, node)
            # the rest (streams, events, availability, capture state) are
            # host objects and host facts
            return _Value(tainted=False, noneness=_NOT_NONE)
        if head == "linalg" and member in _UNCAPTURABLE_LINALG and any_taint:
            self._emit(
                REASON_HOST_SYNC,
                f"`torch.linalg.{member}` on a batch of systems runs MAGMA's batched LU, which "
                "synchronises with the host and cannot be captured",
                conditional,
                node,
            )
            return _Value(tainted=True, noneness=_NOT_NONE)
        if path[:2] == ["nn", "functional"]:
            return self._functional_call(member, node, kw_values, conditional)
        if member.startswith("is_"):
            # host predicates (`torch._C._functorch.is_batchedtensor(x)`)
            return _Value(tainted=False, noneness=_NOT_NONE)
        if head == "distributed":
            return self._dist_call(["torch"] + path, node, conditional)
        # other submodules (fft, special, linalg's capturable ops, ...):
        # ordinary fixed-shape tensor programs
        return _Value(tainted=True, noneness=_NOT_NONE)

    def _functional_call(
        self, member: str, node: ast.Call, kw_values: Dict[Optional[str], _Value], conditional: bool
    ) -> _Value:
        """``torch.nn.functional.<member>(...)``; ``one_hot`` without
        ``num_classes`` sizes its output by the largest label."""
        if member == "one_hot" and len(node.args) < 2 and "num_classes" not in kw_values:
            self._emit(
                REASON_DATA_SHAPE,
                "`one_hot` without `num_classes` sizes its output by the largest value",
                conditional,
                node,
            )
        return _Value(tainted=True, noneness=_NOT_NONE)

    def _dist_call(self, chain: List[str], node: ast.Call, conditional: bool) -> _Value:
        """A ``torch.distributed`` call inside an update: the collectives
        wait for every process, and the rest are host-side group facts."""
        member = chain[-1]
        if member in _DIST_COLLECTIVES:
            self._emit(
                REASON_HOST_SYNC,
                f"`{'.'.join(chain)}` inside an update waits for every process",
                conditional,
                node,
            )
        return _Value(tainted=False, noneness=_NOT_NONE)

    def _torch_call(
        self,
        member: str,
        node: ast.Call,
        arg_values: List[_Value],
        kw_values: Dict[Optional[str], _Value],
        conditional: bool,
    ) -> _Value:
        """A top-level ``torch.<member>(...)`` call."""
        any_taint = any(v.tainted for v in arg_values) or any(v.tainted for v in kw_values.values())
        if member in _DATA_DEP_MEMBERS:
            detail = (
                "its length is `max(minlength, max + 1)`" if member == "bincount" else "its output shape follows the data"
            )
            self._emit(REASON_DATA_SHAPE, f"`torch.{member}`: {detail}", conditional, node)
            return _Value(tainted=True, noneness=_NOT_NONE)
        if member == "where" and len(node.args) == 1:
            self._emit(
                REASON_DATA_SHAPE,
                "single-argument `torch.where` is `nonzero`: data-dependent output shape",
                conditional,
                node,
            )
            return _Value(tainted=True, noneness=_NOT_NONE)
        if member == "repeat_interleave" and _repeats_unbounded(node, arg_values, kw_values, 1):
            self._emit(
                REASON_DATA_SHAPE,
                "`torch.repeat_interleave` with tensor repeats and no `output_size` has a data-dependent shape",
                conditional,
                node,
            )
            return _Value(tainted=True, noneness=_NOT_NONE)
        if member in ("tensor", "as_tensor", "asarray") and "device" in kw_values and node.args and _is_literal(node.args[0]):
            # a host constant copied to the card: a synchronous copy every
            # update, which a capture cannot hold (fill with torch.full)
            self._emit(
                REASON_HOST_SYNC,
                f"`torch.{member}(<constant>, device=...)` is a synchronous host-to-device copy",
                conditional,
                node,
            )
            return _Value(tainted=True, noneness=_NOT_NONE)
        if member in _HOST_SYNC_MEMBERS:
            if any_taint:
                self._emit(
                    REASON_HOST_SYNC,
                    f"`torch.{member}` returns a Python bool read from the tensors",
                    conditional,
                    node,
                )
            return _Value(tainted=False, noneness=_NOT_NONE)
        if member in _HOST_RESULT_MEMBERS or member.startswith("is_"):
            # metadata and mode predicates (`torch.is_grad_enabled()`)
            return _Value(tainted=False, noneness=_NOT_NONE)
        return _Value(tainted=True, noneness=_NOT_NONE, boolish=member in _BOOLISH_MEMBERS)

    def _resolved_call(
        self,
        resolved: Tuple[FileContext, ast.FunctionDef],
        node: ast.Call,
        arg_values: List[_Value],
        kw_values: Dict[Optional[str], _Value],
        conditional: bool,
        skip_self: bool = False,
    ) -> _Value:
        tctx, fn = resolved
        if self.depth <= 0:
            if any(v.tainted for v in arg_values) or any(v.tainted for v in kw_values.values()):
                self._emit(
                    "unknown",
                    f"call depth budget exhausted at `{fn.name}`",
                    conditional,
                    node,
                )
            # untainted result for the same reason as unresolved calls: the
            # unknown signal is already recorded, and an artificial taint
            # would fabricate unconditional unsafe signals downstream
            return _Value(tainted=False, noneness=_MAYBE)

        signals, ret = summarize_function(
            self.project,
            tctx,
            fn,
            arg_values,
            kw_values,
            depth=self.depth - 1,
            skip_self=skip_self,
            owner=self._owner if skip_self else None,
        )
        for sig in signals:
            if sig.kind == "trace-raise" and self._shielded:
                continue  # an enclosing try/except owns the trace-time raise
            self.signals.append(
                Signal(sig.kind, f"{sig.detail} (via `{fn.name}`)", sig.conditional or conditional, sig.line)
            )
        return ret


def _bind_params(
    fn: ast.FunctionDef,
    arg_values: List[_Value],
    kw_values: Dict[Optional[str], _Value],
    skip_self: bool,
) -> Tuple[Set[str], Dict[str, str]]:
    """Map a concrete call's abstract arguments onto the callee's params;
    returns (tainted param names, param None-ness)."""
    params = [a.arg for a in list(fn.args.posonlyargs) + list(fn.args.args)]
    if skip_self and params and params[0] == "self":
        params = params[1:]
    defaults = list(fn.args.defaults)
    default_map: Dict[str, ast.AST] = {}
    for pname, dflt in zip(params[len(params) - len(defaults):], defaults):
        default_map[pname] = dflt
    for kwarg, dflt in zip(fn.args.kwonlyargs, fn.args.kw_defaults):
        if dflt is not None:
            default_map[kwarg.arg] = dflt
    kw_params = [a.arg for a in fn.args.kwonlyargs]

    tainted: Set[str] = set()
    noneness: Dict[str, str] = {}

    def note(pname: str, value: _Value) -> None:
        if value.tainted:
            tainted.add(pname)
        noneness[pname] = value.noneness

    consumed = 0
    for i, value in enumerate(arg_values):
        if i < len(params):
            note(params[i], value)
            consumed = i + 1
        elif fn.args.vararg is not None:
            note(fn.args.vararg.arg, value)
    for kwname, value in kw_values.items():
        if kwname is None:  # **kwargs expansion at the call site
            for pname in params[consumed:] + kw_params:
                if value.tainted:
                    tainted.add(pname)
                noneness.setdefault(pname, _MAYBE)
            if fn.args.kwarg is not None:
                note(fn.args.kwarg.arg, value)
        elif kwname in params or kwname in kw_params:
            note(kwname, value)
        elif fn.args.kwarg is not None:
            note(fn.args.kwarg.arg, value)
    # unbound params take their declared default's None-ness
    for pname in params + kw_params:
        if pname in noneness:
            continue
        dflt = default_map.get(pname)
        if isinstance(dflt, ast.Constant):
            noneness[pname] = _NONE if dflt.value is None else _NOT_NONE
        else:
            noneness[pname] = _MAYBE
    # a MAYBE binding upgrades to notnone when the parameter's annotation
    # excludes None (`num_classes: int`): passing None there is already a
    # type error, so dead-branch elimination may trust the annotation
    ann_by_name = {
        a.arg: a.annotation
        for a in list(fn.args.posonlyargs) + list(fn.args.args) + list(fn.args.kwonlyargs)
    }
    for pname, nn in list(noneness.items()):
        if nn == _MAYBE and _annotation_excludes_none(ann_by_name.get(pname)):
            noneness[pname] = _NOT_NONE
    return tainted, noneness


def _annotation_excludes_none(ann: Optional[ast.AST]) -> bool:
    """True for annotations that rule out None (``int``, ``Array``,
    ``Union[str, List[str]]``); False for Optional/None/Any/strings."""
    if ann is None:
        return False
    for sub in ast.walk(ann):
        if isinstance(sub, ast.Constant) and (sub.value is None or isinstance(sub.value, str)):
            return False  # explicit None, or a quoted annotation we won't parse
        name = None
        if isinstance(sub, ast.Name):
            name = sub.id
        elif isinstance(sub, ast.Attribute):
            name = sub.attr
        if name in ("Optional", "Any", "object", "None"):
            return False
    return True


@dataclass(frozen=True)
class _Owner:
    """The class context of a ``self.<method>()`` callee (see
    :attr:`_Scanner._owner`)."""

    resolver: object
    states: FrozenSet[str]
    list_states: FrozenSet[str]
    exact_attr: Optional[str]
    traced_callable_attrs: FrozenSet[str]

    def key(self) -> Tuple:
        # the class chain names the resolver (an id() could be reused by a
        # later class's resolver once this one is collected)
        return (getattr(self.resolver, "chain_key", id(self.resolver)), self.states, self.list_states, self.exact_attr, self.traced_callable_attrs)


def summarize_function(
    project: Project,
    ctx: FileContext,
    fn: ast.FunctionDef,
    arg_values: List[_Value],
    kw_values: Dict[Optional[str], _Value],
    depth: int,
    skip_self: bool = False,
    owner: Optional[_Owner] = None,
) -> Tuple[List[Signal], _Value]:
    """Memoized abstract scan of ``fn`` under one argument binding (and,
    for a method of the classified class, that class's context)."""
    tainted, noneness = _bind_params(fn, arg_values, kw_values, skip_self)
    key = (
        ctx.relpath,
        hash(ctx.source),  # two sources under one relpath (fixtures) never share summaries
        fn.name,
        fn.lineno,
        frozenset(tainted),
        tuple(sorted(noneness.items())),
        owner.key() if owner is not None else None,
    )
    cached = project._summary_cache.get(key)
    if cached is not None:
        return list(cached[0]), _Value(tainted=cached[1], noneness=cached[2], elts=cached[3], capture_empty=cached[4])
    if key in project._in_progress:
        return [], _Value(tainted=True, noneness=_MAYBE)  # recursion: optimistic
    project._in_progress.add(key)
    try:
        scanner = _Scanner(project, ctx, depth)
        env = _Env(traced=set(tainted), noneness=dict(noneness))
        if owner is not None:
            scanner._method_resolver = owner.resolver
            scanner._states = owner.states
            scanner._list_states = owner.list_states
            scanner.exact_attr = owner.exact_attr
            scanner.traced_callable_attrs = owner.traced_callable_attrs
            env.states = set(owner.states)
            env.list_states = set(owner.list_states)
        scanner.scan(fn, env)
        ret = scanner.return_value
        # element values survive memoization WITHOUT nested elts (one level
        # is what tuple unpacking at the call site consumes)
        elts = (
            [_Value(tainted=e.tainted, noneness=e.noneness, capture_empty=e.capture_empty) for e in ret.elts]
            if ret.elts is not None
            else None
        )
        project._summary_cache[key] = (list(scanner.signals), ret.tainted, ret.noneness, elts, ret.capture_empty)
        return list(scanner.signals), _Value(
            tainted=ret.tainted, noneness=ret.noneness, elts=elts, capture_empty=ret.capture_empty
        )
    finally:
        project._in_progress.discard(key)


# ---------------------------------------------------------------------------
# class-level classification
# ---------------------------------------------------------------------------

#: add_state default-expression container classification
_CONTAINER_ARRAY = "array"
_CONTAINER_LIST = "list"
_CONTAINER_UNKNOWN = "unknown"

#: torch constructors whose leading arguments are the size (``full``: the
#: first one, then the fill value)
_SHAPED_CTORS = {"zeros", "ones", "empty", "full"}

#: torch constructors copying their data argument (``torch.tensor(0.0)``)
_DATA_CTORS = {"tensor", "as_tensor", "asarray"}

#: sketches/ (and retrieval-table) state initializers:
#: fixed-shape float32 leaves with the capacity as the leading dim
_SKETCH_INIT_CTORS = {
    "qsketch_init",
    "ranksketch_init",
    "reservoir_init",
    "hist_init",
    "retrieval_table_init",
    "detection_table_init",
}

_DTYPE_DEFAULTS = {"zeros": "float32", "ones": "float32", "empty": "float32", "full": None}


def _dim_of(node: ast.AST) -> object:
    """One abstract dimension: a concrete int, a symbol (parameter name),
    or "?" when the expression is beyond the lattice."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if isinstance(node, ast.Name):
        return node.id
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return "?"


def _shape_of(node: ast.AST) -> Optional[List[object]]:
    if isinstance(node, (ast.Tuple, ast.List)):
        return [_dim_of(el) for el in node.elts]
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return [node.value]
    if isinstance(node, ast.Name) or isinstance(node, ast.Attribute):
        return None  # a shape variable: rank unknown
    return None


def _size_of(args: Sequence[ast.AST]) -> Optional[List[object]]:
    """The size a torch constructor's positional arguments give: one
    sequence (``torch.zeros((d, d))``) or the dims spelled out
    (``torch.zeros(d, d)``)."""
    if not args:
        return None
    if len(args) == 1:
        return _shape_of(args[0])
    return [_dim_of(a) for a in args]


def _scalar_dtype(value: object, python_ints: str) -> str:
    """The dtype a Python scalar becomes: ``python_ints`` for an int (the
    port's ``add_state`` makes host ints int32; torch's constructors make
    them int64)."""
    if isinstance(value, bool):
        return "bool"
    return python_ints if isinstance(value, int) else "float32"


def _dtype_name(node: Optional[ast.AST]) -> Optional[str]:
    if node is None:
        return None
    name = _last_name(node)
    if name in ("float", "half", "double", "long", "short"):
        return {"float": "float32", "half": "float16", "double": "float64", "long": "int64", "short": "int16"}[name]
    if name and (
        name.startswith(("int", "uint", "float", "bfloat", "complex"))
        or name in ("bool_", "bool")
    ):
        return "bool" if name in ("bool_", "bool") else name
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


@dataclass
class StateEntry:
    """Abstract description of one registered state leaf."""

    name: str
    container: str  # array | list | unknown
    shape: Optional[List[object]]  # dims: int | symbol str | "?" ; None = unknown
    dtype: Optional[str]
    dist_reduce_fx: Optional[str]  # "sum"/"mean"/... | "custom" | None

    @property
    def sliceable(self) -> bool:
        """Whether the leaf admits an exact slice-axis scatter: a
        ``sum``/``max``/``min`` reducer over an array state maps onto
        ``segment_sum`` / scatter-max / scatter-min along a leading ``[S]``
        dimension (``sliced/``); mean/cat/custom/None reducers
        and list states have no per-slice decomposition, and an unknown
        container is conservatively not sliceable."""
        return self.container == _CONTAINER_ARRAY and self.dist_reduce_fx in _SLICEABLE_REDUCERS

    def to_dict(self) -> Dict[str, object]:
        return {
            "container": self.container,
            "shape": self.shape,
            "dtype": self.dtype,
            "dist_reduce_fx": self.dist_reduce_fx,
            "sliceable": self.sliceable,
        }


def _infer_default(
    expr: Optional[ast.AST],
    bindings: Optional[Dict[str, List[ast.AST]]] = None,
    _depth: int = 3,
) -> Tuple[str, Optional[List[object]], Optional[str]]:
    """(container, shape, dtype) of an ``add_state`` default expression.

    ``bindings`` maps local names to every expression assigned to them in
    the class body: a name bound exactly once resolves through (the
    ``default = torch.zeros(...) if multilabel else ...`` idiom); multiple
    bindings are genuinely config-dependent and stay unknown.
    """
    if expr is None or _depth <= 0:
        return _CONTAINER_UNKNOWN, None, None
    if isinstance(expr, ast.Name) and bindings is not None:
        bound = bindings.get(expr.id)
        if bound is not None and len(bound) == 1:
            return _infer_default(bound[0], bindings, _depth - 1)
        return _CONTAINER_UNKNOWN, None, None
    if (
        isinstance(expr, ast.Call)
        and isinstance(expr.func, ast.Name)
        and not expr.args
        and not expr.keywords
        and bindings is not None
    ):
        # `default()` thunk idiom: resolve the zero-arg callable's body
        bound = bindings.get(expr.func.id)
        if bound is not None and len(bound) == 1:
            target = bound[0]
            if isinstance(target, ast.Lambda):
                return _infer_default(target.body, bindings, _depth - 1)
            if isinstance(target, ast.Name) and target.id == "list":
                return _CONTAINER_LIST, None, None
        if expr.func.id == "list":
            return _CONTAINER_LIST, None, None
        if bound is not None:
            return _CONTAINER_UNKNOWN, None, None
    if isinstance(expr, ast.List):
        return _CONTAINER_LIST, None, None
    if isinstance(expr, ast.Constant) and isinstance(expr.value, (int, float, bool)):
        # a host scalar default: the port's add_state makes ints int32
        return _CONTAINER_ARRAY, [], _scalar_dtype(expr.value, "int32")
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.operand, ast.Constant):
        return _infer_default(expr.operand, bindings, _depth - 1)
    if isinstance(expr, ast.IfExp):
        c1, s1, d1 = _infer_default(expr.body, bindings, _depth - 1)
        c2, s2, d2 = _infer_default(expr.orelse, bindings, _depth - 1)
        container = c1 if c1 == c2 else _CONTAINER_UNKNOWN
        return container, s1 if s1 == s2 else None, d1 if d1 == d2 else None
    if isinstance(expr, ast.Call):
        member = _last_name(expr.func)
        dtype_kw = next((kw.value for kw in expr.keywords if kw.arg == "dtype"), None)
        if member in _SKETCH_INIT_CTORS:
            # the sketches/ initializers return fixed float32 tensors whose
            # leading dim is the capacity argument (metrics register their
            # defaults through them; column count is layout-derived)
            dim0 = _dim_of(expr.args[0]) if expr.args else "?"
            return _CONTAINER_ARRAY, [dim0, "?"], "float32"
        if member in _SHAPED_CTORS and _attr_chain(expr.func)[:1] in (["np"], ["numpy"]):
            # numpy's constructors: the shape, then the fill value (full)
            # or the dtype, positionally
            shape = _shape_of(expr.args[0]) if expr.args else None
            pos_dtype = expr.args[2 if member == "full" else 1] if len(expr.args) > (2 if member == "full" else 1) else None
            return _CONTAINER_ARRAY, shape, _dtype_name(dtype_kw) or _dtype_name(pos_dtype) or _DTYPE_DEFAULTS.get(member)
        if member in _SHAPED_CTORS:
            size_args = expr.args[:1] if member == "full" else expr.args
            size_kw = next((kw.value for kw in expr.keywords if kw.arg == "size"), None)
            shape = _size_of(size_args) if size_args else (_shape_of(size_kw) if size_kw is not None else None)
            dtype = _dtype_name(dtype_kw) or _DTYPE_DEFAULTS.get(member)
            if member == "full" and dtype is None and len(expr.args) >= 2:
                # torch.full infers the fill value's dtype (ints: int64)
                fill = expr.args[1]
                if isinstance(fill, ast.UnaryOp) and isinstance(fill.operand, ast.Constant):
                    fill = fill.operand
                if isinstance(fill, ast.Constant) and isinstance(fill.value, (int, float, bool)):
                    dtype = _scalar_dtype(fill.value, "int64")
            return _CONTAINER_ARRAY, shape, dtype
        if member == "eye" and expr.args:
            dim = _dim_of(expr.args[0])
            return _CONTAINER_ARRAY, [dim, dim], _dtype_name(dtype_kw) or "float32"
        if member in _DATA_CTORS and expr.args:
            data = expr.args[0]
            if isinstance(data, ast.UnaryOp) and isinstance(data.operand, ast.Constant):
                data = data.operand
            if isinstance(data, ast.Constant) and isinstance(data.value, (int, float, bool)):
                # torch's constructors make Python ints int64
                return _CONTAINER_ARRAY, [], _dtype_name(dtype_kw) or _scalar_dtype(data.value, "int64")
            container, shape, dtype = _infer_default(data, bindings, _depth - 1)
            if container == _CONTAINER_LIST:
                # torch.tensor([...]) is a tensor literal
                shape = [len(data.elts)] if isinstance(data, ast.List) else None
            return _CONTAINER_ARRAY, shape, _dtype_name(dtype_kw) or dtype
        if isinstance(expr.func, ast.Name) and member in ("float", "int", "bool") and expr.args:
            # `default=float(x)`: a host scalar, as add_state converts it
            return _CONTAINER_ARRAY, [], {"float": "float32", "int": "int32", "bool": "bool"}[member]
        return _CONTAINER_UNKNOWN, None, _dtype_name(dtype_kw)
    return _CONTAINER_UNKNOWN, None, None


_STRING_REDUCERS = {"sum", "mean", "max", "min", "cat", "merge", "ring", "decay"}

#: reducers with an exact slice-axis scatter (see StateEntry.sliceable)
_SLICEABLE_REDUCERS = {"sum", "max", "min"}


def _reducer_of(call: ast.Call) -> Optional[str]:
    """The dist_reduce_fx of an add_state call: a known string, None (no
    reduction), or "custom" for callables/unrecognized expressions."""
    fx: Optional[ast.AST] = None
    if len(call.args) >= 3:
        fx = call.args[2]
    for kw in call.keywords:
        if kw.arg == "dist_reduce_fx":
            fx = kw.value
    if fx is None:
        return None
    if isinstance(fx, ast.Constant):
        if fx.value is None:
            return None
        if isinstance(fx.value, str) and fx.value in _STRING_REDUCERS:
            return fx.value
    if isinstance(fx, ast.Call):
        name = _last_name(fx.func)
        # the windowed module's tagged reducers (`ring_sum_fx()`,
        # `ring_merge_fx(...)`, `decay_sum_fx()`) serialize as their window
        # semantics -- checked BEFORE the merge_fx suffix so a ring-of-
        # sketches leaf reads "ring", not "merge"
        if name in ("ring_sum_fx", "ring_merge_fx"):
            return "ring"
        if name == "decay_sum_fx":
            return "decay"
        # streaming-moment leaves (`moments_merge_fx()`): element-wise
        # summable sufficient statistics whose cross-rank merge IS addition
        # -- checked BEFORE the merge_fx suffix so the write-contract rules
        # (additive, not insert-transform) apply to them
        if name == "moments_merge_fx":
            return "moments"
        # the sketch modules' tagged merge reducers (`sketch_merge_fx()`,
        # `reservoir_merge_fx()`, `ranksketch_merge_fx()`): a self-merging
        # leaf, distinct from an arbitrary custom callable
        if name is not None and name.endswith("merge_fx"):
            return "merge"
    return "custom"


def module_constants(tree: ast.Module) -> Dict[str, object]:
    """Module-level string and string-tuple constants (``RING_ROWS =
    "_ring_rows"``, ``_STATES = ("a", "b")``): the names a state
    registration may spell through."""
    out: Dict[str, object] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            value = _const_strings(node.value, {})
            if value is not None:
                out[node.targets[0].id] = value
    return out


def _const_strings(node: ast.AST, names: Dict[str, object]) -> Optional[object]:
    """A string, or a tuple of strings, that ``node`` statically is: a
    literal, a bound name, an f-string over bound names, or a tuple/list
    of those; None beyond that."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return names.get(node.id)
    if isinstance(node, ast.JoinedStr):
        parts: List[str] = []
        for value in node.values:
            if isinstance(value, ast.FormattedValue):
                inner = _const_strings(value.value, names)
                if not isinstance(inner, str):
                    return None
                parts.append(inner)
            elif isinstance(value, ast.Constant) and isinstance(value.value, str):
                parts.append(value.value)
            else:
                return None
        return "".join(parts)
    if isinstance(node, (ast.Tuple, ast.List)):
        elts = [_const_strings(e, names) for e in node.elts]
        if elts and all(isinstance(e, str) for e in elts):
            return tuple(elts)
    return None


def add_state_calls(
    class_node: ast.ClassDef, constants: Optional[Dict[str, object]] = None
) -> List[Tuple[ast.Call, Optional[str]]]:
    """Every ``self.add_state(...)`` call in the class body with the state
    name it registers (None when not static), in breadth-first order.
    ``for name in ("a", "b"):`` loops over constant names are unrolled, so
    a registration spelled ``self.add_state(name, ...)`` or
    ``self.add_state(f"{side}_sum", ...)`` yields one entry per name."""
    found: List[Tuple[int, int, ast.Call, Optional[str]]] = []
    order = [0]

    def visit(node: ast.AST, depth: int, names: Dict[str, object]) -> None:
        order[0] += 1
        if isinstance(node, ast.FunctionDef) and node.name == "add_state":
            return  # the registry itself (its auto-registered mean counter)
        if isinstance(node, ast.Call):
            func = node.func
            if (
                isinstance(func, ast.Attribute)
                and func.attr == "add_state"
                and isinstance(func.value, ast.Name)
                and func.value.id == "self"
            ):
                name = _const_strings(node.args[0], names) if node.args else None
                found.append((depth, order[0], node, name if isinstance(name, str) else None))
        if isinstance(node, ast.For) and isinstance(node.target, ast.Name):
            values = _const_strings(node.iter, names)
            if isinstance(values, tuple):
                visit(node.iter, depth + 1, names)
                for value in values:
                    inner = dict(names)
                    inner[node.target.id] = value
                    for stmt in node.body:
                        visit(stmt, depth + 1, inner)
                for stmt in node.orelse:
                    visit(stmt, depth + 1, names)
                return
        for child in ast.iter_child_nodes(node):
            visit(child, depth + 1, names)

    visit(class_node, 0, dict(constants or {}))
    found.sort(key=lambda t: (t[0], t[1]))
    return [(call, name) for _, _, call, name in found]


def state_entries_of(
    class_node: ast.ClassDef, constants: Optional[Dict[str, object]] = None
) -> List[StateEntry]:
    """Every ``self.add_state(...)`` in the class body, abstracted."""
    entries: List[StateEntry] = []
    seen: Set[str] = set()
    # local constant propagation for the `default = <expr>; add_state(...,
    # default=default)` idiom: single-binding names resolve through
    bindings: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(class_node):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            bindings.setdefault(node.targets[0].id, []).append(node.value)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name) and node.value is not None:
            bindings.setdefault(node.target.id, []).append(node.value)
    for node, name in add_state_calls(class_node, constants):
        default: Optional[ast.AST] = node.args[1] if len(node.args) >= 2 else None
        for kw in node.keywords:
            if kw.arg == "default":
                default = kw.value
        container, shape, dtype = _infer_default(default, bindings)
        if name is None:
            continue  # dynamically-named state: recorded via the unknown-container path
        if name in seen:
            # registered twice (config branches): containers must agree
            prev = next(e for e in entries if e.name == name)
            if prev.container != container:
                prev.container = _CONTAINER_UNKNOWN
                prev.shape = None
            continue
        seen.add(name)
        entries.append(StateEntry(name, container, shape, dtype, _reducer_of(node)))
    return entries


@dataclass
class ClassFacts:
    """Merged cross-file view of a metric class and its in-package bases."""

    name: str
    relpath: str
    node: ast.ClassDef
    entries: List[StateEntry]
    declared: Optional[bool]  # explicit __jit_unsafe__ (None = undeclared)
    declared_here: Optional[bool]  # declaration in THIS class body only
    declared_computed: bool
    update: Optional[Tuple[FileContext, ast.FunctionDef]]
    chain: List[Tuple[FileContext, ast.ClassDef]]
    is_metric: bool
    exact_attr: Optional[str] = None  # __exact_mode_attr__ declaration
    traced_callable_attrs: FrozenSet[str] = frozenset()  # __traced_callable_attrs__


def _traced_callable_attrs(class_node: ast.ClassDef) -> FrozenSet[str]:
    """The ``__traced_callable_attrs__ = ("<attr>", ...)`` declaration.

    A metric whose constructor installs a *traceable* callable on an
    instance attribute (e.g. a torch feature extractor bound via
    ``self.inception = build_fid_inception(...)``) declares those attribute
    names here: ``self.<attr>(...)`` calls in the update are modeled as
    traced-pure array programs instead of emitting the unresolved-method
    "unknown" signal. The declaration is a CONTRACT on the default
    configuration -- a user who installs a host-only callable on such an
    attribute is caught at runtime by the fused dispatcher's stale-manifest
    safety net (the trace fails, the member is re-probed and demoted to the
    eager path), so a wrong declaration degrades performance, never
    correctness.
    """
    for stmt in class_node.body:
        if (
            isinstance(stmt, ast.Assign)
            and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)
            and stmt.targets[0].id == "__traced_callable_attrs__"
            and isinstance(stmt.value, (ast.Tuple, ast.List))
        ):
            names = [
                el.value
                for el in stmt.value.elts
                if isinstance(el, ast.Constant) and isinstance(el.value, str)
            ]
            return frozenset(names)
    return frozenset()


def _exact_mode_attr(class_node: ast.ClassDef) -> Optional[str]:
    """The ``__exact_mode_attr__ = "<attr>"`` declaration, if present.

    The mode-split contract for sketch-converted metrics: branches testing
    ``self.<attr>`` (and states registered only there) belong to the opt-in
    exact mode, which is runtime-guarded (live list states + instance-level
    ``__jit_unsafe__``) -- the class-level verdict describes the DEFAULT
    (sketch) mode, so the scanner skips the declared exact branches.
    """
    for stmt in class_node.body:
        if (
            isinstance(stmt, ast.Assign)
            and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)
            and stmt.targets[0].id == "__exact_mode_attr__"
            and isinstance(stmt.value, ast.Constant)
            and isinstance(stmt.value.value, str)
        ):
            return stmt.value.value
    return None


def _own_declaration(class_node: ast.ClassDef) -> Tuple[Optional[bool], bool]:
    """(declared value, computed?) for a __jit_unsafe__ declaration in this
    class body -- class-level assignment or the instance-dict idiom."""
    declared: Optional[bool] = None
    computed = False

    def record(value: Optional[ast.AST]) -> None:
        nonlocal declared, computed
        if isinstance(value, ast.Constant):
            declared = bool(value.value) if declared is None else (declared or bool(value.value))
        else:
            computed = True
            declared = True if declared is None else declared

    for stmt in class_node.body:
        target = None
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and isinstance(stmt.targets[0], ast.Name):
            target = stmt.targets[0].id
        elif isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
            target = stmt.target.id
        if target == "__jit_unsafe__":
            record(getattr(stmt, "value", None))
    # an instance-level declaration under a constructor branch (KID's
    # callable extractor, whose width the first update learns) depends on
    # the configuration: computed, like a non-constant value
    branched: Set[int] = set()
    for node in ast.walk(class_node):
        if isinstance(node, ast.If):
            branched.update(id(sub) for sub in ast.walk(node))
    for node in ast.walk(class_node):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and id(node) in branched:
            tgt = node.targets[0]
            if _names_instance_declaration(tgt):
                computed = True
                declared = True if declared is None else declared
            continue
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if (
                isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self"
                and tgt.attr == "__jit_unsafe__"
            ):
                record(node.value)
            if (
                isinstance(tgt, ast.Subscript)
                and isinstance(tgt.value, ast.Attribute)
                and isinstance(tgt.value.value, ast.Name)
                and tgt.value.value.id == "self"
                and tgt.value.attr == "__dict__"
                and isinstance(tgt.slice, ast.Constant)
                and tgt.slice.value == "__jit_unsafe__"
            ):
                record(node.value)
    return declared, computed


def _names_instance_declaration(tgt: ast.AST) -> bool:
    """``self.__jit_unsafe__`` or ``self.__dict__["__jit_unsafe__"]``."""
    if isinstance(tgt, ast.Attribute):
        return isinstance(tgt.value, ast.Name) and tgt.value.id == "self" and tgt.attr == "__jit_unsafe__"
    return (
        isinstance(tgt, ast.Subscript)
        and isinstance(tgt.value, ast.Attribute)
        and isinstance(tgt.value.value, ast.Name)
        and tgt.value.value.id == "self"
        and tgt.value.attr == "__dict__"
        and isinstance(tgt.slice, ast.Constant)
        and tgt.slice.value == "__jit_unsafe__"
    )


def class_facts(project: Project, ctx: FileContext, class_node: ast.ClassDef) -> ClassFacts:
    """Resolve the class chain across files and merge state registrations,
    declarations, and the effective update method."""
    chain: List[Tuple[FileContext, ast.ClassDef]] = []
    seen: Set[Tuple[str, str]] = set()
    queue: List[Tuple[FileContext, ast.ClassDef]] = [(ctx, class_node)]
    is_metric = False
    while queue:
        cur_ctx, cur_node = queue.pop(0)
        key = (cur_ctx.relpath, cur_node.name)
        if key in seen:
            continue
        seen.add(key)
        chain.append((cur_ctx, cur_node))
        for base in cur_node.bases:
            base_name = _last_name(base)
            if base_name is None:
                continue
            if base_name == "Metric" or base_name.endswith("Metric") or base_name == "ABC":
                if base_name != "ABC":
                    is_metric = True
                resolved = project.resolve_class(cur_ctx, base_name)
                if resolved is not None and base_name != "ABC":
                    queue.append(resolved)
                continue
            resolved = project.resolve_class(cur_ctx, base_name)
            if resolved is not None:
                queue.append(resolved)

    entries: List[StateEntry] = []
    names: Set[str] = set()
    declared: Optional[bool] = None
    computed = False
    for cur_ctx, cur_node in chain:
        for entry in state_entries_of(cur_node, module_constants(cur_ctx.tree)):
            if entry.name not in names:
                names.add(entry.name)
                entries.append(entry)
        if entries and not is_metric:
            is_metric = True  # registers state: metric-like regardless of name
        if declared is None and not (
            cur_node.name == "Metric" and cur_ctx.relpath == "core/metric.py"
        ):
            # the base Metric's `__jit_unsafe__ = False` is the inherited
            # DEFAULT, not an explicit per-metric declaration
            d, c = _own_declaration(cur_node)
            if d is not None:
                declared, computed = d, c

    update: Optional[Tuple[FileContext, ast.FunctionDef]] = None
    for method_name in ("_update", "update"):
        for cur_ctx, cur_node in chain:
            for stmt in cur_node.body:
                if isinstance(stmt, ast.FunctionDef) and stmt.name == method_name:
                    update = (cur_ctx, stmt)
                    break
            if update is not None:
                break
        if update is not None:
            break

    declared_here, computed_here = _own_declaration(class_node)
    exact_attr = None
    for cur_ctx, cur_node in chain:
        exact_attr = _exact_mode_attr(cur_node)
        if exact_attr is not None:
            break
    traced_attrs: FrozenSet[str] = frozenset()
    for cur_ctx, cur_node in chain:
        traced_attrs = traced_attrs | _traced_callable_attrs(cur_node)
    return ClassFacts(
        name=class_node.name,
        relpath=ctx.relpath,
        node=class_node,
        entries=entries,
        declared=declared,
        declared_here=declared_here,
        declared_computed=computed or computed_here,
        update=update,
        chain=chain,
        is_metric=is_metric,
        exact_attr=exact_attr,
        traced_callable_attrs=traced_attrs,
    )


def _string_annotated_params(fn: ast.FunctionDef) -> Set[str]:
    """Update parameters whose type annotation mentions ``str`` -- a declared
    host-text input that can never trace."""
    out: Set[str] = set()
    for arg in list(fn.args.posonlyargs) + list(fn.args.args) + list(fn.args.kwonlyargs):
        if arg.arg == "self" or arg.annotation is None:
            continue
        for sub in ast.walk(arg.annotation):
            if (isinstance(sub, ast.Name) and sub.id == "str") or (
                isinstance(sub, ast.Constant) and sub.value == "str"
            ):
                out.add(arg.arg)
                break
    return out


def _static_annotated_params(fn: ast.FunctionDef) -> Set[str]:
    """Update parameters annotated as BARE ``bool`` or ``int`` -- declared
    Python-static configuration knobs, not traced array inputs. Under the
    fused dispatcher these are static (non-array leaves never become
    tracers), so branching on them is shape selection, not a host sync.
    Only the bare annotation qualifies: ``Optional[int]``, ``Tensor``-like
    wrappers, and unions stay traced."""
    out: Set[str] = set()
    for arg in list(fn.args.posonlyargs) + list(fn.args.args) + list(fn.args.kwonlyargs):
        ann = arg.annotation
        if arg.arg == "self" or ann is None:
            continue
        if (isinstance(ann, ast.Name) and ann.id in ("bool", "int")) or (
            isinstance(ann, ast.Constant) and ann.value in ("bool", "int")
        ):
            out.add(arg.arg)
    return out


def _method_resolver_for(project: Project, facts: ClassFacts):
    """Resolve ``self.<name>(...)`` along the class chain (in-package only)."""

    def resolve(name: str) -> Optional[Tuple[FileContext, ast.FunctionDef]]:
        for cur_ctx, cur_node in facts.chain:
            for stmt in cur_node.body:
                if isinstance(stmt, ast.FunctionDef) and stmt.name == name:
                    return cur_ctx, stmt
        return None

    resolve.chain_key = tuple((c.relpath, n.name, n.lineno) for c, n in facts.chain)
    return resolve


def classify(project: Project, ctx: FileContext, class_node: ast.ClassDef) -> Tuple[Verdict, ClassFacts]:
    """The per-class verdict and the facts it was derived from."""
    facts = class_facts(project, ctx, class_node)

    definite_lists = [e.name for e in facts.entries if e.container == _CONTAINER_LIST]
    if definite_lists:
        return (
            Verdict(
                VERDICT_UNSAFE,
                REASON_CAT_GROWTH,
                f"list state{'s' if len(definite_lists) > 1 else ''} "
                f"{', '.join(sorted(definite_lists))} accumulate by unbounded concatenation",
            ),
            facts,
        )

    if facts.update is None:
        return Verdict(VERDICT_UNKNOWN, None, "no update method found in the class chain"), facts

    unknown_containers = [e.name for e in facts.entries if e.container == _CONTAINER_UNKNOWN]

    up_ctx, up_fn = facts.update
    text_params = _string_annotated_params(up_fn)
    if text_params:
        # declared host-text inputs: a graph cannot hold Python strings, so the
        # update is host-side by type contract, whatever its body does
        return (
            Verdict(
                VERDICT_UNSAFE,
                REASON_HOST_SYNC,
                "update consumes Python strings (host text processing): "
                + ", ".join(sorted(text_params)),
            ),
            facts,
        )
    scanner = _Scanner(project, up_ctx, _DEPTH_BUDGET)
    scanner._method_resolver = _method_resolver_for(project, facts)
    scanner.exact_attr = facts.exact_attr
    scanner.traced_callable_attrs = facts.traced_callable_attrs
    params = {a.arg for a in list(up_fn.args.posonlyargs) + list(up_fn.args.args) if a.arg != "self"}
    params.update(a.arg for a in up_fn.args.kwonlyargs)
    if up_fn.args.vararg:
        params.add(up_fn.args.vararg.arg)
    if up_fn.args.kwarg:
        params.add(up_fn.args.kwarg.arg)
    env = _Env(
        traced=set(params) - _static_annotated_params(up_fn),
        noneness={p: _NOT_NONE for p in params},
        states={e.name for e in facts.entries if e.container != _CONTAINER_LIST},
        list_states=set(unknown_containers),
    )
    scanner._states = frozenset(env.states)
    scanner._list_states = frozenset(env.list_states)
    scanner.scan(up_fn, env)
    signals = list(scanner.signals)
    if unknown_containers:
        signals.append(
            Signal(
                "unknown",
                "state container depends on constructor configuration: "
                + ", ".join(sorted(unknown_containers)),
                conditional=True,
                line=class_node.lineno,
            )
        )
    return verdict_from_signals(signals), facts


def iter_metric_classes(ctx: FileContext) -> Iterator[ast.ClassDef]:
    """Top-level classes in ``ctx`` worth classifying (named like metrics,
    based on an in-package metric, or registering state)."""
    for node in ctx.tree.body:
        if isinstance(node, ast.ClassDef):
            yield node
