"""State-lifecycle dataflow: the TL-FLOW analysis (the JAX package's, over
the port's torch spellings).

Every ``add_state`` leaf carries a ``dist_reduce_fx`` contract that sync,
``merge_states``, and the fused kernel all trust. This pass checks that the
class's own lifecycle honors it:

* **Reducer-consistent writes** -- a ``"sum"``-reduced leaf must accumulate
  additively in update methods (``self.x = self.x + delta`` / ``+=`` /
  ``self.x.index_add(...)``): a plain overwrite discards prior batches on
  this rank AND double-counts nothing on others after a cross-rank sum, and
  an extremum update (``torch.maximum``) makes per-rank values
  non-additive. The
  dual holds for ``"max"``/``"min"`` leaves, where an additive write breaks
  the idempotent-extremum contract.
* **Reset restoration** -- a class that overrides ``reset`` must either call
  ``super().reset()`` (which restores every registered default) or assign
  each leaf itself; a leaf missed by an overriding reset survives across
  epochs and silently inflates the next accumulation.
* **Live leaves** -- a leaf registered by a class that defines its own
  update but never touches the leaf anywhere in the file is dead weight:
  it still costs sync bytes every ``compute`` and suggests a typo'd
  attribute name (write hits ``__setattr__`` but not the registry).

Only leaves with a CONSTANT string reducer are checked (config-dependent
reducers -- the StatScores ``"cat"``-or-``"sum"`` idiom -- and custom
callables have no statically-checkable write contract). Findings surface
through the ``TL-FLOW`` rule in :mod:`.rules`.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

from .engine import FileContext

#: methods whose writes are ACCUMULATION (the reducer contract applies);
#: reset/sync/bind/merge/load writes are restoration and exempt
_UPDATE_METHODS = {"_update", "update", "update_state"}

#: additive accumulation spellings for sum-reduced leaves
_ADDITIVE_AUG_OPS = (ast.Add, ast.Sub)
_EXTREMUM_FNS = {
    "maximum", "minimum", "max", "min", "amax", "amin", "fmax", "fmin",
    "maximum_ieee", "minimum_ieee",
}
#: additive tensor methods on the prior value (`self.x.index_add(0, i, v)`)
_ADD_METHOD_NAMES = {"add", "index_add", "scatter_add"}

#: slice-axis scatter reducers (sliced/): a `segment_sum` of per-row deltas
#: combined with the prior value IS additive accumulation, and
#: `segment_max`/`segment_min` results folded through the matching extremum
#: are extremum-consistent -- but a scatter-EXTREMUM write
#: (`self.x.scatter_reduce(0, ids, v, "amax")`, or a segment_max folded into
#: a sum leaf) silently breaks the additivity the cross-rank sum relies on
_SEGMENT_EXTREMUM_FNS = {
    "segment_max": "max", "segment_min": "min",
    "segment_max_dispatch": "max", "segment_min_dispatch": "min",
}
#: torch's scatter-reduce methods, by their `reduce` argument
_SCATTER_REDUCE_METHODS = {"scatter_reduce", "index_reduce"}
_SCATTER_EXTREMUM_REDUCES = {"amax": "max", "amin": "min"}


@dataclass(frozen=True)
class FlowFinding:
    node: ast.AST
    message: str


def _state_reducers(class_node: ast.ClassDef) -> Dict[str, str]:
    """name -> constant string reducer, for this class's own add_state calls."""
    from .interp import _reducer_of  # shared reducer extraction

    out: Dict[str, str] = {}
    for node in ast.walk(class_node):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if not (
            isinstance(func, ast.Attribute)
            and func.attr == "add_state"
            and isinstance(func.value, ast.Name)
            and func.value.id == "self"
        ):
            continue
        if node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
            reducer = _reducer_of(node)
            if isinstance(reducer, str) and reducer in {
                "sum", "mean", "max", "min", "cat", "merge", "ring", "decay",
                "moments",
            }:
                out[node.args[0].value] = reducer
    return out


def _mentions_self_attr(node: ast.AST, attr: str) -> bool:
    for sub in ast.walk(node):
        if (
            isinstance(sub, ast.Attribute)
            and sub.attr == attr
            and isinstance(sub.value, ast.Name)
            and sub.value.id == "self"
        ):
            return True
    return False


def _self_attr_writes(method: ast.FunctionDef) -> Iterator[Tuple[ast.stmt, str, str]]:
    """(stmt, state name, kind) for writes to self.<attr>; kind is
    "assign" or the AugAssign op class name."""
    for node in ast.walk(method):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                ):
                    yield node, tgt.attr, "assign"
        elif isinstance(node, ast.AugAssign):
            tgt = node.target
            if (
                isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self"
            ):
                yield node, tgt.attr, type(node.op).__name__
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            tgt = node.target
            if (
                isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self"
            ):
                yield node, tgt.attr, "assign"


def _is_extremum_rhs(rhs: ast.AST, attr: str) -> bool:
    """``torch.maximum(self.attr, ...)``-shaped RHS (top-level call)."""
    if not isinstance(rhs, ast.Call):
        return False
    name = rhs.func.attr if isinstance(rhs.func, ast.Attribute) else (
        rhs.func.id if isinstance(rhs.func, ast.Name) else None
    )
    if name not in _EXTREMUM_FNS:
        return False
    return any(_mentions_self_attr(a, attr) for a in rhs.args)


def _scatter_extremum_kind(rhs: ast.AST, attr: str) -> Optional[str]:
    """``"max"``/``"min"`` when the RHS is a scatter-extremum over
    ``self.<attr>`` -- ``self.x.scatter_reduce(0, ids, v, "amax")`` or
    ``self.x.index_reduce(0, ids, v, "amin")`` (``torch.maximum(self.x,
    segment_max(...))`` is caught by the top-level extremum check; this
    covers the scatter spelling that check cannot see)."""
    if not (
        isinstance(rhs, ast.Call)
        and isinstance(rhs.func, ast.Attribute)
        and rhs.func.attr in _SCATTER_REDUCE_METHODS
        and _mentions_self_attr(rhs.func.value, attr)
    ):
        return None
    mode = rhs.args[3] if len(rhs.args) >= 4 else next((kw.value for kw in rhs.keywords if kw.arg == "reduce"), None)
    if isinstance(mode, ast.Constant) and mode.value in _SCATTER_EXTREMUM_REDUCES:
        return _SCATTER_EXTREMUM_REDUCES[mode.value]
    return None


def _segment_extremum_name(rhs: ast.AST) -> Optional[str]:
    """The first ``segment_max``/``segment_min`` call name inside ``rhs``."""
    for sub in ast.walk(rhs):
        if isinstance(sub, ast.Call):
            name = _last_call_name(sub)
            if name in _SEGMENT_EXTREMUM_FNS:
                return name
    return None


def _additive_segment_extremum(rhs: ast.AST) -> Optional[str]:
    """The ``segment_max``/``segment_min`` call name when it is a TOP-LEVEL
    additive operand (``self.x + segment_max(...)``): summing a scattered
    extremum reads the prior value, so the overwrite check passes it, yet
    the accumulated quantity is an extremum -- not additive across ranks.
    Only the direct-operand shape is flagged; an extremum buried deeper
    (e.g. an indicator derived from one) may legitimately be additive."""
    if not (isinstance(rhs, ast.BinOp) and isinstance(rhs.op, _ADDITIVE_AUG_OPS)):
        return None
    for side in (rhs.left, rhs.right):
        if isinstance(side, ast.Call):
            name = _last_call_name(side)
            if name in _SEGMENT_EXTREMUM_FNS:
                return name
    return None


def _is_additive_rhs(rhs: ast.AST, attr: str) -> bool:
    """Additive accumulation forms: ``self.x + e`` / ``e + self.x`` /
    ``self.x - e`` (top-level BinOp) or ``self.x.index_add(...)``."""
    if isinstance(rhs, ast.BinOp) and isinstance(rhs.op, _ADDITIVE_AUG_OPS):
        return _mentions_self_attr(rhs.left, attr) or _mentions_self_attr(rhs.right, attr)
    if (
        isinstance(rhs, ast.Call)
        and isinstance(rhs.func, ast.Attribute)
        and rhs.func.attr in _ADD_METHOD_NAMES
        and _mentions_self_attr(rhs.func.value, attr)
    ):
        return True
    return False


def _is_bare_self_attr(node: ast.AST, attr: str) -> bool:
    """``self.<attr>`` exactly -- no scaling, no indexing, no wrapping."""
    return (
        isinstance(node, ast.Attribute)
        and node.attr == attr
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    )


def _direct_unscaled_additive(rhs: ast.AST, attr: str) -> bool:
    """``self.x + e`` / ``e + self.x`` / ``self.x - e`` with the BARE
    (unscaled) prior value as a top-level operand -- the write shape that
    never decays a decay leaf and ignores a ring leaf's rotation. A scaled
    operand (``alpha * self.x + e``) deliberately does NOT match."""
    if not (isinstance(rhs, ast.BinOp) and isinstance(rhs.op, _ADDITIVE_AUG_OPS)):
        return False
    return _is_bare_self_attr(rhs.left, attr) or _is_bare_self_attr(rhs.right, attr)


def _has_scaled_prior(rhs: ast.AST, attr: str) -> bool:
    """An ``alpha * self.x``-shaped multiplicative subexpression anywhere
    in ``rhs`` -- the decayed-accumulation signature."""
    for sub in ast.walk(rhs):
        if isinstance(sub, ast.BinOp) and isinstance(sub.op, (ast.Mult, ast.Pow)):
            if _mentions_self_attr(sub.left, attr) or _mentions_self_attr(sub.right, attr):
                return True
    return False


def _is_ring_rotation(rhs: ast.AST, attr: str) -> bool:
    """An indexed write on the leaf itself (``self.x.index_copy(0, slot,
    row)`` / ``index_put`` / ``index_add`` / ``index_fill`` / ``scatter``)
    -- the ring-rotation idiom: one slot changes, the other buckets' rows
    are untouched."""
    return (
        isinstance(rhs, ast.Call)
        and isinstance(rhs.func, ast.Attribute)
        and rhs.func.attr in ("index_copy", "index_put", "index_add", "index_fill", "scatter", "scatter_add")
        and _mentions_self_attr(rhs.func.value, attr)
    )


def _locals_reading_attr(method: ast.FunctionDef, attrs: Iterable[str]) -> Dict[str, Set[str]]:
    """attr -> local names whose assigned value reads ``self.<attr>``
    (transitively through other such locals) -- the two-step accumulation
    idiom ``new_total = self.total + x; self.total = new_total`` reads the
    prior value even though the final write's RHS does not mention it."""
    readers: Dict[str, Set[str]] = {attr: set() for attr in attrs}
    changed = True
    while changed:
        changed = False
        for node in ast.walk(method):
            if not (isinstance(node, ast.Assign) and node.value is not None):
                continue
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
            if not names:
                continue
            for attr, locs in readers.items():
                if _mentions_self_attr(node.value, attr) or any(
                    isinstance(sub, ast.Name) and sub.id in locs
                    for sub in ast.walk(node.value)
                ):
                    for name in names:
                        if name not in locs:
                            locs.add(name)
                            changed = True
    return readers


def _check_update_writes(
    method: ast.FunctionDef, reducers: Dict[str, str]
) -> Iterator[FlowFinding]:
    readers = _locals_reading_attr(method, reducers)
    for stmt, attr, kind in _self_attr_writes(method):
        reducer = reducers.get(attr)
        if reducer is None:
            continue
        rhs = getattr(stmt, "value", None)

        def rhs_reads_prior(expr: ast.AST) -> bool:
            if _mentions_self_attr(expr, attr):
                return True
            return any(
                isinstance(sub, ast.Name) and sub.id in readers[attr]
                for sub in ast.walk(expr)
            )

        # streaming-moment leaves ("moments", `moments_merge_fx()`) are
        # element-wise summable sufficient statistics: the cross-rank merge
        # IS addition, so every "sum" write contract applies verbatim
        if reducer in ("sum", "moments"):
            if kind == "assign":
                scatter = _scatter_extremum_kind(rhs, attr) if rhs is not None else None
                seg_add = _additive_segment_extremum(rhs) if rhs is not None else None
                if seg_add is not None:
                    yield FlowFinding(
                        stmt,
                        f"`\"{reducer}\"`-reduced state `{attr}` accumulates a `{seg_add}` "
                        f"result in `{method.name}`; a scattered extremum summed into "
                        "the state is not additive across ranks -- segment-SUM the "
                        "per-slice deltas, or declare the state "
                        '`dist_reduce_fx="max"/"min"` and fold through the extremum',
                    )
                elif scatter is not None:
                    seg = _segment_extremum_name(rhs)
                    spelled = f"`segment_{scatter}`" if seg else f"`scatter_reduce(..., \"a{scatter}\")`"
                    yield FlowFinding(
                        stmt,
                        f"`\"{reducer}\"`-reduced state `{attr}` updated with a slice-axis "
                        f"scatter-extremum ({spelled}) in `{method.name}`; scattered "
                        "extrema are not additive across ranks -- declare the state "
                        '`dist_reduce_fx="max"/"min"` or segment-SUM the per-slice '
                        "deltas instead",
                    )
                elif rhs is not None and _is_extremum_rhs(rhs, attr):
                    yield FlowFinding(
                        stmt,
                        f"`\"{reducer}\"`-reduced state `{attr}` updated with an extremum "
                        f"(`{_last_call_name(rhs)}`) in `{method.name}`; per-rank values stop "
                        "being additive and the cross-rank sum double-counts -- declare the "
                        'state `dist_reduce_fx="max"/"min"` or accumulate additively',
                    )
                elif rhs is not None and not rhs_reads_prior(rhs):
                    yield FlowFinding(
                        stmt,
                        f"`\"{reducer}\"`-reduced state `{attr}` overwritten in `{method.name}` "
                        "without reading its prior value; the overwrite discards earlier "
                        "batches on this rank -- accumulate additively "
                        f"(`self.{attr} = self.{attr} + delta`)",
                    )
            elif kind not in ("Add", "Sub"):
                yield FlowFinding(
                    stmt,
                    f"`\"{reducer}\"`-reduced state `{attr}` mutated with `{kind}` in "
                    f"`{method.name}`; only additive accumulation keeps per-rank values "
                    "summable across ranks",
                )
        elif reducer == "merge":
            # sketch leaves (sketches/): the leaf is a PACKED
            # structure whose only consistent accumulation is a self-merging
            # transform -- an insert/merge call that receives the prior leaf.
            # Element-wise arithmetic corrupts the (weight, key, payload)
            # layout the cross-rank merge reducer trusts.
            if kind in ("Add", "Sub") or (
                kind == "assign"
                and isinstance(rhs, ast.BinOp)
                and isinstance(rhs.op, _ADDITIVE_AUG_OPS)
            ):
                yield FlowFinding(
                    stmt,
                    f"`\"merge\"`-reduced sketch state `{attr}` accumulated additively in "
                    f"`{method.name}`; a packed sketch leaf is not element-wise summable -- "
                    "route the batch through the sketch's insert/merge transform "
                    f"(`self.{attr} = qsketch_insert(self.{attr}, ...)`)",
                )
            elif kind == "assign" and rhs is not None and not rhs_reads_prior(rhs):
                yield FlowFinding(
                    stmt,
                    f"`\"merge\"`-reduced sketch state `{attr}` overwritten in "
                    f"`{method.name}` without reading its prior value; the overwrite "
                    "discards earlier batches on this rank -- insert into the prior leaf "
                    "instead",
                )
            elif kind not in ("assign", "Add", "Sub"):
                yield FlowFinding(
                    stmt,
                    f"`\"merge\"`-reduced sketch state `{attr}` mutated with `{kind}` in "
                    f"`{method.name}`; only the sketch's own insert/merge transforms keep "
                    "the packed layout mergeable across ranks",
                )
        elif reducer == "decay":
            # exponentially-decayed sum leaves (windowed/):
            # the one consistent accumulation is decay-then-add -- the prior
            # value must be SCALED before the delta lands. A plain additive
            # write type-checks and sums, but the leaf silently stops
            # forgetting: it degrades to an all-of-time sum while every
            # consumer still reads it as "the recent window".
            if kind in ("Add", "Sub"):
                yield FlowFinding(
                    stmt,
                    f"`\"decay\"`-reduced state `{attr}` accumulated with a plain"
                    f" `{kind}` in `{method.name}`; an unscaled addition never decays"
                    " -- write the decayed form"
                    f" (`self.{attr} = alpha * self.{attr} + delta`)",
                )
            elif kind == "assign" and rhs is not None:
                if _direct_unscaled_additive(rhs, attr) and not _has_scaled_prior(rhs, attr):
                    yield FlowFinding(
                        stmt,
                        f"`\"decay\"`-reduced state `{attr}` accumulated additively"
                        f" without scaling the prior value in `{method.name}`; the"
                        " leaf degrades to an all-of-time sum -- write the decayed"
                        f" form (`self.{attr} = alpha * self.{attr} + delta`)",
                    )
                elif not rhs_reads_prior(rhs):
                    yield FlowFinding(
                        stmt,
                        f"`\"decay\"`-reduced state `{attr}` overwritten in"
                        f" `{method.name}` without reading its prior value; the"
                        " overwrite discards the decayed history on this rank",
                    )
        elif reducer == "ring":
            # ring-of-buckets leaves (windowed/): accumulation is a
            # ROTATION -- one slot is read, combined, and written back with
            # an indexed write; a whole-leaf additive write pours
            # the batch into EVERY bucket's row, so expired buckets never
            # evict and every window over-counts.
            if kind in ("Add", "Sub"):
                yield FlowFinding(
                    stmt,
                    f"`\"ring\"`-reduced state `{attr}` accumulated with a"
                    f" whole-leaf `{kind}` in `{method.name}`; ring leaves rotate"
                    " one slot per bucket -- write through"
                    f" `self.{attr} = self.{attr}.index_copy(0, slot, row)`",
                )
            elif kind == "assign" and rhs is not None:
                if _is_ring_rotation(rhs, attr):
                    pass  # the ring-rotation idiom: reducer-consistent
                elif _direct_unscaled_additive(rhs, attr):
                    yield FlowFinding(
                        stmt,
                        f"`\"ring\"`-reduced state `{attr}` accumulated with a"
                        f" whole-leaf addition in `{method.name}`; the batch lands"
                        " in every bucket's row and expired buckets never evict --"
                        f" rotate one slot (`self.{attr}.index_copy(0, slot, row)`)",
                    )
                elif not rhs_reads_prior(rhs):
                    yield FlowFinding(
                        stmt,
                        f"`\"ring\"`-reduced state `{attr}` overwritten in"
                        f" `{method.name}` without reading its prior value; the"
                        " overwrite wipes every bucket's row, not one slot",
                    )
        elif reducer in ("max", "min"):
            additive = (kind in ("Add", "Sub")) or (
                kind == "assign" and rhs is not None and _is_additive_rhs(rhs, attr)
            )
            scatter = (
                _scatter_extremum_kind(rhs, attr) if kind == "assign" and rhs is not None else None
            )
            if additive:
                yield FlowFinding(
                    stmt,
                    f"`\"{reducer}\"`-reduced state `{attr}` accumulated additively in "
                    f"`{method.name}`; an extremum-reduced leaf must be updated with "
                    f"`torch.{'maximum' if reducer == 'max' else 'minimum'}(self.{attr}, ...)` "
                    "or its cross-rank reduction is meaningless",
                )
            elif scatter is not None and scatter != reducer:
                # a matching scatter-extremum (`scatter_reduce(..., "amax")` into a
                # "max"-reduced leaf) is the reducer-consistent sliced form
                # and passes; only the MISMATCHED direction is flagged
                yield FlowFinding(
                    stmt,
                    f"`\"{reducer}\"`-reduced state `{attr}` updated with a "
                    f"`scatter_reduce(..., \"a{scatter}\")` in `{method.name}`; the scatter "
                    f"direction contradicts the declared `\"{reducer}\"` reduction",
                )


def _last_call_name(rhs: ast.AST) -> str:
    if isinstance(rhs, ast.Call):
        if isinstance(rhs.func, ast.Attribute):
            return rhs.func.attr
        if isinstance(rhs.func, ast.Name):
            return rhs.func.id
    return "?"


def _calls_super_reset(method: ast.FunctionDef) -> bool:
    for node in ast.walk(method):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr == "reset":
            # super().reset() / Metric.reset(self): base-class reset restores
            # every registered default. `child.reset()` on some OTHER object
            # does NOT -- it must not satisfy the restoration check.
            if isinstance(func.value, ast.Call) and isinstance(func.value.func, ast.Name) and func.value.func.id == "super":
                return True
            if (
                isinstance(func.value, ast.Name)
                and func.value.id != "self"
                and any(isinstance(a, ast.Name) and a.id == "self" for a in node.args)
            ):
                return True
    return False


def _check_reset(
    class_node: ast.ClassDef, reducers: Dict[str, str], all_states: Set[str]
) -> Iterator[FlowFinding]:
    reset = next(
        (s for s in class_node.body if isinstance(s, ast.FunctionDef) and s.name == "reset"),
        None,
    )
    if reset is None or _calls_super_reset(reset):
        return
    restored = {attr for _, attr, _ in _self_attr_writes(reset)}
    missing = sorted(all_states - restored)
    if missing:
        yield FlowFinding(
            reset,
            f"`reset` override restores {sorted(restored & all_states)} but not "
            f"{missing} and never calls `super().reset()`; unrestored state leaks "
            "across epochs",
        )


def _check_live_leaves(
    ctx: FileContext, class_node: ast.ClassDef, own_states: Set[str]
) -> Iterator[FlowFinding]:
    has_update = any(
        isinstance(s, ast.FunctionDef) and s.name in ("_update", "update")
        for s in class_node.body
    )
    if not has_update or not own_states:
        return
    # liveness is file-scoped: in-file subclasses and helpers may own the
    # read/write side of a base-registered leaf. The add_state name argument
    # itself does not count as a touch -- it IS the registration.
    registration_names: Set[int] = set()
    for node in ast.walk(ctx.tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "add_state"
            and node.args
        ):
            registration_names.add(id(node.args[0]))
    touched: Set[str] = set()
    for node in ast.walk(ctx.tree):
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            touched.add(node.attr)
        elif (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and id(node) not in registration_names
        ):
            # getattr(self, name) / dynamic state access by string literal
            touched.add(node.value)
    for name in sorted(own_states):
        if name not in touched:
            yield FlowFinding(
                class_node,
                f"state `{name}` is registered but never read or written anywhere in "
                "this file; dead state still pays sync bytes every compute (typo'd "
                "attribute?)",
            )


def analyze_class(ctx: FileContext, class_node: ast.ClassDef) -> List[FlowFinding]:
    """All TL-FLOW findings for one class."""
    reducers = _state_reducers(class_node)
    findings: List[FlowFinding] = []
    own_states: Set[str] = set()
    for node in ast.walk(class_node):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "add_state"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "self"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            own_states.add(node.args[0].value)
    for stmt in class_node.body:
        if isinstance(stmt, ast.FunctionDef) and stmt.name in _UPDATE_METHODS:
            findings.extend(_check_update_writes(stmt, reducers))
    findings.extend(_check_reset(class_node, reducers, own_states))
    findings.extend(_check_live_leaves(ctx, class_node, own_states))
    return findings
