"""tracelint engine: file contexts, suppression pragmas, and the run loop.

Counterpart of ``metrics_tpu/analysis/engine.py``. Stdlib-only
(ast/pathlib/re): ``python -m metrics_tpu_torch.analysis`` parses the
port's sources as text and never imports torch. Rules receive a
:class:`FileContext` (parsed tree + import-alias maps for ``torch``,
``torch.nn.functional``, ``torch.distributed`` and ``numpy``) and yield
:class:`Violation` records; the engine drops violations whose source line
carries a ``# tracelint: disable=RULE-ID`` pragma (the JAX package's
syntax) and hands the rest to the baseline partitioner.
"""
from __future__ import annotations

import ast
import pathlib
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: the package whose invariants the rules encode; relpaths are computed
#: against this directory so path-scoped rules (TL-COLLECTIVE, TL-PRINT)
#: stay stable no matter where the checkout lives
PACKAGE_NAME = "metrics_tpu_torch"

_PRAGMA_RE = re.compile(r"#\s*tracelint:\s*disable=([A-Za-z0-9_\-,\s]+)")
_FILE_PRAGMA_RE = re.compile(r"#\s*tracelint:\s*disable-file=([A-Za-z0-9_\-,\s]+)")


def suppressed_rules(line_text: str) -> Set[str]:
    """Rule ids disabled by a ``# tracelint: disable=...`` pragma on a line.

    Ids are comma-separated and case-insensitive; ``all`` disables every
    rule. Text after the id list (a justification) is permitted:
    ``# tracelint: disable=TL-TRACE (eager-only guard)``.
    """
    match = _PRAGMA_RE.search(line_text)
    if not match:
        return set()
    return {tok.strip().upper() for tok in match.group(1).split(",") if tok.strip()}


def file_suppressed_rules(lines: Sequence[str], tree: ast.Module) -> Set[str]:
    """Rule ids disabled file-wide by ``# tracelint: disable-file=...``.

    Only the module docstring line region is honored (the header lines up to
    and including the docstring statement, or the comment block preceding the
    first statement) -- a file-wide waiver is a visible, top-of-file decision,
    never something buried mid-module. ``all`` disables every rule.
    """
    if tree.body:
        first = tree.body[0]
        is_docstring = (
            isinstance(first, ast.Expr)
            and isinstance(first.value, ast.Constant)
            and isinstance(first.value.value, str)
        )
        last_line = (getattr(first, "end_lineno", first.lineno) or first.lineno) if is_docstring else max(
            first.lineno - 1, 0
        )
    else:
        last_line = len(lines)
    rules: Set[str] = set()
    for text in lines[:last_line]:
        match = _FILE_PRAGMA_RE.search(text)
        if match:
            rules.update(tok.strip().upper() for tok in match.group(1).split(",") if tok.strip())
    return rules


def _dotted_chain(node: ast.AST) -> List[str]:
    """``torch.nn.functional`` -> ["torch", "nn", "functional"]; [] when not
    a pure Name/Attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return []


@dataclass(frozen=True)
class Violation:
    """One rule finding, addressed by package-relative path.

    ``snippet`` (the stripped source line) -- not the line number -- is the
    stable half of the baseline key, so unrelated edits above a
    grandfathered violation don't invalidate the baseline.
    """

    rule: str
    path: str
    line: int
    col: int
    message: str
    snippet: str

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.snippet)

    def to_dict(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "snippet": self.snippet,
        }

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


class FileContext:
    """Parsed view of one source file handed to every rule."""

    def __init__(self, path: Optional[pathlib.Path], relpath: str, source: str) -> None:
        self.path = path
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=relpath)
        self._alias_maps: Optional[Dict[str, Set[str]]] = None
        self._member_maps: Optional[Dict[str, Dict[str, str]]] = None
        self._file_suppressed: Optional[Set[str]] = None

    # ------------------------------------------------------------------
    # import-alias maps (lazy; shared by several rules)
    # ------------------------------------------------------------------
    def _aliases(self) -> Dict[str, Set[str]]:
        if self._alias_maps is not None:
            return self._alias_maps
        numpy: Set[str] = set()
        torch_names: Set[str] = set()
        functional: Set[str] = set()
        dist: Set[str] = set()
        warnings_mod: Set[str] = set()
        warn_fns: Set[str] = set()
        dist_members: Dict[str, str] = {}
        torch_members: Dict[str, str] = {}
        numpy_members: Dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    bound = alias.asname or alias.name.split(".")[0]
                    if alias.name == "numpy":
                        numpy.add(bound)
                    elif alias.name == "torch" or (alias.name.startswith("torch.") and not alias.asname):
                        # `import torch.distributed` binds `torch` too
                        torch_names.add(bound)
                    elif alias.name == "torch.nn.functional":
                        functional.add(bound)
                    elif alias.name == "torch.distributed":
                        dist.add(bound)
                    elif alias.name == "warnings":
                        warnings_mod.add(bound)
            elif isinstance(node, ast.ImportFrom):
                for alias in node.names:
                    bound = alias.asname or alias.name
                    if node.module == "torch" and alias.name == "distributed":
                        dist.add(bound)
                    elif node.module == "torch.nn" and alias.name == "functional":
                        functional.add(bound)
                    elif node.module == "torch":
                        # `from torch import cat [as c]`: bound -> member
                        torch_members[bound] = alias.name
                    elif node.module == "numpy":
                        # direct-member imports (`from numpy import asarray`)
                        # are host pullers at the call site; record bound ->
                        # original so rules can key on the member name
                        numpy_members[bound] = alias.name
                    elif node.module == "warnings" and alias.name == "warn":
                        warn_fns.add(bound)
                    elif node.module == "torch.distributed":
                        dist_members[bound] = alias.name
        # simple same-file rebindings (`dist = torch.distributed`, `F =
        # torch.nn.functional`): a Name-to-Name or Name-to-dotted-chain
        # assignment re-aliases the module object, and every rule keyed on
        # the original alias must follow it. MODULE-LEVEL assignments only
        # -- a function-local shadow must not re-alias a name file-wide.
        # Fixed-point so chained rebindings (`a = torch; b = a`) resolve
        # regardless of statement order.
        rebinds: List[Tuple[str, object]] = []
        for node in self.tree.body:
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, (ast.Name, ast.Attribute))
            ):
                rebinds.append((node.targets[0].id, node.value))
        changed = True
        while changed:
            changed = False
            for bound, value in rebinds:
                chain = _dotted_chain(value)
                for names, canonical in (
                    (torch_names, ["torch"]),
                    (functional, ["torch", "nn", "functional"]),
                    (dist, ["torch", "distributed"]),
                    (numpy, ["numpy"]),
                ):
                    if bound in names:
                        continue
                    root_match = chain and (
                        chain == canonical or (len(chain) == 1 and chain[0] in names)
                    )
                    # `x = torch.distributed` via a torch alias root
                    attr_match = (
                        len(chain) == len(canonical)
                        and len(chain) > 1
                        and chain[0] in torch_names
                        and chain[1:] == canonical[1:]
                    )
                    if root_match or attr_match:
                        names.add(bound)
                        changed = True
        self._member_maps = {"torch_members": torch_members, "numpy_members": numpy_members}
        self._alias_maps = {
            "numpy": numpy,
            "torch": torch_names,
            "functional": functional,
            "dist": dist,
            "warnings": warnings_mod,
            "warn_fns": warn_fns,
            "dist_names": dist_members,
        }
        return self._alias_maps

    @property
    def numpy_aliases(self) -> Set[str]:
        return self._aliases()["numpy"]

    @property
    def torch_aliases(self) -> Set[str]:
        """Names bound to the ``torch`` module."""
        return self._aliases()["torch"]

    @property
    def functional_aliases(self) -> Set[str]:
        """Names bound to ``torch.nn.functional`` (``F``)."""
        return self._aliases()["functional"]

    @property
    def dist_aliases(self) -> Set[str]:
        """Names bound to ``torch.distributed`` (``dist``)."""
        return self._aliases()["dist"]

    @property
    def warnings_aliases(self) -> Set[str]:
        return self._aliases()["warnings"]

    @property
    def warn_fn_aliases(self) -> Set[str]:
        return self._aliases()["warn_fns"]

    @property
    def dist_from_imports(self) -> Dict[str, str]:
        """``from torch.distributed import all_reduce [as ar]`` -> {"ar": "all_reduce"}."""
        return self._aliases()["dist_names"]

    @property
    def torch_member_imports(self) -> Dict[str, str]:
        """``from torch import cat [as c]`` -> {"c": "cat"}."""
        self._aliases()
        return self._member_maps["torch_members"]

    @property
    def numpy_member_imports(self) -> Dict[str, str]:
        """``from numpy import asarray [as aa]`` -> {"aa": "asarray"}."""
        self._aliases()
        return self._member_maps["numpy_members"]

    @property
    def file_suppressed(self) -> Set[str]:
        """Rule ids waived for the whole file by a docstring-region
        ``# tracelint: disable-file=...`` pragma (``ALL`` waives every rule)."""
        if self._file_suppressed is None:
            self._file_suppressed = file_suppressed_rules(self.lines, self.tree)
        return self._file_suppressed

    # ------------------------------------------------------------------
    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def violation(self, rule_id: str, node: ast.AST, message: str) -> Violation:
        lineno = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Violation(
            rule=rule_id,
            path=self.relpath,
            line=lineno,
            col=col,
            message=message,
            snippet=self.line_text(lineno).strip(),
        )


@dataclass
class LintResult:
    """Outcome of one analyzer run (pre-baseline partitioning)."""

    violations: List[Violation] = field(default_factory=list)
    suppressed: List[Violation] = field(default_factory=list)
    n_files: int = 0
    parse_errors: List[str] = field(default_factory=list)
    #: package-relative paths of every file analyzed -- lets the CLI scope
    #: baseline updates/staleness to the analyzed subset
    relpaths: List[str] = field(default_factory=list)


def default_package_root() -> pathlib.Path:
    """The ``metrics_tpu_torch`` package directory (this file's grandparent)."""
    return pathlib.Path(__file__).resolve().parent.parent


def package_relpath(path: pathlib.Path) -> str:
    """Posix path relative to the ``metrics_tpu_torch`` package dir when the file
    lives under one; otherwise the bare filename (test fixtures, scripts)."""
    parts = list(path.resolve().parts)
    if PACKAGE_NAME in parts:
        idx = len(parts) - 1 - parts[::-1].index(PACKAGE_NAME)
        tail = parts[idx + 1 :]
        if tail:
            return "/".join(tail)
    return path.name


def run_rules(ctx: FileContext, rules: Sequence) -> Tuple[List[Violation], List[Violation]]:
    """Run ``rules`` over one file; returns (kept, pragma-suppressed)."""
    kept: List[Violation] = []
    suppressed: List[Violation] = []
    file_disabled = ctx.file_suppressed
    for rule in rules:
        if "ALL" in file_disabled or rule.id.upper() in file_disabled:
            continue  # file-wide waiver: the rule never runs on this file
        for violation in rule.check(ctx):
            disabled = suppressed_rules(ctx.line_text(violation.line))
            if "ALL" in disabled or violation.rule.upper() in disabled:
                suppressed.append(violation)
            else:
                kept.append(violation)
    return kept, suppressed


def analyze_source(
    source: str,
    relpath: str = "<string>",
    rules: Optional[Sequence] = None,
    path: Optional[pathlib.Path] = None,
) -> Tuple[List[Violation], List[Violation]]:
    """Analyze a source string (the test-fixture entry point)."""
    from .rules import all_rules

    ctx = FileContext(path, relpath, source)
    return run_rules(ctx, rules if rules is not None else all_rules())


def iter_python_files(paths: Iterable[pathlib.Path]) -> List[pathlib.Path]:
    files: List[pathlib.Path] = []
    for p in paths:
        p = pathlib.Path(p)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    return files


def analyze_paths(
    paths: Optional[Iterable[pathlib.Path]] = None,
    rules: Optional[Sequence] = None,
) -> LintResult:
    """Analyze every ``*.py`` under ``paths`` (default: the whole package)."""
    from .rules import all_rules

    if paths is None:
        paths = [default_package_root()]
    if rules is None:
        rules = all_rules()
    result = LintResult()
    for path in iter_python_files(paths):
        try:
            ctx = FileContext(path, package_relpath(path), path.read_text())
        except (SyntaxError, UnicodeDecodeError) as err:
            result.parse_errors.append(f"{path}: {err}")
            continue
        kept, suppressed = run_rules(ctx, rules)
        result.violations.extend(kept)
        result.suppressed.extend(suppressed)
        result.n_files += 1
        result.relpaths.append(ctx.relpath)
    result.violations.sort(key=lambda v: (v.path, v.line, v.rule))
    return result
