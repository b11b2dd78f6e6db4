"""Static-analysis engine for the port's invariants.

The port's correctness rests on conventions that its CPU tests cannot
see, because they only break on the card: hot paths free of host
synchronizations (ROADMAP C.5: a CPU scalar tensor in ``torch.where``
made 24 synchronizing calls a step, and a scalar written into a CUDA
tensor in the MoE dispatch one more), the ``CommSpec`` call form of
``communicate``, the
aliasing contract of the overlap buffer and of the in-place kernel
launches, data rather than keys for what changes at runtime, the counter
hash as the round's only randomness, and the ctypes launch contract of
the hand-written CUDA kernels (a wrong argument count or an unchecked
return code passes on the CPU, where no kernel launches).  Each
:class:`Rule` in :mod:`repro_torch.analysis.rules` checks one of them over
the AST; this module owns the shared machinery:

* per-file parsing and :class:`FileContext` construction (import-alias
  resolution, parent links, enclosing-function qualnames);
* inline suppressions — ``# repro: allow(RPR001)`` (comma-separate for
  several rules) on the flagged line or the line directly above it
  silences a finding; the comment is also where its reason is written.
  The spelling is the reference's, so one marker means the same to both
  engines;
* a tracked **baseline** (``src/repro_torch/analysis/baseline.json``) for
  pre-existing findings: entries are ``{rule, path, count, note}`` and
  absorb up to ``count`` findings of ``rule`` in ``path``;
* text / JSON / GitHub-annotation reporting for the CLI
  (``python -m repro_torch.analysis``).

The modules of this package import only the standard library; importing
the package still loads ``torch``, through ``repro_torch/__init__.py``.
"""
from __future__ import annotations

import ast
import dataclasses
import fnmatch
import json
import re
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

__all__ = [
    "Finding", "Rule", "FileContext", "register", "all_rules",
    "analyze_file", "analyze_paths", "load_baseline", "apply_baseline",
    "write_baseline", "format_findings", "Baseline",
]


# ---------------------------------------------------------------------------
# Findings
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""
    rule: str          # "RPR001"
    path: str          # root-relative posix path
    line: int          # 1-based
    col: int           # 0-based (ast convention)
    message: str

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# File context shared by every rule
# ---------------------------------------------------------------------------
def module_name(path: str) -> Optional[str]:
    """Dotted module of a root-relative ``src/<pkg>/...py`` path, else
    None: ``src/repro_torch/core/mixing.py`` is
    ``repro_torch.core.mixing``."""
    if not (path.startswith("src/") and path.endswith(".py")):
        return None
    parts = path[len("src/"):-len(".py")].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) or None


class FileContext:
    """Parsed file + the cross-rule lookups every visitor needs.

    ``imports`` maps local names to fully-qualified dotted module/object
    paths (``np`` → ``numpy``, ``mixing`` → ``repro_torch.core.mixing``),
    so rules match call targets structurally instead of by surface
    spelling.  A bare name defined at the top level of a module under
    ``src/`` resolves to ``<module>.<name>``, so a module's calls of its
    own functions match as its importers' do.
    """

    def __init__(self, path: str, source: str, tree: ast.Module,
                 root: Optional[Path] = None):
        self.path = path            # posix, relative to the analysis root
        self.root = root            # the analysis root (rules reading
                                    # sibling files resolve against it)
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.parents: Dict[ast.AST, ast.AST] = {}
        self.children: Dict[ast.AST, List[ast.AST]] = {}
        self._stacks: Dict[ast.AST, Tuple[str, ...]] = {}
        self.nodes: List[ast.AST] = []     # every node, in preorder
        self._index(tree)
        self.imports = _collect_imports(self.nodes)
        self.module = module_name(path)
        self.top_defs = {n.name for n in tree.body if isinstance(
            n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))}

    def _index(self, tree: ast.Module) -> None:
        """One pass over the tree: parents, children, the enclosing
        definitions of every node, and the preorder node list that the
        rules walk instead of re-walking the tree."""
        stack: List[Tuple[ast.AST, Optional[ast.AST], Tuple[str, ...]]] = [
            (tree, None, ())]
        while stack:
            node, parent, defs = stack.pop()
            if parent is not None:
                self.parents[node] = parent
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                defs = defs + (node.name,)
            self._stacks[node] = defs
            kids = list(ast.iter_child_nodes(node))
            self.children[node] = kids
            self.nodes.append(node)
            stack.extend((k, node, defs) for k in reversed(kids))

    # -- lookups ----------------------------------------------------------
    def qualname(self, node: ast.AST) -> str:
        """Dotted enclosing definition name ('' at module level)."""
        return ".".join(self._stacks.get(node, ()))

    def walk(self, node: ast.AST) -> Iterator[ast.AST]:
        """``node`` and everything below it, in preorder (``ast.walk``
        over the indexed children)."""
        stack = [node]
        while stack:
            n = stack.pop()
            yield n
            kids = self.children.get(n)
            if kids is None:
                kids = list(ast.iter_child_nodes(n))
            stack.extend(reversed(kids))

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self.parents.get(node)

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Fully-qualified dotted name of an expression, if it is a plain
        (possibly aliased) attribute chain — else None."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        if node.id in self.imports:
            root = self.imports[node.id]
        elif node.id in self.top_defs and self.module:
            root = f"{self.module}.{node.id}"
        else:
            root = node.id
        return ".".join([root] + list(reversed(parts)))

    def enclosing_function(self, node: ast.AST
                           ) -> Optional[ast.FunctionDef]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self.parents.get(cur)
        return None

    def functions(self) -> Iterator[ast.FunctionDef]:
        """Every (possibly nested) function definition of the file."""
        for node in self.nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node

    def finding(self, rule: "Rule", node: ast.AST, message: str) -> Finding:
        return Finding(rule=rule.id, path=self.path,
                       line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0), message=message)


def _collect_imports(nodes: Iterable[ast.AST]) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for node in nodes:
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def param_names(fn: ast.FunctionDef) -> List[str]:
    """Every parameter name of ``fn``, in order (``*args``/``**kw``
    included)."""
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args]
    if a.vararg:
        names.append(a.vararg.arg)
    names += [p.arg for p in a.kwonlyargs]
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


# ---------------------------------------------------------------------------
# Rule registry
# ---------------------------------------------------------------------------
class Rule:
    """One checkable convention.  Subclasses set the class attributes and
    implement :meth:`check`; the docstring names the invariant the port
    holds and why (surfaced by ``--list-rules``)."""

    id: str = ""            # "RPRxxx"
    title: str = ""
    design_ref: str = ""    # where the invariant is recorded

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        raise NotImplementedError

    # paths the rule applies to; default: every analyzed file
    path_globs: Tuple[str, ...] = ("*",)

    def applies_to(self, path: str) -> bool:
        return any(fnmatch.fnmatch(path, g) for g in self.path_globs)


_REGISTRY: Dict[str, Rule] = {}


def register(cls):
    """Class decorator adding a rule (by instance) to the registry."""
    inst = cls()
    if not inst.id or inst.id in _REGISTRY:
        raise ValueError(f"rule id missing or duplicated: {inst.id!r}")
    _REGISTRY[inst.id] = inst
    return cls


def all_rules() -> List[Rule]:
    # import for side effect: the rules package registers on import
    from repro_torch.analysis import rules as _rules  # noqa: F401
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


# ---------------------------------------------------------------------------
# Suppressions:  # repro: allow(RPR001[, RPR002])  [— reason]
# ---------------------------------------------------------------------------
_ALLOW_RE = re.compile(r"#\s*repro:\s*allow\(([^)]*)\)")


def _suppressions(lines: List[str]) -> Dict[int, set]:
    """Map of 1-based line numbers to the set of rule ids allowed there.
    An allow comment covers its own line and, when it is the whole line
    (a comment-only line), the line below it."""
    out: Dict[int, set] = {}
    for i, line in enumerate(lines, 1):
        m = _ALLOW_RE.search(line)
        if not m:
            continue
        ids = {s.strip() for s in m.group(1).split(",") if s.strip()}
        out.setdefault(i, set()).update(ids)
        if line.lstrip().startswith("#"):
            out.setdefault(i + 1, set()).update(ids)
    return out


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Baseline:
    """Tracked debt: ``entries[(rule, path)] -> (count, note)``."""
    entries: Dict[Tuple[str, str], Tuple[int, str]]

    @staticmethod
    def empty() -> "Baseline":
        return Baseline(entries={})


def load_baseline(path: Path) -> Baseline:
    if not path.exists():
        return Baseline.empty()
    data = json.loads(path.read_text())
    entries: Dict[Tuple[str, str], Tuple[int, str]] = {}
    for e in data.get("entries", []):
        key = (e["rule"], e["path"])
        entries[key] = (int(e.get("count", 1)), e.get("note", ""))
    return Baseline(entries=entries)


def apply_baseline(findings: List[Finding], baseline: Baseline
                   ) -> Tuple[List[Finding], int]:
    """Drop up to ``count`` findings per baselined (rule, path); returns
    (remaining findings, number absorbed)."""
    budget = {k: c for k, (c, _note) in baseline.entries.items()}
    kept: List[Finding] = []
    absorbed = 0
    for f in findings:
        key = (f.rule, f.path)
        if budget.get(key, 0) > 0:
            budget[key] -= 1
            absorbed += 1
        else:
            kept.append(f)
    return kept, absorbed


def write_baseline(path: Path, findings: List[Finding]) -> None:
    groups: Dict[Tuple[str, str], int] = {}
    for f in findings:
        groups[(f.rule, f.path)] = groups.get((f.rule, f.path), 0) + 1
    entries = [{"rule": r, "path": p, "count": c,
                "note": "TODO: justify or fix"}
               for (r, p), c in sorted(groups.items())]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"version": 1, "entries": entries},
                               indent=2) + "\n")


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------
def analyze_file(root: Path, file: Path,
                 rules: Optional[List[Rule]] = None
                 ) -> Tuple[List[Finding], int]:
    """Run every applicable rule over one file; returns
    (findings, n_suppressed).  A syntax error is itself a finding
    (RPR000) so a broken file can never silently pass the gate."""
    rules = rules if rules is not None else all_rules()
    rel = file.relative_to(root).as_posix()
    source = file.read_text()
    try:
        tree = ast.parse(source, filename=str(file))
    except SyntaxError as e:
        return [Finding(rule="RPR000", path=rel, line=e.lineno or 1,
                        col=e.offset or 0,
                        message=f"syntax error: {e.msg}")], 0
    ctx = FileContext(rel, source, tree, root)
    allow = _suppressions(ctx.lines)
    findings: List[Finding] = []
    suppressed = 0
    for rule in rules:
        if not rule.applies_to(rel):
            continue
        for f in rule.check(ctx):
            if f.rule in allow.get(f.line, ()):
                suppressed += 1
            else:
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, suppressed


def is_glob(target: str) -> bool:
    return any(c in target for c in "*?[")


def iter_python_files(root: Path, targets: Iterable[str]) -> Iterator[Path]:
    """The ``.py`` files of ``targets`` (files, directories walked
    recursively, or globs relative to ``root``), each once, in order."""
    seen = set()
    for t in targets:
        p = (root / t) if not Path(t).is_absolute() else Path(t)
        if is_glob(t):
            found = sorted(root.glob(t))
        elif p.is_dir():
            found = sorted(p.rglob("*.py"))
        else:
            found = [p]
        for f in found:
            if f.is_file() and f.suffix == ".py" \
                    and "__pycache__" not in f.parts and f not in seen:
                seen.add(f)
                yield f


def analyze_paths(root: Path, targets: List[str],
                  rules: Optional[List[Rule]] = None
                  ) -> Tuple[List[Finding], int]:
    findings: List[Finding] = []
    suppressed = 0
    for f in iter_python_files(root, targets):
        fs, sup = analyze_file(root, f, rules)
        findings.extend(fs)
        suppressed += sup
    return findings, suppressed


# ---------------------------------------------------------------------------
# Reporting
# ---------------------------------------------------------------------------
def format_findings(findings: List[Finding], fmt: str, *,
                    suppressed: int = 0, baselined: int = 0) -> str:
    if fmt == "json":
        counts: Dict[str, int] = {}
        for f in findings:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        return json.dumps({
            "version": 1,
            "findings": [f.to_dict() for f in findings],
            "counts": counts,
            "suppressed": suppressed,
            "baselined": baselined,
        }, indent=2)
    if fmt == "github":
        # one workflow-command annotation per finding
        return "\n".join(
            f"::error file={f.path},line={f.line},col={f.col + 1},"
            f"title={f.rule}::{f.message}" for f in findings)
    if fmt == "text":
        lines = [f"{f.path}:{f.line}:{f.col + 1}: {f.rule} {f.message}"
                 for f in findings]
        tail = (f"{len(findings)} finding(s)"
                f" ({suppressed} suppressed, {baselined} baselined)")
        return "\n".join(lines + [tail])
    raise ValueError(f"unknown format {fmt!r} "
                     f"(expected text, json, or github)")
