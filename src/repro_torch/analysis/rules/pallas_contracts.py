"""RPR006 — the CUDA launch contract (the ``pl.pallas_call`` contract's
counterpart).

Every kernel of the port is launched through ctypes:
``cuda_build.entry(<name>)(<args>)`` binds the ``extern "C"`` function
that ``cuda_build.ENTRY_POINTS[<name>]`` names — ``(library, symbol,
argtypes)``, one library per ``csrc/<library>.cu`` — and calls it with
positional arguments.  Four things must agree: the call site's argument
count, the ``argtypes`` list, and the C signature, in a library and under
a symbol that exist.  Nothing checks that before a launch on the card:
the CPU tests take the plain twins and never reach the call, and ctypes
converts a short or long argument list into garbage on the device rather
than an error.  The reference's RPR006 closes the same "passes on the CPU,
breaks on the device" gap for ``pallas_call`` (grid rank, aliases).

Checked at every ``cuda_build.entry(<name>)(...)`` call in the kernel
modules, with ``ENTRY_POINTS`` read from ``cuda_build.py``'s AST (never
imported) and the signatures from ``csrc/*.cu`` under the analysis root:

* **(a)** ``<name>`` is a key of ``ENTRY_POINTS``;
* **(b)** the positional argument count equals the length of its
  ``argtypes`` (a sum of ``[_X] * k`` lists, evaluated statically); the
  call passes no keyword;
* **(c)** the symbol is defined as ``extern "C" int <symbol>(...)`` in
  ``csrc/<library>.cu`` with as many parameters as ``argtypes`` has
  entries, each of the ctypes type its C type needs (a pointer
  ``c_void_p``, ``long long`` ``c_longlong``: a 64-bit value passed as a
  32-bit int is cut without a word);
* **(d)** the returned code is checked — bound to a name that is then
  passed to ``_check_launch(err, ...)`` or tested by ``if err != 0:
  raise`` — never dropped;
* **(e)** the call sits after the wrapper's operand checks (a call of a
  ``_check*`` function other than ``_check_launch``) on every path: a
  check in a statement that precedes, in the same function, the
  statement holding the launch (at its own level or an enclosing one).
  A private function (leading underscore) may leave the check to its
  callers in the file: then every reference to it there (a call, or a
  use as a value such as ``launch = mix_vector if ... else mix_generic``)
  must sit after a check, recursively.  A public one is reachable from
  outside the file and checks for itself.

A launch whose entry name is a parameter (``_launch(lib, ...)``) is
resolved to the literals the same file's callers pass in its position; a
``*args`` operand to a tuple assigned in the same function, or to the
caller's extra positional arguments when it is the function's ``*extra``.
What cannot be resolved is reported as such.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.analysis.engine import (FileContext, Finding, Rule,
                                         param_names, register)

CUDA_BUILD = "src/repro_torch/kernels/cuda_build.py"
CSRC = "src/repro_torch/csrc"
ENTRY_FQ = "repro_torch.kernels.cuda_build.entry"
_C_SCALARS = {"int": "c_int", "unsigned int": "c_uint",
              "long long": "c_longlong", "float": "c_float"}
_SIG_RE = r'extern\s+"C"\s+int\s+{}\s*\(([^)]*)\)\s*\{{'


class Unresolved(Exception):
    """A launch site whose entry name or argument count the AST does not
    fix."""


# ---------------------------------------------------------------------------
# The contract: ENTRY_POINTS and the C signatures
# ---------------------------------------------------------------------------
def _ctypes_aliases(tree: ast.Module) -> Dict[str, str]:
    """Module-level names bound to ``ctypes.c_*`` (``_P, _I = (ctypes.
    c_void_p, ctypes.c_int)`` or one by one) → the ctypes type name."""
    out: Dict[str, str] = {}
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
            continue
        tgt, val = stmt.targets[0], stmt.value
        pairs = (zip(tgt.elts, val.elts)
                 if isinstance(tgt, ast.Tuple) and isinstance(val, ast.Tuple)
                 else [(tgt, val)])
        for t, v in pairs:
            if isinstance(t, ast.Name) and isinstance(v, ast.Attribute) \
                    and isinstance(v.value, ast.Name) \
                    and v.value.id == "ctypes":
                out[t.id] = v.attr
    return out


def _eval_argtypes(node: ast.AST, aliases: Dict[str, str]) -> List[str]:
    """The ctypes type names of an ``argtypes`` expression: lists of
    aliases, joined by ``+`` and repeated by ``* <int>``."""
    if isinstance(node, ast.List):
        out = []
        for e in node.elts:
            if isinstance(e, ast.Name) and e.id in aliases:
                out.append(aliases[e.id])
            elif isinstance(e, ast.Attribute) and isinstance(
                    e.value, ast.Name) and e.value.id == "ctypes":
                out.append(e.attr)
            else:
                raise Unresolved(ast.unparse(e))
        return out
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return (_eval_argtypes(node.left, aliases)
                + _eval_argtypes(node.right, aliases))
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        for lst, k in ((node.left, node.right), (node.right, node.left)):
            if isinstance(k, ast.Constant) and isinstance(k.value, int):
                return _eval_argtypes(lst, aliases) * k.value
    raise Unresolved(ast.unparse(node))


def entry_points(root: Path) -> Dict[str, Tuple[str, str, List[str]]]:
    """``ENTRY_POINTS`` of ``cuda_build.py`` under ``root``, read from its
    AST: name → (library, symbol, ctypes type names)."""
    tree = ast.parse((root / CUDA_BUILD).read_text())
    aliases = _ctypes_aliases(tree)
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "ENTRY_POINTS"
                for t in stmt.targets) and isinstance(stmt.value, ast.Dict):
            out = {}
            for k, v in zip(stmt.value.keys, stmt.value.values):
                lib, sym, types = v.elts
                out[k.value] = (lib.value, sym.value,
                                _eval_argtypes(types, aliases))
            return out
    raise Unresolved(f"no ENTRY_POINTS dict in {CUDA_BUILD}")


def c_signature(root: Path, library: str, symbol: str
                ) -> Optional[List[str]]:
    """The ctypes type each parameter of ``extern "C" int <symbol>(...)``
    in ``csrc/<library>.cu`` needs (None: no such definition)."""
    path = root / CSRC / f"{library}.cu"
    if not path.exists():
        return None
    m = re.search(_SIG_RE.format(re.escape(symbol)), path.read_text())
    if m is None:
        return None
    types = []
    for param in m.group(1).split(","):
        if not param.strip():
            continue
        if "*" in param:
            types.append("c_void_p")
        else:
            words = param.replace("const", " ").split()
            types.append(_C_SCALARS.get(" ".join(words[:-1]), "?"))
    return types


# ---------------------------------------------------------------------------
# Launch sites
# ---------------------------------------------------------------------------
def is_launch(ctx: FileContext, node: ast.AST) -> bool:
    """``cuda_build.entry(<name>)(...)``."""
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Call)
            and ctx.resolve(node.func.func) == ENTRY_FQ)


def _callers(ctx: FileContext, fn: ast.FunctionDef) -> List[ast.Call]:
    return [n for n in ctx.nodes if isinstance(n, ast.Call) and (
        (isinstance(n.func, ast.Name) and n.func.id == fn.name)
        or (isinstance(n.func, ast.Attribute) and n.func.attr == fn.name))]


def _caller_arg(fn: ast.FunctionDef, call: ast.Call, param: str
                ) -> Optional[ast.expr]:
    positional = [p.arg for p in fn.args.posonlyargs + fn.args.args]
    if param in positional:
        i = positional.index(param)
        if i < len(call.args) and not any(
                isinstance(a, ast.Starred) for a in call.args[:i + 1]):
            return call.args[i]
    return next((kw.value for kw in call.keywords if kw.arg == param), None)


def _starred_count(ctx: FileContext, fn: ast.FunctionDef, name: str,
                   caller: Optional[ast.Call]) -> int:
    """Elements of ``*name`` at a launch in ``fn`` (for ``caller``'s
    binding when ``name`` is ``fn``'s ``*extra``)."""
    if fn.args.vararg is not None and fn.args.vararg.arg == name:
        if caller is None or any(isinstance(a, ast.Starred)
                                 for a in caller.args):
            raise Unresolved(f"*{name}")
        fixed = len(fn.args.posonlyargs + fn.args.args)
        return max(len(caller.args) - fixed, 0)
    sizes = {len(s.value.elts) for s in ctx.walk(fn)
             if isinstance(s, ast.Assign) and len(s.targets) == 1
             and isinstance(s.targets[0], ast.Name)
             and s.targets[0].id == name and isinstance(s.value, ast.Tuple)
             and not any(isinstance(e, ast.Starred) for e in s.value.elts)}
    if len(sizes) != 1:
        raise Unresolved(f"*{name}")
    return sizes.pop()


def resolve_launch(ctx: FileContext, call: ast.Call
                   ) -> List[Tuple[str, int]]:
    """``[(entry name, positional argument count)]`` of a launch site, one
    per binding its enclosing function's callers give it; raises
    :class:`Unresolved`."""
    fn = ctx.enclosing_function(call)
    name_arg = call.func.args[0] if call.func.args else None
    bindings: List[Tuple[Optional[str], Optional[ast.Call]]]
    if isinstance(name_arg, ast.Constant) and isinstance(name_arg.value,
                                                         str):
        bindings = [(name_arg.value, None)]
        needs_caller = fn is not None and fn.args.vararg is not None and any(
            isinstance(a, ast.Starred) and isinstance(a.value, ast.Name)
            and a.value.id == fn.args.vararg.arg for a in call.args)
        if needs_caller:
            bindings = [(name_arg.value, c) for c in _callers(ctx, fn)]
    elif isinstance(name_arg, ast.Name) and fn is not None \
            and name_arg.id in param_names(fn):
        bindings = []
        for c in _callers(ctx, fn):
            v = _caller_arg(fn, c, name_arg.id)
            if not (isinstance(v, ast.Constant) and isinstance(v.value,
                                                               str)):
                raise Unresolved(f"{name_arg.id} at line {c.lineno}")
            bindings.append((v.value, c))
    else:
        raise Unresolved("the entry name")
    if not bindings:
        raise Unresolved("no caller in the file binds the entry name")
    out = []
    for name, caller in bindings:
        count = 0
        for a in call.args:
            if isinstance(a, ast.Starred):
                if not isinstance(a.value, ast.Name):
                    raise Unresolved(ast.unparse(a))
                count += _starred_count(ctx, fn, a.value.id, caller)
            else:
                count += 1
        out.append((name, count))
    return out


def launch_sites(ctx: FileContext) -> List[ast.Call]:
    return [n for n in ctx.nodes if is_launch(ctx, n)]


# ---------------------------------------------------------------------------
# (d) the return code, (e) the operand checks
# ---------------------------------------------------------------------------
def _is_operand_check(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    name = f.id if isinstance(f, ast.Name) else (
        f.attr if isinstance(f, ast.Attribute) else "")
    return name.startswith("_check") and name != "_check_launch"


def _stmt_checks(stmt: ast.stmt) -> bool:
    """A statement that runs an operand check unconditionally: an
    expression, assignment or ``return`` whose value calls one."""
    if isinstance(stmt, (ast.Expr, ast.Assign, ast.AnnAssign,
                         ast.AugAssign)) and stmt.value is not None:
        return any(_is_operand_check(n) for n in ast.walk(stmt.value))
    return False


def _blocks_of(node: ast.AST) -> List[List[ast.stmt]]:
    return [getattr(node, f) for f in ("body", "orelse", "finalbody")
            if isinstance(getattr(node, f, None), list)] + [
        h.body for h in getattr(node, "handlers", [])]


def _dominated(ctx: FileContext, node: ast.AST) -> bool:
    """Whether a statement before ``node``'s statement (at its level or an
    enclosing one, within its function) runs an operand check."""
    fn = ctx.enclosing_function(node)
    cur = node
    while cur is not None and cur is not fn:
        parent = ctx.parent(cur)
        if parent is None:
            break
        for block in _blocks_of(parent):
            if cur in block:
                if any(_stmt_checks(s) for s in block[:block.index(cur)]):
                    return True
        cur = parent
    return False


def _guarded(ctx: FileContext, node: ast.AST, seen: set) -> bool:
    if _dominated(ctx, node):
        return True
    fn = ctx.enclosing_function(node)
    if fn is None or not fn.name.startswith("_") or fn in seen:
        return False
    seen = seen | {fn}
    refs = [n for n in ctx.nodes
            if isinstance(n, ast.Name) and n.id == fn.name
            and isinstance(n.ctx, ast.Load)]
    refs += [n for n in ctx.nodes
             if isinstance(n, ast.Attribute) and n.attr == fn.name]
    return bool(refs) and all(_guarded(ctx, r, seen) for r in refs)


def _code_checked(ctx: FileContext, call: ast.Call) -> bool:
    stmt = ctx.parent(call)
    if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)):
        return False
    err = stmt.targets[0].id
    fn = ctx.enclosing_function(call) or ctx.tree
    for n in ctx.walk(fn):
        if getattr(n, "lineno", 0) <= stmt.lineno:
            continue
        if isinstance(n, ast.Call) and n.args \
                and isinstance(n.args[0], ast.Name) and n.args[0].id == err \
                and ((isinstance(n.func, ast.Name)
                      and n.func.id == "_check_launch")
                     or (isinstance(n.func, ast.Attribute)
                         and n.func.attr == "_check_launch")):
            return True
        if isinstance(n, ast.If) and err in {
                x.id for x in ast.walk(n.test) if isinstance(x, ast.Name)} \
                and any(isinstance(s, ast.Raise) for s in n.body):
            return True
    return False


@register
class CudaLaunchContractRule(Rule):
    """Every kernel launch matches ENTRY_POINTS and its C signature."""
    id = "RPR006"
    title = "CUDA launch contract violation"
    design_ref = "kernels/cuda_build.py ENTRY_POINTS, csrc/*.cu"
    path_globs = ("src/repro_torch/kernels/*.py",)

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        sites = launch_sites(ctx)
        if not sites:
            return
        try:
            table = entry_points(ctx.root)
        except (OSError, Unresolved, ValueError, AttributeError) as e:
            for call in sites:
                yield ctx.finding(self, call, f"cannot read ENTRY_POINTS "
                                  f"from {CUDA_BUILD}: {e}")
            return
        for call in sites:
            yield from self._check_site(ctx, call, table)

    def _check_site(self, ctx, call, table) -> Iterator[Finding]:
        ref = self.design_ref
        if call.keywords:
            yield ctx.finding(self, call, "keyword arguments to a ctypes "
                              f"entry point: pass every argument "
                              f"positionally ({ref})")
        try:
            resolved = resolve_launch(ctx, call)
        except Unresolved as e:
            yield ctx.finding(
                self, call, f"launch site not resolvable statically ({e}): "
                f"pass the entry name as a literal or through a parameter "
                f"the file's callers bind to one ({ref})")
            resolved = []
        for name, count in resolved:
            if name not in table:
                yield ctx.finding(
                    self, call, f"entry point {name!r} is not a key of "
                    f"ENTRY_POINTS ({ref})")
                continue
            library, symbol, argtypes = table[name]
            if count != len(argtypes):
                yield ctx.finding(
                    self, call, f"{name!r} launched with {count} "
                    f"argument(s), its argtypes have {len(argtypes)}: "
                    f"ctypes hands the kernel garbage on the card ({ref})")
            sig = c_signature(ctx.root, library, symbol)
            if sig is None:
                yield ctx.finding(
                    self, call, f"no extern \"C\" int {symbol}(...) in "
                    f"{CSRC}/{library}.cu ({ref})")
            elif len(sig) != len(argtypes):
                yield ctx.finding(
                    self, call, f"{symbol} takes {len(sig)} parameter(s) "
                    f"in {library}.cu, ENTRY_POINTS[{name!r}] lists "
                    f"{len(argtypes)} argtypes ({ref})")
            elif sig != argtypes:
                bad = [i for i, (c, p) in enumerate(zip(sig, argtypes))
                       if c != p]
                yield ctx.finding(
                    self, call, f"{symbol}'s parameter(s) {bad} need "
                    f"{[sig[i] for i in bad]}, ENTRY_POINTS[{name!r}] "
                    f"binds {[argtypes[i] for i in bad]} ({ref})")
        if not _code_checked(ctx, call):
            yield ctx.finding(
                self, call, "the launch's return code is dropped: bind it "
                "and pass it to _check_launch (or raise on err != 0) — a "
                f"refused launch would otherwise pass silently ({ref})")
        if not _guarded(ctx, call, set()):
            yield ctx.finding(
                self, call, "launch not preceded on every path by the "
                "wrapper's operand checks (a _check* call): a wrong "
                "dtype, device or layout reaches the kernel unchecked "
                f"({ref})")
