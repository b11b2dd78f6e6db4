"""RPR003 — the port's aliasing contract (ROADMAP B, hazard "Aliasing").

The reference guards XLA donation; the port donates nothing, but it has
the same hazard in two places, and a CPU test sees neither unless the
aliasing happens to change a value it compares:

* the **overlap buffer**: ``mixing.start_round`` / ``overlap_flush``
  return a buffer that is read one step later.  The dense buffer is a
  copy that owns its storage (``start_round`` copies), because the fused
  rounds consume staging buffers in place and the optimizer's outputs
  become the next state: a buffer sharing storage with the params could
  change under the step.  A caller that keeps such a buffer beside the
  params it came from must not make them share storage again;
* the **in-place launches**: ``mix_flat`` and ``collective_flat`` take
  ``inplace=`` and then write the round's output over their operand.
  That is only sound for a private staging buffer nobody reads again;
  on a caller's tensor it overwrites the caller's params.

Two checks:

* **(a) alias-escape** (the reference's walk, path-sensitive over
  ``if``/``elif`` arms): a name bound from ``start_round(src, ...)`` (or
  the buffer slot of ``overlap_flush``) escapes — via ``return`` together
  with ``src`` (containment through constructor calls like
  ``TrainState(params=src)`` is followed), or via an attribute store —
  without an interposed copy.  The port's copy spellings are
  ``.clone()``, ``torch.clone``, ``tree_map(torch.clone, ...)``,
  ``copy_`` and ``.to(..., copy=True)``.
* **(b) in-place launch**: a call with ``inplace=`` (the kernel
  wrappers' keyword) whose value is not a literal ``False``, where the
  operand (the first argument, through ``.contiguous()``/views) is a
  parameter of the enclosing function or a local bound from an expression
  over one — a caller's tensor.  Two spellings are accepted, by pattern:
  ``inplace=<p>`` with ``<p>`` the enclosing function's own parameter
  (it forwards the caller's decision, which this check then holds at
  the caller), and ``inplace=<name>`` with ``<name>`` bound in the same
  function to a data-pointer test on the operand —
  ``<name> = <operand>.data_ptr() != <other>.data_ptr()``, a later
  binding possibly ``and``-ing ``<name>`` with more such tests — the
  staging buffer's proof that ``_pack_rows``/``flatten_nodes`` made a
  private copy.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.engine import (FileContext, Finding, Rule,
                                         param_names, register)

PRIMING_CALLS = {
    "repro_torch.core.mixing.start_round",
    "repro_torch.core.mixing.overlap_flush",
}
_COPY_ATTRS = {"clone", "copy_"}
# torch functions that may return a view of (or the same) tensor
_TORCH_VIEWS = {"torch.as_tensor", "torch.reshape", "torch.flatten",
                "torch.squeeze", "torch.unsqueeze", "torch.narrow",
                "torch.select", "torch.t", "torch.transpose",
                "torch.permute", "torch.atleast_2d"}
# methods that return (or may return) their receiver's storage
_VIEW_METHODS = {"contiguous", "view", "reshape", "flatten", "to",
                 "float", "squeeze", "unsqueeze", "expand", "t",
                 "transpose", "permute"}


def _names(node: Optional[ast.AST]) -> Set[str]:
    if node is None:
        return set()
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _has_copy_call(node: ast.AST) -> bool:
    """True when the expression pipes its value through one of the
    port's copies (directly or as ``tree_map(torch.clone, ...)``)."""
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr in _COPY_ATTRS:
            return True
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr == "to" and any(
                    kw.arg == "copy" and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True for kw in n.keywords):
            return True
    return False


def _contained_names(node: ast.AST) -> Set[str]:
    """Names whose referents the expression plausibly *keeps a reference
    to*: plain names, tuple/list/dict literals, and constructor-style
    calls (Capitalized func, or ``.replace(...)``).  Ordinary function
    calls compute fresh values and do not propagate containment."""
    if isinstance(node, ast.Name):
        return {node.id}
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out: Set[str] = set()
        for e in node.elts:
            out |= _contained_names(e)
        return out
    if isinstance(node, ast.Dict):
        out = set()
        for v in node.values:
            out |= _contained_names(v)
        return out
    if isinstance(node, ast.Starred):
        return _contained_names(node.value)
    if isinstance(node, ast.Attribute):
        return _contained_names(node.value)
    if isinstance(node, ast.Call):
        fname = node.func.attr if isinstance(node.func, ast.Attribute) \
            else (node.func.id if isinstance(node.func, ast.Name) else "")
        if fname[:1].isupper() or fname == "replace":
            out = set()
            for a in node.args:
                out |= _contained_names(a)
            for kw in node.keywords:
                out |= _contained_names(kw.value)
            return out
    return set()


def _root_name(node: ast.AST) -> Optional[str]:
    """The name an operand expression reads its storage from, through
    view-like methods, subscripts and attributes (``xf.contiguous()`` →
    ``xf``), else None."""
    while True:
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _VIEW_METHODS:
            node = node.func.value
        elif isinstance(node, (ast.Subscript, ast.Attribute)):
            node = node.value
        else:
            return None


def _data_ptr_receivers(node: ast.AST) -> Set[str]:
    """Root names compared by a ``!=`` of ``.data_ptr()`` calls anywhere in
    ``node`` (the private-staging-buffer test)."""
    out: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Compare) and len(n.ops) == 1 \
                and isinstance(n.ops[0], ast.NotEq):
            for side in (n.left, n.comparators[0]):
                if isinstance(side, ast.Call) \
                        and isinstance(side.func, ast.Attribute) \
                        and side.func.attr == "data_ptr":
                    root = _root_name(side.func.value)
                    if root is not None:
                        out.add(root)
    return out


@register
class DonationRule(Rule):
    """Overlap buffers and in-place launches write no caller's storage."""
    id = "RPR003"
    title = "aliasing hazard: shared overlap buffer or in-place launch"
    design_ref = "ROADMAP B (Aliasing), core/mixing.start_round"

    #: cap on forked (hazards, contains) path states per function; states
    #: beyond it are merged into the last one kept (conservative, keeps
    #: every hazard alive)
    MAX_STATES = 64

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        inplace: Dict[ast.AST, List[ast.Call]] = {}
        for n in ctx.nodes:
            if isinstance(n, ast.Call) and n.args and any(
                    kw.arg == "inplace" for kw in n.keywords):
                fn = ctx.enclosing_function(n)
                if fn is not None:
                    inplace.setdefault(fn, []).append(n)
        for node in ctx.functions():
            findings: List[Finding] = []
            self._walk_block(ctx, node.body, [({}, {})], findings)
            seen = set()
            for f in findings:
                key = (f.line, f.message)
                if key not in seen:
                    seen.add(key)
                    yield f
            if node in inplace:
                yield from self._check_inplace(ctx, node, inplace[node])

    # ------------------------------------------------------------------
    # (a) alias-escape
    # ------------------------------------------------------------------
    def _priming(self, ctx: FileContext, stmt: ast.Assign
                 ) -> Optional[Tuple[str, Set[str]]]:
        """If ``stmt`` binds a priming-call result, return
        (buffer name, aliased source names)."""
        call = stmt.value
        if not isinstance(call, ast.Call):
            return None
        fq = ctx.resolve(call.func)
        if fq not in PRIMING_CALLS:
            return None
        tgt = stmt.targets[0]
        elts = tgt.elts if isinstance(tgt, ast.Tuple) else [tgt]
        names = [e.id if isinstance(e, ast.Name) else None for e in elts]
        if fq.endswith("start_round"):
            # buf = start_round(src, ...)  |  buf, ef = start_round(...)
            buf = names[0]
            src = _names(call.args[0] if call.args else None)
        else:
            # params, buf, ef = overlap_flush(...): buf aliases params
            if len(names) < 2 or names[0] is None:
                return None
            buf, src = names[1], {names[0]}
        if buf is None or not src:
            return None
        return buf, src

    # one path state: (hazards, contains); the walk carries a list of
    # them and forks at every if/elif arm
    def _walk_block(self, ctx: FileContext, stmts: List[ast.stmt],
                    states: List[Tuple[Dict[str, Set[str]],
                                       Dict[str, Set[str]]]],
                    findings: List[Finding]
                    ) -> List[Tuple[Dict[str, Set[str]],
                                    Dict[str, Set[str]]]]:
        for stmt in stmts:
            if isinstance(stmt, ast.Assign):
                for hazards, contains in states:
                    self._assign(ctx, stmt, hazards, contains, findings)
            elif isinstance(stmt, ast.Return) and stmt.value is not None:
                for hazards, contains in states:
                    self._check_return(ctx, stmt, hazards, contains,
                                       findings)
            elif isinstance(stmt, ast.If):
                forked = []
                for hazards, contains in states:
                    forked += self._walk_block(
                        ctx, stmt.body,
                        [(dict(hazards), dict(contains))], findings)
                    forked += self._walk_block(
                        ctx, stmt.orelse,
                        [(dict(hazards), dict(contains))], findings)
                states = self._dedupe(forked)
            elif isinstance(stmt, (ast.For, ast.While)):
                states = self._walk_block(ctx, stmt.body, states,
                                          findings)
                states = self._walk_block(ctx, stmt.orelse, states,
                                          findings)
            elif isinstance(stmt, ast.With):
                states = self._walk_block(ctx, stmt.body, states,
                                          findings)
            elif isinstance(stmt, ast.Try):
                states = self._walk_block(ctx, stmt.body, states,
                                          findings)
                for handler in stmt.handlers:
                    self._walk_block(
                        ctx, handler.body,
                        [(dict(h), dict(c)) for h, c in states],
                        findings)
                states = self._walk_block(ctx, stmt.finalbody, states,
                                          findings)
        return states

    def _assign(self, ctx: FileContext, stmt: ast.Assign,
                hazards: Dict[str, Set[str]],
                contains: Dict[str, Set[str]],
                findings: List[Finding]) -> None:
        prime = self._priming(ctx, stmt)
        if prime is not None:
            buf, src = prime
            hazards[buf] = src
            contains.pop(buf, None)
            return
        tgts: List[ast.expr] = []
        for t in stmt.targets:
            tgts.extend(t.elts if isinstance(t, ast.Tuple) else [t])
        # attribute-store escape: self.x = <expr using buf>
        for t in tgts:
            if isinstance(t, ast.Attribute):
                used = _names(stmt.value) & set(hazards)
                if used and not _has_copy_call(stmt.value):
                    findings.append(ctx.finding(
                        self, stmt,
                        f"start_round/overlap_flush buffer "
                        f"{sorted(used)[0]!r} stored without a copy while "
                        f"its params stay live: keep it private (clone) "
                        f"so the next step's in-place rounds cannot write "
                        f"through it ({self.design_ref})"))
        for t in tgts:
            if isinstance(t, ast.Name):
                # rebind: a copy rebind sanitizes; any other
                # rebind replaces the binding entirely
                hazards.pop(t.id, None)
                contains[t.id] = _contained_names(stmt.value)

    def _check_return(self, ctx: FileContext, stmt: ast.Return,
                      hazards: Dict[str, Set[str]],
                      contains: Dict[str, Set[str]],
                      findings: List[Finding]) -> None:
        ret = self._closure(_contained_names(stmt.value), contains)
        for buf, src in hazards.items():
            if buf in ret and (src & ret):
                findings.append(ctx.finding(
                    self, stmt,
                    f"buffer {buf!r} (taken from "
                    f"{sorted(src & ret)[0]!r}) returned beside it "
                    f"un-copied: the next step writes the params in "
                    f"place; re-bind via tree_map(torch.clone, {buf}) "
                    f"before returning ({self.design_ref})"))

    def _dedupe(self, states):
        """Collapse identical path states (arms that never touch a
        tracked name fork into equal states) and cap the population."""
        out, keys = [], set()
        for hazards, contains in states:
            key = (
                frozenset((k, frozenset(v))
                          for k, v in hazards.items()),
                frozenset((k, frozenset(v))
                          for k, v in contains.items() if v),
            )
            if key not in keys:
                keys.add(key)
                out.append((hazards, contains))
        if len(out) > self.MAX_STATES:
            # conservative merge of the overflow into one state so no
            # hazard is dropped
            head, tail = out[:self.MAX_STATES - 1], out[self.MAX_STATES - 1:]
            mh: Dict[str, Set[str]] = {}
            mc: Dict[str, Set[str]] = {}
            for hazards, contains in tail:
                for k, v in hazards.items():
                    mh.setdefault(k, set()).update(v)
                for k, v in contains.items():
                    mc.setdefault(k, set()).update(v)
            out = head + [(mh, mc)]
        return out

    @staticmethod
    def _closure(names: Set[str], contains: Dict[str, Set[str]]
                 ) -> Set[str]:
        out, frontier = set(names), list(names)
        while frontier:
            n = frontier.pop()
            for m in contains.get(n, ()):
                if m not in out:
                    out.add(m)
                    frontier.append(m)
        return out

    # ------------------------------------------------------------------
    # (b) in-place launch
    # ------------------------------------------------------------------
    def _check_inplace(self, ctx: FileContext, fn: ast.FunctionDef,
                       calls: List[ast.Call]) -> Iterator[Finding]:
        params = set(param_names(fn))
        binds: Dict[str, List[ast.expr]] = {}
        for stmt in _own_nodes(ctx, fn):
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    for name, value in _pairs(t, stmt.value):
                        binds.setdefault(name, []).append(value)
        derived = _derived(ctx, params, binds)
        for call in calls:
            val = next(kw.value for kw in call.keywords
                       if kw.arg == "inplace")
            if isinstance(val, ast.Constant) and val.value is False:
                continue
            root = _root_name(call.args[0])
            if root is None or root not in derived:
                continue            # a fresh buffer of this function
            if isinstance(val, ast.Name) and val.id in params:
                continue            # forwards the caller's decision
            if isinstance(val, ast.Name) and binds.get(val.id) and all(
                    root in _data_ptr_receivers(b)
                    or (val.id in _names(b) and _data_ptr_receivers(b))
                    for b in binds[val.id]):
                continue            # a private-staging-buffer test
            yield ctx.finding(
                self, call,
                f"in-place launch on {root!r}, a caller's tensor (or a "
                f"view of one): the kernel writes its output over it. "
                f"Pass inplace=False, or a data-pointer test that proves "
                f"the operand a private copy ({self.design_ref})")


def _own_nodes(ctx: FileContext, fn: ast.FunctionDef) -> Iterator[ast.AST]:
    """The nodes of ``fn``'s body, not descending into nested
    definitions (each is checked on its own)."""
    stack = list(fn.body)
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
            stack.extend(ctx.children[n])


def _pairs(target: ast.AST, value: ast.AST):
    """``(name, value)`` bindings of an assignment, element by element
    when both sides are tuples of one length."""
    if isinstance(target, ast.Name):
        yield target.id, value
    elif isinstance(target, (ast.Tuple, ast.List)):
        if isinstance(value, (ast.Tuple, ast.List)) \
                and len(value.elts) == len(target.elts):
            for t, v in zip(target.elts, value.elts):
                yield from _pairs(t, v)
        else:
            for t in target.elts:
                yield from _pairs(t, value)


def _may_alias(ctx: FileContext, value: ast.AST, derived: Set[str]) -> bool:
    """Whether ``value`` may share storage with a name in ``derived``: a
    view of one, or the result of a call that takes one (``_pack_rows``,
    ``flatten_nodes`` may hand their input back).  A copy, and a
    ``torch.*`` function that is not a view, make a fresh tensor."""
    if isinstance(value, (ast.Tuple, ast.List)):
        return any(_may_alias(ctx, e, derived) for e in value.elts)
    if isinstance(value, ast.IfExp):
        return (_may_alias(ctx, value.body, derived)
                or _may_alias(ctx, value.orelse, derived))
    if isinstance(value, (ast.Name, ast.Subscript, ast.Attribute)):
        return _root_name(value) in derived
    if not isinstance(value, ast.Call) or _has_copy_call(value):
        return False
    fq = ctx.resolve(value.func) or ""
    if isinstance(value.func, ast.Attribute) \
            and value.func.attr in _VIEW_METHODS:
        return _root_name(value.func.value) in derived
    if fq.startswith("torch.") and fq not in _TORCH_VIEWS:
        return False
    operands = list(value.args) + [kw.value for kw in value.keywords]
    return any(_may_alias(ctx, a, derived) for a in operands)


def _derived(ctx: FileContext, params: Set[str],
             binds: Dict[str, List[ast.expr]]) -> Set[str]:
    """Parameters and the locals that may share storage with one (to a
    fixpoint)."""
    out = set(params)
    changed = True
    while changed:
        changed = False
        for name, values in binds.items():
            if name not in out and any(_may_alias(ctx, v, out)
                                       for v in values):
                out.add(name)
                changed = True
    return out
