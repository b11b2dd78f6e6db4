"""RPR004 — what changes at runtime is data, never a step-variant key.

The reference's invariant: everything that varies at runtime
is a traced jit operand; the push-sum matrix ``W`` and the live mask
change every round under faults and cross the jit boundary as data, and
the Trainer's compile cache is keyed host-side on the genuinely static
``(phase, shift, buf_shift)``.  The port compiles nothing — no
``jax.jit``, no ``torch.compile`` — so the reference's checks of
``static_argnums``/``static_argnames`` have nothing to read.  What
carries over is the contract itself, on the port's **variant caches**:
the Trainer's ``_get_step_fn(phase, shift, buf_shift)`` (one built step
per key), its ``_variant_scope(key)`` and ``simulate``'s ``once(key)``
(each meters a variant's first call, as the reference meters each
compiled variant once), and any ``functools.lru_cache``'d builder (such
as ``mixing_cuda._device_factors``, one upload per round kind).  A value
that changes every step in a key position makes a new variant every
step: a step rebuilt, a round re-metered or re-uploaded, a cache that
grows without bound.

A **variant-keyed function** is one defined in the same file that
memoizes on some of its parameters: it tests one — or a name bound to a
tuple of them — for membership in a container and stores it there
(``if key not in self._steps: self._steps[key] = ...``,
``metered.add(key)``), or it is ``functools.lru_cache``/``cache``-
decorated (every parameter is a key).  Each
argument in such a parameter's position (or keyword) is a key position.
Three checks, on every call of such a function in the port's package
(a test helper that memoizes reference outputs by shape is no step
variant):

* inside a ``for``/``while`` loop, a **loop-varying name** in a key
  position: the loop target, or a name assigned in the loop from an
  expression that reads a loop-varying name.  The schedule's answers
  are static by construction: a value computed by a schedule method
  (``advance``, ``peek_phase``, ``phase``, ``gossip_shift_step``) is a
  phase name or a shift reduced modulo the topology's period, so a name
  bound from one is not loop-varying even though the step ``k`` flows
  into it;
* a ``dict``/``list``/``set`` literal (or comprehension) in a key
  position — unhashable, a ``TypeError`` at the first call;
* ``W`` or ``active`` (the push-sum round's runtime operands) in a key
  position or as a key parameter's name: a fault pattern must never be a
  new variant.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set

from repro_torch.analysis.engine import (FileContext, Finding, Rule,
                                         param_names, register)

TRACED_OPERANDS = {"W", "active"}
SCHEDULE_METHODS = {"advance", "peek_phase", "phase", "gossip_shift_step"}
_CACHE_DECORATORS = {"functools.lru_cache", "functools.cache"}
_UNHASHABLE = (ast.Dict, ast.List, ast.Set, ast.DictComp, ast.ListComp,
               ast.SetComp)


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` of an attribute chain rooted at a name, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    return ".".join([node.id] + parts[::-1])


def _names_outside_schedule(node: ast.AST) -> Set[str]:
    """Names and attribute chains (``self._buf_shift``, with every prefix)
    an expression reads, leaving out what flows into a schedule method
    call (its result is static by construction)."""
    out: Set[str] = set()
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr in SCHEDULE_METHODS:
            continue
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            chain = _dotted(n)
            if chain is not None:
                parts = chain.split(".")
                out |= {".".join(parts[:i]) for i in range(2, len(parts) + 1)}
        stack.extend(ast.iter_child_nodes(n))
    return out


def _stored(target: ast.AST) -> Set[str]:
    """What an assignment target rebinds: names, and attribute chains for
    attribute stores (``self.x = ...`` changes ``self.x``, not ``self``).
    A subscript store mutates a container and rebinds nothing."""
    if isinstance(target, ast.Name):
        return {target.id}
    if isinstance(target, ast.Attribute):
        chain = _dotted(target)
        return {chain} if chain else set()
    if isinstance(target, (ast.Tuple, ast.List)):
        return set().union(*(_stored(e) for e in target.elts))
    if isinstance(target, ast.Starred):
        return _stored(target.value)
    return set()


@register
class RecompileRule(Rule):
    """Runtime data never becomes a step-variant key."""
    id = "RPR004"
    title = "runtime value in a step-variant key"
    design_ref = "ROADMAP A.12; train/trainer.py _get_step_fn"
    # the port's step loops; a test's memo of reference outputs keyed by
    # shape is not a step variant
    path_globs = ("src/repro_torch/*",)

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        keyed = self._variant_keyed(ctx)
        for fn, _positions, keys in keyed.values():
            for w in sorted(TRACED_OPERANDS & keys):
                yield ctx.finding(
                    self, fn,
                    f"{fn.name}() keys its cache on {w!r}: the push-sum "
                    f"round's W/active are runtime data by contract — a "
                    f"fault pattern must never make a new variant "
                    f"({self.design_ref})")
        for call in ctx.nodes:
            if not isinstance(call, ast.Call):
                continue
            name = (call.func.attr if isinstance(call.func, ast.Attribute)
                    else call.func.id if isinstance(call.func, ast.Name)
                    else None)
            if name not in keyed:
                continue
            _fn, positions, kwnames = keyed[name]
            slots = [(f"position {i}", call.args[i]) for i in positions
                     if i < len(call.args)]
            slots += [(f"keyword {kw.arg!r}", kw.value)
                      for kw in call.keywords if kw.arg in kwnames]
            varying = self._loop_varying(ctx, call)
            for where, val in slots:
                yield from self._check_slot(ctx, call, name, where, val,
                                            varying)

    # ------------------------------------------------------------------
    def _variant_keyed(self, ctx: FileContext) -> Dict[str, tuple]:
        """name -> (def, key positions in a call, key keyword names) of
        every variant-keyed function defined in the file."""
        out: Dict[str, tuple] = {}
        for fn in ctx.functions():
            params = param_names(fn)
            keys = self._key_params(ctx, fn, params)
            if not keys:
                continue
            positional = [p.arg for p in fn.args.posonlyargs + fn.args.args]
            offset = 1 if positional[:1] in (["self"], ["cls"]) else 0
            positions = [i - offset for i, p in enumerate(positional)
                         if p in keys and i >= offset]
            out[fn.name] = (fn, positions, keys)
        return out

    @staticmethod
    def _key_params(ctx: FileContext, fn: ast.FunctionDef,
                    params: List[str]) -> Set[str]:
        """The parameters ``fn`` keys a cache on: all of them under
        ``lru_cache``/``cache``; else those tested for membership in a
        container that the function also stores the key into
        (``C[key] = ...``, ``C.add(key)``, ``C.setdefault(key, ...)``),
        directly or through a name bound to a tuple of them."""
        real = [p for p in params if p not in ("self", "cls")]
        for dec in fn.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            if ctx.resolve(target) in _CACHE_DECORATORS:
                return set(real)
        tuples: Dict[str, Set[str]] = {}
        stores: Set[tuple] = set()
        for node in ctx.walk(fn):
            if isinstance(node, ast.Assign):
                t = node.targets[0]
                if len(node.targets) == 1 and isinstance(t, ast.Name) \
                        and isinstance(node.value, ast.Tuple):
                    tuples[t.id] = {e.id for e in node.value.elts
                                    if isinstance(e, ast.Name)
                                    and e.id in real}
                for tgt in node.targets:
                    if isinstance(tgt, ast.Subscript) \
                            and isinstance(tgt.slice, ast.Name):
                        stores.add((ast.dump(tgt.value), tgt.slice.id))
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("add", "setdefault") \
                    and node.args and isinstance(node.args[0], ast.Name):
                stores.add((ast.dump(node.func.value), node.args[0].id))
        keys: Set[str] = set()
        for cmp in ctx.walk(fn):
            if isinstance(cmp, ast.Compare) and len(cmp.ops) == 1 \
                    and isinstance(cmp.ops[0], (ast.In, ast.NotIn)) \
                    and isinstance(cmp.left, ast.Name) \
                    and (ast.dump(cmp.comparators[0]),
                         cmp.left.id) in stores:
                left = cmp.left.id
                if left in real:
                    keys.add(left)
                elif left in tuples:
                    keys |= tuples[left]
        return keys

    @staticmethod
    def _loop_varying(ctx: FileContext, call: ast.Call) -> Set[str]:
        """Loop-varying names at ``call``: over every loop enclosing it
        (within its function), the loop targets and the names assigned in
        the loop from an expression reading one (to a fixpoint)."""
        varying: Set[str] = set()
        cur = ctx.parent(call)
        loops = []
        while cur is not None and not isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if isinstance(cur, (ast.For, ast.While)):
                loops.append(cur)
            cur = ctx.parent(cur)
        for loop in loops:
            if isinstance(loop, ast.For):
                varying |= _stored(loop.target)
            assigns = [n for n in ctx.walk(loop)
                       if isinstance(n, (ast.Assign, ast.AugAssign))]
            changed = True
            while changed:
                changed = False
                for a in assigns:
                    targets = a.targets if isinstance(a, ast.Assign) \
                        else [a.target]
                    reads = _names_outside_schedule(a.value)
                    if isinstance(a, ast.AugAssign):
                        reads |= _names_outside_schedule(a.target)
                    if reads & varying:
                        for t in targets:
                            new = _stored(t) - varying
                            if new:
                                varying |= new
                                changed = True
        return varying

    def _check_slot(self, ctx, call, name, where, val, varying
                    ) -> Iterator[Finding]:
        # findings anchor at the call so one `# repro: allow(RPR004)` on
        # the call line covers every key slot of that call
        if isinstance(val, _UNHASHABLE):
            yield ctx.finding(
                self, call,
                f"unhashable literal in key {where} of {name}(): a "
                f"variant key must be hashable — pass a tuple or a frozen "
                f"value ({self.design_ref})")
            return
        used = _names_outside_schedule(val)
        for w in sorted(TRACED_OPERANDS & used):
            yield ctx.finding(
                self, call,
                f"{w!r} in key {where} of {name}(): the push-sum round's "
                f"W/active are runtime data by contract — a fault pattern "
                f"must never make a new step variant ({self.design_ref})")
        for v in sorted((used & varying) - TRACED_OPERANDS):
            yield ctx.finding(
                self, call,
                f"loop-varying {v!r} in key {where} of {name}(): every "
                f"new value is a new variant (a step rebuilt, a round "
                f"re-metered) — key on the schedule's phase and shift, "
                f"pass the value as data ({self.design_ref})")
