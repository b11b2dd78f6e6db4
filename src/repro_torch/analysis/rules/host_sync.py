"""RPR001 — no host syncs inside the port's registered hot paths.

Invariant: the Trainer's step loop, the step builders, the mixing
rounds, the algorithm hooks, the kernel wrappers and the serving loops
make **no implicit host synchronization** — device scalars stay on the
card and are read at log boundaries.  On the card a synchronizing call
stalls the host until the queue drains; on the CPU, where the tests run,
it costs nothing, so only a static check (or the card) sees it.  The card
found two (ROADMAP C.5): a CPU scalar tensor passed to ``torch.where`` in
``_sdpa``, 24 synchronizing copies a step; and a scalar written into a
CUDA tensor in the MoE dispatch, one more.  ``chip_smoke.py``'s
one-synchronizing-call gate on every trainer path is the runtime side of
this rule.

Flagged inside the registered (module, function) scopes below:

* ``float(...)`` of a non-constant (a tensor's ``__float__`` reads it
  back); ``int()`` is not flagged: the AST has no types, and host ints
  (shapes, counts, steps) are everywhere in these files;
* ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``;
* ``np.asarray(...)`` / ``np.array(...)``;
* ``torch.cuda.synchronize()`` and ``.synchronize()`` on a stream or
  event;
* a ``torch.tensor(...)`` / ``torch.as_tensor(...)`` with no ``device=``
  (a CPU tensor) passed — directly or through a name bound in the same
  function — to ``torch.where``, ``.where``, ``.masked_fill(_)``,
  ``.index_put(_)``, ``.index_fill(_)`` or written through an index
  (``t[i] = ...``): C.5's spelling.  On CUDA operands it is a
  synchronous copy from pageable host memory;
* a Python number written through a boolean-mask index (``t[m] = 0``
  with ``m`` a comparison or ``~x``, or a name bound to one): the MoE
  dispatch's spelling; the mask makes it an ``index_put_`` that reads the
  mask back.

A deliberate transfer in a hot scope (a host mask, a per-call or
per-tick result the caller asked for) carries ``# repro: allow(RPR001)``
with its reason on the line.
"""
from __future__ import annotations

import ast
import fnmatch
from typing import Dict, Iterator, Optional, Set, Tuple

from repro_torch.analysis.engine import (FileContext, Finding, Rule,
                                         register)

# (path glob, function-qualname globs) — the hot-path registry.
# "*" registers the whole module (every function and module level).
HOT_PATHS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("src/repro_torch/train/step.py", ("*",)),
    ("src/repro_torch/train/trainer.py", ("Trainer.run", "Trainer._run")),
    ("src/repro_torch/core/mixing.py", ("*",)),
    ("src/repro_torch/core/algo.py", ("*",)),
    ("src/repro_torch/kernels/*.py", ("*",)),
    ("src/repro_torch/serve/engine.py",
     ("Engine.generate", "Engine.decode_step", "Engine.prefill",
      "BatchedServer.run")),
)

_SYNC_FQ = {
    "numpy.asarray": "np.asarray materializes the operand on the host",
    "numpy.array": "np.array materializes the operand on the host",
    "torch.cuda.synchronize": "torch.cuda.synchronize stalls the host "
                              "until the card's queue drains",
}
_SYNC_METHODS = {
    "item": ".item() reads a device value back to the host",
    "tolist": ".tolist() reads a device tensor back to the host",
    "cpu": ".cpu() copies a device tensor to the host and waits for it",
    "numpy": ".numpy() needs a host tensor: on a device one it follows a "
             "device-to-host read",
    "synchronize": ".synchronize() stalls the host until the stream or "
                   "event completes",
}
_HOST_TENSOR_CALLS = {"torch.tensor", "torch.as_tensor"}
# calls whose tensor operands must already be on the card
_MASKING_FUNCS = {"torch.where"}
_MASKING_METHODS = {"where", "masked_fill", "masked_fill_", "index_put",
                    "index_put_", "index_fill", "index_fill_"}


def hot_function_globs(path: str) -> Tuple[str, ...]:
    globs: Tuple[str, ...] = ()
    for pat, fns in HOT_PATHS:
        if fnmatch.fnmatch(path, pat):
            globs = globs + fns
    return globs


def _is_host_tensor(ctx: FileContext, node: ast.AST) -> bool:
    """A ``torch.tensor``/``torch.as_tensor`` call with no ``device=``."""
    return (isinstance(node, ast.Call)
            and ctx.resolve(node.func) in _HOST_TENSOR_CALLS
            and not any(kw.arg == "device" for kw in node.keywords))


def _is_mask(node: ast.AST) -> bool:
    return isinstance(node, ast.Compare) or (
        isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert))


@register
class HostSyncRule(Rule):
    """No implicit device-to-host sync in the port's hot paths."""
    id = "RPR001"
    title = "host sync inside a registered hot path"
    design_ref = "ROADMAP C.5"
    path_globs = tuple(p for p, _ in HOT_PATHS)

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        fn_globs = hot_function_globs(ctx.path)
        if not fn_globs:
            return

        def hot(node: ast.AST) -> bool:
            qual = ctx.qualname(node)
            return any(g == "*" or fnmatch.fnmatch(qual, g)
                       for g in fn_globs)

        bindings = self._bindings(ctx)
        for node in ctx.nodes:
            if not hot(node):
                continue
            why = None
            if isinstance(node, ast.Call):
                why = (self._sync_reason(ctx, node)
                       or self._masking_reason(ctx, node, bindings))
            elif isinstance(node, ast.Assign):
                why = self._index_write_reason(ctx, node, bindings)
            if why is not None:
                yield ctx.finding(
                    self, node,
                    f"{why} — hot paths must stay host-sync-free: keep the "
                    f"value on the card, build constants with device=, or "
                    f"read it at a log boundary ({self.design_ref})")

    # ------------------------------------------------------------------
    @staticmethod
    def _bindings(ctx: FileContext) -> Dict[ast.AST, Dict[str, Set[str]]]:
        """Per function: names bound (anywhere in it) to a host tensor
        (``"host"``) or to a boolean mask (``"mask"``)."""
        out: Dict[ast.AST, Dict[str, Set[str]]] = {}
        for fn in [ctx.tree, *ctx.functions()]:
            kinds: Dict[str, Set[str]] = {"host": set(), "mask": set()}
            for node in ctx.walk(fn):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    name = node.targets[0].id
                    if _is_host_tensor(ctx, node.value):
                        kinds["host"].add(name)
                    elif _is_mask(node.value):
                        kinds["mask"].add(name)
            out[fn] = kinds
        return out

    @staticmethod
    def _kinds(ctx, node, bindings) -> Dict[str, Set[str]]:
        return bindings[ctx.enclosing_function(node) or ctx.tree]

    def _host_operand(self, ctx, node, expr, bindings) -> bool:
        return _is_host_tensor(ctx, expr) or (
            isinstance(expr, ast.Name)
            and expr.id in self._kinds(ctx, node, bindings)["host"])

    def _sync_reason(self, ctx: FileContext, node: ast.Call
                     ) -> Optional[str]:
        func = node.func
        if isinstance(func, ast.Name) and func.id == "float" \
                and len(node.args) == 1 \
                and not isinstance(node.args[0], ast.Constant):
            return "float() of a tensor reads it back to the host"
        fq = ctx.resolve(func)
        if fq in _SYNC_FQ:
            return _SYNC_FQ[fq]
        if isinstance(func, ast.Attribute) and func.attr in _SYNC_METHODS:
            if func.attr in ("item", "tolist") and node.args:
                return None
            return _SYNC_METHODS[func.attr]
        return None

    def _masking_reason(self, ctx, node: ast.Call, bindings
                        ) -> Optional[str]:
        fq = ctx.resolve(node.func)
        is_masking = fq in _MASKING_FUNCS or (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _MASKING_METHODS)
        if not is_masking:
            return None
        operands = list(node.args) + [kw.value for kw in node.keywords]
        if any(self._host_operand(ctx, node, a, bindings) for a in operands):
            name = fq if fq in _MASKING_FUNCS else f".{node.func.attr}"
            return (f"a CPU tensor (torch.tensor/as_tensor without "
                    f"device=) passed to {name}: on CUDA operands a "
                    f"synchronous copy from pageable memory (C.5)")
        return None

    def _index_write_reason(self, ctx, node: ast.Assign, bindings
                            ) -> Optional[str]:
        subs = [t for t in node.targets if isinstance(t, ast.Subscript)]
        if not subs:
            return None
        if self._host_operand(ctx, node, node.value, bindings):
            return ("a CPU tensor (torch.tensor/as_tensor without device=) "
                    "written through an index: on a CUDA tensor a "
                    "synchronous copy from pageable memory")
        masks = self._kinds(ctx, node, bindings)["mask"]
        if isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, (int, float)) \
                and any(_is_mask(t.slice) or (isinstance(t.slice, ast.Name)
                                              and t.slice.id in masks)
                        for t in subs):
            return ("a Python scalar written through a boolean mask: on a "
                    "CUDA tensor an index_put_ that reads the mask back "
                    "(the MoE dispatch's fault)")
        return None
