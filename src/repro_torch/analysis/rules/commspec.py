"""RPR002 — every communication round is called in the CommSpec form.

Invariant: a round threads its round-invariant knobs through one frozen
:class:`repro_torch.core.mixing.CommSpec` —
``communicate(params, spec, phase=..., step=...)``, and the same form of
``communicate_sharded`` — built canonically by ``DistConfig.comm_spec()``.
The reference keeps a deprecated all-kwargs shim
(``communicate(params, phase=..., topology=..., n_nodes=..., ...)``);
the port has none (``core/mixing.py``), so a kwargs-form call is a
``TypeError`` on whatever path first reaches it — possibly one no CPU test
runs.  Hand-forwarding kwargs is also how the reference once dropped
``model_axis`` silently.  This rule keeps the spec form at every call
site the AST can see.

Detection (the reference's): a call to ``repro_torch.core.mixing.
communicate`` / ``communicate_sharded`` (alias-resolved) with **no second
positional argument** that passes a round-invariant knob — either
literally (``topology=...``) or through a ``**kwargs`` expansion whose
dict literal is assigned in the same function scope and visibly contains
one.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional, Set

from repro_torch.analysis.engine import (FileContext, Finding, Rule,
                                         register)

TARGETS = {
    "repro_torch.core.mixing.communicate",
    "repro_torch.core.mixing.communicate_sharded",
}

# CommSpec fields: the round-invariant vocabulary (mixing.CommSpec)
SPEC_KEYS: Set[str] = {
    "topology", "n_nodes", "n_pods", "backend", "mesh", "node_axis",
    "model_axis", "shard_mode", "leaf_threshold", "comm_dtype",
    "compressor", "global_compressor",
}


def _dict_literal_keys(node: ast.AST) -> Optional[Set[str]]:
    """String keys of a ``dict(...)`` call or ``{...}`` literal."""
    if isinstance(node, ast.Dict):
        keys = set()
        for k in node.keys:
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                keys.add(k.value)
        return keys
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id == "dict" and not node.args:
        return {kw.arg for kw in node.keywords if kw.arg}
    return None


@register
class LegacyCommunicateRule(Rule):
    """``communicate``/``communicate_sharded`` take a CommSpec."""
    id = "RPR002"
    title = "legacy communicate(**kwargs) call form"
    design_ref = "ROADMAP A.12; core/mixing.py CommSpec"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ctx.nodes:
            if not isinstance(node, ast.Call):
                continue
            if ctx.resolve(node.func) not in TARGETS:
                continue
            if len(node.args) >= 2:     # communicate(params, spec, ...)
                continue
            bad = sorted(SPEC_KEYS & {kw.arg for kw in node.keywords
                                      if kw.arg})
            if not bad:
                bad = sorted(self._starred_spec_keys(ctx, node))
            if bad:
                yield ctx.finding(
                    self, node,
                    f"kwargs-form communicate ({', '.join(bad)}): the port "
                    f"has no kwargs shim — build a CommSpec "
                    f"(DistConfig.comm_spec() or mixing.CommSpec) and call "
                    f"communicate(params, spec, phase=..., step=...) "
                    f"({self.design_ref})")

    def _starred_spec_keys(self, ctx: FileContext,
                           node: ast.Call) -> Set[str]:
        """Spec keys visible through ``**name`` where ``name`` is a dict
        literal assigned in the enclosing function (or module) scope."""
        starred = [kw.value for kw in node.keywords if kw.arg is None]
        names = {v.id for v in starred if isinstance(v, ast.Name)}
        if not names:
            return set()
        scope = ctx.enclosing_function(node) or ctx.tree
        found: Set[str] = set()
        for stmt in ctx.walk(scope):
            if not isinstance(stmt, ast.Assign):
                continue
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name) and tgt.id in names:
                    keys = _dict_literal_keys(stmt.value)
                    if keys:
                        found |= keys & SPEC_KEYS
        return found
