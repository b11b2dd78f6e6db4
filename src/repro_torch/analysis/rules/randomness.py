"""RPR005 — only counter-hash randomness in the port's device modules.

Invariant (the reference's): randomness that takes part in a
communication round is a **pure function of (seed, step, leaf,
column)** — the shared counter hash (``repro_torch.compress``) that makes
every node take the same stochastic-rounding decision, keeps a constant
state an exact fixed point, makes quantizer randomness bit-stable under
resharding, and lets the card's kernels and their plain twins round
alike.  A host-stateful generator breaks all of that: ``np.random``, the
``random`` module, and torch's global generator, whose state advances per
call and differs between the CPU and the card (so the tests on the CPU
would not see the card's numbers).  Where the port needs other
randomness (the init's draws, the serving sampler) it takes an explicit
``torch.Generator``.  Host-side schedule code is exempt by registry —
``core/faults.py`` uses a counter-keyed ``np.random.Philox`` and
``data/`` builds host batches.

Flagged inside the registered device modules: any ``np.random.*``
attribute use, ``random.*`` call or ``from random import ...``; and a
``torch.rand``/``randn``/``randint``/``randperm``/``rand_like``/
``randn_like``/``randint_like``/``normal``/``bernoulli``/``multinomial``/
``poisson`` call or a ``.normal_``/``.uniform_``/``.bernoulli(_)``/
``.random_``/``.exponential_``/``.geometric_``/``.log_normal_``/
``.cauchy_``/``.multinomial`` method call without an explicit
``generator=``.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.engine import (FileContext, Finding, Rule,
                                         register)

DEVICE_MODULES = (
    "src/repro_torch/core/mixing.py",
    "src/repro_torch/kernels/*.py",
    "src/repro_torch/compress/*.py",
    "src/repro_torch/train/step.py",
)
TORCH_RANDOM_FUNCS = {
    f"torch.{n}" for n in (
        "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
        "randint_like", "normal", "bernoulli", "multinomial", "poisson")}
TORCH_RANDOM_METHODS = {"normal_", "uniform_", "bernoulli", "bernoulli_",
                        "random_", "exponential_", "geometric_",
                        "log_normal_", "cauchy_", "multinomial"}


@register
class RandomnessRule(Rule):
    """Device modules draw no host-stateful randomness."""
    id = "RPR005"
    title = "host-stateful randomness in device code"
    design_ref = "compress counter hash"
    path_globs = DEVICE_MODULES

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ctx.nodes:
            if isinstance(node, ast.ImportFrom) and node.module == "random":
                yield ctx.finding(
                    self, node,
                    "stdlib `random` imported in a device-code module: "
                    "device randomness must be the counter hash (pure in "
                    f"(seed, step, leaf, column)) ({self.design_ref})")
            elif isinstance(node, ast.Attribute):
                fq = ctx.resolve(node)
                if fq is None:
                    continue
                # flag the base `np.random` attribute exactly once per
                # use (nested attributes like np.random.default_rng
                # contain it as a child node)
                if fq == "numpy.random":
                    yield ctx.finding(
                        self, node,
                        "np.random in a device-code module: np.random is "
                        "host-stateful — nodes desynchronize and replay "
                        "breaks; use the counter hash or an explicit "
                        f"torch.Generator ({self.design_ref})")
                elif isinstance(node.value, ast.Name) \
                        and node.value.id == "random" \
                        and ctx.imports.get("random") == "random":
                    yield ctx.finding(
                        self, node,
                        f"stdlib random.{node.attr} in a device-code "
                        f"module: use the counter hash or an explicit "
                        f"torch.Generator ({self.design_ref})")
            elif isinstance(node, ast.Call) and not any(
                    kw.arg == "generator" for kw in node.keywords):
                fq = ctx.resolve(node.func)
                method = (node.func.attr
                          if isinstance(node.func, ast.Attribute) else None)
                if fq in TORCH_RANDOM_FUNCS or (
                        method in TORCH_RANDOM_METHODS
                        and not (fq or "").startswith("numpy.")):
                    what = fq if fq in TORCH_RANDOM_FUNCS else f".{method}"
                    yield ctx.finding(
                        self, node,
                        f"{what}() without generator= draws from torch's "
                        f"global generator, whose state advances per call "
                        f"and differs between the CPU and the card: pass "
                        f"an explicit torch.Generator or use the counter "
                        f"hash ({self.design_ref})")
