"""Algorithm registry: what differs per training algorithm (counterpart of
``repro/core/algo.py``).

Every algorithm shares one skeleton — per-node grad, optimizer half-step,
communication round — and ``train/step.py`` and ``core/algorithms.py``
``simulate`` each keep one step body; what differs enters through:

* ``slots`` — extra ``TrainState.extras`` entries as :class:`ExtraSlot`
  descriptors (SlowMo's anchor and slow momentum, GT-PGA's tracker);
* ``pre_update(extras, grads)`` — the gradients the optimizer consumes
  (GT-PGA's tracker recursion ``y <- y + g - g_prev``);
* ``comm_payload(extras, params_half)`` — extra trees that ride the round
  jointly with the params, through the same ``communicate`` call;
* ``post_round(extras, mixed, phase, ctx)`` — the update after the round
  (SlowMo's outer step, GT's tracker absorption).  ``mixed`` is always a
  dict ``{"params": tree, **payload}`` at the hook level.

Lookups raise caller-named ``ValueError`` listing valid names.  The
mode slots (the error-feedback memory, the push-sum weight) are declared
here too, with what a checkpoint that predates a slot restores into it
(``backfill``).  The slots' sharding axes (``axes_value``,
``extras_axes``) wait for ROADMAP A.10.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

__all__ = [
    "Algorithm",
    "EF_SLOT",
    "ExtraSlot",
    "PUSH_SLOT",
    "StepContext",
    "algorithm_names",
    "backfill_kind",
    "get_algorithm",
    "init_extras",
    "join_payload",
    "known_slot_names",
    "phases_for_algorithm",
    "push_sum_algorithm_names",
    "register",
    "state_slots",
    "unwrap_mixed",
    "wrap_mixed",
]


@dataclasses.dataclass(frozen=True)
class ExtraSlot:
    """Descriptor for one entry of ``TrainState.extras``.

    ``kind``: ``"stacked_params"`` (the params tree with its leading node
    axis), ``"unstacked"`` (one replica's tree) or ``"node_scalar"`` (an
    ``(n_nodes, 1)`` float32 column: the push-sum weight).  ``init``:
    ``"zeros"`` (float32 zeros of the base shape), ``"ones"``
    (node_scalar only) or ``"row0"`` (a copy of node 0's params —
    SlowMo's anchor).  ``backfill`` names what ``checkpoint/ckpt.py``
    materialises when an older checkpoint lacks the slot (``"ones"`` for
    push weights, else ``"zeros"``).  ``payload`` marks the slot as riding
    the round jointly with the params (GT-PGA's tracker).
    """

    name: str
    kind: str = "stacked_params"  # stacked_params | unstacked | node_scalar
    init: str = "zeros"           # zeros | ones | row0
    backfill: str = "zeros"       # zeros | ones
    payload: bool = False

    def init_value(self, params_stacked: Any, n_nodes: int) -> Any:
        if self.kind == "node_scalar":
            fill = 1.0 if self.init == "ones" else 0.0
            if self.init not in ("ones", "zeros"):
                raise ValueError(f"ExtraSlot {self.name!r}: unknown init "
                                 f"{self.init!r} for a node_scalar")
            dev = tree_flatten(params_stacked)[0][0].device
            return torch.full((n_nodes, 1), fill, dtype=torch.float32,
                              device=dev)
        if self.kind not in ("stacked_params", "unstacked"):
            raise ValueError(f"ExtraSlot {self.name!r}: unknown kind "
                             f"{self.kind!r}")
        base = params_stacked
        if self.kind == "unstacked":
            base = tree_map(lambda p: p[0], params_stacked)
        if self.init == "row0":
            return tree_map(torch.clone, base)
        if self.init != "zeros":
            raise ValueError(f"ExtraSlot {self.name!r}: unknown init "
                             f"{self.init!r}")
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), base)


#: the per-node error-feedback memory, owned by the communication stack
#: (``DistConfig.comm_error_feedback``): fp32 zeros shaped like the joint
#: round payload
EF_SLOT = ExtraSlot("ef_state", kind="stacked_params", backfill="zeros")
#: the push-sum weight (``DistConfig.push_sum``): ones at init (Σw = n);
#: readers de-bias with ``train.state.debias(params, w)``
PUSH_SLOT = ExtraSlot("push_weight", kind="node_scalar", init="ones",
                      backfill="ones")


@dataclasses.dataclass(frozen=True)
class StepContext:
    """Per-step constants handed to hooks."""
    dist: Any
    n_nodes: int
    lr: Any


class Algorithm:
    """One decentralised training algorithm: phases + extras + hooks."""

    name: str = ""
    phases: Tuple[str, ...] = ()
    #: phases consumed entirely by ``post_round`` with no comm round
    #: (SlowMo's outer step)
    owned_phases: Tuple[str, ...] = ()
    slots: Tuple[ExtraSlot, ...] = ()
    #: eligible to compose with push-sum (directed, gossip-style mixing)
    push_sum_capable: bool = False
    #: True when ``pre_update`` is not the identity; rules out the fused
    #: half-step + mix kernel, whose in-kernel update consumes raw grads
    transforms_grads: bool = False
    description: str = ""

    def payload_names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.slots if s.payload)

    def pre_update(self, extras: Dict[str, Any],
                   grads: Any) -> Tuple[Any, Dict[str, Any]]:
        """Return ``(update_grads, extras)`` — what the optimizer consumes."""
        return grads, extras

    def comm_payload(self, extras: Dict[str, Any],
                     params_half: Any) -> Dict[str, Any]:
        """Extra pytrees that ride the round jointly with the params."""
        return {n: extras[n] for n in self.payload_names()}

    def post_round(self, extras: Dict[str, Any], mixed: Dict[str, Any],
                   phase: str, ctx: StepContext) -> Tuple[Any, Dict[str, Any]]:
        """Consume the round output; return ``(new_params, extras)``.
        Default: absorb the mixed payload slots into ``extras`` and pass
        the mixed params through."""
        names = self.payload_names()
        if names:
            extras = dict(extras)
            for n in names:
                extras[n] = mixed[n]
        return mixed["params"], extras


_REGISTRY: Dict[str, Algorithm] = {}


def register(algo: Algorithm) -> Algorithm:
    if not algo.name:
        raise ValueError("register: algorithm must set a non-empty name")
    _REGISTRY[algo.name] = algo
    return algo


def algorithm_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def push_sum_algorithm_names() -> Tuple[str, ...]:
    return tuple(n for n, a in _REGISTRY.items() if a.push_sum_capable)


def get_algorithm(name: str, *, caller: str = "get_algorithm") -> Algorithm:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"{caller}: unknown algorithm {name!r} "
            f"(expected one of {algorithm_names()})") from None


def phases_for_algorithm(algorithm: str) -> Tuple[str, ...]:
    """Phases an algorithm's schedule can emit, in canonical order."""
    return get_algorithm(algorithm, caller="phases_for_algorithm").phases


def known_slot_names() -> Tuple[str, ...]:
    """Every extras slot name a registered algorithm (or mode) can own."""
    names = []
    for algo in _REGISTRY.values():
        for slot in algo.slots:
            if slot.name not in names:
                names.append(slot.name)
    for slot in (EF_SLOT, PUSH_SLOT):
        if slot.name not in names:
            names.append(slot.name)
    return tuple(names)


def backfill_kind(slot_name: str) -> str:
    """Checkpoint backfill for a slot missing from an older checkpoint."""
    for algo in _REGISTRY.values():
        for slot in algo.slots:
            if slot.name == slot_name:
                return slot.backfill
    for slot in (EF_SLOT, PUSH_SLOT):
        if slot.name == slot_name:
            return slot.backfill
    return "zeros"


def state_slots(dist: Any) -> Tuple[ExtraSlot, ...]:
    """All extras slots for a config: algorithm-declared plus mode slots."""
    algo = get_algorithm(dist.algorithm, caller="state_slots")
    slots = tuple(algo.slots)
    if dist.comm_error_feedback:
        slots += (EF_SLOT,)
    if dist.push_sum:
        slots += (PUSH_SLOT,)
    return slots


def init_extras(dist: Any, params_stacked: Any,
                n_nodes: int) -> Dict[str, Any]:
    """Initial ``TrainState.extras`` for a config.  The error-feedback slot
    mirrors the joint round payload (params plus any payload slots), so
    compressed GT-PGA keeps one residual per transmitted leaf."""
    algo = get_algorithm(dist.algorithm, caller="init_extras")
    slots = state_slots(dist)
    extras: Dict[str, Any] = {}
    for slot in algo.slots:
        extras[slot.name] = slot.init_value(params_stacked, n_nodes)
    if EF_SLOT in slots:
        from repro_torch.compress import init_ef_state
        payload = algo.comm_payload(extras, params_stacked)
        extras[EF_SLOT.name] = init_ef_state(join_payload(payload,
                                                          params_stacked))
    if PUSH_SLOT in slots:
        extras[PUSH_SLOT.name] = PUSH_SLOT.init_value(params_stacked,
                                                      n_nodes)
    return extras


def join_payload(payload: Dict[str, Any], params: Any) -> Any:
    """The tree that rides the round: bare params when the payload is
    empty, so the round sees exactly the params tree."""
    if not payload:
        return params
    return {"params": params, **payload}


def wrap_mixed(mixed: Any, has_payload: bool) -> Dict[str, Any]:
    """Normalise a round's output to the ``post_round`` dict contract."""
    return mixed if has_payload else {"params": mixed}


def unwrap_mixed(joint: Any, has_payload: bool) -> Any:
    """Params tree of a joint round tree (inverse of ``join_payload``)."""
    return joint["params"] if has_payload else joint


def _f32_product(a, b):
    """``a * b`` rounded to float32, as the reference's traced float32
    scalars multiply (Python floats would multiply in double)."""
    if torch.is_tensor(a) or torch.is_tensor(b):
        return torch.as_tensor(a, dtype=torch.float32) * torch.as_tensor(
            b, dtype=torch.float32)
    return float(np.float32(a) * np.float32(b))


def _zip(fn, *trees):
    """``fn`` over the leaves of trees of one structure."""
    flat = [tree_flatten(t) for t in trees]
    return tree_unflatten(flat[0][1],
                          [fn(*ls) for ls in zip(*(f[0] for f in flat))])


class _Parallel(Algorithm):
    name = "parallel"
    phases = ("global",)
    push_sum_capable = True
    description = "All-reduce every step (centralised baseline)."


class _Gossip(Algorithm):
    name = "gossip"
    phases = ("gossip",)
    push_sum_capable = True
    description = "One W-mixing per step (DSGD)."


class _Local(Algorithm):
    name = "local"
    phases = ("none", "global")
    push_sum_capable = True
    description = "H local steps, then a global average (Local SGD)."


class _GossipPGA(Algorithm):
    name = "gossip_pga"
    phases = ("gossip", "global")
    push_sum_capable = True
    description = "Gossip with a global average every H steps (Alg. 1)."


class _GossipAGA(Algorithm):
    name = "gossip_aga"
    phases = ("gossip", "global")
    push_sum_capable = True
    description = "Gossip-PGA with the adaptive H controller (App. G)."


class _SlowMo(Algorithm):
    name = "slowmo"
    phases = ("gossip", "slowmo")
    owned_phases = ("slowmo",)
    slots = (
        ExtraSlot("slow_params", kind="unstacked", init="row0"),
        ExtraSlot("slow_u", kind="unstacked", init="zeros"),
    )
    description = "Gossip with a periodic slow momentum outer step."

    def post_round(self, extras, mixed, phase, ctx):
        if phase not in self.owned_phases:
            return super().post_round(extras, mixed, phase, ctx)
        params_half = mixed["params"]
        beta = ctx.dist.slowmo_beta
        lr = ctx.lr
        step = _f32_product(ctx.dist.slowmo_lr, lr)
        xbar = tree_map(lambda p: torch.mean(p.to(torch.float32), dim=0),
                        params_half)
        f32 = torch.float32
        slow_u = _zip(lambda u, s, xb: beta * u.to(f32)
                      + (s.to(f32) - xb) / lr,
                      extras["slow_u"], extras["slow_params"], xbar)
        slow_params = _zip(lambda s, u: (s.to(f32) - step * u).to(s.dtype),
                           extras["slow_params"], slow_u)
        new_params = _zip(
            lambda s, p: s.to(p.dtype)[None].expand(p.shape).contiguous(),
            slow_params, params_half)
        return new_params, {**extras, "slow_params": slow_params,
                            "slow_u": slow_u}


class _HierPGA(Algorithm):
    name = "hier_pga"
    phases = ("gossip", "pod_avg", "global")
    description = "Two-level PGA: pod averages nested inside global ones."


class _GTPGA(Algorithm):
    name = "gt_pga"
    phases = ("gossip", "global")
    slots = (
        ExtraSlot("gt_tracker", kind="stacked_params", payload=True),
        ExtraSlot("gt_prev_grad", kind="stacked_params"),
    )
    transforms_grads = True
    description = ("Gradient tracking + PGA for non-IID data: the tracker "
                   "rides the round jointly with the params.")

    def pre_update(self, extras, grads):
        # y_{k+1/2} = y_k + g_k - g_{k-1}; the optimizer consumes y, whose
        # node-mean equals the global gradient mean (y_0 = g_{-1} = 0)
        tracker = _zip(lambda y, g, p: y + (g - p), extras["gt_tracker"],
                       grads, extras["gt_prev_grad"])
        return tracker, {**extras, "gt_tracker": tracker,
                         "gt_prev_grad": grads}


register(_Parallel())
register(_Gossip())
register(_Local())
register(_GossipPGA())
register(_GossipAGA())
register(_SlowMo())
register(_HierPGA())
register(_GTPGA())
