"""Algorithm registry: what differs per training algorithm (counterpart of
``repro/core/algo.py``).

Every algorithm shares one skeleton — per-node grad, optimizer half-step,
communication round — and ``train/step.py`` keeps one step body; the hooks
``pre_update`` / ``comm_payload`` / ``post_round`` carry what differs.
The port has the hook-free algorithms (``parallel``, ``gossip``,
``local``, ``gossip_pga``) and the error-feedback mode slot.  The
reference's other registered algorithms (``gossip_aga``, ``slowmo``,
``hier_pga``, ``gt_pga``) are known names that raise
``NotImplementedError`` (ROADMAP A.2).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from repro_torch.configs.base import not_ported

#: registered in the reference, ported later (ROADMAP A.2)
PENDING = ("gossip_aga", "slowmo", "hier_pga", "gt_pga")
#: the extras slot of the per-node error-feedback memory, owned by the
#: communication stack (``DistConfig.comm_error_feedback``): fp32 zeros
#: shaped like the joint round payload
EF_SLOT = "ef_state"


@dataclasses.dataclass(frozen=True)
class StepContext:
    """Per-step constants handed to hooks."""
    dist: Any
    n_nodes: int
    lr: Any


class Algorithm:
    """One decentralised training algorithm: phases + hooks."""

    name: str = ""
    phases: Tuple[str, ...] = ()
    description: str = ""

    def payload_names(self) -> Tuple[str, ...]:
        return ()

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
        """Consume the round output; return ``(new_params, extras)``."""
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
    """Every algorithm name the reference knows (ported or pending)."""
    return tuple(_REGISTRY) + PENDING


def get_algorithm(name: str, *, caller: str = "get_algorithm") -> Algorithm:
    if name in PENDING:
        raise not_ported(f"algorithm {name!r}", "A.2")
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"{caller}: unknown algorithm {name!r} "
            f"(expected one of {algorithm_names()})") from None


def phases_for_algorithm(algorithm: str) -> Tuple[str, ...]:
    """Phases an algorithm's schedule can emit, in canonical order."""
    return get_algorithm(algorithm, caller="phases_for_algorithm").phases


def init_extras(dist: Any, params_stacked: Any,
                n_nodes: int) -> Dict[str, Any]:
    """Initial ``TrainState.extras``: the ported algorithms declare no
    slots; with error feedback the EF slot mirrors the joint round payload
    (the push-sum weight slot is not ported)."""
    algo = get_algorithm(dist.algorithm, caller="init_extras")
    if dist.push_sum:
        raise not_ported("the push-sum weight slot", "A.4")
    extras: Dict[str, Any] = {}
    if dist.comm_error_feedback:
        from repro_torch.compress import init_ef_state
        payload = algo.comm_payload(extras, params_stacked)
        extras[EF_SLOT] = init_ef_state(join_payload(payload,
                                                     params_stacked))
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


class _Parallel(Algorithm):
    name = "parallel"
    phases = ("global",)
    description = "All-reduce every step (centralised baseline)."


class _Gossip(Algorithm):
    name = "gossip"
    phases = ("gossip",)
    description = "One W-mixing per step (DSGD)."


class _Local(Algorithm):
    name = "local"
    phases = ("none", "global")
    description = "H local steps, then a global average (Local SGD)."


class _GossipPGA(Algorithm):
    name = "gossip_pga"
    phases = ("gossip", "global")
    description = "Gossip with a global average every H steps (Alg. 1)."


register(_Parallel())
register(_Gossip())
register(_Local())
register(_GossipPGA())
