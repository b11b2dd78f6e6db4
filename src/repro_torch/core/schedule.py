"""Communication schedules (counterpart of ``repro/core/schedule.py``):
fixed-period PGA and adaptive AGA (paper Alg. 2).

Host-side logic: the trainer asks the schedule which phase ("gossip",
"global", "pod_avg", "slowmo", "none") step k runs.  The phase of step k
applies after the local update of step k, as in paper Alg. 1 where
``mod(k+1, H) == 0`` triggers the global average.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, List, Optional

from repro_torch.configs.base import DistConfig


def _as_float(loss) -> Optional[float]:
    """Materialize a loss observation on the host.

    ``observe_loss`` takes the loss lazily — a device scalar (or a thunk
    returning one) — so the trainer's loop never waits on a per-step
    device-to-host copy; the read (``.item()``) happens here, at period
    boundaries and in ``state_dict`` only."""
    if loss is None:
        return None
    if callable(loss):
        loss = loss()
    if hasattr(loss, "item"):
        loss = loss.item()
    return float(loss)


class CommSchedule:
    """Base: ``peek_phase`` is pure (never mutates schedule state, so
    logging or probing code can query any step); ``advance`` is the
    once-per-executed-step call that returns the phase and commits any
    internal counters (AGA's period counter).  For stateless schedules the
    two coincide."""

    def peek_phase(self, step: int) -> str:
        """Phase of step k, with no side effects."""
        raise NotImplementedError

    def phase(self, step: int) -> str:
        """Pure alias of :meth:`peek_phase` (the reference keeps it for
        callers predating the peek/advance split)."""
        return self.peek_phase(step)

    def advance(self, step: int) -> str:
        """Phase of step k, committing schedule state.  Call exactly once
        per executed step, in step order."""
        return self.peek_phase(step)

    def gossip_shift_step(self, step: int, period: int = 1) -> int:
        """Index fed to the time-varying one-peer-exp graph, reduced modulo
        the topology's schedule period."""
        return step % max(period, 1)

    def observe_loss(self, step: int, loss) -> None:
        """Feed the schedule a loss signal: a python float, a 0-d tensor
        or a thunk returning either.  Stateful schedules hold it lazily
        and read it only at period boundaries (:func:`_as_float`)."""

    def state_dict(self) -> dict:
        """JSON-serializable internal state (empty for stateless
        schedules)."""
        return {}

    def load_state_dict(self, state: dict) -> None:
        pass


@dataclass
class ParallelSchedule(CommSchedule):
    """Parallel SGD: exact global average every step (W = J)."""
    def peek_phase(self, step: int) -> str:
        return "global"


@dataclass
class GossipSchedule(CommSchedule):
    """Gossip SGD: H → ∞ (paper Remark 4)."""
    def peek_phase(self, step: int) -> str:
        return "gossip"


@dataclass
class LocalSchedule(CommSchedule):
    """Local SGD: W = I between periodic All-Reduce syncs."""
    H: int = 6

    def peek_phase(self, step: int) -> str:
        return "global" if (step + 1) % self.H == 0 else "none"


@dataclass
class PGASchedule(CommSchedule):
    """Gossip-PGA (paper Alg. 1): gossip every step, All-Reduce every H."""
    H: int = 6

    def peek_phase(self, step: int) -> str:
        return "global" if (step + 1) % self.H == 0 else "gossip"


@dataclass
class AGASchedule(CommSchedule):
    """Gossip-AGA (paper Alg. 2): H^(ℓ) = ceil(F_init / F(x_k) · H_init),
    clipped to H_max (Corollary 1 requires bounded periods), without the
    ^(1/4) exponent, as App. G runs it.  ``history`` holds the period set
    at each global round."""
    H_init: int = 4
    warmup: int = 64
    H_max: int = 64
    _C: int = field(default=0, init=False)
    _H: int = field(default=0, init=False)
    _F_init: Optional[float] = field(default=None, init=False)
    # the latest observation, held lazily (float, 0-d tensor or thunk)
    _F_last: Any = field(default=None, init=False)
    history: List[int] = field(default_factory=list, init=False)

    def __post_init__(self):
        self._H = self.H_init

    @property
    def current_H(self) -> int:
        return self._H

    def observe_loss(self, step: int, loss) -> None:
        self._F_last = loss

    def peek_phase(self, step: int) -> str:
        """What :meth:`advance` would return for the next executed step,
        with the period counter untouched."""
        return "global" if self._C + 1 >= self._H else "gossip"

    def advance(self, step: int) -> str:
        ph = self.peek_phase(step)
        if ph == "global":
            self._C = 0
            self._update_period(step)
        else:
            self._C += 1
        return ph

    def state_dict(self) -> dict:
        return {"C": self._C, "H": self._H, "F_init": self._F_init,
                "F_last": _as_float(self._F_last),
                "history": list(self.history)}

    def load_state_dict(self, state: dict) -> None:
        self._C = int(state["C"])
        self._H = int(state["H"])
        self._F_init = state["F_init"]
        self._F_last = state["F_last"]
        self.history = list(state["history"])

    def _update_period(self, step: int) -> None:
        f_last = _as_float(self._F_last)
        if f_last is None:
            return
        self._F_last = f_last  # keep the value read
        if step < self.warmup or self._F_init is None:
            # running average F_init <- (F_init + F)/2 (paper Alg. 2 warmup)
            self._F_init = (f_last if self._F_init is None
                            else 0.5 * (self._F_init + f_last))
        else:
            h = math.ceil(self._F_init / max(f_last, 1e-12) * self.H_init)
            self._H = int(min(max(h, 1), self.H_max))
        self.history.append(self._H)


@dataclass
class HierPGASchedule(CommSchedule):
    """Hierarchical PGA: gossip every step, intra-pod exact averaging every
    H_pod steps, global All-Reduce every H_global steps."""
    H_pod: int = 3
    H_global: int = 12

    def peek_phase(self, step: int) -> str:
        if (step + 1) % self.H_global == 0:
            return "global"
        if (step + 1) % self.H_pod == 0:
            return "pod_avg"
        return "gossip"


@dataclass
class SlowMoSchedule(CommSchedule):
    """SlowMo (Wang et al. 2019) outer loop: gossip base optimizer and a
    slow-momentum step at each period boundary (phase ``"slowmo"``)."""
    H: int = 6

    def peek_phase(self, step: int) -> str:
        return "slowmo" if (step + 1) % self.H == 0 else "gossip"


def make_schedule(dist: DistConfig) -> CommSchedule:
    a = dist.algorithm
    if a == "parallel":
        return ParallelSchedule()
    if a == "gossip":
        return GossipSchedule()
    if a == "local":
        return LocalSchedule(H=dist.H)
    if a in ("gossip_pga", "gt_pga"):
        # gt_pga keeps PGA's cadence: the tracker changes what rides the
        # round, not when rounds happen
        return PGASchedule(H=dist.H)
    if a == "gossip_aga":
        return AGASchedule(H_init=dist.aga_h_init, warmup=dist.aga_warmup,
                           H_max=dist.aga_h_max)
    if a == "slowmo":
        return SlowMoSchedule(H=dist.H)
    if a == "hier_pga":
        return HierPGASchedule(H_pod=dist.hier_h_pod, H_global=dist.H)
    from repro_torch.core.algo import algorithm_names
    raise ValueError(f"make_schedule: unknown algorithm {a!r} "
                     f"(expected one of {algorithm_names()})")
