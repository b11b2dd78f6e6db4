"""Communication schedules (counterpart of ``repro/core/schedule.py``).

Host-side logic: the trainer asks the schedule which phase ("gossip",
"global", "none") step k runs.  The phase of step k applies after the
local update of step k, as in paper Alg. 1 where ``mod(k+1, H) == 0``
triggers the global average.  The adaptive (AGA), hierarchical and SlowMo
schedules are not ported yet (ROADMAP A.2).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import DistConfig, not_ported


class CommSchedule:
    """Base: ``peek_phase`` is pure; ``advance`` is the once-per-executed
    -step call (the two coincide for the stateless schedules here)."""

    def peek_phase(self, step: int) -> str:
        raise NotImplementedError

    def advance(self, step: int) -> str:
        return self.peek_phase(step)

    def gossip_shift_step(self, step: int, period: int = 1) -> int:
        """Index fed to the time-varying one-peer-exp graph, reduced modulo
        the topology's schedule period."""
        return step % max(period, 1)


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


def make_schedule(dist: DistConfig) -> CommSchedule:
    a = dist.algorithm
    if a == "parallel":
        return ParallelSchedule()
    if a == "gossip":
        return GossipSchedule()
    if a == "local":
        return LocalSchedule(H=dist.H)
    if a == "gossip_pga":
        return PGASchedule(H=dist.H)
    if a in ("gossip_aga", "slowmo", "hier_pga", "gt_pga"):
        raise not_ported(f"the {a} schedule", "A.2")
    raise ValueError(f"make_schedule: unknown algorithm {a!r}")
