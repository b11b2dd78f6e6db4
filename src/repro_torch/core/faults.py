"""Deterministic fault injection for push-sum gossip (numpy copy of
``repro/core/faults.py``).

A :class:`FaultSchedule` says who is alive and what the wiring is at every
step: it drops nodes mid-run, rejoins them later, and optionally resamples
the directed topology per step.  Everything derives from ``(seed, step)``
through numpy's counter-based Philox generator, so the schedule is a pure
function of the step index, and its masks, matrices and draws are bit for
bit the reference's.

Every matrix it emits is column-stochastic
(:func:`repro_torch.core.topology.push_sum_matrix`), so the push-sum mass
``Σᵢ wᵢ = n`` holds at every step of every scenario.  The queries
(``active_mask``, ``out_weights``, ``matrix``) never mutate; ``advance``
commits the counters of ``state_dict``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import topology as topo

Events = Dict[int, Tuple[int, ...]]      # step -> node ids
RESAMPLE_MODES = ("none", "hop", "peer")


def parse_fault_events(spec: str) -> Events:
    """Parse ``"step:id,id;step:id"`` (the launcher's syntax) into events."""
    out: Events = {}
    if not spec:
        return out
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        step_s, ids_s = part.split(":")
        ids = tuple(int(i) for i in ids_s.split(",") if i.strip() != "")
        if ids:
            out[int(step_s)] = tuple(sorted(set(out.get(int(step_s), ())
                                                + ids)))
    return out


@dataclass
class FaultSchedule:
    """Seeded, deterministic drop/rejoin/resample schedule.

    ``drops[t]`` lists the nodes that go down at step t (inactive from t
    on); ``rejoins[t]`` the nodes that come back at step t (a rejoin wins
    over a drop at the same step).  ``resample``: ``"none"`` (the
    topology's own shifts), ``"hop"`` (one exponential hop drawn per step
    for every node) or ``"peer"`` (every node draws its own hop per step:
    column-stochastic-only wiring even without faults).
    """
    n_nodes: int
    drops: Events = field(default_factory=dict)
    rejoins: Events = field(default_factory=dict)
    resample: str = "none"
    seed: int = 0

    # counters committed by advance()
    steps_seen: int = 0
    drops_applied: int = 0
    rejoins_applied: int = 0

    def __post_init__(self):
        if self.resample not in RESAMPLE_MODES:
            raise ValueError(f"resample must be one of {RESAMPLE_MODES}, "
                             f"got {self.resample!r}")
        for ev in (self.drops, self.rejoins):
            for t, ids in ev.items():
                bad = [i for i in ids if not (0 <= i < self.n_nodes)]
                if bad:
                    raise ValueError(f"fault event at step {t} names nodes "
                                     f"{bad} outside [0, {self.n_nodes})")

    def _rng(self, step: int) -> np.random.Generator:
        # counter-based: (seed, step) -> an independent stream
        return np.random.Generator(
            np.random.Philox(key=[self.seed & 0xFFFFFFFF, step]))

    def active_mask(self, step: int) -> np.ndarray:
        """Boolean (n,) mask of the live nodes at ``step``."""
        inactive: set = set()
        for t in sorted(set(self.drops) | set(self.rejoins)):
            if t > step:
                break
            inactive |= set(self.drops.get(t, ()))
            inactive -= set(self.rejoins.get(t, ()))
        mask = np.ones(self.n_nodes, dtype=bool)
        for i in inactive:
            mask[i] = False
        return mask

    def out_weights(self, step: int
                    ) -> Optional[List[topo.ShiftWeights]]:
        """Per-node sender shift sets at ``step``; None: the topology's."""
        if self.resample == "none":
            return None
        n = self.n_nodes
        if n == 1:
            return [{0: 1.0}]
        p = max(1, int(round(np.log2(n))))
        rng = self._rng(step)
        if self.resample == "hop":
            hop = 2 ** int(rng.integers(0, p)) % n
            shared = {0: 0.5} if hop == 0 else {0: 0.5, hop: 0.5}
            return [shared] * n
        hops = 2 ** rng.integers(0, p, size=n) % n
        return [({0: 0.5} if h == 0 else {0: 0.5, int(h): 0.5})
                for h in hops]

    def matrix(self, topology: str, step: int,
               shift_step: Optional[int] = None) -> np.ndarray:
        """Column-stochastic mixing matrix of the gossip round at ``step``;
        ``shift_step`` (default ``step``) is the period-reduced index of
        the topology's own time variation (one_peer_exp)."""
        return topo.push_sum_matrix(
            topology, self.n_nodes,
            step=step if shift_step is None else shift_step,
            active=self.active_mask(step),
            out_weights=self.out_weights(step))

    def hop_superset(self, topology: str) -> Tuple[int, ...]:
        """Every shift a sender might ever use: the static superset from
        which the sharded rounds take their halo offsets."""
        shifts: set = set()
        period = max(1, topo.schedule_period(topology, self.n_nodes))
        for k in range(period):
            shifts |= set(topo.shift_weights(topology, self.n_nodes, k))
        if self.resample != "none" and self.n_nodes > 1:
            p = max(1, int(round(np.log2(self.n_nodes))))
            shifts |= {0} | {2 ** j % self.n_nodes for j in range(p)}
        return tuple(sorted(shifts))

    def events_before(self, step: int) -> Tuple[int, int]:
        """(drops, rejoins) event counts at steps < ``step``."""
        d = sum(len(ids) for t, ids in self.drops.items() if t < step)
        r = sum(len(ids) for t, ids in self.rejoins.items() if t < step)
        return d, r

    def advance(self, step: int) -> np.ndarray:
        """Commit step ``step``: return its active mask and update the
        counters."""
        mask = self.active_mask(step)
        self.steps_seen += 1
        self.drops_applied += len(self.drops.get(step, ()))
        self.rejoins_applied += len(self.rejoins.get(step, ()))
        return mask

    def state_dict(self) -> Dict[str, int]:
        return {"steps_seen": self.steps_seen,
                "drops_applied": self.drops_applied,
                "rejoins_applied": self.rejoins_applied}

    def load_state_dict(self, sd: Dict[str, int]) -> None:
        self.steps_seen = int(sd.get("steps_seen", 0))
        self.drops_applied = int(sd.get("drops_applied", 0))
        self.rejoins_applied = int(sd.get("rejoins_applied", 0))


def push_round(topology: str, n: int, phase: str, step: int,
               shift_step: int, fault_schedule: Optional[FaultSchedule] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side ``(W, active)`` of the push-sum round at absolute ``step``
    (float64 W, boolean mask), as the reference's Trainer and simulator
    build them: a gossip round's W is the topology's (at ``shift_step``)
    or ``fault_schedule``'s, an averaging round's the global push matrix
    over the live nodes, and a step without a round the identity.
    ``fault_schedule.advance`` commits its counters."""
    active = (fault_schedule.advance(step) if fault_schedule is not None
              else np.ones(n, dtype=bool))
    if phase == "gossip":
        W = (fault_schedule.matrix(topology, step, shift_step=shift_step)
             if fault_schedule is not None else
             topo.push_sum_matrix(topology, n, step=shift_step))
    elif phase in ("global", "pod_avg"):
        W = topo.global_push_matrix(n, active)
    else:
        W = np.eye(n)
    return W, active
