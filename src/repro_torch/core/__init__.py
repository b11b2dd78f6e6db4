"""Core: Gossip SGD with Periodic Global Averaging (counterpart of
``repro/core``).

topology.py   — mixing matrices W, β, circulant shift decompositions
mixing.py     — stacked and one-device sharded gossip, global averaging,
                push-sum rounds
faults.py     — FaultSchedule: seeded drops, rejoins, resampled wiring
schedule.py   — PGA fixed period, AGA adaptive period (paper Alg. 2), baselines
algo.py       — the algorithm registry and its hooks
algorithms.py — Decentralized wiring + the exact-math simulator
"""
from repro_torch.core import algorithms, mixing, schedule, topology  # noqa: F401
from repro_torch.core.algorithms import Decentralized, simulate  # noqa: F401
from repro_torch.core.schedule import make_schedule  # noqa: F401
