"""Gossip topologies: circulant shift decompositions, dense mixing
matrices W, the mixing rate β, the push-sum matrices and the paper's
transient-stage quantities (numpy copy of ``repro/core/topology.py``).

Every topology here is circulant (or 2-D circulant on a torus), so
``W·x = Σ_s w_s · roll(x, s)`` along the node axis.  The directed
circulants (``directed_ring``, ``directed_exp``) are asymmetric but
doubly stochastic under full participation; faults make a push-sum round
only column-stochastic (:func:`push_sum_matrix` renormalizes a sender's
column over its surviving receivers), which keeps the mass ``Σw = n``.
:func:`c_beta`, :func:`d_beta` and :func:`transient_stage` are the
paper's Tables 2–3 (App. D), :func:`effective_beta` the β they take for
a topology; numpy and Python floats only.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

ShiftWeights = Dict[int, float]
GridShiftWeights = Dict[Tuple[int, int], float]

CIRCULANT_TOPOLOGIES = ("ring", "exp", "one_peer_exp", "full",
                        "disconnected", "directed_ring", "directed_exp")
DIRECTED_TOPOLOGIES = ("directed_ring", "directed_exp")
KNOWN_TOPOLOGIES = CIRCULANT_TOPOLOGIES + ("grid",)


def _require_power_of_two(n: int, what: str) -> int:
    p = int(round(math.log2(n)))
    if 2 ** p != n:
        raise ValueError(f"{what} requires power-of-two node count, got {n}")
    return p


def shift_weights(topology: str, n: int, step: int = 0) -> ShiftWeights:
    """Circulant decomposition ``{shift: weight}`` of W for 1-D
    topologies; ``step`` selects the one-peer exponential graph's hop
    ``2^(step mod log2 n)``."""
    if n == 1:
        return {0: 1.0}
    if topology == "ring":
        if n == 2:
            return {0: 1.0 / 3.0, 1: 2.0 / 3.0}
        return {0: 1.0 / 3.0, 1: 1.0 / 3.0, n - 1: 1.0 / 3.0}
    if topology == "exp":
        p = _require_power_of_two(n, "exp topology")
        shifts = [0] + [2 ** j for j in range(p)]
        w = 1.0 / len(shifts)
        return {s: w for s in shifts}
    if topology == "one_peer_exp":
        p = _require_power_of_two(n, "one-peer exp topology")
        hop = 2 ** (step % p)
        return {0: 0.5, hop: 0.5}
    if topology == "full":
        return {s: 1.0 / n for s in range(n)}
    if topology == "disconnected":
        return {0: 1.0}
    if topology == "directed_ring":
        return {0: 0.5, 1: 0.5}
    if topology == "directed_exp":
        p = _require_power_of_two(n, "directed exp topology")
        out: ShiftWeights = {0: 2.0 ** -p}
        for j in range(p):
            out[2 ** j] = out.get(2 ** j, 0.0) + 2.0 ** -(j + 1)
        return out
    raise ValueError(f"no 1D shift decomposition for topology {topology!r}")


def grid_shape(n: int) -> Tuple[int, int]:
    """Near-square factorization for the torus grid."""
    r = int(math.sqrt(n))
    while n % r != 0:
        r -= 1
    return r, n // r


def grid_shift_weights(n: int) -> GridShiftWeights:
    """Torus grid: nodes average with 4 neighbors (|N_i|=5, paper §3.4)."""
    r, c = grid_shape(n)
    w = 1.0 / 5.0
    out: GridShiftWeights = {(0, 0): w}
    for dr, dc in ((1, 0), (r - 1, 0), (0, 1), (0, c - 1)):
        out[(dr, dc)] = out.get((dr, dc), 0.0) + w
    return out


def mixing_matrix(topology: str, n: int, step: int = 0) -> np.ndarray:
    """Dense doubly-stochastic W ∈ R^{n×n} for ``topology``."""
    if topology == "grid":
        r, c = grid_shape(n)
        W = np.zeros((n, n))
        for (dr, dc), w in grid_shift_weights(n).items():
            P = np.zeros((n, n))
            for i in range(n):
                ir, ic = divmod(i, c)
                j = ((ir + dr) % r) * c + (ic + dc) % c
                P[i, j] = 1.0
            W += w * P
        return W
    W = np.zeros((n, n))
    for s, w in shift_weights(topology, n, step).items():
        W += w * np.roll(np.eye(n), s, axis=1)    # W[i, (i+s)%n] = w_s
    return W


def is_doubly_stochastic(W: np.ndarray, tol: float = 1e-9) -> bool:
    n = W.shape[0]
    ones = np.ones(n)
    return (bool(np.all(W >= -tol))
            and np.allclose(W @ ones, ones, atol=tol)
            and np.allclose(ones @ W, ones, atol=tol))


def is_column_stochastic(W: np.ndarray, tol: float = 1e-9) -> bool:
    n = W.shape[0]
    ones = np.ones(n)
    return bool(np.all(W >= -tol)) and np.allclose(ones @ W, ones, atol=tol)


def perron_vector(W: np.ndarray) -> np.ndarray:
    """Right Perron vector of a column-stochastic W (``Wπ = π``,
    ``Σπ = 1``)."""
    vals, vecs = np.linalg.eig(W)
    idx = int(np.argmin(np.abs(vals - 1.0)))
    pi = np.real(vecs[:, idx])
    s = pi.sum()
    if abs(s) < 1e-12:
        pi = np.abs(pi)
        s = pi.sum()
    return pi / s


def beta(W: np.ndarray) -> float:
    """Mixing rate ``β = ‖W − (1/n)𝟙𝟙ᵀ‖₂`` (Assumption 3); for a
    column-stochastic-only W the Perron-vector form ``‖W − π𝟙ᵀ‖₂``."""
    n = W.shape[0]
    if is_doubly_stochastic(W):
        J = np.ones((n, n)) / n
        return float(np.linalg.svd(W - J, compute_uv=False)[0])
    if not is_column_stochastic(W):
        raise ValueError(
            "beta(W) needs a (column-)stochastic matrix; got one whose "
            "columns do not sum to 1")
    pi = perron_vector(W)
    return float(np.linalg.svd(W - np.outer(pi, np.ones(n)),
                               compute_uv=False)[0])


def effective_beta(topology: str, n: int) -> float:
    """β for static topologies; for the time-varying one-peer exponential
    graph, the per-period contraction ‖Π_k (W_k − J)‖^(1/p) (0 for n a
    power of two: exact averaging after log2 n steps, paper §3)."""
    if n == 1:
        return 0.0
    if topology == "one_peer_exp":
        p = _require_power_of_two(n, "one-peer exp topology")
        P = np.eye(n)
        for k in range(p):
            P = mixing_matrix(topology, n, step=k) @ P
        return beta(P) ** (1.0 / p) if beta(P) > 0 else 0.0
    return beta(mixing_matrix(topology, n))


def schedule_period(topology: str, n: int) -> int:
    """Distinct mixing matrices over time: log2(n) for the one-peer
    exponential graph, 1 for static topologies; unknown names raise."""
    if topology not in KNOWN_TOPOLOGIES:
        raise ValueError(f"unknown topology {topology!r}; "
                         f"expected one of {KNOWN_TOPOLOGIES}")
    if topology == "one_peer_exp" and n > 1:
        return _require_power_of_two(n, "one-peer exp topology")
    return 1


def push_sum_matrix(topology: str, n: int, step: int = 0,
                    active: Optional[np.ndarray] = None,
                    out_weights: Optional[List[ShiftWeights]] = None,
                    ) -> np.ndarray:
    """Column-stochastic W for one push-sum round, honouring failures.

    Column j is how active sender j splits its mass among its receivers
    ``(j - s) % n`` for each shift s (``W[i, (i+s) % n] = w_s``, as in
    :func:`mixing_matrix`, which it equals under full participation).  A
    dropped node (``active[j] == False``) neither sends nor receives: its
    row and column collapse to ``e_j``.  An active sender renormalizes its
    out-weights over its surviving receivers, so every column still sums
    to 1.  ``out_weights`` (one ShiftWeights per node) gives each sender
    its own shift set (per-step resampling); it defaults to
    ``shift_weights(topology, n, step)`` for every node.
    """
    if active is None:
        active = np.ones(n, dtype=bool)
    active = np.asarray(active, dtype=bool)
    if active.shape != (n,):
        raise ValueError(f"active mask shape {active.shape} != ({n},)")
    if out_weights is None:
        shared = shift_weights(topology, n, step)
        out_weights = [shared] * n
    if len(out_weights) != n:
        raise ValueError("out_weights must have one entry per node")
    W = np.zeros((n, n))
    for j in range(n):
        if not active[j]:
            W[j, j] = 1.0
            continue
        live = {s: w for s, w in out_weights[j].items()
                if active[(j - s) % n]}
        z = sum(live.values())
        if z <= 0.0:                      # all receivers down: keep own mass
            W[j, j] = 1.0
            continue
        for s, w in live.items():
            W[(j - s) % n, j] += w / z
    return W


def global_push_matrix(n: int, active: Optional[np.ndarray] = None
                       ) -> np.ndarray:
    """The PGA global round as a push-sum matrix: the exact average of the
    joint ``(x, w)`` pair over the active set, ``W = a aᵀ/|A| + diag(1 −
    a)`` (dropped nodes keep their own mass); ``𝟙𝟙ᵀ/n`` under full
    participation."""
    if active is None:
        active = np.ones(n, dtype=bool)
    a = np.asarray(active, dtype=float)
    n_live = a.sum()
    if n_live == 0:
        return np.eye(n)
    return np.outer(a, a) / n_live + np.diag(1.0 - a)


# ---------------------------------------------------------------------------
# Paper quantities: C_β, D_β, transient stages (Tables 2, 3)
# ---------------------------------------------------------------------------
def c_beta(b: float, H: int) -> float:
    """C_β = Σ_{k=0}^{H-1} β^k = (1 − β^H)/(1 − β); H when β ≥ 1."""
    if b >= 1.0:
        return float(H)
    return (1.0 - b ** H) / (1.0 - b)


def d_beta(b: float, H: int) -> float:
    """D_β = min{H, 1/(1 − β)}; H when β ≥ 1."""
    if b >= 1.0:
        return float(H)
    return min(float(H), 1.0 / (1.0 - b))


def transient_stage(algorithm: str, n: int, b: float, H: int,
                    iid: bool = False) -> float:
    """Transient-stage length in iterations (paper Tables 2 and 3, App. D)
    of ``parallel``, ``gossip``, ``local``, ``gossip_pga`` and
    ``gossip_aga``; any other algorithm raises ``ValueError``."""
    if algorithm == "parallel":
        return 0.0
    if algorithm == "gossip":
        g = 1.0 - b
        return n ** 3 * b ** 4 / (g ** 2 if iid else g ** 4)
    if algorithm == "local":
        return n ** 3 * (H ** 2 if iid else H ** 4)
    if algorithm in ("gossip_pga", "gossip_aga"):
        cb, db = c_beta(b, H), d_beta(b, H)
        return n ** 3 * b ** 4 * cb ** 2 * (1.0 if iid else db ** 2)
    raise ValueError(f"no transient model for {algorithm!r}")
