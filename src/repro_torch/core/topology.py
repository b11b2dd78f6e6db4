"""Gossip topologies: circulant shift decompositions, dense mixing
matrices W and the mixing rate β (numpy copy of the circulant and grid
part of ``repro/core/topology.py``).

Every topology here is circulant (or 2-D circulant on a torus), so
``W·x = Σ_s w_s · roll(x, s)`` along the node axis.  The push-sum fault
matrices and the paper's transient-stage formulas are not copied yet
(ROADMAP A.4, A.1).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

ShiftWeights = Dict[int, float]
GridShiftWeights = Dict[Tuple[int, int], float]

CIRCULANT_TOPOLOGIES = ("ring", "exp", "one_peer_exp", "full",
                        "disconnected", "directed_ring", "directed_exp")
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


def schedule_period(topology: str, n: int) -> int:
    """Distinct mixing matrices over time: log2(n) for the one-peer
    exponential graph, 1 for static topologies; unknown names raise."""
    if topology not in KNOWN_TOPOLOGIES:
        raise ValueError(f"unknown topology {topology!r}; "
                         f"expected one of {KNOWN_TOPOLOGIES}")
    if topology == "one_peer_exp" and n > 1:
        return _require_power_of_two(n, "one-peer exp topology")
    return 1
