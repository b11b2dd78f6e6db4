"""Distributed logistic regression data — paper §5.1 (counterpart of
``repro/data/logistic.py``).

f_i(x) = (1/M) Σ_m ln(1 + exp(-y_{i,m} h_{i,m}^T x))
h ~ N(0, 10 I_d); label y from the logistic model at a node-specific x*_i
(non-iid) or a shared x* (iid); each x*_i normalized.

The numpy generation is the reference's, draw for draw, so ``H`` and ``y``
(float32, as the reference's ``jnp.asarray`` casts them) are bit for bit
the reference's.  The problem's tensors live on its device (``"cuda"``
unless the caller asks for the CPU).  A stochastic gradient draws its
indices from the ``torch.Generator`` the caller passes — another stream
than the reference's ``jax.random`` keys.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass
class LogisticProblem:
    H: torch.Tensor           # (n, M, d) features, float32
    y: torch.Tensor           # (n, M) labels in {+1, -1}, float32
    d: int
    n: int
    M: int

    def grad_fn(self, batch: int = 0) -> Callable:
        """Per-node gradient ``grad(x (n, d), generator, step) -> (n, d)``:
        the full gradient for ``batch <= 0``, else ``batch`` examples per
        node drawn uniformly with replacement from ``generator`` (a
        ``torch.Generator`` on the problem's device)."""
        H, y, M = self.H, self.y, self.M

        def full_grad(x, generator=None, step=None):
            return batch_grad(H, y, x)

        if batch <= 0:
            return full_grad

        def stoch_grad(x, generator, step=None):
            idx = sample_indices(self.n, batch, M, generator, H.device)
            Hb = torch.take_along_dim(H, idx[..., None], dim=1)
            yb = torch.take_along_dim(y, idx, dim=1)
            return batch_grad(Hb, yb, x)

        return stoch_grad

    def loss_fn(self) -> Callable:
        """``loss(x̄ (d,))``: the global objective f(x̄)."""
        H, y = self.H, self.y

        def loss(xbar):
            z = -y * torch.einsum("nmd,d->nm", H, xbar)
            return torch.mean(torch.logaddexp(torch.zeros_like(z), z))

        return loss


def sample_indices(n: int, batch: int, M: int, generator: torch.Generator,
                   device) -> torch.Tensor:
    """``(n, batch)`` example indices in [0, M), from ``generator``."""
    return torch.randint(0, M, (n, batch), generator=generator,
                         device=device)


def batch_grad(Hb: torch.Tensor, yb: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """The logistic gradient of each node over its rows ``Hb (n, b, d)``,
    ``yb (n, b)`` at ``x (n, d)``, averaged over the b rows."""
    z = -yb * torch.einsum("nmd,nd->nm", Hb, x)
    s = torch.sigmoid(z)
    return -torch.einsum("nm,nmd->nd", s * yb, Hb) / Hb.shape[1]


def _problem(H: np.ndarray, y: np.ndarray, device) -> LogisticProblem:
    dev = resolve_device(device)
    n, M, d = H.shape
    return LogisticProblem(
        torch.from_numpy(H.astype(np.float32)).to(dev),
        torch.from_numpy(y.astype(np.float32)).to(dev), d, n, M)


def make_logistic_problem(n: int, M: int = 8000, d: int = 10, *,
                          iid: bool = False, seed: int = 0,
                          device="cuda") -> LogisticProblem:
    rng = np.random.default_rng(seed)
    H = rng.normal(0.0, np.sqrt(10.0), size=(n, M, d))
    if iid:
        x_star = rng.standard_normal(d)
        x_star /= np.linalg.norm(x_star)
        xs = np.broadcast_to(x_star, (n, d))
    else:
        xs = rng.standard_normal((n, d))
        xs /= np.linalg.norm(xs, axis=1, keepdims=True)
    p = 1.0 / (1.0 + np.exp(-np.einsum("nmd,nd->nm", H, xs)))
    u = rng.uniform(size=(n, M))
    y = np.where(u <= p, 1.0, -1.0)
    return _problem(H, y, device)


def dirichlet_noniid_problem(n: int, M: int = 8000, d: int = 10, *,
                             alpha: float = 0.3, feature_shift: float = 2.0,
                             seed: int = 0,
                             device="cuda") -> LogisticProblem:
    """Label-skew + feature-shift sharding of ONE shared task.

    Every node shares one ground-truth ``x*`` (one global minimizer), but
    the local objectives differ: each node draws its class proportions
    from ``Dirichlet(alpha, alpha)`` and samples its M examples from the
    class pools of a global pool of 2n·M labeled examples (with
    replacement when a pool runs short), and node i's features are
    shifted by ``feature_shift`` along a node-specific unit direction.
    Plain gossip stalls at a consensus-bias floor here while gradient
    tracking (gt_pga) keeps descending.  Deterministic per ``seed``.
    """
    if n < 1:
        raise ValueError(f"dirichlet_noniid_problem: n must be >= 1, "
                         f"got {n}")
    if alpha <= 0.0:
        raise ValueError(f"dirichlet_noniid_problem: alpha must be > 0, "
                         f"got {alpha}")
    rng = np.random.default_rng(seed)
    pool = 2 * n * M
    Hp = rng.normal(0.0, np.sqrt(10.0), size=(pool, d))
    x_star = rng.standard_normal(d)
    x_star /= np.linalg.norm(x_star)
    p = 1.0 / (1.0 + np.exp(-Hp @ x_star))
    yp = np.where(rng.uniform(size=pool) <= p, 1.0, -1.0)
    by_class = {+1: np.flatnonzero(yp > 0), -1: np.flatnonzero(yp < 0)}

    H = np.empty((n, M, d))
    y = np.empty((n, M))
    for i in range(n):
        props = rng.dirichlet([alpha, alpha])
        n_pos = int(round(props[0] * M))
        for cls, count in ((+1, n_pos), (-1, M - n_pos)):
            if count == 0:
                continue
            src = by_class[cls]
            idx = rng.choice(src, size=count,
                             replace=count > src.size)
            sl = slice(0, count) if cls > 0 else slice(M - count, M)
            H[i, sl] = Hp[idx]
            y[i, sl] = cls
        shift = rng.standard_normal(d)
        shift /= np.linalg.norm(shift)
        H[i] += feature_shift * shift
    return _problem(H, y, device)
