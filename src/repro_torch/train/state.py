"""TrainState, node-stacking and push-sum helpers (counterpart of
``repro/train/state.py``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.tree import pairwise_mean, tree_leaves, tree_map

PyTree = Any


@dataclasses.dataclass
class TrainState:
    params: PyTree               # stacked: leading node axis
    opt_state: PyTree
    step: int                    # host counter of executed steps
    extras: Dict[str, PyTree] = dataclasses.field(default_factory=dict)

    @property
    def ef_state(self) -> Optional[PyTree]:
        """Per-node error-feedback memory (None without error feedback)."""
        return self.extras.get("ef_state")

    @property
    def push_weight(self) -> Optional[torch.Tensor]:
        """The ``(n, 1)`` float32 push-sum weight (None without push-sum);
        readers de-bias with :func:`debias`, and ``Σw = n`` holds."""
        return self.extras.get("push_weight")


def init_push_weight(n_nodes: int, device="cpu") -> torch.Tensor:
    """Push-sum weights start at 1 on every node (Σw = n)."""
    return torch.ones((n_nodes, 1), dtype=torch.float32, device=device)


def debias(params_stacked: PyTree, push_weight: Optional[torch.Tensor]
           ) -> PyTree:
    """The de-biased read ``x/w``, the push-sum estimate of the average;
    the identity when ``push_weight`` is None.  Divides in fp32 and casts
    back per leaf; w broadcasts over each leaf's trailing dims."""
    if push_weight is None:
        return params_stacked
    w = push_weight.reshape(-1).to(torch.float32)

    def one(p):
        wb = w.reshape((p.shape[0],) + (1,) * (p.dim() - 1))
        return (p.to(torch.float32) / wb).to(p.dtype)

    return tree_map(one, params_stacked)


def stack_for_nodes(tree: PyTree, n_nodes: int) -> PyTree:
    """x_i^(0) identical across nodes (paper Alg. 1 requirement); each node
    gets its own copy."""
    return tree_map(
        lambda p: p[None].expand((n_nodes,) + tuple(p.shape)).contiguous(),
        tree)


def consensus_distance(params_stacked: PyTree, mesh=None) -> torch.Tensor:
    """(1/n) Σ_i ‖x_i − x̄‖² summed over all parameters — the paper's
    consensus quantity (§4 Intuition).  x̄ is the node mean taken by
    pairwise halving, as the fused round's residual takes it: for n a
    power of two it is exact on equal rows, so the consensus after an
    exact average is exactly 0.0 (a running sum over the rows is not
    exact: 3·x rounds).

    On a rank mesh (``mesh.distributed``) ``params_stacked`` holds this
    rank's m rows of n = m·k: x̄ is the same halving, each level's row
    additions made where the destination row lives after its source row
    crossed the mesh (:func:`pairwise_mean_ranks`, the same bits as
    :func:`repro_torch.tree.pairwise_mean` on all n rows), and the
    squared distances are summed per rank and folded over the ranks in
    order.  Both run over the node-axis ranks (``mesh.exchange``): on a
    2-D mesh the model ranks of one node shard hold the same rows."""
    if mesh is not None and mesh.distributed:
        return _consensus_ranks(params_stacked, mesh)

    def one(p):
        p32 = p.to(torch.float32)
        xbar = pairwise_mean(p32)
        return torch.sum(torch.square(p32 - xbar)) / p.shape[0]
    return sum(one(p) for p in tree_leaves(params_stacked))


def _runs(rows, owner):
    """``[(owner, first, last + 1)]``: consecutive ``rows`` grouped by
    ``owner(row)``."""
    out = []
    for i in rows:
        o = owner(i)
        if out and out[-1][0] == o and out[-1][2] == i:
            out[-1] = (o, out[-1][1], i + 1)
        else:
            out.append((o, i, i + 1))
    return out


def pairwise_mean_ranks(x: torch.Tensor, mesh) -> torch.Tensor:
    """:func:`repro_torch.tree.pairwise_mean` over the n = m·k rows spread
    over the k node shards of a rank mesh (``x`` this rank's m rows,
    global rows ``r·m …``, r its node shard; ``mesh.exchange``):
    at each level of c rows, row ``c − h + i`` is added into row i (h =
    c // 2), sent first when another rank holds it; rank 0 ends with row
    0, divides it by n and sends x̄ to every rank.  Returns the ``(1, D)``
    x̄ on every rank."""
    ex = mesh.exchange
    m, k, r = x.shape[0], ex.k, ex.rank
    n, lo, hi = m * k, r * m, (r + 1) * m
    s = x.clone()

    def owner(i):
        return i // m

    c = n
    while c > 1:
        h = c // 2
        base = c - h
        sends = [(o, s[a - lo:b - lo])
                 for o, a, b in _runs(range(max(lo, base), min(hi, c)),
                                      lambda i: owner(i - base))
                 if o != r]
        recvs, adds = [], []
        for o, a, b in _runs(range(lo, min(hi, h)),
                             lambda i: owner(i + base)):
            if o == r:
                adds.append((a, b, s[a + base - lo:b + base - lo]))
            else:
                buf = torch.empty((b - a,) + tuple(x.shape[1:]),
                                  dtype=x.dtype, device=x.device)
                recvs.append((o, buf))
                adds.append((a, b, buf))
        ex.sendrecv(sends, recvs)
        for a, b, src in adds:
            s[a - lo:b - lo] += src
        c = base
    xbar = s[:1] / n if r == 0 else torch.empty_like(s[:1])
    ex.sendrecv([(o, xbar) for o in range(1, k)] if r == 0 else [],
                [(0, xbar)] if r else [])
    return xbar


def _consensus_ranks(params_stacked: PyTree, mesh) -> torch.Tensor:
    """:func:`consensus_distance` on a rank mesh: x̄ of the packed rows by
    :func:`pairwise_mean_ranks`, each leaf's squared distances summed on
    this rank, the per-leaf sums folded over the ranks."""
    leaves = tree_leaves(params_stacked)
    m = leaves[0].shape[0]
    n = m * mesh.exchange.k
    x = torch.cat([p.reshape(m, -1).to(torch.float32) for p in leaves],
                  dim=1)
    xbar = pairwise_mean_ranks(x, mesh)
    parts, col = [], 0
    for p in leaves:
        w = p[0].numel()
        parts.append(torch.sum(torch.square(x[:, col:col + w]
                                            - xbar[:, col:col + w])))
        col += w
    del x
    sums = mesh.exchange.fold(torch.stack(parts))
    return sum(t / n for t in sums.unbind(0))
