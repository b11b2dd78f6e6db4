"""Training-step builder (counterpart of the sync mode of
``repro/train/step.py``): per-node forward/backward over the stacked node
axis → per-node optimizer update → one communication round (the paper's
Alg. 1).

One step body; algorithm differences enter through the
``repro_torch.core.algo`` hooks.  With ``comm_backend="pallas"`` and
``with_consensus`` the fused kernel emits the consensus residual in the
same pass that mixes the parameters (``mixing_cuda.mix_residual``), so the
step never re-reads the parameters it just wrote.  A lossy compressed round
(``comm_compression`` on gossip, ``comm_global_compression`` on the
averaging phases) goes through ``mixing.communicate`` with the step's
error-feedback memory (``extras["ef_state"]``) and the absolute step as its
rounding seed; residual fusion does not compose with compression, so its
consensus is ``consensus_distance``.  With a ``mesh`` whose node axis has
several shards (``Trainer(mesh=...)``), the fused backend runs every
round through the sharded per-shard kernels (``mixing.communicate_sharded``),
honouring ``DistConfig.comm_shard_mode``.  With ``DistConfig.push_sum``
the step runs every round as a push-sum round of the joint ``(x, w)``
pair against the round's runtime W (``mixing.communicate_push_sum``).
The overlap step mode is not ported yet (ROADMAP A.5).  An
algorithm-owned phase (SlowMo's outer step) runs no round:
``post_round`` consumes the half-step iterate.  Algorithms with a payload
(GT-PGA's tracker) send the joint tree ``{"params": ..., <slot>: ...}``
through ``communicate``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core import algo as algo_lib
from repro_torch.core import mixing
from repro_torch.core import topology as topo
from repro_torch.kernels import mixing_cuda
from repro_torch.models.model import Model
from repro_torch.optim import clip_by_global_norm, make_optimizer
from repro_torch.train.state import TrainState, consensus_distance, debias
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

PyTree = Any


def _grad_global_norm(grads: PyTree) -> torch.Tensor:
    """Global L2 norm over all nodes' grads (an on-device monitor)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(grads)))


def _host_mask(active, n_nodes: int) -> np.ndarray:
    """The live mask as a host boolean ``(n,)`` array (from a numpy array
    or a CPU tensor: it is never read back from the device)."""
    if torch.is_tensor(active):
        if active.device.type != "cpu":
            raise ValueError("push step: pass the live mask as a host array "
                             "(the step decides on it without a device "
                             "read)")
        active = active.numpy()
    live = np.asarray(active) > 0
    if live.shape != (n_nodes,):
        raise ValueError(f"push step: active mask of shape {live.shape} for "
                         f"{n_nodes} nodes")
    return live


def _freeze_rows(new: PyTree, old: PyTree, dropped, n_nodes: int) -> PyTree:
    """Dropped nodes take no step: their node rows of ``new`` (a fresh
    tree the optimizer returned) get back ``old``'s, row by row in place,
    so no second tree is allocated.  Leaves without the node axis (AdamW's
    shared ``count``) pass through.  Bitwise the reference's ``where``."""
    if dropped:
        for nw, od in zip(tree_leaves(new), tree_leaves(old)):
            if nw.dim() == 0 or nw.shape[0] != n_nodes:
                continue
            for i in dropped:
                nw[i].copy_(od[i])
    return new


def build_train_step(model: Model, tcfg: TrainConfig, n_nodes: int, *,
                     phase: str, shift_step: int = 0,
                     with_consensus: bool = False, mesh=None,
                     fault_hops: Optional[Tuple[int, ...]] = None
                     ) -> Callable:
    """Returns ``step(state, batch, lr) -> (state, metrics)``.

    ``phase``: one of ``phases_for_algorithm(dist.algorithm)``; batch
    leaves carry leading ``(n_nodes, per_node_batch, …)``.  ``metrics``
    holds device scalars (no host sync): the node-mean ``loss``/``ce``/
    ``lb_loss`` and, with ``with_consensus``, ``grad_norm`` and
    ``consensus`` (``(1/n) Σ_i ‖x_i − x̄‖²`` of the mixed params).
    ``mesh``: a :class:`repro_torch.core.mesh.Mesh` for the sharded rounds
    (None: the stacked rounds).

    With ``DistConfig.push_sum`` the step is ``step(state, batch, lr, W,
    active)``: ``W`` the round's ``(n, n)`` column-stochastic matrix and
    ``active`` the ``(n,)`` live mask, both host arrays (numpy or CPU
    tensors), new data every step.  The step copies each to the device
    once, from pinned memory without blocking, and decides on the host
    mask (the dropped rows, the weight's snap to ones after a
    full-participation global round): no device read.  Dropped nodes'
    grads are zeroed and their params and optimizer rows kept.
    ``metrics`` gains ``mass`` (``Σw``), and ``consensus`` is taken on the
    de-biased params ``x/w``.  ``fault_hops`` (``FaultSchedule.
    hop_superset``) widens the static halo offsets of the sharded rounds.
    """
    tcfg.validate()
    dist = tcfg.dist
    dist.validate_nodes(n_nodes)
    algo = algo_lib.get_algorithm(dist.algorithm, caller="build_train_step")
    if phase not in algo.phases:
        raise ValueError(f"build_train_step: phase {phase!r} is not one of "
                         f"{dist.algorithm}'s phases {algo.phases}")
    sharded_comm = mixing.use_sharded_backend(
        dist.comm_backend, mesh, dist.node_axis, dist.comm_shard_mode)
    spec = dist.comm_spec(n_nodes, mesh=mesh)
    spec_plain = spec.replace(compressor=None, global_compressor=None)
    lossy_global = (spec.global_compressor is not None
                    and spec.global_compressor.lossy)
    lossy_round = n_nodes > 1 and (
        (spec.lossy and phase in ("gossip", "global", "pod_avg"))
        or (lossy_global and phase in ("global", "pod_avg")))
    owned = phase in algo.owned_phases
    push = dist.push_sum
    ps_offsets = None
    if push and sharded_comm:
        # static halo superset: every shift the topology (over its period)
        # or the fault schedule's resampling can emit; the runtime W only
        # re-weights them (a global round gathers every shard)
        k = mixing.node_shard_count(mesh, dist.node_axis)
        if phase == "global":
            ps_offsets = tuple(range(k))
        else:
            hops = set(fault_hops or ())
            period = max(1, topo.schedule_period(dist.topology, n_nodes))
            for s in range(period):
                hops |= set(topo.shift_weights(dist.topology, n_nodes, s))
            ps_offsets = mixing.push_sum_shard_offsets(n_nodes, k, hops)
    opt = make_optimizer(tcfg.optimizer)
    remat = "none" if dist.remat == "none" else "default"
    fused_consensus_round = (dist.comm_backend == "pallas" and with_consensus
                             and n_nodes > 1 and not lossy_round
                             and phase in mixing_cuda.KERNEL_PHASES)

    def grad_fn(params: PyTree, batch: PyTree):
        leaves, treedef = tree_flatten(params)
        with torch.enable_grad():
            live = [p.detach().requires_grad_(True) for p in leaves]
            losses, metrics = model.node_losses(
                tree_unflatten(treedef, live), batch, remat=remat,
                z_loss=tcfg.z_loss)
            # sum over nodes => grads land per node, unscaled (Alg. 1)
            grads = torch.autograd.grad(losses.sum(), live)
        metrics = {k: v.detach().mean() for k, v in metrics.items()}
        return tree_unflatten(treedef, list(grads)), metrics

    def _sync_round(extras, params_half, step_seed: int):
        payload = algo.comm_payload(extras, params_half)
        has_payload = bool(payload)
        joint = algo_lib.join_payload(payload, params_half)
        if owned:
            # algorithm-owned phase (SlowMo's outer step): no round —
            # post_round consumes the half-step iterate itself
            return algo_lib.wrap_mixed(joint, has_payload), None
        if lossy_round:
            # the rounding seed is the absolute step (a host int: no sync),
            # so stochastic rounding is unbiased across steps
            mixed, new_ef = mixing.communicate(
                joint, spec, phase=phase, step=shift_step,
                ef_state=extras.get(algo_lib.EF_SLOT.name), seed=step_seed)
            if new_ef is not None:
                extras[algo_lib.EF_SLOT.name] = new_ef
            return algo_lib.wrap_mixed(mixed, has_payload), None
        if fused_consensus_round and not has_payload and sharded_comm:
            mixed, _xbar, resid = mixing.communicate_sharded(
                params_half, spec_plain, phase=phase, step=shift_step,
                with_residual=True)
            return algo_lib.wrap_mixed(mixed, False), resid / n_nodes
        if fused_consensus_round and not has_payload:
            mixed, _xbar, resid = mixing_cuda.mix_residual(
                params_half, phase=phase, topology=dist.topology,
                n_nodes=n_nodes, step=shift_step,
                comm_dtype=spec.comm_dtype, n_pods=dist.n_pods,
                leaf_threshold=dist.pallas_leaf_threshold)
            return algo_lib.wrap_mixed(mixed, False), resid / n_nodes
        mixed = mixing.communicate(joint, spec_plain, phase=phase,
                                   step=shift_step)
        return algo_lib.wrap_mixed(mixed, has_payload), None

    def _push_round(extras, params_half, step_seed: int, W, all_active):
        payload = algo.comm_payload(extras, params_half)
        has_payload = bool(payload)
        joint = algo_lib.join_payload(payload, params_half)
        w = extras[algo_lib.PUSH_SLOT.name]
        new_w = w
        kw = dict(W=W, n_nodes=n_nodes, comm_dtype=spec.comm_dtype,
                  backend=dist.comm_backend, mesh=mesh,
                  node_axis=dist.node_axis, shard_mode=dist.comm_shard_mode,
                  leaf_threshold=dist.pallas_leaf_threshold,
                  offsets=ps_offsets)
        if phase == "none" or n_nodes == 1:
            mixed = joint
        elif spec.lossy and phase == "gossip":
            mixed, new_w, new_ef = mixing.communicate_push_sum(
                joint, w, compressor=spec.compressor,
                ef_state=extras.get(algo_lib.EF_SLOT.name), seed=step_seed,
                **kw)
            if new_ef is not None:
                extras[algo_lib.EF_SLOT.name] = new_ef
        else:
            mixed, new_w = mixing.communicate_push_sum(joint, w, **kw)
        if phase == "global" and all_active:
            # a full-participation global round sets every w_i to Σw/n = 1
            # in exact arithmetic: snap to it (decided on the host mask)
            new_w = torch.ones_like(new_w)
        extras[algo_lib.PUSH_SLOT.name] = new_w
        return algo_lib.wrap_mixed(mixed, has_payload)

    def _core(state: TrainState, batch: PyTree, lr, W=None, active=None
              ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        extras = dict(state.extras)
        dropped = []
        if push:
            live = _host_mask(active, n_nodes)
            dropped = [int(i) for i in np.flatnonzero(~live)]
        grads, metrics = grad_fn(state.params, batch)
        if dropped:
            a = mixing.upload(live, tree_leaves(grads)[0].device)
            for g in tree_leaves(grads):
                g.mul_(a.reshape((n_nodes,) + (1,) * (g.dim() - 1)))
        if with_consensus:
            metrics["grad_norm"] = _grad_global_norm(grads)
        if tcfg.optimizer.grad_clip:
            grads = clip_by_global_norm(grads, tcfg.optimizer.grad_clip)
        upd, extras = algo.pre_update(extras, grads)
        params_half, opt_state = opt.update(upd, state.opt_state,
                                            state.params, lr)
        del grads, upd
        if push:
            params_half = _freeze_rows(params_half, state.params, dropped,
                                       n_nodes)
            opt_state = _freeze_rows(opt_state, state.opt_state, dropped,
                                     n_nodes)
            mixed = _push_round(extras, params_half, state.step, W,
                                not dropped)
            fused_consensus = None
        else:
            mixed, fused_consensus = _sync_round(extras, params_half,
                                                 state.step)
        sctx = algo_lib.StepContext(dist=dist, n_nodes=n_nodes, lr=lr)
        new_params, extras = algo.post_round(extras, mixed, phase, sctx)
        if push:
            new_w = extras[algo_lib.PUSH_SLOT.name]
            metrics["mass"] = torch.sum(new_w.to(torch.float32))
            if with_consensus:
                metrics["consensus"] = consensus_distance(
                    debias(new_params, new_w))
        elif with_consensus:
            metrics["consensus"] = (fused_consensus
                                    if fused_consensus is not None
                                    else consensus_distance(new_params))
        return TrainState(params=new_params, opt_state=opt_state,
                          step=state.step + 1, extras=extras), metrics

    if push:
        @torch.no_grad()
        def push_step(state: TrainState, batch: PyTree, lr, W, active
                      ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
            return _core(state, batch, lr, W, active)

        return push_step

    @torch.no_grad()
    def step(state: TrainState, batch: PyTree, lr
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        return _core(state, batch, lr)

    return step
