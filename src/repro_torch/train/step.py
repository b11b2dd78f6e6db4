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
honouring ``DistConfig.comm_shard_mode``; a mesh that also has
``DistConfig.model_axis`` runs them 2-D.  On a rank mesh (one
``torch.distributed`` rank per block, :func:`check_rank_mesh`) the step
holds the m = n/k nodes of this rank's node shard, whole: its batch,
grads and optimizer rows are theirs, the rounds put whole rows back
together across the model axis, and every reduction over the node axis
crosses the node-axis ranks only (``mesh.exchange``), in a fixed order
(the metric means, the joint gradient norm, the consensus, push-sum's
mass): the k_model ranks of a node shard hold the same values, so a
fold over the whole world would count them k_model times.  With
``DistConfig.push_sum`` the step runs every round as a push-sum round of
the joint ``(x, w)`` pair against the round's runtime W
(``mixing.communicate_push_sum``).
With ``DistConfig.comm_overlap`` the step is ``step(state, batch, lr,
comm_buf) -> (state, metrics, new_buf)``: a gossip step finishes the
round buffered one step ago (``mixing.finish_round`` with the buffer's
shift) and starts the next from its half-step iterate
(``mixing.start_round``); global and pod steps flush synchronously and
re-prime (``mixing.overlap_flush``); ``"none"`` returns the buffer
unchanged.  An algorithm-owned phase (SlowMo's outer step) runs no round:
``post_round`` consumes the half-step iterate.  Algorithms with a payload
(GT-PGA's tracker) send the joint tree ``{"params": ..., <slot>: ...}``
through ``communicate``.  The fused consensus rounds bypass
``communicate`` and meter themselves (``mixing.meter_round``).

With ``TrainConfig.microbatches`` m > 1 every mode accumulates the grads
of m slices of each node's batch (rows ``[i·b/m, (i+1)·b/m)``, the
reference's reshape): their fp32 sum over the slices in order, then
``/ m``; the metrics are the mean over the slices of each slice's node
mean (:func:`build_grad_fn`, the step's gradient phase alone).
``DistConfig.remat`` and ``remat_policy`` map to the blocks' policy as
in the reference: ``"none"``, else ``"dots"`` or ``"default"``
(``models.blocks.make_remat``).
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
from repro_torch.configs.base import not_ported
from repro_torch.optim import clip_by_global_norm, make_optimizer
from repro_torch.optim.optimizers import joint_sq_norm
from repro_torch.train.state import TrainState, consensus_distance, debias
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

PyTree = Any


def _grad_global_norm(grads: PyTree, mesh=None,
                      node_axis: str = "data") -> torch.Tensor:
    """Global L2 norm over all nodes' grads (an on-device monitor)."""
    return torch.sqrt(joint_sq_norm(grads, mesh, node_axis))


def check_rank_mesh(tcfg: TrainConfig, mesh) -> None:
    """What a rank mesh does not run yet raises (ROADMAP A.10.1): SlowMo
    (its outer step means every node's rows) and checkpoints.  No-op for
    a local mesh or none."""
    if mesh is None or not mesh.distributed:
        return
    if tcfg.dist.algorithm == "slowmo":
        raise not_ported("SlowMo over ranks (its outer step's node mean)",
                         "A.10.1")
    if tcfg.ckpt_every:
        raise not_ported("checkpoints over ranks", "A.10.1")


def node_means(metrics: Dict[str, torch.Tensor], mesh=None
               ) -> Dict[str, torch.Tensor]:
    """The node mean of each per-node metric.  On a rank mesh every node
    shard's rows are gathered first (one ``all_gather`` of them all over
    the node-axis ranks), so the mean is taken over all n nodes in node
    order, the same bits as in one process."""
    if mesh is None or not mesh.distributed:
        return {k: v.detach().mean() for k, v in metrics.items()}
    from repro_torch.core.mesh import pack_arrays, unpack_arrays
    vals = [v.detach().contiguous() for v in metrics.values()]
    got = [unpack_arrays(g, vals)
           for g in mesh.exchange.all_gather(pack_arrays(vals))]
    return {k: torch.cat([g[i] for g in got]).mean()
            for i, k in enumerate(metrics)}


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


def check_microbatches(per_node_batch: int, microbatches: int) -> None:
    """The per-node batch must split into equal microbatches (the
    reference fails at its reshape)."""
    if per_node_batch % microbatches:
        raise ValueError(f"per-node batch {per_node_batch} is not divisible "
                         f"by microbatches={microbatches}")


def build_grad_fn(model: Model, tcfg: TrainConfig, mesh=None) -> Callable:
    """The step's gradient phase alone: ``grad_fn(params, batch) ->
    (grads, metrics)`` over node-stacked ``params`` and a batch of
    ``(n_nodes, per_node_batch, …)`` leaves, under the remat policy of
    ``tcfg.dist`` and with ``tcfg.microbatches`` slices accumulated.
    ``grads`` are per node and unscaled (the loss is summed over the
    nodes); ``metrics`` are the node means as device scalars (over every
    rank's nodes on a rank ``mesh``: :func:`node_means`)."""
    # DistConfig.remat/remat_policy -> the blocks' remat policy
    if tcfg.dist.remat == "none":
        remat = "none"
    elif tcfg.dist.remat_policy == "dots":
        remat = "dots"
    else:
        remat = "default"

    def grad_fn(params: PyTree, batch: PyTree):
        leaves, treedef = tree_flatten(params)
        with torch.enable_grad():
            live = [p.detach().requires_grad_(True) for p in leaves]
            losses, metrics = model.node_losses(
                tree_unflatten(treedef, live), batch, remat=remat,
                z_loss=tcfg.z_loss)
            # sum over nodes => grads land per node, unscaled (Alg. 1);
            # a leaf the loss does not read (an audio encoder's token
            # table) gets zeros, as under jax.grad
            grads = torch.autograd.grad(losses.sum(), live,
                                        allow_unused=True,
                                        materialize_grads=True)
        return tree_unflatten(treedef, list(grads)), node_means(metrics,
                                                                mesh)

    def accum_grad_fn(params: PyTree, batch: PyTree):
        """Gradient accumulation over ``tcfg.microbatches`` slices of each
        node's batch: activation memory drops about m× at the same math
        (for the encoder each slice has its own mask count, so the mean
        of the slices is not the full batch's mean, as in the
        reference)."""
        m = tcfg.microbatches
        b = tree_leaves(batch)[0].shape[1]
        check_microbatches(b, m)
        bm = b // m
        leaves, treedef = tree_flatten(params)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        mets = []
        for i in range(m):
            g, met = grad_fn(params, {k: t[:, i * bm:(i + 1) * bm]
                                      for k, t in batch.items()})
            for a, gi in zip(acc, tree_leaves(g)):
                a.add_(gi)
            del g
            mets.append(met)
        grads = tree_unflatten(treedef, [a.div_(m) for a in acc])
        return grads, {k: torch.stack([mt[k] for mt in mets]).mean()
                       for k in mets[0]}

    return accum_grad_fn if tcfg.microbatches > 1 else grad_fn


def build_train_step(model: Model, tcfg: TrainConfig, n_nodes: int, *,
                     phase: str, shift_step: int = 0, buf_shift: int = 0,
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
    (None: the stacked rounds); on a rank mesh ``state`` and ``batch``
    hold this rank's m = n/k nodes and ``n_nodes`` stays n.

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

    With ``DistConfig.comm_overlap`` the step is ``step(state, batch, lr,
    comm_buf) -> (state, metrics, new_buf)``, ``comm_buf`` the round state
    of ``mixing.start_round``: a gossip step applies it with the factors
    of ``buf_shift`` (the shift of the step that primed it), then primes
    the next one from its half-step iterate; global and pod steps run the
    synchronous round and re-prime from its result; an owned phase
    re-primes from ``post_round``'s result; ``"none"`` returns the buffer
    unchanged.  The consensus is ``consensus_distance`` of the new params
    (the residual is not fused).
    """
    tcfg.validate()
    dist = tcfg.dist
    dist.validate_nodes(n_nodes)
    check_rank_mesh(tcfg, mesh)
    algo = algo_lib.get_algorithm(dist.algorithm, caller="build_train_step")
    # "none" (no round) is every algorithm's: a one-node Trainer and the
    # occupancy calibration's compute-only step run it
    if phase != "none" and phase not in algo.phases:
        raise ValueError(f"build_train_step: phase {phase!r} is not one of "
                         f"{dist.algorithm}'s phases {algo.phases}")
    sharded_comm = mixing.use_sharded_backend(
        dist.comm_backend, mesh, dist.node_axis, dist.comm_shard_mode,
        dist.model_axis)
    spec = dist.comm_spec(n_nodes, mesh=mesh)
    spec_plain = spec.replace(compressor=None, global_compressor=None)
    lossy_global = (spec.global_compressor is not None
                    and spec.global_compressor.lossy)
    lossy_round = n_nodes > 1 and (
        (spec.lossy and phase in ("gossip", "global", "pod_avg"))
        or (lossy_global and phase in ("global", "pod_avg")))
    owned = phase in algo.owned_phases
    push = dist.push_sum
    overlap = dist.comm_overlap
    # the node rows this process holds: all n, or rows row0 … row0 +
    # rows − 1 on a rank mesh
    ranked = mesh is not None and mesh.distributed
    rows = n_nodes // mesh.node_count if ranked else n_nodes
    row0 = mesh.node_rank * rows if ranked else 0
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
    # the joint gradient norm folds per node shard under the sharded
    # rounds, on a rank mesh and in one process alike (joint_sq_norm)
    norm_mesh = mesh if sharded_comm else None
    opt = make_optimizer(tcfg.optimizer, per_node=True)
    fused_consensus_round = (dist.comm_backend == "pallas" and with_consensus
                             and n_nodes > 1 and not lossy_round
                             and phase in mixing_cuda.KERNEL_PHASES)

    grad_fn = build_grad_fn(model, tcfg, mesh)

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
        if fused_consensus_round and not has_payload:
            # the fused round bypasses communicate(): meter it here
            mixing.meter_round(params_half, spec_plain, phase=phase,
                               step=shift_step)
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
                  model_axis=dist.model_axis,
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

    def _overlap_round(extras, params_half, step_seed: int, comm_buf,
                       sctx):
        """``(mixed, new_buf, owned_params)``: the round of an overlapped
        step; an owned phase returns its new params as ``owned_params``
        (and no ``mixed``)."""
        payload = algo.comm_payload(extras, params_half)
        has_payload = bool(payload)
        joint = algo_lib.join_payload(payload, params_half)
        ef_name = algo_lib.EF_SLOT.name
        if phase == "none" or n_nodes == 1:
            return algo_lib.wrap_mixed(joint, has_payload), comm_buf, None
        if owned:
            # no round to finish: post_round consumes the half-step and
            # its result re-primes the buffer
            new_params, extras2 = algo.post_round(
                extras, algo_lib.wrap_mixed(joint, has_payload), phase, sctx)
            extras.clear()
            extras.update(extras2)
            reprime = algo_lib.join_payload(
                algo.comm_payload(extras, new_params), new_params)
            new_buf, new_ef = mixing.start_round(
                reprime, spec, ef_state=extras.get(ef_name), seed=step_seed)
            if new_ef is not None:
                extras[ef_name] = new_ef
            return None, new_buf, new_params
        if phase == "gossip":
            # finish the round primed one step ago, with its shift, then
            # issue the next from this half-step:
            # x_{t+1} = y_t + (W(buf_shift) − I)·y_{t−1}
            mixed = mixing.finish_round(joint, comm_buf, spec,
                                        step=buf_shift)
            new_buf, new_ef = mixing.start_round(
                joint, spec, ef_state=extras.get(ef_name), seed=step_seed)
        else:
            mixed, new_buf, new_ef = mixing.overlap_flush(
                joint, spec, phase=phase, step=shift_step,
                ef_state=extras.get(ef_name), seed=step_seed)
        if new_ef is not None:
            extras[ef_name] = new_ef
        return algo_lib.wrap_mixed(mixed, has_payload), new_buf, None

    def _core(state: TrainState, batch: PyTree, lr, W=None, active=None,
              comm_buf=None):
        """``(new_state, metrics, new_buf)``; ``new_buf`` is None unless
        the step is overlapped."""
        extras = dict(state.extras)
        dropped, mine = [], []
        if push:
            live = _host_mask(active, n_nodes)
            dropped = [int(i) for i in np.flatnonzero(~live)]
            # this process's dropped rows, as local row indices
            mine = [i - row0 for i in dropped if row0 <= i < row0 + rows]
        grads, metrics = grad_fn(state.params, batch)
        if mine:
            a = mixing.upload(live[row0:row0 + rows],
                              tree_leaves(grads)[0].device)
            for g in tree_leaves(grads):
                g.mul_(a.reshape((rows,) + (1,) * (g.dim() - 1)))
        if with_consensus:
            metrics["grad_norm"] = _grad_global_norm(grads, norm_mesh,
                                                     dist.node_axis)
        if tcfg.optimizer.grad_clip:
            grads = clip_by_global_norm(grads, tcfg.optimizer.grad_clip,
                                        norm_mesh, dist.node_axis)
        upd, extras = algo.pre_update(extras, grads)
        params_half, opt_state = opt.update(upd, state.opt_state,
                                            state.params, lr)
        del grads, upd
        sctx = algo_lib.StepContext(dist=dist, n_nodes=n_nodes, lr=lr)
        fused_consensus = new_params = new_buf = None
        if push:
            params_half = _freeze_rows(params_half, state.params, mine,
                                       rows)
            opt_state = _freeze_rows(opt_state, state.opt_state, mine, rows)
            mixed = _push_round(extras, params_half, state.step, W,
                                not dropped)
        elif overlap:
            mixed, new_buf, new_params = _overlap_round(
                extras, params_half, state.step, comm_buf, sctx)
        else:
            mixed, fused_consensus = _sync_round(extras, params_half,
                                                 state.step)
        if new_params is None:
            new_params, extras = algo.post_round(extras, mixed, phase, sctx)
        if push:
            new_w = extras[algo_lib.PUSH_SLOT.name]
            mass = torch.sum(new_w.to(torch.float32))
            metrics["mass"] = (mesh.exchange.fold(mass.reshape(1))[0]
                               if ranked else mass)
            if with_consensus:
                metrics["consensus"] = consensus_distance(
                    debias(new_params, new_w), mesh)
        elif with_consensus:
            metrics["consensus"] = (fused_consensus
                                    if fused_consensus is not None
                                    else consensus_distance(new_params,
                                                            mesh))
        new_state = TrainState(params=new_params, opt_state=opt_state,
                               step=state.step + 1, extras=extras)
        return new_state, metrics, new_buf

    if push:
        @torch.no_grad()
        def push_step(state: TrainState, batch: PyTree, lr, W, active
                      ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
            return _core(state, batch, lr, W, active)[:2]

        return push_step

    if overlap:
        @torch.no_grad()
        def overlap_step(state: TrainState, batch: PyTree, lr, comm_buf
                         ) -> Tuple[TrainState, Dict[str, torch.Tensor],
                                    Any]:
            return _core(state, batch, lr, comm_buf=comm_buf)

        return overlap_step

    @torch.no_grad()
    def step(state: TrainState, batch: PyTree, lr
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        return _core(state, batch, lr)[:2]

    return step
