"""Algorithm wiring and the paper's single-process simulator (counterpart
of ``repro/core/algorithms.py``).

``Decentralized`` wires a communication schedule (core.schedule) to the
mixing primitives (core.mixing).

``simulate`` is the exact-math reference: n nodes as a leading axis on one
device, reproducing paper Alg. 1/2 step for step.  The logistic-regression
experiments (paper Fig. 1 / §5.1, :mod:`repro_torch.data.logistic`) run on
it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.configs.base import DistConfig
from repro_torch.core import algo as algo_registry
from repro_torch.core import mixing
from repro_torch.core import topology as topo
from repro_torch.core.faults import push_round
from repro_torch.core.schedule import CommSchedule, make_schedule
from repro_torch.kernels import mixing_cuda
from repro_torch.tree import pairwise_mean

PyTree = Any


@dataclass
class Decentralized:
    """The paper's technique as one object: owns the schedule and applies
    the right communication round to stacked parameters.  ``mesh`` (a
    :class:`repro_torch.core.mesh.Mesh`, optional) rides the spec into
    every round."""
    dist: DistConfig
    n_nodes: int
    schedule: CommSchedule = None  # type: ignore[assignment]
    mesh: Any = None

    def __post_init__(self):
        if self.schedule is None:
            self.schedule = make_schedule(self.dist)
        # round-invariant spec with the compressor slots cleared: a round
        # re-attaches them per call (plain pytree back unless a
        # compressor is passed)
        self._spec = self.dist.comm_spec(self.n_nodes, mesh=self.mesh) \
            .replace(compressor=None, global_compressor=None)

    @property
    def spec(self) -> mixing.CommSpec:
        """The round-invariant :class:`repro_torch.core.mixing.CommSpec`
        (compressor slots cleared)."""
        return self._spec

    def phase(self, step: int) -> str:
        """Pure phase query (``schedule.peek_phase``)."""
        if self.n_nodes == 1:
            return "none"
        return self.schedule.peek_phase(step)

    def advance(self, step: int) -> str:
        """Phase of an executed step: commits stateful schedules (AGA's
        period counter).  Call once per step, in order."""
        if self.n_nodes == 1:
            return "none"
        return self.schedule.advance(step)

    def communicate(self, params: PyTree, phase: str, step: int,
                    axis: int = 0, backend: Optional[str] = None,
                    compressor=None, ef_state: Optional[PyTree] = None,
                    seed=0, global_compressor=None) -> PyTree:
        if phase == "slowmo":
            # parameter part only; the caller handles the momentum
            phase = "global"
        spec = self._spec.replace(compressor=compressor,
                                  global_compressor=global_compressor)
        if backend is not None:
            spec = spec.replace(backend=backend)
        return mixing.communicate(params, spec, phase=phase, step=step,
                                  axis=axis, ef_state=ef_state, seed=seed)


def simulate(
    *,
    algorithm: str,
    grad_fn: Callable[[torch.Tensor, torch.Generator, int], torch.Tensor],
    loss_fn: Callable[[torch.Tensor], torch.Tensor],
    x0,                                 # (d,) common initial point
    n: int,
    steps: int,
    lr: Callable[[int], float] | float,
    topology: str = "ring",
    H: int = 16,
    seed: int = 0,
    slowmo_beta: float = 0.0,
    slowmo_lr: float = 1.0,
    aga_kwargs: Optional[dict] = None,
    eval_every: int = 10,
    backend: str = "reference",
    compression: str = "none",
    compression_k: int = 32,
    error_feedback: bool = False,
    global_compression: str = "none",
    push_sum: bool = False,
    fault_schedule=None,
    overlap: bool = False,
    telemetry=None,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Run ``algorithm`` on n simulated nodes; returns the trajectory of the
    node-average loss f(x̄^k) and the consensus distance ‖x − x̄‖²/n at the
    eval steps (``iteration``, ``loss``, ``consensus``), and ``H_history``
    for a schedule that keeps one (Gossip-AGA).

    ``grad_fn(x_stacked (n, d), generator, step) -> (n, d)`` per-node
    stochastic gradients, drawing any randomness from ``generator`` (a
    ``torch.Generator`` on ``device`` seeded with ``seed``) — where the
    reference's ``grad_fn(x, key, step)`` takes a ``jax.random`` key.
    ``loss_fn(x̄ (d,))`` -> the scalar global objective f(x̄).  ``x0`` and
    everything else live on ``device`` (``"cuda"`` unless the caller asks
    for ``"cpu"``).

    ``backend="pallas"`` routes the rounds through the fused kernel
    (:mod:`repro_torch.kernels.mixing_cuda`, ``csrc/mix.cu``): the SGD
    half-step and the mix run as one pass, and at eval iterations the same
    pass also emits x̄ and the consensus residual.  Algorithms that
    transform the gradient (GT-PGA) or carry a payload take
    ``communicate`` instead.  The fused path passes no ``n_pods``, as the
    reference's does, so its pod rounds average over all nodes (a
    reference fault kept for parity, ROADMAP C.4).

    ``compression`` selects a wire codec (repro_torch.compress);
    ``error_feedback=True`` threads per-node EF memory through the
    trajectory; ``global_compression`` (int8|fp8) runs the averaging
    phases through the compressed collective.  The step index seeds the
    stochastic rounding.  ``aga_kwargs`` go to :class:`DistConfig` (AGA's
    and Hier-PGA's fields).

    ``push_sum=True`` runs every round as a column-stochastic push-sum
    round of ``(x, w)`` (``mixing.communicate_push_sum``): each step's W
    is built on the host (the topology's, or ``fault_schedule``'s, a
    :class:`repro_torch.core.faults.FaultSchedule` that drops, rejoins
    and rewires nodes) and copied to the device without blocking; dropped
    nodes' gradients are zeroed; a lossy ``compression`` applies to the
    gossip rounds only, the weight mixed exactly; a full-participation
    global round snaps w to ones.  Evals read the de-biased average
    ``Σx/Σw`` and the consensus of ``x_i/w_i``, and the output gains the
    per-step ``mass`` (``Σw``, kept on the device until the end) and the
    final ``push_weight``.

    ``overlap=True`` runs the one-step-stale pipelined rounds: each gossip
    step applies the previous step's buffered half-step iterate as the
    compensated correction, ``x_{k+1} = y_k + (W − I)·y_{k−1}`` with
    ``y_k = x_k − γ g_k`` and the warm-up buffer ``y_{−1} = x_0``
    (``mixing.finish_round`` / ``start_round``).  The matrix applied at
    step k is that of the buffer's priming step (the warm-up round reuses
    step 0's shift).  Global, pod and SlowMo steps run synchronously and
    re-prime the buffer; ``"none"`` steps leave it in flight.  Composes
    with ``compression``/``error_feedback`` (the EF memory advances
    against the payload buffered), not with ``push_sum``.

    ``telemetry`` (a :class:`repro_torch.obs.Telemetry`) is installed as
    the ambient hub for the run: eval points emit ``step`` records, fault
    events ``fault`` records, and the mixing meters ``comm_round``
    records, once per step variant (the reference's jitted step
    functions meter once, at their trace; its eager captures every call).
    Equivalently, call inside an enclosing ``obs.telemetry_scope``.
    """
    if fault_schedule is not None:
        if not push_sum:
            raise ValueError("simulate: fault_schedule requires "
                             "push_sum=True (DESIGN.md §2.5)")
        if fault_schedule.n_nodes != n:
            raise ValueError(f"simulate: fault_schedule built for "
                             f"{fault_schedule.n_nodes} nodes, got n={n}")
    if telemetry is not None:
        with obs.telemetry_scope(telemetry):
            return simulate(
                algorithm=algorithm, grad_fn=grad_fn, loss_fn=loss_fn,
                x0=x0, n=n, steps=steps, lr=lr, topology=topology, H=H,
                seed=seed, slowmo_beta=slowmo_beta, slowmo_lr=slowmo_lr,
                aga_kwargs=aga_kwargs, eval_every=eval_every,
                backend=backend, compression=compression,
                compression_k=compression_k,
                error_feedback=error_feedback,
                global_compression=global_compression,
                push_sum=push_sum, fault_schedule=fault_schedule,
                overlap=overlap, telemetry=None, device=device)
    dev = resolve_device(device)
    dist = DistConfig(algorithm=algorithm, topology=topology, H=H,
                      comm_backend=backend, comm_compression=compression,
                      comm_compression_k=compression_k,
                      comm_error_feedback=error_feedback,
                      comm_global_compression=global_compression,
                      push_sum=push_sum, comm_overlap=overlap,
                      **(aga_kwargs or {})).validate()
    dist.validate_nodes(n)
    if algorithm == "slowmo":
        dist = dataclasses.replace(dist, slowmo_beta=slowmo_beta,
                                   slowmo_lr=slowmo_lr)
    algo = Decentralized(dist, n)
    algo_impl = algo_registry.get_algorithm(algorithm, caller="simulate")
    has_payload = bool(algo_impl.payload_names())
    lr_fn = lr if callable(lr) else (lambda k: lr)
    from repro_torch.compress import make_compressor
    compressor = make_compressor(compression, k=compression_k)
    lossy = compressor is not None and compressor.lossy
    global_comp = make_compressor(global_compression)
    glossy = global_comp is not None and global_comp.lossy
    ov_spec = (algo.spec.replace(compressor=compressor,
                                 global_compressor=global_comp)
               if overlap else None)
    # the fused half-step + mix kernel consumes raw grads and only the
    # bare params ride it: algorithms that transform the update (GT) or
    # attach a payload take the generic communicate path
    fused_ok = (backend == "pallas" and not has_payload
                and not algo_impl.transforms_grads)
    x0 = torch.as_tensor(x0, device=dev).to(torch.float32)
    x = x0[None].expand((n,) + tuple(x0.shape)).contiguous()
    extras = algo_registry.init_extras(dist, x, n)
    generator = torch.Generator(device=dev).manual_seed(seed)

    def _ctx(gamma):
        return algo_registry.StepContext(dist=dist, n_nodes=n, lr=gamma)

    def half_step(x, extras, k, gamma):
        g = grad_fn(x, generator, k)
        upd, extras = algo_impl.pre_update(dict(extras), g)
        return x - gamma * upd, dict(extras)

    def _joint(extras, y):
        return algo_registry.join_payload(algo_impl.comm_payload(extras, y),
                                          y)

    def sync_step(x, extras, k, gamma, phase, shift_step, use_lossy):
        """pre_update -> half-step -> joint communicate (compressed when
        the phase's codec is lossy) -> post_round."""
        y, extras = half_step(x, extras, k, gamma)
        joint = _joint(extras, y)
        if use_lossy:
            mixed, new_ef = algo.communicate(
                joint, phase, shift_step, compressor=compressor,
                ef_state=extras.get("ef_state"), seed=k,
                global_compressor=global_comp)
            if new_ef is not None:
                extras["ef_state"] = new_ef
        else:
            mixed = algo.communicate(joint, phase, shift_step)
        return algo_impl.post_round(
            extras, algo_registry.wrap_mixed(mixed, has_payload), phase,
            _ctx(gamma))

    def ov_step(x, extras, buf, k, gamma, phase, shift_step, buf_shift):
        """One pipelined step: the half-step iterate takes the buffered
        round (its priming shift), then re-primes the buffer from itself;
        averaging phases flush synchronously; ``"none"`` leaves the buffer
        in flight."""
        y, extras = half_step(x, extras, k, gamma)
        if phase == "none":
            return y, buf, extras
        joint = _joint(extras, y)
        ef = extras.get("ef_state")
        if phase == "gossip":
            mixed = mixing.finish_round(joint, buf, ov_spec, step=buf_shift)
            buf2, ef2 = mixing.start_round(joint, ov_spec, ef_state=ef,
                                           seed=k)
        else:
            mixed, buf2, ef2 = mixing.overlap_flush(
                joint, ov_spec, phase=phase, step=shift_step, ef_state=ef,
                seed=k)
        if ef2 is not None:
            extras["ef_state"] = ef2
        new_x, extras = algo_impl.post_round(
            extras, algo_registry.wrap_mixed(mixed, has_payload), phase,
            _ctx(gamma))
        return new_x, buf2, extras

    def push_step(x, extras, k, gamma, phase, W, live):
        """Push-sum round: dropped nodes' grads zeroed, half-step, the
        joint round against the runtime W, w's snap after a
        full-participation averaging round."""
        g = grad_fn(x, generator, k)
        if not live.all():
            g = g * mixing.upload(live, g.device)[:, None]
        upd, extras = algo_impl.pre_update(dict(extras), g)
        extras = dict(extras)
        y = x - gamma * upd
        joint = _joint(extras, y)
        w = extras["push_weight"]
        if lossy and phase == "gossip":
            mixed, w2, new_ef = mixing.communicate_push_sum(
                joint, w, W=W, n_nodes=n, backend=backend,
                compressor=compressor, ef_state=extras.get("ef_state"),
                seed=k)
            if new_ef is not None:
                extras["ef_state"] = new_ef
        else:
            mixed, w2 = mixing.communicate_push_sum(joint, w, W=W,
                                                    n_nodes=n,
                                                    backend=backend)
        if phase in ("global", "pod_avg") and live.all():
            # w_i = Σw/n = 1 in exact arithmetic: snap to it
            w2 = torch.ones_like(w2)
        extras["push_weight"] = w2
        return algo_impl.post_round(
            extras, algo_registry.wrap_mixed(mixed, has_payload), phase,
            _ctx(gamma))

    tel = obs.get_telemetry()
    metered = set()

    def once(key):
        """The ambient hub for a step variant's first call, none after."""
        if key in metered:
            return obs.telemetry_scope(None)
        metered.add(key)
        return contextlib.nullcontext()

    losses, consensus, its = [], [], []
    # Σw of every push-sum step, kept on the device until the end
    mass = (torch.empty(steps, dtype=torch.float32, device=dev)
            if push_sum else None)
    period = topo.schedule_period(topology, n)
    buf = buf_shift = None
    with torch.no_grad():
        if overlap:
            # warm-up buffer b = x_0; the warm-up round reuses step 0's
            # shift
            buf, ef0 = mixing.start_round(
                _joint(extras, x), ov_spec,
                ef_state=extras.get("ef_state"), seed=0)
            if ef0 is not None:
                extras["ef_state"] = ef0
            buf_shift = algo.schedule.gossip_shift_step(0, period)
        for k in range(steps):
            gamma = float(lr_fn(k))
            phase = algo.advance(k)   # executed step: commit schedule state
            shift_step = algo.schedule.gossip_shift_step(k, period)
            is_eval = k % eval_every == 0 or k == steps - 1
            xbar = resid = None
            lossy_round = ((lossy and phase in ("gossip", "global",
                                                "pod_avg"))
                           or (glossy and phase in ("global", "pod_avg")))
            if push_sum:
                W, live = push_round(topology, n, phase, k, shift_step,
                                     fault_schedule)
                if tel is not None and fault_schedule is not None:
                    for kind, events in (("drop", fault_schedule.drops),
                                         ("rejoin", fault_schedule.rejoins)):
                        if k in events:
                            tel.emit("fault", step=k, kind=kind,
                                     nodes=list(events[k]))
                with once(("push", phase, lossy and phase == "gossip",
                           phase in ("global", "pod_avg"))):
                    x, extras = push_step(x, extras, k, gamma, phase, W,
                                          live)
                w = extras["push_weight"]
                mass[k] = torch.sum(w)
                if is_eval:
                    xbar = torch.sum(x, dim=0) / torch.sum(w)   # Σx/Σw
                    f = float(loss_fn(xbar))
                    algo.schedule.observe_loss(k, f)
                    losses.append(f)
                    consensus.append(float(torch.mean(torch.sum(
                        (x / w - xbar) ** 2, -1))))
                    its.append(k)
                    if tel is not None:
                        tel.emit("step", step=k, phase=phase, loss=f,
                                 consensus=consensus[-1],
                                 mass=float(mass[k]))
                elif losses:
                    algo.schedule.observe_loss(k, losses[-1])
                continue
            if phase in algo_impl.owned_phases:
                # owned phase (SlowMo's outer step): no round; post_round
                # consumes the half-step iterate
                y, extras = half_step(x, extras, k, gamma)
                x, extras = algo_impl.post_round(extras, {"params": y},
                                                 phase, _ctx(gamma))
                if overlap:   # the outer step is a synchronous flush
                    buf, ef2 = mixing.start_round(
                        _joint(extras, x), ov_spec,
                        ef_state=extras.get("ef_state"), seed=k)
                    if ef2 is not None:
                        extras["ef_state"] = ef2
                    buf_shift = shift_step
            elif overlap:
                with once(("overlap", phase, shift_step, buf_shift)):
                    x, buf, extras = ov_step(x, extras, buf, k, gamma,
                                             phase, shift_step, buf_shift)
                if phase != "none":   # "none" leaves the buffer in flight
                    buf_shift = shift_step
            elif lossy_round:
                with once(("sync", phase, shift_step, True)):
                    x, extras = sync_step(x, extras, k, gamma, phase,
                                          shift_step, use_lossy=True)
            elif fused_ok and phase in mixing_cuda.KERNEL_PHASES:
                g = grad_fn(x, generator, k)
                out = mixing_cuda.fused_step_mix(
                    x, g, gamma, phase=phase, topology=topology, n_nodes=n,
                    step=shift_step, with_residual=is_eval)
                # fused: mix + x̄ + consensus in one parameter pass
                x, xbar, resid = out if is_eval else (out, None, None)
            else:
                with once(("sync", phase, shift_step, False)):
                    x, extras = sync_step(x, extras, k, gamma, phase,
                                          shift_step, use_lossy=False)
            if is_eval:
                if xbar is None:
                    # pairwise, as the fused kernel takes x̄: exact on
                    # equal rows for n a power of two
                    xbar = pairwise_mean(x)[0]
                f = float(loss_fn(xbar))
                algo.schedule.observe_loss(k, f)
                losses.append(f)
                consensus.append(
                    float(resid) / n if resid is not None
                    else float(torch.mean(torch.sum((x - xbar) ** 2, -1))))
                its.append(k)
                if tel is not None:
                    tel.emit("step", step=k, phase=phase, loss=f,
                             consensus=consensus[-1])
            elif losses:
                # AGA still needs a loss signal between evals: reuse the last
                algo.schedule.observe_loss(k, losses[-1])

    out = {
        "iteration": np.array(its),
        "loss": np.array(losses),
        "consensus": np.array(consensus),
    }
    if push_sum:
        out["mass"] = mass.cpu().numpy()
        out["push_weight"] = extras["push_weight"].cpu().numpy()
    if hasattr(algo.schedule, "history"):
        out["H_history"] = np.array(getattr(algo.schedule, "history"))
    return out
