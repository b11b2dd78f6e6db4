"""Host training loop: schedule-driven phase dispatch, metrics,
telemetry and checkpoints (counterpart of ``repro/train/trainer.py``).

n simulated nodes live on one device as a stacked leading axis; with a
``mesh`` (:func:`repro_torch.core.mesh.make_mesh`) whose node axis has
several shards, the fused backend runs the rounds shard by shard through
the per-shard kernels, every shard on that one device.  On a rank mesh
(``make_mesh(..., group=...)``, one ``torch.distributed`` rank per node
shard) each rank's Trainer holds only its m = n/k nodes: the initial
state stacks the replica m times, step k's batch is rows ``r·m … r·m + m
− 1`` of the stream's, every rank keeps its own ring of records and only
rank 0 prints the step line.  On a 2-D ``(node, model)`` mesh the rounds
also slice the columns over the model axis (``core/mixing.py``); a rank
mesh then has k·k_model ranks, the k_model ranks of node shard r holding
its m rows whole.  SlowMo runs on every mesh: its slots are whole and
bitwise equal on every rank (the anchor node 0's row, sent by the rank
that holds it; x̄ over all n nodes, ``core.algo.node_mean``).

Each step runs inside the ``train/step`` span (fenced on the loss when
the hub's tracer fences) and keeps its metrics on the device in a pending
window; a log boundary brings the window's losses, the last step's
metrics and lr back in one counted transfer (``Telemetry.fetch``) and
emits the ``step`` record — the ring behind ``history``, the JSONL
stream, the printed line ``[algo] step N loss=… phase=… consensus=…``.
``run()`` installs the hub as the ambient one for a step variant's first
call, so the mixing layer's meters emit one ``comm_round`` record per
round of each variant, as the reference's traced meters do (ROADMAP
C.3).  Each step's loss goes to ``schedule.observe_loss`` as a device
scalar (Gossip-AGA reads it at its period boundaries).

With ``DistConfig.push_sum`` each step gets its round's W and live mask,
built on the host (:func:`repro_torch.core.faults.push_round`), from a
:class:`repro_torch.core.faults.FaultSchedule` when one is given (its
drops and rejoins emit ``fault`` records).  With
``DistConfig.comm_overlap`` the trainer keeps the in-flight round's
buffer and the shift it was primed with, primed at the first ``run()``
from the current params and kept across ``run()`` calls; every period
boundary emits a ``flush`` record.

Checkpoints: with ``TrainConfig.ckpt_every`` the state is saved after
every ``ckpt_every``-th step (``checkpoint.save_checkpoint``, with the
``schedule_*.json`` and ``faults_*.json`` sidecars and a ``ckpt``
record).  The file is the same on every mesh.  On a rank mesh every rank
calls the collective save: global rank 0 writes the sidecars, then the
npz from every node shard's rows, and emits the ``ckpt`` record (rank 0
only, as the step line); every rank returns after the save's barrier, so
no rank reads a file before it is whole.  The ranks must share the
checkpoint directory's file system (the reference's single controller
takes the same for granted).  A fresh Trainer given a restored state
(``step > 0``; ``checkpoint.restore_checkpoint(dir, template,
mesh=mesh)`` on a rank mesh) reloads both sidecars at its first
``run()``, on every rank; the overlap buffer is re-primed from the
restored params, a rank's from its own rows (the stale buffer is not
checkpointed: resume is a flush).
"""
from __future__ import annotations

import contextlib
import json
import os
import time
import warnings
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.configs.base import TrainConfig
from repro_torch.core import algo as algo_lib
from repro_torch.core import mixing
from repro_torch.core import topology as topo
from repro_torch.core.faults import push_round
from repro_torch.core.schedule import make_schedule
from repro_torch.data import make_stream
from repro_torch.models.model import make_model
from repro_torch.optim import make_optimizer
from repro_torch.optim import make_schedule as make_lr
from repro_torch.train.state import TrainState, stack_for_nodes
from repro_torch.train.step import build_train_step, check_microbatches
from repro_torch.tree import tree_map

PyTree = Any


class Trainer:
    """``Trainer(tcfg, n_nodes, mesh=None, device="cuda")``: runs on the
    card unless ``device="cpu"`` is passed (no card → the default raises);
    a ``mesh`` must sit on that device.  ``fault_schedule`` (a
    :class:`repro_torch.core.faults.FaultSchedule` for ``n_nodes``)
    drops, rejoins and rewires nodes; it requires push-sum.

    ``telemetry``: the hub the run reports to.  By default a
    :class:`repro_torch.obs.RingSink` (``history``) and a
    :class:`repro_torch.obs.PrettySink` (the step line); a given hub
    without a ring gets one.  ``measure_occupancy`` (overlapped runs):
    the one-shot occupancy calibration at the first log boundary after a
    run's first step, on clones of the state and the buffer (the run ends
    bitwise where it would without it); None turns it on when a
    :class:`repro_torch.obs.JsonlSink` is attached."""

    def __init__(self, tcfg: TrainConfig, n_nodes: int, *, mesh=None,
                 with_consensus: bool = False, fault_schedule=None,
                 telemetry: Optional[obs.Telemetry] = None,
                 measure_occupancy: Optional[bool] = None, device="cuda"):
        self.device = resolve_device(device)
        if mesh is not None and mesh.device.type != self.device.type:
            raise ValueError(f"Trainer: the mesh sits on {mesh.device}, the "
                             f"trainer on {self.device}")
        self.mesh = mesh
        tcfg.validate()
        tcfg.dist.validate_nodes(n_nodes)
        # the node rows this process holds: all n, or one rank's shard
        ranked = mesh is not None and mesh.distributed
        if ranked and n_nodes % mesh.node_count:
            raise ValueError(f"Trainer: {n_nodes} nodes do not split over "
                             f"the {mesh.node_count} node shards of the "
                             f"mesh")
        self.rows = n_nodes // mesh.node_count if ranked else n_nodes
        self.row0 = mesh.node_rank * self.rows if ranked else 0
        if fault_schedule is not None:
            if not tcfg.dist.push_sum:
                raise ValueError(
                    "Trainer: fault injection requires DistConfig."
                    "push_sum=True — only the push-sum weight scalar keeps "
                    "the average unbiased when nodes drop (DESIGN.md §2.5)")
            if fault_schedule.n_nodes != n_nodes:
                raise ValueError(
                    f"Trainer: fault_schedule built for "
                    f"{fault_schedule.n_nodes} nodes, trainer has {n_nodes}")
        self.fault_schedule = fault_schedule
        self.tcfg = tcfg
        self.n_nodes = n_nodes
        self.model = make_model(tcfg.model)
        self.lr_fn = make_lr(tcfg.optimizer)
        self.schedule = make_schedule(tcfg.dist)
        self.period = topo.schedule_period(tcfg.dist.topology, n_nodes)
        self.with_consensus = with_consensus
        self.stream = make_stream(tcfg.model, tcfg.data, n_nodes=n_nodes,
                                  global_batch=tcfg.global_batch,
                                  seq_len=tcfg.seq_len)
        check_microbatches(self.stream.per_node_batch, tcfg.microbatches)
        self._steps: Dict[Any, Any] = {}
        self._metered: set = set()   # step variants that have reported
        # overlap: the in-flight round's buffer and the shift it was
        # primed with, host-side trajectory state primed at the first run()
        self._overlap = tcfg.dist.comm_overlap
        self._comm_buf = None
        self._buf_shift = 0
        if telemetry is None:
            # one printed step line per run: rank 0's on a rank mesh
            telemetry = obs.Telemetry(
                sinks=[obs.RingSink()] + ([obs.PrettySink()]
                                          if not ranked or mesh.rank == 0
                                          else []))
        elif telemetry.ring() is None:
            telemetry.sinks.append(obs.RingSink())
        telemetry.tags.setdefault("algorithm", tcfg.dist.algorithm)
        self.telemetry = telemetry
        # the device-side window: per-step (k, phase, lr, metrics) until
        # the log boundary's one fetch
        self._pending: deque = deque(maxlen=1024)
        self._phase_counts: Dict[str, int] = {}
        self.measure_occupancy = measure_occupancy
        self._occ_measured = False
        self._sched_live = False   # True once this trainer advanced the
        self._faults_live = False  # schedule / fault counters

    @property
    def history(self) -> List[Dict[str, Any]]:
        """The log boundaries' ``step`` records, a view over the hub's
        ring (``step``, ``phase``, ``lr``, ``time``, the metrics,
        ``loss_window_mean``, ``window``, ``phase_counts``)."""
        ring = self.telemetry.ring()
        return ring.records("step") if ring is not None else []

    # ------------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None,
                   params: Optional[PyTree] = None) -> TrainState:
        """Stacked initial state from ``Model.init`` drawn with
        ``generator`` (a seeded CPU generator by default), or from a given
        single-replica ``params`` tree (e.g. carried across with
        ``repro_torch.interop``); this process's node rows of it."""
        if params is None:
            if generator is None:
                generator = torch.Generator().manual_seed(self.tcfg.seed)
            params = self.model.init(generator, self.device)
        params = stack_for_nodes(params, self.rows)
        opt_state = make_optimizer(self.tcfg.optimizer,
                                   per_node=True).init(params)
        extras = algo_lib.init_extras(self.tcfg.dist, params, self.rows,
                                      mesh=self.mesh)
        return TrainState(params=params, opt_state=opt_state, step=0,
                          extras=extras)

    def _get_step_fn(self, phase: str, shift: int, buf_shift: int = 0):
        key = (phase, shift, buf_shift)
        if key not in self._steps:
            hops = (self.fault_schedule.hop_superset(self.tcfg.dist.topology)
                    if self.fault_schedule is not None else None)
            self._steps[key] = build_train_step(
                self.model, self.tcfg, self.n_nodes, phase=phase,
                shift_step=shift, buf_shift=buf_shift,
                with_consensus=self.with_consensus, mesh=self.mesh,
                fault_hops=hops)
        return self._steps[key]

    def _prime(self, state: TrainState) -> TrainState:
        """Prime the overlap buffer from ``state``'s params (the warm-up
        round then mixes x_0 with itself); returns ``state`` with the EF
        memory the capture advanced."""
        dist = self.tcfg.dist
        spec = dist.comm_spec(self.n_nodes, mesh=self.mesh)
        impl = algo_lib.get_algorithm(dist.algorithm, caller="Trainer")
        joint = algo_lib.join_payload(
            impl.comm_payload(state.extras, state.params), state.params)
        ef_name = algo_lib.EF_SLOT.name
        self._comm_buf, ef = mixing.start_round(
            joint, spec, ef_state=state.extras.get(ef_name),
            seed=state.step)
        self._buf_shift = self.schedule.gossip_shift_step(state.step,
                                                          self.period)
        if ef is state.extras.get(ef_name):
            return state
        return TrainState(params=state.params, opt_state=state.opt_state,
                          step=state.step, extras={**state.extras,
                                                   ef_name: ef})

    def device_batch(self, k: int) -> Dict[str, torch.Tensor]:
        """Step k's batch on the device (pinned, asynchronous copy): this
        process's node rows of the stream's ``(n, B, …)`` batch."""
        out = {}
        for name, arr in self.stream.get_batch(k).items():
            rows = arr[self.row0:self.row0 + self.rows]
            t = torch.from_numpy(np.ascontiguousarray(rows))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[name] = t
        return out

    # ------------------------------------------------------------------
    def _variant_scope(self, key):
        """The hub a step variant's rounds report to: the ambient one on
        the variant's first call, none after (the reference meters each
        compiled variant once, at its trace)."""
        if key in self._metered:
            return obs.telemetry_scope(None)
        self._metered.add(key)
        return contextlib.nullcontext()

    def _push_round(self, phase: str, k: int, shift: int):
        """Host-side (W, active) of the push-sum step at absolute step
        ``k``; the fault schedule's drops and rejoins at ``k`` emit
        ``fault`` records."""
        W, active = push_round(self.tcfg.dist.topology, self.n_nodes, phase,
                               k, shift, self.fault_schedule)
        fs = self.fault_schedule
        if fs is not None:
            if k in fs.drops:
                self.telemetry.emit("fault", step=k, kind="drop",
                                    nodes=list(fs.drops[k]))
            if k in fs.rejoins:
                self.telemetry.emit("fault", step=k, kind="rejoin",
                                    nodes=list(fs.rejoins[k]))
        return W, active

    # ------------------------------------------------------------------
    def run(self, state: TrainState, steps: Optional[int] = None,
            log_every: Optional[int] = None) -> TrainState:
        # the hub is the ambient one for the loop: the mixing-round meters
        # report to it without plumbing
        with obs.telemetry_scope(self.telemetry):
            return self._run(state, steps, log_every)

    def _run(self, state: TrainState, steps: Optional[int],
             log_every: Optional[int]) -> TrainState:
        tcfg = self.tcfg
        steps = steps if steps is not None else tcfg.steps
        log_every = log_every if log_every is not None else tcfg.log_every
        t0 = time.time()
        start = state.step
        # resume: a stateful schedule (AGA's period counter) and the fault
        # counters are trajectory state; a fresh trainer given a restored
        # state reloads the sidecars written next to its checkpoint
        if start > 0 and not self._sched_live:
            self.load_schedule(step=start)
        self._sched_live = True
        if start > 0 and not self._faults_live \
                and self.fault_schedule is not None:
            self.load_faults(step=start)
        self._faults_live = True
        if self._overlap and self.n_nodes > 1 and self._comm_buf is None:
            # the warm-up round mixes x_start with itself; on resume this
            # is the flush semantics (the stale buffer is not saved)
            state = self._prime(state)
        for k in range(start, start + steps):
            batch = self.device_batch(k)
            # advance() commits stateful schedules (AGA's period counter)
            phase = (self.schedule.advance(k) if self.n_nodes > 1
                     else "none")
            shift = self.schedule.gossip_shift_step(k, self.period)
            lr = self.lr_fn(k)
            bs = self._buf_shift if self._overlap and phase == "gossip" \
                else 0
            step_fn = self._get_step_fn(phase, shift, buf_shift=bs)
            with self.telemetry.span("train/step", step=k,
                                     phase=phase) as sp, \
                    self._variant_scope((phase, shift, bs)):
                if self._overlap:
                    state, metrics, self._comm_buf = step_fn(
                        state, batch, lr, self._comm_buf)
                    if phase != "none":
                        # the buffer now in flight was primed at this step
                        self._buf_shift = shift
                elif tcfg.dist.push_sum:
                    W, active = self._push_round(phase, k, shift)
                    state, metrics = step_fn(state, batch, lr, W, active)
                else:
                    state, metrics = step_fn(state, batch, lr)
                # --trace-fence: the span ends when the device is done
                sp.fence(metrics["loss"])
            # the schedule holds the device scalar and reads it only at a
            # period boundary (schedule._as_float): no per-step host read
            self.schedule.observe_loss(k, metrics["loss"])
            self._phase_counts[phase] = self._phase_counts.get(phase, 0) + 1
            self._pending.append((k, phase, lr, metrics))
            if self._overlap and phase not in ("gossip", "none"):
                # period boundary: the step flushed the in-flight round
                self.telemetry.emit("flush", step=k, phase=phase)
            if log_every and (k % log_every == 0 or k == steps - 1):
                self._log_boundary(k, phase, t0)
                mo = self.measure_occupancy
                if mo is None:
                    mo = any(isinstance(sk, obs.JsonlSink)
                             for sk in self.telemetry.sinks)
                if (mo and self._overlap and self.n_nodes > 1
                        and not self._occ_measured and k > start):
                    self._occ_measured = True
                    self._measure_occupancy(state, k)
            if tcfg.ckpt_every and (k + 1) % tcfg.ckpt_every == 0:
                self._checkpoint(state, k + 1)
        return state

    def _checkpoint(self, state: TrainState, step: int) -> None:
        """Save ``state`` after ``step`` steps with its sidecars; on a rank
        mesh collectively, global rank 0 the writer (module docstring)."""
        from repro_torch.checkpoint import save_checkpoint
        mesh = self.mesh
        ranked = mesh is not None and mesh.distributed
        writer = not ranked or mesh.rank == 0
        if writer:
            os.makedirs(self.tcfg.ckpt_dir, exist_ok=True)
            self._save_schedule(step)
            self._save_faults(step)
        save_checkpoint(self.tcfg.ckpt_dir, state, step,
                        mesh=mesh if ranked else None)
        if writer:
            self.telemetry.emit("ckpt", step=step, path=self.tcfg.ckpt_dir)

    def _log_boundary(self, k: int, phase: str, t0: float) -> None:
        """Bring the pending window back in ONE counted transfer
        (``Telemetry.fetch``) and emit the ``step`` record."""
        window = list(self._pending)
        self._pending.clear()
        if not window:
            return
        _, _, lr, metrics = window[-1]
        host = self.telemetry.fetch({
            "lr": lr, "metrics": metrics,
            "window_loss": [w[3]["loss"] for w in window]})
        rec = {"step": k, "phase": phase, "lr": float(host["lr"]),
               "time": time.time() - t0}
        rec.update({m: float(v) for m, v in host["metrics"].items()})
        wl = [float(x) for x in host["window_loss"]]
        rec["loss_window_mean"] = sum(wl) / len(wl)
        rec["window"] = len(wl)
        # executed rounds by phase: joins the comm_round records (one per
        # step variant) back to the steps run
        rec["phase_counts"] = dict(self._phase_counts)
        self.telemetry.emit("step", **rec)

    # ------------------------------------------------------------------
    def _measure_occupancy(self, state: TrainState, k: int) -> None:
        """One-shot occupancy calibration of an overlapped run: the
        overlapped step, the round-free step and a synchronous issue +
        apply, each timed by ``obs.fenced_time``, give

            occupancy = clip(1 - max(0, t_overlap - t_compute) / t_sync,
                             0, 1)

        in a ``comm_round`` record of role ``"occupancy"``.  It runs on
        clones of the state and the buffer, with fresh step functions
        and the hub scoped out, so the run goes on bitwise as without it.
        A failure warns: the calibration is telemetry."""
        try:
            self._measure_occupancy_impl(state, k)
        except Exception as e:
            warnings.warn(f"Trainer: occupancy calibration failed ({e}); "
                          f"continuing without an occupancy record")

    def _measure_occupancy_impl(self, state: TrainState, k: int) -> None:
        tcfg = self.tcfg
        spec = tcfg.dist.comm_spec(self.n_nodes, mesh=self.mesh)
        shift = self.schedule.gossip_shift_step(k, self.period)
        batch = self.device_batch(k)
        lr = self.lr_fn(k)

        def build(phase):
            return build_train_step(self.model, tcfg, self.n_nodes,
                                    phase=phase, shift_step=shift,
                                    buf_shift=shift,
                                    with_consensus=self.with_consensus,
                                    mesh=self.mesh)

        def clone(tree):
            return tree_map(lambda t: t.clone() if torch.is_tensor(t)
                            else t, tree)

        st = TrainState(params=clone(state.params),
                        opt_state=clone(state.opt_state), step=state.step,
                        extras=clone(state.extras))
        buf = clone(self._comm_buf)
        ef = st.extras.get(algo_lib.EF_SLOT.name)
        step_ov, step_cmp = build("gossip"), build("none")
        with obs.telemetry_scope(None):
            t_ov = obs.fenced_time(step_ov, st, batch, lr, buf, iters=3,
                                   warmup=1)
            t_cmp = obs.fenced_time(step_cmp, st, batch, lr, buf, iters=3,
                                    warmup=1)
            t_issue = obs.fenced_time(mixing.start_round, st.params, spec,
                                      iters=3, warmup=1, ef_state=ef, seed=k)
            rs, _ = mixing.start_round(st.params, spec, ef_state=ef, seed=k)
            t_apply = obs.fenced_time(mixing.finish_round, st.params, rs,
                                      spec, iters=3, warmup=1, step=shift)
        del st, buf, rs
        t_sync = t_issue + t_apply
        occ = obs.meters.occupancy(t_cmp * 1e-6, t_sync * 1e-6, t_ov * 1e-6)
        self.telemetry.emit(
            "comm_round", phase="gossip", role="occupancy",
            occupancy=occ, t_step_overlap_us=t_ov,
            t_step_compute_us=t_cmp, t_round_sync_us=t_sync,
            topology=tcfg.dist.topology, backend=tcfg.dist.comm_backend,
            n_nodes=self.n_nodes, step=k)

    # ------------------------------------------------------------------
    def _schedule_path(self, step: int) -> str:
        return os.path.join(self.tcfg.ckpt_dir, f"schedule_{step:08d}.json")

    def _save_schedule(self, step: int) -> None:
        """Sidecar of a stateful schedule (AGA's period counter and H
        adaptation); stateless schedules write nothing."""
        sd = self.schedule.state_dict()
        if not sd:
            return
        with open(self._schedule_path(step), "w") as f:
            json.dump(sd, f)

    def load_schedule(self, step: Optional[int] = None) -> None:
        """Restore the schedule's state saved beside the checkpoint at
        ``step`` (default: the latest); a missing sidecar is a no-op."""
        from repro_torch.checkpoint import latest_step
        step = step if step is not None else latest_step(self.tcfg.ckpt_dir)
        if step is None:
            return
        path = self._schedule_path(step)
        if os.path.exists(path):
            with open(path) as f:
                self.schedule.load_state_dict(json.load(f))

    def _faults_path(self, step: int) -> str:
        return os.path.join(self.tcfg.ckpt_dir, f"faults_{step:08d}.json")

    def _save_faults(self, step: int) -> None:
        """Sidecar of the fault schedule's counters (the schedule itself
        is a pure function of the step)."""
        if self.fault_schedule is None:
            return
        with open(self._faults_path(step), "w") as f:
            json.dump(self.fault_schedule.state_dict(), f)

    def load_faults(self, step: Optional[int] = None) -> None:
        """Restore the fault counters saved beside the checkpoint at
        ``step`` (default: the latest); a missing sidecar is a no-op."""
        if self.fault_schedule is None:
            return
        from repro_torch.checkpoint import latest_step
        step = step if step is not None else latest_step(self.tcfg.ckpt_dir)
        if step is None:
            return
        path = self._faults_path(step)
        if os.path.exists(path):
            with open(path) as f:
                self.fault_schedule.load_state_dict(json.load(f))


def quick_train(tcfg: TrainConfig, n_nodes: int, steps: int, *,
                seed: int = 0, with_consensus: bool = False,
                device=None) -> Trainer:
    """Build, init, run: returns the Trainer (with ``.history``).  On the
    card unless ``device="cpu"``.  ``seed`` seeds the CPU
    ``torch.Generator`` of :meth:`Trainer.init_state`; the port's init
    draws other values than ``jax.random`` from the same seed, so the run
    is not the reference ``quick_train``'s."""
    tr = Trainer(tcfg, n_nodes, with_consensus=with_consensus,
                 device="cuda" if device is None else device)
    state = tr.init_state(torch.Generator().manual_seed(seed))
    tr.run(state, steps)
    return tr
