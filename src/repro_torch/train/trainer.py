"""Host training loop: schedule-driven phase dispatch and metrics
(counterpart of ``repro/train/trainer.py``).

n simulated nodes live on one device as a stacked leading axis; with a
``mesh`` (:func:`repro_torch.core.mesh.make_mesh`) whose node axis has
several shards, the fused backend runs the rounds shard by shard through
the per-shard kernels, every shard on that one device.  The loop
keeps metrics on the device and reads them back in one transfer per log
boundary, where it records them in ``history`` and prints the reference's line
``[algo] step N loss=… phase=… consensus=…``.  Each step's loss goes to
``schedule.observe_loss`` as a device scalar (Gossip-AGA reads it at its
period boundaries; ``schedule.history`` keeps the periods it set).  With
``DistConfig.push_sum`` each step gets its round's W and live mask, built
on the host (:func:`repro_torch.core.faults.push_round`), from a
:class:`repro_torch.core.faults.FaultSchedule` when one is given.
Telemetry sinks (the ``fault`` events among them) and checkpoints (the
fault counters' sidecar among them) are not ported yet (ROADMAP A.6,
A.7).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import TrainConfig
from repro_torch.core import algo as algo_lib
from repro_torch.core import topology as topo
from repro_torch.core.faults import push_round
from repro_torch.core.schedule import make_schedule
from repro_torch.data import make_stream
from repro_torch.models.model import make_model
from repro_torch.optim import make_optimizer
from repro_torch.optim import make_schedule as make_lr
from repro_torch.train.state import TrainState, stack_for_nodes
from repro_torch.train.step import build_train_step

PyTree = Any


class Trainer:
    """``Trainer(tcfg, n_nodes, mesh=None, device="cuda")``: runs on the
    card unless ``device="cpu"`` is passed (no card → the default raises);
    a ``mesh`` must sit on that device.  ``fault_schedule`` (a
    :class:`repro_torch.core.faults.FaultSchedule` for ``n_nodes``)
    drops, rejoins and rewires nodes; it requires push-sum."""

    def __init__(self, tcfg: TrainConfig, n_nodes: int, *, mesh=None,
                 with_consensus: bool = False, fault_schedule=None,
                 device="cuda"):
        self.device = resolve_device(device)
        if mesh is not None and mesh.device.type != self.device.type:
            raise ValueError(f"Trainer: the mesh sits on {mesh.device}, the "
                             f"trainer on {self.device}")
        self.mesh = mesh
        tcfg.validate()
        tcfg.dist.validate_nodes(n_nodes)
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
        self._steps: Dict[Any, Any] = {}
        self.history: List[Dict[str, Any]] = []

    # ------------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None,
                   params: Optional[PyTree] = None) -> TrainState:
        """Stacked initial state from ``Model.init`` drawn with
        ``generator`` (a seeded CPU generator by default), or from a given
        single-replica ``params`` tree (e.g. carried across with
        ``repro_torch.interop``)."""
        if params is None:
            if generator is None:
                generator = torch.Generator().manual_seed(self.tcfg.seed)
            params = self.model.init(generator, self.device)
        params = stack_for_nodes(params, self.n_nodes)
        opt_state = make_optimizer(self.tcfg.optimizer).init(params)
        extras = algo_lib.init_extras(self.tcfg.dist, params, self.n_nodes)
        return TrainState(params=params, opt_state=opt_state, step=0,
                          extras=extras)

    def _get_step_fn(self, phase: str, shift: int):
        key = (phase, shift)
        if key not in self._steps:
            hops = (self.fault_schedule.hop_superset(self.tcfg.dist.topology)
                    if self.fault_schedule is not None else None)
            self._steps[key] = build_train_step(
                self.model, self.tcfg, self.n_nodes, phase=phase,
                shift_step=shift, with_consensus=self.with_consensus,
                mesh=self.mesh, fault_hops=hops)
        return self._steps[key]

    def device_batch(self, k: int) -> Dict[str, torch.Tensor]:
        """Step k's batch on the device (pinned, asynchronous copy)."""
        out = {}
        for name, arr in self.stream.get_batch(k).items():
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[name] = t
        return out

    # ------------------------------------------------------------------
    def run(self, state: TrainState, steps: Optional[int] = None,
            log_every: Optional[int] = None) -> TrainState:
        tcfg = self.tcfg
        steps = steps if steps is not None else tcfg.steps
        log_every = log_every if log_every is not None else tcfg.log_every
        t0 = time.time()
        start = state.step
        for k in range(start, start + steps):
            batch = self.device_batch(k)
            phase = (self.schedule.advance(k) if self.n_nodes > 1
                     else "none")
            shift = self.schedule.gossip_shift_step(k, self.period)
            lr = self.lr_fn(k)
            step_fn = self._get_step_fn(phase, shift)
            if self.tcfg.dist.push_sum:
                # the round's W and live mask, built on the host
                W, active = push_round(self.tcfg.dist.topology,
                                       self.n_nodes, phase, k, shift,
                                       self.fault_schedule)
                state, metrics = step_fn(state, batch, lr, W, active)
            else:
                state, metrics = step_fn(state, batch, lr)
            # the schedule holds the device scalar and reads it only at a
            # period boundary (schedule._as_float): no per-step host read
            self.schedule.observe_loss(k, metrics["loss"])
            if log_every and (k % log_every == 0 or k == steps - 1):
                self._log_boundary(k, phase, lr, metrics, t0)
        return state

    def _log_boundary(self, k: int, phase: str, lr: float,
                      metrics: Dict[str, torch.Tensor], t0: float) -> None:
        """Read step k's device metrics back in one transfer, record them
        in ``history`` and print the step line."""
        names = sorted(metrics)
        host = torch.stack([metrics[m].to(torch.float32)
                            for m in names]).tolist()
        rec = {"step": k, "phase": phase, "lr": lr,
               "time": time.time() - t0, **dict(zip(names, host))}
        self.history.append(rec)
        line = (f"[{self.tcfg.dist.algorithm:10s}] step {k:5d}"
                f" loss={rec['loss']:.4f} phase={phase}")
        if "consensus" in rec:
            line += f" consensus={rec['consensus']:.3e}"
        print(line, flush=True)
