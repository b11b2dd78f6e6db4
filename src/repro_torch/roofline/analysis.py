"""Three-term roofline of one step on an NVIDIA H100 (counterpart of
``repro/roofline/analysis.py``):

  compute term    = FLOPs / PEAK_FLOPS               (per chip)
  memory term     = bytes / HBM_BW                   (per chip)
  collective term = collective bytes / ICI_BW        (per chip)

The card: NVIDIA H100 80GB HBM3 (SXM5) at 700 W, peaks from the vendor's
datasheet — 989.4e12 FLOP/s dense bf16 on the tensor cores, 3.35e12 B/s
of HBM3, and 450e9 B/s of NVLink 4 in one direction.  The names are the
reference's, so callers port unchanged: ``ICI_BW`` holds NVLink's figure.
Every term is analytic, not timed.

The port has no compiled program to read.  Its counterparts of the XLA
readers:

* :func:`raw_costs` runs the step itself (on ``meta`` tensors, which
  allocate and compute nothing) under ``FlopCounterMode`` — the matmul
  family's ``2·M·K·N`` per product, forward and backward — and under a
  dispatch mode that sums the input and output bytes of every aten op
  but the views (which move no data).  Those bytes are unfused, one read
  and one write per op as eager PyTorch runs them, so they bound from
  above what XLA's fused "bytes accessed" counts.  The same tally
  follows each result's storage until it is freed and keeps the peak of
  the live bytes above the arguments;
* :func:`collective_bytes` takes the port's round meters
  (``obs.meters.measured_round_bytes``) on the step's abstract state, not
  HLO text: a gossip round's halo is ``collective-permute``, a global or
  pod average ``all-reduce``, under the reference's five type names;
* :func:`from_run` takes the place of ``from_compiled``.

:class:`Roofline`, :func:`from_costs`, :func:`scan_corrected_costs`,
:func:`count_params` and :func:`model_flops_for` are the reference's
arithmetic, unchanged.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.tree import tree_leaves

PEAK_FLOPS = 989.4e12        # dense bf16 on the tensor cores, per card
HBM_BW = 3.35e12             # bytes/s of HBM3 per card
ICI_BW = 450e9               # bytes/s of NVLink 4, one direction

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


@dataclasses.dataclass
class Roofline:
    flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_detail: Dict[str, Any]
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: Optional[float] = None

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        if self.model_flops is None or self.flops == 0:
            return None
        return self.model_flops / self.flops

    def to_dict(self) -> Dict[str, Any]:
        return {
            "flops": self.flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes,
            "coll_per_type": self.coll_detail.get("per_type_bytes"),
            "coll_counts": self.coll_detail.get("counts"),
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


class ByteTally(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor inputs and outputs
    (``bytes``; a view, which moves no data, counts none) and follows
    each result's storage until it is freed:
    ``peak`` is the most bytes live at once above the storages given to
    :meth:`hold` (the step's arguments), ``live`` those live now."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, int] = {}

    def hold(self, tree) -> None:
        """Mark the storages of ``tree``'s tensors as present before the
        step: a view of them or an op writing into them allocates
        nothing."""
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._seen.setdefault(id(t.untyped_storage()), 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        moves = not func.is_view        # a view moves no data
        for t in tree_flatten((args, kwargs))[0]:
            if moves and isinstance(t, torch.Tensor):
                self.bytes += t.nbytes
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.bytes += t.nbytes if moves else 0
                self._track(t)
        return out


def run_costs(fn: Callable, *args, **kwargs) -> Tuple[Any, Dict[str, float]]:
    """``(fn(*args, **kwargs), costs)``: ``costs`` holds the matmul
    ``flops`` that ``FlopCounterMode`` counts, the unfused ``bytes`` of
    every op and ``peak_bytes``, the peak of the bytes live above the
    arguments while ``fn`` ran (its outputs included)."""
    tally = ByteTally()
    tally.hold((args, kwargs))
    with FlopCounterMode(display=False) as counter, tally:
        out = fn(*args, **kwargs)
    return out, {"flops": float(counter.get_total_flops()),
                 "bytes": float(tally.bytes),
                 "peak_bytes": float(tally.peak)}


def no_collectives() -> Dict[str, Any]:
    """The collective record of a step that moves nothing."""
    return {"total_bytes": 0, "per_type_bytes": {c: 0 for c in _COLLECTIVES},
            "counts": {c: 0 for c in _COLLECTIVES}}


def collective_bytes(params, *, phase: str, topology: str, n_nodes: int,
                     step: int = 0, n_pods: int = 1, comm_dtype=None,
                     compressor=None, global_compressor=None,
                     model_shards: int = 1) -> Dict[str, Any]:
    """Per-node bytes of one round of ``phase`` on the node-stacked
    ``params`` (meta tensors will do) from the port's round meter, in the
    reference's ``{"total_bytes", "per_type_bytes", "counts"}`` shape: a
    gossip round is ``collective-permute`` (one operation per send of the
    topology at ``step``), a global or pod average ``all-reduce`` (one)."""
    from repro_torch.obs.meters import measured_round_bytes, round_sends
    rec = no_collectives()
    per_type, counts = rec["per_type_bytes"], rec["counts"]
    b = measured_round_bytes(
        params, phase=phase, topology=topology, n_nodes=n_nodes, step=step,
        n_pods=n_pods, comm_dtype=comm_dtype, compressor=compressor,
        global_compressor=global_compressor, model_shards=model_shards)
    if phase == "gossip":
        per_type["collective-permute"] = b
        counts["collective-permute"] = (
            round_sends(phase, topology, n_nodes, step) if b else 0)
    elif phase in ("global", "pod_avg"):
        per_type["all-reduce"] = b
        counts["all-reduce"] = 1 if b else 0
    rec["total_bytes"] = b
    return rec


def raw_costs(fn: Callable, *args, coll_detail: Optional[Dict] = None,
              **kwargs) -> Dict[str, Any]:
    """The reference's ``raw_costs`` shape for one run of ``fn``: FLOPs,
    unfused bytes (:func:`run_costs`) and the collective record (none
    unless ``coll_detail`` is given: :func:`collective_bytes`)."""
    _, costs = run_costs(fn, *args, **kwargs)
    coll = coll_detail if coll_detail is not None else no_collectives()
    return {"flops": costs["flops"], "bytes": costs["bytes"],
            "coll": float(coll["total_bytes"]), "coll_detail": coll}


def from_costs(costs: Dict[str, float], *,
               model_flops: Optional[float] = None) -> Roofline:
    return Roofline(
        flops=costs["flops"], hlo_bytes=costs["bytes"],
        coll_bytes=costs["coll"],
        coll_detail=costs.get("coll_detail", {}),
        compute_s=costs["flops"] / PEAK_FLOPS,
        memory_s=costs["bytes"] / HBM_BW,
        collective_s=costs["coll"] / ICI_BW,
        model_flops=model_flops,
    )


def from_run(fn: Callable, *args, model_flops: Optional[float] = None,
             coll_detail: Optional[Dict] = None, **kwargs) -> Roofline:
    """The roofline of one run of ``fn`` (``from_compiled``'s
    counterpart)."""
    return from_costs(raw_costs(fn, *args, coll_detail=coll_detail,
                                **kwargs), model_flops=model_flops)


def scan_corrected_costs(costs_1rep: Dict[str, float],
                         costs_2rep: Dict[str, float],
                         n_reps: int) -> Dict[str, float]:
    """The reference corrects XLA's count of a ``lax.scan`` body (once,
    whatever its trip count) from 1-rep and 2-rep depth variants: per-rep
    cost = c2 − c1; total = c1 + (R−1)·(c2 − c1).  The port unrolls every
    layer, so its dry-run needs no correction; kept for the arithmetic."""
    out = {}
    for k in ("flops", "bytes", "coll"):
        per_rep = max(costs_2rep[k] - costs_1rep[k], 0.0)
        out[k] = costs_1rep[k] + (n_reps - 1) * per_rep
    out["coll_detail"] = {
        "total_bytes": out["coll"],
        "per_type_bytes": {
            k: costs_1rep["coll_detail"]["per_type_bytes"].get(k, 0)
            + (n_reps - 1) * max(
                costs_2rep["coll_detail"]["per_type_bytes"].get(k, 0)
                - costs_1rep["coll_detail"]["per_type_bytes"].get(k, 0), 0)
            for k in costs_1rep["coll_detail"]["per_type_bytes"]},
        "counts": costs_1rep["coll_detail"]["counts"],
    }
    return out


# ---------------------------------------------------------------------------
# MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) per train step;
# 2·N·D forward-only (prefill); 2·N_active per token (decode).
# ---------------------------------------------------------------------------
def count_params(cfg, active_only: bool = False) -> int:
    """Analytic parameter count from the config (no allocation)."""
    d, V = cfg.d_model, cfg.vocab_size
    total = V * d  # embedding
    if not cfg.tie_embeddings:
        total += d * V
    for mixer, ffn in cfg.layers:
        total += 2 * d  # norms (approx; post-norms ignored)
        if mixer in ("attn", "attn_sw"):
            if cfg.mla is not None:
                m = cfg.mla
                qd = m.nope_head_dim + m.rope_head_dim
                total += d * cfg.n_heads * qd
                total += d * m.kv_lora_rank + d * m.rope_head_dim
                total += m.kv_lora_rank * cfg.n_heads * (
                    m.nope_head_dim + m.v_head_dim)
                total += cfg.n_heads * m.v_head_dim * d
            else:
                hd = cfg.resolved_head_dim
                total += d * cfg.n_heads * hd * 2  # q, o
                total += d * cfg.n_kv_heads * hd * 2  # k, v
        elif mixer == "mamba":
            s = cfg.ssm
            di = s.expand * d
            R = s.dt_rank or max(d // 16, 1)
            total += d * 2 * di + di * (R + 2 * s.d_state) + R * di \
                + di * s.d_state + 2 * di + di * d
        elif mixer == "mlstm":
            s = cfg.ssm
            di = s.mlstm_expand * d
            nh = max(di // (2 * s.mlstm_head_dim), 1)
            dk = s.mlstm_head_dim
            total += d * 2 * di + di * nh * dk * 2 + di * (di // nh) * nh \
                + 2 * di * nh + di * d
        elif mixer == "slstm":
            total += d * 4 * d + 4 * d * (d // cfg.ssm.slstm_heads) + d * d
        if ffn == "dense":
            total += 3 * d * cfg.d_ff
        elif ffn == "moe":
            m = cfg.moe
            n_e = m.top_k if active_only else m.n_routed
            total += d * m.n_routed  # router (always dense compute)
            total += n_e * 3 * d * m.d_ff_expert
            total += m.n_shared * 3 * d * m.d_ff_expert
    return int(total)


def model_flops_for(cfg, shape, n_chips: int) -> float:
    """Per-chip MODEL_FLOPS for one step of the given input shape."""
    n_active = count_params(cfg, active_only=True)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if shape.kind == "train" else 2
    return mult * n_active * tokens / n_chips
