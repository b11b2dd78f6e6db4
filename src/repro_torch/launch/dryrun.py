"""Multi-pod dry-run: run every (architecture × input shape × mesh)
combination's step on ``meta`` tensors against the production mesh
description and record its memory, its costs and its collectives for the
roofline report (counterpart of ``repro/launch/dryrun.py``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch qwen3-0.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --all --mesh both --out results.jsonl

No card and no JAX: the shape work runs on the ``meta`` device by design.
It is the counterpart of the reference's abstract lowering against 512
forced host devices, not a CPU fallback: a meta tensor has a shape and a
dtype and no data, so the step runs at full published size in seconds
and touches no device.  Every figure is analytic for the H100 of
``repro_torch.roofline``, not timed.

Train shapes run BOTH communication phases ("gossip" = a Gossip-SGD step
with its gossip round; "global" = the periodic exact average); the
H-amortized combination is what Gossip-PGA executes.  The train step is
the port's ``train.step.build_train_step`` under the lowered
``DistConfig`` (``comm_backend="reference"`` as ``run_one`` sets it, so no
hand-written kernel's wrapper is reached: each raises on a meta tensor).
Decode shapes run ``Model.decode_step`` — one new token against a
``seq_len`` cache — and prefill shapes ``Model.forward(mode="prefill")``.

Where the port differs from the reference's record, by design:

* Every node and every layer runs unrolled, so the full-depth costs are
  exact: no 1-rep/2-rep depth variants are run (the reference's
  ``_shallow_variants``), and ``roofline_raw_scan`` equals ``roofline``.
  Its ``--fast`` flag, which skips those variants, has nothing to skip
  and is not taken.  ``compile_s`` is the wall seconds of the meta run.
* FLOPs are ``FlopCounterMode``'s matmul count; bytes are every aten op's
  inputs and outputs, unfused (an upper bound of XLA's fused bytes).
  FLOPs and bytes per chip are the step's totals ÷ ``n_chips``: an even
  split, where the reference reads post-SPMD per-device counts.
* Collective bytes are the port's round meters on the abstract state, per
  node, times the nodes ÷ ``n_chips`` (the same even split): the gossip
  or global round only, not the tensor-parallel gathers and reductions
  that the reference's SPMD partitioner adds inside the step.  A serve
  step has no round, so no collective of it is modelled.  Each record
  says which in ``coll_modelled`` (a key the reference does not write):
  ``"round"`` for a train phase, ``"none"`` for a serve step, whose
  collective term of 0 is then no result and whose ``dominant`` can
  never be "collective".
* ``run_one`` does not set ``DistConfig.fsdp`` for
  ``HIERARCHICAL_ARCHS`` as the reference's does: nothing reads it there
  (the ``train_pod`` rules follow ``node_axis``), and the port's
  ``DistConfig`` refuses it (ROADMAP A.10.5).
* ``argument_size_in_bytes`` and ``output_size_in_bytes`` sum each
  leaf's shard under its ``PartitionSpec`` (a replicated leaf whole on
  every chip; an output without a sharding split evenly);
  ``temp_size_in_bytes`` is the peak of the bytes live above the
  arguments while the step runs, outputs included, as the port runs it:
  one process holding every shard (not per chip).  ``alias_size_in_bytes``
  is 0 but for a decode with ``donate_cache`` (the cache's bytes a chip),
  and ``generated_code_size_in_bytes`` None: nothing is compiled.

Nothing here catches a failure and carries on except :func:`run_one`,
which records ``ok: False`` with the error and its traceback, as the
reference does; the CLI then exits 1.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.compress import round_wire_bytes
from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, DataConfig,
                                 DistConfig, OptimizerConfig, TrainConfig,
                                 get_model_config)
from repro_torch.core.mixing import model_shard_count, use_sharded_backend
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import serve_specs, train_specs
from repro_torch.models.model import make_model
from repro_torch.roofline import model_flops_for
from repro_torch.roofline.analysis import (collective_bytes, from_costs,
                                           no_collectives, run_costs)
from repro_torch.train.step import build_train_step
from repro_torch.tree import tree_leaves


# long-context eligibility: SSM/hybrid run as is; gemma2 runs its
# sliding-window variant; other dense/moe/vlm archs and the encoder skip.
LONG_OK_FAMILIES = ("ssm", "hybrid")
DECODE_SKIP_FAMILIES = ("encoder",)

# archs whose per-node replicas don't fit 16-way TP: hierarchical mode
# (gossip across pods, FSDP+TP within) + 2D weight sharding when serving.
HIERARCHICAL_ARCHS = ("jamba-1.5-large-398b", "qwen1.5-32b")
SERVE_2D_ARCHS = ("jamba-1.5-large-398b", "qwen1.5-32b",
                  "qwen3-moe-30b-a3b", "llava-next-mistral-7b", "gemma2-9b")


def plan_for(arch: str, shape_name: str) -> Optional[Dict[str, Any]]:
    """What to run for this (arch, shape) — or a skip with its reason."""
    cfg = get_model_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if shape.kind == "decode" and cfg.family in DECODE_SKIP_FAMILIES:
        return {"skip": f"{arch} is encoder-only: no decode step"}
    if shape_name == "long_500k":
        if cfg.family in LONG_OK_FAMILIES:
            pass
        elif arch == "gemma2-9b":
            cfg = get_model_config(arch, long_context=True)
        else:
            return {"skip": f"{arch} is pure full-attention: long_500k "
                            "requires sub-quadratic attention"}
    return {"cfg": cfg, "shape": shape}


def _chips_per_shard(spec, mesh) -> int:
    """How many blocks of ``mesh`` one shard of a leaf under ``spec`` is
    split over (the product of the mesh axes it names)."""
    sizes = dict(mesh.shape)
    k = 1
    for part in spec:
        for name in (part if isinstance(part, tuple) else (part,)):
            if name is not None:
                k *= sizes[name]
    return k


def _leaves_with_shardings(sds, shardings):
    leaves, shards = tree_leaves(sds), tree_leaves(shardings)
    assert len(leaves) == len(shards), (len(leaves), len(shards))
    return [(t, sh) for t, sh in zip(leaves, shards)
            if isinstance(t, torch.Tensor)]


def argument_bytes(sds, shardings, mesh) -> Tuple[int, int]:
    """``(per chip, replicated)``: the bytes one chip holds of the tensor
    leaves of ``sds`` under their shardings, and of those the bytes of
    the leaves every chip holds whole."""
    per_chip = replicated = 0
    for t, sh in _leaves_with_shardings(sds, shardings):
        k = _chips_per_shard(sh.spec, mesh)
        nbytes = t.numel() * t.element_size()
        per_chip += nbytes // k
        if k == 1:
            replicated += nbytes
    return per_chip, replicated


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _mem_dict(argument: int, output: int, temp: int) -> Dict[str, Any]:
    return {"argument_size_in_bytes": argument,
            "output_size_in_bytes": output,
            "temp_size_in_bytes": temp,
            "alias_size_in_bytes": 0,
            "generated_code_size_in_bytes": None}


def _per_chip(costs: Dict[str, float], n_chips: int) -> Dict[str, Any]:
    out = {k: costs[k] / n_chips for k in ("flops", "bytes", "coll")}
    det = costs["coll_detail"]
    out["coll_detail"] = {
        "total_bytes": det["total_bytes"] / n_chips,
        "per_type_bytes": {k: v / n_chips
                           for k, v in det["per_type_bytes"].items()},
        "counts": det["counts"]}
    return out


def _run_train(cfg, shape, mesh, *, dist: DistConfig, phase: str,
               microbatches: int = 1,
               optimizer: OptimizerConfig = OptimizerConfig()):
    """``(costs of the whole step, output, specs, tcfg)`` of one train
    step of ``phase`` on the meta state."""
    model = make_model(cfg)
    specs = train_specs(cfg, mesh, shape, dist=dist, optimizer=optimizer)
    tcfg = TrainConfig(model=cfg, dist=dist, optimizer=optimizer,
                       data=DataConfig(), global_batch=shape.global_batch,
                       seq_len=shape.seq_len, microbatches=microbatches)
    step = build_train_step(model, tcfg, specs.n_nodes, phase=phase,
                            mesh=mesh)
    out, costs = run_costs(step, specs.state_sds, specs.batch_sds,
                           tcfg.optimizer.lr)
    return costs, out, specs, tcfg


def dryrun_train(cfg, shape, mesh, *, dist: DistConfig, phases=("gossip",
                                                                "global"),
                 microbatches: int = 1,
                 optimizer: OptimizerConfig = OptimizerConfig()):
    """One record per phase: the step's memory, roofline and wire bytes,
    with ``optimizer`` (the reference's is always the default SGD; a
    caller that holds the record against a real step passes that step's
    optimizer, whose state and passes change the bytes)."""
    n_chips = mesh.size
    out: Dict[str, Any] = {"phases": {}}
    for phase in phases:
        t0 = time.time()
        costs, (new_state, metrics), specs, tcfg = _run_train(
            cfg, shape, mesh, dist=dist, phase=phase,
            microbatches=microbatches, optimizer=optimizer)
        run_s = time.time() - t0
        out["n_nodes"] = specs.n_nodes
        out["mode"] = specs.mode
        spec = dist.comm_spec(specs.n_nodes, mesh=mesh)
        coll = collective_bytes(
            specs.state_sds.params, phase=phase, topology=dist.topology,
            n_nodes=specs.n_nodes, n_pods=dist.n_pods,
            comm_dtype=spec.comm_dtype, compressor=spec.compressor,
            global_compressor=spec.global_compressor)
        # per node -> the step's total over the nodes
        total = {"flops": costs["flops"], "bytes": costs["bytes"],
                 "coll": float(coll["total_bytes"] * specs.n_nodes),
                 "coll_detail": {
                     "total_bytes": coll["total_bytes"] * specs.n_nodes,
                     "per_type_bytes": {
                         k: v * specs.n_nodes
                         for k, v in coll["per_type_bytes"].items()},
                     "counts": coll["counts"]}}
        per_chip = _per_chip(total, n_chips)
        mf = model_flops_for(cfg, shape, n_chips)
        rl = from_costs(per_chip, model_flops=mf)
        arg, _ = argument_bytes((specs.state_sds, specs.batch_sds),
                                (specs.state_shardings,
                                 specs.batch_shardings), mesh)
        state_out, _ = argument_bytes(new_state, specs.state_shardings, mesh)
        output = state_out + _tensor_bytes(metrics)
        mem = _mem_dict(arg, output, int(costs["peak_bytes"]))
        # analytic bytes-on-wire per node per round: what the configured
        # compressor/wire dtype puts on the interconnect vs fp32
        leaf_sizes = [math.prod(lf.shape[1:])
                      for lf in tree_leaves(specs.state_sds.params)]
        per_node_params = sum(leaf_sizes)
        wb = round_wire_bytes(
            phase, dist.topology, specs.n_nodes, per_node_params,
            comm_dtype=dist.comm_dtype, compression=dist.comm_compression,
            k=dist.comm_compression_k, n_pods=dist.n_pods,
            leaf_sizes=leaf_sizes,
            global_compression=dist.comm_global_compression)
        wb_fp32 = round_wire_bytes(phase, dist.topology, specs.n_nodes,
                                   per_node_params, n_pods=dist.n_pods)
        # per-device bytes divide by the model axis only when the run
        # routes through the sharded rounds (the reference backend keeps
        # replicated columns)
        sharded_comm = use_sharded_backend(
            dist.comm_backend, mesh, dist.node_axis, dist.comm_shard_mode,
            dist.model_axis)
        model_shards = model_shard_count(
            mesh, dist.model_axis, dist.node_axis) if sharded_comm else 1
        wb_dev = round_wire_bytes(
            phase, dist.topology, specs.n_nodes, per_node_params,
            comm_dtype=dist.comm_dtype, compression=dist.comm_compression,
            k=dist.comm_compression_k, n_pods=dist.n_pods,
            leaf_sizes=leaf_sizes,
            global_compression=dist.comm_global_compression,
            model_shards=model_shards)
        out["phases"][phase] = {
            "compile_s": run_s,
            "memory": mem,
            "roofline": rl.to_dict(),
            "roofline_raw_scan": rl.to_dict(),
            "wire": {"bytes_per_node": wb,
                     "fp32_bytes_per_node": wb_fp32,
                     "model_shards": model_shards,
                     "bytes_per_device": wb_dev,
                     "compression": dist.comm_compression,
                     "global_compression": dist.comm_global_compression,
                     "reduction": (wb_fp32 / wb) if wb else 1.0},
            "coll_modelled": "round",
        }
        useful = rl.useful_flops_ratio
        print(f"    [{phase:6s}] meta run {run_s:6.1f}s  "
              f"flops/chip {rl.flops:.3e}  bytes {rl.hlo_bytes:.3e}  "
              f"coll(round) {rl.coll_bytes:.3e}  dominant={rl.dominant}  "
              f"useful={useful if useful is None else round(useful, 3)}",
              flush=True)
        print(f"    wire(analytic): {wb:.3e} B/node/round "
              f"({dist.comm_compression}; fp32 {wb_fp32:.3e}, "
              f"reduction {(wb_fp32 / wb) if wb else 1.0:.2f}x)", flush=True)
        print(f"    memory: {mem}", flush=True)
        del new_state, metrics, specs
    return out


def _node(tree):
    """The node axis of 1 that the port's Model takes, as a view."""
    if isinstance(tree, dict):
        return {k: _node(v) for k, v in tree.items()}
    return tree[None]


def _run_serve(cfg, shape, mesh, *, param_sharding: str,
               context_parallel: Optional[bool] = None):
    model = make_model(cfg)
    specs = serve_specs(cfg, mesh, shape, param_sharding=param_sharding,
                        context_parallel=context_parallel)
    params = _node(specs.params_sds)
    if shape.kind == "prefill":
        def prefill_step(params, batch):
            logits, caches, _ = model.forward(params, batch, mode="prefill",
                                              want_cache=True)
            return logits, caches

        out, costs = run_costs(prefill_step, params, _node(specs.batch_sds))
        return costs, out, specs

    def serve_step(params, caches, tokens, pos):
        return model.decode_step(params, caches, tokens, pos)

    out, costs = run_costs(serve_step, params, _node(specs.cache_sds),
                           _node(specs.tokens_sds), specs.pos_sds)
    return costs, out, specs


def dryrun_serve(cfg, shape, mesh, *, param_sharding: str,
                 context_parallel: Optional[bool] = None,
                 donate_cache: bool = False):
    """The serve step's memory and roofline.  ``donate_cache``: the cache's
    bytes count as aliased (the port's decode writes the attention caches
    in place, so the updated cache is no second copy either way).  No
    collective is modelled (``coll_modelled: "none"``)."""
    n_chips = mesh.size
    t0 = time.time()
    costs, out, specs = _run_serve(cfg, shape, mesh,
                                   param_sharding=param_sharding,
                                   context_parallel=context_parallel)
    run_s = time.time() - t0
    total = {"flops": costs["flops"], "bytes": costs["bytes"], "coll": 0.0,
             "coll_detail": no_collectives()}
    per_chip = _per_chip(total, n_chips)
    mf = model_flops_for(cfg, shape, n_chips)
    rl = from_costs(per_chip, model_flops=mf)
    if shape.kind == "prefill":
        arg, _ = argument_bytes((specs.params_sds, specs.batch_sds),
                                (specs.params_shardings,
                                 specs.batch_shardings), mesh)
        output = _tensor_bytes(out) // n_chips
    else:
        arg, _ = argument_bytes(
            (specs.params_sds, specs.cache_sds, specs.tokens_sds,
             specs.pos_sds),
            (specs.params_shardings, specs.cache_shardings,
             specs.tokens_sharding, specs.pos_sharding), mesh)
        logits, _caches = out
        cache_chip, _ = argument_bytes(specs.cache_sds, specs.cache_shardings,
                                       mesh)
        output = _tensor_bytes(logits) // n_chips + cache_chip
    mem = _mem_dict(arg, output, int(costs["peak_bytes"]))
    if donate_cache and shape.kind == "decode":
        mem["alias_size_in_bytes"] = cache_chip
    print(f"    [{shape.kind:6s}] meta run {run_s:6.1f}s  "
          f"flops/chip {rl.flops:.3e}  bytes {rl.hlo_bytes:.3e}  "
          f"coll not modelled  dominant of compute and memory="
          f"{rl.dominant}", flush=True)
    print(f"    memory: {mem}", flush=True)
    return {"mode": specs.mode, "compile_s": run_s, "memory": mem,
            "roofline": rl.to_dict(), "roofline_raw_scan": rl.to_dict(),
            "coll_modelled": "none"}


def run_one(arch: str, shape_name: str, mesh_kind: str, *,
            algorithm: str = "gossip_pga", topology: str = "ring",
            H: int = 6, compression: str = "none",
            compression_k: int = 32,
            error_feedback: bool = False,
            global_compression: str = "none") -> Dict[str, Any]:
    plan = plan_for(arch, shape_name)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_kind}
    if plan is None or "skip" in plan:
        rec["skipped"] = plan["skip"]
        print(f"  SKIP: {plan['skip']}", flush=True)
        return rec
    cfg, shape = plan["cfg"], plan["shape"]
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device="meta")
    try:
        if shape.kind == "train":
            node_axis = ("pod" if arch in HIERARCHICAL_ARCHS
                         and mesh_kind == "multi" else "data")
            dist = DistConfig(algorithm=algorithm, topology=topology, H=H,
                              node_axis=node_axis,
                              comm_compression=compression,
                              comm_compression_k=compression_k,
                              comm_error_feedback=error_feedback,
                              comm_global_compression=global_compression)
            rec.update(dryrun_train(cfg, shape, mesh, dist=dist))
        else:
            ps = "2d" if arch in SERVE_2D_ARCHS else "tp"
            rec.update(dryrun_serve(cfg, shape, mesh, param_sharding=ps))
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — recorded, not hidden
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"  FAIL: {rec['error']}", flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--algorithm", default="gossip_pga")
    ap.add_argument("--topology", default="ring")
    ap.add_argument("--H", type=int, default=6)
    ap.add_argument("--out", default=None, help="append-mode JSONL output")
    ap.add_argument("--comm-compression", default="none",
                    choices=("none", "identity", "int8", "fp8", "topk",
                             "randk"),
                    help="wire compressor: runs the compressed comm path "
                         "and feeds the wire-bytes cost model")
    ap.add_argument("--comm-compression-k", type=int, default=32)
    ap.add_argument("--comm-global-compression", default="none",
                    choices=("none", "identity", "int8", "fp8"),
                    help="compressed collective for the global/pod-avg "
                         "phases: the wire record's global-phase row "
                         "reports its real reduction")
    ap.add_argument("--error-feedback", action="store_true")
    args = ap.parse_args()

    archs = list(ASSIGNED_ARCHS) if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    results = []
    for mesh_kind in meshes:
        for arch in archs:
            for shape_name in shapes:
                print(f"== {arch} × {shape_name} × {mesh_kind} ==", flush=True)
                rec = run_one(arch, shape_name, mesh_kind,
                              algorithm=args.algorithm,
                              topology=args.topology, H=args.H,
                              compression=args.comm_compression,
                              compression_k=args.comm_compression_k,
                              error_feedback=args.error_feedback,
                              global_compression=args.comm_global_compression)
                results.append(rec)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    n_fail = sum(1 for r in results if r.get("ok") is False)
    n_ok = sum(1 for r in results if r.get("ok"))
    n_skip = sum(1 for r in results if "skipped" in r)
    print(f"\ndry-run summary: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_fail} FAILED")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
