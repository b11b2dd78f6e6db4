"""Hill-climbing on the dry-run — three selected (arch × shape) pairs,
iterated with the hypothesis → change → re-run → validate loop
(counterpart of ``repro/launch/hillclimb.py``).  Results append to
``results_hillclimb.jsonl``.  The dry-run runs on ``meta`` tensors: no
card and no JAX; every figure is analytic for the H100 of
``repro_torch.roofline``.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb [--exp exp1]

The experiments and their hypotheses are the reference's, word for word:
they speak of a TPU pod's collectives, and are kept as data.  The port's
dry-run models no collective of a serve step and only the round of a
train step (``coll_modelled`` in each record): :func:`record` says so
where it prints, and names no collective-bound verdict from a 0.

Selected pairs (from the single-pod baseline sweep):
 1. gemma2-9b × decode_32k   — most collective-bound (kv_heads=8 doesn't
    divide model=16 ⇒ the 32k KV cache replicates per chip and decode
    all-gathers it).
 2. jamba-1.5-large-398b × train_4k — worst absolute roofline (mamba scan
    states + MoE dispatch in fp32).
 3. qwen3-moe-30b-a3b × train_4k — the paper-representative pair: gossip
    phase is MORE collective-expensive than the periodic All-Reduce
    (ring = 2 permutes of full fp32 params); the paper itself prescribes the
    one-peer exponential graph, and bf16 wire is the beyond-paper step.
"""
import argparse
import dataclasses
import json
from typing import Any, Dict

from repro_torch.configs import INPUT_SHAPES, DistConfig, get_model_config
from repro_torch.launch.dryrun import dryrun_serve, dryrun_train
from repro_torch.launch.mesh import make_production_mesh

OUT = "results_hillclimb.jsonl"


def record(exp: str, variant: str, hypothesis: str, rec: Dict[str, Any],
           out_path: str) -> None:
    rec = dict(rec, experiment=exp, variant=variant, hypothesis=hypothesis)
    with open(out_path, "a") as f:
        f.write(json.dumps(rec) + "\n")
    if "phases" in rec:
        ph = rec["phases"]
        rl = ph["gossip" if "gossip" in ph else next(iter(ph))]["roofline"]
        modelled = ph.get("gossip", {}).get("coll_modelled", "round")
    else:
        rl = rec["roofline"]
        modelled = rec.get("coll_modelled", "round")
    coll = ("coll=not modelled" if modelled == "none"
            else f"coll({modelled})={rl['collective_s']:.3e}")
    dominant = ("dominant of comp and mem" if modelled == "none"
                else "dominant")
    print(f"  >> {exp}/{variant}: {dominant}={rl['dominant']} "
          f"comp={rl['compute_s']:.3e} mem={rl['memory_s']:.3e} {coll}",
          flush=True)


def exp1_gemma2_decode(mesh, out_path):
    """KV-cache sharding for GQA decode when kv_heads ∤ model axis."""
    cfg = get_model_config("gemma2-9b")
    shape = INPUT_SHAPES["decode_32k"]
    print("== exp1: gemma2-9b decode_32k ==", flush=True)
    rec = dryrun_serve(cfg, shape, mesh, param_sharding="2d")
    record("gemma2_decode_kv", "baseline_2d",
           "baseline: kv_heads=8 replicated on model=16 — every chip holds "
           "the full 32k KV; expect collective-bound", rec, out_path)
    rec = dryrun_serve(cfg, shape, mesh, param_sharding="tp_seq")
    record("gemma2_decode_kv", "kv_seq_over_model",
           "shard the cache SEQUENCE dim over model (flash-decoding style): "
           "per-chip KV drops 16x; decode reads 1/16 of the cache + a tiny "
           "partial-softmax all-reduce — predict collective term ↓ >10x and "
           "memory term ↓ ~10x", rec, out_path)
    rec = dryrun_serve(cfg, shape, mesh, param_sharding="tp_seq",
                       donate_cache=True)
    record("gemma2_decode_kv", "kv_seq+cache_donation",
           "remaining memory term ≈ a full cache copy: without input/output "
           "aliasing XLA materializes the updated cache — donate the cache "
           "buffer; predict memory term ↓ toward params+1/16-cache reads",
           rec, out_path)


def exp2_jamba_train(mesh, out_path, variants=None):
    """Memory-bound hybrid training: scan dtype, remat policy, comm wire.
    ``variants``: the names to run (all when None)."""
    cfg = get_model_config("jamba-1.5-large-398b")
    cfg_bf16 = dataclasses.replace(
        cfg, ssm=dataclasses.replace(cfg.ssm, scan_dtype="bfloat16"))
    shape = INPUT_SHAPES["train_4k"]
    print("== exp2: jamba-1.5-large-398b train_4k ==", flush=True)
    base_dist = DistConfig(algorithm="gossip_pga", topology="ring", H=6)
    for variant, c, dist, hyp in [
        ("baseline_ring_f32", cfg, base_dist,
         "baseline: fp32 mamba scan states (B,S,di,N) dominate HLO bytes"),
        ("scan_bf16", cfg_bf16, base_dist,
         "mamba scan state fp32→bf16: scan-state traffic is ~half of the "
         "mamba layers' bytes — predict memory term ↓ ~25-35%"),
        ("scan_bf16+remat_dots", cfg_bf16,
         dataclasses.replace(base_dist, remat_policy="dots"),
         "checkpoint_dots policy keeps matmul outputs, recomputes the "
         "rest: fewer backward recompute reads — predict memory term ↓ "
         "but compute term ↑ slightly (re-lowered to verify direction)"),
        ("scan_bf16+one_peer_bf16_comm", cfg_bf16,
         dataclasses.replace(base_dist, topology="one_peer_exp",
                             comm_dtype="bfloat16"),
         "gossip wire: ring(2 permutes, fp32) → one-peer-exp(1 permute, "
         "bf16) — predict gossip-phase collective bytes ↓ ~4x"),
    ]:
        if variants is None or variant in variants:
            rec = dryrun_train(c, shape, mesh, dist=dist)
            record("jamba_train", variant, hyp, rec, out_path)


def exp4_jamba_microbatch(mesh, out_path):
    """Follow-up on exp2: the memory term tracks live activations; gradient
    accumulation (4 microbatches) shrinks the per-pass working set 4x."""
    cfg = dataclasses.replace(
        get_model_config("jamba-1.5-large-398b"),
        ssm=dataclasses.replace(
            get_model_config("jamba-1.5-large-398b").ssm,
            scan_dtype="bfloat16"))
    shape = INPUT_SHAPES["train_4k"]
    print("== exp4: jamba train_4k + microbatching ==", flush=True)
    dist = DistConfig(algorithm="gossip_pga", topology="one_peer_exp", H=6,
                      comm_dtype="bfloat16")
    rec = dryrun_train(cfg, shape, mesh, dist=dist, microbatches=4)
    record("jamba_train", "scan_bf16+one_peer_bf16+microbatch4",
           "4-way grad accumulation: per-microbatch activations (incl. the "
           "(B,S,di,N) mamba scan states) shrink 4x — predict temp memory "
           "↓ ~3-4x; HLO bytes roughly unchanged (same total work), so the "
           "memory *term* holds while the footprint fits HBM", rec, out_path)


def exp3_qwen3moe_comm(mesh, out_path, phases=("gossip", "global")):
    """The paper's own knob: topology choice + wire dtype for gossip."""
    cfg = get_model_config("qwen3-moe-30b-a3b")
    shape = INPUT_SHAPES["train_4k"]
    print("== exp3: qwen3-moe-30b-a3b train_4k ==", flush=True)
    for variant, dist, hyp in [
        ("baseline_ring_f32",
         DistConfig(algorithm="gossip_pga", topology="ring", H=6),
         "baseline: ring gossip = 2 collective-permutes of the full fp32 "
         "param set per step"),
        ("one_peer_exp_f32",
         DistConfig(algorithm="gossip_pga", topology="one_peer_exp", H=6),
         "paper-faithful fix (§3, Assran et al.): one-peer exponential "
         "graph = ONE permute per step — predict gossip collective bytes "
         "↓ ~2x at equal convergence bound (C_β shrinks too)"),
        ("one_peer_exp_bf16",
         DistConfig(algorithm="gossip_pga", topology="one_peer_exp", H=6,
                    comm_dtype="bfloat16"),
         "beyond-paper: bf16 wire on the permute — predict another ~2x; "
         "the paper lists quantization as an orthogonal add-on"),
    ]:
        rec = dryrun_train(cfg, shape, mesh, dist=dist, phases=phases)
        record("qwen3moe_comm", variant, hyp, rec, out_path)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", default="all",
                    choices=["all", "exp1", "exp2", "exp3", "exp4"])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    mesh = make_production_mesh(multi_pod=False, device="meta")
    if args.exp in ("all", "exp1"):
        exp1_gemma2_decode(mesh, args.out)
    if args.exp in ("all", "exp2"):
        exp2_jamba_train(mesh, args.out)
    if args.exp in ("all", "exp3"):
        exp3_qwen3moe_comm(mesh, args.out)
    if args.exp in ("all", "exp4"):
        exp4_jamba_microbatch(mesh, args.out)


if __name__ == "__main__":
    main()
