#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises, so the run exits non-zero and prints no ok
line):

1. device and build: the card's name and power limit, the torch/CUDA
   versions, and the three kernels built from ``src/repro_torch/csrc/``
   (``mix.cu``, ``cmix.cu``, ``collective.cu``; one nvcc each, all at
   once) with their ``-Xptxas -v`` reports;
2. every kernel against its plain PyTorch version on the card, at ragged
   and main-path shapes, with the tolerances stated in
   :func:`check_mix_kernel`, :func:`check_cmix_kernel` and
   :func:`check_collective_kernel`; timing by CUDA events against the
   kernel's memory bound and one PyTorch library call;
3. slice 1's main path: the decentralized ``Trainer`` on pga-lm-100m at
   full width (8 nodes stacked on the card, Gossip-PGA with H = 3 over
   the one-peer exponential graph, fused kernel mixing with the consensus
   residual, AdamW, global batch 32 × seq 512, 6 steps), with every
   kernel's launch count set to 0 just before it and read just after;
   then one fused round timed alone and one more step under
   ``torch.profiler`` (where the device time goes);
4. slice 2's main path: the same trainer with compressed Gossip-PGA
   (int8 gossip rounds and int8 compressed collective, error feedback),
   its launch counts read the same way, then one compressed gossip round
   and one compressed global round timed alone;
5. both trainers at the reduced config with fp32 compute, on the card
   (kernels) and on the CPU (plain versions) from one init, compared.

The last three lines of standard output are the card's name and power
limit, one JSON object with the kernel records, and the ok line.  The
script imports nothing of JAX: the card's machine has none.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: HBM3 rate, fp32 rate outside tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
MAIN_N, MAIN_D = 8, 25_165_824      # the embedding leaf of pga-lm-100m
# every launch width of the main path's round: the staging buffer of the
# norms, the attention projections, the embedding, the MLP matrices
MAIN_WIDTHS = (19_200, 7_077_888, MAIN_D, 28_311_552)
RAGGED_D = 1_000_003
MAIN_PACKED_D = 138_431_232         # every parameter of one node, packed


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters=20, warmup=3) -> float:
    """Mean time of ``fn`` by CUDA events over ``iters`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bound(bytes_moved: float, flops: float):
    """``(bound_ms, bound_by)``: the larger of the bytes over the HBM rate
    and the fp32 operations over the card's fp32 rate."""
    b = bytes_moved / HBM_BYTES_PER_S * 1e3
    f = flops / FP32_FLOP_PER_S * 1e3
    return max(b, f), "bytes" if b >= f else "operations"


def check_mix_kernel(torch, mc) -> dict:
    """Kernel vs plain version.  Tolerances: max|o − o_plain| and
    max|x̄ − x̄_plain| ≤ 1e-5·max|x| (the plain version's matmul sums the
    n terms in another order than the kernel's loop), residual relative
    error ≤ 1e-5 (another summation order over D columns), and the rows
    of a global round bitwise equal with a residual of exactly 0."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    gamma = torch.tensor([0.05], device="cuda")
    worst = 0.0
    cases = 0

    def compare(x, g, d, M, with_g, with_residual, wire, bitwise_rows):
        nonlocal worst, cases
        args = (x, g if with_g else None, gamma if with_g else None, d, M)
        kw = dict(with_g=with_g, with_residual=with_residual, wire=wire)
        out = mc.mix_flat(*args, **kw)
        ref = mc.mix_flat_plain(*args, **kw)
        torch.cuda.synchronize()
        xs = x - gamma * g if with_g else x
        tol = 1e-5 * float(xs.abs().max())
        o, r = (out[0], ref[0]) if with_residual else (out, ref)
        err = float((o - r).abs().max())
        if with_residual:
            err = max(err, float((out[1] - ref[1]).abs().max()))
            rel = abs(float(out[2]) - float(ref[2])) / max(
                abs(float(ref[2])), 1e-30)
            if bitwise_rows:
                assert float(out[2]) == 0.0, float(out[2])
            elif rel > 1e-5:
                raise AssertionError(f"residual rel err {rel:.3e}")
        if err > tol:
            raise AssertionError(
                f"mix kernel n={x.shape[0]} D={x.shape[1]} {kw}: max abs "
                f"err {err:.3e} > {tol:.3e}")
        if bitwise_rows:
            assert torch.equal(o, o[:1].expand_as(o)), "global rows differ"
        worst = max(worst, err)
        cases += 1

    # n = 256 takes the path where a block opts into more than 48 KB of
    # shared memory
    for n, width in ((4, RAGGED_D), (8, RAGGED_D), (32, RAGGED_D),
                     (256, 100_003)):
        x = torch.randn(n, width, device="cuda", generator=gen)
        g = torch.randn(n, width, device="cuda", generator=gen)
        for phase, topo in (("gossip", "exp"), ("global", "ring")):
            d, M = (torch.from_numpy(a).cuda()
                    for a in mc.phase_matrices(phase, topo, n))
            for with_g in (False, True):
                for with_residual in (False, True):
                    for wire in (False, True):
                        compare(x, g, d, M, with_g, with_residual, wire,
                                phase == "global")
        # in place into a private staging buffer
        stage = x.clone()
        d, M = (torch.from_numpy(a).cuda()
                for a in mc.phase_matrices("gossip", "ring", n))
        out = mc.mix_flat(stage, None, None, d, M, with_g=False,
                          with_residual=False, wire=True, inplace=True)
        ref = mc.mix_flat_plain(x, None, None, d, M, with_g=False,
                                with_residual=False, wire=True)
        assert out.data_ptr() == stage.data_ptr()
        assert float((out - ref).abs().max()) <= 1e-5 * float(
            x.abs().max())
        del x, g, stage, out, ref

    # the main path's calls (n = 8, fp32 wire, consensus residual on, as
    # Trainer's fused round launches them), timed at the embedding leaf
    d, M = (torch.from_numpy(a).cuda()
            for a in mc.phase_matrices("gossip", "one_peer_exp", MAIN_N))
    for width in MAIN_WIDTHS:
        x = torch.randn(MAIN_N, width, device="cuda", generator=gen)
        compare(x, None, d, M, False, True, False, False)
    x = torch.randn(MAIN_N, MAIN_D, device="cuda", generator=gen)
    kw = dict(with_g=False, with_residual=True, wire=False)
    ms = cuda_ms(torch, lambda: mc.mix_flat(x, None, None, d, M, **kw))
    plain_ms = cuda_ms(torch,
                       lambda: mc.mix_flat_plain(x, None, None, d, M, **kw))
    W = M + torch.diag(d[:, 0])
    library_ms = cuda_ms(torch, lambda: torch.matmul(W, x))
    n, D = MAIN_N, MAIN_D
    bytes_moved = 4 * (n * D + n * D + D)      # read x, write o and x̄
    flops = 2 * n * n * D + 4 * n * D           # mix + mean + residual
    bound_ms, bound_by = _bound(bytes_moved, flops)
    print(f"[kernel] mix n={n} D={D} residual: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.matmul(W, x) {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms by {bound_by} "
          f"({bytes_moved / (ms * 1e-3) / 1e9:.0f} GB/s achieved)",
          flush=True)
    print(f"[kernel] {cases} kernel-vs-plain cases within tolerance, "
          f"max abs err {worst:.3e}", flush=True)
    return {"name": "mix_kernel", "route": "cuda",
            "source": "src/repro_torch/csrc/mix.cu",
            "replaces": "src/repro/kernels/mixing_pallas.py:215",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def check_cmix_kernel(torch, mc) -> dict:
    """cmix kernel vs its plain twin on the card, every kind (int8, fp8 with
    error feedback on and off; q precomputed from topk and randk), every
    phase (gossip, global with and without the bf16 wire, pod_avg), n in
    {4, 8, 32} at D = 1,000,003 and n = 8 at the embedding leaf.  The two
    do the same IEEE operations in the same order on the same scale tensor
    (the wrapper computes it), so the tolerance is 1e-6·max|x| on o and on
    the new EF and the measured error is expected to be 0.  Constant
    fixed point: the rows of an equal-row state stay bitwise equal in every
    case, and one-peer gossip returns the state bitwise, for every kind."""
    from repro_torch import compress as C
    from repro_torch.compress import quantize as cq

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst, cases = 0.0, 0
    phases = (("gossip", "one_peer_exp", 1, False), ("global", "ring", 1,
                                                     False),
              ("global", "ring", 1, True), ("pod_avg", "ring", 2, False))

    def run(x, e, kind, phase, topo, pods, wire, seed, q=None):
        n = x.shape[0]
        w, M = mc._device_compensated(phase, topo, n, 1, pods,
                                      torch.device("cuda"))
        scale = None
        if q is None:
            y = x if e is None else x + e
            scale = cq.int8_scale(y) if kind == "int8" else cq.fp8_scale(y)
            del y
        args = (x, e, q, seed, scale, w, M)
        kw = dict(kind=kind, with_ef=e is not None, wire=wire)
        return mc.cmix_flat(*args, **kw), mc.cmix_flat_plain(*args, **kw)

    def compare(x, e, kind, phase, topo, pods, wire, seed=7, q=None):
        nonlocal worst, cases
        (o, ef), (po, pef) = run(x, e, kind, phase, topo, pods, wire, seed,
                                 q)
        torch.cuda.synchronize()
        err = float((o - po).abs().max())
        if ef is not None:
            err = max(err, float((ef - pef).abs().max()))
        tol = 1e-6 * float(x.abs().max())
        if err > tol:
            raise AssertionError(
                f"cmix n={x.shape[0]} D={x.shape[1]} kind={kind} "
                f"phase={phase} wire={wire} ef={e is not None}: max abs err "
                f"{err:.3e} > {tol:.3e}")
        worst = max(worst, err)
        cases += 1

    def fixed_point(n, D, kind, comp=None):
        row = torch.randn(1, D, device="cuda", generator=gen)
        x = row.expand(n, D).contiguous()
        for phase, topo, pods, wire in phases:
            q = None
            if comp is not None:
                q = C.apply_tree(comp, {"w": x}, None, 5)[0]["w"]
            (o, _), _ = run(x, None, kind, phase, topo, pods, wire, 5, q)
            assert torch.equal(o, o[:1].expand_as(o)), (kind, phase)
            if topo == "one_peer_exp":
                assert torch.equal(o, x), (kind, phase)

    for n, width in ((4, RAGGED_D), (8, RAGGED_D), (32, RAGGED_D),
                     (MAIN_N, MAIN_D)):
        x = torch.randn(n, width, device="cuda", generator=gen)
        e = 0.01 * torch.randn(n, width, device="cuda", generator=gen)
        for kind in ("int8", "fp8"):
            for phase, topo, pods, wire in phases:
                for ef in (None, e):
                    compare(x, ef, kind, phase, topo, pods, wire)
        for name in ("topk", "randk"):
            comp = C.make_compressor(name, k=32)
            q = C.apply_tree(comp, {"w": x}, {"w": e}, 11)[0]["w"]
            for phase, topo, pods, wire in phases:
                compare(x, None, "precomputed", phase, topo, pods, wire,
                        q=q)
        del x, e
    for kind, name in (("int8", None), ("fp8", None),
                       ("precomputed", "topk"), ("precomputed", "randk")):
        comp = None if name is None else C.make_compressor(name, k=32)
        fixed_point(8, RAGGED_D, kind, comp)

    # the main path's call timed at the embedding leaf: int8, EF, gossip
    n, D = MAIN_N, MAIN_D
    x = torch.randn(n, D, device="cuda", generator=gen)
    e = 0.01 * torch.randn(n, D, device="cuda", generator=gen)
    w, M = mc._device_compensated("gossip", "one_peer_exp", n, 1, 1,
                                  torch.device("cuda"))
    scale = cq.int8_scale(x + e)
    args = (x, e, None, 7, scale, w, M)
    kw = dict(kind="int8", with_ef=True, wire=False)
    ms = cuda_ms(torch, lambda: mc.cmix_flat(*args, **kw))
    plain_ms = cuda_ms(torch, lambda: mc.cmix_flat_plain(*args, **kw),
                       iters=5, warmup=1)
    # the yardstick covers the mix part only: M·q at the same shape
    library_ms = cuda_ms(torch, lambda: torch.matmul(M, x))
    bytes_moved = 4 * 4 * n * D                 # read x, e; write o, ef
    flops = (2 * n + 12) * n * D                # codec + mix per element
    bound_ms, bound_by = _bound(bytes_moved, flops)
    print(f"[kernel] cmix int8+EF n={n} D={D}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.matmul(M, q) (the mix part only) "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
          f"({bytes_moved / (ms * 1e-3) / 1e9:.0f} GB/s achieved)",
          flush=True)
    print(f"[kernel] cmix: {cases} kernel-vs-plain cases within tolerance, "
          f"max abs err {worst:.3e}; constant fixed point bitwise for int8, "
          f"fp8, topk, randk", flush=True)
    return {"name": "cmix_kernel", "route": "cuda",
            "source": "src/repro_torch/csrc/cmix.cu",
            "replaces": "src/repro/kernels/mixing_pallas.py:504",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def check_collective_kernel(torch, mc) -> dict:
    """collective kernel vs its plain twin on the card: int8 and fp8,
    global and pod_avg (2 pods), error feedback on and off, n = 8 at
    D = 1,000,003 (a ragged last block, masked in the kernel and padded in
    the twin) and at the packed main-path width (int8 + EF, global: the
    main path's call).  The pod sum runs in one order in both and the
    scales are powers of two, so the tolerance is 1e-6·max|x| (measured
    error expected 0).  A constant state comes back bitwise for every
    kind and phase."""
    from repro_torch.compress import collective as ccol

    gen = torch.Generator(device="cuda").manual_seed(2)
    worst, cases = 0.0, 0
    n = MAIN_N
    s1, s2 = ccol.stage_seeds(7)

    def compare(x, e, kind, pods):
        nonlocal worst, cases
        kw = dict(kind=kind, with_ef=e is not None, n_pods=pods,
                  qblock=ccol.QBLOCK)
        o, ef = mc.collective_flat(x, e, s1, s2, **kw)
        po, pef = mc.collective_flat_plain(x, e, s1, s2, **kw)
        torch.cuda.synchronize()
        err = float((o - po).abs().max())
        if ef is not None:
            err = max(err, float((ef - pef).abs().max()))
        del po, pef
        tol = 1e-6 * float(x.abs().max())
        if err > tol:
            raise AssertionError(f"collective D={x.shape[1]} kind={kind} "
                                 f"pods={pods} ef={e is not None}: max abs "
                                 f"err {err:.3e} > {tol:.3e}")
        worst = max(worst, err)
        cases += 1
        return o, ef

    x = torch.randn(n, RAGGED_D, device="cuda", generator=gen)
    e = 0.01 * torch.randn(n, RAGGED_D, device="cuda", generator=gen)
    for kind in ("int8", "fp8"):
        for pods in (1, 2):
            for ef in (None, e):
                compare(x, ef, kind, pods)
        const = x[:1].expand(n, RAGGED_D).contiguous()
        for pods in (1, 2):
            o, _ = mc.collective_flat(const, None, s1, s2, kind=kind,
                                      with_ef=False, n_pods=pods,
                                      qblock=ccol.QBLOCK)
            assert torch.equal(o, const), (kind, pods)
        # written in place into a private buffer
        stage, stage_e = x.clone(), e.clone()
        o, ef = mc.collective_flat(stage, stage_e, s1, s2, kind=kind,
                                   with_ef=True, n_pods=1,
                                   qblock=ccol.QBLOCK, inplace=True)
        po, pef = mc.collective_flat_plain(x, e, s1, s2, kind=kind,
                                           with_ef=True, n_pods=1,
                                           qblock=ccol.QBLOCK)
        assert o.data_ptr() == stage.data_ptr()
        assert ef.data_ptr() == stage_e.data_ptr()
        assert torch.equal(o, po) and torch.equal(ef, pef)
        del const, stage, stage_e, o, ef, po, pef
    del x, e
    torch.cuda.empty_cache()

    D = MAIN_PACKED_D
    x = torch.randn(n, D, device="cuda", generator=gen)
    e = 0.01 * torch.randn(n, D, device="cuda", generator=gen)
    compare(x, e, "int8", 1)
    torch.cuda.empty_cache()
    kw = dict(kind="int8", with_ef=True, n_pods=1, qblock=ccol.QBLOCK)
    ms = cuda_ms(torch, lambda: mc.collective_flat(x, e, s1, s2, **kw),
                 iters=10, warmup=2)
    plain_ms = cuda_ms(torch, lambda: mc.collective_flat_plain(
        x, e, s1, s2, **kw), iters=2, warmup=1)
    bytes_moved = 4 * 4 * n * D                 # read x, e; write o, ef
    flops = 60 * n * D                          # two codecs, pod mean
    bound_ms, bound_by = _bound(bytes_moved, flops)
    print(f"[kernel] collective int8+EF n={n} D={D}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, no single PyTorch call computes it, "
          f"bound {bound_ms:.4f} ms by {bound_by} "
          f"({bytes_moved / (ms * 1e-3) / 1e9:.0f} GB/s achieved)",
          flush=True)
    print(f"[kernel] collective: {cases} kernel-vs-plain cases within "
          f"tolerance, max abs err {worst:.3e}; constant fixed point bitwise "
          f"for int8 and fp8, global and 2 pods; in place matches", flush=True)
    del x, e
    torch.cuda.empty_cache()
    return {"name": "collective_kernel", "route": "cuda",
            "source": "src/repro_torch/csrc/collective.cu",
            "replaces": "src/repro/kernels/mixing_pallas.py:765",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


COMPRESSED = dict(comm_compression="int8", comm_global_compression="int8",
                  comm_error_feedback=True)


def counts(mc) -> dict:
    return {"mix": mc.mix_flat.launches, "cmix": mc.cmix_flat.launches,
            "collective": mc.collective_flat.launches}


def reset_counts(mc) -> None:
    mc.mix_flat.launches = 0
    mc.cmix_flat.launches = 0
    mc.collective_flat.launches = 0


def run_main_path(torch, mc, compressed: bool = False):
    """One main path at full width for 6 steps; returns ``(launches per
    kernel, trainer, state)``.  Slice 1: fused rounds with the consensus
    residual.  Slice 2 (``compressed``): int8 gossip + int8 collective
    with error feedback."""
    from repro_torch.configs import (DistConfig, OptimizerConfig,
                                     TrainConfig, get_model_config)
    from repro_torch.train import Trainer
    from repro_torch.tree import tree_leaves

    steps, n_nodes = 6, 8
    tag = "[cmain]" if compressed else "[main]"
    tcfg = TrainConfig(
        model=get_model_config("pga-lm-100m"),
        dist=DistConfig(algorithm="gossip_pga", topology="one_peer_exp",
                        H=3, comm_backend="pallas",
                        **(COMPRESSED if compressed else {})),
        # total_steps covers the profiled step after the 6 (lr > 0 there)
        optimizer=OptimizerConfig(name="adamw", lr=3e-4,
                                  schedule="warmup_cosine", warmup_steps=2,
                                  total_steps=steps + 2),
        global_batch=32, seq_len=512, steps=steps, log_every=1)
    tr = Trainer(tcfg, n_nodes=n_nodes, with_consensus=True)
    state = tr.init_state(torch.Generator().manual_seed(0))
    leaves = tree_leaves(state.params)
    per_node = sum(p.numel() for p in leaves) // n_nodes
    groups = mc._dispatch_groups(leaves, tcfg.dist.pallas_leaf_threshold)
    if compressed:
        print(f"{tag} pga-lm-100m compressed: {per_node:,} params per node,"
              f" {n_nodes} nodes, {len(leaves)} leaves (one cmix launch "
              f"each per gossip round), one collective launch per global "
              f"round over {per_node:,} packed columns", flush=True)
    else:
        widths = [sum(leaves[i][0].numel() for i in g) for g in groups]
        print(f"{tag} pga-lm-100m: {per_node:,} params per node, {n_nodes} "
              f"nodes, {len(groups)} kernel launches per round (group "
              f"widths {widths})", flush=True)
    tokens = tcfg.global_batch * tcfg.seq_len
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(mc)
    times, phases = [], []
    for k in range(steps):
        t0 = time.perf_counter()
        state = tr.run(state, steps=1, log_every=1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        times.append(dt)
        rec = tr.history[-1]
        phases.append(rec["phase"])
        print(f"{tag} step {k} phase={rec['phase']} loss={rec['loss']:.4f}"
              f" consensus={rec['consensus']:.6e} step_ms={dt * 1e3:.1f} "
              f"tokens/s={tokens / dt:.0f} max_mem_GB="
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} launches="
              f"{counts(mc)}", flush=True)
        if not math.isfinite(rec["loss"]):
            raise AssertionError(f"step {k}: loss {rec['loss']}")
        if rec["phase"] == "global" and not compressed:
            assert rec["consensus"] == 0.0, rec
        else:
            # a compressed global round keeps each node's own state at full
            # precision: the nodes differ by their stage-1 residuals
            assert rec["consensus"] > 0.0, rec
    launches = counts(mc)
    gossip, glob = phases.count("gossip"), phases.count("global")
    expected = ({"mix": 0, "cmix": gossip * len(leaves), "collective": glob}
                if compressed else
                {"mix": len(groups) * steps, "cmix": 0, "collective": 0})
    if launches != expected:
        raise AssertionError(f"{tag} launches {launches} on the main path, "
                             f"expected {expected} ({gossip} gossip and "
                             f"{glob} global steps)")
    if compressed:
        ef_abs = sum(float(e.abs().sum()) for e in tree_leaves(state.ef_state))
        assert ef_abs > 0.0 and math.isfinite(ef_abs), ef_abs
        print(f"{tag} ef_state sum |e| = {ef_abs:.6e} (non-zero, finite)",
              flush=True)
    steady = statistics.median(times[1:])
    print(f"{tag} {steps} steps through the kernels ({launches}); steady "
          f"step {steady * 1e3:.1f} ms (median of steps 1-5), "
          f"{tokens / steady:.0f} tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    return launches, tr, state


KERNEL_KINDS = (("mix round", ("mix_kernel", "sum_partials")),
                ("matmul", ("gemm", "xmma", "cutlass", "cublas", "nvjet")),
                ("softmax", ("softmax",)),
                ("reduction", ("reduce",)),
                ("elementwise", ("elementwise", "vectorized", "copy",
                                 "fill", "index", "cat", "gather",
                                 "scatter")))


def where_time_goes(torch, mc, tr, state) -> None:
    """One fused round timed alone against its bound, forward+backward and
    clip+AdamW timed alone, then one more steady step under
    ``torch.profiler``: device busy share of the step's wall time, device
    time by kernel kind and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.optim import clip_by_global_norm, make_optimizer
    from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

    dist = tr.tcfg.dist
    leaves = tree_leaves(state.params)

    def one_round():
        mc.mix_residual(state.params, phase="gossip",
                        topology=dist.topology, n_nodes=tr.n_nodes,
                        leaf_threshold=dist.pallas_leaf_threshold)

    round_ms = cuda_ms(torch, one_round, iters=10, warmup=2)
    moved = sum(4 * (2 * p.numel() + p[0].numel()) for p in leaves)
    print(f"[round] one fused gossip round with residual over all "
          f"{len(leaves)} leaves: {round_ms:.3f} ms, bound "
          f"{moved / HBM_BYTES_PER_S * 1e3:.3f} ms ({moved / 1e9:.2f} GB)",
          flush=True)
    batch = tr.device_batch(0)

    def fwd_bwd():
        flat, treedef = tree_flatten(state.params)
        live = [p.detach().requires_grad_(True) for p in flat]
        with torch.enable_grad():
            losses, _ = tr.model.node_losses(tree_unflatten(treedef, live),
                                             batch, remat="default")
            grads = torch.autograd.grad(losses.sum(), live)
        return tree_unflatten(treedef, list(grads))

    fb_ms = cuda_ms(torch, fwd_bwd, iters=3, warmup=1)
    grads = fwd_bwd()
    opt = make_optimizer(tr.tcfg.optimizer)

    def update():
        g = clip_by_global_norm(grads, tr.tcfg.optimizer.grad_clip)
        opt.update(g, state.opt_state, state.params, 3e-4)

    up_ms = cuda_ms(torch, update, iters=3, warmup=1)
    del grads
    print(f"[split] forward+backward {fb_ms:.1f} ms, clip+AdamW "
          f"{up_ms:.1f} ms, fused round {round_ms:.1f} ms (each timed "
          f"alone by CUDA events)", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.run(state, steps=1, log_every=1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    busy = sum(t for t, _ in by_name.values())
    print(f"[profile] profiled step: wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%), "
          f"{sum(c for _, c in by_name.values())} device events",
          flush=True)
    kinds = {}
    for name, (t, _) in by_name.items():
        low = name.lower()
        kind = next((k for k, keys in KERNEL_KINDS
                     if any(key in low for key in keys)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + t
    for kind, t in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {kind:12s} {t:9.3f} ms "
              f"({100 * t / max(busy, 1e-9):.1f}% of device time)",
              flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (t, c) in top:
        print(f"[profile] {t:9.3f} ms {c:5d}x {name[:100]}", flush=True)


def compressed_round_times(torch, mc, tr, state) -> None:
    """One compressed gossip round (int8 + EF, one cmix launch per leaf)
    and one compressed global round (packing, one collective launch,
    unpacking), each timed alone by CUDA events against the bytes bound
    of its kernels (read x and e, write o and e')."""
    from repro_torch import compress as C
    from repro_torch.tree import tree_leaves

    dist = tr.tcfg.dist
    comp = C.make_compressor(dist.comm_compression)
    gcomp = C.make_compressor(dist.comm_global_compression)
    leaves = tree_leaves(state.params)
    moved = sum(4 * 4 * p.numel() for p in leaves)
    bound = moved / HBM_BYTES_PER_S * 1e3

    def gossip():
        mc.compressed_step_mix(state.params, compressor=comp,
                               ef_state=state.ef_state, seed=3,
                               phase="gossip", topology=dist.topology,
                               n_nodes=tr.n_nodes, step=1)

    def global_round():
        mc.collective_step_mix(state.params, compressor=gcomp,
                               ef_state=state.ef_state, seed=3,
                               phase="global", n_nodes=tr.n_nodes)

    g_ms = cuda_ms(torch, gossip, iters=5, warmup=1)
    c_ms = cuda_ms(torch, global_round, iters=5, warmup=1)
    print(f"[cround] one compressed gossip round (int8+EF, {len(leaves)} "
          f"cmix launches): {g_ms:.3f} ms; one compressed global round "
          f"(pack, collective, unpack): {c_ms:.3f} ms; bound of each "
          f"{bound:.3f} ms ({moved / 1e9:.2f} GB)", flush=True)


def _cross_config(compressed: bool):
    from repro_torch.configs import (DistConfig, OptimizerConfig,
                                     TrainConfig, get_model_config)

    model = dataclasses.replace(
        get_model_config("pga-lm-100m", reduced=True), dtype="float32")
    return TrainConfig(
        model=model,
        dist=DistConfig(algorithm="gossip_pga", topology="one_peer_exp",
                        H=2, comm_backend="pallas",
                        **(COMPRESSED if compressed else {})),
        optimizer=OptimizerConfig(name="sgd", lr=0.05, schedule="constant",
                                  warmup_steps=0),
        global_batch=8, seq_len=64, log_every=1)


def cross_check(torch, compressed: bool = False) -> None:
    """Reduced config at fp32 compute, 4 nodes, 3 steps (gossip, global,
    gossip), card (kernels) vs CPU (plain versions) from one init.
    Nesterov SGD keeps the update linear in the gradient, so the two runs
    differ only by fp32 summation order: params agree to rtol 1e-4, atol
    1e-6, per-step loss/consensus to rtol 1e-4.  (AdamW's sqrt(v) + eps
    normalisation would turn near-zero gradient noise into updates of up
    to lr; its port is checked against JAX in tests/test_torch_train.py.)

    Compressed (int8 gossip and collective, EF): stochastic rounding turns
    a summation-order difference that lands on a code boundary into one
    code step of the leaf (its absmax/127; a power-of-two step of the
    collective is up to two of them), which error feedback and the next
    rounds carry on.  So all but 1e-4 of the params and EF elements agree
    to rtol 1e-4, atol 1e-6, and every one is finite and within 8 code
    steps of its leaf (steps from the CPU run's params); loss rtol 1e-4;
    consensus rtol 1e-2 (each flipped code moves it by about a squared code
    step, and a few dozen flips of a reduced run's 1e-2 consensus reach
    1e-3).
    """
    import numpy as np

    from repro_torch import interop
    from repro_torch.models.model import make_model
    from repro_torch.train import Trainer
    from repro_torch.tree import tree_leaves

    tcfg = _cross_config(compressed)
    init = interop.to_numpy(make_model(tcfg.model).init(
        torch.Generator().manual_seed(1), "cpu"))
    runs = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(tcfg, n_nodes=4, with_consensus=True, device=dev)
        st = tr.init_state(params=interop.from_numpy(init, dev))
        st = tr.run(st, steps=3, log_every=1)
        trees = [st.params] + ([st.ef_state] if compressed else [])
        runs[dev] = ([interop.to_numpy(t) for t in trees], tr.history)
    worst, off, size, steps = 0.0, 0, 0, 0.0
    cpu_params = tree_leaves(runs["cpu"][0][0])
    for ta, tb in zip(runs["cuda"][0], runs["cpu"][0]):
        for a, b, p in zip(tree_leaves(ta), tree_leaves(tb), cpu_params):
            assert np.isfinite(a).all() and np.isfinite(b).all()
            d = np.abs(a - b)
            worst = max(worst, float(d.max()))
            size += a.size
            if compressed:
                off += int((d > 1e-6 + 1e-4 * np.abs(b)).sum())
                steps = max(steps, float(d.max()) / (
                    float(np.abs(p).max()) / 127.0))
            else:
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    if compressed and (off > 1e-4 * size or steps > 8.0):
        raise AssertionError(f"compressed cross-check: {off} of {size} "
                             f"elements off, max abs diff {worst:.3e} = "
                             f"{steps:.2f} code steps")
    for ra, rb in zip(runs["cuda"][1], runs["cpu"][1]):
        assert ra["phase"] == rb["phase"]
        np.testing.assert_allclose(ra["loss"], rb["loss"], rtol=1e-4)
        np.testing.assert_allclose(ra["consensus"], rb["consensus"],
                                   rtol=1e-2 if compressed else 1e-4)
    what = ("compressed int8+EF trainer (params and EF)" if compressed
            else "trainer")
    print(f"[cross] reduced fp32 {what}, cuda vs cpu over 3 steps: max abs "
          f"diff {worst:.3e} ({steps:.2f} code steps of its leaf), {off} of "
          f"{size} elements beyond rtol 1e-4 + "
          f"atol 1e-6; losses {[round(r['loss'], 6) for r in runs['cuda'][1]]}"
          f", consensus cuda {[r['consensus'] for r in runs['cuda'][1]]} cpu "
          f"{[r['consensus'] for r in runs['cpu'][1]]}", flush=True)


def main() -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels, then stop (no main "
                         "paths, no ok line)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import mixing_cuda as mc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    print(f"[device] {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.perf_counter()
    cuda_build.build()
    print(f"[build] {', '.join(f'{k}.cu' for k in cuda_build.ENTRY_POINTS)} "
          f"in {time.perf_counter() - t0:.1f} s, one nvcc each in parallel "
          f"({cuda_build._Libs.build_seconds})", flush=True)
    for name, log in cuda_build._Libs.build_log.items():
        print(f"[build] {name}.cu:\n{log.strip()}", flush=True)
    records = [check_mix_kernel(torch, mc)]
    torch.cuda.empty_cache()
    records.append(check_cmix_kernel(torch, mc))
    torch.cuda.empty_cache()
    records.append(check_collective_kernel(torch, mc))
    torch.cuda.empty_cache()
    if args.kernels_only:
        print(json.dumps({"kernels": records}))
        return 1
    slice1, tr, state = run_main_path(torch, mc)
    where_time_goes(torch, mc, tr, state)
    del tr, state
    torch.cuda.empty_cache()
    slice2, tr, state = run_main_path(torch, mc, compressed=True)
    compressed_round_times(torch, mc, tr, state)
    del tr, state
    torch.cuda.empty_cache()
    records[0]["launches"] = slice1["mix"]
    records[1]["launches"] = slice2["cmix"]
    records[2]["launches"] = slice2["collective"]
    cross_check(torch)
    cross_check(torch, compressed=True)
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
