#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises, so the run exits non-zero and prints no ok
line):

1. device and build: the card's name and power limit, the torch/CUDA
   versions, and the mixing kernel built from ``csrc/mix.cu`` with its
   ``-Xptxas -v`` report;
2. every kernel against its plain PyTorch version on the card, at ragged
   and main-path shapes, with the tolerances stated in
   :func:`check_mix_kernel`; timing by CUDA events against the kernel's
   memory bound and one PyTorch library call;
3. the main path: the decentralized ``Trainer`` on pga-lm-100m at full
   width (8 nodes stacked on the card, Gossip-PGA with H = 3 over the
   one-peer exponential graph, fused kernel mixing with the consensus
   residual, AdamW, global batch 32 × seq 512, 6 steps), with every
   kernel's launch count read around it;
   then one fused round timed alone and one more step under
   ``torch.profiler`` (where the device time goes);
4. the same trainer at the reduced config with fp32 compute, on the card
   (kernel) and on the CPU (plain versions) from one init, compared.

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
    bound_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_flops = flops / FP32_FLOP_PER_S * 1e3
    print(f"[kernel] mix n={n} D={D} residual: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.matmul(W, x) {library_ms:.4f} ms, "
          f"bound {max(bound_bytes, bound_flops):.4f} ms "
          f"({bytes_moved / (ms * 1e-3) / 1e9:.0f} GB/s achieved)",
          flush=True)
    print(f"[kernel] {cases} kernel-vs-plain cases within tolerance, "
          f"max abs err {worst:.3e}", flush=True)
    return {"name": "mix_kernel", "route": "cuda",
            "source": "src/repro_torch/csrc/mix.cu",
            "replaces": "src/repro/kernels/mixing_pallas.py:215",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bound_bytes, bound_flops),
            "bound_by": "bytes" if bound_bytes >= bound_flops
            else "operations",
            "library_ms": library_ms}


def run_main_path(torch, mc):
    from repro_torch.configs import (DistConfig, OptimizerConfig,
                                     TrainConfig, get_model_config)
    from repro_torch.train import Trainer
    from repro_torch.tree import tree_leaves

    steps, n_nodes = 6, 8
    tcfg = TrainConfig(
        model=get_model_config("pga-lm-100m"),
        dist=DistConfig(algorithm="gossip_pga", topology="one_peer_exp",
                        H=3, comm_backend="pallas"),
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
    print(f"[main] pga-lm-100m: {per_node:,} params per node, {n_nodes} "
          f"nodes, {len(groups)} kernel launches per round (group widths "
          f"{[sum(leaves[i][0].numel() for i in g) for g in groups]})",
          flush=True)
    tokens = tcfg.global_batch * tcfg.seq_len
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mc.mix_flat.launches = 0
    times = []
    for k in range(steps):
        t0 = time.perf_counter()
        state = tr.run(state, steps=1, log_every=1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        times.append(dt)
        rec = tr.history[-1]
        print(f"[main] step {k} phase={rec['phase']} loss={rec['loss']:.4f}"
              f" consensus={rec['consensus']:.6e} step_ms={dt * 1e3:.1f} "
              f"tokens/s={tokens / dt:.0f} max_mem_GB="
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f}", flush=True)
        if not math.isfinite(rec["loss"]):
            raise AssertionError(f"step {k}: loss {rec['loss']}")
        if rec["phase"] == "global":
            assert rec["consensus"] == 0.0, rec
        else:
            assert rec["consensus"] > 0.0, rec
    launches = mc.mix_flat.launches
    expected = len(groups) * steps
    if launches != expected:
        raise AssertionError(f"mix kernel launched {launches} times on the "
                             f"main path, expected {expected}")
    steady = statistics.median(times[1:])
    print(f"[main] {steps} steps through the kernel ({launches} launches); "
          f"steady step {steady * 1e3:.1f} ms (median of steps 1-5), "
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


def cross_check(torch) -> None:
    """Reduced config at fp32 compute, 4 nodes, 3 steps (gossip, global,
    gossip), card (kernel) vs CPU (plain versions) from one init.  Nesterov
    SGD keeps the update linear in the gradient, so the two runs differ
    only by fp32 summation order: params agree to rtol 1e-4, atol 1e-6,
    per-step loss/consensus to rtol 1e-4.  (AdamW's sqrt(v) + eps
    normalisation would turn near-zero gradient noise into updates of up
    to lr; its port is checked against JAX in tests/test_torch_train.py.)
    """
    import numpy as np

    from repro_torch import interop
    from repro_torch.configs import (DistConfig, OptimizerConfig,
                                     TrainConfig, get_model_config)
    from repro_torch.models.model import make_model
    from repro_torch.train import Trainer

    lr = 0.05
    model = dataclasses.replace(
        get_model_config("pga-lm-100m", reduced=True), dtype="float32")
    tcfg = TrainConfig(
        model=model,
        dist=DistConfig(algorithm="gossip_pga", topology="one_peer_exp",
                        H=2, comm_backend="pallas"),
        optimizer=OptimizerConfig(name="sgd", lr=lr, schedule="constant",
                                  warmup_steps=0),
        global_batch=8, seq_len=64, log_every=1)
    init = interop.to_numpy(make_model(model).init(
        torch.Generator().manual_seed(1), "cpu"))
    runs = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(tcfg, n_nodes=4, with_consensus=True, device=dev)
        st = tr.init_state(params=interop.from_numpy(init, dev))
        st = tr.run(st, steps=3, log_every=1)
        runs[dev] = (interop.to_numpy(st.params), tr.history)
    worst = 0.0
    from repro_torch.tree import tree_leaves
    for a, b in zip(tree_leaves(runs["cuda"][0]),
                    tree_leaves(runs["cpu"][0])):
        worst = max(worst, float(np.abs(a - b).max()))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    for ra, rb in zip(runs["cuda"][1], runs["cpu"][1]):
        assert ra["phase"] == rb["phase"]
        for key in ("loss", "consensus"):
            np.testing.assert_allclose(ra[key], rb[key], rtol=1e-4)
    print(f"[cross] reduced fp32 trainer, cuda vs cpu over 3 steps: params "
          f"max abs diff {worst:.3e} (atol 1e-6), losses "
          f"{[round(r['loss'], 6) for r in runs['cuda'][1]]}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import mixing_cuda as mc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    print(f"[device] {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.perf_counter()
    mc.build()
    print(f"[build] mix.cu in {time.perf_counter() - t0:.1f} s (nvcc "
          f"{mc._Lib.build_seconds:.1f} s)\n{mc._Lib.build_log.strip()}",
          flush=True)
    record = check_mix_kernel(torch, mc)
    torch.cuda.empty_cache()
    record["launches"], tr, state = run_main_path(torch, mc)
    where_time_goes(torch, mc, tr, state)
    del tr, state
    torch.cuda.empty_cache()
    cross_check(torch)
    print(card)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
