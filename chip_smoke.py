#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises, so the run exits non-zero and prints no ok
line):

1. device and build: the card's name and power limit, the torch/CUDA
   versions, and the ten kernel libraries built from
   ``src/repro_torch/csrc/`` (``mix.cu``, ``cmix.cu``, ``collective.cu``,
   ``mlstm.cu``, ``mlstm_wgmma.cu``, ``shard_mix.cu``, ``shard_cmix.cu``,
   ``flash_attention.cu``, ``flash_attention_wgmma.cu``, ``rmsnorm.cu``;
   one nvcc each, all at once) with their ``-Xptxas -v`` reports, the
   count of ``HGMMA`` (tensor-core) instructions in the SASS of the two
   tensor-core kernels (flash attention, mLSTM), and the registers and
   spills of the mix and cmix register instances (with their global and
   shared loads and stores) and of the tensor-core mLSTM kernel;
2. every kernel against its plain PyTorch version on the card, at ragged
   and main-path shapes, each case on the instance its dispatch rule
   picks (the mix and cmix register instances also bitwise against the
   generic ones), with the tolerances stated in
   :func:`check_mix_kernel`, :func:`check_cmix_kernel` (with the
   compressed round's row maxima, :func:`check_absmax`),
   :func:`check_collective_kernel`, :func:`check_mlstm_kernel`,
   :func:`check_shard_mix_kernel`, :func:`check_shard_cmix_kernel`,
   :func:`check_flash_kernel` and :func:`check_rmsnorm_kernel`; timing by
   CUDA events against the kernel's bound and, where one exists, one
   PyTorch library call (``--kernels-only`` stops here);
3. slice 5's path (``[ops]``, :func:`run_ops_path`): the substrate entry
   points ``repro_torch.kernels.ops`` at full width (pga-lm-100m's and
   gemma2-9b's attention and norm calls, the xlstm-125m mLSTM call, and
   pga-lm-100m's attention and the mLSTM call in float32), one launch of
   the right kernel per call and no plain twin;
4. slice 1's main path: the decentralized ``Trainer`` on pga-lm-100m at
   full width (8 nodes stacked on the card, Gossip-PGA with H = 3 over
   the one-peer exponential graph, fused kernel mixing with the consensus
   residual, AdamW, global batch 32 × seq 512, 6 steps), with every
   kernel's launch count set to 0 just before it and read just after;
   then one fused round timed alone and one more step under
   ``torch.profiler`` (where the device time goes);
5. slice 2's main path: the same trainer with compressed Gossip-PGA
   (int8 gossip rounds and int8 compressed collective, error feedback),
   its launch counts read the same way, then one compressed gossip round
   and one compressed global round timed alone;
6. slice 3's main path: serving xlstm-125m at full width through the
   tensor-core mLSTM kernel (:func:`run_serving_path`: ``Engine.generate``
   and ``BatchedServer.run``), its launch counts read the same way;
7. slice 4's main paths: the same trainer on a mesh of 4 node shards
   (2 nodes each) on the card, ``comm_shard_mode="sharded"``, every round
   shard by shard through the per-shard kernels: uncompressed with the
   consensus residual (``[smain]``), then int8 gossip + int8 collective
   with error feedback (``[scmain]``), launch counts read the same way;
   then one sharded round of each kind timed beside its stacked
   counterpart (``[sround]``).  The shards share one card: this measures
   the per-shard kernels and the decomposition, not an interconnect;
8. the trainers and the server at reduced configs with fp32 compute, on
   the card (kernels) and on the CPU (plain versions) from one init,
   compared; the sharded trainers also against the stacked ones on the
   card (``[scross]``); and the trainer with each of ``[algos]``' four
   algorithms below, 6 steps (``[xalgos]``);
9. slice 7's paths.  ``[sim]`` (:func:`run_sim_path`): the paper's §5.1
   protocol through ``repro_torch.core.simulate(backend="pallas")`` at
   n = 100, M = 8000, d = 10 (ring, H = 16, lr 0.2 halved every 1000
   steps, batch 8, 3000 steps) for all eight algorithms, each with its
   launch counts against the dispatch rule, no plain-twin call, and the
   consensus after the global rounds an eval falls on; the suboptimality
   AUC against parallel SGD (f* by full-batch gradient descent here);
   one compressed run at the same size (int8 gossip + EF, int8
   collective); then the non-IID crossover of
   ``benchmarks/bench_logistic_transient.py`` with its two gates.
   ``[simx]`` (:func:`run_sim_cross_check`): ``simulate`` on the card
   against the CPU at n = 16 with full gradients, held to the CPU tests'
   tolerances, the compressed runs' iterates bitwise.
   ``[algos]`` (:func:`run_algo_path`): the Trainer at full width with
   SlowMo, Hier-PGA, GT-PGA and Gossip-AGA, 6 steps each, phases against
   the schedule, launch counts against the dispatch rule, step ms and
   peak memory;
10. slice 8's paths, push-sum gossip with fault injection: the Trainer
   at full width over directed_exp with ``push_sum=True`` and a
   :class:`repro_torch.core.faults.FaultSchedule` (nodes 2 and 5 down at
   steps 1–3, per-node hops), stacked (``[psmain]``, mix.cu on a runtime
   W), with int8 gossip + EF (``[pscmain]``, cmix.cu and its row maxima)
   and on a mesh of 4 node shards (``[spsmain]``, shard_mix.cu over the
   static halo; its rounds timed beside the stacked ones): the mass
   ``Σw`` within 8e-5 of 8 after every step, ``w`` bitwise ones after the
   full global round, the dropped nodes' rows bitwise frozen, the
   synchronizing calls per step against ``[main]``'s; the three at a
   reduced config card vs CPU (``[pscross]``); ``[psim]``: ``simulate``
   with push-sum and faults, the reference's acceptance scenario card vs
   CPU and the §5.1 problem at n = 100 over the directed ring.  The
   kernel checks of phase 2 also hold mix, cmix and shard_mix on factors
   built on the card from a runtime W at these paths' shapes.

Every kernel's record must show launches on a main path.  The last three
lines of standard output are the card's name and power limit, one JSON
object with the kernel records, and the ok line.  The
script imports nothing of JAX: the card's machine has none.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
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
BF16_TC_FLOP_PER_S = 989e12         # dense bf16 on the tensor cores
SPIN_CYCLES = 200_000_000           # ~0.1 s of torch.cuda._sleep
MAIN_N, MAIN_D = 8, 25_165_824      # the embedding leaf of pga-lm-100m
# every launch width of the main path's round: the staging buffer of the
# norms, the attention projections, the embedding, the MLP matrices
MAIN_WIDTHS = (19_200, 7_077_888, MAIN_D, 28_311_552)
RAGGED_D = 1_000_003
# the simulator's round operands ([sim] at n = 100, [simx] and the non-IID
# crossover at 16, d = 10; GT-PGA's joint tree is 2d wide)
SIM_MIX_SHAPES = ((16, 10), (16, 20), (100, 10), (100, 20))
SIM_COMP_SHAPES = ((16, 10), (32, 10), (100, 10))
MAIN_PACKED_D = 138_431_232         # every parameter of one node, packed
# the push-sum paths' round operands (slice 8): the staging group of the
# norms with the weight column (19,201: not a multiple of 4, so the
# generic instance), the large leaves, and the simulator's joint (x, w)
# trees ([psim]: d = 6 at n = 16, d = 10 at n = 100)
PUSH_MIX_SHAPES = ((8, 19_201), (8, 7_077_888), (8, MAIN_D),
                   (8, 28_311_552), (16, 7), (100, 11))


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def hgmma_count(cuda_build, name: str) -> str:
    """The count of tensor-core (``HGMMA``) instructions in the SASS of
    the library ``name`` (a tensor-core kernel's), by ``cuobjdump -sass``;
    raises if there are none."""
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / \
        "cuobjdump"
    if not tool.exists():
        return "cuobjdump absent, HGMMA instructions not counted"
    lib = cuda_build._lib_path(name)
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    n = sum("HGMMA" in line for line in sass.splitlines())
    if n == 0:
        raise AssertionError(f"{name}.cu: no HGMMA in its SASS")
    return f"{n} HGMMA instructions in its SASS (cuobjdump -sass)"


# the generic and the main path's register instance of each round, by a
# piece of their mangled names: mix with the residual (no g, no wire);
# cmix int8 with error feedback (no wire)
SASS_KERNELS = {"mix": (("mix_kernel", "10mix_kernelE"),
                        ("mix_vector_kernel<8, residual>",
                         "mix_vector_kernelILi8ELb0ELb0ELb1E")),
                "cmix": (("cmix_kernel<int8, EF>", "cmix_kernelILi0ELb1ELb0E"),
                         ("cmix_vector_kernel<8, int8, EF>",
                          "cmix_vector_kernelILi8ELi0ELb1ELb0E"))}


def sass_memory_counts(cuda_build, name: str) -> list:
    """One line per kernel of :data:`SASS_KERNELS` ``[name]``: its global
    and shared loads and stores in the library's SASS, by ``cuobjdump
    -sass`` (static counts: a loop's body counts once; the register
    instance's body is one group of columns)."""
    import re

    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / \
        "cuobjdump"
    if not tool.exists():
        return ["cuobjdump absent, instructions not counted"]
    sass = subprocess.run([str(tool), "-sass", str(cuda_build._lib_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = dict.fromkeys(("LDG", "STG", "LDS", "STS"), 0)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                      line)
        if fn and m and m.group(1) in counts[fn]:
            counts[fn][m.group(1)] += 1
    lines = []
    for label, piece in SASS_KERNELS[name]:
        found = [c for f, c in counts.items() if piece in f]
        if len(found) != 1:
            raise AssertionError(f"{name}.cu: {len(found)} SASS functions "
                                 f"match {piece}")
        lines.append(f"{label}: " + ", ".join(f"{k} {v}"
                                             for k, v in found[0].items()))
    return lines


def register_report(log: str, kernel: str) -> list:
    """One line per instance of ``kernel`` in an ``nvcc -Xptxas -v``
    report: its template arguments, registers and spill bytes.  Raises if
    there is none, or if an instance at n = 8 (the main path's) spills."""
    lines, name, frame = [], None, None
    for raw in log.splitlines():
        if "Compiling entry function" in raw:
            name = raw.split("'")[1]
            frame = None
        elif name and "bytes spill stores" in raw:
            frame = raw.strip()
        elif name and frame and "Used" in raw and "registers" in raw \
                and kernel in name:
            regs = raw.split("Used")[1].split("registers")[0].strip()
            args = name.split(kernel, 1)[1]
            spill = [int(t) for t in frame.replace(",", " ").split()
                     if t.isdigit()]
            lines.append(f"{kernel}<{args[:40]}>: {regs} registers, "
                         f"{frame}")
            if args.startswith("ILi8E") and any(spill[1:]):
                raise AssertionError(f"{kernel}{args}: spills at n = 8: "
                                     f"{frame}")
            name = None
    if not lines:
        raise AssertionError(f"no ptxas report of {kernel}")
    return lines


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


def device_ms(torch, fn, iters=20, warmup=3) -> float:
    """Time per call of ``fn`` on the card, by CUDA events around
    ``iters`` calls that the host queued while a spin kernel
    (``torch.cuda._sleep``) held the stream: the card then runs them back
    to back, whatever the host's launch rate.  :func:`cuda_ms` times the
    host instead when a call is shorter on the card than in the Python
    wrapper.  Raises if the host took longer to queue the calls than the
    spin lasted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin, before, start, end = (torch.cuda.Event(enable_timing=True)
                                for _ in range(4))
    spin.record()
    torch.cuda._sleep(SPIN_CYCLES)
    before.record()
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    if not host_ms < spin.elapsed_time(before):
        raise AssertionError(f"device_ms: queueing took {host_ms:.2f} ms, "
                             f"longer than the {spin.elapsed_time(before):.2f}"
                             f" ms spin")
    return start.elapsed_time(end) / iters


def _bound(bytes_moved: float, flops: float):
    """``(bound_ms, bound_by)``: the larger of the bytes over the HBM rate
    and the fp32 operations over the card's fp32 rate."""
    b = bytes_moved / HBM_BYTES_PER_S * 1e3
    f = flops / FP32_FLOP_PER_S * 1e3
    return max(b, f), "bytes" if b >= f else "operations"


def _turns(torch, old, new) -> tuple:
    """``(old ms, new ms)`` by :func:`device_ms`, timed in turns (old, new,
    new, old) and averaged per version."""
    o1, n1, n2, o2 = (device_ms(torch, f) for f in (old, new, new, old))
    return (o1 + o2) / 2, (n1 + n2) / 2


def push_matrices(n: int) -> list:
    """Two runtime push-sum matrices at n nodes, float32 numpy: a gossip
    round with nodes 1 and n − 2 down and every node on its own drawn hop
    (renormalized, non-dyadic columns), and the global round over the
    other nodes."""
    import numpy as np

    from repro_torch.core import topology as topo
    from repro_torch.core.faults import FaultSchedule

    fs = FaultSchedule(n_nodes=n, drops={0: (1, n - 2)}, resample="peer",
                       seed=3)
    t = "directed_exp" if n & (n - 1) == 0 else "directed_ring"
    return [W.astype(np.float32)
            for W in (fs.matrix(t, 0),
                      topo.global_push_matrix(n, fs.active_mask(0)))]


def check_mix_kernel(torch, mc) -> dict:
    """Kernel vs plain version, each case on the instance that
    ``use_vector_mix`` picks.  Tolerances: max|o − o_plain| and
    max|x̄ − x̄_plain| ≤ 1e-5·max|x| (the plain version's matmul sums the
    n terms in another order than the kernel's loop), residual relative
    error ≤ 1e-5 (another summation order over D columns), and the rows
    of a global round bitwise equal with a residual of exactly 0.  Where
    the register instance takes a case, it also runs on the generic
    instance: o and x̄ bitwise equal, and the register instance's residual
    bitwise the same in two runs.  For n not a power of two the mean of n
    equal rows is not always exact, so a global round's residual is held
    to n·D·(2⁻²⁰·max|o|)² instead of 0.  The simulator's shapes ([sim],
    [simx]: n = 16 and 100 at D = 10, and D = 20 for GT-PGA's joint tree)
    run on a ring with and without the half-step and the residual.  The
    push-sum rounds (:data:`PUSH_MIX_SHAPES`) run with d and M built on
    the card from two runtime matrices (:func:`push_matrices`), fp32 and
    bf16 wire."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    gamma = torch.tensor([0.05], device="cuda")
    worst = 0.0
    cases = vector_cases = 0

    def compare(x, g, d, M, with_g, with_residual, wire, bitwise_rows,
                inplace=False):
        nonlocal worst, cases, vector_cases
        args = (x, g if with_g else None, gamma if with_g else None, d, M)
        kw = dict(with_g=with_g, with_residual=with_residual, wire=wire)
        vector = mc.use_vector_mix(x, g if with_g else None)
        if inplace:
            stage = x.clone()
            out = mc.mix_flat(stage, *args[1:], **kw, inplace=True)
            assert (out[0] if with_residual else out).data_ptr() == \
                stage.data_ptr()
        else:
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
                n, width = x.shape
                cap = (0.0 if n & (n - 1) == 0 else
                       n * width * (2.0 ** -20 * float(o.abs().max())) ** 2)
                assert 0.0 <= float(out[2]) <= cap, (float(out[2]), cap)
            elif rel > 1e-5:
                raise AssertionError(f"residual rel err {rel:.3e}")
        if err > tol:
            raise AssertionError(
                f"mix kernel n={x.shape[0]} D={x.shape[1]} {kw} vector="
                f"{vector}: max abs err {err:.3e} > {tol:.3e}")
        if bitwise_rows:
            assert torch.equal(o, o[:1].expand_as(o)), "global rows differ"
        if vector:
            if inplace:
                stage = x.clone()
                old = mc.mix_generic(stage, *args[1:], **kw, inplace=True)
            else:
                old = mc.mix_generic(*args, **kw)
            again = mc.mix_vector(*args, **kw)
            pairs = list(zip(out, old))[:2] if with_residual else [(out, old)]
            for a, b in pairs:
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"mix n={x.shape[0]} D={x.shape[1]} {kw}: register "
                        f"instance differs from the generic one by "
                        f"{float((a - b).abs().max()):.3e}")
            if with_residual and not torch.equal(out[2], again[2]):
                raise AssertionError(f"mix residual differs between two "
                                     f"runs: {float(out[2])!r} "
                                     f"{float(again[2])!r}")
            del old, again
            vector_cases += 1
        worst = max(worst, err)
        cases += 1

    # n = 4, 8 at D = 1,000,003 and 32 at any D, and 256, on the generic
    # instance (n = 256 opts into more than 48 KB of shared memory); n = 4,
    # 8, 16, 32 at D a multiple of 4 on the register instance
    for n, width in ((4, RAGGED_D), (4, RAGGED_D - 3), (8, RAGGED_D),
                     (8, RAGGED_D - 3), (16, RAGGED_D - 1), (32, RAGGED_D),
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
        d, M = (torch.from_numpy(a).cuda()
                for a in mc.phase_matrices("gossip", "ring", n))
        compare(x, g, d, M, True, True, True, False, inplace=True)
        del x, g

    # the simulator's rounds: ring gossip and global at n = 16 and 100,
    # D = 10 (params) and 20 (GT-PGA's params + tracker)
    for n, width in SIM_MIX_SHAPES:
        x = torch.randn(n, width, device="cuda", generator=gen)
        g = torch.randn(n, width, device="cuda", generator=gen)
        for phase in ("gossip", "global"):
            d, M = (torch.from_numpy(a).cuda()
                    for a in mc.phase_matrices(phase, "ring", n, step=1))
            for with_g in (False, True):
                for with_residual in (False, True):
                    for wire in (False, True):
                        compare(x, g, d, M, with_g, with_residual, wire,
                                phase == "global")

    # the push-sum rounds (slice 8): d and M built on the card from a
    # runtime W (dense_factors), fp32 and bf16 wire, at the push paths'
    # widths
    push_cases = 0
    for n, width in PUSH_MIX_SHAPES:
        x = torch.randn(n, width, device="cuda", generator=gen)
        for W in push_matrices(n):
            d, M = mc.dense_factors(torch.from_numpy(W).cuda(), n)
            for wire in (False, True):
                compare(x, None, d, M, False, False, wire, False)
                push_cases += 1
        del x

    # the main path's calls (n = 8, fp32 wire, consensus residual on, as
    # Trainer's fused round launches them), timed at the embedding leaf
    d, M = (torch.from_numpy(a).cuda()
            for a in mc.phase_matrices("gossip", "one_peer_exp", MAIN_N))
    for width in MAIN_WIDTHS:
        x = torch.randn(MAIN_N, width, device="cuda", generator=gen)
        if not mc.use_vector_mix(x):
            raise AssertionError(f"main-path width {width} is not taken by "
                                 f"the register instance")
        compare(x, None, d, M, False, True, False, False)
    x = torch.randn(MAIN_N, MAIN_D, device="cuda", generator=gen)
    kw = dict(with_g=False, with_residual=True, wire=False)
    old_ms, ms = _turns(
        torch, lambda: mc.mix_generic(x, None, None, d, M, **kw),
        lambda: mc.mix_vector(x, None, None, d, M, **kw))
    plain_ms = cuda_ms(torch,
                       lambda: mc.mix_flat_plain(x, None, None, d, M, **kw))
    W = M + torch.diag(d[:, 0])
    library_ms = device_ms(torch, lambda: torch.matmul(W, x))
    n, D = MAIN_N, MAIN_D
    bytes_moved = 4 * (n * D + n * D + D)      # read x, write o and x̄
    flops = 2 * n * n * D + 4 * n * D           # mix + mean + residual
    bound_ms, bound_by = _bound(bytes_moved, flops)
    print(f"[kernel] mix n={n} D={D} residual: register instance {ms:.4f} "
          f"ms, generic instance {old_ms:.4f} ms (device_ms, in turns), "
          f"plain {plain_ms:.4f} ms, torch.matmul(W, x) {library_ms:.4f} ms,"
          f" bound {bound_ms:.4f} ms by {bound_by} "
          f"({bytes_moved / (ms * 1e-3) / 1e9:.0f} GB/s achieved, "
          f"{100 * bound_ms / ms:.1f}% of the bound)", flush=True)
    print(f"[kernel] mix: {cases} kernel-vs-plain cases within tolerance, "
          f"max abs err {worst:.3e}; {vector_cases} of them on the register "
          f"instance, bitwise equal to the generic one; {push_cases} with a "
          f"runtime push-sum W at {PUSH_MIX_SHAPES}", flush=True)
    return {"name": "mix_vector_kernel", "route": "cuda",
            "source": "src/repro_torch/csrc/mix.cu",
            "replaces": "src/repro/kernels/mixing_pallas.py:215",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "old_ms": old_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def _nan_equal(torch, a, b) -> bool:
    """Bitwise equality, any NaN equal to any NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and torch.equal(
        a.masked_fill(na, 0).view(torch.int32),
        b.masked_fill(nb, 0).view(torch.int32))


def check_absmax(torch, mc, gen) -> int:
    """The rows' maxima kernel bitwise against ``absmax_rows(x + e)``, with
    and without e, on aligned rows (16-byte loads), a ragged D and a
    misaligned view (4-byte loads), with rows holding a NaN, ±inf, only
    zeros, a denormal maximum, and only negative values; the int8 and fp8
    scales made from its maxima bitwise equal to the plain ones.  Returns
    the number of cases."""
    from repro_torch.compress import quantize as cq

    cases = 0
    for n, width, offset in ((8, RAGGED_D - 3, 0), (8, RAGGED_D, 0),
                             (8, RAGGED_D - 3, 1), (32, 4096, 0),
                             (MAIN_N, MAIN_D, 0)):
        buf = torch.randn(2, n * width + offset, device="cuda",
                          generator=gen)
        x = buf[0, offset:].view(n, width)
        e = 0.01 * buf[1, offset:].view(n, width)
        x[0, width // 3] = float("nan")
        x[1, width - 1] = float("inf")
        x[2, 0] = float("-inf")
        x[3] = 0.0
        e[3] = 0.0
        x[4] *= 1e-39
        e[4] *= 1e-39
        x[5] = -x[5].abs()
        for ef in (None, e):
            m = mc.cmix_absmax(x, ef)
            p = mc.cmix_absmax_plain(x, ef)
            torch.cuda.synchronize()
            if not _nan_equal(torch, m, p):
                raise AssertionError(f"absmax n={n} D={width} offset="
                                     f"{offset} ef={ef is not None}: {m} vs "
                                     f"{p}")
            y = x if ef is None else x + ef
            for of_max, plain in ((cq.int8_scale_of_max, cq.int8_scale),
                                  (cq.fp8_scale_of_max, cq.fp8_scale)):
                if not _nan_equal(torch, of_max(m), plain(y)):
                    raise AssertionError(f"{plain.__name__} from the "
                                         f"kernel's maxima differs")
            assert torch.isnan(m[0]).all() and m[1, 0] == float("inf")
            assert m[2, 0] == float("inf") and m[3, 0] == 0.0
            assert 0.0 < float(m[4, 0]) < 1.1754944e-38, float(m[4, 0])
            cases += 1
        del buf, x, e
    return cases


def check_cmix_kernel(torch, mc) -> tuple:
    """cmix kernel vs its plain twin on the card, each case on the instance
    that ``use_vector_cmix`` picks: every kind (int8, fp8 with error
    feedback on and off; q precomputed from topk and randk), every phase
    (gossip, global with and without the bf16 wire, pod_avg), n in {4, 8,
    16, 32} at D near 1,000,000 (n = 4 and 8 at 1,000,003 on the generic
    instance) and n = 8 at the embedding leaf.  The two do the same IEEE
    operations in the same order on the same scale tensor (the wrapper
    computes it), so the tolerance is 1e-6·max|x| on o and on the new EF
    and the measured error is expected to be 0; where the register
    instance takes a case, the generic one also runs it and the two agree
    bitwise.  Constant fixed point: the rows of an equal-row state stay
    bitwise equal in every case, and one-peer gossip returns the state
    bitwise, for every kind, at D = 1,000,003 (generic instance) and
    1,000,000 (both instances).  Then the rows' maxima
    kernel (:func:`check_absmax`).  At the simulator's shapes (n = 16, 32
    and 100 at D = 10; ring gossip, global and pod_avg) o and the new EF
    must be bitwise the twin's.  The push-sum gossip round's factors come
    from a runtime W built on the card (n = 8 at D = 1,000,003 and the
    embedding leaf, int8 and fp8).  Returns the cmix record and the maxima
    kernel's."""
    from repro_torch import compress as C
    from repro_torch.compress import quantize as cq

    gen = torch.Generator(device="cuda").manual_seed(1)
    worst, cases, vector_cases = 0.0, 0, 0
    phases = (("gossip", "one_peer_exp", 1, False), ("global", "ring", 1,
                                                     False),
              ("global", "ring", 1, True), ("pod_avg", "ring", 2, False))

    def run(x, e, kind, phase, topo, pods, wire, seed, q=None,
            launch=None, factors=None):
        n = x.shape[0]
        w, M = factors if factors is not None else mc._device_compensated(
            phase, topo, n, 1, pods, torch.device("cuda"))
        scale = None
        if q is None:
            y = x if e is None else x + e
            scale = cq.int8_scale(y) if kind == "int8" else cq.fp8_scale(y)
            del y
        args = (x, e, q, seed, scale, w, M)
        kw = dict(kind=kind, with_ef=e is not None, wire=wire)
        out = (launch or mc.cmix_flat)(*args, **kw)
        return out, (None if launch else mc.cmix_flat_plain(*args, **kw))

    def compare(x, e, kind, phase, topo, pods, wire, seed=7, q=None,
                bitwise=False, factors=None):
        nonlocal worst, cases, vector_cases
        (o, ef), (po, pef) = run(x, e, kind, phase, topo, pods, wire, seed,
                                 q, factors=factors)
        torch.cuda.synchronize()
        err = float((o - po).abs().max())
        if ef is not None:
            err = max(err, float((ef - pef).abs().max()))
        tol = 0.0 if bitwise else 1e-6 * float(x.abs().max())
        if bitwise and not (torch.equal(o, po) and (
                ef is None or torch.equal(ef, pef))):
            err = max(err, float("inf"))
        what = (f"cmix n={x.shape[0]} D={x.shape[1]} kind={kind} "
                f"phase={phase} wire={wire} ef={e is not None}")
        if err > tol:
            raise AssertionError(f"{what}: max abs err {err:.3e} > "
                                 f"{tol:.3e}")
        if mc.use_vector_cmix(x, e, q):
            (go, gef), _ = run(x, e, kind, phase, topo, pods, wire, seed, q,
                               launch=mc.cmix_generic, factors=factors)
            if not (torch.equal(o, go) and (ef is None
                                            or torch.equal(ef, gef))):
                raise AssertionError(f"{what}: register instance differs "
                                     f"from the generic one")
            vector_cases += 1
        worst = max(worst, err)
        cases += 1

    def fixed_point(n, D, kind, comp=None):
        row = torch.randn(1, D, device="cuda", generator=gen)
        x = row.expand(n, D).contiguous()
        for phase, topo, pods, wire in phases:
            q = None
            if comp is not None:
                q = C.apply_tree(comp, {"w": x}, None, 5)[0]["w"]
            vector = mc.use_vector_cmix(x, None, q)
            for launch in ((mc.cmix_generic, mc.cmix_vector) if vector
                           else (mc.cmix_generic,)):
                (o, _), _ = run(x, None, kind, phase, topo, pods, wire, 5, q,
                                launch=launch)
                assert torch.equal(o, o[:1].expand_as(o)), (kind, phase)
                if topo == "one_peer_exp":
                    assert torch.equal(o, x), (kind, phase)

    for n, width in ((4, RAGGED_D), (4, RAGGED_D - 3), (8, RAGGED_D),
                     (16, RAGGED_D - 1), (32, RAGGED_D), (MAIN_N, MAIN_D)):
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
    # the simulator's compressed rounds, bitwise
    for n, width in SIM_COMP_SHAPES:
        x = torch.randn(n, width, device="cuda", generator=gen)
        e = 0.01 * torch.randn(n, width, device="cuda", generator=gen)
        pods = 4 if n % 4 == 0 and n > 32 else 2
        for kind in ("int8", "fp8"):
            for phase, pp in (("gossip", 1), ("global", 1),
                              ("pod_avg", pods)):
                for ef in (None, e):
                    for seed in (7, 1234):
                        compare(x, ef, kind, phase, "ring", pp, False,
                                seed=seed, bitwise=True)
        del x, e
    # push-sum compressed gossip (slice 8): w = 1 − diag(W) and M built on
    # the card from a runtime fault W, int8 and fp8, EF on and off
    Wf = torch.from_numpy(push_matrices(MAIN_N)[0]).cuda()
    d, M = mc.dense_factors(Wf, MAIN_N)
    for width in (RAGGED_D, MAIN_D):
        x = torch.randn(MAIN_N, width, device="cuda", generator=gen)
        e = 0.01 * torch.randn(MAIN_N, width, device="cuda", generator=gen)
        for kind in ("int8", "fp8"):
            for ef in (None, e):
                compare(x, ef, kind, "gossip", None, 1, False,
                        factors=(1.0 - d, M))
        del x, e
    for kind, name in (("int8", None), ("fp8", None),
                       ("precomputed", "topk"), ("precomputed", "randk")):
        comp = None if name is None else C.make_compressor(name, k=32)
        for width in (RAGGED_D, RAGGED_D - 3):
            fixed_point(8, width, kind, comp)
    absmax_cases = check_absmax(torch, mc, gen)

    # the main path's call timed at the embedding leaf: int8, EF, gossip
    n, D = MAIN_N, MAIN_D
    x = torch.randn(n, D, device="cuda", generator=gen)
    e = 0.01 * torch.randn(n, D, device="cuda", generator=gen)
    w, M = mc._device_compensated("gossip", "one_peer_exp", n, 1, 1,
                                  torch.device("cuda"))
    scale = cq.int8_scale(x + e)
    args = (x, e, None, 7, scale, w, M)
    kw = dict(kind="int8", with_ef=True, wire=False)
    old_ms, ms = _turns(torch, lambda: mc.cmix_generic(*args, **kw),
                        lambda: mc.cmix_vector(*args, **kw))
    plain_ms = cuda_ms(torch, lambda: mc.cmix_flat_plain(*args, **kw),
                       iters=5, warmup=1)
    # the yardstick covers the mix part only: M·q at the same shape
    library_ms = device_ms(torch, lambda: torch.matmul(M, x))
    bytes_moved = 4 * 4 * n * D                 # read x, e; write o, ef
    flops = (2 * n + 12) * n * D                # codec + mix per element
    bound_ms, bound_by = _bound(bytes_moved, flops)
    print(f"[kernel] cmix int8+EF n={n} D={D}: register instance {ms:.4f} "
          f"ms, generic instance {old_ms:.4f} ms (device_ms, in turns), "
          f"plain {plain_ms:.4f} ms, torch.matmul(M, q) (the mix part only)"
          f" {library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
          f"({bytes_moved / (ms * 1e-3) / 1e9:.0f} GB/s achieved, "
          f"{100 * bound_ms / ms:.1f}% of the bound)", flush=True)
    print(f"[kernel] cmix: {cases} kernel-vs-plain cases within tolerance, "
          f"max abs err {worst:.3e}; {vector_cases} of them on the register "
          f"instance, bitwise equal to the generic one; constant fixed "
          f"point bitwise for int8, fp8, topk, randk on both instances",
          flush=True)
    cmix_rec = {"name": "cmix_vector_kernel", "route": "cuda",
                "source": "src/repro_torch/csrc/cmix.cu",
                "replaces": "src/repro/kernels/mixing_pallas.py:504",
                "launches": None, "max_abs_err": worst, "ms": ms,
                "old_ms": old_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms}

    # the rows' maxima of the same call: read x and e once
    a_ms = device_ms(torch, lambda: mc.cmix_absmax(x, e))
    a_plain_ms = device_ms(torch, lambda: mc.cmix_absmax_plain(x, e))
    a_bytes = 2 * 4 * n * D
    a_bound, a_by = _bound(a_bytes, 2 * n * D)
    print(f"[kernel] cmix_absmax n={n} D={D} with e: kernel {a_ms:.4f} ms, "
          f"plain amax(abs(x + e)) {a_plain_ms:.4f} ms (device_ms), bound "
          f"{a_bound:.4f} ms by {a_by} ({a_bytes / (a_ms * 1e-3) / 1e9:.0f} "
          f"GB/s achieved, {100 * a_bound / a_ms:.1f}% of the bound); "
          f"{absmax_cases} cases bitwise equal to the plain maxima, NaN rows "
          f"included", flush=True)
    absmax_rec = {"name": "cmix_absmax_kernel", "route": "cuda",
                  "source": "src/repro_torch/csrc/cmix.cu",
                  "replaces": "src/repro/kernels/mixing_pallas.py:718",
                  "launches": None, "max_abs_err": 0.0, "ms": a_ms,
                  "plain_ms": a_plain_ms, "bound_ms": a_bound,
                  "bound_by": a_by, "library_ms": None}
    return cmix_rec, absmax_rec


def check_collective_kernel(torch, mc) -> dict:
    """collective kernel vs its plain twin on the card: int8 and fp8,
    global and pod_avg (2 pods), error feedback on and off, n = 8 at
    D = 1,000,003 (a ragged last block, masked in the kernel and padded in
    the twin) and at the packed main-path width (int8 + EF, global: the
    main path's call).  The pod sum runs in one order in both and the
    scales are powers of two, so the tolerance is 1e-6·max|x| (measured
    error expected 0).  A constant state comes back bitwise for every
    kind and phase.  At the simulator's shapes (n = 16, 32 and 100 at
    D = 10; n = 100 takes the untiled instance) o and the new EF must be
    bitwise the twin's, and so must the untiled instance, forced at n = 8,
    against the tiled one and at n = 100 over 98 blocks against the
    twin."""
    from repro_torch.compress import collective as ccol

    gen = torch.Generator(device="cuda").manual_seed(2)
    worst, cases, untiled_cases = 0.0, 0, 0
    n = MAIN_N
    s1, s2 = ccol.stage_seeds(7)

    def compare(x, e, kind, pods, bitwise=False, tiled=None):
        nonlocal worst, cases
        kw = dict(kind=kind, with_ef=e is not None, n_pods=pods,
                  qblock=ccol.QBLOCK)
        o, ef = mc.collective_flat(x, e, s1, s2, tiled=tiled, **kw)
        po, pef = mc.collective_flat_plain(x, e, s1, s2, **kw)
        torch.cuda.synchronize()
        err = float((o - po).abs().max())
        if ef is not None:
            err = max(err, float((ef - pef).abs().max()))
        if bitwise and not (torch.equal(o, po) and (
                ef is None or torch.equal(ef, pef))):
            err = max(err, float("inf"))
        del po, pef
        tol = 0.0 if bitwise else 1e-6 * float(x.abs().max())
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
        # the untiled instance, forced, bitwise the tiled one
        for pods in (1, 2):
            for ef in (None, e):
                kw = dict(kind=kind, with_ef=ef is not None, n_pods=pods,
                          qblock=ccol.QBLOCK)
                a = mc.collective_flat(x, ef, s1, s2, tiled=True, **kw)
                b = mc.collective_flat(x, ef, s1, s2, tiled=False, **kw)
                if not all(u is None and v is None or torch.equal(u, v)
                           for u, v in zip(a, b)):
                    raise AssertionError(f"collective {kind} pods={pods} "
                                         f"ef={ef is not None}: untiled "
                                         f"instance differs from the tiled")
                del a, b
                untiled_cases += 1
    del x, e
    torch.cuda.empty_cache()

    # the simulator's shapes, bitwise; n = 100 is past the tile
    for n_sim, width in SIM_COMP_SHAPES + ((100, 100_003),):
        x = torch.randn(n_sim, width, device="cuda", generator=gen)
        e = 0.01 * torch.randn(n_sim, width, device="cuda", generator=gen)
        pods = 4 if n_sim % 4 == 0 and n_sim > 32 else 2
        for kind in ("int8", "fp8"):
            for pp in (1, pods):
                for ef in (None, e):
                    compare(x, ef, kind, pp, bitwise=True)
        del x, e
    if mc.collective_smem(100, 1, ccol.QBLOCK, True) <= \
            mc.cuda_build.MAX_SMEM:
        raise AssertionError("n = 100 was expected past the tile")

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
    untiled_ms = cuda_ms(torch, lambda: mc.collective_flat(
        x, e, s1, s2, tiled=False, **kw), iters=5, warmup=1)
    bytes_moved = 4 * 4 * n * D                 # read x, e; write o, ef
    flops = 60 * n * D                          # two codecs, pod mean
    bound_ms, bound_by = _bound(bytes_moved, flops)
    print(f"[kernel] collective int8+EF n={n} D={D}: kernel {ms:.4f} ms "
          f"(the untiled instance {untiled_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms, no single PyTorch call computes it, "
          f"bound {bound_ms:.4f} ms by {bound_by} "
          f"({bytes_moved / (ms * 1e-3) / 1e9:.0f} GB/s achieved)",
          flush=True)
    print(f"[kernel] collective: {cases} kernel-vs-plain cases within "
          f"tolerance (those at n = 16, 32 and 100 bitwise), max abs err "
          f"{worst:.3e}; {untiled_cases} untiled-vs-tiled cases bitwise; "
          f"constant fixed point bitwise for int8 and fp8, global and 2 "
          f"pods; in place matches", flush=True)
    del x, e
    torch.cuda.empty_cache()
    return {"name": "collective_kernel", "route": "cuda",
            "source": "src/repro_torch/csrc/collective.cu",
            "replaces": "src/repro/kernels/mixing_pallas.py:765",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "untiled_ms": untiled_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


MLSTM_SWEEP = ((1, 37, 2, 8, 16, 8), (2, 64, 2, 16, 16, 16),
               (1, 100, 3, 8, 8, 32), (2, 16, 1, 4, 4, 16),
               (1, 6, 2, 8, 16, 64))
MLSTM_FULL = dict(nh=8, dk=96, dv=192, chunk=64)   # xlstm-125m's mLSTM
MLSTM_ACC_TOL = 1e-5     # float32 accumulation, in units of |ex| + scale
MLSTM_OUT_TOL = {"torch.float32": 0.0, "torch.bfloat16": 8e-3}


def mlstm_inputs(torch, gen, B, S, nh, dk, dv, dtype, strided=False,
                 gates="wide"):
    """q, k, v (B, S, nh, ·) in ``dtype`` and float32 log gates: drawn
    wide (log i ~ 5·N(0, 2²), log f = logsigmoid(N(0, 2²))) to drive the
    stabilizer, or at the model's scale (``gates="model"``: log i ~ N(0, 1)
    as the fan-in input gate with zero bias gives, log f = logsigmoid(3 +
    N(0, 1)) as the forget bias of 3 gives).  ``strided`` makes q, k, v
    and the gates views of head-major buffers (the kernel reads them
    through their strides)."""
    F = torch.nn.functional

    def draw(shape, scale=1.0):
        if strided:   # (B, nh, S, ·) buffer seen as (B, S, nh, ·)
            order = (0, 2, 1) + tuple(range(3, len(shape)))
            buf_shape = tuple(shape[i] for i in order)
            return scale * torch.randn(buf_shape, device="cuda",
                                       generator=gen).transpose(1, 2)
        return scale * torch.randn(shape, device="cuda", generator=gen)

    q = (draw((B, S, nh, dk)) / math.sqrt(dk)).to(dtype)
    k = draw((B, S, nh, dk)).to(dtype)
    v = draw((B, S, nh, dv)).to(dtype)
    if gates == "wide":
        li = draw((B, S, nh), 10.0)
        lf = F.logsigmoid(draw((B, S, nh), 2.0))
    else:
        li = draw((B, S, nh))
        lf = F.logsigmoid(3.0 + draw((B, S, nh)))
    return q, k, v, li, lf


def check_mlstm_kernel(torch, mk) -> list:
    """Both mLSTM kernels vs their plain twin on the card, on h and on the
    final (C, n, m), each case's launch checked: float32 goes to
    ``mlstm.cu``, bf16 to ``mlstm_wgmma.cu`` where
    :func:`~repro_torch.kernels.mlstm_cuda.use_wgmma` takes it (chunk 64,
    or one chunk of S <= 64; dk, dv multiples of 8) and to ``mlstm.cu``
    otherwise; every bf16 case the tensor-core instance takes also runs
    through ``mlstm.cu`` (``mlstm_simt``) under that kernel's gates.  Cases:
    the JAX kernel test's sweep and a prompt of 6 (L = 8 with padding); at
    full width (nh 8, dk 96, dv 192, chunk 64) B ∈ {1, 8} × S ∈ {2000,
    2048}, the serving admissions' B = 1 × S ∈ {6, 100, 1000} (S = 6 takes
    the padded L = 8 layout), one case read through strided views, all
    with wide gates, and B = 8 × S = 2048 and B = 1 × S = 1000 with gates
    at the model's scale; each in float32 and with bf16 q, k, v.

    Tolerances.  State, both kernels: max abs error ≤ 1e-5 · max|ref| on
    C, n and m, and m bit for bit the twin's.  ``mlstm.cu``, h element by
    element against the twin run in float64 (``ex``) and its error scale
    (``scale``, see ``mlstm_cuda.chunkwise``: about |h| where nothing
    cancels, large only in rows whose denominator or numerator cancels,
    where every float32 order loses digits): |h − ex| ≤ out·|ex| +
    1e-5·(|ex| + scale), with out = 0 for float32 h and 8e-3 (one bf16
    ulp) for bf16 h; the float32 twin passes at under 1e-6 in scale
    units.  Kernel vs float32 twin, element by element: |h − twin| ≤
    out·|ex| + 2e-5·(|ex| + scale), and over the whole case max|h − twin|
    ≤ 2e-3 (float32) / 8e-3 (bf16) · max|twin|.  ``mlstm_wgmma.cu``, which
    rounds P and C to bf16 before their products: the same element gates
    with ``WGMMA_UNIT`` (2^-8) added to each allowance
    (``mlstm_cuda.wgmma_excess``).  The cases with model-scale gates,
    where no row comes near cancelling, also hold max|h − ex| ≤ 1e-5
    (float32) / 8e-3 (bf16) · max|ex|.

    Timing at the serving shape (B = 8, S = 2048) and at B = 1: both
    kernels on the same bf16 operands by :func:`device_ms` in turns, the
    tensor-core instance against the bytes and bf16 tensor-core bound, the
    twin by :func:`cuda_ms`; ``mlstm.cu``'s float32 call at B = 8 against
    its fp32 bound.  Returns the records of ``mlstm.cu`` (the float32
    path) and ``mlstm_wgmma.cu``."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [c + (False, "wide") for c in MLSTM_SWEEP]
    full = (MLSTM_FULL["nh"], MLSTM_FULL["dk"], MLSTM_FULL["dv"],
            MLSTM_FULL["chunk"])
    cases += [(B, S) + full + (False, "wide")
              for B in (1, 8) for S in (2000, 2048)]
    cases += [(1, S) + full + (False, "wide") for S in (6, 100, 1000)]
    cases.append((2, 300) + full + (True, "wide"))
    cases += [(8, 2048) + full + (False, "model"),
              (1, 1000) + full + (False, "model")]
    worst = {"mlstm": 0.0, "mlstm_wgmma": 0.0}
    n_cases = {"mlstm": 0, "mlstm_wgmma": 0}
    m_equal = {"mlstm": True, "mlstm_wgmma": True}
    failures = []
    rel = {"h32": 0.0, "h16": 0.0, "k64": 0.0, "t64": 0.0, "state": 0.0,
           "scaled": 0.0, "model32": 0.0, "model16": 0.0, "wg_h": 0.0,
           "wg_state": 0.0, "wg_scaled": 0.0, "wg_model": 0.0}

    def hold(kernel, dtype, h, state, rh, rstate, ex, scale, where, gates):
        wg = kernel == "mlstm_wgmma"
        m_equal[kernel] = m_equal[kernel] and torch.equal(state[2],
                                                          rstate[2])
        for name, a, b in zip(("C", "n", "m"), state, rstate):
            err = float((a - b).abs().max())
            worst[kernel] = max(worst[kernel], err)
            ref_max = float(b.abs().max())
            key = "wg_state" if wg else "state"
            rel[key] = max(rel[key], err / max(ref_max, 1e-30))
            if not err <= 1e-5 * ref_max:
                failures.append(f"{where} {kernel}: {name} max abs err "
                                f"{err:.3e}")
        if not bool(torch.isfinite(h).all()):
            failures.append(f"{where} {kernel}: h not finite")
        h, rh = h.double(), rh.double()
        err_k, err_t = (h - ex).abs(), (rh - ex).abs()
        err_kt = (h - rh).abs()
        ex_max, rh_max = float(ex.abs().max()), float(rh.abs().max())
        unit = ex.abs() + scale
        out = MLSTM_OUT_TOL[str(dtype)]
        if wg:
            over = mk.wgmma_excess(h, ex, ex, scale, MLSTM_ACC_TOL)
            over_kt = mk.wgmma_excess(h, rh, ex, scale, 2 * MLSTM_ACC_TOL)
            kt_ok = True
            rel["wg_h"] = max(rel["wg_h"], float(err_kt.max()) / rh_max)
            rel["wg_scaled"] = max(rel["wg_scaled"], float(
                ((err_k - out * ex.abs()) / unit).max()))
        else:
            over = err_k - out * ex.abs() - MLSTM_ACC_TOL * unit
            over_kt = err_kt - out * ex.abs() - 2 * MLSTM_ACC_TOL * unit
            kt_tol = 2e-3 if dtype == torch.float32 else 8e-3
            kt_ok = float(err_kt.max()) <= kt_tol * rh_max
        if float(over.max()) > 0:
            i = int(over.argmax())
            failures.append(
                f"{where} {kernel}: h vs float64 "
                f"{float(err_k.flatten()[i]):.3e} at |ex| "
                f"{float(ex.abs().flatten()[i]):.3e}, scale "
                f"{float(scale.flatten()[i]):.3e}")
        if float(over_kt.max()) > 0 or not kt_ok:
            failures.append(f"{where} {kernel}: h vs twin max abs err "
                            f"{float(err_kt.max()):.3e}, max|twin| "
                            f"{rh_max:.3e}")
        if gates == "model":
            key = ("wg_model" if wg else "model32" if dtype == torch.float32
                   else "model16")
            r = float(err_k.max()) / ex_max
            rel[key] = max(rel[key], r)
            if not r <= (1e-5 if dtype == torch.float32 else 8e-3):
                failures.append(f"{where} {kernel}: h vs float64 {r:.3e} of "
                                f"max|ex|")
        if not wg:
            key = "h32" if dtype == torch.float32 else "h16"
            rel[key] = max(rel[key], float(err_kt.max()) / rh_max)
        if wg or dtype == torch.float32:
            worst[kernel] = max(worst[kernel], float(err_kt.max()))
        if not wg and dtype == torch.float32:
            rel["k64"] = max(rel["k64"], float(err_k.max()) / ex_max)
            rel["t64"] = max(rel["t64"], float(err_t.max()) / ex_max)
            rel["scaled"] = max(rel["scaled"], float((err_k / unit).max()))
        n_cases[kernel] += 1

    for B, S, nh, dk, dv, chunk, strided, gates in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = mlstm_inputs(torch, gen, B, S, nh, dk, dv, dtype, strided,
                                gates)
            wg = mk.use_wgmma(*args[:3], mk.chunk_len(chunk, S))
            expect = "mlstm_wgmma" if wg else "mlstm"
            torch.cuda.synchronize()
            reset_counts()
            h, state = mk.mlstm_chunk(*args, chunk=chunk)
            torch.cuda.synchronize()
            where = (f"B={B} S={S} nh={nh} dk={dk} dv={dv} L={chunk} "
                     f"strided={strided} gates={gates} {dtype}")
            if counts() != only(**{expect: 1}):
                raise AssertionError(f"mlstm {where}: launches {counts()}, "
                                     f"expected one {expect}")
            rh, rstate = mk.mlstm_chunk_plain(*args, chunk=chunk)
            ex, _, scale = mk.mlstm_chunk_plain(
                *(t.double() for t in args), chunk=chunk, error_scale=True)
            hold(expect, dtype, h, state, rh, rstate, ex, scale, where, gates)
            if wg:   # the same bf16 operands on mlstm.cu, its own gates
                h2, state2 = mk.mlstm_simt(*args, chunk=chunk)
                torch.cuda.synchronize()
                hold("mlstm", dtype, h2, state2, rh, rstate, ex, scale,
                     where, gates)
                del h2, state2
            del args, h, state, rh, rstate, ex, scale
    if failures:
        raise AssertionError("mlstm kernel vs plain:\n" + "\n".join(failures))
    print(f"[kernel] mlstm: {sum(n_cases.values())} kernel-vs-plain cases "
          f"within tolerance, {n_cases['mlstm_wgmma']} on mlstm_wgmma.cu and "
          f"{n_cases['mlstm']} on mlstm.cu (every bf16 case of the first "
          f"also on the second); max abs err {worst['mlstm']:.3e} (mlstm.cu"
          f", float32 h vs twin, state), {worst['mlstm_wgmma']:.3e} "
          f"(mlstm_wgmma.cu, bf16 h vs twin, state)", flush=True)
    print(f"[kernel] mlstm mlstm.cu: max error over max|ref|: state "
          f"{rel['state']:.3e}, float32 h vs twin {rel['h32']:.3e}, bf16 h "
          f"vs twin {rel['h16']:.3e}; float32 h vs float64: kernel "
          f"{rel['k64']:.3e}, twin {rel['t64']:.3e}, kernel per element in "
          f"units of |ex| + scale {rel['scaled']:.3e}; model-scale gates, h "
          f"vs float64 over max|ex|: float32 {rel['model32']:.3e}, bf16 "
          f"{rel['model16']:.3e}; m equal to the twin's bit for bit in every"
          f" case: {m_equal['mlstm']}", flush=True)
    print(f"[kernel] mlstm mlstm_wgmma.cu: max error over max|ref|: state "
          f"{rel['wg_state']:.3e}, bf16 h vs twin {rel['wg_h']:.3e}; h vs "
          f"float64 beyond one bf16 ulp, per element in units of |ex| + "
          f"scale {rel['wg_scaled']:.3e} (allowed {mk.WGMMA_UNIT:.3e} + "
          f"{MLSTM_ACC_TOL:.0e}); model-scale gates, h vs float64 over "
          f"max|ex| {rel['wg_model']:.3e}; m equal to the twin's bit for bit"
          f" in every case: {m_equal['mlstm_wgmma']}", flush=True)
    if not all(m_equal.values()):
        raise AssertionError(f"mlstm: m not bit for bit the twin's: "
                             f"{m_equal}")
    timings = {}
    S, (nh, dk, dv, L) = 2048, full
    for B in (8, 1):
        args = mlstm_inputs(torch, gen, B, S, nh, dk, dv, torch.bfloat16)
        simt_ms, ms = _turns(torch, lambda: mk.mlstm_simt(*args, chunk=L),
                             lambda: mk.mlstm_wgmma(*args, chunk=L))
        plain_ms = cuda_ms(torch, lambda: mk.mlstm_chunk_plain(*args,
                                                               chunk=L),
                           iters=5, warmup=1)
        bytes_moved, flops = mlstm_work(B, S, nh, dk, dv, L)
        b_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        f_ms = flops / BF16_TC_FLOP_PER_S * 1e3
        bound_ms, bound_by = max(b_ms, f_ms), ("bytes" if b_ms >= f_ms
                                               else "operations")
        simt_bound, simt_by = _bound(bytes_moved, flops)
        timings[B] = (ms, plain_ms, bound_ms, bound_by)
        print(f"[kernel] mlstm B={B} S={S} nh={nh} dk={dk} dv={dv} L={L} "
              f"bf16: mlstm_wgmma.cu {ms:.4f} ms on the card ("
              f"{bound_ms / ms:.1%} of its bound {bound_ms:.4f} ms by "
              f"{bound_by}: {bytes_moved / 1e6:.1f} MB at 3.35 TB/s, "
              f"{flops / 1e9:.2f} GFLOP at 989 TFLOP/s), mlstm.cu "
              f"{simt_ms:.4f} ms ({simt_ms / ms:.1f}x; fp32 bound "
              f"{simt_bound:.4f} ms by {simt_by}), in turns; plain "
              f"{plain_ms:.4f} ms; no single PyTorch call computes it",
              flush=True)
        del args
    B = 8
    args = mlstm_inputs(torch, gen, B, S, nh, dk, dv, torch.float32)
    ms32 = device_ms(torch, lambda: mk.mlstm_chunk(*args, chunk=L))
    plain32 = cuda_ms(torch, lambda: mk.mlstm_chunk_plain(*args, chunk=L),
                      iters=5, warmup=1)
    bound32, by32 = _bound(*mlstm_work(B, S, nh, dk, dv, L, itemsize=4))
    print(f"[kernel] mlstm B={B} S={S} nh={nh} dk={dk} dv={dv} L={L} float32"
          f": mlstm.cu {ms32:.4f} ms on the card, plain {plain32:.4f} ms, "
          f"bound {bound32:.4f} ms by {by32} (fp32 operations at 67 "
          f"TFLOP/s)", flush=True)
    del args
    ms, plain_ms, bound_ms, bound_by = timings[8]
    record = dict(route="cuda", replaces="src/repro/kernels/mlstm_chunk.py:32",
                  launches=None, library_ms=None)
    return [dict(record, name="mlstm_kernel",
                 source="src/repro_torch/csrc/mlstm.cu",
                 max_abs_err=worst["mlstm"], ms=ms32, plain_ms=plain32,
                 bound_ms=bound32, bound_by=by32),
            dict(record, name="mlstm_wgmma_kernel",
                 source="src/repro_torch/csrc/mlstm_wgmma.cu",
                 max_abs_err=worst["mlstm_wgmma"], ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by)]


def mlstm_work(B, S, nh, dk, dv, L, itemsize=2):
    """``(bytes, flops)`` the chunkwise mLSTM needs at q, k, v of
    ``itemsize`` bytes (bf16 by default): read q, k, v and the two float32
    gates once, write h (q's type) and the float32 state once; per chunk
    of each (b, h) the causal pairs' scores and weighted values,
    L(L+1)/2 · 2(dk + dv), plus q·C and kᵀv, 4 L dk dv."""
    nc = -(-S // L)
    bytes_moved = (itemsize * B * S * nh * (2 * dk + 2 * dv)
                   + 4 * 2 * B * S * nh
                   + 4 * B * nh * (dk * dv + dk + 1))
    flops = B * nh * nc * (L * (L + 1) * (dk + dv) + 4 * L * dk * dv)
    return bytes_moved, flops


SHARD_M = 2                          # nodes per shard on the main path
SHARD_CASES = tuple((m, halo) for m in (1, 2, 4)     # (m, K / m)
                    for halo in (1, 2, 3))
SHARD_WIDTHS = (RAGGED_D, 37, 1)


def _shard_factors(torch, gen, m, K, comp=False):
    """A random ``(m, K)`` factor and ``(m, 1)`` self weight whose rows have
    the absolute sum of a mixing row (1), so |o| ≤ max|inputs|; ``comp``
    draws w in [0, 1) as 1 − d of a gossip round."""
    M = torch.rand(m, K, device="cuda", generator=gen)
    d = torch.rand(m, 1, device="cuda", generator=gen)
    s = M.sum(1, keepdim=True) + d
    return M / s, (1.0 - d / s) if comp else d / s


def _main_shard_factors(torch, step):
    """Shard 0's ``(M_r, d_r, w_r)`` of the main path's gossip round at
    ``step`` (one_peer_exp, n = 8, 4 shards: K = 4 at hop 1, 2 after)."""
    from repro_torch.core import mixing

    offsets, Mst, dst, wst = mixing._device_shard_blocks(
        "gossip", "one_peer_exp", MAIN_N, step, 1, MAIN_N // SHARD_M,
        torch.device("cuda"))
    return Mst[0], dst[0], wst[0]


def check_shard_mix_kernel(torch, mc) -> dict:
    """shard_mix kernel vs its plain twin on the card: m ∈ {1, 2, 4} rows,
    K ∈ {m, 2m, 3m} halo rows, D ∈ {1,000,003, 37, 1}, with and without
    the column sums, xs in fp32 and bf16-cast; then the main path's
    full-width shard (m = 2, D = 138,431,232) at K = 4 (hop 1) and K = 2
    (hop 2) with the real one_peer_exp factors.  Factor rows have abs sum
    1, so |o| ≤ s = max(|x|, |xs|).  Tolerance: max|o − o_plain| ≤
    1e-5·s and max|cs − cs_plain| ≤ 1e-5·m·s per element (the plain
    version's matmul and column sum add in another order than the
    kernel's loops)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst, cases = 0.0, 0

    def compare(x, xs, d, M, with_residual):
        nonlocal worst, cases
        m = x.shape[0]
        out = mc.shard_mix_block(x, xs, d, M, with_residual=with_residual)
        ref = mc.shard_mix_block_plain(x, xs, d, M,
                                       with_residual=with_residual)
        torch.cuda.synchronize()
        s = max(float(x.abs().max()), float(xs.abs().max()))
        o, r = (out[0], ref[0]) if with_residual else (out, ref)
        err = float((o - r).abs().max())
        if err > 1e-5 * s:
            raise AssertionError(f"shard_mix m={m} K={xs.shape[0]} "
                                 f"D={x.shape[1]}: o max abs err {err:.3e}")
        if with_residual:
            cerr = float((out[1] - ref[1]).abs().max())
            if cerr > 1e-5 * m * s:
                raise AssertionError(f"shard_mix m={m} K={xs.shape[0]} "
                                     f"D={x.shape[1]}: column sums max abs "
                                     f"err {cerr:.3e}")
            err = max(err, cerr)
        worst = max(worst, err)
        cases += 1

    for m, halo in SHARD_CASES:
        K = m * halo
        M, d = _shard_factors(torch, gen, m, K)
        for D in SHARD_WIDTHS:
            x = torch.randn(m, D, device="cuda", generator=gen)
            xs = torch.randn(K, D, device="cuda", generator=gen)
            for cast in (False, True):
                xsw = xs.to(torch.bfloat16).to(torch.float32) if cast else xs
                for with_residual in (False, True):
                    compare(x, xsw, d, M, with_residual)
    # full width: the main path's shard
    D = MAIN_PACKED_D
    x = torch.randn(SHARD_M, D, device="cuda", generator=gen)
    xs = torch.randn(2 * SHARD_M, D, device="cuda", generator=gen)
    for step, K in ((0, 4), (1, 2)):
        M, d, _ = _main_shard_factors(torch, step)
        assert tuple(M.shape) == (SHARD_M, K), M.shape
        compare(x, xs[:K], d, M, True)
    M, d, _ = _main_shard_factors(torch, 0)
    kw = dict(with_residual=True)
    ms = cuda_ms(torch, lambda: mc.shard_mix_block(x, xs, d, M, **kw),
                 iters=10, warmup=2)
    push_ms = push_shard_cases(torch, mc, compare)
    plain_ms = cuda_ms(torch, lambda: mc.shard_mix_block_plain(
        x, xs, d, M, **kw), iters=5, warmup=1)
    library_ms = cuda_ms(torch, lambda: torch.matmul(M, xs), iters=10,
                         warmup=2)
    m, K = SHARD_M, xs.shape[0]
    bytes_moved = 4 * (m + K + m + 1) * D      # read x, xs; write o, cs
    flops = (2 * K + 3) * m * D                 # mix, self term, sums
    bound_ms, bound_by = _bound(bytes_moved, flops)
    print(f"[kernel] shard_mix m={m} K={K} D={D} column sums: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul(M_r, xs) "
          f"(the mix only) {library_ms:.4f} ms, bound {bound_ms:.4f} ms by "
          f"{bound_by} ({bytes_moved / (ms * 1e-3) / 1e9:.0f} GB/s achieved)",
          flush=True)
    print(f"[kernel] shard_mix: {cases} kernel-vs-plain cases within "
          f"tolerance, max abs err {worst:.3e}", flush=True)
    del x, xs
    torch.cuda.empty_cache()
    return {"name": "shard_mix_kernel", "route": "cuda",
            "source": "src/repro_torch/csrc/shard_mix.cu",
            "replaces": "src/repro/kernels/mixing_pallas.py:975",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "push_ms": push_ms}


def push_shard_cases(torch, mc, compare) -> dict:
    """The sharded push-sum path's shard_mix calls at full width (slice 8):
    m = 2 rows of the joint (x, w) matrix, D = 138,431,233 (the weight
    column packed with the parameters), each shard's factor gathered on
    the card from a runtime W over the static halo: K = 6 (offsets 0, 1, 2
    of directed_exp's hops at 4 shards) on a fault gossip W, K = 8 on the
    global round over 6 of 8 nodes.  Held by ``compare`` (the tolerances
    of :func:`check_shard_mix_kernel`), every shard; returns the ms of one
    call of each kind (CUDA events)."""
    from repro_torch.core import mixing

    k, D = MAIN_N // SHARD_M, MAIN_PACKED_D + 1
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(SHARD_M, D, device="cuda", generator=gen)
    xs = torch.randn(MAIN_N, D, device="cuda", generator=gen)
    out = {}
    gossip_offsets = mixing.push_sum_shard_offsets(MAIN_N, k, (0, 1, 2, 4))
    for name, W, offsets in zip(("gossip", "global"), push_matrices(MAIN_N),
                                (gossip_offsets, tuple(range(k)))):
        Mst, dst = mixing._dense_shard_stacks(torch.from_numpy(W).cuda(),
                                              MAIN_N, k, offsets)
        K = len(offsets) * SHARD_M
        for r in range(k):
            compare(x, xs[:K], dst[r], Mst[r], False)
        out[f"{name} K={K}"] = cuda_ms(
            torch, lambda: mc.shard_mix_block(x, xs[:K], dst[1], Mst[1]),
            iters=5, warmup=1)
    print(f"[kernel] shard_mix push-sum shards m={SHARD_M} D={D}: "
          f"{ {key: round(v, 4) for key, v in out.items()} } ms per call",
          flush=True)
    del x, xs
    return out


def check_shard_cmix_kernel(torch, mc) -> dict:
    """shard_cmix kernel vs its plain twin on the card, the cases of
    :func:`check_shard_mix_kernel` (qs in fp32 and bf16-cast), then the
    main path's full-width shard at K = 4 and 2 with the real factors.
    With |M| rows ≤ 1 and w ≤ 1, |o − x| ≤ 2s, s = max(|x|, |q_self|,
    |qs|).  Tolerance: max|o − o_plain| ≤ 1e-5·s per element."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst, cases = 0.0, 0

    def compare(x, q, qs, w, M):
        nonlocal worst, cases
        o = mc.shard_comp_mix_block(x, q, qs, w, M)
        ref = mc.shard_comp_mix_block_plain(x, q, qs, w, M)
        torch.cuda.synchronize()
        s = max(float(t.abs().max()) for t in (x, q, qs))
        err = float((o - ref).abs().max())
        if err > 1e-5 * s:
            raise AssertionError(f"shard_cmix m={x.shape[0]} K={qs.shape[0]}"
                                 f" D={x.shape[1]}: max abs err {err:.3e}")
        worst = max(worst, err)
        cases += 1

    for m, halo in SHARD_CASES:
        K = m * halo
        M, w = _shard_factors(torch, gen, m, K, comp=True)
        for D in SHARD_WIDTHS:
            x = torch.randn(m, D, device="cuda", generator=gen)
            q = torch.randn(m, D, device="cuda", generator=gen)
            qs = torch.randn(K, D, device="cuda", generator=gen)
            for cast in (False, True):
                f = ((lambda t: t.to(torch.bfloat16).to(torch.float32))
                     if cast else (lambda t: t))
                compare(x, f(q), f(qs), w, M)
    D = MAIN_PACKED_D
    x = torch.randn(SHARD_M, D, device="cuda", generator=gen)
    qs = torch.randn(2 * SHARD_M, D, device="cuda", generator=gen)
    for step, K in ((0, 4), (1, 2)):
        M, _, w = _main_shard_factors(torch, step)
        compare(x, qs[:SHARD_M], qs[:K], w, M)
    M, _, w = _main_shard_factors(torch, 0)
    m, K = SHARD_M, qs.shape[0]
    flops = (2 * K + 4) * m * D
    # the record: q_self in rows of its own (the kernel's general call, as
    # at hops 2 and 4), so x, q_self and qs are each read once from HBM
    q = torch.randn(m, D, device="cuda", generator=gen)
    ms = cuda_ms(torch, lambda: mc.shard_comp_mix_block(x, q, qs, w, M),
                 iters=10, warmup=2)
    plain_ms = cuda_ms(torch, lambda: mc.shard_comp_mix_block_plain(
        x, q, qs, w, M), iters=5, warmup=1)
    library_ms = cuda_ms(torch, lambda: torch.matmul(M, qs), iters=10,
                         warmup=2)
    bytes_moved = 4 * (m + m + K + m) * D      # read x, q_self, qs; write o
    bound_ms, bound_by = _bound(bytes_moved, flops)
    print(f"[kernel] shard_cmix m={m} K={K} D={D}, q_self its own rows: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.matmul(M_r, qs) (the mix only) {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms by {bound_by} "
          f"({bytes_moved / (ms * 1e-3) / 1e9:.0f} GB/s achieved)",
          flush=True)
    # the path's hop-1 call: q_self is a view of qs's self block, whose
    # second read the cache serves, so HBM moves x, qs and o only
    del q
    q = qs[:m]
    view_ms = cuda_ms(torch, lambda: mc.shard_comp_mix_block(x, q, qs, w, M),
                      iters=10, warmup=2)
    view_bound, _ = _bound(4 * (m + K + m) * D, flops)
    print(f"[kernel] shard_cmix m={m} K={K} D={D}, q_self a view of qs (the "
          f"path at hop 1): kernel {view_ms:.4f} ms, bound "
          f"{view_bound:.4f} ms by bytes", flush=True)
    print(f"[kernel] shard_cmix: {cases} kernel-vs-plain cases within "
          f"tolerance, max abs err {worst:.3e}", flush=True)
    del x, qs, q
    torch.cuda.empty_cache()
    return {"name": "shard_cmix_kernel", "route": "cuda",
            "source": "src/repro_torch/csrc/shard_cmix.cu",
            "replaces": "src/repro/kernels/mixing_pallas.py:924",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


# -- slice 5: the substrate kernel entry points (kernels/ops.py) -----------
# (B, Sq, Sk, H, KH, D, causal, window, softcap): the reference kernel
# test's sweep (tests/test_kernels.py), then rows with no valid key
FLASH_SWEEP = ((1, 64, 64, 4, 2, 32, True, None, None),
               (2, 100, 100, 4, 4, 16, True, 32, None),
               (1, 48, 48, 2, 1, 64, True, None, 50.0),
               (2, 32, 32, 8, 8, 8, False, None, None),
               (1, 128, 128, 2, 2, 128, True, None, None),
               (1, 17, 33, 3, 1, 24, False, None, None),
               (1, 256, 256, 1, 1, 64, True, 64, 30.0))
FLASH_MASKED = (1, 40, 16, 2, 1, 16, True, 4, None)   # rows 20..39: no key
# head dims past 128, where the kernel takes 32-row kv tiles: D = 256 with
# gemma2-9b's GQA, softcap and window at small S, ragged and Sq != Sk; D =
# 160, whose last pass over 64 output columns is partial
FLASH_WIDE = ((2, 300, 300, 4, 2, 256, True, None, 50.0),
              (1, 700, 700, 16, 8, 256, True, 256, 50.0),
              (1, 77, 200, 4, 1, 256, False, None, None),
              (1, 130, 130, 2, 1, 160, True, 50, 30.0))
# csrc/flash_attention.cu vs twin, (atol, rtol).  float32: the reference
# suite's 2e-5.  bf16 and float16 (the views and head dims that kernel
# takes): both round an fp32 result that differs only by summation order
# (about 1e-6 at most), so the two are equal or adjacent, at most one ulp
# of the output apart: rtol 2^-7 (bf16) and 2^-10 (fp16) of |o|, atol 1e-5
# for that order.  csrc/flash_attention_wgmma.cu (bf16 and fp16) rounds p
# to q's type before p·v: flash_attention_cuda.wgmma_tolerance (atol 1e-5
# + 2^-9 max|v| bf16, 2^-11 fp16; rtol one output ulp) and the RMS error
# against the float64 twin at most WGMMA_RMS_RATIO times the fp32 twin's.
FLASH_TOL = {"torch.float32": (2e-5, 2e-5),
             "torch.bfloat16": (1e-5, 2.0 ** -7),
             "torch.float16": (1e-5, 2.0 ** -10)}
FLASH_MODEL_TOL = 2e-2      # vs models.attention._sdpa: the suite's bf16
NORM_SWEEP = ((8, 64), (3, 7, 96), (1, 128), (5, 256), (1001, 768))
# rows the vector instance does not take: 196- and 392-byte rows, rows past
# its 8192 bytes
NORM_SCALAR = ((7, 98), (4, 5000))
NORM_TOL = {"torch.float32": 1e-5, "torch.bfloat16": 1e-2,
            "torch.float16": 1e-3}


def substrate_shapes() -> tuple:
    """The slice's full-width calls, from the two model configs.

    pga-lm-100m (``configs/pga_lm_100m.py``): 12 heads of 64, d_model 768;
    the trainer's global batch 32 × seq 512 (8 nodes × 4 sequences) folded
    into B.  gemma2-9b (``configs/gemma2_9b.py``, arXiv:2408.00118): 16
    query heads and 8 kv heads of 256, d_model 3584, logit softcap 50,
    window 4096 on its ``attn_sw`` layers, over Gemma 2's 8192-token
    context.  Returns ``(attention, norms)``: name → ``((B, Sq, Sk, H, KH,
    D), causal, window, softcap)`` and name → ``((N, D), offsets)``."""
    from repro_torch.configs import get_model_config

    lm = get_model_config("pga-lm-100m")
    gm = get_model_config("gemma2-9b")
    lm_tokens, gm_tokens = 32 * 512, 8192
    lm_dims = (32, 512, 512, lm.n_heads, lm.n_kv_heads, lm.resolved_head_dim)
    gm_dims = (1, gm_tokens, gm_tokens, gm.n_heads, gm.n_kv_heads,
               gm.resolved_head_dim)
    attention = {
        "lm100m_attn": (lm_dims, True, None, None),
        "gemma2_global": (gm_dims, True, None, gm.attn_logit_softcap),
        "gemma2_local": (gm_dims, True, gm.sliding_window,
                         gm.attn_logit_softcap)}
    norms = {"lm100m_norm": ((lm_tokens, lm.d_model), (0.0,)),
             "gemma2_norm": ((gm_tokens, gm.d_model), (0.0, 1.0))}
    return attention, norms


def flash_work(B, Sq, Sk, H, KH, D, causal, window, itemsize=2):
    """``(bytes, flops, pairs)`` of one attention call: read q, k, v and
    write o once each; 4·D operations (two multiply-adds per element of
    D) for every unmasked (q, k) pair of every head and batch; ``pairs``
    the unmasked pairs of one head."""
    import numpy as np

    i = np.arange(Sq)
    lo = np.maximum(0, i - window + 1) if window is not None \
        else np.zeros_like(i)
    hi = np.minimum(Sk, i + 1) if causal else np.full_like(i, Sk)
    pairs = int(np.maximum(0, hi - lo).sum())
    bytes_moved = itemsize * (2 * B * Sq * H * D + 2 * B * Sk * KH * D)
    return bytes_moved, 4 * D * pairs * B * H, pairs


def rmsnorm_work(N, D, itemsize=2, w_itemsize=4):
    """``(bytes, flops)`` of one RMSNorm call: read x and w, write y once
    each; per element a square-add, two multiplies and the offset add."""
    return 2 * N * D * itemsize + D * w_itemsize, 4 * N * D


def _flash_inputs(torch, gen, B, Sq, Sk, H, KH, D, dtype, packed=False):
    """q, k, v on the card; ``packed`` makes them views of one (B, S,
    H + 2·KH, D) projection output (the kernel reads their strides)."""
    if packed:
        assert Sq == Sk
        qkv = torch.randn(B, Sq, H + 2 * KH, D, device="cuda",
                          generator=gen).to(dtype)
        return qkv[:, :, :H], qkv[:, :, H:H + KH], qkv[:, :, H + KH:]
    return tuple(torch.randn(s, device="cuda", generator=gen).to(dtype)
                 for s in ((B, Sq, H, D), (B, Sk, KH, D), (B, Sk, KH, D)))


def _over_tol(torch, got, want, atol, rtol=None) -> float:
    """max(|got − want| − atol − rtol·|want|): positive where an element
    is outside the tolerance (``rtol`` defaults to ``atol``)."""
    rtol = atol if rtol is None else rtol
    g, w = got.float(), want.float()
    return float(((g - w).abs() - atol - rtol * w.abs()).max())


def check_flash_kernel(torch, fa) -> list:
    """Both flash attention kernels vs their plain twin on the card, each
    case's launch checked: float32 goes to ``flash_attention.cu``, bf16 and
    float16 to ``flash_attention_wgmma.cu``, except the operands that
    :func:`~repro_torch.kernels.flash_attention_cuda.use_wgmma` leaves to
    the first (a head dim of 12, views whose strides are not 16-byte
    multiples).  Cases: the reference sweep (7) in float32 and bf16, the
    rows-without-a-key case (those rows exactly 0), four cases at D = 256
    and 160, q, k, v as strided views of one packed projection, float16 at
    two shapes, the two bf16 cases of the fp32 kernel, and the three
    full-width calls in float32 and bf16.  Tolerance (:data:`FLASH_TOL`):
    2e-5 atol and rtol in float32, the reference suite's; one output ulp
    plus 1e-5 for the fp32 kernel in bf16; for the tensor-core kernel
    ``wgmma_tolerance`` and the RMS error against the float64 twin at most
    ``WGMMA_RMS_RATIO`` times the fp32 twin's.  The lm100m call is also
    held to the port model's ``_sdpa`` (one node), whose bf16 products
    round the scores and probabilities to bf16, at the suite's bf16 2e-2.
    Timing of each full-width bf16 call by :func:`device_ms`: the
    tensor-core kernel, ``flash_attention.cu`` on the same operands, and
    ``scaled_dot_product_attention`` at lm100m (no PyTorch call computes
    the softcapped gemma2 function; SDPA with ``enable_gqa`` and no cap is
    printed as a yardstick at gemma2_global), the twin by :func:`cuda_ms`
    as a caller sees it, against the bound (bytes at 3.35 TB/s, operations
    at the bf16 tensor-core rate); the fp32 call at lm100m against its own
    bound (4-byte operands, operations at the fp32 rate) and SDPA in
    float32.  Returns the records of ``flash_attention.cu`` (the float32
    path) and ``flash_attention_wgmma.cu``."""
    from repro_torch.models import attention as tattn

    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst, ratios, n_cases = {}, [], 0

    def compare(args, dtype, packed=False, where="", operands=None,
                expect=None):
        nonlocal n_cases
        (B, Sq, Sk, H, KH, D), causal, window, cap = args
        q, k, v = operands or _flash_inputs(torch, gen, B, Sq, Sk, H, KH, D,
                                            dtype, packed)
        expect = expect or ("flash" if dtype == torch.float32
                            else "flash_wgmma")
        kw = dict(causal=causal, window=window, softcap=cap)
        torch.cuda.synchronize()
        reset_counts()
        o = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        if counts() != only(**{expect: 1}):
            raise AssertionError(f"flash {where} {args} {dtype}: launches "
                                 f"{counts()}, expected one {expect}")
        r = fa.flash_attention_plain(q, k, v, **kw)
        if not bool(torch.isfinite(o).all()):
            raise AssertionError(f"flash {where} {args} {dtype}: not finite")
        wgmma = expect == "flash_wgmma"
        tol = fa.wgmma_tolerance(v) if wgmma else FLASH_TOL[str(dtype)]
        over = _over_tol(torch, o, r, *tol)
        err = float((o.float() - r.float()).abs().max())
        if over > 0:
            raise AssertionError(f"flash {where} {args} {dtype} ({expect}): "
                                 f"max abs err {err:.3e} beyond tolerance")
        if wgmma:
            exact = fa.flash_attention_plain(q.double(), k.double(),
                                             v.double(), **kw)
            ratio = fa.rms_ratio(o, r, exact)
            if not ratio <= fa.WGMMA_RMS_RATIO:
                raise AssertionError(f"flash {where} {args} {dtype}: RMS error"
                                     f" {ratio:.3f} x the fp32 twin's, over "
                                     f"{fa.WGMMA_RMS_RATIO}")
            ratios.append(ratio)
            del exact
        key = f"{expect} {str(dtype)[6:]}"
        worst[key] = max(worst.get(key, 0.0), err)
        n_cases += 1
        return q, k, v, o

    for case in FLASH_SWEEP + (FLASH_MASKED,) + FLASH_WIDE:
        args = (case[:6],) + case[6:]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, o = compare(args, dtype, where="sweep")
            if case is FLASH_MASKED:
                assert torch.equal(o[:, 20:], torch.zeros_like(o[:, 20:]))
    for dtype in (torch.float32, torch.bfloat16):
        compare(((2, 300, 300, 8, 2, 64), True, 100, None), dtype,
                packed=True, where="packed views")
    for args in (((1, 256, 256, 1, 1, 64), True, 64, 30.0),
                 ((2, 500, 500, 12, 12, 64), True, None, None)):
        compare(args, torch.float16, where="fp16")
    # bf16 operands the fp32 kernel takes: D = 12, and views of a width-28
    # projection (56-byte head strides)
    compare(((1, 64, 64, 4, 2, 12), True, None, None), torch.bfloat16,
            where="D = 12", expect="flash")
    wide = torch.randn(2, 100, 6, 28, device="cuda", generator=gen).to(
        torch.bfloat16)
    compare(((2, 100, 100, 4, 1, 24), True, 16, None), torch.bfloat16,
            where="misaligned views", expect="flash",
            operands=(wide[:, :, :4, :24], wide[:, :, 4:5, :24],
                      wide[:, :, 5:, :24]))
    del wide
    attention, _ = substrate_shapes()
    timings = {}
    for name, args in attention.items():
        dims, causal, window, cap = args
        kw = dict(causal=causal, window=window, softcap=cap)
        q, k, v, o = compare(args, torch.float32, where=name)
        if name == "lm100m_attn":
            ms = device_ms(torch, lambda: fa.flash_attention(q, k, v, **kw))
            plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, **kw), iters=5, warmup=1)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            library_ms = device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True))
            bytes_moved, flops, _ = flash_work(*dims, causal, window,
                                               itemsize=4)
            bound_ms, bound_by = _bound(bytes_moved, flops)
            timings["fp32"] = (ms, plain_ms, bound_ms, bound_by, library_ms)
            print(f"[kernel] flash {name} {dims} float32 (flash_attention.cu)"
                  f": kernel {ms:.4f} ms on the card, plain {plain_ms:.4f} "
                  f"ms, scaled_dot_product_attention(is_causal=True) "
                  f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms by "
                  f"{bound_by} (fp32 operations at 67 TFLOP/s, "
                  f"{bytes_moved / 1e6:.1f} MB)", flush=True)
            del qt, kt, vt
        del q, k, v, o
        torch.cuda.empty_cache()
        q, k, v, o = compare(args, torch.bfloat16, where=name)
        heavy = dims[1] >= 4096
        iters, p_iters = (5, 2) if heavy else (20, 5)
        event_ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, **kw),
                           iters=iters, warmup=1)
        ms = device_ms(torch, lambda: fa.flash_attention(q, k, v, **kw),
                       iters=iters, warmup=1)
        simt_ms = device_ms(torch, lambda: fa.flash_simt(q, k, v, **kw),
                            iters=p_iters, warmup=1)
        plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, **kw), iters=p_iters, warmup=1)
        library_ms = None
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if name == "lm100m_attn":
            B, S, H, KH, D = dims[0], dims[1], dims[3], dims[4], dims[5]
            pos = torch.arange(S, device="cuda")[None].expand(B, S)
            mask = tattn.attention_mask(pos, pos, causal=True, window=None)
            model = tattn._sdpa(q.reshape(1, B, S, KH, H // KH, D), k[None],
                                v[None], mask, scale=1.0 / math.sqrt(D))
            model = model.reshape(B, S, H, D)
            over = _over_tol(torch, o, model, FLASH_MODEL_TOL)
            model_err = float((o.float() - model.float()).abs().max())
            if over > 0:
                raise AssertionError(f"flash {name} vs models.attention._sdpa"
                                     f": max abs err {model_err:.3e}")
            del model, mask
            library_ms = device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True))
            extra = (f", scaled_dot_product_attention(is_causal=True) "
                     f"{library_ms:.4f} ms (kernel / SDPA "
                     f"{ms / library_ms:.2f}); vs models.attention._sdpa max "
                     f"abs err {model_err:.3e}")
        elif window is None:
            gqa_ms = device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True),
                iters=iters, warmup=1)
            extra = (f", no PyTorch call computes the softcapped function "
                     f"(yardstick, not the same function: "
                     f"scaled_dot_product_attention(is_causal=True, "
                     f"enable_gqa=True) without softcap {gqa_ms:.4f} ms)")
        else:
            extra = ", no PyTorch call computes the softcapped function"
        del qt, kt, vt
        bytes_moved, flops, pairs = flash_work(*dims, causal, window)
        b_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        f_ms = flops / BF16_TC_FLOP_PER_S * 1e3
        bound_ms, bound_by = max(b_ms, f_ms), ("bytes" if b_ms >= f_ms
                                               else "operations")
        timings[name] = (ms, plain_ms, bound_ms, bound_by, library_ms)
        print(f"[kernel] flash {name} (B, Sq, Sk, H, KH, D)={dims} "
              f"causal={causal} window={window} softcap={cap} bf16: "
              f"flash_attention_wgmma.cu {ms:.4f} ms on the card "
              f"({event_ms:.4f} ms host-paced; "
              f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
              f"{bound_ms / ms:.1%} of the bound), "
              f"flash_attention.cu {simt_ms:.4f} ms ({simt_ms / ms:.1f}x), "
              f"plain {plain_ms:.4f} ms{extra}; {pairs:,} unmasked pairs per "
              f"head, {flops:.4e} flops, {bytes_moved / 1e6:.1f} MB: bound "
              f"{bound_ms:.4f} ms by {bound_by}", flush=True)
        del q, k, v, o
        torch.cuda.empty_cache()
    print(f"[kernel] flash: {n_cases} kernel-vs-plain cases within "
          f"tolerance, max abs err "
          + ", ".join(f"{e:.3e} {t}" for t, e in worst.items())
          + f"; tensor-core RMS error {min(ratios):.3f}-{max(ratios):.3f} x "
          f"the fp32 twin's (limit {fa.WGMMA_RMS_RATIO}); rows without a "
          f"valid key exactly 0", flush=True)
    records = []
    for key, kernel, source in (
            ("fp32", "flash_attention_kernel", "flash_attention.cu"),
            ("lm100m_attn", "flash_attention_wgmma_kernel",
             "flash_attention_wgmma.cu")):
        ms, plain_ms, bound_ms, bound_by, library_ms = timings[key]
        err = max(e for t, e in worst.items()
                  if t.startswith("flash_wgmma") == (key != "fp32"))
        records.append({
            "name": kernel, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": "src/repro/kernels/flash_attention.py:36",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms})
    return records


def check_rmsnorm_kernel(torch, rn) -> dict:
    """RMSNorm kernel vs its plain twin on the card, each case's instance
    checked (:func:`~repro_torch.kernels.rmsnorm_cuda.use_vector`): the
    reference sweep (4 shapes) and a ragged 1001 rows in float32 and bf16,
    offsets 0 and 1, w in float32 and in x's dtype, float16 at the ragged
    shape (all the vector instance), two shapes the scalar instance takes
    (rows of 196 and 392 bytes; rows past the vector instance's 8192
    bytes), then the full-width calls in bf16.  Tolerance (atol and rtol):
    1e-5 float32, 1e-2 bf16 (the reference suite's), 1e-3 float16 (one
    output ulp).
    Timing over four copies of x in turn (no call finds its input in L2):
    the vector instance, the scalar instance on the same rows and the
    library by :func:`device_ms` (a call takes tens of microseconds on the
    card, less than the wrapper takes on the host, so host-paced CUDA
    events time the host), the twin by :func:`cuda_ms`; against the bytes
    bound and ``torch.nn.functional.rms_norm`` (w cast to x's dtype;
    offset 0, the function it computes)."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(7)
    worst, n_cases = 0.0, 0

    def compare(shape, dtype, offset, w_dtype=torch.float32, where="",
                expect="rmsnorm_vector"):
        nonlocal worst, n_cases
        x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        w = torch.randn(shape[-1], device="cuda", generator=gen).to(w_dtype)
        torch.cuda.synchronize()
        reset_counts()
        y = rn.rmsnorm(x, w, offset=offset, block_rows=4)
        torch.cuda.synchronize()
        if counts() != only(**{expect: 1}):
            raise AssertionError(f"rmsnorm {where} {shape} {dtype}: launches "
                                 f"{counts()}, expected one {expect}")
        r = rn.rmsnorm_plain(x, w, offset=offset)
        assert y.shape == x.shape and y.dtype == x.dtype
        err = float((y.float() - r.float()).abs().max())
        if _over_tol(torch, y, r, NORM_TOL[str(dtype)]) > 0:
            raise AssertionError(f"rmsnorm {where} {shape} {dtype} offset="
                                 f"{offset} w {w_dtype}: max abs err "
                                 f"{err:.3e} beyond tolerance")
        worst = max(worst, err)
        n_cases += 1
        return x, w

    for shape in NORM_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            for offset in (0.0, 1.0):
                compare(shape, dtype, offset, where="sweep")
        compare(shape, torch.bfloat16, 1.0, torch.bfloat16, where="w bf16")
        compare(shape, torch.float16, 0.0, where="fp16")
    for shape in NORM_SCALAR:
        for dtype in (torch.float32, torch.bfloat16):
            compare(shape, dtype, 1.0, where="scalar", expect="rmsnorm")
    _, norms = substrate_shapes()
    timings = {}
    for name, (shape, offsets) in norms.items():
        for offset in offsets:
            x, w = compare(shape, torch.bfloat16, offset, where=name)
            # four copies of x (100 MB and more) cycled, so no call finds
            # its input in the 50 MB L2
            xs = itertools.cycle([x] + [x.clone() for _ in range(3)])
            event_ms = cuda_ms(torch, lambda: rn.rmsnorm(next(xs), w,
                                                         offset=offset))
            ms = device_ms(torch, lambda: rn.rmsnorm(next(xs), w,
                                                     offset=offset))
            scalar_ms = device_ms(torch, lambda: rn.rmsnorm_scalar(
                next(xs), w, offset=offset))
            plain_ms = cuda_ms(torch, lambda: rn.rmsnorm_plain(
                next(xs), w, offset=offset))
            wx = w.to(x.dtype)
            library_ms = device_ms(torch, lambda: F.rms_norm(
                next(xs), (shape[-1],), wx, 1e-6)) if offset == 0.0 \
                else None
            bytes_moved, flops = rmsnorm_work(*shape)
            bound_ms, bound_by = _bound(bytes_moved, flops)
            lib = (f"F.rms_norm {library_ms:.4f} ms (kernel / library "
                   f"{ms / library_ms:.2f})" if library_ms is not None
                   else "no PyTorch call adds the offset")
            print(f"[kernel] rmsnorm {name} x {shape} bf16, w fp32, offset "
                  f"{offset}: vector instance {ms:.4f} ms on the card "
                  f"({event_ms:.4f} ms host-paced), scalar instance "
                  f"{scalar_ms:.4f} ms, plain {plain_ms:.4f} ms, {lib}, "
                  f"bound {bound_ms:.4f} ms by {bound_by} "
                  f"({bytes_moved / 1e6:.1f} MB, "
                  f"{bytes_moved / (ms * 1e-3) / 1e9:.0f} GB/s achieved)",
                  flush=True)
            timings.setdefault(name, (ms, plain_ms, bound_ms, bound_by,
                                      library_ms))
            del x, w, wx, xs
    print(f"[kernel] rmsnorm: {n_cases} kernel-vs-plain cases within "
          f"tolerance, max abs err {worst:.3e}", flush=True)
    ms, plain_ms, bound_ms, bound_by, library_ms = timings["lm100m_norm"]
    return {"name": "rmsnorm_kernel", "route": "cuda",
            "source": "src/repro_torch/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm.py:16",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def run_ops_path(torch) -> dict:
    """Slice 5's path: the entry points of ``repro_torch.kernels.ops`` at
    full width, as a caller of the reference's ``repro.kernels.ops`` calls
    them: ``flash_attention_op`` on the three attention shapes,
    ``rmsnorm_op`` on the three norm calls and ``mlstm_chunk_op`` once at
    the serving shape (B = 8, S = 2048, xlstm-125m's heads), all in bf16,
    then ``mlstm_chunk_op`` on the same inputs and ``flash_attention_op``
    on pga-lm-100m's attention in float32.  Each call's launch counts are
    set to 0 just before it and read just after: exactly one launch of its
    kernel and none of another (bf16 attention and mLSTM the tensor-core
    kernels, float32 the fp32 ones, the norms the vector instance); the
    plain twins are replaced by a function that raises for the whole
    phase.  Returns the launches per kernel."""
    from repro_torch.kernels import flash_attention_cuda as fa
    from repro_torch.kernels import mlstm_cuda as mk
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm_cuda as rn

    gen = torch.Generator(device="cuda").manual_seed(8)
    attention, norms = substrate_shapes()
    calls = []
    for name, (dims, causal, window, cap) in attention.items():
        qkv = _flash_inputs(torch, gen, *dims, torch.bfloat16)
        calls.append((name, "flash_wgmma", lambda qkv=qkv, kw=dict(
            causal=causal, window=window, softcap=cap):
            ops.flash_attention_op(*qkv, **kw)))
    for name, (shape, offsets) in norms.items():
        x = torch.randn(shape, device="cuda", generator=gen).to(
            torch.bfloat16)
        w = torch.randn(shape[-1], device="cuda", generator=gen)
        for offset in offsets:
            calls.append((f"{name} offset={offset}", "rmsnorm_vector",
                          lambda x=x, w=w, offset=offset: ops.rmsnorm_op(
                              x, w, offset=offset)))
    S = 2048
    m_args = mlstm_inputs(torch, gen, 8, S, MLSTM_FULL["nh"],
                          MLSTM_FULL["dk"], MLSTM_FULL["dv"], torch.bfloat16,
                          gates="model")
    calls.append(("mlstm B=8 S=2048", "mlstm_wgmma",
                  lambda: ops.mlstm_chunk_op(*m_args,
                                             chunk=MLSTM_FULL["chunk"])))
    m_args32 = [t.float() for t in m_args]
    calls.append(("mlstm B=8 S=2048 float32", "mlstm",
                  lambda: ops.mlstm_chunk_op(*m_args32,
                                             chunk=MLSTM_FULL["chunk"])))
    dims, causal, window, cap = attention["lm100m_attn"]
    qkv32 = _flash_inputs(torch, gen, *dims, torch.float32)
    calls.append(("lm100m_attn float32", "flash",
                  lambda: ops.flash_attention_op(*qkv32, causal=causal,
                                                 window=window, softcap=cap)))

    def refuse(*_, **__):
        raise AssertionError("[ops] a plain twin ran on the card")

    twins = ((fa, "flash_attention_plain"), (rn, "rmsnorm_plain"),
             (mk, "mlstm_chunk_plain"))
    saved = [getattr(mod, attr) for mod, attr in twins]
    total = {k: 0 for k in counts()}
    try:
        for mod, attr in twins:
            setattr(mod, attr, refuse)
        for name, kernel, call in calls:
            torch.cuda.synchronize()
            reset_counts()
            out = call()
            torch.cuda.synchronize()
            launches = counts()
            if launches != only(**{kernel: 1}):
                raise AssertionError(f"[ops] {name}: launches {launches}, "
                                     f"expected one {kernel}")
            finite = bool(torch.isfinite(out).all())
            if not finite:
                raise AssertionError(f"[ops] {name}: output not finite")
            total[kernel] += 1
            print(f"[ops] {name}: out {tuple(out.shape)} {out.dtype}, finite "
                  f"{finite}, max|o| {float(out.float().abs().max()):.4f}, "
                  f"launches {launches}", flush=True)
            del out
    finally:
        for (mod, attr), fn in zip(twins, saved):
            setattr(mod, attr, fn)
    del calls, m_args, m_args32, qkv32
    torch.cuda.empty_cache()
    print(f"[ops] {len(attention) + 1} flash_attention_op, "
          f"{sum(len(o) for _, o in norms.values())} rmsnorm_op, 2 "
          f"mlstm_chunk_op calls through their kernels: {total}", flush=True)
    return total


COMPRESSED = dict(comm_compression="int8", comm_global_compression="int8",
                  comm_error_feedback=True)


def counts() -> dict:
    from repro_torch.kernels import flash_attention_cuda as fa
    from repro_torch.kernels import mixing_cuda as mc
    from repro_torch.kernels import mlstm_cuda as mk
    from repro_torch.kernels import rmsnorm_cuda as rn
    return {"mix": mc.mix_flat.launches,
            "mix_vector": mc.mix_flat.vector_launches,
            "cmix": mc.cmix_flat.launches,
            "cmix_vector": mc.cmix_flat.vector_launches,
            "cmix_absmax": mc.cmix_flat.absmax_launches,
            "collective": mc.collective_flat.launches,
            "mlstm": mk.mlstm_chunk.launches,
            "mlstm_wgmma": mk.mlstm_chunk.wgmma_launches,
            "shard_mix": mc.shard_mix_block.launches,
            "shard_cmix": mc.shard_comp_mix_block.launches,
            "flash": fa.flash_attention.launches,
            "flash_wgmma": fa.flash_attention.wgmma_launches,
            "rmsnorm": rn.rmsnorm.launches,
            "rmsnorm_vector": rn.rmsnorm.vector_launches}


def only(**launches) -> dict:
    """The launch counts of a path that launches only the named kernels."""
    return {**{k: 0 for k in counts()}, **launches}


# synchronizing calls per step of each trainer path, and where in the
# source the last step of each made them (sync_steps)
SYNCS, SYNC_SITES = {}, {}


def sync_steps(torch, fn, sites=None):
    """``(fn(), synchronizing calls)``: the calls that
    ``torch.cuda.set_sync_debug_mode("warn")`` reports while ``fn`` runs
    (a device read, a pageable copy, a stream or device synchronize).
    ``sites`` (a dict) gets the count per ``file:line`` of the Python
    frame that made each."""
    import warnings
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    found = [w for w in caught if "synchroniz" in str(w.message)]
    if sites is not None:
        sites.clear()
        for w in found:
            where = (f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}")
            sites[where] = sites.get(where, 0) + 1
    return out, len(found)


def reset_counts() -> None:
    from repro_torch.kernels import flash_attention_cuda as fa
    from repro_torch.kernels import mixing_cuda as mc
    from repro_torch.kernels import mlstm_cuda as mk
    from repro_torch.kernels import rmsnorm_cuda as rn
    fa.flash_attention.launches = 0
    fa.flash_attention.wgmma_launches = 0
    rn.rmsnorm.launches = 0
    rn.rmsnorm.vector_launches = 0
    mc.mix_flat.launches = 0
    mc.mix_flat.vector_launches = 0
    mc.cmix_flat.launches = 0
    mc.cmix_flat.vector_launches = 0
    mc.cmix_flat.absmax_launches = 0
    mc.collective_flat.launches = 0
    mk.mlstm_chunk.launches = 0
    mk.mlstm_chunk.wgmma_launches = 0
    mc.shard_mix_block.launches = 0
    mc.shard_comp_mix_block.launches = 0


def run_main_path(torch, mc, compressed: bool = False,
                  sharded: bool = False):
    """One main path at full width for 6 steps; returns ``(launches per
    kernel, trainer, state)``.  Slice 1: fused rounds with the consensus
    residual.  Slice 2 (``compressed``): int8 gossip + int8 collective
    with error feedback.  Slice 4 (``sharded``): either of them on a mesh
    of 4 node shards on the card, ``comm_shard_mode="sharded"``: one
    per-shard kernel launch per shard per gossip round, the global rounds
    in plain PyTorch (the sum over the shards; the compressed collective's
    owner segments)."""
    from repro_torch.configs import (DistConfig, OptimizerConfig,
                                     TrainConfig, get_model_config)
    from repro_torch.core.mesh import make_mesh
    from repro_torch.train import Trainer
    from repro_torch.tree import tree_leaves

    steps, n_nodes = 6, 8
    tag = ("[s" if sharded else "[") + ("cmain]" if compressed else "main]")
    shards = n_nodes // SHARD_M
    mesh = make_mesh((shards,), ("data",)) if sharded else None
    tcfg = TrainConfig(
        model=get_model_config("pga-lm-100m"),
        dist=DistConfig(algorithm="gossip_pga", topology="one_peer_exp",
                        H=3, comm_backend="pallas",
                        comm_shard_mode="sharded" if sharded else "auto",
                        **(COMPRESSED if compressed else {})),
        # total_steps covers the profiled step after the 6 (lr > 0 there)
        optimizer=OptimizerConfig(name="adamw", lr=3e-4,
                                  schedule="warmup_cosine", warmup_steps=2,
                                  total_steps=steps + 2),
        global_batch=32, seq_len=512, steps=steps, log_every=1)
    tr = Trainer(tcfg, n_nodes=n_nodes, mesh=mesh, with_consensus=True)
    state = tr.init_state(torch.Generator().manual_seed(0))
    leaves = tree_leaves(state.params)
    per_node = sum(p.numel() for p in leaves) // n_nodes
    groups = mc._dispatch_groups(leaves, tcfg.dist.pallas_leaf_threshold)
    if sharded:
        print(f"{tag} pga-lm-100m on a mesh of {shards} node shards of "
              f"{SHARD_M} nodes on one card ({mesh.shape}, "
              f"{'compressed int8+EF' if compressed else 'uncompressed'}): "
              f"{per_node:,} params per node, {n_nodes} nodes, one "
              f"{'shard_cmix' if compressed else 'shard_mix'} launch per "
              f"shard per gossip round over {per_node:,} packed columns",
              flush=True)
    elif compressed:
        print(f"{tag} pga-lm-100m compressed: {per_node:,} params per node,"
              f" {n_nodes} nodes, {len(leaves)} leaves (one cmix_absmax "
              f"and one cmix launch each per gossip round), one collective "
              f"launch per global "
              f"round over {per_node:,} packed columns", flush=True)
    else:
        widths = [sum(leaves[i][0].numel() for i in g) for g in groups]
        print(f"{tag} pga-lm-100m: {per_node:,} params per node, {n_nodes} "
              f"nodes, {len(groups)} kernel launches per round (group "
              f"widths {widths})", flush=True)
    tokens = tcfg.global_batch * tcfg.seq_len
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, phases, syncs = [], [], []
    for k in range(steps):
        t0 = time.perf_counter()
        state, n_sync = sync_steps(
            torch, lambda: tr.run(state, steps=1, log_every=1),
            SYNC_SITES.setdefault(tag, {}))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        times.append(dt)
        syncs.append(n_sync)
        rec = tr.history[-1]
        phases.append(rec["phase"])
        print(f"{tag} step {k} phase={rec['phase']} loss={rec['loss']:.4f}"
              f" consensus={rec['consensus']:.6e} step_ms={dt * 1e3:.1f} "
              f"tokens/s={tokens / dt:.0f} max_mem_GB="
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} "
              f"synchronizing_calls={n_sync} launches={counts()}",
              flush=True)
        if not math.isfinite(rec["loss"]):
            raise AssertionError(f"step {k}: loss {rec['loss']}")
        if rec["phase"] == "global" and not compressed:
            assert rec["consensus"] == 0.0, rec
        else:
            # a compressed global round keeps each node's own state at full
            # precision: the nodes differ by their stage-1 residuals
            assert rec["consensus"] > 0.0, rec
    launches = counts()
    gossip, glob = phases.count("gossip"), phases.count("global")
    if sharded:
        key = "shard_cmix" if compressed else "shard_mix"
        expected = only(**{key: gossip * shards})
    elif compressed:
        expected = only(cmix_vector=gossip * len(leaves),
                        cmix_absmax=gossip * len(leaves), collective=glob)
    else:
        expected = only(mix_vector=len(groups) * steps)
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
    SYNCS[tag] = syncs
    print(f"{tag} {steps} steps through the kernels ({launches}); steady "
          f"step {steady * 1e3:.1f} ms (median of steps 1-5), "
          f"{tokens / steady:.0f} tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; synchronizing "
          f"calls per step {syncs}, step {steps - 1}'s by source line "
          f"{SYNC_SITES[tag]}", flush=True)
    return launches, tr, state


KERNEL_KINDS = (("shard kernels", ("shard_mix_kernel", "shard_cmix_kernel")),
                ("cmix round", ("cmix_kernel", "cmix_vector_kernel",
                                "absmax")),
                ("mix round", ("mix_kernel", "mix_vector_kernel",
                               "sum_partials")),
                ("mlstm kernel", ("mlstm_kernel",)),
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
    profile_report(prof, wall_ms, "[profile]", "profiled step")


def profile_report(prof, wall_ms: float, tag: str, what: str) -> None:
    """Device busy share of ``wall_ms``, device time by kernel kind and the
    top kernels of one ``torch.profiler`` window."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    busy = sum(t for t, _ in by_name.values())
    print(f"{tag} {what}: wall {wall_ms:.1f} ms, device busy "
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
        print(f"{tag} {kind:12s} {t:9.3f} ms "
              f"({100 * t / max(busy, 1e-9):.1f}% of device time)",
              flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (t, c) in top:
        print(f"{tag} {t:9.3f} ms {c:5d}x {name[:100]}", flush=True)


def compressed_round_times(torch, mc, tr, state) -> None:
    """One compressed gossip round (int8 + EF, one row maxima and one cmix
    launch per leaf) and one compressed global round (packing, one
    collective launch, unpacking), each timed alone by CUDA events against
    the bytes bound of its kernels (read x and e, write o and e'; the
    gossip round reads x and e once more for its scales); the gossip round
    again on contiguous copies of the leaves, then once more under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import compress as C
    from repro_torch.tree import tree_leaves, tree_map

    dist = tr.tcfg.dist
    comp = C.make_compressor(dist.comm_compression)
    gcomp = C.make_compressor(dist.comm_global_compression)
    leaves = tree_leaves(state.params)
    moved = sum(4 * 4 * p.numel() for p in leaves)
    bound = moved / HBM_BYTES_PER_S * 1e3

    def gossip(params=state.params, ef_state=state.ef_state):
        mc.compressed_step_mix(params, compressor=comp, ef_state=ef_state,
                               seed=3, phase="gossip",
                               topology=dist.topology, n_nodes=tr.n_nodes,
                               step=1)

    def global_round():
        mc.collective_step_mix(state.params, compressor=gcomp,
                               ef_state=state.ef_state, seed=3,
                               phase="global", n_nodes=tr.n_nodes)

    g_ms = cuda_ms(torch, gossip, iters=5, warmup=1)
    c_ms = cuda_ms(torch, global_round, iters=5, warmup=1)
    # the state after a global round holds views into the collective's
    # packed output (rows D apart), which the round copies into
    # contiguous rows; the same round on contiguous copies of the leaves
    params = tree_map(lambda t: t.contiguous(), state.params)
    ef_state = tree_map(lambda t: t.contiguous(), state.ef_state)
    views = sum(not t.is_contiguous() for t in tree_leaves(state.params))
    gc_ms = cuda_ms(torch, lambda: gossip(params, ef_state), iters=5,
                    warmup=1)
    del params, ef_state
    print(f"[cround] one compressed gossip round (int8+EF, {len(leaves)} "
          f"cmix_absmax and {len(leaves)} cmix launches): {g_ms:.3f} ms on "
          f"the state as the last (global) step left it ({views} of "
          f"{len(leaves)} leaves views), {gc_ms:.3f} ms on contiguous "
          f"copies (bound {bound * 1.5:.3f} ms with the maxima's pass over "
          f"x and e); one compressed global round (pack, collective, "
          f"unpack): {c_ms:.3f} ms; bound of each round's cmix or "
          f"collective launches {bound:.3f} ms ({moved / 1e9:.2f} GB)",
          flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gossip()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    profile_report(prof, wall_ms, "[cprofile]",
                   "one compressed gossip round")


def sharded_round_times(torch, mc, tr, state, compressed: bool) -> None:
    """One sharded round of each phase timed by CUDA events beside the
    stacked round on the same state, in turns (stacked, sharded, sharded,
    stacked).  Uncompressed: gossip at hop 1 (4 shard_mix launches of K =
    4 halo rows) and global, each with the consensus residual; compressed:
    int8 + EF gossip and the int8 collective.  The bound is that of the
    sharded gossip round's kernels alone (bytes at the HBM rate)."""
    from repro_torch.core import mixing
    from repro_torch.tree import tree_leaves

    dist = tr.tcfg.dist
    spec = dist.comm_spec(tr.n_nodes, mesh=tr.mesh)
    if not compressed:
        spec = spec.replace(compressor=None, global_compressor=None)
    D = sum(p[0].numel() for p in tree_leaves(state.params))
    k, m = tr.n_nodes // SHARD_M, SHARD_M
    # per shard at hop 1 (K = 2m): shard_cmix reads x and qs (q_self is
    # a view of qs's self block, read again from the cache) and writes o;
    # shard_mix reads x, xs and writes o and the column sums
    per_shard = (m + 2 * m + m) * D if compressed \
        else (m + 2 * m + m + 1) * D
    bound_ms = k * 4 * per_shard / HBM_BYTES_PER_S * 1e3

    def run(sp, phase):
        if compressed:
            mixing.communicate(state.params, sp, phase=phase, step=0,
                               ef_state=state.ef_state, seed=3)
        elif sp.mesh is None:
            mc.mix_residual(state.params, phase=phase,
                            topology=dist.topology, n_nodes=tr.n_nodes,
                            step=0, leaf_threshold=dist.pallas_leaf_threshold)
        else:
            mixing.communicate_sharded(state.params, sp, phase=phase,
                                       step=0, with_residual=True)

    stacked = spec.replace(mesh=None, shard_mode="auto")
    for phase in ("gossip", "global"):
        t = [cuda_ms(torch, lambda: run(sp, phase), iters=3, warmup=1)
             for sp in (stacked, spec, spec, stacked)]
        bound = (f"bound of its {k} shard kernels {bound_ms:.3f} ms"
                 if phase == "gossip" else "no shard kernel")
        print(f"[sround] {'compressed int8+EF ' if compressed else ''}"
              f"{phase} round: sharded {t[1]:.3f} / {t[2]:.3f} ms, stacked "
              f"{t[0]:.3f} / {t[3]:.3f} ms (in turns); {bound}", flush=True)
        torch.cuda.empty_cache()


def _serving_config(torch, reduced: bool = False, dtype: str = "bfloat16"):
    """xlstm-125m with the hand-written mLSTM kernel on the prefill path."""
    from repro_torch.configs import get_model_config

    cfg = get_model_config("xlstm-125m", reduced=reduced)
    return dataclasses.replace(cfg, dtype=dtype, ssm=dataclasses.replace(
        cfg.ssm, use_pallas_mlstm=True))


def run_serving_path(torch) -> int:
    """Slice 3's main path at full width: xlstm-125m (12 layers, 10 mLSTM
    blocks) with ``use_pallas_mlstm=True``, one replica on the card,
    random weights from seed 0.  (a) ``Engine.generate`` on 8 prompts of
    2000 tokens (31 whole chunks and a tail of 16), 32 new tokens, greedy;
    (b) ``BatchedServer.run`` with prompts of 6, 100, 1000 and 2048 tokens
    on 2 slots, 16 new tokens each.  The launch counts are set to 0 just
    before each and read just after: 10 launches of the tensor-core mLSTM
    kernel per prefill (bf16 q, k, v, the model's einsum views), no other
    kernel.  Returns its launches in (a) and (b)."""
    import numpy as np

    from repro_torch.models.model import make_model
    from repro_torch.serve import BatchedServer, Engine, Request
    from repro_torch.tree import tree_leaves

    cfg = _serving_config(torch)
    model = make_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cuda")
    n_params = sum(p.numel() for p in tree_leaves(params))
    n_mlstm = sum(kind[0] == "mlstm" for kind in cfg.layers)
    rng = np.random.default_rng(0)
    B, S0, n_new = 8, 2000, 32
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S0))).to(
        device="cuda", dtype=torch.int32)
    engine = Engine(model, s_max=S0 + n_new)
    print(f"[serve] xlstm-125m: {n_params:,} params, {n_mlstm} mLSTM "
          f"blocks, use_pallas_mlstm=True, bf16 compute", flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    ids = engine.generate(params, prompts, n_new)
    gen_s = time.perf_counter() - t0
    launches_a = counts()
    if launches_a != only(mlstm_wgmma=n_mlstm):
        raise AssertionError(f"[serve] generate launches {launches_a}, "
                             f"expected {n_mlstm} mlstm_wgmma (one "
                             f"prefill)")
    peak_a = torch.cuda.max_memory_allocated() / 1e9
    assert ids.shape == (B, n_new), ids.shape
    assert ((ids >= 0) & (ids < cfg.vocab_size)).all()

    # the same traffic's parts timed alone, outside the counted run
    def prefill():
        return engine.prefill(params, prompts)

    t0 = time.perf_counter()
    logits, caches = prefill()
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    assert bool(torch.isfinite(logits).all()), "prefill logits not finite"
    assert all(bool(torch.isfinite(t.float()).all())
               for t in tree_leaves(caches)), "cache not finite"
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    pos = torch.full((B,), S0, dtype=torch.int32, device="cuda")
    engine.decode_step(params, caches, tok, pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_new):
        out, caches = engine.decode_step(params, caches, tok, pos + i)
        tok = torch.argmax(out, dim=-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / n_new
    again = engine.generate(params, prompts, n_new)
    if not np.array_equal(ids, again):
        raise AssertionError("[serve] a second generate gave other ids")
    from torch.profiler import ProfilerActivity, profile
    for what, fn in (("one prefill", prefill),
                     ("4 decode steps", lambda: [
                         engine.decode_step(params, caches, tok, pos)
                         for _ in range(4)])):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        profile_report(prof, wall_ms, "[sprofile]", what)
    print(f"[serve] (a) Engine.generate B={B} S={S0} +{n_new} greedy: "
          f"{gen_s * 1e3:.1f} ms in all, {B * n_new / gen_s:.1f} generated "
          f"tokens/s; prefill alone {prefill_ms:.1f} ms "
          f"({B * S0 / prefill_ms * 1e3:.0f} prompt tokens/s), decode "
          f"{decode_ms:.2f} ms/token ({B / decode_ms * 1e3:.1f} tokens/s at "
          f"B={B}); peak memory {peak_a:.2f} GB; launches {launches_a}; "
          f"logits finite, a second run gives the same ids", flush=True)
    del logits, caches, out

    lengths, max_new = (6, 100, 1000, 2048), 16
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=s),
                    max_new=max_new) for i, s in enumerate(lengths)]
    server = BatchedServer(Engine(model, s_max=max(lengths) + max_new),
                           params, n_slots=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    done = server.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches_b = counts()
    if launches_b != only(mlstm_wgmma=n_mlstm * len(lengths)):
        raise AssertionError(f"[serve] batched launches {launches_b}, "
                             f"expected {n_mlstm} mlstm_wgmma per prefill "
                             f"× {len(lengths)}")
    assert sorted(r.uid for r in done) == list(range(len(lengths)))
    for r in done:
        assert r.done and len(r.generated) == max_new, r
        assert all(0 <= t < cfg.vocab_size for t in r.generated), r
    print(f"[serve] (b) BatchedServer prompts {lengths} on 2 slots, "
          f"+{max_new} each: {run_s * 1e3:.1f} ms, "
          f"{len(lengths) * max_new / run_s:.1f} generated tokens/s, peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"launches {launches_b}; every request answered", flush=True)
    return launches_a["mlstm_wgmma"] + launches_b["mlstm_wgmma"]


def serving_cross_check(torch) -> None:
    """Reduced xlstm-125m at float32 compute with the kernel, one init on
    the card (kernel) and on the CPU (plain twin): prefill logits and every
    cache leaf within 1e-4 · max|cpu| (the kernel and the twin, cuBLAS and
    the CPU's BLAS sum in other orders), and the same greedy ids over 8
    decode steps."""
    import numpy as np

    from repro_torch import interop
    from repro_torch.models.model import make_model
    from repro_torch.serve import Engine
    from repro_torch.tree import tree_leaves

    model = make_model(_serving_config(torch, reduced=True,
                                       dtype="float32"))
    init = interop.to_numpy(model.init(torch.Generator().manual_seed(1),
                                       "cpu"))
    prompts = np.random.default_rng(1).integers(0, model.cfg.vocab_size,
                                                (2, 37)).astype(np.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        params = interop.from_numpy(init, dev)
        eng = Engine(model, s_max=64)
        logits, caches = eng.prefill(params, torch.from_numpy(prompts).to(
            dev))
        ids = eng.generate(params, prompts, 8)
        out[dev] = ([logits.cpu().numpy()] + [
            t.float().cpu().numpy() for t in tree_leaves(caches)], ids)
    worst = 0.0
    for a, b in zip(*(out[d][0] for d in ("cuda", "cpu"))):
        assert np.isfinite(a).all() and a.shape == b.shape
        ratio = float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                 1e-30)
        worst = max(worst, ratio)
    if worst > 1e-4:
        raise AssertionError(f"[xcross] cuda vs cpu: {worst:.3e} of max|ref|")
    if not np.array_equal(out["cuda"][1], out["cpu"][1]):
        raise AssertionError(f"[xcross] greedy ids differ: {out['cuda'][1]} "
                             f"vs {out['cpu'][1]}")
    print(f"[xcross] reduced xlstm fp32, kernel on cuda vs twin on cpu: "
          f"logits and {len(out['cpu'][0]) - 1} cache leaves within "
          f"{worst:.3e} of max|cpu|; greedy ids over 8 steps equal "
          f"{out['cuda'][1].tolist()}", flush=True)


def _cross_config(compressed: bool, algorithm: str = "gossip_pga",
                  dist_kw=None):
    from repro_torch.configs import (DistConfig, OptimizerConfig,
                                     TrainConfig, get_model_config)

    model = dataclasses.replace(
        get_model_config("pga-lm-100m", reduced=True), dtype="float32")
    dist = dict(algorithm=algorithm, topology="one_peer_exp",
                comm_backend="pallas")
    dist.update(dist_kw if dist_kw is not None else {"H": 2})
    dist.update(COMPRESSED if compressed else {})
    return TrainConfig(
        model=model,
        dist=DistConfig(**dist),
        optimizer=OptimizerConfig(name="sgd", lr=0.05, schedule="constant",
                                  warmup_steps=0),
        global_batch=8, seq_len=64, log_every=1)


def cross_check(torch, compressed: bool = False, sharded: bool = False,
                algorithm: str = "gossip_pga", dist_kw=None,
                steps: int = 3) -> None:
    """Reduced config at fp32 compute, 4 nodes, 3 steps (gossip, global,
    gossip), card (kernels) vs CPU (plain versions) from one init; with
    ``algorithm`` and ``dist_kw`` one of ``[algos]``' runs at reduced width
    over ``steps`` (``[xalgos]``), the phases equal and the consensus after
    a global or SlowMo outer step exactly 0.0 in both.
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
    from repro_torch.core.mesh import make_mesh
    from repro_torch.models.model import make_model
    from repro_torch.train import Trainer

    tcfg = _cross_config(compressed, algorithm, dist_kw)
    init = interop.to_numpy(make_model(tcfg.model).init(
        torch.Generator().manual_seed(1), "cpu"))
    runs = {}
    labels = (("cuda", True), ("cpu", True), ("cuda", False)) if sharded \
        else (("cuda", False), ("cpu", False))
    for dev, on_mesh in labels:
        mesh = make_mesh((2,), ("data",), device=dev) if on_mesh else None
        tr = Trainer(tcfg, n_nodes=4, mesh=mesh, with_consensus=True,
                     device=dev)
        st = tr.init_state(params=interop.from_numpy(init, dev))
        st = tr.run(st, steps=steps, log_every=1)
        trees = [st.params] + ([st.ef_state] if compressed else [])
        runs[dev, on_mesh] = ([interop.to_numpy(t) for t in trees],
                              tr.history)
    pairs = [(labels[0], labels[1])] + (
        [(labels[0], labels[2])] if sharded else [])
    what = ("compressed int8+EF trainer (params and EF)" if compressed
            else "trainer")
    tag = "[scross]" if sharded else "[cross]"
    if algorithm != "gossip_pga":
        tag, what = "[xalgos]", f"{algorithm} {dist_kw} trainer"
    for a, b in pairs:
        name = " vs ".join(f"{dev} {'sharded' if m else 'stacked'}"
                           for dev, m in (a, b))
        _compare_runs(runs[a], runs[b], compressed,
                      f"{tag} reduced fp32 {what}, {name} over {steps} "
                      f"steps")


def _compare_runs(ra_runs, rb_runs, compressed: bool, title: str,
                  push: bool = False) -> None:
    """Hold run a against run b with :func:`cross_check`'s tolerances and
    print the differences.  ``push``: push-sum runs, whose global round is
    a dense 1/n W (each row summed in its own order), so their consensus
    after it is rounding noise, held to atol 1e-10 instead of exactly 0.0;
    their mass per step to atol 1e-6."""
    import numpy as np

    from repro_torch.tree import tree_leaves

    worst, off, size, steps = 0.0, 0, 0, 0.0
    cpu_params = tree_leaves(rb_runs[0][0])
    for ta, tb in zip(ra_runs[0], rb_runs[0]):
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
        raise AssertionError(f"{title}: {off} of {size} elements off, max "
                             f"abs diff {worst:.3e} = {steps:.2f} code "
                             f"steps")
    for ra, rb in zip(ra_runs[1], rb_runs[1]):
        assert ra["phase"] == rb["phase"]
        np.testing.assert_allclose(ra["loss"], rb["loss"], rtol=1e-4)
        np.testing.assert_allclose(ra["consensus"], rb["consensus"],
                                   rtol=1e-2 if compressed else 1e-4,
                                   atol=1e-10 if push else 0.0)
        if push:
            np.testing.assert_allclose(ra["mass"], rb["mass"], rtol=0,
                                       atol=1e-6)
        elif ra["phase"] in ("global", "slowmo") and not compressed:
            assert ra["consensus"] == rb["consensus"] == 0.0, (ra, rb)
    print(f"{title}: phases {[r['phase'] for r in ra_runs[1]]}; max abs "
          f"diff {worst:.3e} ({steps:.2f} code steps of "
          f"its leaf), {off} of {size} elements beyond rtol 1e-4 + atol "
          f"1e-6; losses {[round(r['loss'], 6) for r in ra_runs[1]]}, "
          f"consensus {[r['consensus'] for r in ra_runs[1]]} vs "
          f"{[r['consensus'] for r in rb_runs[1]]}", flush=True)


# ---------------------------------------------------------------------------
# Slice 7: the paper's simulator on the §5.1 logistic problem ([sim],
# [simx]) and the Trainer with the four new algorithms at full width
# ([algos])
# ---------------------------------------------------------------------------
SIM_ALGORITHMS = ("parallel", "gossip", "local", "gossip_pga", "gossip_aga",
                  "slowmo", "hier_pga", "gt_pga")
# paper §5.1 at its largest network (bench_logistic_transient.py --full):
# ring, H = 16, lr 0.2 halved every 1000 steps, batch 8 per node
SIM = dict(n=100, M=8000, d=10, H=16, steps=3000, eval_every=50, batch=8)
SIM_EXTRA = {"hier_pga": dict(aga_kwargs={"n_pods": 4, "hier_h_pod": 4})}
# the compressed case, on the same problem (n = 100 takes collective.cu's
# untiled instance)
SIM_COMPRESSED = dict(compression="int8", error_feedback=True,
                      global_compression="int8")
# the non-IID crossover of benchmarks/bench_logistic_transient.py:120-175
NONIID = dict(n=16, M=500, d=10, steps=400, alpha=0.3, feature_shift=2.0,
              lr=0.05, H=16)
NONIID_GATES = (4.0, 10.0)       # gt <= 4 x gossip(IID); gossip >= 10 x gt
# [simx]: the CPU tests' setup (tests/test_torch_algorithms.py) at n = 16
SIMX = dict(n=16, M=500, d=10, steps=40, eval_every=5, H=8, lr=0.2)
SIMX_EXTRA = {"hier_pga": dict(aga_kwargs={"n_pods": 2, "hier_h_pod": 3}),
              "gossip_aga": dict(aga_kwargs={"aga_h_init": 2,
                                              "aga_warmup": 10})}


def sim_lr(k: int) -> float:
    return 0.2 * (0.5 ** (k // 1000))   # paper §5.1


def f_star(torch, prob, steps: int = 4000, lr: float = 0.05) -> float:
    """f* of the average objective by full-batch gradient descent (the
    reference benchmark's ``f_star``, restated: ``benchmarks/`` imports
    the JAX package)."""
    H, y = prob.H, prob.y
    x = torch.zeros(prob.d, device=H.device)
    with torch.no_grad():
        for _ in range(steps):
            z = -y * torch.einsum("nmd,d->nm", H, x)
            g = -torch.einsum("nm,nmd->d", torch.sigmoid(z) * y,
                              H) / (prob.n * prob.M)
            x = x - lr * g
        return float(prob.loss_fn()(x))


# [sim]'s f* and parallel SGD's suboptimality integral, which [psim]'s
# AUCs are taken against
SIM_REFERENCE = {}


class PlainCalls:
    """Counts calls of the mix, cmix, collective and shard plain twins
    while active (the wrappers look them up in their module at each
    call)."""
    NAMES = ("mix_flat_plain", "cmix_flat_plain", "cmix_absmax_plain",
             "collective_flat_plain", "shard_mix_block_plain",
             "shard_comp_mix_block_plain")

    def __init__(self, mc):
        self.mc, self.calls, self.saved = mc, 0, {}

    def __enter__(self):
        for name in self.NAMES:
            fn = self.saved[name] = getattr(self.mc, name)

            def counted(*a, _fn=fn, **kw):
                self.calls += 1
                return _fn(*a, **kw)
            setattr(self.mc, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.mc, name, fn)


def replay_phases(algorithm: str, steps: int, losses_at, **dist_kw) -> list:
    """Each step's phase, from the port's schedule fed the losses the run
    observed (``losses_at(k)``: the loss observed after step k, or None):
    Gossip-AGA's phases depend on them."""
    from repro_torch.configs import DistConfig
    from repro_torch.core.schedule import make_schedule
    sched = make_schedule(DistConfig(algorithm=algorithm, **dist_kw))
    phases = []
    for k in range(steps):
        phases.append(sched.advance(k))
        f = losses_at(k)
        if f is not None:
            sched.observe_loss(k, f)
    return phases


def sim_round_launches(torch, mc, algorithm: str, phases, n: int, d: int,
                       compressed: bool) -> dict:
    """The dispatch rule's launches for a ``simulate(backend="pallas")``
    run, stated before it runs: one round per gossip/global/pod_avg step
    (none for SlowMo's outer step or Local SGD's "none"); uncompressed,
    one mix.cu launch a round (the joint tree of GT-PGA, params and
    tracker, packs into one (n, 2d) staging buffer), on the register
    instance where ``use_vector_mix`` takes the (n, width) operand;
    compressed (one leaf), a gossip round is one row maxima and one
    cmix.cu launch, a global round one collective.cu launch."""
    kinds = mc.KERNEL_PHASES
    rounds = [ph for ph in phases if ph in kinds]
    if compressed:
        x = torch.empty(n, d, device="cuda")
        gossip = rounds.count("gossip")
        key = "cmix_vector" if mc.use_vector_cmix(x, x) else "cmix"
        return only(**{key: gossip, "cmix_absmax": gossip,
                       "collective": len(rounds) - gossip})
    width = 2 * d if algorithm == "gt_pga" else d
    x = torch.empty(n, width, device="cuda")
    key = "mix_vector" if mc.use_vector_mix(x, x) else "mix"
    return only(**{key: len(rounds)})


def _sim_run(torch, prob, algorithm: str, *, steps, lr, H, eval_every,
             backend="pallas", batch=0, device="cuda", grad_fn=None,
             topology="ring", **kw):
    from repro_torch.core import simulate
    return simulate(algorithm=algorithm,
                    grad_fn=grad_fn or prob.grad_fn(batch=batch),
                    loss_fn=prob.loss_fn(),
                    x0=torch.zeros(prob.d, device=device), n=prob.n,
                    steps=steps, lr=lr, topology=topology, H=H,
                    eval_every=eval_every, seed=0, backend=backend,
                    device=device, **kw)


def _sim_checked(torch, mc, prob, algorithm: str, tag: str, *,
                 compressed=False, **run_kw) -> tuple:
    """One ``simulate`` on the card: launch counts against the dispatch
    rule, no plain twin, finite losses, and the consensus after every
    uncompressed global round that an eval falls on: exactly 0.0 for n a
    power of two; for other n the mean of n equal float32 rows is not
    always exact, so at most rounding level (1e-12).  Returns ``(out,
    wall ms per step, launches)``."""
    torch.cuda.synchronize()
    reset_counts()
    with PlainCalls(mc) as plain:
        t0 = time.perf_counter()
        out = _sim_run(torch, prob, algorithm, **run_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = counts()
    steps = run_kw["steps"]
    dist_kw = dict(H=run_kw["H"], **run_kw.get("aga_kwargs", {}))
    losses = dict(zip(out["iteration"].tolist(), out["loss"].tolist()))
    last = [None]

    def losses_at(k):
        last[0] = losses.get(k, last[0])
        return last[0]

    phases = replay_phases(algorithm, steps, losses_at, **dist_kw)
    expected = sim_round_launches(torch, mc, algorithm, phases, prob.n,
                                  prob.d, compressed)
    if launches != expected:
        raise AssertionError(f"{tag} {algorithm}: launches {launches}, the "
                             f"dispatch rule gives {expected}")
    if plain.calls:
        raise AssertionError(f"{tag} {algorithm}: {plain.calls} plain-twin "
                             f"calls on the card")
    if not all(math.isfinite(f) for f in out["loss"]):
        raise AssertionError(f"{tag} {algorithm}: loss {out['loss']}")
    exact = prob.n & (prob.n - 1) == 0
    for k, c in zip(out["iteration"].tolist(), out["consensus"].tolist()):
        if phases[k] == "global" and not compressed:
            if (c != 0.0) if exact else (abs(c) > 1e-12):
                raise AssertionError(f"{tag} {algorithm}: consensus {c!r} "
                                     f"after the global round of step {k}")
    return out, wall * 1e3 / steps, launches


def run_sim_path(torch, mc) -> dict:
    """[sim]: paper §5.1 at n = 100 (M = 8000, d = 10, non-IID), all eight
    algorithms through ``simulate(backend="pallas")`` and one compressed
    run, then the non-IID crossover gates.  Returns the launch counts
    summed over the phase's runs."""
    import numpy as np

    from repro_torch.data import (dirichlet_noniid_problem,
                                  make_logistic_problem)
    total = {k: 0 for k in counts()}
    t_phase = time.perf_counter()
    prob = make_logistic_problem(SIM["n"], SIM["M"], SIM["d"], iid=False,
                                 seed=0)
    fs = f_star(torch, prob)
    print(f"[sim] §5.1 logistic problem n={SIM['n']} M={SIM['M']} "
          f"d={SIM['d']} non-IID, ring, H={SIM['H']}, lr 0.2 halved every "
          f"1000 steps, batch {SIM['batch']}, {SIM['steps']} steps, "
          f"backend pallas; f* = {fs:.8f} (4000 full-batch GD steps)",
          flush=True)
    run_kw = dict(steps=SIM["steps"], lr=sim_lr, H=SIM["H"],
                  eval_every=SIM["eval_every"], batch=SIM["batch"])
    aucs, sub_ref = {}, None
    for alg in SIM_ALGORITHMS:
        out, ms, launches = _sim_checked(torch, mc, prob, alg, "[sim]",
                                         **run_kw, **SIM_EXTRA.get(alg, {}))
        for k, v in launches.items():
            total[k] += v
        sub = out["loss"] - fs
        if alg == "parallel":
            sub_ref = sub
        aucs[alg] = float(np.trapezoid(sub) / max(np.trapezoid(sub_ref),
                                                  1e-12))
        used = {k: v for k, v in launches.items() if v}
        line = (f"[sim] {alg:10s} final loss {out['loss'][-1]:.8f} "
                f"consensus {out['consensus'][-1]:.6e} AUC vs parallel "
                f"{aucs[alg]:.4f}; {ms:.4f} ms/step wall, launches {used} "
                f"({sum(used.values()) / SIM['steps']:.4f} per step)")
        if "H_history" in out:
            line += f"; H_history {out['H_history'].tolist()}"
        print(line, flush=True)
    SIM_REFERENCE.update(f_star=fs, parallel_auc=float(
        np.trapezoid(sub_ref)))
    print(f"[sim] AUC ordering (printed, one seed): PGA "
          f"{aucs['gossip_pga']:.4f} <= 1.05 x Gossip {aucs['gossip']:.4f}: "
          f"{aucs['gossip_pga'] <= 1.05 * aucs['gossip']}; PGA <= 1.05 x "
          f"Local {aucs['local']:.4f}: "
          f"{aucs['gossip_pga'] <= 1.05 * aucs['local']}", flush=True)
    # one compressed run: int8 gossip + EF, int8 collective
    out, ms, launches = _sim_checked(torch, mc, prob, "gossip_pga", "[sim]",
                                     compressed=True, **run_kw,
                                     **SIM_COMPRESSED)
    for k, v in launches.items():
        total[k] += v
    used = {k: v for k, v in launches.items() if v}
    print(f"[sim] gossip_pga int8+EF gossip, int8 collective, n="
          f"{prob.n}: final loss {out['loss'][-1]:.8f} consensus "
          f"{out['consensus'][-1]:.6e}; {ms:.4f} ms/step wall, launches "
          f"{used}", flush=True)
    del prob
    # the non-IID crossover: deterministic (full batch, constant lr)
    floor = 1e-9
    pn = dirichlet_noniid_problem(NONIID["n"], NONIID["M"], NONIID["d"],
                                  alpha=NONIID["alpha"],
                                  feature_shift=NONIID["feature_shift"],
                                  seed=0)
    pi = make_logistic_problem(NONIID["n"], NONIID["M"], NONIID["d"],
                               iid=True, seed=0)
    fs_n, fs_i = f_star(torch, pn), f_star(torch, pi)
    cross_kw = dict(steps=NONIID["steps"], lr=NONIID["lr"], H=NONIID["H"],
                    eval_every=25)
    subs = {}
    for name, prob, fs_p, alg in (("gt", pn, fs_n, "gt_pga"),
                                  ("gossip", pn, fs_n, "gossip"),
                                  ("iid", pi, fs_i, "gossip"),
                                  ("pga", pn, fs_n, "gossip_pga")):
        out, _, launches = _sim_checked(torch, mc, prob, alg, "[sim]",
                                        **cross_kw)
        for k, v in launches.items():
            total[k] += v
        subs[name] = max(float(np.mean(out["loss"][-4:])) - fs_p, floor)
    gt_vs_iid = subs["gt"] / subs["iid"]
    stall = subs["gossip"] / subs["gt"]
    print(f"[sim] non-IID crossover (n={NONIID['n']}, M={NONIID['M']}, "
          f"alpha {NONIID['alpha']}, shift {NONIID['feature_shift']}, full "
          f"batch, lr {NONIID['lr']}, H={NONIID['H']}, {NONIID['steps']} "
          f"steps): tail suboptimality gt_pga {subs['gt']:.3e}, gossip "
          f"{subs['gossip']:.3e}, gossip IID {subs['iid']:.3e}, gossip_pga "
          f"{subs['pga']:.3e}; gt/IID {gt_vs_iid:.3f} (gate <= "
          f"{NONIID_GATES[0]}), gossip/gt {stall:.3f} (gate >= "
          f"{NONIID_GATES[1]})", flush=True)
    if gt_vs_iid > NONIID_GATES[0] or stall < NONIID_GATES[1]:
        raise AssertionError("[sim] non-IID crossover gate failed")
    del pn, pi
    print(f"[sim] phase wall time {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return total


def run_sim_cross_check(torch) -> None:
    """[simx]: ``simulate`` with full gradients at n = 16 on the card
    (kernels) and on the CPU (plain versions), every algorithm and the
    compressed case.  Uncompressed runs are held to the CPU tests'
    tolerances (tests/test_torch_algorithms.py): loss rtol 2e-6,
    consensus rtol 5e-6 + atol 1e-12, AGA's H_history equal.  Compressed
    runs (int8 gossip + EF, int8 collective) take their gradients from the
    CPU run's function on a CPU copy of the iterate: the card's einsum
    sums in another order, and a rounding difference on a code boundary
    would move a stochastic-rounding code.  cmix.cu and collective.cu are
    bitwise their twins, so every iterate the card run hands its gradient
    function must be bitwise the CPU run's, and the loss and consensus,
    taken on each device from the same iterates, are held to the
    uncompressed tolerances."""
    import numpy as np

    from repro_torch.data import make_logistic_problem
    t0 = time.perf_counter()
    probs = {dev: make_logistic_problem(SIMX["n"], SIMX["M"], SIMX["d"],
                                        seed=0, device=dev)
             for dev in ("cuda", "cpu")}
    cpu_grad = probs["cpu"].grad_fn(0)

    def traced(log, on_cpu):
        def grad(x, generator, k):
            log.append(x.cpu())
            if on_cpu:
                return cpu_grad(log[-1], None, k).to(x.device)
            return probs[x.device.type].grad_fn(0)(x, generator, k)
        return grad

    worst, iterates = {}, 0
    cases = [(alg, {}) for alg in SIM_ALGORITHMS] + \
        [("gossip_pga", SIM_COMPRESSED), ("hier_pga", SIM_COMPRESSED)]
    for alg, comp in cases:
        kw = dict(steps=SIMX["steps"], lr=SIMX["lr"], H=SIMX["H"],
                  eval_every=SIMX["eval_every"], slowmo_beta=0.5,
                  slowmo_lr=0.7, **SIMX_EXTRA.get(alg, {}), **comp)
        xa, xb = [], []
        a = _sim_run(torch, probs["cuda"], alg, device="cuda",
                     grad_fn=traced(xa, bool(comp)), **kw)
        b = _sim_run(torch, probs["cpu"], alg, device="cpu",
                     grad_fn=traced(xb, False), **kw)
        what = f"[simx] {alg}{' int8+EF' if comp else ''} card vs CPU"
        if comp:
            if len(xa) != len(xb) or not all(
                    torch.equal(u, v) for u, v in zip(xa, xb)):
                k = next((k for k, (u, v) in enumerate(zip(xa, xb))
                          if not torch.equal(u, v)), None)
                raise AssertionError(f"{what}: the iterate of step {k} "
                                     f"differs")
            iterates += len(xa)
        np.testing.assert_array_equal(a["iteration"], b["iteration"])
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=2e-6,
                                   err_msg=what)
        np.testing.assert_allclose(a["consensus"], b["consensus"],
                                   rtol=5e-6, atol=1e-12, err_msg=what)
        if "H_history" in b:
            assert a["H_history"].tolist() == b["H_history"].tolist(), what
        big = np.abs(b["consensus"]) > 1e-12
        kind = "compressed" if comp else "uncompressed"
        w = worst.setdefault(kind, [0.0, 0.0])
        w[0] = max(w[0], float(np.max(np.abs(a["loss"] - b["loss"])
                                      / np.abs(b["loss"]))))
        if big.any():
            w[1] = max(w[1], float(np.max(
                np.abs(a["consensus"] - b["consensus"])[big]
                / np.abs(b["consensus"])[big])))
    print(f"[simx] simulate card vs CPU, n={SIMX['n']} M={SIMX['M']} full "
          f"gradients, {SIMX['steps']} steps, {len(cases)} runs (eight "
          f"algorithms; gossip_pga and hier_pga int8+EF, {iterates} "
          f"iterates bitwise equal): max relative difference of loss and "
          f"consensus "
          f"{ {k: [f'{v:.3e}' for v in w] for k, w in worst.items()} }; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


ALGO_RUNS = (("slowmo", dict(H=3, slowmo_beta=0.5)),
             ("hier_pga", dict(H=6, n_pods=2, hier_h_pod=2)),
             ("gt_pga", dict(H=3)),
             ("gossip_aga", dict(aga_h_init=2, aga_warmup=2)))


def run_algo_path(torch, mc, algorithm: str, dist_kw: dict) -> dict:
    """[algos]: the Trainer on pga-lm-100m at full width with one of the
    four new algorithms, 8 nodes stacked on the card, fused rounds with
    the consensus residual, AdamW, global batch 32 × seq 512, 6 steps.
    The launch counts are reset just before and read just after; they must
    be the dispatch rule's: one mix.cu launch per dispatch group of the
    round's tree (the joint params + tracker tree for GT-PGA) per
    gossip/pod_avg/global step, none for SlowMo's outer step.  The phases
    must be the schedule's, fed the run's losses, and the consensus after
    every global (and SlowMo outer) step exactly 0.0."""
    from repro_torch.configs import (DistConfig, OptimizerConfig,
                                     TrainConfig, get_model_config)
    from repro_torch.core import algo as algo_lib
    from repro_torch.train import Trainer
    from repro_torch.tree import tree_leaves

    steps, n_nodes = 6, 8
    t_phase = time.perf_counter()
    tcfg = TrainConfig(
        model=get_model_config("pga-lm-100m"),
        dist=DistConfig(algorithm=algorithm, topology="one_peer_exp",
                        comm_backend="pallas", **dist_kw),
        optimizer=OptimizerConfig(name="adamw", lr=3e-4,
                                  schedule="warmup_cosine", warmup_steps=2,
                                  total_steps=steps),
        global_batch=32, seq_len=512, steps=steps, log_every=1)
    tr = Trainer(tcfg, n_nodes=n_nodes, with_consensus=True)
    state = tr.init_state(torch.Generator().manual_seed(0))
    impl = algo_lib.get_algorithm(algorithm)
    joint = algo_lib.join_payload(
        impl.comm_payload(state.extras, state.params), state.params)
    leaves = tree_leaves(joint)
    groups = mc._dispatch_groups(leaves, tcfg.dist.pallas_leaf_threshold)
    vector = all(mc.use_vector_mix(
        leaves[g[0]].reshape(n_nodes, -1) if len(g) == 1 else
        torch.empty(n_nodes, sum(leaves[i][0].numel() for i in g),
                    device="cuda")) for g in groups)
    extra_gb = sum(p.numel() * p.element_size()
                   for name in state.extras
                   for p in tree_leaves(state.extras[name])) / 1e9
    tokens = tcfg.global_batch * tcfg.seq_len
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    for k in range(steps):
        t0 = time.perf_counter()
        state = tr.run(state, steps=1, log_every=1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = counts()
    recs = tr.history[-steps:]
    phases = [r["phase"] for r in recs]
    losses = [r["loss"] for r in recs]
    want_phases = replay_phases(algorithm, steps, lambda k: losses[k],
                                topology="one_peer_exp", **dist_kw)
    for k, r in enumerate(recs):
        print(f"[algos] {algorithm} step {k} phase={r['phase']} "
              f"loss={r['loss']:.4f} consensus={r['consensus']:.6e} "
              f"step_ms={times[k] * 1e3:.1f}", flush=True)
        if not math.isfinite(r["loss"]):
            raise AssertionError(f"[algos] {algorithm} step {k}: {r}")
        if r["phase"] in ("global", "slowmo") and r["consensus"] != 0.0:
            raise AssertionError(f"[algos] {algorithm} step {k}: consensus "
                                 f"{r['consensus']!r} after a "
                                 f"{r['phase']} step")
    if phases != want_phases:
        raise AssertionError(f"[algos] {algorithm}: phases {phases}, the "
                             f"schedule gives {want_phases}")
    rounds = sum(ph in mc.KERNEL_PHASES for ph in phases)
    expected = only(**{("mix_vector" if vector else "mix"):
                       len(groups) * rounds})
    if launches != expected:
        raise AssertionError(f"[algos] {algorithm}: launches {launches}, "
                             f"expected {expected}")
    steady = statistics.median(times[1:])
    line = (f"[algos] {algorithm} {dist_kw}: phases {phases}; launches "
            f"{ {k: v for k, v in launches.items() if v} } ({len(groups)} "
            f"per round x {rounds} rounds); steady step {steady * 1e3:.1f} "
            f"ms (median of steps 1-5), {tokens / steady:.0f} tokens/s, "
            f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
            f"(extras {extra_gb:.2f} GB)")
    if hasattr(tr.schedule, "history"):
        line += f"; H_history {tr.schedule.history}"
    print(line + f"; phase wall time {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    del tr, state
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Slice 8: push-sum gossip and fault injection ([psmain], [pscmain],
# [spsmain], [pscross], [psim])
# ---------------------------------------------------------------------------
# nodes 2 and 5 drop at step 1 and rejoin at 4, and every node draws its
# own hop each step ("peer"): step 2 is a global round over 6 active
# nodes, step 5 a full one
PUSH_FAULTS = dict(n_nodes=8, drops={1: (2, 5)}, rejoins={4: (2, 5)},
                   resample="peer", seed=0)
PUSH_DROPPED = (2, 5)
PUSH_MASS_TOL = 8e-5
# push-sum forbids the compressed collective: int8 gossip + EF only
PUSH_COMPRESSED = dict(comm_compression="int8", comm_error_feedback=True)
# [pscross]: node 1 of 4 down at steps 1 and 2, per-node hops
PUSH_CROSS_FAULTS = dict(n_nodes=4, drops={1: (1,)}, rejoins={3: (1,)},
                         resample="peer", seed=0)


def _row_copies(tree, rows) -> list:
    """Host copies of the node rows ``rows`` of every node-stacked leaf of
    ``tree`` (no device allocation)."""
    from repro_torch.tree import tree_leaves
    return [lf[i].cpu() for lf in tree_leaves(tree)
            if lf.dim() and lf.shape[0] == MAIN_N for i in rows]


def push_expected_launches(mc, tr, state, phases, compressed: bool,
                           sharded: bool) -> tuple:
    """The dispatch rule's launches for a push path's steps, stated before
    they run, and the instance each dispatch group takes.  Stacked: one
    mix.cu launch per dispatch group of the joint ``{"x": params, "w":
    weight}`` tree per round; every operand is a fresh contiguous tensor
    (the staging buffer, or the optimizer's output), so the rule
    ``use_vector_mix`` reads n and the width only.  Compressed: a gossip
    round is one row maxima and one cmix.cu launch per params leaf (the
    weight is mixed by one matmul), a global round the uncompressed one.
    Sharded: one shard_mix launch per shard per round."""
    from repro_torch.tree import tree_leaves
    n = tr.n_nodes
    rounds = sum(ph in mc.KERNEL_PHASES for ph in phases)
    gossip = phases.count("gossip")
    if sharded:
        return only(shard_mix=rounds * (n // SHARD_M)), {}
    leaves = tree_leaves({"x": state.params, "w": state.push_weight})
    groups = mc._dispatch_groups(leaves, tr.tcfg.dist.pallas_leaf_threshold)
    per_round, widths = {}, {}
    for g in groups:
        D = sum(leaves[i][0].numel() for i in g)
        key = "mix_vector" if mc._vector_rows(n, D, []) else "mix"
        per_round[key] = per_round.get(key, 0) + 1
        widths.setdefault(key, []).append(D)
    mix_rounds = rounds - gossip if compressed else rounds
    want = {k: v * mix_rounds for k, v in per_round.items()}
    if compressed:
        for lf in tree_leaves(state.params):
            D = lf[0].numel()
            key = "cmix_vector" if mc._vector_rows(n, D, []) else "cmix"
            want[key] = want.get(key, 0) + gossip
            want["cmix_absmax"] = want.get("cmix_absmax", 0) + gossip
    return only(**want), widths


def run_push_path(torch, mc, compressed: bool = False,
                  sharded: bool = False):
    """Slice 8's main paths at full width: pga-lm-100m, 8 nodes, Gossip-PGA
    H = 3 over directed_exp with ``push_sum=True``, AdamW, global batch
    32 × seq 512, 6 steps (gossip at 0, 1, 3, 4; global at 2 over 6 nodes
    and at 5 over all), under :data:`PUSH_FAULTS`.  ``[psmain]``: stacked
    fused rounds of the runtime W (mix.cu); ``[pscmain]``: int8 gossip +
    EF (cmix.cu and its row maxima) with the weight mixed exactly, the
    global rounds on mix.cu; ``[spsmain]``: on a mesh of 4 node shards,
    ``comm_shard_mode="sharded"`` (shard_mix.cu over the static halo).
    Gates: |Σw − 8| ≤ 8e-5 after every step, w bitwise ones after step 5,
    nodes 2 and 5's params and AdamW m/v rows after step 3 bitwise those
    after step 0, finite losses, the phases the schedule gives, the launch
    counts the dispatch rule gives (reset just before, read just after),
    no plain-twin call; ``[psmain]`` no more synchronizing calls per step
    than ``[main]``.  Returns ``(launches, trainer, state, host copy of
    the de-biased params)``."""
    from repro_torch.configs import (DistConfig, OptimizerConfig,
                                     TrainConfig, get_model_config)
    from repro_torch.core.faults import FaultSchedule
    from repro_torch.core.mesh import make_mesh
    from repro_torch.train import Trainer
    from repro_torch.train.state import debias
    from repro_torch.tree import tree_leaves

    steps, n = 6, MAIN_N
    tag = ("[spsmain]" if sharded else "[pscmain]" if compressed
           else "[psmain]")
    t_phase = time.perf_counter()
    mesh = make_mesh((n // SHARD_M,), ("data",)) if sharded else None
    tcfg = TrainConfig(
        model=get_model_config("pga-lm-100m"),
        dist=DistConfig(algorithm="gossip_pga", topology="directed_exp",
                        H=3, comm_backend="pallas", push_sum=True,
                        comm_shard_mode="sharded" if sharded else "auto",
                        **(PUSH_COMPRESSED if compressed else {})),
        optimizer=OptimizerConfig(name="adamw", lr=3e-4,
                                  schedule="warmup_cosine", warmup_steps=2,
                                  total_steps=steps),
        global_batch=32, seq_len=512, steps=steps, log_every=1)
    fs = FaultSchedule(**PUSH_FAULTS)
    tr = Trainer(tcfg, n_nodes=n, mesh=mesh, with_consensus=True,
                 fault_schedule=fs)
    state = tr.init_state(torch.Generator().manual_seed(0))
    phases_want = [tr.schedule.peek_phase(k) for k in range(steps)]
    expected, widths = push_expected_launches(mc, tr, state, phases_want,
                                              compressed, sharded)
    per_node = sum(p[0].numel() for p in tree_leaves(state.params))
    where = "stacked"
    if sharded:
        from repro_torch.core import mixing
        offs = mixing.push_sum_shard_offsets(
            n, n // SHARD_M, fs.hop_superset("directed_exp"))
        where = (f"a mesh of {n // SHARD_M} node shards, gossip halo "
                 f"offsets {offs}")
    print(f"{tag} pga-lm-100m push-sum ({where}"
          f"{', int8+EF gossip' if compressed else ''}): {per_node:,} "
          f"params per node + the weight column, {n} nodes, directed_exp, "
          f"faults {PUSH_FAULTS}, hop superset "
          f"{fs.hop_superset('directed_exp')}; dispatch groups of the "
          f"joint (x, w) tree by instance {widths}; expected launches "
          f"{ {k: v for k, v in expected.items() if v} }", flush=True)
    tokens = tcfg.global_batch * tcfg.seq_len
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, syncs, rows0 = [], [], None
    with PlainCalls(mc) as plain:
        for k in range(steps):
            t0 = time.perf_counter()
            state, n_sync = sync_steps(
                torch, lambda: tr.run(state, steps=1, log_every=1),
                SYNC_SITES.setdefault(tag, {}))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            times.append(dt)
            syncs.append(n_sync)
            rec = tr.history[-1]
            print(f"{tag} step {k} phase={rec['phase']} active="
                  f"{int(fs.active_mask(k).sum())} loss={rec['loss']:.4f} "
                  f"mass={rec['mass']!r} consensus={rec['consensus']:.6e} "
                  f"step_ms={dt * 1e3:.1f} max_mem_GB="
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} "
                  f"synchronizing_calls={n_sync}", flush=True)
            if not math.isfinite(rec["loss"]):
                raise AssertionError(f"{tag} step {k}: loss {rec['loss']}")
            if abs(rec["mass"] - n) > PUSH_MASS_TOL:
                raise AssertionError(f"{tag} step {k}: mass {rec['mass']!r}")
            if k in (0, 3):
                rows = _row_copies((state.params, state.opt_state),
                                   PUSH_DROPPED)
                if k == 0:
                    rows0 = rows
                elif not all(torch.equal(a, b) for a, b in zip(rows, rows0)):
                    raise AssertionError(f"{tag}: the rows of dropped nodes "
                                         f"{PUSH_DROPPED} moved while down")
    launches = counts()
    phases = [r["phase"] for r in tr.history[-steps:]]
    if phases != phases_want:
        raise AssertionError(f"{tag} phases {phases}, the schedule gives "
                             f"{phases_want}")
    if not torch.equal(state.push_weight, torch.ones_like(
            state.push_weight)):
        raise AssertionError(f"{tag}: w after the full global round of step "
                             f"5 is not ones: {state.push_weight.flatten()}")
    if launches != expected:
        raise AssertionError(f"{tag} launches {launches}, the dispatch rule "
                             f"gives {expected}")
    if plain.calls:
        raise AssertionError(f"{tag}: {plain.calls} plain-twin calls on the "
                             f"card")
    main_tag = ("[smain]" if sharded else "[cmain]" if compressed
                else "[main]")
    base = SYNCS.get(main_tag)
    if not compressed and not sharded and (
            base is None or max(syncs[1:]) > max(base[1:])):
        raise AssertionError(f"{tag} synchronizing calls per step {syncs} "
                             f"over [main]'s {base}")
    if compressed:
        ef_abs = sum(float(e.abs().sum()) for e in tree_leaves(state.ef_state))
        assert ef_abs > 0.0 and math.isfinite(ef_abs), ef_abs
    steady = statistics.median(times[1:])
    print(f"{tag} {steps} steps: phases {phases}; launches "
          f"{ {k: v for k, v in launches.items() if v} } as the dispatch "
          f"rule gives, no plain twin; w bitwise ones after step 5; nodes "
          f"{PUSH_DROPPED}' params and AdamW m/v rows after step 3 bitwise "
          f"those after step 0; steady step {steady * 1e3:.1f} ms (median "
          f"of steps 1-5), {tokens / steady:.0f} tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; synchronizing "
          f"calls per step {syncs} ({main_tag}: {base}), step "
          f"{steps - 1}'s by source line {SYNC_SITES[tag]}; phase wall time "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    debiased = [p.cpu() for p in tree_leaves(debias(state.params,
                                                    state.push_weight))]
    return launches, tr, state, debiased


def push_round_times(torch, mc, tr, state) -> None:
    """[spsmain]'s rounds timed beside the stacked ones on the same state,
    by CUDA events over 10 rounds (as ``[round]``; ``[sround]`` takes 3)
    in turns (stacked, sharded, sharded, stacked): a fault
    gossip round (nodes 2 and 5 down, per-node hops; shard_mix over the
    static halo, K = 6) and the full global round (K = 8).  Then the
    stacked push gossip round beside the static-W round of slice 1 on the
    same params (``fused_step_mix``, factors cached per round kind, no
    weight column), in turns: what the runtime W costs."""
    from repro_torch.core import mixing
    from repro_torch.core import topology as topo
    from repro_torch.core.faults import FaultSchedule

    n, k = tr.n_nodes, tr.n_nodes // SHARD_M
    fs = FaultSchedule(**PUSH_FAULTS)
    offsets = mixing.push_sum_shard_offsets(
        n, k, fs.hop_superset("directed_exp"))
    for name, W, offs in (("gossip", fs.matrix("directed_exp", 3), offsets),
                          ("global", topo.global_push_matrix(n), None)):
        def run(sharded, W=W, offs=offs):
            kw = (dict(mesh=tr.mesh, shard_mode="sharded", offsets=offs)
                  if sharded else {})
            mixing.communicate_push_sum(state.params, state.push_weight,
                                        W=W, n_nodes=n, backend="pallas",
                                        **kw)
        t = [cuda_ms(torch, lambda: run(sh), iters=10, warmup=2)
             for sh in (False, True, True, False)]
        print(f"[spsmain] push-sum {name} round: sharded {t[1]:.3f} / "
              f"{t[2]:.3f} ms (halo offsets "
              f"{offs if offs is not None else tuple(range(k))}), stacked "
              f"{t[0]:.3f} / {t[3]:.3f} ms (in turns)", flush=True)
        torch.cuda.empty_cache()
    W = fs.matrix("directed_exp", 3)
    dense = (lambda: mixing.communicate_push_sum(
        state.params, state.push_weight, W=W, n_nodes=n, backend="pallas"))
    static = (lambda: mc.fused_step_mix(state.params, phase="gossip",
                                        topology="directed_exp", n_nodes=n))
    t = [cuda_ms(torch, f, iters=10, warmup=2)
         for f in (static, dense, dense, static)]
    print(f"[spsmain] stacked gossip rounds: push-sum (runtime W, weight "
          f"column) {t[1]:.3f} / {t[2]:.3f} ms, static W of the round kind "
          f"{t[0]:.3f} / {t[3]:.3f} ms (in turns)", flush=True)
    torch.cuda.empty_cache()


def push_cross_check(torch, compressed: bool = False,
                     sharded: bool = False, steps: int = 4) -> None:
    """[pscross]: the push paths at the reduced config (fp32 compute, 4
    nodes, directed_exp, H = 2, SGD) under :data:`PUSH_CROSS_FAULTS`, card
    (kernels) vs CPU (plain versions) from one init, with
    :func:`cross_check`'s tolerances (push: the consensus after a global
    round to atol 1e-10, the mass per step to 1e-6); sharded, also against
    the stacked run on the card.  The push weight is compared with the
    params."""
    from repro_torch import interop
    from repro_torch.core.faults import FaultSchedule
    from repro_torch.core.mesh import make_mesh
    from repro_torch.models.model import make_model
    from repro_torch.train import Trainer

    tcfg = _cross_config(False, dist_kw=dict(
        H=2, topology="directed_exp", push_sum=True,
        **(PUSH_COMPRESSED if compressed else {})))
    init = interop.to_numpy(make_model(tcfg.model).init(
        torch.Generator().manual_seed(1), "cpu"))
    runs = {}
    labels = (("cuda", True), ("cpu", True), ("cuda", False)) if sharded \
        else (("cuda", False), ("cpu", False))
    for dev, on_mesh in labels:
        mesh = make_mesh((2,), ("data",), device=dev) if on_mesh else None
        tr = Trainer(tcfg, n_nodes=4, mesh=mesh, with_consensus=True,
                     fault_schedule=FaultSchedule(**PUSH_CROSS_FAULTS),
                     device=dev)
        st = tr.init_state(params=interop.from_numpy(init, dev))
        st = tr.run(st, steps=steps, log_every=1)
        trees = [st.params, {"w": st.push_weight}] + (
            [st.ef_state] if compressed else [])
        runs[dev, on_mesh] = ([interop.to_numpy(t) for t in trees],
                              tr.history)
    pairs = [(labels[0], labels[1])] + (
        [(labels[0], labels[2])] if sharded else [])
    what = "push-sum int8+EF trainer" if compressed else "push-sum trainer"
    for a, b in pairs:
        name = " vs ".join(f"{dev} {'sharded' if m else 'stacked'}"
                           for dev, m in (a, b))
        _compare_runs(runs[a], runs[b], compressed,
                      f"[pscross] reduced fp32 {what}, {name} over {steps} "
                      f"steps, faults {PUSH_CROSS_FAULTS}", push=True)


def _least_squares(torch, device, d: int = 6, m: int = 48):
    """The reference fault tests' least squares (``tests/test_faults.py``),
    A and b drawn with numpy: ``0.5·mean((A x − b)²)`` and its full
    gradient on ``device``."""
    import numpy as np
    rng = np.random.default_rng(11)
    A = torch.from_numpy(rng.standard_normal((m, d)).astype(
        np.float32)).to(device)
    b = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(
        device)

    def loss(x):
        return 0.5 * torch.mean((A @ x - b) ** 2)

    def grad(xs, generator, k):
        return (xs @ A.T - b) @ A / m

    return loss, grad, d


def run_push_sim_path(torch, mc) -> dict:
    """[psim]: ``simulate(push_sum=True, fault_schedule=...)`` on the card.
    (a) the reference's acceptance scenario (``tests/test_faults.py``):
    n = 16, directed_exp, nodes 3 and 11 dropped at step 12 and rejoined
    at 28, 64 steps, H = 8, ``backend="pallas"``, card vs CPU: mass within
    1e-2 of 16 at every step, final consensus < 1e-6, loss rtol 1e-5.
    (b) the §5.1 problem of [sim] at n = 100 over directed_ring, 3000
    steps: push-sum gossip, push-sum Gossip-PGA, and push-sum Gossip-PGA
    with 10 nodes dropped at step 1000 and rejoined at 2000; mass within
    1e-3·n at every step; AUC against [sim]'s parallel SGD printed (one
    seed, not gated).  Every run: one mix.cu launch a round (the joint
    (n, d + 1) tree, on the instance ``use_vector_mix`` picks), no plain
    twin on the card.  Returns the launch counts summed over the runs."""
    import numpy as np

    from repro_torch.core import simulate
    from repro_torch.core.faults import FaultSchedule
    from repro_torch.data import make_logistic_problem

    total = {k: 0 for k in counts()}
    t_phase = time.perf_counter()

    def mix_key(n, d):
        return ("mix_vector" if mc._vector_rows(n, d + 1, []) else "mix")

    def checked(tag, n, d, fn):
        torch.cuda.synchronize()
        reset_counts()
        with PlainCalls(mc) as plain:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = counts()
        steps = len(out["mass"])
        want = only(**{mix_key(n, d): steps})
        if launches != want:
            raise AssertionError(f"{tag}: launches {launches}, the dispatch "
                                 f"rule gives {want}")
        if plain.calls:
            raise AssertionError(f"{tag}: {plain.calls} plain-twin calls")
        for k, v in launches.items():
            total[k] += v
        return out, wall * 1e3 / steps, launches

    # (a) the acceptance scenario, card vs CPU
    acc = dict(algorithm="gossip_pga", n=16, steps=64, lr=0.05,
               topology="directed_exp", H=8, push_sum=True,
               backend="pallas", eval_every=8)
    outs = {}
    for dev in ("cuda", "cpu"):
        loss, grad, d = _least_squares(torch, dev)
        fs = FaultSchedule(n_nodes=16, drops={12: (3, 11)},
                           rejoins={28: (3, 11)}, seed=0)

        def fn(dev=dev, loss=loss, grad=grad, d=d, fs=fs):
            return simulate(grad_fn=grad, loss_fn=loss,
                            x0=torch.zeros(d, device=dev),
                            fault_schedule=fs, device=dev, **acc)
        if dev == "cuda":
            outs[dev], ms, launches = checked("[psim] acceptance", 16, d,
                                              fn)
        else:
            outs[dev] = fn()
    for dev, out in outs.items():
        if np.abs(out["mass"] - 16.0).max() > 1e-2:
            raise AssertionError(f"[psim] acceptance {dev}: mass "
                                 f"{out['mass']}")
        if not out["consensus"][-1] < 1e-6:
            raise AssertionError(f"[psim] acceptance {dev}: final consensus "
                                 f"{out['consensus'][-1]}")
    np.testing.assert_allclose(outs["cuda"]["loss"], outs["cpu"]["loss"],
                               rtol=1e-5, err_msg="[psim] acceptance")
    rel = float(np.max(np.abs(outs["cuda"]["loss"] - outs["cpu"]["loss"])
                       / np.abs(outs["cpu"]["loss"])))
    print(f"[psim] acceptance (n=16 directed_exp, nodes 3 and 11 down at "
          f"steps 12-27, 64 steps, H=8, pallas): card vs CPU loss max rel "
          f"diff {rel:.3e} (gate 1e-5); max |mass - 16| card "
          f"{np.abs(outs['cuda']['mass'] - 16).max():.3e}, CPU "
          f"{np.abs(outs['cpu']['mass'] - 16).max():.3e} (gate 1e-2); final "
          f"consensus card {outs['cuda']['consensus'][-1]:.3e}, CPU "
          f"{outs['cpu']['consensus'][-1]:.3e} (gate 1e-6); final weight "
          f"{outs['cuda']['push_weight'].ravel().tolist()}; {ms:.4f} ms/step "
          f"wall, launches { {k: v for k, v in launches.items() if v} }",
          flush=True)

    # (b) the §5.1 problem at n = 100 over the directed ring
    n = SIM["n"]
    prob = make_logistic_problem(n, SIM["M"], SIM["d"], iid=False, seed=0)
    fs_star = SIM_REFERENCE["f_star"]
    down = tuple(range(0, n, n // 10))
    run_kw = dict(steps=SIM["steps"], lr=sim_lr, H=SIM["H"],
                  eval_every=SIM["eval_every"], batch=SIM["batch"],
                  topology="directed_ring", push_sum=True)
    for name, alg, faults in (
            ("gossip", "gossip", None), ("gossip_pga", "gossip_pga", None),
            ("gossip_pga, 10 nodes down 1000-1999", "gossip_pga",
             dict(n_nodes=n, drops={1000: down}, rejoins={2000: down}))):
        fs = FaultSchedule(**faults) if faults else None
        out, ms, launches = checked(
            f"[psim] {name}", n, prob.d,
            lambda: _sim_run(torch, prob, alg, fault_schedule=fs, **run_kw))
        err = float(np.abs(out["mass"] - n).max())
        if err > 1e-3 * n:
            raise AssertionError(f"[psim] {name}: max |mass - n| {err}")
        if not all(math.isfinite(f) for f in out["loss"]):
            raise AssertionError(f"[psim] {name}: loss {out['loss']}")
        auc = float(np.trapezoid(out["loss"] - fs_star)
                    / max(SIM_REFERENCE["parallel_auc"], 1e-12))
        used = {k: v for k, v in launches.items() if v}
        print(f"[psim] push-sum {name} (n={n} directed_ring, §5.1 problem, "
              f"{SIM['steps']} steps): final loss {out['loss'][-1]:.8f} "
              f"consensus {out['consensus'][-1]:.6e} AUC vs [sim]'s parallel "
              f"{auc:.4f}; max |mass - n| {err:.3e} (gate {1e-3 * n:g}); "
              f"{ms:.4f} ms/step wall, launches {used} "
              f"({sum(used.values()) / SIM['steps']:.4f} per step)",
              flush=True)
    del prob
    print(f"[psim] phase wall time {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return total


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
    from repro_torch.kernels import flash_attention_cuda as fa
    from repro_torch.kernels import mixing_cuda as mc
    from repro_torch.kernels import mlstm_cuda as mk
    from repro_torch.kernels import rmsnorm_cuda as rn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    print(f"[device] {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.perf_counter()
    cuda_build.build()
    print(f"[build] {', '.join(f'{k}.cu' for k in cuda_build.LIBRARIES)} "
          f"in {time.perf_counter() - t0:.1f} s, one nvcc each in parallel "
          f"({cuda_build._Libs.build_seconds})", flush=True)
    for name, log in cuda_build._Libs.build_log.items():
        print(f"[build] {name}.cu:\n{log.strip()}", flush=True)
    for name in ("flash_attention_wgmma", "mlstm_wgmma"):
        print(f"[build] {name}.cu: {hgmma_count(cuda_build, name)}",
              flush=True)
    for name, kernel in (("mix", "mix_vector_kernel"),
                         ("cmix", "cmix_vector_kernel"),
                         ("mlstm_wgmma", "mlstm_wgmma_kernel")):
        log = cuda_build._Libs.build_log.get(name)
        lines = (["built before this run: no ptxas report"] if log is None
                 else register_report(log, kernel))
        if name in SASS_KERNELS:
            lines += sass_memory_counts(cuda_build, name)
        for line in lines:
            print(f"[build] {name}.cu: {line}", flush=True)
    records = {}

    def add(*found):
        for rec in found:
            records[rec["name"]] = rec

    add(check_mix_kernel(torch, mc))
    torch.cuda.empty_cache()
    add(*check_cmix_kernel(torch, mc))
    torch.cuda.empty_cache()
    add(check_collective_kernel(torch, mc))
    torch.cuda.empty_cache()
    add(*check_mlstm_kernel(torch, mk))
    torch.cuda.empty_cache()
    add(check_shard_mix_kernel(torch, mc))
    add(check_shard_cmix_kernel(torch, mc))
    add(*check_flash_kernel(torch, fa))
    torch.cuda.empty_cache()
    add(check_rmsnorm_kernel(torch, rn))
    if args.kernels_only:
        print(json.dumps({"kernels": list(records.values())}))
        return 1
    ops_launches = run_ops_path(torch)
    records["flash_attention_kernel"]["launches"] = ops_launches["flash"]
    records["flash_attention_wgmma_kernel"]["launches"] = \
        ops_launches["flash_wgmma"]
    records["rmsnorm_kernel"]["launches"] = (ops_launches["rmsnorm"]
                                             + ops_launches["rmsnorm_vector"])
    records["mlstm_kernel"]["launches"] = ops_launches["mlstm"]
    slice1, tr, state = run_main_path(torch, mc)
    where_time_goes(torch, mc, tr, state)
    del tr, state
    torch.cuda.empty_cache()
    slice2, tr, state = run_main_path(torch, mc, compressed=True)
    compressed_round_times(torch, mc, tr, state)
    del tr, state
    torch.cuda.empty_cache()
    records["mix_vector_kernel"]["launches"] = slice1["mix_vector"]
    records["cmix_vector_kernel"]["launches"] = slice2["cmix_vector"]
    records["collective_kernel"]["launches"] = slice2["collective"]
    records["cmix_absmax_kernel"]["launches"] = slice2["cmix_absmax"]
    records["mlstm_wgmma_kernel"]["launches"] = run_serving_path(torch)
    torch.cuda.empty_cache()
    for compressed in (False, True):
        launches, tr, state = run_main_path(torch, mc, compressed=compressed,
                                            sharded=True)
        key = "shard_cmix" if compressed else "shard_mix"
        records[f"{key}_kernel"]["launches"] = launches[key]
        sharded_round_times(torch, mc, tr, state, compressed)
        del tr, state
        torch.cuda.empty_cache()
    cross_check(torch)
    cross_check(torch, compressed=True)
    cross_check(torch, sharded=True)
    cross_check(torch, compressed=True, sharded=True)
    for algorithm, dist_kw in ALGO_RUNS:
        cross_check(torch, algorithm=algorithm, dist_kw=dist_kw, steps=6)
    serving_cross_check(torch)
    torch.cuda.empty_cache()
    sim = run_sim_path(torch, mc)
    run_sim_cross_check(torch)
    algos = {k: 0 for k in counts()}
    for algorithm, dist_kw in ALGO_RUNS:
        for k, v in run_algo_path(torch, mc, algorithm, dist_kw).items():
            algos[k] += v
    # slice 8: push-sum and faults
    push = {}
    push["[psmain]"], tr, state, debiased = run_push_path(torch, mc)
    del tr, state
    torch.cuda.empty_cache()
    push["[pscmain]"], tr, state, _ = run_push_path(torch, mc,
                                                    compressed=True)
    del tr, state
    torch.cuda.empty_cache()
    push["[spsmain]"], tr, state, sharded_debiased = run_push_path(
        torch, mc, sharded=True)
    push_round_times(torch, mc, tr, state)
    del tr, state
    torch.cuda.empty_cache()
    diff = max(float((a - b).abs().max())
               for a, b in zip(sharded_debiased, debiased))
    print(f"[spsmain] de-biased params after 6 steps vs [psmain]'s: max abs "
          f"diff {diff:.3e}", flush=True)
    del debiased, sharded_debiased
    push_cross_check(torch)
    push_cross_check(torch, compressed=True)
    push_cross_check(torch, sharded=True)
    push["[psim]"] = run_push_sim_path(torch, mc)
    # the slice-7 paths' launches beside the main paths' (B.1 to B.3)
    for name, keys in (("mix_vector_kernel", ("mix", "mix_vector")),
                       ("cmix_vector_kernel", ("cmix", "cmix_vector")),
                       ("cmix_absmax_kernel", ("cmix_absmax",)),
                       ("collective_kernel", ("collective",))):
        records[name]["launches_sim_algos"] = {
            path: {k: c[k] for k in keys if c[k]}
            for path, c in (("[sim]", sim), ("[algos]", algos))}
    # the push paths' launches (B.1, B.2 and its row maxima, B.5)
    for name, keys in (("mix_vector_kernel", ("mix", "mix_vector")),
                       ("cmix_vector_kernel", ("cmix", "cmix_vector")),
                       ("cmix_absmax_kernel", ("cmix_absmax",)),
                       ("shard_mix_kernel", ("shard_mix",))):
        records[name]["launches_push"] = {
            path: {k: c[k] for k in keys if c[k]}
            for path, c in push.items()}
    missing = [k for k, r in records.items() if not r["launches"]]
    if missing:
        raise AssertionError(f"kernels no main path launched: {missing}")
    print(card)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
