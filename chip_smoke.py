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
   picks (the mix and cmix register and node-parallel instances also
   bitwise against the generic ones: :func:`check_mix_nodes_kernel`,
   :func:`check_cmix_nodes_kernel`; the node-parallel rule's crossovers
   timed by :func:`nodes_rule_times`; shard_cmix.cu's node-parallel
   instance bitwise its column one, :func:`check_shard_cmix_nodes_kernel`;
   collective.cu's narrow instance bitwise its untiled and tiled ones,
   :func:`check_collective_narrow_kernel`), with the tolerances stated in
   :func:`check_mix_kernel`, :func:`check_cmix_kernel` (with the
   compressed round's row maxima, :func:`check_absmax`),
   :func:`check_collective_kernel`, :func:`check_mlstm_kernel`,
   :func:`check_shard_mix_kernel`, :func:`check_shard_cmix_kernel`,
   :func:`check_flash_kernel` and :func:`check_rmsnorm_kernel`; timing by
   CUDA events against the kernel's bound and, where one exists, one
   PyTorch library call; rows 4d and 3 at the simulators' n = 100, each
   redesign timed in turns against its old instance, and the two
   dispatch rules' crossovers (:func:`sim_shape_rows`)
   (``--kernels-only`` stops here);
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
   launch counts against the dispatch rule (the node-parallel mix and
   cmix instances at n = 100, no generic launch), no plain-twin call,
   and the consensus after the global rounds an eval falls on; the
   suboptimality AUC against parallel SGD (f* by full-batch gradient
   descent here); ``[simsplit]`` (:func:`sim_split`): gossip's first
   steps under ``torch.profiler``, the device's share of the wall time;
   one compressed run at the same size (int8 gossip + EF, int8
   collective on collective.cu's narrow instance, none on the others);
   then the non-IID crossover of
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
   built on the card from a runtime W at these paths' shapes;
11. slice 9's paths, overlapped gossip (``comm_overlap=True``: step t's
   round applied at step t + 1 as ``x + (M·b − (1 − d)⊙b)``, global
   rounds flushing synchronously): the Trainer at full width over
   one_peer_exp, stacked (``[ovmain]``: shard_cmix.cu once per dispatch
   group per gossip step, the whole node stack as one shard with
   ``q_self = qs`` the buffer; mix.cu on the flushes), with int8 gossip +
   int8 collective + EF (``[ovcmain]``) and on a mesh of 4 node shards
   (``[sovmain]``, A.10.4): launches, no plain twin, consensus 0.0 after
   every uncompressed flush, the node average kept by every apply, one
   synchronizing call on each steady step (``[main]`` is held to the
   same);
   ``[ovround]`` times the overlapped round against ``[round]``'s fused
   one; ``[ovcross]`` the three at a reduced config card vs CPU;
   ``[ovsim]`` ``simulate(overlap=True)`` on ``[sim]``'s problem at
   n = 100 (every apply on shard_cmix.cu's node-parallel instance, none
   on the column one), card vs CPU, its AUC beside the synchronous
   runs'.  The
   kernel checks of phase 2 hold shard_cmix at that apply's shape (m = K
   = 8, ``q_self is qs``) at the ragged widths and at 138,431,232
   columns, and time it there.

12. slice 10's paths, checkpoints and resume and the telemetry layer:
   ``[tel]`` (right after ``[main]``) runs ``[main]``'s cell with a hub
   of JsonlSink + RingSink: one synchronizing call and one
   ``Telemetry.fetch`` a step, ``analytic_bytes == measured_bytes`` on
   every ``comm_round`` record, the Chrome trace loads with the
   ``train/step`` spans, the step ms beside ``[main]``'s;
   ``[telfence]`` the same with fenced spans (device time beside host
   time).  ``[ckpt]`` (``[main]``'s cell), ``[cckpt]`` (``[cmain]``'s:
   the EF slot in the file), ``[psckpt]`` (``[psmain]``'s push-sum and
   faults, the checkpoint between drop and rejoin) and ``[agackpt]``
   (Gossip-AGA: the schedule sidecar) save once, after step 2, and
   resume in a fresh Trainer from ``restore_checkpoint``: steps 3-5
   bitwise an uninterrupted run's (params, AdamW m, v, count, extras;
   fault counters; schedule), with the file size, the save and restore
   seconds and the peak host RSS printed; ``[psckpt]`` and
   ``[agackpt]`` at 2 of the 12 layers (the card's machine stops a run
   after 45 GiB of disk writes), ``[ckpt]`` and ``[cckpt]`` too since
   slice 16 (the script's time budget).  ``[occ]``: ``[ovmain]``'s cell
   with ``measure_occupancy=True``, its one occupancy record, the params
   bitwise a run's without it.  ``[simtel]``: ``[psim]``'s acceptance
   scenario under ``simulate(telemetry=)``, its fault records the
   schedule's events.  ``[servetel]``: ``[serve]``'s server with a hub,
   one ``serve_req`` per request and the serve spans.
13. slice 11's paths, attention KV caches and decode (A.9) and the dense
   features of A.8, serving the dense decoders at full published width
   with fp32 params from seed 0 and bf16 compute
   (:func:`run_dense_serve_path`): ``[lmserve]`` pga-lm-100m
   (``Engine.generate`` 8 × 480 + 32; ``BatchedServer`` with prompts of
   6, 100 and 480 on 2 slots, 16 new each), ``[gserve]`` gemma2-9b at
   full width and, since slice 13, :data:`GEMMA_LAYERS` of its 42 layers
   (1 × 4,608 + 32 at ``s_max`` 4,672, the sliding window cutting the
   prefill and every decode step on its ``attn_sw`` layers; prompts of 6, 100, 1,000 and 4,608 on 4 slots; the init time,
   one profiled window of 4 decode steps and the weight casts alone),
   ``[qserve]`` qwen3-0.6b, qwen2-0.5b and qwen1.5-32b at 2 of its 64
   layers (8 × 1,024 + 32): prefill ms, decode ms a token against the
   floor of :func:`decode_floor_bytes`, tokens/s, peak memory, no kernel
   launched, and :func:`decode_gate` (decode against the full forward,
   gated at float32, bf16 beside its rounding floor);
   ``[dxcross]`` (:func:`dense_cross_check`) the five archs at their
   reduced configs card vs CPU through ``Engine`` and ``BatchedServer``.
14. slice 12's paths, the encoder family, LAMB, microbatches, the remat
   policies and the blocked attention: ``[glong]`` (right after
   ``[gserve]``, on its params) one 8,192-token gemma2-9b prompt through
   ``Engine.generate`` (+16 at ``s_max`` 8,208), every layer's prefill
   attention through ``_sdpa_blocked``, then one ``attn_sw`` and one
   ``attn`` layer at float32 against the plain ``_sdpa`` on the same q,
   k, v; ``[bert]`` bert-large at its full published size (465,213,440
   params a replica) trained on 4 stacked nodes with Gossip-PGA H = 4,
   LAMB (``warmup_poly``), 32 sequences of 128 a node in 4
   microbatches, 8 steps through mix.cu's fused consensus round: launch
   count, consensus 0.0 on the global steps, one synchronizing call a
   steady step; ``[bertmem]`` the same step with remat_policy ``"dots"``
   and with 1 microbatch beside ``"nothing"``/4 (peak memory, step ms,
   params after one step); ``[encx]`` bert-large and hubert-xlarge at
   their reduced configs card vs CPU (grads, loss and params after one
   LAMB step with 2 microbatches).
15. slice 13's paths, MoE, MLA and prefix patterns:
   ``[dsserve]`` deepseek-v2-lite-16b at its full published size (27
   layers, 15,706,484,224 params: the dense prefix layer, 26 MoE layers
   of 64 routed experts top-6 and 2 shared, MLA with the latent cache;
   the init timed, ``Engine.generate`` 4 × 1,024 + 16 with the prefill's
   drop_frac, a 4-slot ``BatchedServer``, the decode gate at float32
   drop-free), ``[dslong]`` one 8,192-token prompt on its params through
   the blocked MLA path, then one layer's blocked MLA against the plain
   at float32 and what keeps them from bitwise (:func:`run_ds_path`,
   :func:`mla_blocked_gate`); ``[qmoe]`` qwen3-moe-30b-a3b at full width
   and 4 of its 48 layers served as ``[dsserve]`` is, ``apply_moe``
   against the dense oracle and ``_build_dispatch`` card vs CPU bitwise
   (:func:`run_qmoe_path`);
   ``[moetrain]`` the Trainer on deepseek-v2-lite at full width with its
   prefix layer and one MoE layer, n = 2, AdamW, B.1 on every round, one
   synchronizing call a steady step (:func:`run_moetrain_path`);
   ``[moex]`` both archs' reduced configs card vs CPU
   (:func:`reduced_cross_check`).
16. slice 14's paths, Mamba, the hybrid family and the VLM stub (every
   full-size init printed with its rate, the host's cores and the draw
   pool): ``[jserve]`` jamba-1.5-large at full width with one layer of
   each block kind, (mamba, dense), (mamba, moe) and (attn, dense)
   (12,937,224,192 bf16 params), served as ``[dsserve]`` is
   (``Engine.generate`` 2 × 1,024 + 16, a 4-slot ``BatchedServer``, the
   decode gate at float32 drop-free), then one Mamba layer card vs CPU
   (:func:`run_jserve_path`); ``[lvserve]`` llava-next-mistral-7b at its
   full published size the same way and ``[lvloss]`` its loss on 4,096
   positions, 2,880 of them patches (:func:`run_lvserve_path`);
   ``[jtrain]`` the Trainer on jamba at full width with one Mamba layer
   and its FFN, n = 2, SGD, B.1 on every round, one synchronizing call a
   steady step (:func:`run_jtrain_path`);
   ``[hybx]`` and ``[vlmx]`` both archs' reduced configs card vs CPU,
   their inits bitwise (:func:`reduced_cross_check`, as ``[moex]``).

17. slice 15's paths, the rank mesh (A.10.1; right after ``[sround]``,
   :func:`run_dist_paths`): four ``torch.distributed`` ranks, one per
   node shard of ``[smain]``'s mesh, spawned once by
   ``repro_torch.core.mesh.run_ranks`` on the one card over gloo (every
   exchange staged through pinned host memory; NCCL refuses two ranks on
   one card).  ``[dround]``: five round kinds on a synthetic full-width
   state (gossip hops 1 and 2 and global with the consensus residual;
   int8 + EF gossip and the int8 collective), each rank's rows
   fingerprinted (:func:`fingerprint`) against the one-process sharded
   round's, timed on the ranks with the exchange's split (staging
   out, exchange, staging in, the kernel alone, the rest) beside
   ``[sround]``; ``[dmain]`` and ``[dcmain]``: the first 4 steps of
   ``[smain]``'s and ``[scmain]``'s trainers on the ranks, 2 nodes each:
   B.5 / B.4 once a gossip step on every rank (12 launches summed), no
   plain twin, consensus 0.0 after every uncompressed global step, finite
   losses, the slowest rank's step ms, synchronizing calls, each rank's
   peak memory and pinned host bytes, the params against the one-process
   run's after its step 3 (:func:`twin_snapshot`).
18. slice 16's paths, 2-D ``(node, model)`` meshes (A.10.2; right after
   ``[sround]``, the rank ones in slice 15's spawn): the kernel checks
   hold B.5 and B.4 at the 2-D block shape (m = 2, W = 69,215,616, K = 4:
   :func:`two_d_block_record`, the kernels line's ``*_kernel_2d``
   records); ``[m2round]`` (:func:`run_m2round`) eight round kinds on a
   synthetic full-width state on a one-process ``(data=4, model=2)``
   mesh, bitwise the 1-D mesh's rows (the int8 collective within one
   quantization step), timed beside them, and the 2-D packing alone;
   ``[m2main]``/``[m2cmain]`` ``[smain]``/``[scmain]``'s trainers on that
   mesh (8 launches a gossip round), their final params against the 1-D
   runs' (:func:`m2_against_one_d`); ``[d2main]``/``[d2cmain]`` the same
   trainers at n = 4 on a ``(data=2, model=2)`` rank mesh of the 4 ranks,
   each rank holding its node shard's 2 nodes whole and computing one
   model chunk of every round (exchange bytes on each axis, the last
   gossip step's split timed; both at 4 steps), against their
   one-process twins
   (:func:`d2_references`).  Every rank path is held to its twin with the
   bound of ``PERF.md`` §2 (:func:`_gate_against_twin`); ``[dcmain]`` is
   traced step by step against ``[scmain]`` (:func:`_trace_dcmain`,
   the joint gradient norm as ``[scmain]`` folds it and as one sum).
19. slice 17's paths, SlowMo and checkpoints on the rank meshes (closing
   A.10.1; right after slice 16's twins, the rank ones in slice 15's
   spawn), and the examples: ``[sslowmo]`` (:func:`run_sslowmo`) SlowMo
   H = 2 on ``[smain]``'s cell and mesh of 4 node shards in this process,
   its outer step's x̄ the pairwise halving over all 8 rows; ``[dslowmo]``
   the same on the 4 ranks after ``[dcmain]``, held to ``[sslowmo]`` by
   :func:`_gate_against_twin`, its slots bitwise ``[sslowmo]``'s on every
   rank (:func:`_report_dslowmo`), consensus 0.0 after every outer step,
   B.5 once a rank a gossip step; ``[d2ckpt]`` (:func:`_d2ckpt_rank`)
   ``[d2cmain]``'s cell at :data:`CKPT_CUT_LAYERS` layers on the
   ``(data=2, model=2)`` ranks: steps 0-2 write one checkpoint
   collectively, fresh rank Trainers restore it and run steps 3-5, their
   state bitwise the one-process twin's uninterrupted run
   (:func:`d2ckpt_reference`), then the twin restores the same file
   bitwise its own step-3 state (:func:`_d2ckpt_twin_restores`); save and
   restore seconds, the bytes gathered, the pinned peak.  After slice
   14, ``[examples]`` (:func:`run_examples`) runs the four
   ``examples/torch_*.py`` on the card at small arguments.
20. slice 19's phase, the port's own static analysis (A.12; after
   ``[roofline]``): ``[analysis]`` (:func:`run_analysis_path`) runs
   ``python -m repro_torch.analysis``'s ``main`` in this process over the
   checkout, with no JAX on the machine: exit 0 required, its finding,
   allow-marker and baseline counts and its seconds printed.
21. slice 20's paths, real overlap (A.10.6): each overlapped gossip step
   on the sharded rounds issues the buffered round's halo gather before
   its forward (``mixing.issue_round``) and the apply waits for it.
   ``[sovround]`` (:func:`sovround`, right after ``[sovmain]``, whose
   steps now issue): one finish on its mesh of 4 node shards, the halos
   issued on the side stream and serial, bitwise equal or the run fails,
   both timed; ``[dovmain]`` (in slice 15's spawn after ``[dcmain]``):
   ``[dmain]``'s configuration with ``comm_overlap=True``, 4 steps
   (gossip, gossip, global, gossip), each rank's halo in flight on the
   node axis's own process group, held to its one-process twin
   (:func:`dov_reference`, computed before the spawn) by
   :func:`_gate_against_twin`: losses within rtol 1e-6, params bitwise,
   B.4 once a gossip step a rank (12 launches summed), consensus 0.0
   after the flush, no plain twin, a wait for a halo on every gossip step
   and none on the others; per rank and step the worker's and the
   wait's seconds, the hidden part, staging waits, synchronizing calls,
   pinned and memory peaks (:func:`_report_dovmain`).  ``python3
   chip_smoke.py --overlap-compare`` times the overlapped step serial
   against issued in turns, in one process and on the ranks
   (:func:`run_overlap_compare`), and stops without an ok line.

Every kernel's record must show launches on a main path.  The last three
lines of standard output are the card's name and power limit, one JSON
object with the kernel records, and the ok line.  The
script imports nothing of JAX: the card's machine has none.
"""
from __future__ import annotations

import contextlib
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
SHORT_SPIN = 20_000_000             # ~10 ms, past the ~1 ms 20 calls queue in
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
# register instance at V = 1; the generic one until PR 33), the large
# leaves, and the simulator's joint (x, w) trees ([psim]: d = 6 at n = 16,
# d = 10 at n = 100)
PUSH_MIX_SHAPES = ((8, 19_201), (8, 7_077_888), (8, MAIN_D),
                   (8, 28_311_552), (16, 7), (100, 11))
PUSH_GROUP_D = 19_201               # row 1c: the push staging group
SHADOW_COLUMNS = 1 << 25            # GenericShadow's columns a launch
# every (n, V) instance of mix.cu's register kernel (V: columns a thread)
MIX_INSTANCES = ((2, 4), (2, 1), (4, 4), (4, 1), (8, 4), (8, 1), (16, 2),
                 (16, 1), (32, 1))
# the node-parallel instances (slice 23) against the generic ones: node
# counts (892, the largest the generic instance takes at 32 threads a
# block), widths, and the two node counts also held at RAGGED_D
NODES_N = (3, 5, 33, 64, 100, 256, 892)
NODES_D = (1, 10, 11, 20, 1000)
NODES_WIDE_N = (100, 256)
# cmix at the register instance's n, at widths it refuses (not a multiple
# of the vector width): the node-parallel instance, by the rule
CMIX_NODES_RAGGED = ((4, 10), (8, 11), (16, 11))
# the dispatch rule's thresholds (NODES_MIN_N = 48, NODES_NARROW_D = 8,192)
# either side, and cmix at n = 2 on a trainer leaf's width (the generic
# instance, by the rule)
NODES_RULE_SHAPES = (("mix", 3, 8_001), ("mix", 3, 16_001),
                     ("mix", 33, RAGGED_D), ("mix", 48, RAGGED_D),
                     ("cmix", 3, 8_001), ("cmix", 3, 16_001),
                     ("cmix", 33, RAGGED_D), ("cmix", 48, RAGGED_D),
                     ("cmix", 2, 8_001), ("cmix", 2, 25_165_824))
# row 1d: the simulators' mix calls (n, D, with_g, factors): [sim] (the
# half-step fused), GT-PGA's joint tree, [psim]'s (x, w) tree
SIM_ROUND_CALLS = ((100, 10, True, "ring"), (100, 20, False, "ring"),
                   (100, 11, False, "push"))
# shard_cmix.cu's node-parallel instance (slice 24) against the column one:
# shard rows (each at K = m and 2m, and m = 50 over K = 100, a sharded
# halo), widths (RAGGED_D too at SHARD_NODES_WIDE_M, K = m), and the
# dispatch rule's timed shapes (K = m and 2m at each)
SHARD_NODES_M = (3, 8, 33, 48, 100, 256)
SHARD_NODES_D = (1, 10, 37, 8_001)
SHARD_NODES_WIDE_M = (3, 100)
SHARD_RULE_M = (3, 8, 33, 48, 100)
SHARD_RULE_D = (10, 8_001, RAGGED_D)
# collective.cu's narrow instance against the untiled (and tiled) ones:
# node counts and widths (those the rule gives it), and the rule's timed
# shapes
COLL_NARROW_N = (1, 2, 16, 32, 100, 256)
COLL_NARROW_D = (1, 10, 31, 32, 100, 1000, 1024)
COLL_RULE_N = (16, 32, 100, 256)
COLL_RULE_D = (1, 10, 100, 1000)


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
                        ("mix_vector_kernel<8, 4, residual>",
                         "mix_vector_kernelILi8ELi4ELb0ELb0ELb1E")),
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


def device_ms(torch, fn, iters=20, warmup=3, spin=SPIN_CYCLES) -> float:
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
    spin_start, before, start, end = (torch.cuda.Event(enable_timing=True)
                                      for _ in range(4))
    spin_start.record()
    torch.cuda._sleep(spin)
    before.record()
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    if not host_ms < spin_start.elapsed_time(before):
        raise AssertionError(f"device_ms: queueing took {host_ms:.2f} ms, "
                             f"longer than the "
                             f"{spin_start.elapsed_time(before):.2f} ms spin")
    return start.elapsed_time(end) / iters


def _bound(bytes_moved: float, flops: float):
    """``(bound_ms, bound_by)``: the larger of the bytes over the HBM rate
    and the fp32 operations over the card's fp32 rate."""
    b = bytes_moved / HBM_BYTES_PER_S * 1e3
    f = flops / FP32_FLOP_PER_S * 1e3
    return max(b, f), "bytes" if b >= f else "operations"


def _turns(torch, old, new, iters=20, spin=SPIN_CYCLES) -> tuple:
    """``(old ms, new ms)`` by :func:`device_ms`, timed in turns (old, new,
    new, old) and averaged per version."""
    o1, n1, n2, o2 = (device_ms(torch, f, iters=iters, warmup=min(iters, 3),
                                spin=spin)
                      for f in (old, new, new, old))
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


def two_node_widths(mc) -> dict:
    """The dispatch groups' widths of the two n = 2 trainers,
    ``[moetrain]`` and ``[jtrain]``, from the meta init of their configs
    (no card memory)."""
    from repro_torch.models.model import make_model
    from repro_torch.train.state import stack_for_nodes
    from repro_torch.tree import tree_leaves

    out = {}
    for tag, tcfg in (("[moetrain]", _moetrain_config()),
                      ("[jtrain]", _jtrain_config())):
        params, _ = make_model(tcfg.model).abstract_init()
        leaves = tree_leaves(stack_for_nodes(params, 2))
        groups = mc._dispatch_groups(leaves, tcfg.dist.pallas_leaf_threshold)
        out[tag] = [sum(leaves[i][0].numel() for i in g) for g in groups]
        del params, leaves
    return out


def check_mix_kernel(torch, mc) -> dict:
    """Kernel vs plain version, each case on the instance that
    ``mix_vector_width`` picks.  Tolerances: max|o − o_plain| and
    max|x̄ − x̄_plain| ≤ 1e-5·max|x| (the plain version's matmul sums the
    n terms in another order than the kernel's loop), residual relative
    error ≤ 1e-5 (another summation order over D columns), and the rows
    of a global round bitwise equal with a residual of exactly 0.  Where
    the register instance takes a case, it also runs on the generic
    instance: o and x̄ bitwise equal, and the register instance's residual
    bitwise the same in two runs; every (n, V) of :data:`MIX_INSTANCES`
    must be among them (V = 1 at ragged widths and at views one float
    off a 16-byte boundary), or the run fails.  For n not a power of two
    the mean of n equal rows is not always exact, so a global round's
    residual is held to n·D·(2⁻²⁰·max|o|)² instead of 0.  The simulator's
    shapes ([sim], [simx]: n = 16 and 100 at D = 10, and D = 20 for
    GT-PGA's joint tree) run on a ring with and without the half-step and
    the residual.  The push-sum rounds (:data:`PUSH_MIX_SHAPES`) run with
    d and M built on the card from two runtime matrices
    (:func:`push_matrices`), fp32 and bf16 wire; row 1c times their
    staging group (n = 8, D = 19,201: V = 1) on both instances."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    gamma = torch.tensor([0.05], device="cuda")
    worst = 0.0
    cases = vector_cases = nodes_cases = 0
    covered = {}

    def compare(x, g, d, M, with_g, with_residual, wire, bitwise_rows,
                inplace=False):
        nonlocal worst, cases, vector_cases, nodes_cases
        args = (x, g if with_g else None, gamma if with_g else None, d, M)
        kw = dict(with_g=with_g, with_residual=with_residual, wire=wire)
        vec = mc.mix_vector_width(x, g if with_g else None)
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
                f"mix kernel n={x.shape[0]} D={x.shape[1]} {kw} vector "
                f"width={vec}: max abs err {err:.3e} > {tol:.3e}")
        if bitwise_rows:
            assert torch.equal(o, o[:1].expand_as(o)), "global rows differ"
        if vec:
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
                        f"mix n={x.shape[0]} D={x.shape[1]} {kw} V={vec}: "
                        f"register instance differs from the generic one by "
                        f"{float((a - b).abs().max()):.3e}")
            if with_residual and not torch.equal(out[2], again[2]):
                raise AssertionError(f"mix residual differs between two "
                                     f"runs: {float(out[2])!r} "
                                     f"{float(again[2])!r}")
            del old, again
            vector_cases += 1
            key = (x.shape[0], vec)
            covered[key] = covered.get(key, 0) + 1
        elif mc.use_nodes_mix(x, g if with_g else None):
            # the node-parallel instance: o, x̄ and the residual bitwise
            if inplace:
                stage = x.clone()
                old = mc.mix_generic(stage, *args[1:], **kw, inplace=True)
            else:
                old = mc.mix_generic(*args, **kw)
            pairs = list(zip(out, old)) if with_residual else [(out, old)]
            if not all(_same_bits(torch, a, b) for a, b in pairs):
                raise AssertionError(f"mix n={x.shape[0]} D={x.shape[1]} "
                                     f"{kw}: the node-parallel instance "
                                     f"differs from the generic one")
            del old
            nodes_cases += 1
        worst = max(worst, err)
        cases += 1

    def rows(n, width, offset=0):
        """A random (n, width) operand, ``offset`` floats past the start
        of its allocation (1: every row off a 16-byte boundary)."""
        buf = torch.randn(n * width + offset, device="cuda", generator=gen)
        return buf[offset:].view(n, width)

    # n = 2, 4, 8 and 16 at D = 1,000,003 (V = 1) and at D a multiple of
    # their vector width (V = 4, 4, 4, 2), n = 32 (V = 1), all on the
    # register instance; n = 256 on the generic one (it opts into more
    # than 48 KB of shared memory)
    for n, width in ((2, RAGGED_D), (2, RAGGED_D - 3), (4, RAGGED_D),
                     (4, RAGGED_D - 3), (8, RAGGED_D), (8, RAGGED_D - 3),
                     (16, RAGGED_D), (16, RAGGED_D - 1), (32, RAGGED_D),
                     (256, 100_003)):
        x = rows(n, width)
        g = rows(n, width)
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

    # rows one float off a 16-byte boundary at a width that is a multiple
    # of every vector width: V = 1, with and without the half-step (whose
    # g is aligned: the rule reads every row operand)
    for n in (2, 4, 8, 16):
        x = rows(n, RAGGED_D - 3, offset=1)
        g = rows(n, RAGGED_D - 3)
        d, M = (torch.from_numpy(a).cuda()
                for a in mc.phase_matrices("gossip", "exp", n))
        for with_g in (False, True):
            for wire in (False, True):
                compare(x, g, d, M, with_g, True, wire, False)
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
    missing = [nv for nv in MIX_INSTANCES if nv not in covered]
    if missing:
        raise AssertionError(f"mix: no case on the register instances "
                             f"(n, V) = {missing}")

    # every launch width of the main path (n = 8) and of the two-node
    # trainers ([moetrain], [jtrain]: n = 2) takes the register instance
    # at its vector width; meta tensors stand in for the operands
    widths = {"[main]": (MAIN_N, list(MAIN_WIDTHS))}
    widths.update((tag, (2, ws)) for tag, ws in two_node_widths(mc).items())
    for tag, (n, ws) in widths.items():
        for width in ws:
            meta = torch.empty((n, width), device="meta")
            if mc.mix_vector_width(meta) != mc.vector_width(n):
                raise AssertionError(
                    f"{tag} width {width} at n = {n} is not taken by the "
                    f"register instance at V = {mc.vector_width(n)}")

    # the main path's calls (n = 8, fp32 wire, consensus residual on, as
    # Trainer's fused round launches them), timed at the embedding leaf
    d, M = (torch.from_numpy(a).cuda()
            for a in mc.phase_matrices("gossip", "one_peer_exp", MAIN_N))
    for width in MAIN_WIDTHS:
        x = torch.randn(MAIN_N, width, device="cuda", generator=gen)
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
    del x
    push_group = push_group_times(torch, mc, gen)
    print(f"[kernel] mix: {cases} kernel-vs-plain cases within tolerance, "
          f"max abs err {worst:.3e}; {vector_cases} of them on the register "
          f"instance, bitwise equal to the generic one, covering all "
          f"{len(MIX_INSTANCES)} (n, V) instances "
          f"{dict(sorted(covered.items()))}; {nodes_cases} on the "
          f"node-parallel instance, o, x̄ and residual bitwise the generic "
          f"one's; {push_cases} with a "
          f"runtime push-sum W at {PUSH_MIX_SHAPES}; every launch width of "
          f"{', '.join(widths)} on the register instance at its vector "
          f"width", flush=True)
    return {"name": "mix_vector_kernel", "route": "cuda",
            "source": "src/repro_torch/csrc/mix.cu",
            "replaces": "src/repro/kernels/mixing_pallas.py:215",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "old_ms": old_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "push_group": push_group}


def push_group_times(torch, mc, gen) -> dict:
    """Row 1c: the push paths' staging group (n = 8, D = 19,201, the norms
    and the weight column: V = 1) as ``fused_step_mix_dense`` launches it
    (a runtime W, fp32 wire, no residual) on the register instance and the
    generic one, by :func:`device_ms` in turns, beside the plain version,
    ``torch.matmul`` of W and the bound by bytes.  A round this small may
    be bound by its launch, not its bytes."""
    n, D = MAIN_N, PUSH_GROUP_D
    x = torch.randn(n, D, device="cuda", generator=gen)
    W = torch.from_numpy(push_matrices(n)[0]).cuda()
    d, M = mc.dense_factors(W, n)
    if mc.mix_vector_width(x) != 1:
        raise AssertionError(f"row 1c: width {mc.mix_vector_width(x)}")
    kw = dict(with_g=False, with_residual=False, wire=False)
    old_ms, ms = _turns(
        torch, lambda: mc.mix_generic(x, None, None, d, M, **kw),
        lambda: mc.mix_vector(x, None, None, d, M, **kw))
    plain_ms = cuda_ms(torch,
                       lambda: mc.mix_flat_plain(x, None, None, d, M, **kw))
    library_ms = device_ms(torch, lambda: torch.matmul(W, x))
    bound_ms, bound_by = _bound(4 * 2 * n * D, 2 * n * n * D)
    print(f"[kernel] mix row 1c n={n} D={D:,} (the push paths' staging "
          f"group, runtime W, no residual): register instance V = 1 "
          f"{ms:.4f} ms, generic instance {old_ms:.4f} ms (device_ms, in "
          f"turns), plain {plain_ms:.4f} ms, torch.matmul(W, x) "
          f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by} "
          f"({100 * bound_ms / ms:.1f}% of the bound)", flush=True)
    return {"shape": [n, D], "vector_width": 1, "ms": ms, "old_ms": old_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


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
    worst, cases, vector_cases, nodes_cases = 0.0, 0, 0, 0
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
        nonlocal worst, cases, vector_cases, nodes_cases
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
        vector = mc.use_vector_cmix(x, e, q)
        if vector or mc.use_nodes_cmix(x, e, q):
            (go, gef), _ = run(x, e, kind, phase, topo, pods, wire, seed, q,
                               launch=mc.cmix_generic, factors=factors)
            which = "register" if vector else "node-parallel"
            if not (torch.equal(o, go) and (ef is None
                                            or torch.equal(ef, gef))):
                raise AssertionError(f"{what}: the {which} instance differs "
                                     f"from the generic one")
            if vector:
                vector_cases += 1
            else:
                nodes_cases += 1
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
          f"instance and {nodes_cases} on the node-parallel one, each "
          f"bitwise equal to the generic one; constant fixed point bitwise "
          f"for int8, fp8, topk, randk on both instances", flush=True)
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


def _same_bits(torch, a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _dense_factors(torch, gen, n):
    """A dense (n, 1) d and (n, n) M on the card, every product of the
    round nonzero: each M row sums to 1/2."""
    M = torch.rand(n, n, device="cuda", generator=gen)
    M = M / (2 * M.sum(dim=1, keepdim=True))
    return torch.rand(n, 1, device="cuda", generator=gen) / 2, M.contiguous()


def check_mix_nodes_kernel(torch, mc) -> dict:
    """mix.cu's node-parallel instance bit for bit against the generic
    one: o, x̄ and the residual at every n of :data:`NODES_N` and D of
    :data:`NODES_D` (and D = RAGGED_D at :data:`NODES_WIDE_N`), every
    (with_g, wire, residual), dense factors (every product nonzero), and
    in place (o written over a private copy of x, both instances) at every
    (n, D) with the half-step, the wire and the residual; o within
    1e-5·max|x′| of the plain twin.  Row 1d: the simulators' calls
    (:data:`SIM_ROUND_CALLS`, ring or runtime push-sum factors) on both
    instances in turns, beside a one-element launch (the floor), the plain
    twin, ``torch.matmul`` of W and the bound; then both instances at
    n = 100 and 256, D = RAGGED_D, for the dispatch rule."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    gamma = torch.tensor([0.05], device="cuda")
    t0 = time.perf_counter()
    cases, inplace_cases, worst = 0, 0, 0.0

    def run(launch, x, g, d, M, kw, inplace=False):
        gg, gm = (g, gamma) if kw["with_g"] else (None, None)
        out = launch(x, gg, gm, d, M, **kw, inplace=inplace)
        return out if kw["with_residual"] else (out,)

    shapes = [(n, D) for n in NODES_N for D in NODES_D] + [
        (n, RAGGED_D) for n in NODES_WIDE_N]
    for n, D in shapes:
        d, M = _dense_factors(torch, gen, n)
        x = torch.randn(n, D, device="cuda", generator=gen)
        g = torch.randn(n, D, device="cuda", generator=gen)
        if not mc.use_nodes_mix(x, g):
            raise AssertionError(f"mix n={n} D={D}: not taken by the "
                                 f"node-parallel instance")
        for with_g in (False, True):
            for wire in (False, True):
                for with_residual in (False, True):
                    kw = dict(with_g=with_g, wire=wire,
                              with_residual=with_residual)
                    new = run(mc.mix_nodes, x, g, d, M, kw)
                    old = run(mc.mix_generic, x, g, d, M, kw)
                    if not all(_same_bits(torch, a, b)
                               for a, b in zip(new, old)):
                        raise AssertionError(
                            f"mix n={n} D={D} {kw}: the node-parallel "
                            f"instance differs from the generic one")
                    plain = mc.mix_flat_plain(
                        x, g if with_g else None, gamma if with_g else None,
                        d, M, **kw)
                    o_plain = plain[0] if with_residual else plain
                    xs = x - gamma * g if with_g else x
                    err = float((new[0] - o_plain).abs().max())
                    if err > 1e-5 * float(xs.abs().max()):
                        raise AssertionError(f"mix n={n} D={D} {kw}: "
                                             f"{err:.3e} from the plain twin")
                    worst = max(worst, err)
                    cases += 1
                    del new, old, plain, xs
        kw = dict(with_g=True, wire=True, with_residual=True)
        outs = []
        for launch in (mc.mix_nodes, mc.mix_generic):
            stage = x.clone()
            outs.append(run(launch, stage, g, d, M, kw, inplace=True))
            if outs[-1][0].data_ptr() != stage.data_ptr():
                raise AssertionError(f"mix n={n} D={D}: not in place")
        if not all(_same_bits(torch, a, b) for a, b in zip(*outs)):
            raise AssertionError(f"mix n={n} D={D}: in place, the "
                                 f"node-parallel instance differs")
        inplace_cases += 1
        del x, g, outs, stage
    torch.cuda.empty_cache()
    print(f"[kernel] mix_nodes: {cases} cases bitwise the generic instance "
          f"(o, x̄, residual) at n {NODES_N} x D {NODES_D} and "
          f"{NODES_WIDE_N} x {RAGGED_D:,}, every (with_g, wire, residual), "
          f"dense factors; {inplace_cases} in place (o over x) bitwise; o "
          f"within {worst:.3e} of the plain twin; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    rows = []
    for n, D, with_g, factors in SIM_ROUND_CALLS:
        x = torch.randn(n, D, device="cuda", generator=gen)
        g = torch.randn(n, D, device="cuda", generator=gen)
        if factors == "ring":
            d, M = (torch.from_numpy(a).cuda()
                    for a in mc.phase_matrices("gossip", "ring", n, step=1))
        else:
            d, M = mc.dense_factors(
                torch.from_numpy(push_matrices(n)[0]).cuda(), n)
        gg, gm = (g, gamma) if with_g else (None, None)
        kw = dict(with_g=with_g, with_residual=False, wire=False)
        old_ms, ms = _turns(torch, lambda: mc.mix_generic(x, gg, gm, d, M,
                                                          **kw),
                            lambda: mc.mix_nodes(x, gg, gm, d, M, **kw))
        one = torch.randn(1, 1, device="cuda", generator=gen)
        d1, M1 = torch.ones(1, 1, device="cuda"), torch.ones(1, 1,
                                                             device="cuda")
        floor_ms = device_ms(torch, lambda: mc.mix_nodes(
            one, one if with_g else None, gm, d1, M1, **kw))
        plain_ms = cuda_ms(torch, lambda: mc.mix_flat_plain(x, gg, gm, d, M,
                                                            **kw))
        W = M + torch.diag(d[:, 0])
        library_ms = device_ms(torch, lambda: torch.matmul(W, x))
        # read x (and g), write o; the mix and the half-step
        bound_ms, bound_by = _bound(4 * (3 if with_g else 2) * n * D,
                                    2 * n * n * D + (2 * n * D if with_g
                                                     else 0))
        print(f"[kernel] mix row 1d n={n} D={D} {factors} factors, "
              f"half-step {with_g}, no residual: node-parallel {ms:.4f} "
              f"ms, generic {old_ms:.4f} ms (device_ms, in turns; "
              f"{old_ms / ms:.1f}x), a one-element "
              f"launch {floor_ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.matmul(W, x) {library_ms:.4f} ms, bound "
              f"{bound_ms:.6f} ms by {bound_by}", flush=True)
        rows.append({"shape": [n, D], "with_g": with_g, "ms": ms,
                     "old_ms": old_ms, "floor_ms": floor_ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by})
        del x, g
    wide = []
    for n in NODES_WIDE_N:
        x = torch.randn(n, RAGGED_D, device="cuda", generator=gen)
        d, M = _dense_factors(torch, gen, n)
        kw = dict(with_g=False, with_residual=False, wire=False)
        old_ms, ms = _turns(
            torch, lambda: mc.mix_generic(x, None, None, d, M, **kw),
            lambda: mc.mix_nodes(x, None, None, d, M, **kw), iters=3)
        plan = mc.nodes_plan(n, RAGGED_D)
        bound_ms, bound_by = _bound(4 * 2 * n * RAGGED_D,
                                    2 * n * n * RAGGED_D)
        print(f"[kernel] mix n={n} D={RAGGED_D:,} (the dispatch rule's "
              f"width): node-parallel {ms:.4f} ms (grid {plan['grid']}), "
              f"generic {old_ms:.4f} ms (device_ms, in "
              f"turns; {old_ms / ms:.1f}x), bound {bound_ms:.4f} ms by "
              f"{bound_by} ({100 * bound_ms / ms:.1f}% of it)", flush=True)
        wide.append({"shape": [n, RAGGED_D], "ms": ms, "old_ms": old_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by})
        del x
    torch.cuda.empty_cache()
    head = rows[0]
    return {"name": "mix_nodes_kernel", "route": "cuda",
            "source": "src/repro_torch/csrc/mix.cu",
            "replaces": "src/repro/kernels/mixing_pallas.py:215",
            "launches": None, "max_abs_err": worst, "ms": head["ms"],
            "old_ms": head["old_ms"], "floor_ms": head["floor_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "row_1d": rows, "wide": wide}


def check_cmix_nodes_kernel(torch, mc) -> dict:
    """cmix.cu's node-parallel instance bit for bit against the generic
    one: o and the new EF for int8 and fp8 codes (EF on and off) and
    precomputed q, each with and without the bf16 wire, at n = 2 (where
    the rule keeps the generic instance) and every n of :data:`NODES_N`,
    D = 10 and 11, at n = 100, D = RAGGED_D, and at
    :data:`CMIX_NODES_RAGGED`; dense factors; o and EF also bitwise the
    plain twin.  Row 2b: [sim]'s compressed gossip call (n = 100, D = 10,
    int8 + EF, ring) on both instances in turns, beside a one-element
    launch, the plain twin, ``torch.matmul(M, q)`` and the bound; then
    both at n = 100, D = RAGGED_D, for the dispatch rule."""
    from repro_torch.compress import quantize as cq

    gen = torch.Generator(device="cuda").manual_seed(4)
    t0 = time.perf_counter()
    cases = 0

    def run(launch, x, e, q, w, M, kind, wire, seed=7):
        scale = None
        if kind != "precomputed":
            y = x if e is None else x + e
            scale = cq.int8_scale(y) if kind == "int8" else cq.fp8_scale(y)
        args = (x, e, q, seed, scale, w, M)
        kw = dict(kind=kind, with_ef=e is not None, wire=wire)
        return launch(*args, **kw), (args, kw)

    shapes = [(n, D) for n in (2,) + NODES_N for D in (10, 11)] + [
        (100, RAGGED_D)] + list(CMIX_NODES_RAGGED)
    for n, D in shapes:
        d, M = _dense_factors(torch, gen, n)
        w = 1.0 - d
        x = torch.randn(n, D, device="cuda", generator=gen)
        e = 0.01 * torch.randn(n, D, device="cuda", generator=gen)
        q = torch.round(8 * torch.randn(n, D, device="cuda",
                                        generator=gen)) / 8
        if mc.use_nodes_cmix(x, e, q) != (n >= 3):
            raise AssertionError(f"cmix n={n} D={D}: the rule sends it to "
                                 f"the wrong instance")
        combos = [(kind, ef) for kind in ("int8", "fp8")
                  for ef in (None, e)] + [("precomputed", None)]
        for kind, ef in combos:
            qq = q if kind == "precomputed" else None
            for wire in (False, True):
                (o, new_ef), (args, kw) = run(mc.cmix_nodes, x, ef, qq, w, M,
                                              kind, wire)
                (go, gef), _ = run(mc.cmix_generic, x, ef, qq, w, M, kind,
                                   wire)
                po, pef = mc.cmix_flat_plain(*args, **kw)
                same = _same_bits(torch, o, go) and _same_bits(torch, o, po)
                if ef is not None:
                    same = same and _same_bits(torch, new_ef, gef) and \
                        _same_bits(torch, new_ef, pef)
                if not same:
                    raise AssertionError(f"cmix n={n} D={D} {kw}: the "
                                         f"node-parallel instance differs")
                cases += 1
                del o, new_ef, go, gef, po, pef
        del x, e, q
    torch.cuda.empty_cache()
    print(f"[kernel] cmix_nodes: {cases} cases bitwise the generic instance "
          f"and the plain twin (o and EF) at n {(2,) + NODES_N} x D (10, 11), "
          f"n = 100 x {RAGGED_D:,} and (n, D) {CMIX_NODES_RAGGED} (the "
          f"register instance's n at widths it refuses): int8 and fp8 with "
          f"EF on and off, "
          f"precomputed q, wire on and off; {time.perf_counter() - t0:.1f} s",
          flush=True)

    n, D = SIM_COMP_SHAPES[-1]
    x = torch.randn(n, D, device="cuda", generator=gen)
    e = 0.01 * torch.randn(n, D, device="cuda", generator=gen)
    w, M = mc._device_compensated("gossip", "ring", n, 1, 1,
                                  torch.device("cuda"))
    scale = cq.int8_scale(x + e)
    kw = dict(kind="int8", with_ef=True, wire=False)
    old_ms, ms = _turns(
        torch, lambda: mc.cmix_generic(x, e, None, 7, scale, w, M, **kw),
        lambda: mc.cmix_nodes(x, e, None, 7, scale, w, M, **kw))
    one = torch.randn(1, 1, device="cuda", generator=gen)
    ones = torch.ones(1, 1, device="cuda")
    floor_ms = device_ms(torch, lambda: mc.cmix_nodes(
        one, one, None, 7, ones, ones, ones, **kw))
    plain_ms = cuda_ms(torch, lambda: mc.cmix_flat_plain(
        x, e, None, 7, scale, w, M, **kw))
    library_ms = device_ms(torch, lambda: torch.matmul(M, x))
    bound_ms, bound_by = _bound(4 * 4 * n * D, (2 * n + 12) * n * D)
    print(f"[kernel] cmix row 2b n={n} D={D} int8+EF ring gossip: "
          f"node-parallel {ms:.4f} ms, generic {old_ms:.4f} ms (device_ms, in "
          f"turns; {old_ms / ms:.1f}x), a one-element launch {floor_ms:.4f} "
          f"ms, plain {plain_ms:.4f} ms, torch.matmul(M, q) (the mix part "
          f"only) {library_ms:.4f} ms, bound {bound_ms:.6f} ms by {bound_by}",
          flush=True)
    rec = {"name": "cmix_nodes_kernel", "route": "cuda",
           "source": "src/repro_torch/csrc/cmix.cu",
           "replaces": "src/repro/kernels/mixing_pallas.py:504",
           "launches": None, "max_abs_err": 0.0, "ms": ms, "old_ms": old_ms,
           "floor_ms": floor_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms}
    n, D = 100, RAGGED_D
    x = torch.randn(n, D, device="cuda", generator=gen)
    e = 0.01 * torch.randn(n, D, device="cuda", generator=gen)
    d, M = _dense_factors(torch, gen, n)
    w = 1.0 - d
    scale = cq.int8_scale(x + e)
    old_ms, ms = _turns(
        torch, lambda: mc.cmix_generic(x, e, None, 7, scale, w, M, **kw),
        lambda: mc.cmix_nodes(x, e, None, 7, scale, w, M, **kw), iters=3)
    bound_ms, bound_by = _bound(4 * 4 * n * D, (2 * n + 12) * n * D)
    print(f"[kernel] cmix n={n} D={D:,} int8+EF (the dispatch rule's width): "
          f"node-parallel {ms:.4f} ms, generic {old_ms:.4f} ms (device_ms, in "
          f"turns; {old_ms / ms:.1f}x), bound {bound_ms:.4f} ms by "
          f"{bound_by} ({100 * bound_ms / ms:.1f}% of it)", flush=True)
    rec["wide"] = [{"shape": [n, D], "ms": ms, "old_ms": old_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by}]
    del x, e
    torch.cuda.empty_cache()
    return rec


def nodes_rule_times(torch, mc) -> list:
    """The dispatch rule's crossovers (``mixing_cuda._nodes_rows``): the
    node-parallel and the generic instance of mix.cu (no half-step, wire
    or residual) and cmix.cu (int8 + EF) in turns at
    :data:`NODES_RULE_SHAPES`, either side of each threshold, and cmix at
    n = 2 on a trainer leaf's width, each beside the instance the rule
    picks."""
    from repro_torch.compress import quantize as cq

    gen = torch.Generator(device="cuda").manual_seed(5)
    out = []
    for kernel, n, D in NODES_RULE_SHAPES:
        d, M = _dense_factors(torch, gen, n)
        x = torch.randn(n, D, device="cuda", generator=gen)
        iters = 20 if n * D < 2e6 else 5
        if kernel == "mix":
            kw = dict(with_g=False, with_residual=False, wire=False)
            old_ms, ms = _turns(
                torch, lambda: mc.mix_generic(x, None, None, d, M, **kw),
                lambda: mc.mix_nodes(x, None, None, d, M, **kw), iters=iters)
            picks = mc.use_nodes_mix(x)
        else:
            e = 0.01 * torch.randn(n, D, device="cuda", generator=gen)
            scale = cq.int8_scale(x + e)
            kw = dict(kind="int8", with_ef=True, wire=False)
            old_ms, ms = _turns(
                torch, lambda: mc.cmix_generic(x, e, None, 7, scale, 1.0 - d,
                                               M, **kw),
                lambda: mc.cmix_nodes(x, e, None, 7, scale, 1.0 - d, M,
                                      **kw), iters=iters)
            picks = mc.use_nodes_cmix(x, e)
            del e
        print(f"[kernel] {kernel} rule n={n} D={D:,}: node-parallel "
              f"{ms:.4f} ms, generic {old_ms:.4f} ms (device_ms, in turns; "
              f"{old_ms / ms:.2f}x); the rule picks "
              f"{'node-parallel' if picks else 'generic'}", flush=True)
        out.append({"kernel": kernel, "shape": [n, D], "ms": ms,
                    "old_ms": old_ms, "nodes": picks})
        del x
    torch.cuda.empty_cache()
    return out


def check_shard_cmix_nodes_kernel(torch, mc) -> dict:
    """shard_cmix.cu's node-parallel instance bit for bit against the
    column instance and within the shard tolerance (1e-5·s, as
    :func:`check_shard_cmix_kernel`) of the plain twin: m of
    :data:`SHARD_NODES_M` at K = m and 2m (and m = 50 over K = 100), D of
    :data:`SHARD_NODES_D` (and RAGGED_D at :data:`SHARD_NODES_WIDE_M`,
    K = m), ``q_self`` its own rows and, at K = m, ``q_self is qs`` (the
    stacked apply); dense factors, and at K = m the runtime compensated
    factors of a ring (and one_peer_exp at powers of two) gossip round.
    The record's times come from :func:`sim_shape_rows`."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cases, worst = 0, 0.0
    shapes = [(m, K, D) for m in SHARD_NODES_M for K in (m, 2 * m)
              for D in SHARD_NODES_D] + [(50, 100, D) for D in SHARD_NODES_D]
    shapes += [(m, m, RAGGED_D) for m in SHARD_NODES_WIDE_M]
    for m, K, D in shapes:
        M = torch.rand(m, K, device="cuda", generator=gen)
        M = (M / (2 * M.sum(dim=1, keepdim=True))).contiguous()
        factors = [(torch.rand(m, 1, device="cuda", generator=gen), M)]
        if K == m:
            topos = ("ring", "one_peer_exp") if m & (m - 1) == 0 else (
                "ring",)
            factors += [mc._device_compensated("gossip", t, m, 1, 1, dev)
                        for t in topos]
        x = torch.randn(m, D, device="cuda", generator=gen)
        qs = torch.randn(K, D, device="cuda", generator=gen)
        selves = [torch.randn(m, D, device="cuda", generator=gen)]
        if K == m:
            selves.append(qs)
        if mc.use_nodes_shard_cmix(x, qs) != mc._shard_nodes_rows(m, K, D):
            raise AssertionError(f"shard_cmix m={m} K={K} D={D}: the "
                                 f"predicate is not the rule")
        for w, Mf in factors:
            for q in selves:
                new = mc.shard_cmix_nodes(x, q, qs, w, Mf)
                old = mc.shard_cmix_column(x, q, qs, w, Mf)
                if not _same_bits(torch, new, old):
                    raise AssertionError(
                        f"shard_cmix m={m} K={K} D={D} (q_self is qs: "
                        f"{q is qs}): the node-parallel instance differs "
                        f"from the column one")
                ref = mc.shard_comp_mix_block_plain(x, q, qs, w, Mf)
                s_max = max(float(t.abs().max()) for t in (x, q, qs))
                err = float((new - ref).abs().max())
                if err > 1e-5 * s_max:
                    raise AssertionError(f"shard_cmix m={m} K={K} D={D}: "
                                         f"{err:.3e} from the plain twin")
                worst = max(worst, err)
                cases += 1
                del new, old, ref
        del x, qs, selves
    torch.cuda.empty_cache()
    print(f"[kernel] shard_cmix_nodes: {cases} cases bitwise the column "
          f"instance at m {SHARD_NODES_M} x K (m, 2m) x D {SHARD_NODES_D}, "
          f"m = 50 over K = 100, and m {SHARD_NODES_WIDE_M} = K x "
          f"{RAGGED_D:,}; q_self its own rows and q_self is qs; dense, ring "
          f"and one_peer_exp factors; within {worst:.3e} of the plain twin; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"name": "shard_cmix_nodes_kernel", "route": "cuda",
            "source": "src/repro_torch/csrc/shard_cmix.cu",
            "replaces": "src/repro/kernels/mixing_pallas.py:924",
            "launches": None, "max_abs_err": worst}


def check_collective_narrow_kernel(torch, mc) -> dict:
    """collective.cu's narrow instance bit for bit against the untiled
    instance (forced), the tiled one where its tile fits, and the plain
    twin, o and the new EF: n of :data:`COLL_NARROW_N`, D of
    :data:`COLL_NARROW_D` that the rule gives it, int8 and fp8, 1, 2 and
    4 pods, EF on and off; in place (int8 + EF, o over x and EF over e);
    a constant state returned bitwise.  The record's times come from
    :func:`sim_shape_rows`."""
    from repro_torch.compress import collective as ccol

    gen = torch.Generator(device="cuda").manual_seed(10)
    s1, s2 = ccol.stage_seeds(7)
    t0 = time.perf_counter()
    cases = inplace = const_cases = 0

    def outs_equal(a, b):
        return _same_bits(torch, a[0], b[0]) and (
            a[1] is None or _same_bits(torch, a[1], b[1]))

    for n in COLL_NARROW_N:
        for D in COLL_NARROW_D:
            pods_all = [p for p in (1, 2, 4) if n % p == 0]
            pods_in = [p for p in pods_all
                       if mc.use_narrow_collective(n, p, D, ccol.QBLOCK)]
            if not pods_in:
                continue
            x = torch.randn(n, D, device="cuda", generator=gen)
            e = 0.01 * torch.randn(n, D, device="cuda", generator=gen)
            for pods in pods_in:
                tiled = mc.collective_smem(n, pods, ccol.QBLOCK, True) <= \
                    mc.cuda_build.MAX_SMEM
                for kind in ("int8", "fp8"):
                    for ef in (None, e):
                        kw = dict(kind=kind, with_ef=ef is not None,
                                  n_pods=pods, qblock=ccol.QBLOCK)
                        new = mc.collective_flat(x, ef, s1, s2,
                                                 instance="narrow", **kw)
                        refs = [mc.collective_flat(x, ef, s1, s2,
                                                   instance="untiled", **kw),
                                mc.collective_flat_plain(x, ef, s1, s2,
                                                         **kw)]
                        if tiled:
                            refs.append(mc.collective_flat(
                                x, ef, s1, s2, instance="tiled", **kw))
                        if not all(outs_equal(new, r) for r in refs):
                            raise AssertionError(
                                f"collective n={n} D={D} pods={pods} "
                                f"{kind} ef={ef is not None}: the narrow "
                                f"instance differs")
                        cases += 1
                        del new, refs
                kw = dict(kind="int8", with_ef=True, n_pods=pods,
                          qblock=ccol.QBLOCK)
                stage, stage_e = x.clone(), e.clone()
                o, eo = mc.collective_flat(stage, stage_e, s1, s2,
                                           inplace=True, instance="narrow",
                                           **kw)
                if not (o.data_ptr() == stage.data_ptr()
                        and eo.data_ptr() == stage_e.data_ptr()
                        and outs_equal((o, eo), mc.collective_flat_plain(
                            x, e, s1, s2, **kw))):
                    raise AssertionError(f"collective n={n} D={D} pods="
                                         f"{pods}: narrow in place differs")
                inplace += 1
                const = x[:1].expand(n, D).contiguous()
                for kind in ("int8", "fp8"):
                    o, _ = mc.collective_flat(const, None, s1, s2, kind=kind,
                                              with_ef=False, n_pods=pods,
                                              qblock=ccol.QBLOCK,
                                              instance="narrow")
                    if not torch.equal(o, const):
                        raise AssertionError(f"collective n={n} D={D} pods="
                                             f"{pods} {kind}: a constant "
                                             f"state is not a fixed point")
                    const_cases += 1
                del stage, stage_e, o, eo, const
            del x, e
    torch.cuda.empty_cache()
    print(f"[kernel] collective_narrow: {cases} cases bitwise the untiled "
          f"instance, the plain twin and (where its tile fits) the tiled "
          f"one, o and EF, at n {COLL_NARROW_N} x D {COLL_NARROW_D} (those "
          f"the rule takes) x 1, 2, 4 pods, int8 and fp8, EF on and off; "
          f"{inplace} in place bitwise; {const_cases} constant fixed points; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"name": "collective_narrow_kernel", "route": "cuda",
            "source": "src/repro_torch/csrc/collective.cu",
            "replaces": "src/repro/kernels/mixing_pallas.py:765",
            "launches": None, "max_abs_err": 0.0}


def shard_rule_times(torch, mc) -> list:
    """shard_cmix.cu's dispatch rule (``mixing_cuda._shard_nodes_rows``):
    the column and the node-parallel instance in turns at m of
    :data:`SHARD_RULE_M` x K = m and 2m x D of :data:`SHARD_RULE_D`, the
    shard's q_self a view of qs, each beside the instance the rule
    picks."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = []
    for m in SHARD_RULE_M:
        for K in (m, 2 * m):
            M = torch.rand(m, K, device="cuda", generator=gen)
            M = (M / (2 * M.sum(dim=1, keepdim=True))).contiguous()
            w = torch.rand(m, 1, device="cuda", generator=gen)
            for D in SHARD_RULE_D:
                x = torch.randn(m, D, device="cuda", generator=gen)
                qs = torch.randn(K, D, device="cuda", generator=gen)
                q = qs[:m]
                old_ms, ms = _turns(
                    torch, lambda: mc.shard_cmix_column(x, q, qs, w, M),
                    lambda: mc.shard_cmix_nodes(x, q, qs, w, M),
                    iters=20 if m * D < 2e6 else 5, spin=SHORT_SPIN)
                picks = mc.use_nodes_shard_cmix(x, qs)
                print(f"[kernel] shard_cmix rule m={m} K={K} D={D:,}: "
                      f"node-parallel {ms:.4f} ms, column {old_ms:.4f} ms "
                      f"(device_ms, in turns; {old_ms / ms:.2f}x); the rule "
                      f"picks {'node-parallel' if picks else 'column'}",
                      flush=True)
                out.append({"shape": [m, K, D], "ms": ms, "old_ms": old_ms,
                            "nodes": picks})
                del x, qs, q
    torch.cuda.empty_cache()
    return out


def collective_rule_times(torch, mc) -> list:
    """collective.cu's narrow rule (``mixing_cuda.use_narrow_collective``):
    int8 + EF global rounds at n of :data:`COLL_RULE_N` x D of
    :data:`COLL_RULE_D`, the narrow instance in turns against the one the
    other rule takes (tiled while its tile fits, else untiled), each beside
    the instance the rule picks; shapes whose narrow tile passes the
    card's shared memory are printed as such."""
    from repro_torch.compress import collective as ccol

    gen = torch.Generator(device="cuda").manual_seed(12)
    s1, s2 = ccol.stage_seeds(7)
    kw = dict(kind="int8", with_ef=True, n_pods=1, qblock=ccol.QBLOCK)
    out = []
    for n in COLL_RULE_N:
        other = ("tiled" if mc.collective_smem(n, 1, ccol.QBLOCK, True)
                 <= mc.cuda_build.MAX_SMEM else "untiled")
        for D in COLL_RULE_D:
            picks = mc.collective_instance(n, 1, D, ccol.QBLOCK)
            if mc.collective_narrow_smem(n, 1, D) > mc.cuda_build.MAX_SMEM:
                print(f"[kernel] collective rule n={n} D={D}: the narrow "
                      f"tile does not fit; the rule picks {picks}",
                      flush=True)
                continue
            x = torch.randn(n, D, device="cuda", generator=gen)
            e = 0.01 * torch.randn(n, D, device="cuda", generator=gen)
            old_ms, ms = _turns(
                torch, lambda: mc.collective_flat(x, e, s1, s2,
                                                  instance=other, **kw),
                lambda: mc.collective_flat(x, e, s1, s2, instance="narrow",
                                           **kw), spin=SHORT_SPIN)
            print(f"[kernel] collective rule n={n} D={D}: narrow {ms:.4f} "
                  f"ms, {other} {old_ms:.4f} ms (device_ms, in turns; "
                  f"{old_ms / ms:.2f}x); the rule picks {picks}", flush=True)
            out.append({"shape": [n, D], "ms": ms, "old_ms": old_ms,
                        "other": other, "picks": picks})
            del x, e
    return out


def sim_shape_rows(torch, mc) -> dict:
    """Rows 4d and 3 at the simulators' n = 100, each old instance against
    its redesign in turns: ``shard_cmix`` as ``compensated_apply`` runs it
    in [ovsim] (m = K = 100, D = 10, q_self = qs, ring factors), column
    against node-parallel, and the compressed collective (int8 + EF,
    global) at n = 100, D = 10, untiled against narrow; each beside a
    one-element launch of the new instance, its plain twin, one PyTorch
    call (``torch.matmul(M, q)``; the exact average ``x.mean(0)``) and the
    bound.  Then each dispatch rule's timed crossovers
    (:func:`shard_rule_times`, :func:`collective_rule_times`)."""
    from repro_torch.compress import collective as ccol

    gen = torch.Generator(device="cuda").manual_seed(8)
    n, D = 100, 10
    x = torch.randn(n, D, device="cuda", generator=gen)
    q = torch.randn(n, D, device="cuda", generator=gen)
    w, M = mc._device_compensated("gossip", "ring", n, 1, 1,
                                  torch.device("cuda"))
    if not mc.use_nodes_shard_cmix(x, q):
        raise AssertionError("row 4d: the rule does not take the "
                             "node-parallel instance")
    old_ms, ms = _turns(torch, lambda: mc.shard_cmix_column(x, q, q, w, M),
                        lambda: mc.shard_cmix_nodes(x, q, q, w, M))
    one = torch.randn(1, 1, device="cuda", generator=gen)
    ones = torch.ones(1, 1, device="cuda")
    floor_ms = device_ms(torch, lambda: mc.shard_cmix_nodes(
        one, one, one, ones, ones))
    plain_ms = cuda_ms(torch, lambda: mc.shard_comp_mix_block_plain(
        x, q, q, w, M))
    library_ms = device_ms(torch, lambda: torch.matmul(M, q))
    bound_ms, bound_by = _bound(4 * 3 * n * D, (2 * n + 4) * n * D)
    print(f"[kernel] shard_cmix row 4d m=K={n} D={D} ([ovsim]'s stacked "
          f"apply, q_self is qs): node-parallel {ms:.4f} ms, column "
          f"{old_ms:.4f} ms (device_ms, in turns; {old_ms / ms:.1f}x), a "
          f"one-element launch {floor_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.matmul(M, q) {library_ms:.4f} ms, bound {bound_ms:.6f} ms "
          f"by {bound_by}", flush=True)
    apply = {"shape": [n, n, D], "ms": ms, "old_ms": old_ms,
             "floor_ms": floor_ms, "plain_ms": plain_ms,
             "library_ms": library_ms, "bound_ms": bound_ms,
             "bound_by": bound_by}
    e = 0.01 * torch.randn(n, D, device="cuda", generator=gen)
    s1, s2 = ccol.stage_seeds(7)
    kw = dict(kind="int8", with_ef=True, n_pods=1, qblock=ccol.QBLOCK)
    if mc.collective_instance(n, 1, D, ccol.QBLOCK) != "narrow":
        raise AssertionError("row 3: the rule does not take the narrow "
                             "instance")
    c_old, c_ms = _turns(
        torch, lambda: mc.collective_flat(x, e, s1, s2, instance="untiled",
                                          **kw),
        lambda: mc.collective_flat(x, e, s1, s2, instance="narrow", **kw))
    e1 = 0.01 * one
    c_floor = device_ms(torch, lambda: mc.collective_flat(
        one, e1, s1, s2, instance="narrow", **kw))
    c_plain = cuda_ms(torch, lambda: mc.collective_flat_plain(x, e, s1, s2,
                                                              **kw))
    c_lib = device_ms(torch, lambda: x.mean(dim=0, keepdim=True))
    c_bound, c_by = _bound(4 * 4 * n * D, 60 * n * D)
    print(f"[kernel] collective row 3 n={n} D={D} int8+EF ([sim]'s global "
          f"round): narrow {c_ms:.4f} ms, untiled {c_old:.4f} ms (device_ms, "
          f"in turns; {c_old / c_ms:.1f}x), a one-element launch "
          f"{c_floor:.4f} ms, plain {c_plain:.4f} ms, x.mean(0) (the exact "
          f"average only) {c_lib:.4f} ms, bound {c_bound:.6f} ms by {c_by}",
          flush=True)
    narrow = {"shape": [n, D], "ms": c_ms, "old_ms": c_old,
              "floor_ms": c_floor, "plain_ms": c_plain, "library_ms": c_lib,
              "bound_ms": c_bound, "bound_by": c_by}
    del x, q, e
    return {"apply": apply, "narrow": narrow,
            "shard_rule": shard_rule_times(torch, mc),
            "collective_rule": collective_rule_times(torch, mc)}


def check_collective_kernel(torch, mc) -> dict:
    """collective kernel vs its plain twin on the card: int8 and fp8,
    global and pod_avg (2 pods), error feedback on and off, n = 8 at
    D = 1,000,003 (a ragged last block, masked in the kernel and padded in
    the twin) and at the packed main-path width (int8 + EF, global: the
    main path's call).  The pod sum runs in one order in both and the
    scales are powers of two, so the tolerance is 1e-6·max|x| (measured
    error expected 0).  A constant state comes back bitwise for every
    kind and phase.  At the simulator's shapes (n = 16, 32 and 100 at
    D = 10, which the narrow instance takes) o and the new EF must be
    bitwise the twin's, and so must the untiled instance, forced at n = 8,
    against the tiled one and at n = 100 over 98 blocks against the
    twin."""
    from repro_torch.compress import collective as ccol

    gen = torch.Generator(device="cuda").manual_seed(2)
    worst, cases, untiled_cases = 0.0, 0, 0
    n = MAIN_N
    s1, s2 = ccol.stage_seeds(7)

    def compare(x, e, kind, pods, bitwise=False):
        nonlocal worst, cases
        kw = dict(kind=kind, with_ef=e is not None, n_pods=pods,
                  qblock=ccol.QBLOCK)
        o, ef = mc.collective_flat(x, e, s1, s2, **kw)
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
                a = mc.collective_flat(x, ef, s1, s2, instance="tiled",
                                       **kw)
                b = mc.collective_flat(x, ef, s1, s2, instance="untiled",
                                       **kw)
                if not all(u is None and v is None or torch.equal(u, v)
                           for u, v in zip(a, b)):
                    raise AssertionError(f"collective {kind} pods={pods} "
                                         f"ef={ef is not None}: untiled "
                                         f"instance differs from the tiled")
                del a, b
                untiled_cases += 1
    del x, e
    torch.cuda.empty_cache()

    # the simulator's shapes, bitwise (the narrow instance); n = 100 over
    # 98 blocks is past the tile (the untiled one)
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
        x, e, s1, s2, instance="untiled", **kw), iters=5, warmup=1)
    bytes_moved = 4 * 4 * n * D                 # read x, e; write o, ef
    flops = 60 * n * D                          # two codecs, pod mean
    bound_ms, bound_by = _bound(bytes_moved, flops)
    print(f"[kernel] collective int8+EF n={n} D={D}: kernel {ms:.4f} ms "
          f"(the untiled instance {untiled_ms:.4f} ms, "
          f"{bound_ms / untiled_ms:.1%} of the bound), plain "
          f"{plain_ms:.4f} ms, no single PyTorch call computes it, "
          f"bound {bound_ms:.4f} ms by {bound_by} "
          f"({bytes_moved / (ms * 1e-3) / 1e9:.0f} GB/s achieved)",
          flush=True)
    # the untiled instance at [sim]'s int8 + EF global round, n = 100,
    # D = 10 (the path runs the narrow one: [kernel] collective row 3)
    n_sim, d_sim = SIM_COMP_SHAPES[-1]
    xs = torch.randn(n_sim, d_sim, device="cuda", generator=gen)
    es = 0.01 * torch.randn(n_sim, d_sim, device="cuda", generator=gen)
    sim_ms = device_ms(torch, lambda: mc.collective_flat(
        xs, es, s1, s2, instance="untiled", **kw))
    sim_bound, sim_by = _bound(4 * 4 * n_sim * d_sim, 60 * n_sim * d_sim)
    print(f"[kernel] collective int8+EF n={n_sim} D={d_sim} ([sim]'s "
          f"shape, the untiled instance forced): {sim_ms:.4f} ms on the "
          f"card, bound {sim_bound:.6f} ms by {sim_by}", flush=True)
    del xs, es
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
            "untiled_ms": untiled_ms, "untiled_sim_ms": sim_ms,
            "plain_ms": plain_ms,
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
    at the model's scale; ``mlstm.cu``'s edges, with wide gates: dv = 200
    and 33 (not multiples of its 32-column v tile: clusters of 7 and 2),
    dk = 13, L = 128 at the widest dk it takes
    (``mlstm_cuda.max_simt_dk``), S = 1, and strided views whose strides
    are not multiples of 16 bytes (dk 13, dv 33); each in float32 and with
    bf16 q, k, v.

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
    twin by :func:`cuda_ms`; ``mlstm.cu``'s float32 call at B = 8 and at
    B = 1 against its fp32 bound.  Returns the records of ``mlstm.cu`` (the
    float32 path, timed at B = 8) and ``mlstm_wgmma.cu``."""
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
    # mlstm.cu's edges: dv past a multiple of its 32-column v tile (a
    # cluster of 7, of 2), dk not a multiple of 4, L = 128 at the widest
    # dk it takes, S = 1, strides that are not multiples of 16 bytes
    cases += [(1, 130, 2, 16, 200, 64, False, "wide"),
              (2, 70, 3, 8, 33, 32, False, "wide"),
              (2, 100, 2, 13, 24, 64, False, "wide"),
              (1, 256, 1, mk.max_simt_dk(128), 40, 128, False, "wide"),
              (1, 1, 2, 8, 16, 64, False, "wide"),
              (2, 90, 2, 13, 33, 64, True, "wide")]
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
    f32 = {}
    for B in (8, 1):
        args = mlstm_inputs(torch, gen, B, S, nh, dk, dv, torch.float32)
        # the cluster's shared scores against every block scoring the
        # whole chunk itself (max_cluster = 1), in turns
        own_ms, ms32 = _turns(
            torch, lambda: mk.mlstm_simt(*args, chunk=L, max_cluster=1),
            lambda: mk.mlstm_chunk(*args, chunk=L))
        plain32 = cuda_ms(torch, lambda: mk.mlstm_chunk_plain(*args,
                                                              chunk=L),
                          iters=5, warmup=1)
        bound32, by32 = _bound(*mlstm_work(B, S, nh, dk, dv, L, itemsize=4))
        cap = mk.simt_max_cluster(
            B * nh * -(-dv // mk.SIMT_TILE_V),
            torch.cuda.get_device_properties(0).multi_processor_count)
        cs, gy = mk.simt_grid(dv, cap)
        # the widest clusters, where the cap holds them back
        wide = ""
        if cap < mk.SIMT_MAX_CLUSTER:
            wide_ms = device_ms(torch, lambda: mk.mlstm_simt(
                *args, chunk=L, max_cluster=mk.SIMT_MAX_CLUSTER))
            wide = (f", in clusters of {mk.simt_grid(dv)[0]} "
                    f"{wide_ms:.4f} ms")
        f32[B] = (ms32, plain32, bound32, by32)
        print(f"[kernel] mlstm B={B} S={S} nh={nh} dk={dk} dv={dv} L={L} "
              f"float32: mlstm.cu {ms32:.4f} ms on the card "
              f"({bound32 / ms32:.1%} of its bound; grid {B * nh} x {gy} "
              f"blocks in clusters of {cs}), without the clusters "
              f"{own_ms:.4f} ms, in turns{wide}; plain {plain32:.4f} ms, "
              f"bound {bound32:.4f} ms by {by32} (fp32 operations at 67 "
              f"TFLOP/s)", flush=True)
        del args
    ms32, plain32, bound32, by32 = f32[8]
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
# slice 16's 2-D mesh: the main path's 4 node shards x 2 model shards,
# each block m = 2 rows of one model chunk of the packed node
MAIN_2D_KM = 2
MAIN_2D_W = MAIN_PACKED_D // MAIN_2D_KM
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
    del x, xs
    torch.cuda.empty_cache()
    two_d = two_d_block_record(torch, mc, "shard_mix", compare)
    print(f"[kernel] shard_mix: {cases} kernel-vs-plain cases within "
          f"tolerance, max abs err {worst:.3e}", flush=True)
    return {"name": "shard_mix_kernel", "route": "cuda",
            "source": "src/repro_torch/csrc/shard_mix.cu",
            "replaces": "src/repro/kernels/mixing_pallas.py:975",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "push_ms": push_ms}, two_d


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
    del x, qs, q
    torch.cuda.empty_cache()
    stacked = stacked_apply_cases(torch, mc, gen, compare)
    two_d = two_d_block_record(torch, mc, "shard_cmix", compare)
    print(f"[kernel] shard_cmix: {cases} kernel-vs-plain cases within "
          f"tolerance, max abs err {worst:.3e}", flush=True)
    return {"name": "shard_cmix_kernel", "route": "cuda",
            "source": "src/repro_torch/csrc/shard_cmix.cu",
            "replaces": "src/repro/kernels/mixing_pallas.py:924",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "overlap_apply": stacked}, two_d


def two_d_block_record(torch, mc, kind: str, compare) -> dict:
    """B.5 (``kind`` "shard_mix") or B.4 ("shard_cmix") at slice 16's 2-D
    block shape: m = 2 rows of one model chunk, W = 69,215,616 columns
    (pga-lm-100m's packed node at k_model = 2), the real one_peer_exp
    factors of k_node = 4 shards (K = 4 at hop 1, 2 at hop 2), held by
    ``compare`` (the 1-D cases' tolerances) at both hops; timed at hop 1
    (K = 4; B.4 with q_self in rows of its own, as its 1-D record) beside
    the plain twin, ``torch.matmul`` of the factor and the bound by bytes.
    The kernel's record of the 2-D main paths ([m2main]/[m2cmain], the
    rank paths [d2main]/[d2cmain])."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    m, W = SHARD_M, MAIN_2D_W
    x = torch.randn(m, W, device="cuda", generator=gen)
    xs = torch.randn(2 * m, W, device="cuda", generator=gen)
    q = torch.randn(m, W, device="cuda", generator=gen)
    mix = kind == "shard_mix"
    err = 0.0
    for step, K in ((0, 4), (1, 2)):
        M, d, w = _main_shard_factors(torch, step)
        if mix:
            compare(x, xs[:K], d, M, True)
            got = mc.shard_mix_block(x, xs[:K], d, M, with_residual=True)
            ref = mc.shard_mix_block_plain(x, xs[:K], d, M,
                                           with_residual=True)
            e = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        else:
            compare(x, q, xs[:K], w, M)
            e = float((mc.shard_comp_mix_block(x, q, xs[:K], w, M)
                       - mc.shard_comp_mix_block_plain(x, q, xs[:K], w,
                                                       M)).abs().max())
        err = max(err, e)
    M, d, w = _main_shard_factors(torch, 0)
    K = 2 * m
    if mix:
        def fn():
            return mc.shard_mix_block(x, xs, d, M, with_residual=True)

        def plain():
            return mc.shard_mix_block_plain(x, xs, d, M, with_residual=True)
        bytes_moved = 4 * (m + K + m + 1) * W     # read x, xs; write o, cs
        flops = (2 * K + 3) * m * W
    else:
        def fn():
            return mc.shard_comp_mix_block(x, q, xs, w, M)

        def plain():
            return mc.shard_comp_mix_block_plain(x, q, xs, w, M)
        bytes_moved = 4 * (m + m + K + m) * W     # read x, q, qs; write o
        flops = (2 * K + 4) * m * W
    ms = cuda_ms(torch, fn, iters=10, warmup=2)
    plain_ms = cuda_ms(torch, plain, iters=5, warmup=1)
    library_ms = cuda_ms(torch, lambda: torch.matmul(M, xs), iters=10,
                         warmup=2)
    bound_ms, bound_by = _bound(bytes_moved, flops)
    print(f"[kernel] {kind} 2-D block m={m} K={K} W={W} (one model chunk "
          f"of k_model = {MAIN_2D_KM}): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.matmul(M_r, xs) {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms by {bound_by} "
          f"({bytes_moved / (ms * 1e-3) / 1e9:.0f} GB/s achieved), max abs "
          f"err {err:.3e}", flush=True)
    del x, xs, q
    torch.cuda.empty_cache()
    src = "shard_mix.cu" if mix else "shard_cmix.cu"
    line = 975 if mix else 924
    return {"name": f"{kind}_kernel_2d", "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}",
            "replaces": f"src/repro/kernels/mixing_pallas.py:{line}",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "shape": [m, K, W]}


def stacked_apply_cases(torch, mc, gen, compare) -> dict:
    """The overlapped gossip round's stacked apply (slice 9): the whole
    node stack as one shard, m = K = 8, ``q_self`` and ``qs`` the same
    buffer, with the real one_peer_exp factors of hops 1 and 2; at the
    ragged widths (b in fp32 and bf16-cast) and at the packed width of
    pga-lm-100m, held by ``compare`` (the tolerance of
    :func:`check_shard_cmix_kernel`).  Also checks that the wrapper
    refuses an ``out`` over the buffer.  Times the full-width call beside
    its bytes bound (x and b read once, o written once) and
    ``torch.matmul(M, b)``; returns those numbers."""
    n, dev = MAIN_N, torch.device("cuda")
    factors = [mc._device_compensated("gossip", "one_peer_exp", n, step, 1,
                                      dev) for step in (0, 1)]
    for D in SHARD_WIDTHS:
        x = torch.randn(n, D, device="cuda", generator=gen)
        b = torch.randn(n, D, device="cuda", generator=gen)
        for w, M in factors:
            for bb in (b, b.to(torch.bfloat16).to(torch.float32)):
                compare(x, bb, bb, w, M)
    D = MAIN_PACKED_D
    x = torch.randn(n, D, device="cuda", generator=gen)
    b = torch.randn(n, D, device="cuda", generator=gen)
    for w, M in factors:
        compare(x, b, b, w, M)
    try:
        mc.shard_comp_mix_block(x, b, b, w, M, out=b)
    except ValueError:
        pass
    else:
        raise AssertionError("shard_cmix: an out over the buffer was taken")
    torch.cuda.empty_cache()
    ms = cuda_ms(torch, lambda: mc.shard_comp_mix_block(x, b, b, w, M),
                 iters=10, warmup=2)
    plain_ms = cuda_ms(torch, lambda: mc.shard_comp_mix_block_plain(
        x, b, b, w, M), iters=3, warmup=1)
    library_ms = cuda_ms(torch, lambda: torch.matmul(M, b), iters=10,
                         warmup=2)
    bytes_moved = 4 * 3 * n * D                # read x, b; write o
    bound_ms, bound_by = _bound(bytes_moved, (2 * n + 4) * n * D)
    print(f"[kernel] shard_cmix stacked overlap apply m=K={n} D={D}, "
          f"q_self is qs: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.matmul(M, b) (the mix only) {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms by {bound_by} "
          f"({bytes_moved / (ms * 1e-3) / 1e9:.0f} GB/s achieved); an out "
          f"over the buffer refused", flush=True)
    del x, b
    torch.cuda.empty_cache()
    return {"m": n, "K": n, "D": D, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
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
    two shapes, the two bf16 cases of the fp32 kernel, two float32 cases
    it cannot copy by ``cp.async`` (D = 18, views at 108-byte head
    strides), and the three full-width calls in float32 and bf16.
    Tolerance (:data:`FLASH_TOL`): 2e-5 atol and rtol in float32, the
    reference suite's; one output ulp plus 1e-5 for the fp32 kernel in
    bf16; for the tensor-core kernel
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
    # float32 operands cp.async cannot copy into flash_attention.cu's tiles
    # (D % 4 != 0; views whose strides are not 16-byte multiples): widened
    # through registers instead
    compare(((1, 70, 90, 4, 2, 18), False, 33, None), torch.float32,
            where="fp32 D = 18")
    wide = torch.randn(2, 100, 6, 27, device="cuda", generator=gen)
    compare(((2, 100, 100, 4, 1, 24), True, 16, 30.0), torch.float32,
            where="fp32 misaligned views",
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
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            library_ms, ms = _turns(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True),
                lambda: fa.flash_attention(q, k, v, **kw))
            plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, **kw), iters=5, warmup=1)
            bytes_moved, flops, _ = flash_work(*dims, causal, window,
                                               itemsize=4)
            bound_ms, bound_by = _bound(bytes_moved, flops)
            timings["fp32"] = (ms, plain_ms, bound_ms, bound_by, library_ms)
            print(f"[kernel] flash {name} {dims} float32 (flash_attention.cu)"
                  f": kernel {ms:.4f} ms on the card, "
                  f"scaled_dot_product_attention(is_causal=True) "
                  f"{library_ms:.4f} ms (device_ms, in turns; kernel / SDPA "
                  f"{ms / library_ms:.2f}), plain {plain_ms:.4f} ms; bound "
                  f"{bound_ms:.4f} ms by {bound_by} (fp32 operations at 67 "
                  f"TFLOP/s, {bytes_moved / 1e6:.1f} MB): "
                  f"{100 * bound_ms / ms:.1f}% of the bound, "
                  f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s", flush=True)
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
            "mix_nodes": mc.mix_flat.nodes_launches,
            "cmix": mc.cmix_flat.launches,
            "cmix_vector": mc.cmix_flat.vector_launches,
            "cmix_nodes": mc.cmix_flat.nodes_launches,
            "cmix_absmax": mc.cmix_flat.absmax_launches,
            "collective": mc.collective_flat.launches,
            "collective_narrow": mc.collective_flat.narrow_launches,
            "mlstm": mk.mlstm_chunk.launches,
            "mlstm_wgmma": mk.mlstm_chunk.wgmma_launches,
            "shard_mix": mc.shard_mix_block.launches,
            "shard_cmix": mc.shard_comp_mix_block.launches,
            "shard_cmix_nodes": mc.shard_comp_mix_block.nodes_launches,
            "flash": fa.flash_attention.launches,
            "flash_wgmma": fa.flash_attention.wgmma_launches,
            "rmsnorm": rn.rmsnorm.launches,
            "rmsnorm_vector": rn.rmsnorm.vector_launches}


def only(**launches) -> dict:
    """The launch counts of a path that launches only the named kernels."""
    return {**{k: 0 for k in counts()}, **launches}


def mix_key(mc, n: int, D: int) -> str:
    """The launch count a mix.cu round on a fresh contiguous (n, D)
    operand adds to, by the dispatch rule (register, node-parallel or
    generic instance)."""
    if mc._mix_rows(n, D, []):
        return "mix_vector"
    return "mix_nodes" if mc._nodes_rows(n, D, []) else "mix"


def cmix_key(mc, n: int, D: int) -> str:
    """The same for a cmix.cu round (16-byte aligned fresh rows)."""
    if mc._cmix_rows(n, D, []):
        return "cmix_vector"
    return "cmix_nodes" if mc._nodes_rows(n, D, []) else "cmix"


def shard_cmix_key(mc, m: int, K: int, D: int) -> str:
    """The launch count a shard_cmix.cu call on an (m, D) shard over K
    halo rows adds to, by the dispatch rule (node-parallel or column
    instance)."""
    return ("shard_cmix_nodes" if mc._shard_nodes_rows(m, K, D)
            else "shard_cmix")


def collective_key(mc, n: int, D: int) -> str:
    """The same for a global collective.cu round on an (n, D) operand
    (narrow, or the tiled or untiled instance) at the 1024-column scale
    block."""
    narrow = mc.use_narrow_collective(n, 1, D, 1024)
    return "collective_narrow" if narrow else "collective"


def gate_no_generic(tag: str, launches: dict) -> None:
    """A simulator path at n = 100 launches no generic mix or cmix: the
    rule sends every round there to the node-parallel instances."""
    if launches["mix"] or launches["cmix"]:
        raise AssertionError(f"{tag}: generic launches {launches}")


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


def step_sites(tag: str, k: int) -> dict:
    """Where :func:`sync_steps` records step k's synchronizing calls by
    source line: step 0 (a fresh trainer's first step) apart, every later
    step in the one dict of ``tag``."""
    return SYNC_SITES.setdefault(f"{tag} step 0" if k == 0 else tag, {})


def gate_one_sync(tag: str, syncs: list) -> None:
    """One synchronizing call a step (the log boundary's read of the
    metrics) on the steady steps 1-5 of a trainer path, or the run fails
    naming the source lines of the last step's; step 0's are printed."""
    print(f"{tag} synchronizing calls per step {syncs}; step 0's by source "
          f"line {SYNC_SITES.get(tag + ' step 0')}", flush=True)
    if any(c != 1 for c in syncs[1:]):
        raise AssertionError(f"{tag} synchronizing calls per step {syncs}, "
                             f"not one; the last step's by source line "
                             f"{SYNC_SITES.get(tag)}")


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
    mc.mix_flat.nodes_launches = 0
    mc.cmix_flat.launches = 0
    mc.cmix_flat.vector_launches = 0
    mc.cmix_flat.nodes_launches = 0
    mc.cmix_flat.absmax_launches = 0
    mc.collective_flat.launches = 0
    mc.collective_flat.narrow_launches = 0
    mk.mlstm_chunk.launches = 0
    mk.mlstm_chunk.wgmma_launches = 0
    mc.shard_mix_block.launches = 0
    mc.shard_comp_mix_block.launches = 0
    mc.shard_comp_mix_block.nodes_launches = 0


def run_main_path(torch, mc, compressed: bool = False,
                  sharded: bool = False, model_shards: int = 1,
                  trace: bool = False, snapshot_at: int = -1):
    """One main path at full width for 6 steps; returns ``(launches per
    kernel, trainer, state)``.  Slice 1: fused rounds with the consensus
    residual.  Slice 2 (``compressed``): int8 gossip + int8 collective
    with error feedback.  Slice 4 (``sharded``): either of them on a mesh
    of 4 node shards on the card, ``comm_shard_mode="sharded"``: one
    per-shard kernel launch per shard per gossip round, the global rounds
    in plain PyTorch (the sum over the shards; the compressed collective's
    owner segments).  Slice 16 (``model_shards`` > 1, ``[m2main]`` /
    ``[m2cmain]``): the same on a 2-D ``(data=4, model)`` mesh, one launch
    per block per gossip round.  ``trace``: each step's final params
    fingerprinted per node shard into ``TRACE[tag]``.  ``snapshot_at``:
    after that step, the state a rank path that stops there is held to
    (:func:`twin_snapshot`) into ``SNAPSHOT[tag]``."""
    from repro_torch.configs import (DistConfig, OptimizerConfig,
                                     TrainConfig, get_model_config)
    from repro_torch.core.mesh import make_mesh
    from repro_torch.train import Trainer
    from repro_torch.tree import tree_leaves

    steps, n_nodes = 6, 8
    tag = (("[m2" if model_shards > 1 else "[s") if sharded else "[") + (
        "cmain]" if compressed else "main]")
    shards = n_nodes // SHARD_M
    mesh = None
    if sharded:
        mesh = (make_mesh((shards, model_shards), ("data", "model"))
                if model_shards > 1 else make_mesh((shards,), ("data",)))
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
        width = mc.ModelChunks(state.params, model_shards).W
        print(f"{tag} pga-lm-100m on a mesh of {shards} node shards of "
              f"{SHARD_M} nodes x {model_shards} model shards on one card "
              f"({mesh.shape}, "
              f"{'compressed int8+EF' if compressed else 'uncompressed'}): "
              f"{per_node:,} params per node, {n_nodes} nodes, one "
              f"{'shard_cmix' if compressed else 'shard_mix'} launch per "
              f"block per gossip round over {width:,} packed columns",
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
    norms, calls = [], [0]
    if trace:
        # the joint gradient norm² the step folds per node shard (the rank
        # mesh's arithmetic) beside one sum over all rows per leaf (the
        # one-process step's arithmetic before the fold), on the clip's
        # grads: one more pass over them a step, inside the step's time
        from repro_torch.optim import optimizers as opt_mod
        from repro_torch.train import step as step_mod
        real_norm = opt_mod.joint_sq_norm

        def traced_norm(tree, mesh=None, node_axis="data"):
            folded = real_norm(tree, mesh, node_axis)
            calls[0] += 1
            if calls[0] % 2 == 0:   # a step's calls: grad_norm, the clip
                norms.append((folded, real_norm(tree)))
            return folded
        opt_mod.joint_sq_norm = step_mod.joint_sq_norm = traced_norm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, phases, syncs = [], [], []
    TRACE[tag] = []
    for k in range(steps):
        t0 = time.perf_counter()
        state, n_sync = sync_steps(
            torch, lambda: tr.run(state, steps=1, log_every=1),
            step_sites(tag, k))
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
        if trace:
            TRACE[tag].append(shard_fingerprints(torch, state.params,
                                                 shards))
        if k == snapshot_at:
            SNAPSHOT[tag] = twin_snapshot(torch, state, shards)
    launches = counts()
    if trace:
        opt_mod.joint_sq_norm = step_mod.joint_sq_norm = real_norm
        pairs = [(float(a), float(b)) for a, b in norms]
        TRACE[tag + " norms"] = pairs
        print(f"{tag} the joint gradient norm² per step, folded per node "
              f"shard as the step takes it (the ranks' arithmetic) vs one "
              f"sum over all {n_nodes} rows: bits equal "
              f"{[a == b for a, b in pairs]}; {pairs}", flush=True)
    gossip, glob = phases.count("gossip"), phases.count("global")
    if sharded:
        key = "shard_cmix" if compressed else "shard_mix"
        expected = only(**{key: gossip * shards * model_shards})
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
    STEADY[tag] = steady
    HISTORY[tag] = [dict(h) for h in tr.history[:steps]]
    if tag in ("[main]", "[m2main]", "[m2cmain]"):
        gate_one_sync(tag, syncs)
    print(f"{tag} {steps} steps through the kernels ({launches}); steady "
          f"step {steady * 1e3:.1f} ms (median of steps 1-5), "
          f"{tokens / steady:.0f} tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; synchronizing "
          f"calls per step {syncs}, step {steps - 1}'s by source line "
          f"{SYNC_SITES[tag]}", flush=True)
    return launches, tr, state


KERNEL_KINDS = (("shard kernels", ("shard_mix_kernel", "shard_cmix_kernel")),
                ("cmix round", ("cmix_kernel", "cmix_vector_kernel",
                                "cmix_nodes_kernel", "absmax")),
                ("mix round", ("mix_kernel", "mix_vector_kernel",
                               "mix_nodes", "sum_partials")),
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
        SROUND[("int8+EF " if compressed else "")
               + ("gossip hop 1" if phase == "gossip" else "global")] = (
            f"{t[1]:.1f} / {t[2]:.1f} ms")
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
                steps: int = 3, tag=None) -> None:
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
    ``tag`` labels the runs of another path (``[ovcross]``: ``dist_kw``
    with ``comm_overlap``).

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
    if tag is not None:
        what = f"{dist_kw} {what}"
    elif algorithm != "gossip_pga":
        tag, what = "[xalgos]", f"{algorithm} {dist_kw} trainer"
    else:
        tag = "[scross]" if sharded else "[cross]"
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


class GenericShadow:
    """While active, every launch of mix.cu's register instance at an
    (n, V) new in PR 33 (n = 2, or V = 1) also runs the generic instance
    on the same operands, :data:`SHADOW_COLUMNS` columns at a time (the
    round is column by column; a copy of x's columns where the launch
    consumes x in place), and the outputs' bits (o, and x̄ with the
    residual) are compared on the card: the path's rounds, and so its
    losses and params, are then bit for bit what the generic instance
    gives.  The comparison's launches are not counted, and nothing is read
    on the host until :meth:`check` (the paths' one synchronizing call a
    step stands)."""

    def __init__(self, torch, mc):
        self.torch, self.mc, self.launches = torch, mc, 0
        self.bad = torch.zeros((), dtype=torch.bool, device="cuda")

    def __enter__(self):
        mc, torch = self.mc, self.torch
        self.vector = launch = mc.mix_vector

        def same_bits(a, b):
            self.bad |= (a.view(torch.int32) != b.view(torch.int32)).any()

        def shadowed(xf, gf, gamma, d, M, *, with_g, with_residual, wire,
                     inplace=False):
            kw = dict(with_g=with_g, with_residual=with_residual, wire=wire)
            new = (xf.shape[0] == 2
                   or mc.mix_vector_width(xf, gf if with_g else None) == 1)
            x0 = xf.clone() if new and inplace else xf
            out = launch(xf, gf, gamma, d, M, inplace=inplace, **kw)
            if not new:
                return out
            counted = mc.mix_flat.launches
            o = out[0] if with_residual else out
            for c0 in range(0, xf.shape[1], SHADOW_COLUMNS):
                cols = slice(c0, c0 + SHADOW_COLUMNS)
                ref = mc.mix_generic(
                    x0[:, cols].contiguous(),
                    gf[:, cols].contiguous() if with_g else None, gamma, d,
                    M, **kw)
                same_bits(o[:, cols], ref[0] if with_residual else ref)
                if with_residual:
                    same_bits(out[1][:, cols], ref[1])
                del ref
            mc.mix_flat.launches = counted
            self.launches += 1
            return out

        mc.mix_vector = shadowed
        return self

    def __exit__(self, *exc):
        self.mc.mix_vector = self.vector

    def check(self, tag: str) -> str:
        """Raises if any shadowed launch differed; else a line's text."""
        if bool(self.bad):
            raise AssertionError(f"{tag}: a register-instance launch differs "
                                 f"from the generic instance's")
        return (f"{self.launches} launches at n = 2 or V = 1, each bitwise "
                f"the generic instance's on the same operands")


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
    tracker, packs into one (n, 2d) staging buffer), on the instance the
    rule takes for the (n, width) operand (:func:`mix_key`: at n = 100
    the node-parallel one); compressed (one leaf), a gossip round is one
    row maxima and one cmix.cu launch, a global round one collective.cu
    launch on the instance the rule takes (:func:`collective_key`: the
    narrow one at d = 10)."""
    kinds = mc.KERNEL_PHASES
    rounds = [ph for ph in phases if ph in kinds]
    if compressed:
        gossip = rounds.count("gossip")
        return only(**{cmix_key(mc, n, d): gossip, "cmix_absmax": gossip,
                       collective_key(mc, n, d): len(rounds) - gossip})
    width = 2 * d if algorithm == "gt_pga" else d
    return only(**{mix_key(mc, n, width): len(rounds)})


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
    if prob.n not in mc.MIX_VECTOR_NODES:
        gate_no_generic(f"{tag} {algorithm}", launches)
    if compressed and launches["collective"]:
        raise AssertionError(f"{tag} {algorithm}: {launches['collective']} "
                             f"launches of the tiled or untiled collective, "
                             f"where the rule gives the narrow one")
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


SIM_SPLIT_STEPS = 100


def sim_split(torch, prob, run_kw) -> None:
    """``[simsplit]``: where a [sim] step's wall time goes: gossip's first
    :data:`SIM_SPLIT_STEPS` steps under ``torch.profiler``, the device's
    busy share of the wall time and its time by kernel (the profiler's
    own host cost inflates the wall time; the device times stand)."""
    from torch.profiler import ProfilerActivity, profile

    kw = dict(run_kw, steps=SIM_SPLIT_STEPS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _sim_run(torch, prob, "gossip", **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    profile_report(prof, wall_ms, "[simsplit]",
                   f"gossip, {SIM_SPLIT_STEPS} steps at n = {prob.n}")


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
        np.trapezoid(sub_ref)), aucs=dict(aucs))
    sim_split(torch, prob, run_kw)
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
    keys = {mix_key(mc, n_nodes, sum(leaves[i][0].numel() for i in g))
            for g in groups}
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
    if len(keys) != 1:
        raise AssertionError(f"[algos] {algorithm}: groups on instances "
                             f"{keys}")
    expected = only(**{keys.pop(): len(groups) * rounds})
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
        key = mix_key(mc, n, D)
        per_round[key] = per_round.get(key, 0) + 1
        widths.setdefault(key, []).append(D)
    mix_rounds = rounds - gossip if compressed else rounds
    want = {k: v * mix_rounds for k, v in per_round.items()}
    if compressed:
        for lf in tree_leaves(state.params):
            key = cmix_key(mc, n, lf[0].numel())
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
    no generic mix (the 19,201-wide staging group on the register instance
    at V = 1, each such launch bitwise the generic instance's:
    :class:`GenericShadow`), no plain-twin call; ``[psmain]`` no more
    synchronizing calls per step than ``[main]``.  Returns ``(launches,
    trainer, state, host copy of the de-biased params)``."""
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
    with PlainCalls(mc) as plain, GenericShadow(torch, mc) as shadow:
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
    if launches != expected or launches["mix"]:
        raise AssertionError(f"{tag} launches {launches}, the dispatch rule "
                             f"gives {expected}, no generic mix")
    if plain.calls:
        raise AssertionError(f"{tag}: {plain.calls} plain-twin calls on the "
                             f"card")
    if not sharded:
        print(f"{tag} {shadow.check(tag)}", flush=True)
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
        want = only(**{mix_key(mc, n, d + 1): steps})
        if launches != want:
            raise AssertionError(f"{tag}: launches {launches}, the dispatch "
                                 f"rule gives {want}")
        if n not in mc.MIX_VECTOR_NODES:
            gate_no_generic(tag, launches)
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


# ---------------------------------------------------------------------------
# Slice 9: overlapped gossip ([ovmain], [ovcmain], [sovmain], [ovround],
# [ovcross], [ovsim])
# ---------------------------------------------------------------------------
OVERLAP_CROSS = {"H": 2, "comm_overlap": True}
# [ovsim] card vs CPU: [sim]'s problem at n = 100 with full gradients
OVSIM_CROSS = dict(steps=300, eval_every=10)


class AverageGate:
    """While active, wraps ``core.mixing.finish_round`` (the step looks it
    up in the module at each call): per call, on the card and without a
    host read, the largest ``|node mean of the output − node mean of the
    input iterate|`` over the leaves and the largest ``|x|`` or ``|b|``,
    kept as 0-d tensors; :meth:`read` brings them back after the step.
    The compensated apply keeps the node average exactly in exact
    arithmetic; in fp32 each output element carries a few roundings of
    terms up to ``2·s``."""

    def __init__(self):
        from repro_torch.core import mixing
        self.mixing, self.pending = mixing, []

    def __enter__(self):
        import torch

        from repro_torch.tree import tree_leaves
        self.saved = finish = self.mixing.finish_round

        def largest(ts):
            return torch.stack([t.float() for t in ts]).max()

        def wrapped(params, round_state, spec, *, step=0):
            out = finish(params, round_state, spec, step=step)
            xs = tree_leaves(params)
            errs = [(o.float().mean(0) - x.float().mean(0)).abs().max()
                    for x, o in zip(xs, tree_leaves(out))]
            scales = [x.abs().max() for x in xs] + [
                q.abs().max() for q in tree_leaves(round_state.get("q", []))]
            self.pending.append((largest(errs), largest(scales)))
            return out

        self.mixing.finish_round = wrapped
        return self

    def __exit__(self, *exc):
        self.mixing.finish_round = self.saved

    def read(self) -> list:
        out = [(float(e), float(s)) for e, s in self.pending]
        self.pending.clear()
        return out


def overlap_expected_launches(mc, tr, state, phases, compressed: bool,
                              sharded: bool) -> tuple:
    """The dispatch rule's launches for an overlapped path's steps, stated
    before they run, and the dispatch groups' widths.  Stacked: a gossip
    step's apply is one shard_cmix.cu launch per dispatch group of the
    params (the whole node stack as one shard, m = K = 8), on the
    instance :func:`shard_cmix_key` gives its width; a global flush
    is the synchronous round: one mix.cu launch per group on the instance
    ``use_vector_mix`` takes (every operand a fresh contiguous tensor, so
    the rule reads n and the width only) or, compressed, one
    collective.cu launch; the captures (``start_round``) launch nothing.
    Sharded: one shard_cmix launch per shard per gossip step, the global
    flush in plain PyTorch (the sum over the shards)."""
    from repro_torch.tree import tree_leaves
    n = tr.n_nodes
    gossip = phases.count("gossip")
    flushes = sum(ph in ("global", "pod_avg") for ph in phases)
    if sharded:
        return only(shard_cmix=gossip * (n // SHARD_M)), {}
    leaves = tree_leaves(state.params)
    groups = mc._dispatch_groups(leaves, tr.tcfg.dist.pallas_leaf_threshold)
    widths = [sum(leaves[i][0].numel() for i in g) for g in groups]
    want = {}
    for D in widths:
        key = shard_cmix_key(mc, n, n, D)
        want[key] = want.get(key, 0) + gossip
        if not compressed:
            key = mix_key(mc, n, D)
            want[key] = want.get(key, 0) + flushes
    if compressed:
        key = collective_key(mc, n, sum(widths))
        want[key] = want.get(key, 0) + flushes
    return only(**want), widths


def run_overlap_path(torch, mc, compressed: bool = False,
                     sharded: bool = False):
    """Slice 9's main paths at full width: pga-lm-100m, 8 nodes,
    Gossip-PGA H = 3 over one_peer_exp, AdamW, global batch 32 × seq 512,
    6 steps, ``comm_backend="pallas"``, ``comm_overlap=True``: each gossip
    step applies the buffer primed one step earlier (shard_cmix.cu) and
    primes the next; the global steps flush.  ``[ovmain]`` uncompressed,
    ``[ovcmain]`` int8 gossip + int8 collective + EF, ``[sovmain]`` on a
    mesh of 4 node shards (A.10.4, dense).  Gates: the phases the schedule
    gives; the launch counts of :func:`overlap_expected_launches` (reset
    just before, read just after); no plain-twin call; consensus 0.0
    after every uncompressed global flush (> 0 compressed); the node
    average after every gossip step's apply within 1e-5·s of the
    half-step's (:class:`AverageGate`); one synchronizing call on each of
    steps 1-5 (:func:`gate_one_sync`).  Returns ``(launches, trainer,
    state)``."""
    from repro_torch.configs import (DistConfig, OptimizerConfig,
                                     TrainConfig, get_model_config)
    from repro_torch.core.mesh import make_mesh
    from repro_torch.train import Trainer
    from repro_torch.tree import tree_leaves

    steps, n = 6, MAIN_N
    tag = ("[sovmain]" if sharded else "[ovcmain]" if compressed
           else "[ovmain]")
    t_phase = time.perf_counter()
    shards = n // SHARD_M
    mesh = make_mesh((shards,), ("data",)) if sharded else None
    tcfg = TrainConfig(
        model=get_model_config("pga-lm-100m"),
        dist=DistConfig(algorithm="gossip_pga", topology="one_peer_exp",
                        H=3, comm_backend="pallas", comm_overlap=True,
                        comm_shard_mode="sharded" if sharded else "auto",
                        **(COMPRESSED if compressed else {})),
        optimizer=OptimizerConfig(name="adamw", lr=3e-4,
                                  schedule="warmup_cosine", warmup_steps=2,
                                  total_steps=steps + 2),
        global_batch=32, seq_len=512, steps=steps, log_every=1)
    tr = Trainer(tcfg, n_nodes=n, mesh=mesh, with_consensus=True)
    state = tr.init_state(torch.Generator().manual_seed(0))
    phases_want = [tr.schedule.peek_phase(k) for k in range(steps)]
    expected, widths = overlap_expected_launches(mc, tr, state, phases_want,
                                                 compressed, sharded)
    per_node = sum(p[0].numel() for p in tree_leaves(state.params))
    where = (f"a mesh of {shards} node shards of {SHARD_M}" if sharded
             else f"stacked, dispatch group widths {widths}")
    print(f"{tag} pga-lm-100m overlapped ({where}"
          f"{', int8+EF gossip, int8 collective' if compressed else ''}): "
          f"{per_node:,} params per node, {n} nodes, one_peer_exp, phases "
          f"{phases_want}; expected launches "
          f"{ {k: v for k, v in expected.items() if v} }", flush=True)
    tokens = tcfg.global_batch * tcfg.seq_len
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, syncs, averages = [], [], []
    with PlainCalls(mc) as plain, AverageGate() as gate:
        for k in range(steps):
            t0 = time.perf_counter()
            state, n_sync = sync_steps(
                torch, lambda: tr.run(state, steps=1, log_every=1),
                step_sites(tag, k))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            times.append(dt)
            syncs.append(n_sync)
            rec = tr.history[-1]
            checked = gate.read()
            print(f"{tag} step {k} phase={rec['phase']} loss="
                  f"{rec['loss']:.4f} consensus={rec['consensus']:.6e} "
                  f"step_ms={dt * 1e3:.1f} tokens/s={tokens / dt:.0f} "
                  f"max_mem_GB="
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} "
                  f"synchronizing_calls={n_sync} node-average "
                  f"(|Δ mean|, s) {checked}", flush=True)
            if not math.isfinite(rec["loss"]):
                raise AssertionError(f"{tag} step {k}: loss {rec['loss']}")
            if rec["phase"] == "gossip":
                if len(checked) != 1 or checked[0][0] > 1e-5 * checked[0][1]:
                    raise AssertionError(f"{tag} step {k}: the apply moved "
                                         f"the node average: {checked}")
                averages.append(checked[0][0] / checked[0][1])
            elif checked:
                raise AssertionError(f"{tag} step {k}: a {rec['phase']} "
                                     f"step finished a round")
            if rec["phase"] == "global" and not compressed:
                assert rec["consensus"] == 0.0, rec
            else:
                assert rec["consensus"] > 0.0, rec
    launches = counts()
    phases = [r["phase"] for r in tr.history[-steps:]]
    if phases != phases_want:
        raise AssertionError(f"{tag} phases {phases}, the schedule gives "
                             f"{phases_want}")
    if launches != expected:
        raise AssertionError(f"{tag} launches {launches}, the dispatch rule "
                             f"gives {expected}")
    if plain.calls:
        raise AssertionError(f"{tag}: {plain.calls} plain-twin calls on the "
                             f"card")
    SYNCS[tag] = syncs
    gate_one_sync(tag, syncs)
    if compressed:
        ef_abs = sum(float(e.abs().sum()) for e in tree_leaves(state.ef_state))
        assert ef_abs > 0.0 and math.isfinite(ef_abs), ef_abs
    buf_gb = sum(q.numel() * q.element_size()
                 for q in tree_leaves(tr._comm_buf)) / 1e9
    steady = statistics.median(times[1:])
    print(f"{tag} {steps} steps: launches "
          f"{ {k: v for k, v in launches.items() if v} } as the dispatch "
          f"rule gives, no plain twin; node average kept to "
          f"{max(averages):.3e}·s over the gossip steps; steady step "
          f"{steady * 1e3:.1f} ms (median of steps 1-5), "
          f"{tokens / steady:.0f} tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (the buffer "
          f"{buf_gb:.2f} GB); synchronizing calls per step {syncs}, step "
          f"{steps - 1}'s by source line {SYNC_SITES[tag]}; phase wall "
          f"time {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, tr, state


def overlap_round_times(torch, mc, tr, state) -> None:
    """[ovround]: one overlapped gossip round, ``finish_round`` of the
    trainer's buffer and ``start_round`` from the same params (what a
    gossip step of ``[ovmain]`` runs), against the synchronous fused round
    with the consensus residual of ``[round]``, on the same params, by
    CUDA events over 10 rounds in turns (sync, overlap, overlap, sync).
    Bounds at the HBM rate: the apply reads x and b and writes o, the
    capture reads x and writes b; the fused round reads x and writes o
    (and x̄).  Then the overlapped step's unfused consensus timed alone
    (``[ovsplit]``) and one more steady gossip step under
    ``torch.profiler`` (``[ovprofile]``, as ``[profile]`` for ``[main]``;
    it advances the trainer, whose state is not used after)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import mixing
    from repro_torch.train.state import consensus_distance
    from repro_torch.tree import tree_leaves

    dist = tr.tcfg.dist
    spec = dist.comm_spec(tr.n_nodes)
    buf = tr._comm_buf

    def sync_round():
        mc.mix_residual(state.params, phase="gossip",
                        topology=dist.topology, n_nodes=tr.n_nodes, step=1,
                        leaf_threshold=dist.pallas_leaf_threshold)

    def overlap_round():
        mixing.finish_round(state.params, buf, spec, step=1)
        mixing.start_round(state.params, spec)

    t = [cuda_ms(torch, f, iters=10, warmup=2)
         for f in (sync_round, overlap_round, overlap_round, sync_round)]
    leaves = tree_leaves(state.params)
    xb = sum(4 * p.numel() for p in leaves)
    ov_bound = 5 * xb / HBM_BYTES_PER_S * 1e3
    sync_bound = sum(4 * (2 * p.numel() + p[0].numel())
                     for p in leaves) / HBM_BYTES_PER_S * 1e3
    print(f"[ovround] overlapped gossip round (finish_round: "
          f"{len(mc._dispatch_groups(leaves, dist.pallas_leaf_threshold))} "
          f"shard_cmix launches; start_round: the buffer copy) "
          f"{t[1]:.3f} / {t[2]:.3f} ms, bound {ov_bound:.3f} ms; the "
          f"synchronous fused round with residual {t[0]:.3f} / {t[3]:.3f} "
          f"ms, bound {sync_bound:.3f} ms (in turns, same params)",
          flush=True)
    # the overlapped step's consensus is not fused into its round
    cons_ms = cuda_ms(torch, lambda: consensus_distance(state.params),
                      iters=5, warmup=1)
    print(f"[ovsplit] consensus_distance of the params alone {cons_ms:.3f} "
          f"ms (CUDA events; [main] takes it from the fused round's "
          f"residual)", flush=True)
    torch.cuda.empty_cache()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.run(state, steps=1, log_every=1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    profile_report(prof, wall_ms, "[ovprofile]",
                   "profiled overlapped gossip step")
    torch.cuda.empty_cache()


def sovround(torch, mc, tr, state) -> None:
    """[sovround]: one overlapped gossip finish on [sovmain]'s mesh of 4
    node shards, its trainer's buffer applied to its params with the
    buffer's shift: serial (``finish_round`` gathers the halos) and
    issued (``issue_round`` gathers them on the side stream first, as a
    gossip step does before its forward; ``finish_round`` waits for the
    event).  The run fails unless the two outputs are bitwise equal.
    Times by CUDA events over 10 rounds in turns (serial, issued, issued,
    serial): the issued one's includes the issue, nothing hides it here;
    then the issue alone on the host clock (what it holds the step's
    thread) and the halo bytes it holds."""
    from repro_torch.core import mixing
    from repro_torch.tree import tree_leaves

    spec = tr.tcfg.dist.comm_spec(tr.n_nodes, mesh=tr.mesh)
    buf, shift = tr._comm_buf, tr._buf_shift

    def serial():
        return mixing.finish_round(state.params, buf, spec, step=shift)

    def issued():
        return mixing.finish_round(
            state.params, mixing.issue_round(buf, spec, step=shift), spec,
            step=shift)

    reset_counts()
    a, b = serial(), issued()
    launched = {k: v for k, v in counts().items() if v}
    equal = all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                   tree_leaves(b)))
    del a, b
    t = [cuda_ms(torch, f, iters=10, warmup=2)
         for f in (serial, issued, issued, serial)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rs = mixing.issue_round(buf, spec, step=shift)
    host_ms = (time.perf_counter() - t0) * 1e3
    held = sum(p.get().numel() * 4 for p in rs["halo"]["pending"]) / 1e9
    mixing.drain_round(rs)
    del rs
    print(f"[sovround] overlapped gossip finish on {dict(tr.mesh.shape)} "
          f"(shift {shift}, launches {launched} for the two): issued "
          f"bitwise the serial finish {equal}; serial {t[0]:.3f} / "
          f"{t[3]:.3f} ms, issued {t[1]:.3f} / {t[2]:.3f} ms (CUDA events, "
          f"in turns); the issue alone {host_ms:.3f} ms on the host; its "
          f"halo stacks {held:.2f} GB (views of the packed buffer "
          f"included)", flush=True)
    if not equal:
        raise AssertionError("[sovround] the issued finish is not bitwise "
                             "the serial one")
    torch.cuda.empty_cache()


def run_overlap_sim_path(torch, mc) -> dict:
    """[ovsim]: ``simulate(overlap=True, backend="pallas")`` on [sim]'s
    §5.1 problem at n = 100 (ring, H = 16, lr 0.2 halved every 1000 steps,
    batch 8, 3000 steps) for gossip_pga and gossip: launches (one
    shard_cmix launch per gossip step at m = K = 100 on the node-parallel
    instance and none on the column one, one node-parallel mix launch per
    global flush), no plain twin, consensus after every global
    flush an eval falls on at most 1e-12 (n = 100 is not a power of two),
    finite losses for gossip_pga, and the suboptimality AUC against
    parallel SGD beside [sim]'s synchronous runs' (printed, not gated: one
    seed).  Overlapped gossip without a flush is not held finite: with
    batch-8 gradients over the ring (eigenvalues of W down to −1/3) the
    one-step-stale recursion diverges, in the reference as in the port.  Then card vs CPU
    at n = 100 with full gradients over 300 steps: loss rtol 1e-5,
    consensus rtol 1e-4 + atol 1e-12 ([simx]'s 2e-6 and 5e-6 are for 40
    steps at n = 16; here the apply sums 100 terms a column, in another
    order on the card, over 300 steps).  Returns the launch counts."""
    import numpy as np

    from repro_torch.data import make_logistic_problem
    total = {k: 0 for k in counts()}
    t_phase = time.perf_counter()
    prob = make_logistic_problem(SIM["n"], SIM["M"], SIM["d"], iid=False,
                                 seed=0)
    fs, ref = SIM_REFERENCE["f_star"], SIM_REFERENCE["parallel_auc"]
    run_kw = dict(steps=SIM["steps"], lr=sim_lr, H=SIM["H"],
                  eval_every=SIM["eval_every"], batch=SIM["batch"])
    flush_key = mix_key(mc, prob.n, prob.d)
    apply_key = shard_cmix_key(mc, prob.n, prob.n, prob.d)
    for alg in ("gossip_pga", "gossip"):
        torch.cuda.synchronize()
        reset_counts()
        with PlainCalls(mc) as plain:
            t0 = time.perf_counter()
            out = _sim_run(torch, prob, alg, overlap=True, **run_kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / SIM["steps"]
        launches = counts()
        phases = replay_phases(alg, SIM["steps"], lambda k: None,
                               H=SIM["H"])
        expected = only(**{apply_key: phases.count("gossip"),
                           flush_key: phases.count("global")})
        if launches != expected or plain.calls or launches["shard_cmix"]:
            raise AssertionError(f"[ovsim] {alg}: launches {launches} (the "
                                 f"dispatch rule gives {expected}), "
                                 f"{plain.calls} plain-twin calls")
        gate_no_generic(f"[ovsim] {alg}", launches)
        for k, c in zip(out["iteration"].tolist(),
                        out["consensus"].tolist()):
            if phases[k] == "global" and abs(c) > 1e-12:
                raise AssertionError(f"[ovsim] {alg}: consensus {c!r} after "
                                     f"the global flush of step {k}")
        bad = [k for k, f in zip(out["iteration"].tolist(),
                                 out["loss"].tolist())
               if not math.isfinite(f)]
        if bad and alg == "gossip_pga":
            raise AssertionError(f"[ovsim] {alg}: loss {out['loss']}")
        for key, v in launches.items():
            total[key] += v
        auc = float(np.trapezoid(out["loss"] - fs) / max(ref, 1e-12))
        growth = ", ".join(f"{k}: {c:.3e}" for k, c in zip(
            out["iteration"].tolist()[::10], out["consensus"].tolist()[::10]))
        print(f"[ovsim] {alg:10s} overlapped, n={prob.n}: final loss "
              f"{out['loss'][-1]:.8f} consensus {out['consensus'][-1]:.6e} "
              f"AUC vs parallel {auc:.4f} (synchronous [sim] "
              f"{SIM_REFERENCE['aucs'][alg]:.4f}, ratio "
              f"{auc / SIM_REFERENCE['aucs'][alg]:.4f}); {ms:.4f} ms/step "
              f"wall, launches {({k: v for k, v in launches.items() if v})};"
              f" consensus by step {{{growth}}}"
              + (f"; loss non-finite from step {bad[0]}" if bad else ""),
              flush=True)
    del prob
    probs = {dev: make_logistic_problem(SIM["n"], SIM["M"], SIM["d"],
                                        iid=False, seed=0, device=dev)
             for dev in ("cuda", "cpu")}
    for alg in ("gossip_pga", "gossip"):
        a, b = (_sim_run(torch, probs[dev], alg, device=dev, overlap=True,
                         lr=0.2, H=SIM["H"], **OVSIM_CROSS)
                for dev in ("cuda", "cpu"))
        what = f"[ovsim] {alg} overlapped card vs CPU"
        np.testing.assert_array_equal(a["iteration"], b["iteration"])
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5,
                                   err_msg=what)
        np.testing.assert_allclose(a["consensus"], b["consensus"],
                                   rtol=1e-4, atol=1e-12, err_msg=what)
        big = np.abs(b["consensus"]) > 1e-12
        dl = np.max(np.abs(a["loss"] - b["loss"]) / np.abs(b["loss"]))
        dc = (np.abs(a["consensus"] - b["consensus"])[big]
              / np.abs(b["consensus"])[big])
        print(f"{what}, n={SIM['n']} full gradients, "
              f"{OVSIM_CROSS['steps']} steps: max relative difference loss "
              f"{dl:.3e}, consensus {dc.max() if big.any() else 0.0:.3e}",
              flush=True)
    print(f"[ovsim] phase wall time {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return total


# ---------------------------------------------------------------------------
# Slice 10: checkpoints and resume ([ckpt], [cckpt], [psckpt], [agackpt])
# and the telemetry layer ([tel], [telfence], [occ], [simtel], [servetel])
# ---------------------------------------------------------------------------
CKPT_DIR = ROOT / "_ckpt_smoke"     # listed in .gitignore, removed after
TEL_DIR = ROOT / "_tel_smoke"
CKPT_EVERY = 3
# [psckpt] and [agackpt] cut pga-lm-100m's depth (12 layers) to this, at
# its full width: the card's machine stops a run after 45 GiB of disk
# writes (deleted files count), and the four phases write one file each
CKPT_CUT_LAYERS = 2
CKPT_WRITE_BUDGET = 40 * 2**30
CKPT_WRITTEN = [0]                  # checkpoint bytes this run wrote
MAIN_OPT = dict(name="adamw", lr=3e-4, schedule="warmup_cosine",
                warmup_steps=2, total_steps=8)
STEADY = {}                         # steady step seconds of each path
TRACE = {}                          # per step, each node shard's params
HISTORY = {}                        # each trainer path's step records
DEVICE = "cuda"                     # where slice 10's phases run


class RssPeak:
    """The process's peak resident set over a block, in bytes, and its
    resident set at the start: ``/proc/self/statm`` sampled every 10 ms
    on a thread (the card's machine keeps no resettable peak)."""

    def __init__(self):
        import threading
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self.start = self.peak = 0

    @staticmethod
    def _rss() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _poll(self):
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, self._rss())

    def __enter__(self):
        self.start = self.peak = self._rss()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())


def _state_bytes(state) -> int:
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(
        (state.params, state.opt_state, state.extras)))


def _bitwise(torch, a, b) -> bool:
    from repro_torch.tree import tree_flatten
    la, da = tree_flatten(a)
    lb, db = tree_flatten(b)
    if da != db:
        return False

    def bits(t):
        return t.detach().contiguous().reshape(-1).view(torch.uint8)
    return all(x.dtype == y.dtype and x.shape == y.shape
               and torch.equal(bits(x), bits(y)) for x, y in zip(la, lb))


def _slice10_config(tag: str, **dist_kw):
    """[main]'s cell (pga-lm-100m full width, 8 nodes, Gossip-PGA H = 3
    over one_peer_exp, AdamW, batch 32 × 512, fused rounds) with the
    phase's distributed options; the resume phases at
    :data:`CKPT_CUT_LAYERS` layers."""
    from repro_torch.configs import (DistConfig, OptimizerConfig,
                                     TrainConfig, get_model_config)
    model = get_model_config("pga-lm-100m")
    if tag in ("[ckpt]", "[cckpt]", "[psckpt]", "[agackpt]"):
        model = dataclasses.replace(model, n_layers=CKPT_CUT_LAYERS)
    dist = {"algorithm": "gossip_pga", "topology": "one_peer_exp", "H": 3,
            "comm_backend": "pallas", **dist_kw}
    return TrainConfig(model=model, dist=DistConfig(**dist),
                       optimizer=OptimizerConfig(**MAIN_OPT),
                       global_batch=32, seq_len=512, steps=6, log_every=1)


def ckpt_expected_launches(mc, tr, state, phases, tag: str) -> dict:
    """The dispatch rule's launches over a resume phase's 9 steps (A's 6,
    B's 3): one mix.cu launch per dispatch group per round, on the
    instance :func:`mix_key` gives fresh contiguous operands;
    compressed: one cmix and one row-maxima launch per leaf per gossip
    step, one collective launch per global step; push-sum:
    :func:`push_expected_launches`."""
    from repro_torch.tree import tree_leaves
    if tag == "[psckpt]":
        return push_expected_launches(mc, tr, state, phases, False, False)[0]
    leaves = tree_leaves(state.params)
    if tag == "[cckpt]":
        width = sum(leaf[0].numel() for leaf in leaves)
        return only(**{"cmix_vector": phases.count("gossip") * len(leaves),
                       "cmix_absmax": phases.count("gossip") * len(leaves),
                       collective_key(mc, tr.n_nodes, width):
                           phases.count("global")})
    rounds = sum(ph in mc.KERNEL_PHASES for ph in phases)
    want = {}
    for g in mc._dispatch_groups(leaves, tr.tcfg.dist.pallas_leaf_threshold):
        D = sum(leaves[i][0].numel() for i in g)
        key = mix_key(mc, tr.n_nodes, D)
        want[key] = want.get(key, 0) + rounds
    return only(**want)


def run_ckpt_path(torch, mc, tag: str, **dist_kw) -> dict:
    """A resume phase.  Trainer U runs the phase's config uninterrupted
    for 6 steps; Trainer A runs steps 0-2 of it with ``ckpt_every=3``
    (one save, after step 2); a fresh Trainer B (``ckpt_every=0``: the
    card's machine stops a run after 45 GiB of writes, so each phase writes
    one file) restores that file onto its ``init_state()`` template with
    ``restore_checkpoint`` and runs steps 3-5.  Gates: B's params,
    optimizer state (AdamW m, v, count) and extras (EF, push weight)
    bitwise U's; the launch counts the dispatch rule gives over the 12
    steps (reset before U, read after B); no plain twin on the card;
    ``[psckpt]`` (push-sum, the faults of :data:`PUSH_FAULTS`: the
    checkpoint falls between the drop and the rejoin) B's fault counters
    equal U's; ``[agackpt]`` (Gossip-AGA) B's schedule state and
    ``history`` equal U's through the schedule sidecar.  The free disk
    and the run's write budget are checked first; the directory is
    removed after.  Prints the file size, the save and restore seconds
    and rates, and the process's peak host RSS over A's run (the save
    in it) and over the restore, beside its RSS before each.  Returns
    the launch counts."""
    import shutil

    from repro_torch import checkpoint as ck
    from repro_torch import obs
    from repro_torch.core.faults import FaultSchedule
    from repro_torch.train import Trainer

    t_phase = time.perf_counter()
    tcfg = _slice10_config(tag, **dist_kw).replace(ckpt_dir=str(CKPT_DIR))

    def trainer(ckpt_every):
        fs = FaultSchedule(**PUSH_FAULTS) if tag == "[psckpt]" else None
        return Trainer(tcfg.replace(ckpt_every=ckpt_every), n_nodes=MAIN_N,
                       with_consensus=True, fault_schedule=fs, device=DEVICE,
                       telemetry=obs.Telemetry(sinks=[obs.RingSink()]))

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    tr_u = trainer(0)
    state = tr_u.init_state(torch.Generator().manual_seed(0))
    nbytes = _state_bytes(state)
    free = shutil.disk_usage(ROOT).free
    if free < nbytes + (1 << 30):
        raise AssertionError(f"{tag}: {free / 1e9:.1f} GB free on the disk "
                             f"of {ROOT}, the phase writes a "
                             f"{nbytes / 1e9:.2f} GB checkpoint there")
    if CKPT_WRITTEN[0] + nbytes > CKPT_WRITE_BUDGET:
        raise AssertionError(f"{tag}: a {nbytes / 1e9:.2f} GB checkpoint "
                             f"after {CKPT_WRITTEN[0] / 1e9:.2f} GB would "
                             f"pass this run's write budget of "
                             f"{CKPT_WRITE_BUDGET / 2**30:.0f} GiB")
    CKPT_WRITTEN[0] += nbytes
    print(f"{tag} pga-lm-100m, {tcfg.model.n_layers} layers, 8 nodes, "
          f"{tcfg.dist.algorithm} over {tcfg.dist.topology} {dist_kw}, "
          f"ckpt_every={CKPT_EVERY}: state {nbytes / 1e9:.3f} GB, "
          f"{free / 1e9:.1f} GB free on the disk", flush=True)
    saves = []
    real_save = ck.save_checkpoint

    def timed_save(d, st, step, **kw):
        t0 = time.perf_counter()
        path = real_save(d, st, step, **kw)
        saves.append((step, time.perf_counter() - t0,
                      os.path.getsize(path)))
        return path

    torch.cuda.synchronize()
    reset_counts()
    ck.save_checkpoint = timed_save
    try:
        with PlainCalls(mc) as plain, GenericShadow(torch, mc) as shadow:
            full = tr_u.run(state, steps=6, log_every=1)
            del state
            tr_a = trainer(CKPT_EVERY)
            state = tr_a.init_state(torch.Generator().manual_seed(0))
            torch.cuda.synchronize()
            with RssPeak() as rss_save:
                state = tr_a.run(state, steps=3, log_every=1)
            del state
            tr_b = trainer(0)
            template = tr_b.init_state(torch.Generator().manual_seed(0))
            torch.cuda.synchronize()
            with RssPeak() as rss_restore:
                t0 = time.perf_counter()
                restored = ck.restore_checkpoint(str(CKPT_DIR), template,
                                                 step=3)
                torch.cuda.synchronize()
                t_restore = time.perf_counter() - t0
            del template
            if restored.step != 3:
                raise AssertionError(f"{tag}: restored step "
                                     f"{restored.step}")
            resumed = tr_b.run(restored, steps=3, log_every=1)
            torch.cuda.synchronize()
            del restored
    finally:
        ck.save_checkpoint = real_save
    launches = counts()
    phases = [r["phase"] for tr in (tr_u, tr_a, tr_b) for r in tr.history]
    expected = ckpt_expected_launches(mc, tr_u, full, phases, tag)
    if launches != expected or launches["mix"]:
        raise AssertionError(f"{tag} launches {launches}, the dispatch rule "
                             f"gives {expected} (phases {phases}), no "
                             f"generic mix")
    if plain.calls:
        raise AssertionError(f"{tag}: {plain.calls} plain-twin calls")
    if shadow.launches:
        extra_shadow = f"; {shadow.check(tag)}"
    else:
        extra_shadow = ""
    if [s[0] for s in saves] != [3]:
        raise AssertionError(f"{tag}: saves {saves}")
    for what, a, b in (("params", full.params, resumed.params),
                       ("optimizer state", full.opt_state,
                        resumed.opt_state),
                       ("extras", full.extras, resumed.extras)):
        if not _bitwise(torch, a, b):
            raise AssertionError(f"{tag}: the resumed run's {what} after "
                                 f"step 5 are not bitwise the "
                                 f"uninterrupted run's")
    extra = ""
    if tag == "[psckpt]":
        if tr_b.fault_schedule.state_dict() != \
                tr_u.fault_schedule.state_dict():
            raise AssertionError(f"{tag}: fault counters "
                                 f"{tr_b.fault_schedule.state_dict()} after "
                                 f"the resume, "
                                 f"{tr_u.fault_schedule.state_dict()} "
                                 f"uninterrupted")
        extra = (f"; push_weight bitwise; fault counters "
                 f"{tr_b.fault_schedule.state_dict()} equal")
    if tag == "[agackpt]":
        if (tr_b.schedule.state_dict() != tr_u.schedule.state_dict()
                or tr_b.schedule.history != tr_u.schedule.history):
            raise AssertionError(f"{tag}: schedule {tr_b.schedule.history} "
                                 f"after the resume, "
                                 f"{tr_u.schedule.history} uninterrupted")
        extra = (f"; schedule sidecar restored, history "
                 f"{tr_b.schedule.history} equal")
    _, t_save, size = saves[0]
    print(f"{tag} phases U {phases[:6]}, A {phases[6:9]}, B {phases[9:]}; "
          f"file {size / 1e9:.3f} GB ({size:,} bytes; state {nbytes:,}); "
          f"save {t_save:.2f} s, {size / t_save / 1e9:.2f} GB/s; restore "
          f"{t_restore:.2f} s, {size / t_restore / 1e9:.2f} GB/s; peak host "
          f"RSS {rss_save.peak / 1e9:.2f} GB over A's 3 steps and the save "
          f"({rss_save.start / 1e9:.2f} before), "
          f"{rss_restore.peak / 1e9:.2f} GB over the restore "
          f"({rss_restore.start / 1e9:.2f} before; sampled every 10 ms); "
          f"launches "
          f"{ {k: v for k, v in launches.items() if v} } as the dispatch "
          f"rule gives, no plain twin{extra_shadow}; B's params, AdamW m, "
          f"v, count and extras after step 5 bitwise U's{extra}; phase wall "
          f"time {time.perf_counter() - t_phase:.1f} s", flush=True)
    del full, resumed, tr_u, tr_a, tr_b
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def run_tel_path(torch, mc, fence: bool) -> dict:
    """``[tel]``: [main]'s run (6 steps, one ``run()`` a step) with a hub
    of JsonlSink + RingSink and an unfenced tracer; its steady step beside
    [main]'s (the default hub: RingSink + PrettySink) is the hub's cost.
    Gates: one synchronizing call a step (:func:`gate_one_sync`), one
    ``Telemetry.fetch`` per log boundary, ``analytic_bytes ==
    measured_bytes`` on every ``comm_round`` record (one per step variant:
    the fused gossip at shifts 0 and 1 and the global round), the JSONL
    stream's records equal the ring's, and the saved Chrome trace loads
    as JSON with the 6 ``train/step`` spans.  ``[telfence]``: the same
    with ``fence=True``: each span waits for the card (CUDA event), its
    duration printed beside the step's host time; its synchronizing calls
    are printed, not gated.  Returns the launch counts."""
    import shutil

    from repro_torch import obs
    from repro_torch.train import Trainer

    tag = "[telfence]" if fence else "[tel]"
    steps = 6
    shutil.rmtree(TEL_DIR, ignore_errors=True)
    TEL_DIR.mkdir()
    jsonl = TEL_DIR / "telemetry.jsonl"
    hub = obs.Telemetry(sinks=[obs.JsonlSink(str(jsonl)), obs.RingSink()],
                        fence=fence)
    tcfg = _slice10_config(tag)
    tr = Trainer(tcfg, n_nodes=MAIN_N, with_consensus=True, telemetry=hub,
                 device=DEVICE)
    state = tr.init_state(torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    reset_counts()
    times, syncs = [], []
    for k in range(steps):
        t0 = time.perf_counter()
        state, n_sync = sync_steps(
            torch, lambda: tr.run(state, steps=1, log_every=1),
            step_sites(tag, k))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        syncs.append(n_sync)
    launches = counts()
    hub.close()
    spans = [e for e in hub.tracer.events if e["name"] == "train/step"]
    trace = hub.tracer.save(str(TEL_DIR / "trace.json"))
    with open(trace) as f:
        loaded = [e for e in json.load(f)["traceEvents"]
                  if e["name"] == "train/step"]
    recs = hub.ring().records()
    with open(jsonl) as f:
        lines = [json.loads(ln) for ln in f]
    comm = hub.ring().records("comm_round")
    bad = [r for r in comm if r["analytic_bytes"] != r["measured_bytes"]]
    if bad or len(comm) != 3:
        raise AssertionError(f"{tag}: comm_round records {comm}")
    if hub.host_fetches != steps:
        raise AssertionError(f"{tag}: {hub.host_fetches} fetches over "
                             f"{steps} log boundaries")
    if len(loaded) != steps or [e["args"]["step"] for e in loaded] != \
            list(range(steps)):
        raise AssertionError(f"{tag}: the trace's train/step spans "
                             f"{loaded}")
    if [r["type"] for r in lines] != [r["type"] for r in recs]:
        raise AssertionError(f"{tag}: the JSONL stream holds other records "
                             f"than the ring")
    SYNCS[tag] = syncs
    if not fence:
        gate_one_sync(tag, syncs)
    steady = statistics.median(times[1:])
    STEADY[tag] = steady
    main = STEADY.get("[main]")
    span_ms = [e["dur"] * 1e3 for e in spans]
    print(f"{tag} 6 steps of [main]'s cell with a JsonlSink + RingSink hub"
          f"{' and a fencing tracer' if fence else ''}: steady step "
          f"{steady * 1e3:.1f} ms (median of steps 1-5; [main] "
          f"{main * 1e3:.1f} ms, hub cost {(steady - main) * 1e3:+.1f} ms); "
          f"train/step span ms {[round(x, 1) for x in span_ms]} beside the "
          f"host step ms {[round(t * 1e3, 1) for t in times]}; "
          f"synchronizing calls per step {syncs}; fetches "
          f"{hub.host_fetches} for {steps} log boundaries; "
          f"{len(comm)} comm_round records (one per step variant), "
          f"analytic == measured: "
          f"{[(r['phase'], r['shift'], r['measured_bytes']) for r in comm]}"
          f"; {len(lines)} JSONL records; the trace loads with {len(loaded)}"
          f" train/step spans; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    del tr, state
    shutil.rmtree(TEL_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def run_occ_path(torch, mc) -> dict:
    """``[occ]``: [ovmain]'s cell (overlapped gossip, 6 steps in one
    ``run()``) with ``measure_occupancy=True``: the one ``occupancy``
    record (the calibration at step 1, on clones of the state and the
    buffer), printed; then the same run without it: the params after 6
    steps must be bitwise equal.  Returns the first run's launch counts
    (the calibration's probes included)."""
    from repro_torch import obs
    from repro_torch.train import Trainer

    t_phase = time.perf_counter()
    tcfg = _slice10_config("[occ]", comm_overlap=True)
    ends, launches = [], None
    for mo in (True, False):
        hub = obs.Telemetry(sinks=[obs.RingSink()])
        tr = Trainer(tcfg, n_nodes=MAIN_N, with_consensus=True,
                     measure_occupancy=mo, telemetry=hub, device=DEVICE)
        state = tr.init_state(torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with PlainCalls(mc) as plain:
            t0 = time.perf_counter()
            state = tr.run(state, steps=6, log_every=1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if plain.calls:
            raise AssertionError(f"[occ]: {plain.calls} plain-twin calls")
        occ = [r for r in hub.ring().records("comm_round")
               if r["role"] == "occupancy"]
        if mo:
            launches = counts()
            if len(occ) != 1:
                raise AssertionError(f"[occ]: occupancy records {occ}")
            rec = {k: v for k, v in occ[0].items()
                   if k not in ("type", "schema", "ts")}
            print(f"[occ] the occupancy record: {rec}; 6 steps with the "
                  f"calibration {wall:.2f} s of wall time, peak memory "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (the "
                  f"calibration's clones of the state and the buffer "
                  f"included); launches "
                  f"{ {k: v for k, v in launches.items() if v} }",
                  flush=True)
        elif occ:
            raise AssertionError(f"[occ]: a record without calibration")
        ends.append(state.params)
        del tr, state
        torch.cuda.empty_cache()
    if not _bitwise(torch, ends[0], ends[1]):
        raise AssertionError("[occ]: the params after 6 steps differ with "
                             "the calibration")
    print(f"[occ] params after 6 steps bitwise those of the run without "
          f"the calibration; phase wall time "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del ends
    torch.cuda.empty_cache()
    return launches


def run_simtel_path(torch, mc) -> dict:
    """``[simtel]``: [psim]'s acceptance scenario (n = 16, directed_exp,
    nodes 3 and 11 down at steps 12-27, 64 steps, H = 8, push-sum,
    ``backend="pallas"``) under ``simulate(telemetry=hub)`` on the card:
    the ``fault`` records are the schedule's events, one ``step`` record
    per eval, every ``comm_round`` record a push round; the run's losses
    bitwise those of the run without a hub.  Returns its launches."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.core import simulate
    from repro_torch.core.faults import FaultSchedule

    acc = dict(algorithm="gossip_pga", n=16, steps=64, lr=0.05,
               topology="directed_exp", H=8, push_sum=True,
               backend="pallas", eval_every=8)
    events = dict(drops={12: (3, 11)}, rejoins={28: (3, 11)})
    loss, grad, d = _least_squares(torch, DEVICE)
    outs = []
    for with_hub in (True, False):
        hub = obs.Telemetry(sinks=[obs.RingSink()]) if with_hub else None
        torch.cuda.synchronize()
        reset_counts()
        out = simulate(grad_fn=grad, loss_fn=loss,
                       x0=torch.zeros(d, device=DEVICE),
                       fault_schedule=FaultSchedule(n_nodes=16, seed=0,
                                                    **events),
                       device=DEVICE, telemetry=hub, **acc)
        outs.append(out)
        if with_hub:
            launches = counts()
            faults = [(r["step"], r["kind"], r["nodes"])
                      for r in hub.ring().records("fault")]
            want = [(12, "drop", [3, 11]), (28, "rejoin", [3, 11])]
            steps = hub.ring().records("step")
            comm = hub.ring().records("comm_round")
            if faults != want:
                raise AssertionError(f"[simtel] fault records {faults}, the "
                                     f"schedule's events {want}")
            if [r["step"] for r in steps] != out["iteration"].tolist():
                raise AssertionError(f"[simtel] step records {steps}")
            if not comm or any(r["phase"] != "push_sum" for r in comm):
                raise AssertionError(f"[simtel] comm records {comm}")
    if not np.array_equal(outs[0]["loss"], outs[1]["loss"]):
        raise AssertionError("[simtel] the hub changed the losses")
    print(f"[simtel] acceptance scenario under simulate(telemetry=): fault "
          f"records {faults} (the schedule's events); {len(steps)} step "
          f"records (the evals), last mass {steps[-1]['mass']!r}; "
          f"{len(comm)} push_sum comm_round records (one per step "
          f"variant); losses bitwise the run without a hub; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    return launches


def run_servetel_path(torch) -> dict:
    """``[servetel]``: [serve]'s ``BatchedServer`` at full width
    (xlstm-125m, bf16, the tensor-core mLSTM kernel; prompts of 6, 100,
    1000 and 2048 tokens on 2 slots, 16 new each) with a hub: one
    ``serve_req`` record per request, 4 ``serve/prefill`` spans and the
    decode spans in the saved Chrome trace, 10 mLSTM launches per
    prefill.  Prints the records' latencies.  Returns its launches."""
    import shutil

    import numpy as np

    from repro_torch import obs
    from repro_torch.models.model import make_model
    from repro_torch.serve import BatchedServer, Engine, Request

    cfg = _serving_config(torch)
    model = make_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), DEVICE)
    n_mlstm = sum(kind[0] == "mlstm" for kind in cfg.layers)
    rng = np.random.default_rng(0)
    lengths, max_new = (6, 100, 1000, 2048), 16
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=s),
                    max_new=max_new) for i, s in enumerate(lengths)]
    hub = obs.Telemetry(sinks=[obs.RingSink()])
    server = BatchedServer(Engine(model, s_max=max(lengths) + max_new),
                           params, n_slots=2, telemetry=hub)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    done = server.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = counts()
    if launches != only(mlstm_wgmma=n_mlstm * len(lengths)):
        raise AssertionError(f"[servetel] launches {launches}")
    recs = hub.ring().records("serve_req")
    if sorted(r["uid"] for r in recs) != list(range(len(lengths))) or \
            len(done) != len(lengths):
        raise AssertionError(f"[servetel] serve_req records {recs}")
    shutil.rmtree(TEL_DIR, ignore_errors=True)
    TEL_DIR.mkdir()
    with open(hub.tracer.save(str(TEL_DIR / "serve_trace.json"))) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]]
    shutil.rmtree(TEL_DIR, ignore_errors=True)
    if names.count("serve/prefill") != len(lengths) or \
            "serve/decode" not in names:
        raise AssertionError(f"[servetel] trace spans {set(names)}")
    latencies = [(r["uid"], round(r["latency_s"] * 1e3, 1),
                  round(r["tokens_per_s"], 1)) for r in recs]
    print(f"[servetel] BatchedServer prompts {lengths} on 2 slots, "
          f"+{max_new} each, with a hub: {run_s * 1e3:.1f} ms; serve_req "
          f"records (uid, latency ms, tokens/s) {latencies}; the trace "
          f"loads with {names.count('serve/prefill')} "
          f"serve/prefill and {names.count('serve/decode')} serve/decode "
          f"spans; launches {launches}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Slice 11: attention KV caches and decode (A.9) and the dense features of
# A.8, serving the dense decoders at full published size
# ---------------------------------------------------------------------------
DENSE_GATE = (5e-2, 5e-2)   # decode vs forward at bf16: atol, rtol
                            # (tests/test_decode_consistency.py's rule;
                            # reported, not gated: see decode_gate)
DENSE_GATE_F32 = (1e-4, 1e-4)   # decode vs forward at float32: gated
DXCROSS_TOL = 1e-4          # card vs CPU at float32, of max|cpu|
DENSE_ARCHS = ("pga-lm-100m", "gemma2-9b", "qwen3-0.6b", "qwen2-0.5b",
               "qwen1.5-32b")
QWEN32_LAYERS = 2           # of qwen1.5-32b's 64, at full width
# of gemma2-9b's 42, at full width: at all 42 the whole script overran
# its 900 s budget by 67 s on an H100, and at 10 by 13 s once the
# dry-run phases came (PERF.md section 7 has the sums)
GEMMA_LAYERS = 4
# (B, prompt, new tokens, s_max) of Engine.generate, then the
# BatchedServer's prompt lengths, slots and new tokens per request
DENSE_SERVE = {
    "[lmserve]": dict(arch="pga-lm-100m", gen=(8, 480, 32, 512),
                      server=((6, 100, 480), 2, 16)),
    "[gserve]": dict(arch="gemma2-9b", gen=(1, 4608, 32, 4672),
                     server=((6, 100, 1000, 4608), 4, 16),
                     n_layers=GEMMA_LAYERS, profile_tag="[gprofile]"),
    "[qserve] qwen3-0.6b": dict(arch="qwen3-0.6b", gen=(8, 1024, 32, 1056)),
    "[qserve] qwen2-0.5b": dict(arch="qwen2-0.5b", gen=(8, 1024, 32, 1056)),
    "[qserve] qwen1.5-32b": dict(arch="qwen1.5-32b", gen=(8, 1024, 32, 1056),
                                 n_layers=QWEN32_LAYERS),
}


def _sync(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _peak_gb(torch) -> float:
    return (torch.cuda.max_memory_allocated() / 1e9 if DEVICE == "cuda"
            else float("nan"))


def _reset_peak(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def decode_floor_bytes(cfg, n_params: int, cache_bytes: int) -> int:
    """The bytes one decode step moves at the least, as the port computes
    it: every fp32 weight matrix read and cast to a bf16 copy that the
    product reads again (4 + 2 + 2 bytes a parameter), the embedding cast
    for the lookup (4 + 2 bytes an entry) and, when tied, cast again and
    read by the unembedding (4 + 2 + 2), and the KV cache read once.  With
    bf16 params (jamba) the casts are no-ops: every parameter and the
    caches read once."""
    if cfg.param_dtype == cfg.dtype:
        return 2 * n_params + cache_bytes
    emb = cfg.vocab_size * cfg.d_model
    return (8 * (n_params - emb) + 6 * emb
            + (8 * emb if cfg.tie_embeddings else 0) + cache_bytes)


def _decode_and_forward(torch, model, params, tokens, s_max: int):
    """Prefill ``tokens[:, :S0]`` (S0 = S − 4), decode the 4 known tokens
    after it, and run one full forward over all S tokens: ``(dec, fwd)``,
    the prefill's last logits and the 4 decode steps' beside the
    forward's logits at the same 5 positions, each ``(B, 5, V)``."""
    from repro_torch.serve import Engine
    from repro_torch.tree import tree_map

    engine = Engine(model, s_max=s_max)
    B, S = tokens.shape
    S0 = S - 4
    logits, caches = engine.prefill(params, tokens[:, :S0])
    outs = [logits.clone()]
    del logits
    for t in range(4):
        pos = torch.full((B,), S0 + t, dtype=torch.int32, device=DEVICE)
        out, caches = engine.decode_step(params, caches,
                                         tokens[:, S0 + t:S0 + t + 1], pos)
        outs.append(out)
    del caches, out
    dec = torch.stack(outs, dim=1)
    del outs
    return dec, _forward_tail(torch, model, params, tokens, S0 - 1, 5)


def _forward_tail(torch, model, params, tokens, start: int, n: int):
    """One full forward over ``tokens``; its logits at positions
    ``start .. start + n − 1``, ``(B, n, V)``."""
    from repro_torch.tree import tree_map

    full, _, _ = model.forward(tree_map(lambda t: t[None], params),
                               {"inputs": tokens[None]})
    out = full[0, :, start:start + n].clone()
    del full
    return out


def _gap(torch, got, want, atol: float, rtol: float) -> tuple:
    """(max |got − want|, worst ratio to atol + rtol·|want|, greedy-id
    agreement) over every logit."""
    err = (got - want).abs()
    return (float(err.max()),
            float((err / (atol + rtol * want.abs())).max()),
            float((got.argmax(-1) == want.argmax(-1)).float().mean()))


def gate_config(cfg):
    """The float32 config of :func:`decode_gate`; an MoE model's also
    drop-free (``capacity_factor = n_routed``), as
    ``tests/test_decode_consistency.py`` pins it: the capacity depends on
    each call's token count, so a prefill, a decode step and a forward
    would otherwise drop different assignments."""
    cfg = dataclasses.replace(cfg, dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_routed)))
    return cfg


def decode_gate(torch, tag: str, model, params, tokens, s_max: int) -> None:
    """The decode path held against the full forward at full size.

    Gated, at float32 compute (the same fp32 params, TF32 off; an MoE
    model drop-free, :func:`gate_config`): the
    prefill's last logits and 4 decode steps against one forward over
    ``tokens[:, :S0 + 4]``, ``|dec − fwd| ≤ atol + rtol·|fwd|`` elementwise
    at :data:`DENSE_GATE_F32`.  Reported, at bf16 compute (the serving
    path): the same gap against the reference test's rule
    (:data:`DENSE_GATE`), beside the bf16 rounding floor, the forward over
    ``S0 + 4`` tokens against the forward over all ``S0 + 8`` at the same
    5 positions (two equally valid bf16 computations of one function), and
    the greedy-id agreement of both."""
    from repro_torch.models.model import make_model

    S = tokens.shape[1] - 4
    B = tokens.shape[0]
    head = tokens[:, :S].contiguous()
    dec, fwd = _decode_and_forward(torch, model, params, head, s_max)
    finite = bool(torch.isfinite(dec).all())
    bf16 = _gap(torch, dec, fwd, *DENSE_GATE)
    longer = _forward_tail(torch, model, params, tokens, S - 5, 5)
    floor = _gap(torch, longer, fwd, *DENSE_GATE)
    ref_max = float(fwd.abs().max())
    del dec, fwd, longer
    model32 = make_model(gate_config(model.cfg))
    dec, fwd = _decode_and_forward(torch, model32, params, head, s_max)
    f32 = _gap(torch, dec, fwd, *DENSE_GATE_F32)
    finite = finite and bool(torch.isfinite(dec).all())
    f32_max = float(fwd.abs().max())
    del dec, fwd
    print(f"{tag} decode vs forward (prefill's last logits and 4 decoded "
          f"positions against one forward over {S} tokens, B={B}): float32 "
          f"max abs err {f32[0]:.4e} (max|fwd| {f32_max:.4f}), worst ratio "
          f"to {DENSE_GATE_F32[0]:g} + {DENSE_GATE_F32[1]:g}·|fwd| "
          f"{f32[1]:.4f} (gated), greedy ids agree at {f32[2]:.4f}; bf16 "
          f"max abs err {bf16[0]:.4e} (max|fwd| {ref_max:.4f}), worst ratio "
          f"to {DENSE_GATE[0]:g} + {DENSE_GATE[1]:g}·|fwd| {bf16[1]:.4f}, "
          f"greedy ids agree at {bf16[2]:.4f}; bf16 rounding floor (forward "
          f"over {S} vs over {S + 4} tokens) max abs err {floor[0]:.4e}, "
          f"worst ratio {floor[1]:.4f}, greedy ids agree at {floor[2]:.4f} "
          f"(bf16 not gated)", flush=True)
    if not finite or not f32[1] <= 1.0:
        raise AssertionError(f"{tag} decode vs forward at float32: worst "
                             f"ratio {f32[1]} to the gate, finite {finite}")


class moe_metrics:
    """Records every ``apply_moe`` call's ``drop_frac`` and ``lb_loss``
    ``(n,)`` (device tensors, read after the run) while the block is
    active: ``models.blocks`` calls ``moe.apply_moe`` through its
    module."""

    def __enter__(self):
        from repro_torch.models import moe as moe_lib
        self.real, self.calls = moe_lib.apply_moe, []

        def spy(*args, **kw):
            out, met = self.real(*args, **kw)
            self.calls.append({k: v.detach() for k, v in met.items()})
            return out, met

        moe_lib.apply_moe = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as moe_lib
        moe_lib.apply_moe = self.real

    def drops(self) -> list:
        """Every call's drop_frac, node by node."""
        return [c["drop_frac"].tolist() for c in self.calls]


def _drop_summary(drops: list) -> str:
    flat = [d for call in drops for d in call]
    return (f"drop_frac over {len(drops)} MoE calls: mean "
            f"{statistics.fmean(flat):.4f}, min {min(flat):.4f}, max "
            f"{max(flat):.4f}")


def run_dense_serve_path(torch, tag: str, arch: str, gen, server=None,
                         n_layers=None, gate=None, profile_tag=None,
                         pattern=None) -> tuple:
    """Slice 11's serving path on one decoder at full published width
    (depth cut to ``n_layers`` where given, the block pattern replaced by
    ``pattern`` where given), its params from seed 0 in the config's
    ``param_dtype``, bf16 compute: the init timed, with its rate; (a)
    ``Engine.generate`` at ``gen`` = (B, prompt, new tokens, s_max) with
    greedy ids, then its prefill timed alone (with each MoE layer's
    drop_frac, :class:`moe_metrics`), its greedy ids generate's first, and
    its decode steps timed alone; with ``profile_tag``, 4 more decode steps
    under ``torch.profiler`` and the weight casts alone; a second generate
    with the same ids; (b) ``BatchedServer.run`` with ``server`` = (prompt
    lengths, slots, new tokens each); then :func:`decode_gate` on the
    generate's own tokens, or on ``gate`` = (B, S) fresh ones at ``s_max``
    S + 8.  The model launches none of the port's kernels (no model calls
    them, here or in the reference): the counts are set to 0 before each
    run and must read 0 after. Returns ``(model, params)``."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.models.model import make_model
    from repro_torch.serve import Engine
    from repro_torch.tree import tree_leaves

    cfg = configs.get_model_config(arch)
    cut = ""
    if n_layers is not None:
        cut = f", depth cut to {n_layers} of its {cfg.n_layers} layers"
        cfg = dataclasses.replace(cfg, n_layers=n_layers,
                                  pattern=pattern or cfg.pattern)
    model = make_model(cfg)
    _reset_peak(torch)
    t0 = time.perf_counter()
    params = model.init(torch.Generator().manual_seed(0), DEVICE)
    _sync(torch)
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    n_params = _init_line(torch, tag, model, params, init_s)
    init_peak = _peak_gb(torch)
    print(f"{tag} {cfg.name}: {n_params:,} params{cut}, {cfg.n_layers} "
          f"layers {sorted(set(cfg.layers))}, bf16 compute; init "
          f"{init_s:.1f} s (drawn on the host from seed 0), peak device "
          f"memory after init {init_peak:.2f} GB", flush=True)
    B, S0, n_new, s_max = gen
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S0 + 8))
                              ).to(device=DEVICE, dtype=torch.int32)
    prompts = tokens[:, :S0].contiguous()
    engine = Engine(model, s_max=s_max)
    _reset_peak(torch)
    reset_counts()
    t0 = time.perf_counter()
    ids = engine.generate(params, prompts, n_new)
    gen_s = time.perf_counter() - t0
    if counts() != only():
        raise AssertionError(f"{tag} generate launched {counts()}")
    peak_a = _peak_gb(torch)
    assert ids.shape == (B, n_new), ids.shape
    assert ((ids >= 0) & (ids < cfg.vocab_size)).all()
    _sync(torch)
    with moe_metrics() as rec:
        t0 = time.perf_counter()
        logits, caches = engine.prefill(params, prompts)
        _sync(torch)
        prefill_ms = (time.perf_counter() - t0) * 1e3
    assert bool(torch.isfinite(logits).all()), "prefill logits not finite"
    cache_leaves = tree_leaves(caches)
    assert all(bool(torch.isfinite(t.float()).all()) for t in cache_leaves)
    cache_bytes = sum(t.numel() * t.element_size() for t in cache_leaves)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    if not np.array_equal(tok[:, 0].cpu().numpy(), ids[:, 0]):
        raise AssertionError(f"{tag} the prefill's greedy ids are not "
                             f"generate's first")
    del logits
    pos = torch.full((B,), S0, dtype=torch.int32, device=DEVICE)
    engine.decode_step(params, caches, tok, pos)
    _sync(torch)
    t0 = time.perf_counter()
    for i in range(n_new):
        out, caches = engine.decode_step(params, caches, tok, pos + i)
        tok = torch.argmax(out, dim=-1).to(torch.int32)[:, None]
    _sync(torch)
    decode_ms = (time.perf_counter() - t0) * 1e3 / n_new
    floor = decode_floor_bytes(cfg, n_params, cache_bytes)
    if profile_tag is not None and DEVICE == "cuda":
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(4):
                engine.decode_step(params, caches, tok, pos + n_new)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        profile_report(prof, wall_ms, profile_tag, "4 decode steps")
        mats = [p for p in leaves if p.dim() >= 3]

        def casts():
            for p in mats:
                p.to(torch.bfloat16)

        cast_ms = cuda_ms(torch, casts, iters=3, warmup=1)
        moved = sum(6 * p.numel() for p in mats)
        print(f"{profile_tag} the casts alone: every weight matrix to bf16 "
              f"once ({len(mats)} leaves, {moved / 1e9:.2f} GB read + "
              f"written): {cast_ms:.2f} ms, bound "
              f"{moved / HBM_BYTES_PER_S * 1e3:.2f} ms", flush=True)
    del caches, out
    again = engine.generate(params, prompts, n_new)
    if not np.array_equal(ids, again):
        raise AssertionError(f"{tag} a second generate gave other ids")
    drops = f"; {_drop_summary(rec.drops())}" if rec.calls else ""
    print(f"{tag} (a) Engine.generate B={B} S={S0} +{n_new} greedy, s_max "
          f"{s_max}: {gen_s * 1e3:.1f} ms in all, {B * n_new / gen_s:.1f} "
          f"generated tokens/s; prefill alone {prefill_ms:.1f} ms "
          f"({B * S0 / prefill_ms * 1e3:.0f} prompt tokens/s{drops}), "
          f"decode {decode_ms:.2f} ms/token ({B / decode_ms * 1e3:.1f} "
          f"tokens/s at B={B}; floor {floor / HBM_BYTES_PER_S * 1e3:.2f} ms "
          f"from {floor / 1e9:.2f} GB a step: weight casts and their reads, "
          f"the KV cache of {cache_bytes / 1e9:.3f} GB); peak memory "
          f"{peak_a:.2f} GB; no kernel launched; a second run gives the same "
          f"ids", flush=True)
    if server is not None:
        _serve_batched(torch, tag, model, params, rng, s_max, *server)
    if gate is not None:
        B, S = gate
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                               (B, S + 8))).to(
            device=DEVICE, dtype=torch.int32)
        s_max = S + 8
    decode_gate(torch, tag, model, params, tokens, s_max)
    return model, params


def _serve_batched(torch, tag: str, model, params, rng, s_max: int,
                   lengths, n_slots: int, max_new: int) -> None:
    """(b) of :func:`run_dense_serve_path`: ``BatchedServer.run`` with
    prompts of ``lengths`` on ``n_slots`` slots, ``max_new`` each."""
    from repro_torch.serve import BatchedServer, Engine, Request

    cfg = model.cfg
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=s),
                    max_new=max_new) for i, s in enumerate(lengths)]
    srv = BatchedServer(Engine(model, s_max=s_max), params, n_slots=n_slots)
    _reset_peak(torch)
    reset_counts()
    t0 = time.perf_counter()
    done = srv.run(reqs)
    _sync(torch)
    run_s = time.perf_counter() - t0
    if counts() != only():
        raise AssertionError(f"{tag} BatchedServer launched {counts()}")
    assert sorted(r.uid for r in done) == list(range(len(lengths)))
    for r in done:
        assert r.done and len(r.generated) == max_new, r
        assert all(0 <= t < cfg.vocab_size for t in r.generated), r
    peak_b = _peak_gb(torch)
    print(f"{tag} (b) BatchedServer prompts {lengths} on {n_slots} slots, "
          f"+{max_new} each, s_max {s_max}: {run_s * 1e3:.1f} ms, "
          f"{len(lengths) * max_new / run_s:.1f} generated tokens/s, peak "
          f"memory {peak_b:.2f} GB; no kernel launched; every request "
          f"answered", flush=True)


def dense_cross_check(torch) -> None:
    """``[dxcross]``: the five dense archs at their reduced configs with
    float32 compute, one init (seed 1) on the card and on the CPU: prefill
    logits and every cache leaf within :data:`DXCROSS_TOL` · max|cpu|
    (cuBLAS and the CPU's BLAS sum in other orders; TF32 off), and the
    same greedy ids over 8 decode steps through ``Engine.generate`` and
    through ``BatchedServer.run`` (prompts of 5, 9 and 3 tokens on 2
    slots)."""
    import numpy as np

    from repro_torch import configs, interop
    from repro_torch.models.model import make_model
    from repro_torch.serve import BatchedServer, Engine, Request
    from repro_torch.tree import tree_leaves

    for arch in DENSE_ARCHS:
        cfg = dataclasses.replace(
            configs.get_model_config(arch, reduced=True), dtype="float32")
        model = make_model(cfg)
        init = interop.to_numpy(model.init(torch.Generator().manual_seed(1),
                                           "cpu"))
        rng = np.random.default_rng(1)
        prompts = rng.integers(0, cfg.vocab_size, (2, 37)).astype(np.int32)
        lone = [rng.integers(0, cfg.vocab_size, s) for s in (5, 9, 3)]
        out = {}
        for dev in ("cuda", "cpu"):
            params = interop.from_numpy(init, dev)
            eng = Engine(model, s_max=64)
            logits, caches = eng.prefill(params,
                                         torch.from_numpy(prompts).to(dev))
            ids = eng.generate(params, prompts, 8)
            srv = BatchedServer(Engine(model, s_max=64), params, n_slots=2)
            done = sorted(srv.run([Request(uid=i, prompt=p, max_new=8)
                                   for i, p in enumerate(lone)]),
                          key=lambda r: r.uid)
            out[dev] = ([logits.cpu().numpy()] + [
                t.float().cpu().numpy() for t in tree_leaves(caches)], ids,
                [r.generated for r in done])
        worst = 0.0
        for a, b in zip(*(out[d][0] for d in ("cuda", "cpu"))):
            assert np.isfinite(a).all() and a.shape == b.shape
            worst = max(worst, float(np.abs(a - b).max())
                        / max(float(np.abs(b).max()), 1e-30))
        if worst > DXCROSS_TOL:
            raise AssertionError(f"[dxcross] {arch} cuda vs cpu: "
                                 f"{worst:.3e} of max|ref|")
        for k, what in ((1, "Engine.generate"), (2, "BatchedServer")):
            if not np.array_equal(np.asarray(out["cuda"][k]),
                                  np.asarray(out["cpu"][k])):
                raise AssertionError(f"[dxcross] {arch} {what} greedy ids "
                                     f"differ: {out['cuda'][k]} vs "
                                     f"{out['cpu'][k]}")
        print(f"[dxcross] {cfg.name} fp32, cuda vs cpu: logits and "
              f"{len(out['cpu'][0]) - 1} cache leaves within {worst:.3e} of "
              f"max|cpu|; greedy ids over 8 steps equal, Engine "
              f"{out['cuda'][1].tolist()}, BatchedServer "
              f"{out['cuda'][2]}", flush=True)


# ---------------------------------------------------------------------------
# Slice 12: bert-large training (the paper's §5.3 workload: the encoder,
# LAMB, microbatches, remat "dots") and gemma2-9b's 8,192-token prefill
# through the blocked attention
# ---------------------------------------------------------------------------
BERT = dict(n=4, H=4, per_node=32, seq=128, microbatches=4, steps=8,
            lr=1e-3)
BERT_PARAMS = 465_213_440           # a replica, untied, gated MLP
BERT_LOGIT_BYTES = 30_522 * 4       # one position's fp32 logits
BERTMEM_REMAT_TOL = 1e-6            # params after one step, remat variants
# the microbatch variants: the CPU test's tolerances
# (test_reference_microbatch_equivalence: loss rtol 1e-3, params 1e-4);
# the encoder's per-slice mask counts make the 1- and 4-microbatch steps
# different functions, and LAMB's first update is ~lr·trust·sign(g), so a
# coordinate whose gradient sign the weighting flips moves 2·lr·trust
# apart: the params gate is the share of elements beyond 1e-4
BERTMEM_MB_LOSS = 1e-3
BERTMEM_MB_TOL = 1e-4
BERTMEM_MB_SHARE = 1e-3
# the gradient phase's grads, per leaf ‖g − g_ref‖/‖g_ref‖: the
# 4-microbatch grads against the mean of the 4 slices' one-batch grads,
# and "dots"' against "nothing"'s (the same sums; only the gather
# backward's atomics may differ); the 1-microbatch grads against the
# 4-microbatch ones differ by the per-slice mask counts (0.1025 at full
# size on an H100, 0.076 on the reduced config on the CPU), while a wrong
# accumulation scale reads 0.75 or more
BERTMEM_GRAD_TOL = 1e-5
BERTMEM_MB_GRAD_TOL = 0.25
# the 8,192-token prefill, on the params of this arch's serving phase
GLONG = dict(arch="gemma2-9b", prompt=8192, new=16, s_max=8208)
GLONG_TOL = 1e-5                    # blocked vs plain attention, of max|plain|
ENCX_TOL = 1e-5                     # card vs CPU, of max|cpu|


def _bert_config(remat_policy: str = "nothing",
                 microbatches: int = BERT["microbatches"],
                 steps: int = BERT["steps"], arch: str = "bert-large",
                 reduced: bool = False):
    """bert-large phase 1 (BERT's 128-token sequences) as the paper trains
    it: LAMB with ``warmup_poly``, Gossip-PGA over one_peer_exp on the
    fused kernel, ``BERT["per_node"]`` sequences a node.  ``reduced``
    ([encx]): the reduced config at float32, H = 2, 2 sequences of 32 a
    node."""
    from repro_torch import configs
    from repro_torch.configs import (DistConfig, OptimizerConfig,
                                     TrainConfig)
    cfg = configs.get_model_config(arch, reduced=reduced)
    H, per_node, seq = BERT["H"], BERT["per_node"], BERT["seq"]
    if reduced:
        cfg = dataclasses.replace(cfg, dtype="float32")
        H, per_node, seq = 2, 2, 32
    return TrainConfig(
        model=cfg,
        dist=DistConfig(algorithm="gossip_pga", topology="one_peer_exp",
                        H=H, comm_backend="pallas",
                        remat_policy=remat_policy),
        optimizer=OptimizerConfig(name="lamb", lr=BERT["lr"],
                                  schedule="warmup_poly", warmup_steps=2,
                                  total_steps=steps + 2, weight_decay=0.01),
        global_batch=per_node * BERT["n"], seq_len=seq,
        microbatches=microbatches, steps=steps, log_every=1)


def run_bert_path(torch, mc) -> tuple:
    """``[bert]``: bert-large at its full published size (24 layers, no
    depth cut), fp32 params from seed 0, bf16 compute, n = 4 stacked
    nodes, Gossip-PGA H = 4 with the fused consensus round, LAMB, 4
    microbatches of 8 sequences a node, 8 steps.  Gates: finite losses,
    consensus exactly 0.0 on the 2 global steps, mix.cu's launches equal
    to the dispatch groups × steps, one synchronizing call on the steady
    steps; then one more step under ``torch.profiler`` (``[bprofile]``).
    Returns ``(launches, one replica's initial params)``."""
    from repro_torch.train import Trainer
    from repro_torch.tree import tree_leaves

    tag, steps, n = "[bert]", BERT["steps"], BERT["n"]
    tcfg = _bert_config()
    tr = Trainer(tcfg, n_nodes=n, with_consensus=True, device=DEVICE)
    t0 = time.perf_counter()
    params = tr.model.init(torch.Generator().manual_seed(0), DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = _init_line(torch, tag, tr.model, params, init_s)
    if n_params != BERT_PARAMS:
        raise AssertionError(f"{tag} {n_params:,} params, expected "
                             f"{BERT_PARAMS:,}")
    state = tr.init_state(params=params)
    leaves = tree_leaves(state.params)
    groups = mc._dispatch_groups(leaves, tcfg.dist.pallas_leaf_threshold)
    widths = [sum(leaves[i][0].numel() for i in g) for g in groups]
    del leaves      # the initial stack must not outlive its step
    print(f"{tag} {tcfg.model.name}: {n_params:,} params a replica "
          f"({n_params * 4 / 1e9:.3f} GB fp32; init {init_s:.1f} s), "
          f"{tcfg.model.n_layers} layers, bf16 compute, {n} nodes, "
          f"Gossip-PGA H={tcfg.dist.H} over {tcfg.dist.topology}, LAMB "
          f"(warmup_poly, lr {BERT['lr']}), {BERT['per_node']} sequences "
          f"of {BERT['seq']} a node in {tcfg.microbatches} microbatches, "
          f"remat {tcfg.dist.remat}/{tcfg.dist.remat_policy}; "
          f"{len(groups)} mix launches a round (group widths {widths})",
          flush=True)
    tokens = tcfg.global_batch * tcfg.seq_len
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, phases, syncs = [], [], []
    for k in range(steps):
        t0 = time.perf_counter()
        state, n_sync = sync_steps(
            torch, lambda: tr.run(state, steps=1, log_every=1),
            step_sites(tag, k))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        times.append(dt)
        syncs.append(n_sync)
        rec = tr.history[-1]
        phases.append(rec["phase"])
        print(f"{tag} step {k} phase={rec['phase']} loss={rec['loss']:.4f}"
              f" lr={rec['lr']:.3e} consensus={rec['consensus']:.6e} "
              f"step_ms={dt * 1e3:.1f} tokens/s={tokens / dt:.0f} "
              f"max_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.2f} "
              f"synchronizing_calls={n_sync}", flush=True)
        if not math.isfinite(rec["loss"]):
            raise AssertionError(f"{tag} step {k}: loss {rec['loss']}")
        if rec["phase"] == "global":
            assert rec["consensus"] == 0.0, rec
        else:
            assert rec["consensus"] > 0.0, rec
    launches = counts()
    expected = only(mix_vector=len(groups) * steps)
    if launches != expected or phases.count("global") != 2:
        raise AssertionError(f"{tag} launches {launches}, expected "
                             f"{expected}; phases {phases}")
    SYNCS[tag] = syncs
    gate_one_sync(tag, syncs)
    steady = statistics.median(times[1:6])
    STEADY[tag] = steady
    print(f"{tag} {steps} steps, {len(phases)} fused rounds "
          f"({phases.count('gossip')} gossip, {phases.count('global')} "
          f"global) through mix.cu ({launches['mix_vector']} launches of "
          f"the register instance); steady step {steady * 1e3:.1f} ms "
          f"(median of steps 1-5), {tokens / steady:.0f} tokens/s, peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.run(state, steps=1, log_every=1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    profile_report(prof, wall_ms, "[bprofile]", "one profiled [bert] step")
    del state, tr, prof
    return launches, params


def _worst_rel(torch, got: list, want: list) -> float:
    """max over leaves of ‖got − want‖ / ‖want‖ (0 where both are 0)."""
    worst = 0.0
    for g, w in zip(got, want):
        diff = float(torch.linalg.vector_norm(g - w))
        if diff:
            worst = max(worst, diff / max(
                float(torch.linalg.vector_norm(w)), 1e-30))
    return worst


def bertmem_grads(torch, params) -> None:
    """``[bertmem]``'s gradient phase: the step's own
    (``train.step.build_grad_fn``) on ``[bert]``'s step-0 batch, from
    the same node-stacked params, in the three variants, each timed on
    its own with its peak memory above what was allocated before it (the
    activations, the accumulation buffer and the grads).  Gated per leaf
    by ``‖g − g_ref‖/‖g_ref‖``: the 4-microbatch grads against the mean
    of the four slices' one-batch grads and ``"dots"``' against
    ``"nothing"``'s within :data:`BERTMEM_GRAD_TOL`, the 1-microbatch
    grads against the 4-microbatch ones within
    :data:`BERTMEM_MB_GRAD_TOL`."""
    from repro_torch.train import Trainer
    from repro_torch.train.state import stack_for_nodes
    from repro_torch.train.step import build_grad_fn
    from repro_torch.tree import tree_leaves

    n, m = BERT["n"], BERT["microbatches"]
    tr = Trainer(_bert_config(), n_nodes=n, device=DEVICE)
    stacked = stack_for_nodes(params, n)
    batch = tr.device_batch(0)
    grads = {}
    for policy, mb in (("nothing", m), ("dots", m), ("nothing", 1)):
        grad_fn = build_grad_fn(tr.model, _bert_config(policy, mb))
        _reset_peak(torch)
        base = torch.cuda.memory_allocated() / 1e9
        t0 = time.perf_counter()
        g, met = grad_fn(stacked, batch)
        _sync(torch)
        ms = (time.perf_counter() - t0) * 1e3
        peak = _peak_gb(torch) - base
        grads[policy, mb] = tree_leaves(g)
        print(f"[bertmem] gradient phase remat_policy={policy!r} "
              f"microbatches={mb}: {ms:.1f} ms, peak {peak:.2f} GB above "
              f"the {base:.2f} GB before it, loss {float(met['loss']):.6f}",
              flush=True)
        del g
        if policy == "dots":
            remat = _worst_rel(torch, grads["dots", m], grads["nothing", m])
            del grads["dots", m]
    one = build_grad_fn(tr.model, _bert_config(microbatches=1))
    b = BERT["per_node"] // m
    mean = [torch.zeros_like(g) for g in grads["nothing", 1]]
    for i in range(m):
        for a, g in zip(mean, tree_leaves(one(stacked, {
                k: t[:, i * b:(i + 1) * b] for k, t in batch.items()})[0])):
            a.add_(g)
    for a in mean:
        a.div_(m)
    acc = _worst_rel(torch, grads["nothing", m], mean)
    del mean, stacked
    mb_gap = _worst_rel(torch, grads["nothing", 1], grads["nothing", m])
    print(f"[bertmem] grads (each leaf, ‖g − g_ref‖/‖g_ref‖): "
          f"{m} microbatches vs the mean of the {m} slices' one-batch grads "
          f"{acc:.3e}, 'dots' vs 'nothing' {remat:.3e} (gate "
          f"{BERTMEM_GRAD_TOL:g}); 1 vs {m} microbatches {mb_gap:.3e} (gate "
          f"{BERTMEM_MB_GRAD_TOL:g}; the per-slice mask counts)", flush=True)
    del grads
    torch.cuda.empty_cache()
    if not (acc <= BERTMEM_GRAD_TOL and remat <= BERTMEM_GRAD_TOL
            and mb_gap <= BERTMEM_MB_GRAD_TOL):
        raise AssertionError(f"[bertmem] grads: accumulation {acc:.3e}, "
                             f"remat {remat:.3e}, 1 vs {m} microbatches "
                             f"{mb_gap:.3e}")


def run_bertmem_path(torch, mc, params) -> dict:
    """``[bertmem]``: ``[bert]``'s step in three variants from the same
    initial params: remat_policy ``"nothing"`` and ``"dots"`` at 4
    microbatches, and 1 microbatch at ``"nothing"``.  First their
    gradient phase alone (:func:`bertmem_grads`), then two Trainer steps
    each: the peak memory over the first step (set by the optimizer
    phase; less the 7.44 GB copy of the first variant's params kept on
    the card for the gate) and the second step's ms; the params after one
    step gated against the ``"nothing"``/4 variant's:
    within :data:`BERTMEM_REMAT_TOL` for the remat variant (recompute
    changes no number; the gather backward's atomics may), within
    :data:`BERTMEM_MB_TOL` for the microbatch one."""
    from repro_torch.train import Trainer
    from repro_torch.tree import tree_leaves

    n = BERT["n"]
    positions = n * BERT["per_node"] * BERT["seq"]   # one microbatch of all
    logit_gb = positions * BERT_LOGIT_BYTES * 3 / 1e9
    saved_gb = positions * 1024 * 2 * 24 / 1e9
    print(f"[bertmem] reckoned before running microbatches=1: fp32 logits "
          f"over {positions:,} positions × 30,522, their log-softmax and "
          f"gradient {logit_gb:.2f} GB, the 24 saved bf16 block inputs "
          f"{saved_gb:.2f} GB: {logit_gb + saved_gb:.2f} GB of activations "
          f"over [bert]'s state", flush=True)
    bertmem_grads(torch, params)
    launches = {k: 0 for k in counts()}
    ref, ref_gb = None, 0.0
    for policy, mb in (("nothing", 4), ("dots", 4), ("nothing", 1)):
        name = f"remat_policy={policy!r} microbatches={mb}"
        tr = Trainer(_bert_config(policy, mb, steps=2), n_nodes=n,
                     with_consensus=True, device=DEVICE)
        state = tr.init_state(params=params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        times = []
        for k in range(2):
            t0 = time.perf_counter()
            state = tr.run(state, steps=1, log_every=1)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if not math.isfinite(tr.history[-1]["loss"]):
                raise AssertionError(f"[bertmem] {name}: loss "
                                     f"{tr.history[-1]['loss']}")
            if k == 0:
                peak = torch.cuda.max_memory_allocated() / 1e9 - ref_gb
                after = [p.detach().clone() for p in
                         tree_leaves(state.params)]
        for key, v in counts().items():
            launches[key] += v
        loss0 = tr.history[0]["loss"]
        if ref is None:
            ref, ref_loss = after, loss0
            ref_gb = sum(a.numel() * a.element_size() for a in ref) / 1e9
        diff = max(float((a - b).abs().max()) for a, b in zip(after, ref))
        n_el = sum(a.numel() for a in after)
        share = sum(int(((a - b).abs() > BERTMEM_MB_TOL).sum())
                    for a, b in zip(after, ref)) / n_el
        loss_rel = abs(loss0 - ref_loss) / abs(ref_loss)
        print(f"[bertmem] {name}: step peak {peak:.2f} GB, step 1 "
              f"{times[1] * 1e3:.1f} ms (step 0 {times[0] * 1e3:.1f}), "
              f"loss at step 0 {loss0:.6f} (the 'nothing'/4 variant's "
              f"{ref_loss:.6f}, rel {loss_rel:.2e}); params after one step "
              f"within {diff:.3e} of its, a share {share:.3e} of them apart "
              f"by more than {BERTMEM_MB_TOL:g}", flush=True)
        if mb == BERT["microbatches"] and not diff <= BERTMEM_REMAT_TOL:
            raise AssertionError(f"[bertmem] {name}: params after one step "
                                 f"{diff:.3e} from the 'nothing'/4 "
                                 f"variant's (tolerance "
                                 f"{BERTMEM_REMAT_TOL:g})")
        if mb != BERT["microbatches"] and not (
                loss_rel <= BERTMEM_MB_LOSS and share <= BERTMEM_MB_SHARE):
            raise AssertionError(f"[bertmem] {name}: loss {loss_rel:.3e} "
                                 f"from the 4-microbatch step's (gate "
                                 f"{BERTMEM_MB_LOSS:g}), {share:.3e} of the "
                                 f"params apart by more than "
                                 f"{BERTMEM_MB_TOL:g} (gate "
                                 f"{BERTMEM_MB_SHARE:g})")
        del state, tr, after
        torch.cuda.empty_cache()
    del ref
    return launches


def run_glong_path(torch, model, params) -> None:
    """``[glong]``: gemma2-9b at full width (``[gserve]``'s params, at
    :data:`GEMMA_LAYERS` of its 42 layers), one prompt of 8,192 tokens through ``Engine.generate`` with
    16 new tokens at ``s_max`` 8,208 (every attention layer's prefill
    through the blocked path): prefill ms, decode ms a token, peak
    memory.  Then the gate at float32 (TF32 off), per layer: one
    ``attn_forward`` of an ``attn_sw`` and one of an ``attn`` layer at S
    = 8,192 against the plain ``_sdpa`` on the same q, k and v, within
    :data:`GLONG_TOL` · max|plain|."""
    import numpy as np

    from repro_torch.models import attention as attn
    from repro_torch.serve import Engine

    cfg = model.cfg
    S, n_new, s_max = GLONG["prompt"], GLONG["new"], GLONG["s_max"]
    assert S >= attn.BLOCKED_THRESHOLD
    rng = np.random.default_rng(2)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, S))).to(
        device=DEVICE, dtype=torch.int32)
    engine = Engine(model, s_max=s_max)
    _reset_peak(torch)
    reset_counts()
    t0 = time.perf_counter()
    ids = engine.generate(params, prompt, n_new)
    _sync(torch)
    gen_s = time.perf_counter() - t0
    peak = _peak_gb(torch)
    if counts() != only():
        raise AssertionError(f"[glong] generate launched {counts()}")
    assert ids.shape == (1, n_new) and ((ids >= 0)
                                        & (ids < cfg.vocab_size)).all()
    _reset_peak(torch)
    t0 = time.perf_counter()
    logits, caches = engine.prefill(params, prompt)
    _sync(torch)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_peak = _peak_gb(torch)
    assert bool(torch.isfinite(logits).all()), "prefill logits not finite"
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    if int(tok[0, 0]) != int(ids[0, 0]):
        raise AssertionError(f"[glong] prefill's greedy id {int(tok[0, 0])}"
                             f" is not generate's first {int(ids[0, 0])}")
    del logits
    pos = torch.full((1,), S, dtype=torch.int32, device=DEVICE)
    _sync(torch)
    t0 = time.perf_counter()
    for i in range(n_new):
        out, caches = engine.decode_step(params, caches, tok, pos + i)
        tok = torch.argmax(out, dim=-1).to(torch.int32)[:, None]
    _sync(torch)
    decode_ms = (time.perf_counter() - t0) * 1e3 / n_new
    del caches, out
    torch.cuda.empty_cache()
    print(f"[glong] {cfg.name} Engine.generate B=1 S={S} +{n_new} greedy, "
          f"s_max {s_max} (attention through the blocked path: "
          f"{S // attn._Q_CHUNK} query chunks of {attn._Q_CHUNK} a layer): "
          f"{gen_s * 1e3:.1f} ms in all, peak memory {peak:.2f} GB; prefill "
          f"alone {prefill_ms:.1f} ms ({S / prefill_ms * 1e3:.0f} prompt "
          f"tokens/s, peak {prefill_peak:.2f} GB), decode {decode_ms:.2f} "
          f"ms/token; no kernel launched", flush=True)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    positions = torch.arange(S, device=DEVICE)[None]
    for j, (kind, _) in enumerate(cfg.pattern):
        layer = {k: v[0][None] for k, v in
                 params["stack"]["scan"][f"entry_{j}"]["mixer"].items()}
        x = torch.randn((1, 1, S, cfg.d_model), generator=gen,
                        device=DEVICE)
        q, k, v = attn._project_qkv(layer, cfg32, x, positions)
        qg = q.reshape(1, 1, S, cfg.n_kv_heads,
                       cfg.n_heads // cfg.n_kv_heads, -1)
        window = attn._window(cfg32, kind)
        scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
        _reset_peak(torch)
        t0 = time.perf_counter()
        blocked = attn._sdpa_blocked(qg, k, v, positions, positions,
                                     causal=True, window=window, scale=scale,
                                     cap=cfg.attn_logit_softcap)
        _sync(torch)
        blocked_ms = (time.perf_counter() - t0) * 1e3
        blocked_peak = _peak_gb(torch)
        full, _ = attn.attn_forward(layer, cfg32, x, layer_kind=kind)
        _reset_peak(torch)
        t0 = time.perf_counter()
        mask = attn.attention_mask(positions, positions, causal=True,
                                   window=window)
        plain = attn._sdpa(qg, k, v, mask, scale=scale,
                           cap=cfg.attn_logit_softcap)
        _sync(torch)
        plain_ms = (time.perf_counter() - t0) * 1e3
        plain_peak = _peak_gb(torch)
        ref = float(plain.abs().max())
        err = float((blocked - plain).abs().max())
        err_fwd = float((full - attn._out(layer, plain, x)).abs().max())
        ref_fwd = float(full.abs().max())
        del q, k, v, qg, mask, blocked, plain, full, x
        torch.cuda.empty_cache()
        print(f"[glong] float32 {kind} layer at S={S}: blocked vs plain "
              f"_sdpa max abs err {err:.3e} (max|plain| {ref:.4f}, gate "
              f"{GLONG_TOL:g}·max); attn_forward (blocked route) vs the "
              f"plain output projected {err_fwd:.3e} (max {ref_fwd:.4f}); "
              f"blocked {blocked_ms:.1f} ms peak {blocked_peak:.2f} GB, "
              f"plain {plain_ms:.1f} ms peak {plain_peak:.2f} GB",
              flush=True)
        if not (err <= GLONG_TOL * ref and err_fwd <= GLONG_TOL * ref_fwd):
            raise AssertionError(f"[glong] {kind}: blocked attention "
                                 f"{err:.3e} / {err_fwd:.3e} from the plain")


def encoder_cross_check(torch) -> None:
    """``[encx]``: bert-large and hubert-xlarge at their reduced configs,
    float32, 4 nodes, LAMB with 2 microbatches: the step-0 grads (the
    step's own gradient phase, ``train.step.build_grad_fn``), the step's
    loss and the params after one Trainer step, card against CPU
    from the same weights, each within :data:`ENCX_TOL` · max|cpu|
    (cuBLAS and the CPU's BLAS sum in other orders; TF32 off)."""
    from repro_torch import interop
    from repro_torch.train import Trainer
    from repro_torch.train.state import stack_for_nodes
    from repro_torch.train.step import build_grad_fn
    from repro_torch.tree import tree_leaves

    for arch in ("bert-large", "hubert-xlarge"):
        tcfg = _bert_config(microbatches=2, steps=1, arch=arch,
                            reduced=True)
        host = None
        out = {}
        for dev in ("cuda", "cpu"):
            tr = Trainer(tcfg, n_nodes=BERT["n"], with_consensus=True,
                         device=dev)
            if host is None:
                host = interop.to_numpy(tr.model.init(
                    torch.Generator().manual_seed(1), "cpu"))
            params = interop.from_numpy(host, dev)
            grads, _ = build_grad_fn(tr.model, tcfg)(
                stack_for_nodes(params, BERT["n"]), tr.device_batch(0))
            state = tr.run(tr.init_state(params=params), steps=1)
            out[dev] = (tr.history[-1]["loss"],
                        [g.cpu() for g in tree_leaves(grads)],
                        [p.cpu() for p in tree_leaves(state.params)])
        worst = {}
        for i, what in ((1, "grads"), (2, "params")):
            worst[what] = max(
                float((a - b).abs().max()) / max(float(b.abs().max()),
                                                 1e-30)
                for a, b in zip(out["cuda"][i], out["cpu"][i]))
        loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
        print(f"[encx] {tcfg.model.name} fp32, LAMB, microbatches=2, cuda "
              f"vs cpu: loss {out['cuda'][0]:.6f} vs {out['cpu'][0]:.6f} "
              f"(rel {loss_rel:.2e}), grads within {worst['grads']:.3e} "
              f"and params after one step within {worst['params']:.3e} of "
              f"max|cpu| (each leaf)", flush=True)
        if not (loss_rel <= ENCX_TOL and max(worst.values()) <= ENCX_TOL):
            raise AssertionError(f"[encx] {arch}: loss {loss_rel:.3e}, "
                                 f"{worst}")


# ---------------------------------------------------------------------------
# Slice 13: MoE, MLA and prefix patterns (A.8): deepseek-v2-lite-16b served
# at full published size, qwen3-moe-30b-a3b at full width, and training a
# MoE model through the Trainer
# ---------------------------------------------------------------------------
DS_ARCH = "deepseek-v2-lite-16b"
DS_PARAMS = 15_706_484_224          # the reference's init (jax.eval_shape)
# (B, prompt, new tokens, s_max) of Engine.generate, the BatchedServer's
# (prompt lengths, slots, new tokens each), and the (B, S) of decode_gate
DSSERVE = dict(gen=(4, 1024, 16, 1056), server=((6, 100, 480), 4, 16),
               gate=(2, 256))
DSLONG = dict(prompt=8192, new=16, s_max=8208)
DSLONG_TOL = 1e-5                   # blocked vs plain MLA, of max|plain|
QMOE_ARCH = "qwen3-moe-30b-a3b"
QMOE_LAYERS = 4                     # of its 48, at full width
QMOE = dict(gen=(4, 1024, 16, 1056), gate=(2, 256), n_layers=QMOE_LAYERS)
QMOE_ORACLE = (2, 64)               # (B, S) of apply_moe vs the dense oracle
QMOE_DISPATCH = (4096, 0.5)         # tokens, capacity factor: drops
QMOE_TOL = (2e-5, 1e-3)             # apply_moe vs the dense oracle, fp32:
                                    # tests/test_moe.py's atol, rtol
# the Trainer on deepseek-v2-lite at full width, the dense prefix layer +
# one MoE layer: n = 2 with AdamW.  At n = 4 with SGD (Nesterov) the
# optimizer phase holds five copies of the 17.4 GB stack (params, momentum,
# grads, the new params and momentum), more than the card has
MOETRAIN = dict(n=2, H=3, per_node=1, seq=512, steps=6, n_layers=2,
                optimizer="adamw", lr=3e-4)
MOEX_TOL = 1e-5                     # card vs CPU, of max|cpu|
MOEX_NODES = 4
MOEX_DEVICES = ("cuda", "cpu")      # card, then the reference run


def run_ds_path(torch) -> None:
    """``[dsserve]`` and ``[dslong]``: deepseek-v2-lite-16b at its full
    published size (27 layers: the dense prefix layer and 26 MoE layers,
    MLA with the latent cache; 15,706,484,224 fp32 params from seed 0),
    bf16 compute, one replica.  ``[dsserve]``: :func:`run_dense_serve_path`
    at :data:`DSSERVE` (the init timed; ``Engine.generate`` with the
    prefill's drop_frac and decode ms a token against its floor, profiled
    as ``[dsprofile]``; ``BatchedServer`` on mixed prompts;
    :func:`decode_gate` at float32 drop-free), the params held to the
    62.83 GB reckoning.  ``[dslong]`` on the same params: one 8,192-token
    prompt through ``Engine.generate`` (every layer's prefill attention
    through ``_mla_attend_blocked``), prefill ms and peak; then, the model
    freed, :func:`mla_blocked_gate`."""
    import numpy as np

    from repro_torch.models import attention as attn
    from repro_torch.serve import Engine
    from repro_torch.tree import tree_leaves

    tag = "[dsserve]"
    model, params = run_dense_serve_path(torch, tag, DS_ARCH, **DSSERVE,
                                         profile_tag="[dsprofile]")
    cfg = model.cfg
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"{tag} params {n_params * 4 / 1e9:.2f} GB against the "
          f"{DS_PARAMS * 4 / 1e9:.2f} GB reckoning (the reference's init, "
          f"fp32)", flush=True)
    if n_params != DS_PARAMS:
        raise AssertionError(f"{tag} {n_params:,} params, expected "
                             f"{DS_PARAMS:,}")
    if DEVICE == "cuda":
        torch.cuda.empty_cache()

    # [dslong]: the blocked MLA path through the engine
    rng = np.random.default_rng(1)
    S, n_new, s_max = DSLONG["prompt"], DSLONG["new"], DSLONG["s_max"]
    assert S >= attn.BLOCKED_THRESHOLD
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, S))).to(
        device=DEVICE, dtype=torch.int32)
    engine = Engine(model, s_max=s_max)
    _reset_peak(torch)
    reset_counts()
    t0 = time.perf_counter()
    ids = engine.generate(params, prompt, n_new)
    _sync(torch)
    gen_s = time.perf_counter() - t0
    peak = _peak_gb(torch)
    if counts() != only():
        raise AssertionError(f"[dslong] generate launched {counts()}")
    assert ids.shape == (1, n_new) and ((ids >= 0)
                                        & (ids < cfg.vocab_size)).all()
    _reset_peak(torch)
    with moe_metrics() as rec:
        t0 = time.perf_counter()
        logits, caches = engine.prefill(params, prompt)
        _sync(torch)
        prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_peak = _peak_gb(torch)
    assert bool(torch.isfinite(logits).all()), "prefill logits not finite"
    if int(torch.argmax(logits[0])) != int(ids[0, 0]):
        raise AssertionError("[dslong] prefill's greedy id is not "
                             "generate's first")
    cache_gb = sum(t.numel() * t.element_size() for t in
                   tree_leaves(caches)) / 1e9
    del logits, caches
    print(f"[dslong] {cfg.name} Engine.generate B=1 S={S} +{n_new} greedy, "
          f"s_max {s_max} (MLA through the blocked path: "
          f"{-(-S // attn._Q_CHUNK)} query chunks of {attn._Q_CHUNK} a layer,"
          f" the latent expanded once): {gen_s * 1e3:.1f} ms in all, peak "
          f"memory {peak:.2f} GB; prefill alone {prefill_ms:.1f} ms "
          f"({S / prefill_ms * 1e3:.0f} prompt tokens/s, peak "
          f"{prefill_peak:.2f} GB, latent cache {cache_gb:.3f} GB; "
          f"{_drop_summary(rec.drops())}); no kernel launched", flush=True)

    # one layer's blocked MLA against the plain, the model freed first
    layer = {k: v[0][None].clone() for k, v in
             params["stack"]["scan"]["entry_0"]["mixer"].items()}
    del params, model, engine
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    mla_blocked_gate(torch, cfg, layer, S)


def mla_blocked_gate(torch, cfg, layer, S: int) -> None:
    """``[dslong]``'s gate: one MLA layer (``layer``, one node's mixer
    params) at float32 (TF32 off) on S random rows, ``_mla_attend_blocked``
    against the plain ``_mla_attend`` on the same inputs within
    :data:`DSLONG_TOL` · max|plain|, and ``attn_forward`` (the blocked
    route) bitwise the blocked call.  Reported beside it, why the two
    are not bitwise: the blocked call with one chunk of all S rows against
    the plain, and each of the chunk's three fp32 products (the logits
    ``q_nope·k_nope``, ``probs·v``, the ``w_o`` projection) on the first
    :data:`attention._Q_CHUNK` rows alone against the same rows of the
    product over all S rows, on random inputs of the layer's shapes."""
    from repro_torch.models import attention as attn

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    x = torch.randn((1, 1, S, cfg.d_model), generator=gen, device=DEVICE)
    positions = torch.arange(S, device=DEVICE)[None]
    q_nope, q_rope, c_kv, k_rope = attn._mla_qkv(layer, cfg32, x, positions)

    def blocked(chunk=attn._Q_CHUNK):
        return attn._mla_attend_blocked(layer, cfg32, q_nope, q_rope, c_kv,
                                        k_rope, positions, positions,
                                        causal=True, chunk=chunk)

    _reset_peak(torch)
    t0 = time.perf_counter()
    out = blocked()
    _sync(torch)
    blocked_ms = (time.perf_counter() - t0) * 1e3
    blocked_peak = _peak_gb(torch)
    full, _ = attn.attn_forward(layer, cfg32, x, layer_kind="attn")
    err_fwd = float((full - out).abs().max())
    del full
    _reset_peak(torch)
    t0 = time.perf_counter()
    mask = attn.attention_mask(positions, positions, causal=True,
                               window=None)
    plain = attn._mla_attend(layer, cfg32, q_nope, q_rope, c_kv, k_rope,
                             mask)
    _sync(torch)
    plain_ms = (time.perf_counter() - t0) * 1e3
    plain_peak = _peak_gb(torch)
    ref = float(plain.abs().max())
    err = float((out - plain).abs().max())
    del out, mask
    err_one = float((blocked(chunk=S) - plain).abs().max())
    del plain
    c, m = attn._Q_CHUNK, cfg.mla
    nh = cfg.n_heads
    a = torch.randn((1, 1, S, nh, m.nope_head_dim), generator=gen,
                    device=DEVICE)
    k = torch.randn((1, 1, S, nh, m.nope_head_dim), generator=gen,
                    device=DEVICE)
    p = torch.rand((1, 1, nh, S, S), generator=gen, device=DEVICE)
    v = torch.randn((1, 1, S, nh, m.v_head_dim), generator=gen,
                    device=DEVICE)
    h = torch.randn((1, 1, S, nh, m.v_head_dim), generator=gen,
                    device=DEVICE)
    # (equation, lhs, rhs, the query axis of lhs, of the product)
    products = {
        "logits": ("nbqhd,nbkhd->nbhqk", a, k, 2, 3),
        "probs·v": ("nbhqk,nbkhd->nbqhd", p, v, 3, 2),
        "w_o": ("nbqhd,nhdo->nbqo", h, layer["w_o"], 2, 2)}
    gaps = {}
    for name, (eq, lhs, rhs, ax_in, ax_out) in products.items():
        whole = torch.einsum(eq, lhs, rhs).narrow(ax_out, 0, c)
        part = torch.einsum(eq, lhs.narrow(ax_in, 0, c), rhs)
        gaps[name] = (float((whole - part).abs().max()),
                      float(whole.abs().max()))
        del whole, part
    del a, k, p, v, h, x, q_nope, q_rope, c_kv, k_rope
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    print(f"[dslong] float32 MLA layer at S={S}: blocked vs plain "
          f"_mla_attend max abs err {err:.3e} (max|plain| {ref:.4f}, gate "
          f"{DSLONG_TOL:g}·max); attn_forward (the blocked route) vs the "
          f"blocked call {err_fwd:.3e}; blocked {blocked_ms:.1f} ms peak "
          f"{blocked_peak:.2f} GB, plain {plain_ms:.1f} ms peak "
          f"{plain_peak:.2f} GB", flush=True)
    print(f"[dslong] why not bitwise: blocked with one chunk of {S} rows vs "
          f"plain {err_one:.3e}; the first {c} rows alone vs the same rows "
          f"of the product over {S} (max abs err, max|whole|): "
          + ", ".join(f"{name} {g:.3e} ({r:.4f})"
                      for name, (g, r) in gaps.items()), flush=True)
    if not (err <= DSLONG_TOL * ref and err_fwd == 0.0):
        raise AssertionError(f"[dslong] blocked MLA {err:.3e} from the "
                             f"plain, attn_forward {err_fwd:.3e}")


def run_qmoe_path(torch) -> None:
    """``[qmoe]``: qwen3-moe-30b-a3b at full width (d 2,048, 32 heads, GQA
    kv 4, qk-norm, 128 experts top-8, vocab 151,936) and
    :data:`QMOE_LAYERS` of its 48 layers, fp32 params from seed 0, bf16
    compute: :func:`run_dense_serve_path` at :data:`QMOE` (prefill with
    its drop_frac, decode, the decode gate at float32 drop-free); then on
    layer 0's MoE params at float32 (TF32 off): ``apply_moe`` drop-free
    against ``apply_moe_dense_reference`` elementwise within
    :data:`QMOE_TOL` on :data:`QMOE_ORACLE` tokens, and
    ``_build_dispatch`` on the card bitwise the port's CPU result on the
    same routing of :data:`QMOE_DISPATCH` tokens at a capacity that drops
    (expert 0's first slot the sentinel)."""
    from repro_torch.models import moe as moe_lib

    tag = "[qmoe]"
    model, params = run_dense_serve_path(torch, tag, QMOE_ARCH, **QMOE)
    cfg = model.cfg
    ffn = {k: v[0][None] for k, v in
           params["stack"]["scan"]["entry_0"]["ffn"].items()}
    del params, model
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    m = cfg.moe
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    B, S = QMOE_ORACLE
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    x = torch.randn((1, B, S, cfg.d_model), generator=gen, device=DEVICE)
    out, met = moe_lib.apply_moe(ffn, cfg32, x,
                                 capacity_factor=float(m.n_routed))
    want = moe_lib.apply_moe_dense_reference(ffn, cfg32, x)
    atol, rtol = QMOE_TOL
    ratio = float(((out - want).abs() / (atol + rtol * want.abs())).max())
    drop = float(met["drop_frac"][0])
    print(f"{tag} apply_moe (sort dispatch, capacity_factor {m.n_routed}) "
          f"vs apply_moe_dense_reference at float32 on layer 0, x {B}x{S}: "
          f"max abs err {float((out - want).abs().max()):.3e} (max|ref| "
          f"{float(want.abs().max()):.4e}), worst ratio to {atol:g} + "
          f"{rtol:g}·|ref| {ratio:.4f} (gated), drop_frac {drop}",
          flush=True)
    if not (ratio <= 1.0 and drop == 0.0):
        raise AssertionError(f"{tag} apply_moe vs the dense oracle: ratio "
                             f"{ratio}, drop_frac {drop}")
    T, cf = QMOE_DISPATCH
    xt = torch.randn((1, 1, T, cfg.d_model), generator=gen, device=DEVICE)
    top_w, top_idx, _ = moe_lib.route(ffn, m, xt)
    top_w, top_idx = top_w[0, 0], top_idx[0, 0]
    C = moe_lib.expert_capacity(m, T, cf)
    dev = moe_lib._build_dispatch(top_idx, top_w, m.n_routed, C, T)
    host = moe_lib._build_dispatch(top_idx.cpu(), top_w.cpu(), m.n_routed,
                                   C, T)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(dev[:2], host[:2]))
    same = same and float(dev[2]) == float(host[2])
    dispatch_ms = (cuda_ms(torch, lambda: moe_lib._build_dispatch(
        top_idx, top_w, m.n_routed, C, T), iters=10)
        if DEVICE == "cuda" else float("nan"))
    print(f"{tag} _build_dispatch T={T} E={m.n_routed} k={m.top_k} C={C} "
          f"(capacity_factor {cf}): card vs CPU tables and drop_frac "
          f"{'bitwise equal' if same else 'DIFFER'}; drop_frac "
          f"{float(dev[2]):.4f}, expert 0's first slot token "
          f"{int(dev[0][0, 0])} weight {float(dev[1][0, 0])} (the sentinel "
          f"{T} when anything drops); {dispatch_ms:.3f} ms on the card",
          flush=True)
    if not (same and float(dev[2]) > 0.0 and int(dev[0][0, 0]) == T):
        raise AssertionError(f"{tag} _build_dispatch card vs CPU: equal "
                             f"{same}, drop_frac {float(dev[2])}")


def _train_config(cfg, *, H: int, per_node: int, seq: int, steps: int,
                  n: int, optimizer: str, lr: float):
    """The Trainer on ``cfg``: Gossip-PGA over one_peer_exp on the fused
    kernel, the optimizer with Nesterov momentum 0.9 where it has
    momentum, warmup_cosine over ``steps + 2``."""
    from repro_torch.configs import (DistConfig, OptimizerConfig,
                                     TrainConfig)
    return TrainConfig(
        model=cfg,
        dist=DistConfig(algorithm="gossip_pga", topology="one_peer_exp",
                        H=H, comm_backend="pallas"),
        optimizer=OptimizerConfig(name=optimizer, lr=lr, momentum=0.9,
                                  nesterov=True, schedule="warmup_cosine",
                                  warmup_steps=2, total_steps=steps + 2),
        global_batch=per_node * n, seq_len=seq, steps=steps,
        log_every=1)


def _moetrain_config():
    """``[moetrain]``'s Trainer: deepseek-v2-lite at full width and
    :data:`MOETRAIN`'s ``n_layers`` (the dense prefix layer + one MoE
    layer), bf16 compute, ``per_node`` sequences of ``seq`` a node."""
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get_model_config(DS_ARCH),
                              n_layers=MOETRAIN["n_layers"])
    return _train_config(cfg, **{k: MOETRAIN[k] for k in (
        "H", "per_node", "seq", "steps", "n", "optimizer", "lr")})


def run_moetrain_path(torch, mc) -> dict:
    """``[moetrain]``: the Trainer on deepseek-v2-lite at full width with
    the dense prefix layer and one MoE layer (64 routed experts top-6, 2
    shared, MLA), fp32 params from seed 0, bf16 compute, n =
    ``MOETRAIN["n"]`` stacked nodes, Gossip-PGA H = 3 over one_peer_exp
    with the fused consensus round (B.1 on every round), AdamW (at n = 2
    one_peer_exp's gossip round is the exact average), 1 sequence of 512
    a node, 6 steps.  Gates: finite losses,
    consensus exactly 0.0 on the global steps, mix.cu's launches equal to
    the dispatch groups × steps, all on the register instance (n = 2,
    each launch bitwise the generic instance's: :class:`GenericShadow`),
    and nothing else launched, one
    synchronizing call on the steady steps (the MoE dispatch adds none).
    Reports the step ms, tokens/s, peak, and the last step's ``lb_loss``
    and ``drop_frac`` per node.  Returns the launches."""
    from repro_torch.train import Trainer
    from repro_torch.tree import tree_leaves

    tag, steps, n = "[moetrain]", MOETRAIN["steps"], MOETRAIN["n"]
    tcfg = _moetrain_config()
    tr = Trainer(tcfg, n_nodes=n, with_consensus=True, device=DEVICE)
    _reset_peak(torch)
    t0 = time.perf_counter()
    params = tr.model.init(torch.Generator().manual_seed(0), DEVICE)
    _sync(torch)
    init_s = time.perf_counter() - t0
    n_params = _init_line(torch, tag, tr.model, params, init_s)
    state = tr.init_state(params=params)
    del params
    leaves = tree_leaves(state.params)
    groups = mc._dispatch_groups(leaves, tcfg.dist.pallas_leaf_threshold)
    widths = [sum(leaves[i][0].numel() for i in g) for g in groups]
    del leaves
    print(f"{tag} {tcfg.model.name} at full width, {tcfg.model.n_layers} "
          f"layers {list(tcfg.model.layers)}: {n_params:,} params a replica "
          f"({n_params * 4 / 1e9:.3f} GB fp32; init {init_s:.1f} s), bf16 "
          f"compute, {n} nodes, Gossip-PGA H={tcfg.dist.H} over "
          f"{tcfg.dist.topology}, {MOETRAIN['optimizer']} (lr "
          f"{MOETRAIN['lr']}), "
          f"{MOETRAIN['per_node']} sequence of {MOETRAIN['seq']} a node; "
          f"state {_state_bytes(state) / 1e9:.2f} GB; {len(groups)} mix "
          f"launches a round (group widths {widths})", flush=True)
    tokens = tcfg.global_batch * tcfg.seq_len
    _reset_peak(torch)
    reset_counts()
    times, phases, syncs = [], [], []
    shadow = GenericShadow(torch, mc)
    for k in range(steps):
        t0 = time.perf_counter()
        with moe_metrics() as rec, shadow:
            state, n_sync = sync_steps(
                torch, lambda: tr.run(state, steps=1, log_every=1),
                step_sites(tag, k))
        _sync(torch)
        dt = time.perf_counter() - t0
        times.append(dt)
        syncs.append(n_sync)
        entry = tr.history[-1]
        phases.append(entry["phase"])
        print(f"{tag} step {k} phase={entry['phase']} "
              f"loss={entry['loss']:.4f} lr={entry['lr']:.3e} "
              f"consensus={entry['consensus']:.6e} step_ms={dt * 1e3:.1f} "
              f"tokens/s={tokens / dt:.0f} max_mem_GB={_peak_gb(torch):.2f} "
              f"synchronizing_calls={n_sync}", flush=True)
        if not math.isfinite(entry["loss"]):
            raise AssertionError(f"{tag} step {k}: loss {entry['loss']}")
        if entry["phase"] == "global":
            assert entry["consensus"] == 0.0, entry
    launches = counts()
    if (launches != only(mix_vector=len(groups) * steps)
            or phases.count("global") != 2):
        raise AssertionError(f"{tag} launches {launches}, expected "
                             f"{len(groups) * steps} of mix.cu's register "
                             f"instance and no generic one; phases {phases}")
    print(f"{tag} {shadow.check(tag)} (the steps' times include the "
          f"generic launches and the comparisons)", flush=True)
    SYNCS[tag] = syncs
    gate_one_sync(tag, syncs)
    steady = statistics.median(times[1:])
    STEADY[tag] = steady
    first = rec.calls[0]
    print(f"{tag} {steps} steps, {phases.count('gossip')} gossip and "
          f"{phases.count('global')} global fused rounds through mix.cu "
          f"({launches['mix_vector']} launches of the register instance, "
          f"{launches['mix']} of the generic); steady step "
          f"{steady * 1e3:.1f} ms (median of steps 1-5), "
          f"{tokens / steady:.0f} tokens/s, peak memory {_peak_gb(torch):.2f}"
          f" GB; the last step's MoE layer per node: lb_loss "
          f"{[round(v, 6) for v in first['lb_loss'].tolist()]}, drop_frac "
          f"{[round(v, 6) for v in first['drop_frac'].tolist()]}",
          flush=True)
    if DEVICE == "cuda":
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.run(state, steps=1, log_every=1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        profile_report(prof, wall_ms, "[mtprofile]",
                       "one profiled [moetrain] step")
        del prof
    del state, tr
    return launches


# ---------------------------------------------------------------------------
# Slice 14: Mamba and the hybrid family (jamba-1.5-large at full width),
# the VLM stub (llava-next-mistral-7b at full published size), the Trainer
# on the hybrid family, and both card against CPU
# ---------------------------------------------------------------------------
JAMBA_ARCH = "jamba-1.5-large-398b"
# one layer of each of jamba's block kinds at full width (bf16 params): its
# 8-layer pattern is 90.48 GB, more than the card holds
JSERVE_PATTERN = (("mamba", "dense"), ("mamba", "moe"), ("attn", "dense"))
JSERVE_PARAMS = 12_937_224_192      # the reference's init (jax.eval_shape)
JSERVE = dict(gen=(2, 1024, 16, 1040), server=((6, 100, 480), 4, 16),
              gate=(2, 256), n_layers=3, pattern=JSERVE_PATTERN)
MAMBA_X = (1, 256)                  # (B, S) of one Mamba layer card vs CPU
MAMBA_X_TOL = 1e-4                  # of max|cpu|, float32 (TF32 off)
LLAVA_ARCH = "llava-next-mistral-7b"
LLAVA_PARAMS = 7_241_732_096
LVSERVE = dict(gen=(4, 1024, 32, 1056), server=((6, 100, 480), 4, 16),
               gate=(2, 256))
LVLOSS = dict(B=1, S=4096)          # 2,880 image positions, 1,216 text
LVLOSS_TOL = 1e-6                   # Model.loss vs the text positions' mean
# the Trainer on the hybrid family at full width, n = 2, SGD with momentum
# (its bf16 state is zeros_like; AdamW's fp32 m and v would double it), one
# (mamba, dense) layer: with an (attn, dense) layer beside it (2.85e9
# params) the optimizer phase peaked at 65.56 GB allocated, and each of
# three runs on an H100 ran out of memory within 7 steps with 24-29 GB
# reserved but unallocated
JTRAIN = dict(n=2, H=3, per_node=1, seq=512, steps=6, n_layers=1,
              pattern=(("mamba", "dense"),), optimizer="sgd", lr=0.01)
JTRAIN_PARAMS = 2_098_077_696
BF16_SCAN_TOL = 2e-2                # card vs CPU with the bf16 scan


def _init_line(torch, tag: str, model, params, init_s: float) -> int:
    """The init's params, bytes and rate beside the host's cores and the
    draw pool; returns the count."""
    from repro_torch.models import layers
    from repro_torch.tree import tree_leaves
    leaves = tree_leaves(params)
    n_params = sum(p.numel() for p in leaves)
    nbytes = sum(p.numel() * p.element_size() for p in leaves)
    print(f"{tag} init of {n_params:,} params ({nbytes / 1e9:.2f} GB "
          f"{model.cfg.param_dtype}) in {init_s:.1f} s: "
          f"{n_params / init_s / 1e6:.0f}e6 params/s drawn on the host and "
          f"copied ({os.cpu_count()} host cores, a pool of "
          f"{layers.INIT_THREADS} threads, pieces of {layers.INIT_PIECE})",
          flush=True)
    return n_params


def mamba_layer_gate(torch, tag: str, cfg, mixer) -> None:
    """One Mamba layer's ``mamba_forward`` at full width on the card
    against the port's CPU result on the same inputs, float32 compute (the
    bf16 params widened exactly, TF32 off), at :data:`MAMBA_X`: the output
    and the final state within :data:`MAMBA_X_TOL` · max|cpu|."""
    from repro_torch.models import ssm as ssm_lib

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    B, S = MAMBA_X
    gen = torch.Generator().manual_seed(14)
    x = 0.5 * torch.randn((1, B, S, cfg.d_model), generator=gen)
    host = {k: v.detach().to("cpu", torch.float32) for k, v in mixer.items()}
    card = {k: v.to(torch.float32) for k, v in mixer.items()}
    _sync(torch)
    t0 = time.perf_counter()
    got, gstate = ssm_lib.mamba_forward(card, cfg32, x.to(DEVICE))
    _sync(torch)
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want, wstate = ssm_lib.mamba_forward(host, cfg32, x)
    cpu_s = time.perf_counter() - t0
    worst = {}
    for name, a, b in (("out", got, want), ("h", gstate["h"], wstate["h"]),
                       ("conv", gstate["conv"], wstate["conv"])):
        worst[name] = float((a.cpu() - b).abs().max()) / max(
            float(b.abs().max()), 1e-30)
    di, N, _ = ssm_lib._mamba_dims(cfg)
    print(f"{tag} one Mamba layer (d_inner {di}, N {N}) mamba_forward at "
          f"float32 on {B}x{S}, card vs CPU: out within {worst['out']:.3e}, "
          f"h {worst['h']:.3e}, conv {worst['conv']:.3e} of max|cpu| (gated "
          f"at {MAMBA_X_TOL:g}); card {card_ms:.1f} ms (first call), CPU "
          f"{cpu_s:.2f} s", flush=True)
    if not max(worst.values()) <= MAMBA_X_TOL:
        raise AssertionError(f"{tag} Mamba layer card vs CPU: {worst}")


def run_jserve_path(torch) -> None:
    """``[jserve]``: jamba-1.5-large at full width (d 8,192, d_inner 16,384,
    N 16, 64 heads GQA kv 8, 16 experts top-2 of d_ff 24,576, vocab 65,536)
    with one layer of each of its block kinds, :data:`JSERVE_PATTERN`
    (12,937,224,192 bf16 params from seed 0), bf16 compute, one replica:
    :func:`run_dense_serve_path` at :data:`JSERVE` (the init timed with its
    rate; ``Engine.generate`` 2 × 1,024 + 16 with the prefill's drop_frac
    and peak, decode against its floor; a
    4-slot ``BatchedServer``; :func:`decode_gate` at float32 drop-free),
    then :func:`mamba_layer_gate` on layer 0's Mamba mixer."""
    from repro_torch.tree import tree_leaves

    tag = "[jserve]"
    _reset_peak(torch)
    model, params = run_dense_serve_path(torch, tag, JAMBA_ARCH, **JSERVE)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"{tag} params {n_params * 2 / 1e9:.2f} GB against the "
          f"{JSERVE_PARAMS * 2 / 1e9:.2f} GB reckoning (the reference's "
          f"init, bf16)", flush=True)
    if n_params != JSERVE_PARAMS:
        raise AssertionError(f"{tag} {n_params:,} params, expected "
                             f"{JSERVE_PARAMS:,}")
    mixer = {k: v[0][None].clone() for k, v in
             params["stack"]["scan"]["entry_0"]["mixer"].items()}
    cfg = model.cfg
    del params, model
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    mamba_layer_gate(torch, tag, cfg, mixer)


def run_lvserve_path(torch) -> None:
    """``[lvserve]``: llava-next-mistral-7b at its full published size (32
    layers, 7,241,732,096 fp32 params from seed 0), bf16 compute, one
    replica: :func:`run_dense_serve_path` at :data:`LVSERVE` (token
    prompts: the engine takes tokens only, as the reference's).  Then
    ``[lvloss]`` on the same params: ``Model.loss`` under ``no_grad`` on
    one 4,096-token batch whose first 2,880 positions are patches (drawn
    on the card, × 0.02): its ms and peak; gated, that it equals the mean
    NLL of the 1,216 text positions taken from one forward's logits
    (within :data:`LVLOSS_TOL` relative), and that the text positions'
    logits differ from a token-only forward's (the patches are used)."""
    from repro_torch.tree import tree_leaves, tree_map

    tag = "[lvserve]"
    model, params = run_dense_serve_path(torch, tag, LLAVA_ARCH, **LVSERVE)
    cfg = model.cfg
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"{tag} params {n_params * 4 / 1e9:.2f} GB against the "
          f"{LLAVA_PARAMS * 4 / 1e9:.2f} GB reckoning (the reference's "
          f"init, fp32)", flush=True)
    if n_params != LLAVA_PARAMS:
        raise AssertionError(f"{tag} {n_params:,} params, expected "
                             f"{LLAVA_PARAMS:,}")
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    tag = "[lvloss]"
    v = cfg.vision
    n_img = v.n_tiles * v.patches_per_tile
    B, S = LVLOSS["B"], LVLOSS["S"]
    gen = torch.Generator(device=DEVICE).manual_seed(26)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    batch = {"inputs": toks, "targets": torch.roll(toks, -1, 1),
             "patches": 0.02 * torch.randn((B, n_img, cfg.d_model),
                                           generator=gen, device=DEVICE)}
    with torch.no_grad():
        model.loss(params, batch)
        _reset_peak(torch)
        t0 = time.perf_counter()
        loss, metrics = model.loss(params, batch)
        _sync(torch)
        loss_ms = (time.perf_counter() - t0) * 1e3
        peak = _peak_gb(torch)
        node = tree_map(lambda t: t[None], params)
        logits, _, _ = model.forward(node, tree_map(lambda t: t[None],
                                                    batch))
        logp = torch.log_softmax(logits[0, :, n_img:], dim=-1)
        nll = -torch.gather(logp, -1, batch["targets"][:, n_img:, None]
                            .long())[..., 0]
        want = float(nll.mean())
        plain, _, _ = model.forward(node, {"inputs": toks[None]})
        moved = float((plain[0, :, n_img:] - logits[0, :, n_img:]).abs()
                      .max())
        del logits, plain, logp, nll
    got = float(loss)
    rel = abs(got - want) / abs(want)
    print(f"{tag} {cfg.name} Model.loss (no_grad) on B={B} S={S}, the first "
          f"{n_img} positions patches: {loss_ms:.1f} ms "
          f"({B * S / loss_ms * 1e3:.0f} positions/s), peak {peak:.2f} GB; "
          f"loss {got:.6f} vs the mean NLL of the {S - n_img} text "
          f"positions {want:.6f} (rel {rel:.2e}, gated at {LVLOSS_TOL:g}); "
          f"text logits moved by the patches: max |Δ| {moved:.4e} against "
          f"a token-only forward (gated > 0)", flush=True)
    if not (math.isfinite(got) and rel <= LVLOSS_TOL and moved > 0.0):
        raise AssertionError(f"{tag} loss {got} vs {want}, moved {moved}")
    del params, model, batch


def _jtrain_config():
    """``[jtrain]``'s Trainer: jamba at full width with
    ``JTRAIN["pattern"]``, bf16 params and compute, SGD with Nesterov
    momentum."""
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get_model_config(JAMBA_ARCH),
                              n_layers=JTRAIN["n_layers"],
                              pattern=JTRAIN["pattern"])
    return _train_config(cfg, **{k: JTRAIN[k] for k in (
        "H", "per_node", "seq", "steps", "n", "optimizer", "lr")})


def run_jtrain_path(torch, mc) -> dict:
    """``[jtrain]``: the Trainer on jamba at full width with one Mamba
    layer and its dense FFN (2,098,077,696 bf16 params a replica from seed
    0),
    bf16 compute, n = 2 stacked nodes, Gossip-PGA H = 3 over one_peer_exp
    with the fused consensus round (B.1 on every round, the bf16 leaves
    packed to fp32), SGD with Nesterov momentum, 1 sequence of 512 a node,
    6 steps.  Gates: finite losses, consensus exactly 0.0 on the global
    steps, mix.cu's launches equal to the dispatch groups × steps, all on
    the register instance (n = 2, each bitwise the generic instance's:
    :class:`GenericShadow`), and nothing else launched, one synchronizing
    call on the steady steps (the Mamba scan adds none).  Reports the init
    rate, step ms, tokens/s and peak.  Returns the launches."""
    from repro_torch.train import Trainer
    from repro_torch.tree import tree_leaves

    tag, steps, n = "[jtrain]", JTRAIN["steps"], JTRAIN["n"]
    tcfg = _jtrain_config()
    tr = Trainer(tcfg, n_nodes=n, with_consensus=True, device=DEVICE)
    _reset_peak(torch)
    t0 = time.perf_counter()
    params = tr.model.init(torch.Generator().manual_seed(0), DEVICE)
    _sync(torch)
    n_params = _init_line(torch, tag, tr.model, params,
                          time.perf_counter() - t0)
    if n_params != JTRAIN_PARAMS:
        raise AssertionError(f"{tag} {n_params:,} params, expected "
                             f"{JTRAIN_PARAMS:,}")
    state = tr.init_state(params=params)
    del params
    leaves = tree_leaves(state.params)
    groups = mc._dispatch_groups(leaves, tcfg.dist.pallas_leaf_threshold)
    widths = [sum(leaves[i][0].numel() for i in g) for g in groups]
    del leaves
    print(f"{tag} {tcfg.model.name} at full width, {tcfg.model.n_layers} "
          f"layers {list(tcfg.model.layers)}: {n_params:,} params a replica "
          f"({n_params * 2 / 1e9:.3f} GB bf16), bf16 compute, {n} nodes, "
          f"Gossip-PGA H={tcfg.dist.H} over {tcfg.dist.topology}, SGD "
          f"(Nesterov momentum 0.9, lr {JTRAIN['lr']}), "
          f"{JTRAIN['per_node']} sequence of {JTRAIN['seq']} a node; state "
          f"{_state_bytes(state) / 1e9:.2f} GB; {len(groups)} mix launches "
          f"a round (group widths {widths})", flush=True)
    tokens = tcfg.global_batch * tcfg.seq_len
    _reset_peak(torch)
    reset_counts()
    times, phases, syncs = [], [], []
    shadow = GenericShadow(torch, mc)
    for k in range(steps):
        # the optimizer phase's fp32 temporaries (4 GiB for the embedding
        # leaf) fragment the cache: each step starts from an emptied one
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with shadow:
            state, n_sync = sync_steps(
                torch, lambda: tr.run(state, steps=1, log_every=1),
                step_sites(tag, k))
        _sync(torch)
        dt = time.perf_counter() - t0
        times.append(dt)
        syncs.append(n_sync)
        entry = tr.history[-1]
        phases.append(entry["phase"])
        print(f"{tag} step {k} phase={entry['phase']} "
              f"loss={entry['loss']:.4f} lr={entry['lr']:.3e} "
              f"consensus={entry['consensus']:.6e} step_ms={dt * 1e3:.1f} "
              f"tokens/s={tokens / dt:.0f} max_mem_GB={_peak_gb(torch):.2f} "
              f"reserved_GB={torch.cuda.memory_reserved() / 1e9:.2f} "
              f"synchronizing_calls={n_sync}", flush=True)
        if not math.isfinite(entry["loss"]):
            raise AssertionError(f"{tag} step {k}: loss {entry['loss']}")
        if entry["phase"] == "global":
            assert entry["consensus"] == 0.0, entry
    launches = counts()
    if (launches != only(mix_vector=len(groups) * steps)
            or phases.count("global") != 2):
        raise AssertionError(f"{tag} launches {launches}, expected "
                             f"{len(groups) * steps} of mix.cu's register "
                             f"instance and no generic one; phases {phases}")
    print(f"{tag} {shadow.check(tag)} (the steps' times include the "
          f"generic launches and the comparisons)", flush=True)
    SYNCS[tag] = syncs
    gate_one_sync(tag, syncs)
    steady = statistics.median(times[1:])
    STEADY[tag] = steady
    print(f"{tag} {steps} steps, {phases.count('gossip')} gossip and "
          f"{phases.count('global')} global fused rounds through mix.cu "
          f"({launches['mix_vector']} launches of the register instance, "
          f"{launches['mix']} of the generic, {len(groups)} a round as the "
          f"dispatch groups predict); steady step {steady * 1e3:.1f} ms "
          f"(median of steps 1-5, each from an emptied cache), "
          f"{tokens / steady:.0f} tokens/s, peak memory "
          f"{_peak_gb(torch):.2f} GB", flush=True)
    if DEVICE == "cuda":
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.empty_cache()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.run(state, steps=1, log_every=1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        profile_report(prof, wall_ms, "[jtprofile]",
                       "one profiled [jtrain] step")
        del prof
    del state, tr
    return launches


# (tag, arch, scan_dtype) of each reduced_cross_check run
MOEX_RUNS = (("[moex]", DS_ARCH, None), ("[moex]", QMOE_ARCH, None))
SLICE14X_RUNS = (("[hybx]", JAMBA_ARCH, "float32"),
                 ("[hybx]", JAMBA_ARCH, "bfloat16"),
                 ("[vlmx]", LLAVA_ARCH, None))


def reduced_cross_check(torch, runs) -> None:
    """``[moex]`` (deepseek-v2-lite, qwen3-moe), ``[hybx]`` (jamba, MoE
    included; then again with ``scan_dtype="bfloat16"``) and ``[vlmx]``
    (llava, with patches) at their reduced configs, float32, one init
    (seed 1) on the card and on the CPU: the two inits bitwise equal (the
    host draw is the same whatever the device); the forward's logits and
    ``lb_loss`` on node 0's 2 × 48 batch of the synthetic stream (llava's
    first 32 positions its patches); a prefill of 36 tokens and 4 decode
    steps through ``Engine``; one Trainer step (:data:`MOEX_NODES` nodes,
    Gossip-PGA H = 2, SGD at lr 0.05: a linear first step, where AdamW's
    ≈ lr·sign(g) would turn a rounding-level gradient into an lr-sized
    card/CPU difference) — its loss and the params after it; each within
    :data:`MOEX_TOL` · max|cpu| (cuBLAS and the CPU's BLAS sum in other
    orders; TF32 off), the bf16 scan within :data:`BF16_SCAN_TOL` (one
    bf16 rounding of inputs an ulp apart); the routing equal (every MoE
    call's drop_frac; reported, not gated, with the bf16 scan: a router
    near a tie may flip there)."""
    from repro_torch import configs, interop
    from repro_torch.serve import Engine
    from repro_torch.train import Trainer
    from repro_torch.tree import tree_leaves, tree_map

    for tag, arch, scan in runs:
        cfg = dataclasses.replace(configs.get_model_config(arch,
                                                           reduced=True),
                                  dtype="float32")
        if scan is not None:
            cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
                cfg.ssm, scan_dtype=scan))
        tcfg = _train_config(cfg, H=2, per_node=2, seq=48, steps=1,
                             n=MOEX_NODES, optimizer="sgd", lr=0.05)
        tol = BF16_SCAN_TOL if scan == "bfloat16" else MOEX_TOL
        out, inits, host = [], [], None
        for dev in MOEX_DEVICES:
            tr = Trainer(tcfg, n_nodes=MOEX_NODES, with_consensus=True,
                         device=dev)
            inits.append(tree_leaves(tr.model.init(
                torch.Generator().manual_seed(1), dev)))
            if host is None:
                host = interop.to_numpy(tr.model.init(
                    torch.Generator().manual_seed(1), "cpu"))
            params = interop.from_numpy(host, dev)
            batch = {k: v[:1] for k, v in tr.device_batch(0).items()}
            with moe_metrics() as rec:
                logits, _, lb = tr.model.forward(
                    tree_map(lambda t: t[None], params), batch)
            drops = rec.drops()
            eng = Engine(tr.model, s_max=48)
            toks = batch["inputs"][0]
            dec, caches = eng.prefill(params, toks[:, :36])
            decs = [dec]
            for t in range(4):
                pos = torch.full((toks.shape[0],), 36 + t,
                                 dtype=torch.int32, device=dev)
                dec, caches = eng.decode_step(params, caches,
                                              toks[:, 36 + t:37 + t], pos)
                decs.append(dec)
            state = tr.run(tr.init_state(params=params), steps=1)
            out.append((logits.cpu(), lb.cpu(),
                        torch.stack(decs, 1).cpu(), tr.history[-1]["loss"],
                        [p.cpu() for p in tree_leaves(state.params)],
                        drops))
        same_init = all(torch.equal(a.cpu(), b) for a, b in zip(*inits))
        card, ref = out
        worst = {}
        for i, what in ((0, "logits"), (1, "lb_loss"), (2, "decode")):
            worst[what] = float((card[i] - ref[i]).abs().max()) / max(
                float(ref[i].abs().max()), 1e-30)
        worst["params"] = max(
            float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for a, b in zip(card[4], ref[4]))
        loss_rel = abs(card[3] - ref[3]) / abs(ref[3])
        scan_note = f", scan {scan}" if scan is not None else ""
        print(f"{tag} {cfg.name} fp32{scan_note}, cuda vs cpu: init "
              f"bitwise {'equal' if same_init else 'DIFFERENT'}; logits "
              f"within {worst['logits']:.3e}, lb_loss "
              f"{worst['lb_loss']:.3e}, prefill + 4 decode steps "
              f"{worst['decode']:.3e} of max|cpu| (lb_loss "
              f"{card[1].tolist()}), drop_frac "
              f"{'equal' if card[5] == ref[5] else 'DIFFER'} {ref[5]}; one "
              f"Trainer step: loss {card[3]:.6f} vs {ref[3]:.6f} (rel "
              f"{loss_rel:.2e}), params within {worst['params']:.3e} of "
              f"max|cpu| (each leaf); gated at {tol:g}", flush=True)
        if not (same_init and max(worst.values()) <= tol
                and loss_rel <= tol
                and (card[5] == ref[5] or scan == "bfloat16")):
            raise AssertionError(f"{tag} {arch} scan {scan}: init "
                                 f"{same_init}, {worst}, loss "
                                 f"{loss_rel:.3e}")


# ---------------------------------------------------------------------------
# Slice 15: the rank mesh (A.10.1), one torch.distributed rank per node
# shard, the four ranks sharing the card over gloo
# ---------------------------------------------------------------------------
DIST_K = 4                          # ranks = node shards ([smain]'s mesh)
DIST_TIMEOUT_S = 600                # run_ranks' limit for the rank phases
DIST_SEED = 15
# slice 16's rank paths: (data=2, model=2), 4 nodes (2 a node shard);
# [d2cmain] at 4 steps (gossip, gossip, global, gossip) to keep the
# script within its 900 s budget
D2_N = 4
D2_AXES = ((2, 2), ("data", "model"))
D2_STEPS = {"[d2main]": 4, "[d2cmain]": 4}
# the 1-D rank paths' steps (gossip, gossip, global, gossip): [dmain] and
# [dcmain] run the first 4 of [smain]'s / [scmain]'s 6 (their learning
# rates, held against the twins' state after step 3: SNAPSHOT), and
# slice 20's [dovmain] 4 of its own
DIST_STEPS = {"[dmain]": 4, "[dcmain]": 4, "[dovmain]": 4}
SNAPSHOT = {}                       # a one-process twin's state mid-run
# the bound a rank path is held to against its one-process twin (PERF.md
# §2): each step's loss, and each leaf's float64 Σx and Σx² on every rank
# when the params are not bitwise
RANK_LOSS_RTOL = 1e-6
RANK_STAT_RTOL = 1e-6
DIST_ROUNDS = (("gossip hop 1", "gossip", 0, False),
               ("gossip hop 2", "gossip", 1, False),
               ("global", "global", 0, False),
               ("int8+EF gossip hop 1", "gossip", 0, True),
               ("int8+EF global", "global", 0, True))
FP_CHUNK = 1 << 26                  # elements per fingerprint pass
SROUND = {}                         # [sround]'s times, beside [dround]'s


def fingerprint(torch, t) -> tuple:
    """An exact digest of a tensor's bytes, taken on its device: ``(numel,
    Σ b_i, Σ b_i·w_i)`` over its 32-bit words b_i with position weights
    w_i, the sums wrapping in int64 (addition mod 2^64: any order gives
    the same value).  Equal tensors give equal digests; one flipped bit
    changes both sums."""
    v = t.detach().contiguous().reshape(-1).view(torch.int32)
    h1 = h2 = 0
    for lo in range(0, v.numel(), FP_CHUNK):
        c = v[lo:lo + FP_CHUNK].to(torch.int64)
        w = torch.arange(lo, lo + c.numel(), dtype=torch.int64,
                         device=c.device)
        w = (w * 2654435761 + 97) % 2147483647
        h1 += int(c.sum())
        h2 += int((c * w).sum())
    return v.numel(), h1 & (2**64 - 1), h2 & (2**64 - 1)


def dist_inputs(torch, shapes, rows, device):
    """The rounds' synthetic inputs ``(x, ef)`` for node ``rows``: one
    leaf per shape of pga-lm-100m (``leaf00`` …), each node row drawn on
    the card from its own seed, so any process builds any rows with the
    same bits (x at 0.02, ef at 1e-3)."""
    def leaf(i, shape, scale, salt):
        out = []
        for g in rows:
            gen = torch.Generator(device=device).manual_seed(
                DIST_SEED * 1_000_003 + salt * 10_007 + 100 * i + g)
            out.append(torch.randn((1,) + tuple(shape), generator=gen,
                                   device=device) * scale)
        return torch.cat(out)
    x = {f"leaf{i:02d}": leaf(i, s, 0.02, 0) for i, s in enumerate(shapes)}
    ef = {f"leaf{i:02d}": leaf(i, s, 1e-3, 1) for i, s in enumerate(shapes)}
    return x, ef


def dist_round(torch, mesh, x, ef, phase: str, step: int,
               compressed: bool):
    """One round of a [dround] kind on ``mesh`` (the one-process mesh of k
    shards or a rank mesh): uncompressed with the consensus residual, as
    the Trainer's fused route runs it; compressed int8 + EF through
    ``communicate`` (the collective on the global phase).  Returns the
    output tensors, each with whether it is node-stacked (x̄ and the
    residual are not)."""
    from repro_torch.core import mixing
    from repro_torch.tree import tree_leaves
    spec = mixing.CommSpec(
        topology="one_peer_exp", n_nodes=MAIN_N, backend="pallas",
        mesh=mesh, shard_mode="sharded",
        **(dict(compressor=_codec("int8"), global_compressor=_codec("int8"))
           if compressed else {})).validate()
    if compressed:
        mixed, new_ef = mixing.communicate(x, spec, phase=phase, step=step,
                                           ef_state=ef, seed=3)
        return [(t, True) for t in tree_leaves(mixed) + tree_leaves(new_ef)]
    mixed, xbar, resid = mixing.communicate_sharded(
        x, spec, phase=phase, step=step, with_residual=True)
    return ([(t, True) for t in tree_leaves(mixed)]
            + [(t, False) for t in tree_leaves(xbar)] + [(resid, False)])


def _codec(name: str):
    from repro_torch import compress as C
    return C.make_compressor(name)


def _row_fingerprints(torch, outs, r: int, m: int) -> list:
    """Rank r's view of a round's outputs: its rows of the node-stacked
    ones, the others (x̄, the residual) whole."""
    return [fingerprint(torch, t[r * m:(r + 1) * m] if stacked else t)
            for t, stacked in outs]


def _dist_tcfg(compressed: bool, reduced: bool = False, nodes: int = MAIN_N,
               steps: int = 6, overlap: bool = False):
    """[smain]'s / [scmain]'s configuration (run_main_path) for ``nodes``
    nodes, each with [smain]'s 4 sequences of 512, ``steps`` steps;
    ``reduced`` (a CPU rehearsal): the reduced model; ``overlap``: the
    overlapped rounds ([dovmain])."""
    from repro_torch.configs import (DistConfig, OptimizerConfig,
                                     TrainConfig, get_model_config)
    return TrainConfig(
        model=get_model_config("pga-lm-100m", reduced=reduced),
        dist=DistConfig(algorithm="gossip_pga", topology="one_peer_exp",
                        H=3, comm_backend="pallas",
                        comm_shard_mode="sharded", comm_overlap=overlap,
                        **(COMPRESSED if compressed else {})),
        optimizer=OptimizerConfig(name="adamw", lr=3e-4,
                                  schedule="warmup_cosine", warmup_steps=2,
                                  total_steps=steps + 2),
        global_batch=(32 if not reduced else 8) * nodes // MAIN_N,
        seq_len=512 if not reduced else 16, steps=steps, log_every=1)


def _twin_counter(mc):
    """Count calls of the per-shard kernels' plain twins (none may run on
    the card): patch the module attributes the wrappers call."""
    calls = {"shard_mix": 0, "shard_cmix": 0}
    for key, name in (("shard_mix", "shard_mix_block_plain"),
                      ("shard_cmix", "shard_comp_mix_block_plain")):
        fn = getattr(mc, name)

        def counted(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        setattr(mc, name, counted)
    return calls


def leaf_stats(torch, leaves) -> list:
    """Per leaf ``(Σx, Σx²)`` in float64: what a rank returns of its final
    params beside their fingerprints, to give the size of a gap where two
    runs' params never meet in one process."""
    out = []
    for p in leaves:
        d = p.detach().to(torch.float64)
        out.append((float(d.sum()), float(d.square().sum())))
        del d
    return out


def shard_fingerprints(torch, params, k: int) -> list:
    """Per node shard r of k, the fingerprints of its rows of every
    leaf."""
    from repro_torch.tree import tree_leaves
    leaves = tree_leaves(params)
    m = leaves[0].shape[0] // k
    return [[fingerprint(torch, p[r * m:(r + 1) * m]) for p in leaves]
            for r in range(k)]


def _rank_path(torch, dist, tr, mesh, tag: str, ref: dict, card: bool,
               twins: dict, trace=None, steps: int = 0) -> dict:
    """This rank's run of one trainer path (``steps``, by default the
    configuration's): each step's record, synchronizing calls, exchange
    bytes on each axis and the node axis's halo in flight (the worker's
    seconds, the caller's wait, staging waits on this thread), the
    launches, the final params' fingerprints and float64 stats, the peak
    memory and pinned bytes (now and at most); on a 2-D mesh the last
    gossip step with the exchanges' split timed (the timing's own waits
    on the stream inside it).  ``trace``: the one-process twin's per-step
    fingerprints of this rank's node shard (the first leaf whose rows
    leave them)."""
    from repro_torch.tree import tree_leaves
    sync = torch.cuda.synchronize if card else (lambda: None)
    exes = [mesh.exchange] + ([mesh.model_exchange]
                              if mesh.model_exchange is not None else [])
    state = tr.init_state(torch.Generator().manual_seed(0))
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    reset_counts()
    for key in twins:
        twins[key] = 0
    n_steps = steps or tr.tcfg.steps
    steps, first, split = [], [], None
    H = tr.tcfg.dist.H
    split_step = max(k for k in range(n_steps) if (k + 1) % H)
    for k in range(n_steps):
        timed = mesh.model_exchange is not None and k == split_step
        for ex in exes:
            ex.reset_stats()
            ex.timing = timed
        t0 = time.perf_counter()
        state, n_sync = (sync_steps(
            torch, lambda: tr.run(state, steps=1, log_every=1))
            if card else (tr.run(state, steps=1, log_every=1), 0))
        sync()
        dt = time.perf_counter() - t0
        rec = tr.history[-1]
        if timed:
            split = dict(ms=dt * 1e3, phase=rec["phase"], step=k,
                         axes=[dict(ex.stats) for ex in exes])
            for ex in exes:
                ex.timing = False
        if mesh.rank == 0:
            print(f"{tag} rank 0 step {k} {dt * 1e3:.1f} ms, peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9 if card else 0:.2f}"
                  f" GB", flush=True)
        steps.append(dict(
            phase=rec["phase"], loss=rec["loss"], consensus=rec["consensus"],
            grad_norm=rec["grad_norm"], ms=dt * 1e3, syncs=n_sync,
            exchange_syncs=sum(ex.stats["syncs"] for ex in exes),
            bytes=[(ex.stats["bytes_out"], ex.stats["bytes_in"])
                   for ex in exes],
            flight_s=exes[0].stats["flight"], wait_s=exes[0].stats["wait"]))
        if trace is not None:
            fps = [fingerprint(torch, p) for p in tree_leaves(state.params)]
            bad = [i for i, (a, b) in enumerate(zip(fps, trace[k]))
                   if a != b]
            first.append((bad[0], len(bad)) if bad else None)
    launches = counts()
    leaves = tree_leaves(state.params)
    fps = [fingerprint(torch, p) for p in leaves]
    out = dict(steps=steps, launches=launches, twins=dict(twins),
               params_equal=fps == ref["fps"][mesh.node_rank]
               if ref else None,
               stats=leaf_stats(torch, leaves), first_leaf=first,
               coords=(mesh.node_rank, mesh.model_rank),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9 if card
               else 0, pinned_bytes=sum(ex.pinned_bytes for ex in exes),
               pinned_peak=max(ex.pinned_peak for ex in exes),
               slot_fps=slot_fingerprints(torch, state))
    del leaves, state
    if split is not None:
        out["split"] = split
    return out


def _dist_rank(rank: int, shapes, refs, device: str = "cuda:0"):
    """One rank of the rank phases (``run_ranks`` spawns four on cuda:0
    over gloo).  Slice 15 on a mesh of 4 node shards: the [dround] rounds
    (one untimed round first, then each kind once, timed with the
    exchange's split, its outputs' fingerprints of this rank's rows
    taken after), then [dmain] and [dcmain] (the Trainer on this
    rank's 2 nodes, 4 steps; [dcmain] fingerprinted after every step
    against [scmain]'s), then slice 20's [dovmain] (the overlapped
    Trainer, 4 steps).  Slice 16 on a (data=2, model=2) mesh: [d2main] and
    [d2cmain] (the Trainer at n = 4, this rank the 2 nodes of its node
    shard whole, one model chunk of every round).  Slice 17: [dslowmo]
    after [dcmain] (SlowMo on the 4 node shards) and [d2ckpt] after
    [d2cmain] (:func:`_d2ckpt_rank`).  ``refs``: the one-process runs'
    fingerprints.  Returns what the parent prints and
    gates.  ``device="cpu"`` rehearses it at the reduced model (no timing
    of kernels, no synchronizing-call count)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.mesh import make_mesh
    from repro_torch.kernels import mixing_cuda as mc
    from repro_torch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = device != "cpu"
    sync = torch.cuda.synchronize if card else (lambda: None)
    twins = _twin_counter(mc)
    m = MAIN_N // DIST_K
    mesh = make_mesh((DIST_K,), ("data",), device=device,
                     group=dist.group.WORLD)
    ex = mesh.exchange
    out = {"rank": rank, "rounds": {}, "paths": {}}
    # [dround]: this rank's rows of the synthetic state
    rows = range(rank * m, (rank + 1) * m)
    x, ef = dist_inputs(torch, shapes, rows, mesh.device)
    D = sum(math.prod(s) for s in shapes)
    for i, (name, phase, step, compressed) in enumerate(DIST_ROUNDS):
        if i == 0:
            # one untimed round first: the pinned staging buffers grow to
            # a round's size there, not inside the timed one
            dist_round(torch, mesh, x, ef, phase, step, compressed)
        # timed: 1 round after a barrier, the exchange's split on; its
        # outputs fingerprinted after the timing
        reset_counts()
        ex.timing = True
        ex.reset_stats()
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        outs = dist_round(torch, mesh, x, ef, phase, step, compressed)
        sync()
        total = (time.perf_counter() - t0) * 1e3
        st = dict(ex.stats)
        ex.timing = False
        launches = counts()
        fps = [fingerprint(torch, t) for t, _ in outs]
        del outs
        kernel_ms = 0.0
        if phase == "gossip" and card:
            # B.5 / B.4 alone at this round's shapes on this rank
            from repro_torch.core.mixing import _device_shard_blocks
            offsets, Ms, ds, ws = _device_shard_blocks(
                phase, "one_peer_exp", MAIN_N, step, 1, DIST_K, mesh.device)
            K = len(offsets) * m
            xr = torch.randn((m, D), device=mesh.device)
            xs = torch.randn((K, D), device=mesh.device)
            o = torch.empty_like(xr)
            if compressed:
                kernel_ms = cuda_ms(torch, lambda: mc.shard_comp_mix_block(
                    xr, xs[:m], xs, ws[rank], Ms[rank], out=o), iters=3,
                    warmup=1)
            else:
                kernel_ms = cuda_ms(torch, lambda: mc.shard_mix_block(
                    xr, xs, ds[rank], Ms[rank], with_residual=True, out=o),
                    iters=3, warmup=1)
            del xr, xs, o
        dist.barrier()
        if rank == 0:
            print(f"[dround] rank 0 {name}: {total:.1f} ms, peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9 if card else 0:.2f}"
                  f" GB", flush=True)
        out["rounds"][name] = dict(
            fps=fps, launches=launches, ms=total,
            stage_out_ms=st["stage_out"] * 1e3,
            exchange_ms=st["exchange"] * 1e3,
            stage_in_ms=st["stage_in"] * 1e3, kernel_ms=kernel_ms,
            bytes_out=st["bytes_out"], bytes_in=st["bytes_in"],
            syncs=st["syncs"], ops=st["ops"])
    del x, ef
    if card:
        torch.cuda.empty_cache()
    # [dmain] and [dcmain]: the Trainer on this rank's nodes, the first
    # DIST_STEPS of [smain]'s / [scmain]'s run; slice 20's [dovmain]: the
    # overlapped Trainer, each gossip step's halo in flight under its
    # forward and backward
    for tag, compressed, overlap in (("[dmain]", False, False),
                                     ("[dcmain]", True, False),
                                     ("[dovmain]", False, True)):
        tr = Trainer(_dist_tcfg(compressed, reduced=not card,
                                steps=DIST_STEPS[tag] if overlap else 6,
                                overlap=overlap),
                     n_nodes=MAIN_N, mesh=mesh, with_consensus=True,
                     device=device)
        ref = refs.get(tag)
        trace = ([t[rank] for t in ref["trace"]]
                 if ref and ref.get("trace") else None)
        out["paths"][tag] = _rank_path(torch, dist, tr, mesh, tag, ref, card,
                                       twins, trace, steps=DIST_STEPS[tag])
        del tr
        if card:
            torch.cuda.empty_cache()
    # slice 17: [dslowmo], SlowMo on this rank's nodes
    tr = Trainer(_slowmo_tcfg(reduced=not card), n_nodes=MAIN_N, mesh=mesh,
                 with_consensus=True, device=device)
    out["paths"]["[dslowmo]"] = _rank_path(
        torch, dist, tr, mesh, "[dslowmo]", refs.get("[dslowmo]"), card,
        twins)
    del tr
    if card:
        torch.cuda.empty_cache()
    # slice 16: [d2main] and [d2cmain] on the (data=2, model=2) mesh; the
    # 1-D mesh's pinned staging buffers go first
    del mesh, ex
    mesh2 = make_mesh(*D2_AXES, device=device, group=dist.group.WORLD)
    for compressed in (False, True):
        tag = "[d2cmain]" if compressed else "[d2main]"
        tr = Trainer(_dist_tcfg(compressed, reduced=not card, nodes=D2_N,
                                steps=D2_STEPS[tag]),
                     n_nodes=D2_N, mesh=mesh2, with_consensus=True,
                     device=device)
        out["paths"][tag] = _rank_path(torch, dist, tr, mesh2, tag,
                                       refs.get(tag), card, twins)
        del tr
        if card:
            torch.cuda.empty_cache()
    # slice 17: [d2ckpt], a checkpoint written and resumed on this mesh
    out["d2ckpt"] = _d2ckpt_rank(torch, dist, mesh2, refs.get("[d2ckpt]"),
                                 card, twins)
    return out


def twin_snapshot(torch, state, k: int = DIST_K) -> dict:
    """What a rank path is held to of a one-process twin's state: each of
    its k node shards' rows' fingerprints and float64 stats of the
    params, and the launches so far."""
    from repro_torch.tree import tree_leaves
    leaves = tree_leaves(state.params)
    m = leaves[0].shape[0] // k
    return dict(
        launches=counts(),
        fps=[[fingerprint(torch, p[r * m:(r + 1) * m]) for p in leaves]
             for r in range(k)],
        stats=[leaf_stats(torch, [p[r * m:(r + 1) * m] for p in leaves])
               for r in range(k)])


OVERLAP_TURNS = ("serial", "issued", "issued", "serial")


@contextlib.contextmanager
def serial_overlap(on: bool):
    """While ``on``: the overlapped step's ``mixing.issue_round`` is the
    identity, so ``finish_round`` gathers the halo itself after the
    optimizer (the serial overlap, as before slice 20)."""
    from repro_torch.core import mixing
    real = mixing.issue_round
    if on:
        mixing.issue_round = lambda round_state, spec, *, step: round_state
    try:
        yield
    finally:
        mixing.issue_round = real


def _overlap_compare_rank(rank: int, device: str):
    """One rank of ``--overlap-compare``: [dovmain]'s Trainer 4 steps at a
    time, serial and issued in turns (:data:`OVERLAP_TURNS`)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.mesh import make_mesh
    from repro_torch.kernels import mixing_cuda as mc
    from repro_torch.train import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = device != "cpu"
    twins = _twin_counter(mc)
    mesh = make_mesh((DIST_K,), ("data",), device=device,
                     group=dist.group.WORLD)
    out = []
    for kind in OVERLAP_TURNS:
        with serial_overlap(kind == "serial"):
            tr = Trainer(_dist_tcfg(False, reduced=not card,
                                    steps=DIST_STEPS["[dovmain]"],
                                    overlap=True),
                         n_nodes=MAIN_N, mesh=mesh, with_consensus=True,
                         device=device)
            rec = _rank_path(torch, dist, tr, mesh, f"[ovcompare] {kind}",
                             None, card, twins,
                             steps=DIST_STEPS["[dovmain]"])
        out.append(dict(kind=kind, steps=rec["steps"], peak_gb=rec["peak_gb"],
                        pinned_peak=rec["pinned_peak"]))
        del tr
        if card:
            torch.cuda.empty_cache()
    return out


def run_overlap_compare(torch, device: str = "cuda") -> None:
    """``--overlap-compare``: what issuing the halo before the forward
    changes in an overlapped step, serial against issued in turns
    (serial, issued, issued, serial), each a fresh 4-step run of
    [dovmain]'s configuration: in one process on the mesh of 4 node
    shards (the side stream), then on 4 gloo ranks of the card.  Prints
    each run's step ms, peak memory and, on the ranks, the worker's and
    the wait's seconds, then the medians of the steady gossip steps
    (steps 1 and 3).  Reports; gates nothing."""
    from repro_torch.core.mesh import make_mesh, run_ranks
    from repro_torch.train import Trainer
    card = device != "cpu"
    one = {"serial": [], "issued": []}
    for kind in OVERLAP_TURNS:
        with serial_overlap(kind == "serial"):
            tr = Trainer(_dist_tcfg(False, reduced=not card,
                                    steps=DIST_STEPS["[dovmain]"],
                                    overlap=True),
                         n_nodes=MAIN_N,
                         mesh=make_mesh((DIST_K,), ("data",), device=device),
                         with_consensus=True, device=device)
            state = tr.init_state(torch.Generator().manual_seed(0))
            if card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            ms = []
            for _ in range(DIST_STEPS["[dovmain]"]):
                t0 = time.perf_counter()
                state = tr.run(state, steps=1, log_every=1)
                if card:
                    torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        phases = [h["phase"] for h in tr.history]
        one[kind] += [v for k, v in enumerate(ms)
                      if k and phases[k] == "gossip"]
        print(f"[ovcompare] one process ({DIST_K} node shards) {kind}: steps "
              f"{[round(v, 1) for v in ms]} ms ({phases}), peak "
              f"{torch.cuda.max_memory_allocated() / 1e9 if card else 0:.2f}"
              f" GB", flush=True)
        del tr, state
        if card:
            torch.cuda.empty_cache()
    prev = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        res = run_ranks(_overlap_compare_rank, DIST_K, backend="gloo",
                        device="cuda:0" if card else "cpu",
                        args=("cuda:0" if card else "cpu",),
                        timeout_s=DIST_TIMEOUT_S, threads=2)
    finally:
        if prev is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = prev
    ranks = {"serial": [], "issued": []}
    for i, kind in enumerate(OVERLAP_TURNS):
        runs = [res[r][i] for r in range(DIST_K)]
        steps0 = runs[0]["steps"]
        slow = [max(run["steps"][k]["ms"] for run in runs)
                for k in range(len(steps0))]
        ranks[kind] += [v for k, v in enumerate(slow)
                        if k and steps0[k]["phase"] == "gossip"]
        flew = [(round(s["flight_s"], 3), round(s["wait_s"], 3))
                for s in steps0]
        print(f"[ovcompare] {DIST_K} ranks {kind}: steps (slowest rank) "
              f"{[round(v, 1) for v in slow]} ms; rank 0's worker and wait "
              f"seconds {flew}; peak "
              f"{[round(run['peak_gb'], 2) for run in runs]} GB, pinned "
              f"peak {[run['pinned_peak'] for run in runs]} bytes",
              flush=True)
    for where, got in (("one process", one), (f"{DIST_K} ranks", ranks)):
        print(f"[ovcompare] {where}: steady gossip steps serial "
              f"{[round(v, 1) for v in got['serial']]} (median "
              f"{statistics.median(got['serial']):.1f} ms), issued "
              f"{[round(v, 1) for v in got['issued']]} (median "
              f"{statistics.median(got['issued']):.1f} ms)", flush=True)


def smain_reference(torch, tr, state, launches, k: int = DIST_K,
                    at: dict = None) -> tuple:
    """``(leaf shapes, reference)`` of a finished one-process trainer run
    ([smain]/[scmain], or the one-process twins of the 2-D rank paths):
    its step records, launches, and each of its k node shards' rows'
    fingerprints and float64 stats of the final params; ``at`` (a
    :func:`twin_snapshot` taken mid-run) in place of the last three."""
    from repro_torch.tree import tree_leaves
    leaves = tree_leaves(state.params)
    ref = dict(steps=[{key: h[key] for key in ("phase", "loss", "consensus",
                                               "grad_norm")}
                      for h in tr.history[:6]])
    ref.update(at or dict(twin_snapshot(torch, state, k),
                          launches=launches))
    return [tuple(p.shape[1:]) for p in leaves], ref


def dov_reference(torch, device="cuda") -> dict:
    """[dovmain]'s one-process twin: the overlapped Trainer ([dmain]'s
    configuration with ``comm_overlap=True``, 4 steps) on the mesh of 4
    node shards in this process, every gossip step's halo gathered on a
    side stream; the reference the rank path is held to
    (:func:`smain_reference`), with each step's host ms."""
    from repro_torch.core.mesh import make_mesh
    from repro_torch.train import Trainer
    card = device != "cpu"
    tag = "[dovmain]"
    mesh = make_mesh((DIST_K,), ("data",), device=device)
    tr = Trainer(_dist_tcfg(False, reduced=not card, steps=DIST_STEPS[tag],
                            overlap=True),
                 n_nodes=MAIN_N, mesh=mesh, with_consensus=True,
                 device=device)
    state = tr.init_state(torch.Generator().manual_seed(0))
    reset_counts()
    times = []
    for _ in range(DIST_STEPS[tag]):
        t0 = time.perf_counter()
        state = tr.run(state, steps=1, log_every=1)
        if card:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ref = smain_reference(torch, tr, state, counts())[1]
    ref["ms"] = times
    fired = {k: v for k, v in ref["launches"].items() if v}
    print(f"{tag} the one-process twin ({mesh.shape}, {MAIN_N} nodes, "
          f"overlapped, the halos on a side stream): steps "
          f"{[round(t, 1) for t in times]} ms, phases "
          f"{[h['phase'] for h in ref['steps']]}, losses "
          f"{[round(h['loss'], 4) for h in ref['steps']]}, launches "
          f"{fired}", flush=True)
    del tr, state
    if card:
        torch.cuda.empty_cache()
    return ref


def d2_references(torch, device="cuda") -> dict:
    """The one-process twins of [d2main]/[d2cmain]: the Trainer on the
    (data=2, model=2) mesh in this process, n = 4, 6 steps, every block
    here: references for the rank paths (:func:`smain_reference`)."""
    from repro_torch.core.mesh import make_mesh
    from repro_torch.train import Trainer
    card = device != "cpu"
    refs = {}
    for compressed in (False, True):
        tag = "[d2cmain]" if compressed else "[d2main]"
        mesh = make_mesh(*D2_AXES, device=device)
        tr = Trainer(_dist_tcfg(compressed, reduced=not card, nodes=D2_N,
                                steps=D2_STEPS[tag]),
                     n_nodes=D2_N, mesh=mesh, with_consensus=True,
                     device=device)
        state = tr.init_state(torch.Generator().manual_seed(0))
        reset_counts()
        t0 = time.perf_counter()
        state = tr.run(state, steps=tr.tcfg.steps, log_every=1)
        if card:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        refs[tag] = smain_reference(torch, tr, state, counts(),
                                    D2_AXES[0][0])[1]
        fired = {k: v for k, v in refs[tag]["launches"].items() if v}
        print(f"{tag} the one-process twin ({mesh.shape}, {D2_N} nodes, "
              f"every block here): {tr.tcfg.steps} steps in {dt:.1f} s, "
              f"losses "
              f"{[round(h['loss'], 4) for h in refs[tag]['steps']]}, "
              f"launches {fired}", flush=True)
        del tr, state
        if card:
            torch.cuda.empty_cache()
    return refs


def dist_parent_fingerprints(torch, shapes, device="cuda") -> dict:
    """The one-process sharded rounds ([sround]'s mesh of 4 shards on the
    card) on the synthetic state of all 8 nodes: each rank's fingerprints
    of each [dround] kind."""
    from repro_torch.core.mesh import make_mesh
    mesh = make_mesh((DIST_K,), ("data",), device=device)
    x, ef = dist_inputs(torch, shapes, range(MAIN_N), mesh.device)
    want = {}
    m = MAIN_N // DIST_K
    for name, phase, step, compressed in DIST_ROUNDS:
        outs = dist_round(torch, mesh, x, ef, phase, step, compressed)
        want[name] = [_row_fingerprints(torch, outs, r, m)
                      for r in range(DIST_K)]
        del outs
    del x, ef
    return want


def _gate_against_twin(tag: str, twin: str, recs: list, ref: dict,
                       failures: list) -> None:
    """Hold a rank path against its one-process twin with the bound of
    ``PERF.md`` §2: every step's loss within rtol ``RANK_LOSS_RTOL``; the
    final params bitwise (every rank's fingerprints), else each leaf's
    float64 Σx and Σx² on every rank within rtol ``RANK_STAT_RTOL`` of
    the twin's rows (the gap printed)."""
    worst = 0.0
    for k, s in enumerate(recs[0]["steps"]):
        want = ref["steps"][k]["loss"]
        worst = max(worst, abs(s["loss"] - want) / abs(want))
    equal = [rec["params_equal"] for rec in recs]
    gaps = []
    for rec in recs:
        mine = ref["stats"][rec["coords"][0]]
        for (a1, a2), (b1, b2) in zip(rec["stats"], mine):
            gaps.append(max(abs(a1 - b1) / max(abs(b1), 1e-30),
                            abs(a2 - b2) / max(abs(b2), 1e-30)))
    gap = max(gaps) if gaps else 0.0
    print(f"{tag} against {twin}: losses within rtol {worst:.3e} (bound "
          f"{RANK_LOSS_RTOL:g}); final params bitwise the twin's rows "
          f"{equal}; float64 Σx, Σx² per leaf within rtol {gap:.3e} (bound "
          f"{RANK_STAT_RTOL:g} when not bitwise)", flush=True)
    if worst > RANK_LOSS_RTOL:
        failures.append(f"{tag} losses rtol {worst:.3e} against {twin}")
    if not all(equal) and gap > RANK_STAT_RTOL:
        failures.append(f"{tag} params not bitwise {equal} and their stats "
                        f"rtol {gap:.3e} against {twin}")


def _report_rank_path(tag: str, twin: str, recs: list, ref: dict,
                      key: str, nodes: int, failures: list,
                      exact_global: bool = False) -> dict:
    """Print one rank path's steps and summary and gate its launches,
    phases, consensus (0.0 after every global step of an uncompressed
    path: ``key`` shard_mix, or ``exact_global``; > 0 otherwise) and plain
    twins; returns its launches summed over the ranks."""
    summed = {k: sum(rec["launches"][k] for rec in recs) for k in counts()}
    steps0 = recs[0]["steps"]
    gossip = sum(s["phase"] == "gossip" for s in steps0)
    axes = len(steps0[0]["bytes"])
    for k, s0 in enumerate(steps0):
        ms = [rec["steps"][k]["ms"] for rec in recs]
        want = ref["steps"][k] if ref else None
        gap = (f", loss - {twin}'s {s0['loss'] - want['loss']:+.3e}"
               if want else "")
        moved = "; ".join(
            f"{'node' if a == 0 else 'model'} axis "
            f"{s0['bytes'][a][0] / 1e9:.3f} GB out "
            f"{s0['bytes'][a][1] / 1e9:.3f} GB in" for a in range(axes))
        print(f"{tag} step {k} phase={s0['phase']} loss={s0['loss']:.4f}"
              f" consensus={s0['consensus']:.6e} step_ms (slowest "
              f"rank)={max(ms):.1f} ranks {[round(v, 1) for v in ms]} "
              f"synchronizing_calls="
              f"{[rec['steps'][k]['syncs'] for rec in recs]} (staging "
              f"waits {s0['exchange_syncs']}) exchange a rank: {moved}{gap}",
              flush=True)
        for rec in recs:
            s = rec["steps"][k]
            if (s["phase"], s["loss"], s["consensus"]) != (
                    s0["phase"], s0["loss"], s0["consensus"]):
                failures.append(f"{tag} step {k}: ranks disagree")
        if not math.isfinite(s0["loss"]):
            failures.append(f"{tag} step {k}: loss {s0['loss']}")
        if (key == "shard_mix" or exact_global) \
                and s0["phase"] in ("global", "slowmo"):
            if s0["consensus"] != 0.0:
                failures.append(f"{tag} step {k}: consensus "
                                f"{s0['consensus']} after a global step")
        elif not s0["consensus"] > 0.0:
            failures.append(f"{tag} step {k}: consensus {s0['consensus']}")
    steady = statistics.median(max(rec["steps"][k]["ms"] for rec in recs)
                               for k in range(1, len(steps0)))
    per_rank = [rec["launches"][key] for rec in recs]
    twins = [rec["twins"] for rec in recs]
    one = STEADY.get(twin)
    print(f"{tag} {len(steps0)} steps on {DIST_K} ranks "
          f"({nodes} nodes, gloo through pinned host memory): {key} "
          f"launches per rank {per_rank}, summed {summed[key]} "
          f"({twin} {ref['launches'][key] if ref else '?'}); plain twins "
          f"called {twins}; steady step {steady:.1f} ms (median of steps "
          f"1-{len(steps0) - 1}, slowest rank; {twin} "
          f"{'%.1f ms' % (one * 1e3) if one else 'not timed'}), "
          f"{512 * 4 * nodes / steady * 1e3:.0f} tokens/s; peak memory per "
          f"rank {[round(rec['peak_gb'], 2) for rec in recs]} GB; pinned "
          f"host bytes per rank {[rec['pinned_bytes'] for rec in recs]}",
          flush=True)
    if per_rank != [gossip] * DIST_K or \
            summed != only(**{key: gossip * DIST_K}):
        failures.append(f"{tag} launches per rank {per_rank}, summed "
                        f"{summed}")
    if any(t[key] for t in twins for key in t):
        failures.append(f"{tag} plain twins called {twins}")
    if ref:
        _gate_against_twin(tag, twin, recs, ref, failures)
    return summed


def _report_dovmain(recs: list, dmain: list, ref: dict,
                    failures: list) -> None:
    """[dovmain]'s halo in flight, per rank and step: the step's ms, the
    worker's seconds (copy out and exchange), the caller's wait in
    ``finish_round`` and the hidden part (worker − wait), staging waits
    on the step's thread, synchronizing calls; each rank's pinned peak
    and peak memory; [dmain]'s gossip steps (the serial exchange) and the
    one-process twin's beside.  A gossip step must have waited for the
    halo it issued (the overlap ran), the others for none."""
    steps0 = recs[0]["steps"]
    for k, s0 in enumerate(steps0):
        per = []
        for r, rec in enumerate(recs):
            s = rec["steps"][k]
            per.append(f"rank {r} {s['ms']:.1f} ms, worker "
                       f"{s['flight_s']:.3f} s, wait {s['wait_s']:.3f} s, "
                       f"hidden {s['flight_s'] - s['wait_s']:.3f} s, "
                       f"staging waits {s['exchange_syncs']}, "
                       f"synchronizing calls {s['syncs']}")
            if (s["wait_s"] > 0.0) != (s0["phase"] == "gossip"):
                failures.append(f"[dovmain] step {k} ({s0['phase']}) rank "
                                f"{r}: waited {s['wait_s']} s for a halo "
                                f"in flight")
        print(f"[dovmain] step {k} phase={s0['phase']}: " + "; ".join(per),
              flush=True)
    gossip = [k for k, s in enumerate(steps0) if s["phase"] == "gossip"]
    slow = [max(rec["steps"][k]["ms"] for rec in recs) for k in gossip]
    hidden = []
    for rec in recs:
        flew = sum(rec["steps"][k]["flight_s"] for k in gossip)
        waited = sum(rec["steps"][k]["wait_s"] for k in gossip)
        # the worker's seconds are the staged transport's (on the card)
        hidden.append(round((flew - waited) / flew, 3) if flew > 0
                      else "not measured")
    serial = [max(rec["steps"][k]["ms"] for rec in dmain)
              for k, s in enumerate(dmain[0]["steps"])
              if s["phase"] == "gossip"]
    twin = ref.get("ms") if ref else None
    print(f"[dovmain] gossip steps (slowest rank) "
          f"{[round(v, 1) for v in slow]} ms against [dmain]'s serial "
          f"exchange {[round(v, 1) for v in serial]} ms; share of the "
          f"worker's seconds hidden under the step per rank {hidden}; "
          f"pinned peak per rank {[rec['pinned_peak'] for rec in recs]} "
          f"bytes; peak memory per rank "
          f"{[round(rec['peak_gb'], 2) for rec in recs]} GB; the "
          f"one-process twin's steps "
          f"{[round(v, 1) for v in twin] if twin else 'not timed'} ms",
          flush=True)


def _report_split(tag: str, recs: list) -> None:
    """The 2-D rank path's last gossip step with the exchanges' split
    timed: the slowest rank's ms, staging out, exchange and staging in on
    each axis, the bytes of each."""
    slow = max(recs, key=lambda rec: rec["split"]["ms"])
    sp = slow["split"]
    parts = []
    for name, st in zip(("node", "model"), sp["axes"]):
        parts.append(f"{name} axis staging out {st['stage_out'] * 1e3:.1f} + "
                     f"exchange {st['exchange'] * 1e3:.1f} + staging in "
                     f"{st['stage_in'] * 1e3:.1f} ms, "
                     f"{st['bytes_out'] / 1e9:.3f} GB out "
                     f"{st['bytes_in'] / 1e9:.3f} GB in, {st['ops']:.0f} "
                     f"calls")
    moved = sum(st["stage_out"] + st["exchange"] + st["stage_in"]
                for st in sp["axes"]) * 1e3
    print(f"{tag} step {sp['step']} ({sp['phase']}) with the exchanges "
          f"timed, slowest rank {slow['coords']}: {sp['ms']:.1f} ms = "
          f"{'; '.join(parts)}; the rest (forward, backward, optimizer, "
          f"packing, kernels) {sp['ms'] - moved:.1f} ms", flush=True)


def _trace_dcmain(recs: list, smain: dict) -> None:
    """[dcmain] against [scmain] step by step: the joint gradient norms
    (and where the clip at 1.0 engages, [smain]'s beside), and the first
    leaf whose rows leave [scmain]'s after each step on any rank."""
    mine = [s["grad_norm"] for s in recs[0]["steps"]]
    ref = smain.get("[dcmain]")
    if not ref:
        return
    want = [s["grad_norm"] for s in ref["steps"]]
    plain = [s["grad_norm"] for s in smain["[dmain]"]["steps"]] \
        if smain.get("[dmain]") else []
    first = [(r, k, f) for r, rec in enumerate(recs)
             for k, f in enumerate(rec["first_leaf"]) if f is not None]
    where = ("none: every leaf's rows bitwise [scmain]'s after every step "
             "on every rank" if not first else
             f"step {first[0][1]}, leaf {first[0][2][0]} (of "
             f"{first[0][2][1]} differing) on rank {first[0][0]}")
    folds = TRACE.get("[scmain] norms", [])
    print(f"[dcmain] trace: grad_norm per step {mine}, [scmain]'s {want}, "
          f"equal {[a == b for a, b in zip(mine, want)]}; the clip at 1.0 "
          f"engages at steps {[k for k, g in enumerate(want) if g > 1.0]} "
          f"([smain]: {[k for k, g in enumerate(plain) if g > 1.0]}); the "
          f"first leaf whose rows leave [scmain]'s: {where}; [scmain]'s "
          f"norm² folded per node shard vs one sum over all rows (the "
          f"one-process step's arithmetic before the fold) differ at steps "
          f"{[k for k, (a, b) in enumerate(folds) if a != b]}", flush=True)


def run_dist_paths(torch, mc, shapes, smain, d2ref, device="cuda") -> dict:
    """The rank phases: the parent's fingerprints of the one-process
    sharded rounds, then one spawn of four ranks on the card over gloo
    (:func:`_dist_rank`).  Slice 15: ``[dround]`` (each rank's rows
    bitwise the one-process round's, the round split into staging out,
    exchange, staging in, kernel and the rest, beside ``[sround]``),
    ``[dmain]`` and ``[dcmain]`` (the Trainer on 2 nodes a rank, 4 steps:
    B.5 / B.4 on every rank, 12 launches summed, consensus 0.0 after every
    uncompressed global step, finite losses, no plain twin on the card;
    [dcmain] traced against [scmain] step by step).  Slice 20:
    ``[dovmain]`` (the overlapped Trainer, 4 steps, each gossip step's
    halo in flight under its forward and backward, held to
    :func:`dov_reference`; :func:`_report_dovmain`).  Slice 16:
    ``[d2main]`` and ``[d2cmain]`` on the (data=2, model=2) mesh (B.5 /
    B.4 once a gossip step on every rank; exchange bytes on each axis;
    the last gossip step's split timed).  Slice 17: ``[dslowmo]`` (SlowMo,
    its slots bitwise ``[sslowmo]``'s on every rank, the outer steps'
    ms and bytes) and ``[d2ckpt]`` (:func:`_report_d2ckpt`, then the twin
    restores the ranks' file: :func:`_d2ckpt_twin_restores`).  Every
    trainer path is held to its one-process twin ([smain], [scmain],
    [sslowmo], [dovmain]'s twin, ``d2ref``) by
    :func:`_gate_against_twin`.  ``smain``: [smain]/[scmain]'s references
    at step 3 (:func:`smain_reference`, [scmain]'s with its per-step
    ``trace``), [sslowmo]'s and [dovmain]'s twin's.
    Returns the launch counts summed over the ranks of each path.
    ``device="cpu"`` rehearses the phases at the reduced model (``shapes``,
    ``smain`` and ``d2ref`` to match; the launch gates then fail: the CPU
    launches no kernel)."""
    from repro_torch.core.mesh import run_ranks

    card = device != "cpu"
    t0 = time.perf_counter()
    want = dist_parent_fingerprints(torch, shapes, device)
    fp_s = time.perf_counter() - t0
    if card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        print(f"[dround] before the spawn: this process holds "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
              f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved; the "
              f"card {free / 1e9:.2f} of {total / 1e9:.2f} GB free",
              flush=True)
    refs = {t: {"fps": v["fps"], "trace": v.get("trace"),
                "slots": v.get("slots")}
            for t, v in {**smain, **d2ref}.items()}
    t0 = time.perf_counter()
    # the ranks' allocators map their pools as expandable segments: four
    # processes share the card, and a pool's reserved but free blocks
    # are memory the others cannot have
    prev = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        res = run_ranks(_dist_rank, DIST_K, backend="gloo",
                        device="cuda:0" if card else "cpu",
                        args=(shapes, refs, "cuda:0" if card else "cpu"),
                        timeout_s=DIST_TIMEOUT_S, threads=2)
    finally:
        if prev is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = prev
    spawn_s = time.perf_counter() - t0
    print(f"[dround] fingerprints of the one-process rounds in {fp_s:.1f} "
          f"s; the {DIST_K} ranks (spawn, init, [dround], [dmain], "
          f"[dcmain], [dovmain], [dslowmo], [d2main], [d2cmain], [d2ckpt]) "
          f"in {spawn_s:.1f} s", flush=True)
    failures = []
    for name, phase, step, compressed in DIST_ROUNDS:
        recs = [r["rounds"][name] for r in res]
        equal = [rec["fps"] == want[name][i] for i, rec in enumerate(recs)]
        kernel = "shard_cmix" if compressed else "shard_mix"
        per_rank = [rec["launches"][kernel] for rec in recs]
        slow = max(range(DIST_K), key=lambda i: recs[i]["ms"])
        s = recs[slow]
        rest = s["ms"] - s["stage_out_ms"] - s["exchange_ms"] \
            - s["stage_in_ms"] - s["kernel_ms"]
        print(f"[dround] {name}: ranks' rows bitwise the one-process "
              f"round's {equal}; {kernel} launches per rank {per_rank}; "
              f"slowest rank {s['ms']:.1f} ms = staging out "
              f"{s['stage_out_ms']:.1f} + exchange {s['exchange_ms']:.1f} "
              f"+ staging in {s['stage_in_ms']:.1f} + kernel "
              f"{s['kernel_ms']:.1f} + the rest (sums, packing, wire "
              f"build) {rest:.1f} ms; {s['bytes_out'] / 1e9:.3f} GB out, "
              f"{s['bytes_in'] / 1e9:.3f} GB in, {s['ops']:.0f} exchange "
              f"calls, {s['syncs']:.0f} staging waits a round; all ranks' "
              f"ms {[round(r['ms'], 1) for r in recs]}; one process "
              f"([sround], 4 shards) {SROUND.get(name, 'not measured')}",
              flush=True)
        if not all(equal):
            failures.append(f"[dround] {name}: rows not bitwise {equal}")
        want_launch = 1 if phase == "gossip" else 0
        if per_rank != [want_launch] * DIST_K:
            failures.append(f"[dround] {name}: {kernel} launches "
                            f"{per_rank}")
    launches = {}
    for tag, twin, key, nodes in (
            ("[dmain]", "[smain]", "shard_mix", MAIN_N),
            ("[dcmain]", "[scmain]", "shard_cmix", MAIN_N),
            ("[dovmain]", "[dovmain] one-process twin", "shard_cmix",
             MAIN_N),
            ("[dslowmo]", "[sslowmo]", "shard_mix", MAIN_N),
            ("[d2main]", "[d2main] one-process twin", "shard_mix", D2_N),
            ("[d2cmain]", "[d2cmain] one-process twin", "shard_cmix",
             D2_N)):
        recs = [r["paths"][tag] for r in res]
        ref = smain.get(tag) if nodes == MAIN_N else d2ref.get(tag)
        launches[tag] = _report_rank_path(tag, twin, recs, ref, key, nodes,
                                          failures,
                                          exact_global=tag == "[dovmain]")
        if tag == "[dcmain]":
            _trace_dcmain(recs, smain)
        if tag == "[dovmain]":
            _report_dovmain(recs, [r["paths"]["[dmain]"] for r in res], ref,
                            failures)
        if tag == "[dslowmo]":
            _report_dslowmo(recs, ref, failures)
        if "split" in recs[0]:
            _report_split(tag, recs)
    launches["[d2ckpt]"] = _report_d2ckpt([r["d2ckpt"] for r in res],
                                          d2ref.get("[d2ckpt]"), failures)
    if d2ref.get("[d2ckpt]"):
        _d2ckpt_twin_restores(torch, d2ref["[d2ckpt]"], device, failures)
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


# ---------------------------------------------------------------------------
# Slice 16: 2-D (node, model) meshes in one process
# ---------------------------------------------------------------------------
M2_ROUNDS = (("gossip hop 1", "gossip", 0, 1, None, None),
             ("gossip hop 2", "gossip", 1, 1, None, None),
             ("global", "global", 0, 1, None, None),
             ("pod_avg", "pod_avg", 0, 2, None, None),
             ("bf16 gossip hop 1", "gossip", 0, 1, "bfloat16", None),
             ("int8+EF gossip hop 1", "gossip", 0, 1, None, "int8"),
             ("int8+EF gossip hop 2", "gossip", 1, 1, None, "int8"),
             ("int8+EF global", "global", 0, 1, None, "int8"))


def _m2_round(torch, mesh, x, ef, phase, step, pods, cd, codec):
    """One [m2round] kind on ``mesh`` (the 1-D mesh of 4 node shards or
    the (data=4, model=2) one): uncompressed with the consensus residual
    (the Trainer's fused route), the bf16 wire, or int8 + EF (gossip codec
    and collective).  Returns the output tensors."""
    from repro_torch.core import mixing
    from repro_torch.tree import tree_leaves
    spec = mixing.CommSpec(
        topology="one_peer_exp", n_nodes=MAIN_N, n_pods=pods,
        backend="pallas", mesh=mesh, shard_mode="sharded",
        comm_dtype=torch.bfloat16 if cd else None,
        **(dict(compressor=_codec(codec), global_compressor=_codec(codec))
           if codec else {})).validate()
    if codec:
        mixed, new_ef = mixing.communicate(x, spec, phase=phase, step=step,
                                           ef_state=ef, seed=3)
        return tree_leaves(mixed) + tree_leaves(new_ef)
    if cd:
        return tree_leaves(mixing.communicate(x, spec, phase=phase,
                                              step=step))
    mixed, xbar, resid = mixing.communicate_sharded(
        x, spec, phase=phase, step=step, with_residual=True)
    return tree_leaves(mixed) + tree_leaves(xbar) + [resid]


def collective_bound(torch, x, ef) -> tuple:
    """One quantization step per compressed round (``tests/
    test_torch_mixing_2d.py``): an int8 collective's output moves by at
    most one stage-2 step of r and one of ρ, 2·2^(⌈log2 max|y|⌉ − 7), its
    EF by one stage-1 step, y = x + e over the whole operand."""
    from repro_torch.tree import tree_leaves
    top = max(float((a + b).abs().max())
              for a, b in zip(tree_leaves(x), tree_leaves(ef)))
    step = 2.0 ** (math.ceil(math.log2(top)) - 7)
    return 2 * step, step


def run_m2round(torch, mc, shapes) -> None:
    """[m2round]: [sround]'s round kinds and three more on a synthetic
    full-width state of 8 nodes (``dist_inputs``), on the (data=4,
    model=2) mesh beside the 1-D mesh of the same 4 node shards:
    uncompressed gossip hops 1 and 2, global and pod_avg with the
    consensus residual, the bf16 wire, int8 + EF gossip: the mixed rows
    (and x̄, the EF state) bitwise the 1-D round's, the residual's gap
    printed; the int8 collective within ``collective_bound`` (and whether
    bitwise).  B.5 / B.4 launch once a block a gossip or pod round (8) and no
    plain twin.  Each kind timed in turns (1-D, 2-D, 2-D, 1-D) beside
    [sround]'s; then the 2-D round's packing alone (the two chunks made
    contiguous, the leaves put back together)."""
    from repro_torch.core.mesh import make_mesh
    from repro_torch.tree import tree_leaves

    twins = _twin_counter(mc)
    k = MAIN_N // SHARD_M
    mesh1 = make_mesh((k,), ("data",))
    mesh2 = make_mesh((k, MAIN_2D_KM), ("data", "model"))
    x, ef = dist_inputs(torch, shapes, range(MAIN_N), mesh1.device)
    lay = mc.ModelChunks(x, MAIN_2D_KM)
    if lay.W != MAIN_2D_W:
        raise AssertionError(f"[m2round] model chunk of {lay.W} columns, "
                             f"the kernel records' {MAIN_2D_W}")
    bound, ef_bound = collective_bound(torch, x, ef)
    failures = []
    for name, phase, step, pods, cd, codec in M2_ROUNDS:
        reset_counts()
        two = _m2_round(torch, mesh2, x, ef, phase, step, pods, cd, codec)
        launches = counts()
        one = _m2_round(torch, mesh1, x, ef, phase, step, pods, cd, codec)
        resid = codec is None and cd is None
        cmp_one = one[:-1] if resid else one
        cmp_two = two[:-1] if resid else two
        equal = all(torch.equal(a, b) for a, b in zip(cmp_one, cmp_two))
        err = max(float((a - b).abs().max()) for a, b in zip(cmp_one,
                                                             cmp_two))
        extra = ""
        if resid:
            r1, r2 = float(one[-1]), float(two[-1])
            extra = (f"; residual {r2:.9e} vs 1-D {r1:.9e} (rel "
                     f"{abs(r2 - r1) / max(abs(r1), 1e-30):.2e}: the fold "
                     f"over 8 blocks, not 4 shards)")
        del one, two
        key = "shard_cmix" if codec else "shard_mix"
        want = (only(**{key: k * MAIN_2D_KM}) if phase != "global"
                else only())
        t = [cuda_ms(torch, lambda: _m2_round(torch, m_, x, ef, phase,
                                              step, pods, cd, codec),
                     iters=3, warmup=1)
             for m_ in (mesh1, mesh2, mesh2, mesh1)]
        collective = codec and phase != "gossip"
        gate = (f"within the bound {bound:.3e} (EF {ef_bound:.3e}): "
                f"{err <= bound}" if collective else "gated bitwise")
        print(f"[m2round] {name}: 2-D rows bitwise the 1-D round's "
              f"{equal}, max abs diff {err:.3e}, {gate}{extra}; launches "
              f"{({k2: v for k2, v in launches.items() if v})}; 2-D "
              f"{t[1]:.1f} / {t[2]:.1f} ms, 1-D {t[0]:.1f} / {t[3]:.1f} ms "
              f"(in turns, synthetic state); [sround] on the trained "
              f"state {SROUND.get(name, 'not measured')}", flush=True)
        if collective:
            if err > bound:
                failures.append(f"[m2round] {name}: {err:.3e} > {bound:.3e}")
        elif not equal:
            failures.append(f"[m2round] {name}: not bitwise ({err:.3e})")
        if launches != want:
            failures.append(f"[m2round] {name}: launches {launches}")
        torch.cuda.empty_cache()
    if any(twins.values()):
        failures.append(f"[m2round] plain twins called {twins}")
    chunk_ms = cuda_ms(torch, lambda: [lay.chunk(x, c)
                                       for c in range(MAIN_2D_KM)],
                       iters=3, warmup=1)
    parts = [lay.chunk(x, c) for c in range(MAIN_2D_KM)]
    unflat_ms = cuda_ms(torch, lambda: lay.unflatten(parts), iters=3,
                        warmup=1)
    nbytes = 4 * MAIN_N * MAIN_PACKED_D
    print(f"[m2round] the 2-D packing alone: both chunks made contiguous "
          f"{chunk_ms:.1f} ms, the leaves put back together "
          f"{unflat_ms:.1f} ms ({nbytes / 1e9:.2f} GB each way; the 1-D "
          f"round packs once too)", flush=True)
    del x, ef, parts
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))


def m2_against_one_d(torch, tag: str, twin: str, state, ref: list,
                     compressed: bool) -> None:
    """[m2main] / [m2cmain]'s final params against [smain] / [scmain]'s
    (``ref``, copies kept on the card): [m2main] bitwise; [m2cmain] within
    one quantization step per compressed round of 6 (collective_bound's
    step at the params' scale), its bitwise flag printed."""
    from repro_torch.tree import tree_leaves
    leaves = tree_leaves(state.params)
    err, equal, top = 0.0, True, 0.0
    for p, d in zip(leaves, ref):
        equal = equal and torch.equal(p, d)
        err = max(err, float((p - d).abs().max()))
        top = max(top, float(d.abs().max()))
    bound = 6 * 2 * 2.0 ** (math.ceil(math.log2(top)) - 7)
    hist = [(h["loss"], h["consensus"]) for h in
            HISTORY.get(twin, [])]
    mine = [(h["loss"], h["consensus"]) for h in HISTORY.get(tag, [])]
    loss_equal = [a[0] == b[0] for a, b in zip(mine, hist)]
    cons = [abs(a[1] - b[1]) / max(abs(b[1]), 1e-30) if b[1] else
            abs(a[1]) for a, b in zip(mine, hist)]
    print(f"{tag} final params vs {twin}'s: bitwise {equal}, max abs diff "
          f"{err:.3e}{'' if not compressed else f' (bound {bound:.3e})'}; "
          f"losses equal per step {loss_equal}; consensus rel gap per "
          f"step {[f'{c:.1e}' for c in cons]}", flush=True)
    if compressed:
        if err > bound:
            raise AssertionError(f"{tag}: params {err:.3e} from {twin}'s, "
                                 f"over {bound:.3e}")
    elif not equal or not all(loss_equal):
        raise AssertionError(f"{tag}: not bitwise {twin} (params {equal}, "
                             f"losses {loss_equal})")


# ---------------------------------------------------------------------------
# Slice 17: SlowMo and checkpoints on the rank meshes (closing A.10.1), the
# examples
# ---------------------------------------------------------------------------
SLOWMO_STEPS = 4                    # gossip, slowmo, gossip, slowmo
SLOWMO_LAYERS = 4                   # pga-lm-100m's depth for [sslowmo] and
#                                     [dslowmo] (None: all 12), cut for the
#                                     900 s budget (PERF.md section 7)
SLOWMO_SLOTS = ("slow_params", "slow_u")
D2CKPT_STEPS = 6                    # steps 0-2 write the file, 3-5 resume
EXAMPLES_DIR = ROOT / "_examples_smoke"     # listed in .gitignore
# each example at small arguments on the card, and the lines it must print
EXAMPLES = (
    ("torch_quickstart.py", ("--steps", "4"),
     (r"^=== final metrics \(non-iid ring, H=6\) ===$",
      r"^gossip +loss=\d+\.\d{4} consensus=", r"^local +loss=",
      r"^gossip_pga +loss=")),
    ("torch_train_lm.py", ("--steps", "4", "--ckpt-dir", str(EXAMPLES_DIR)),
     (r"^model pga-lm-reduced: ~\d+\.\dM params, 8 nodes, "
      r"gossip_pga/one_peer_exp H=6$",
      r"^loss \d+\.\d{4} -> \d+\.\d{4} over 4 steps; final consensus ")),
    ("torch_serve_requests.py", (),
     (r"^served 6 requests / 48 tokens in .* on \w+, 2 slots\)$",
      r"^  req 5: prompt\[\d+\] -> \[(\d+, ){7}\d+\]$")),
    ("torch_logistic_regression.py", ("--steps", "100"),
     (r"^n=20 topology=ring non-iid H=16$", r"^    99( +\d+\.\d{5}){5}$",
      r"^  gossip_pga +\d\.\d{3}e[-+]\d\d$")),
)


# the kernel record each launch counter of :func:`counts` belongs to
KERNEL_OF_COUNT = {"mix": "mix_vector_kernel",
                   "mix_vector": "mix_vector_kernel",
                   "mix_nodes": "mix_nodes_kernel",
                   "cmix": "cmix_vector_kernel",
                   "cmix_vector": "cmix_vector_kernel",
                   "cmix_nodes": "cmix_nodes_kernel",
                   "cmix_absmax": "cmix_absmax_kernel",
                   "collective": "collective_kernel",
                   "collective_narrow": "collective_narrow_kernel",
                   "mlstm": "mlstm_kernel",
                   "mlstm_wgmma": "mlstm_wgmma_kernel",
                   "shard_mix": "shard_mix_kernel",
                   "shard_cmix": "shard_cmix_kernel",
                   "shard_cmix_nodes": "shard_cmix_nodes_kernel",
                   "flash": "flash_attention_kernel",
                   "flash_wgmma": "flash_attention_wgmma_kernel",
                   "rmsnorm": "rmsnorm_kernel",
                   "rmsnorm_vector": "rmsnorm_kernel"}


def _slowmo_tcfg(reduced: bool = False):
    """[sslowmo]'s / [dslowmo]'s configuration: [smain]'s (pga-lm-100m,
    8 nodes, one_peer_exp, fused sharded rounds, AdamW, 32 x 512) with
    SlowMo H = 2, β 0.5, 4 steps (:data:`SLOWMO_LAYERS` layers)."""
    tcfg = _dist_tcfg(False, reduced=reduced, steps=SLOWMO_STEPS)
    model = tcfg.model
    if SLOWMO_LAYERS is not None and not reduced:
        model = dataclasses.replace(model, n_layers=SLOWMO_LAYERS)
    return tcfg.replace(model=model, dist=dataclasses.replace(
        tcfg.dist, algorithm="slowmo", H=2, slowmo_beta=0.5))


def slot_fingerprints(torch, state) -> list:
    """SlowMo's slots, each leaf fingerprinted whole (every rank holds
    them whole)."""
    from repro_torch.tree import tree_leaves
    return [[fingerprint(torch, p) for p in tree_leaves(state.extras[s])]
            for s in SLOWMO_SLOTS if s in state.extras]


def run_sslowmo(torch, mc, device: str = "cuda") -> tuple:
    """``[sslowmo]``: SlowMo on a one-process mesh of 4 node shards
    (:func:`_slowmo_tcfg`), the twin of ``[dslowmo]``: B.5 once a shard a
    gossip step, the outer step's x̄ the pairwise halving over all 8 rows;
    consensus 0.0 after every outer step, finite losses.  Returns ``(its
    launches, its reference)``: :func:`smain_reference` and the slots'
    fingerprints."""
    from repro_torch.core.mesh import make_mesh
    from repro_torch.train import Trainer
    card = device != "cpu"
    tag = "[sslowmo]"
    tcfg = _slowmo_tcfg(reduced=not card)
    tr = Trainer(tcfg, n_nodes=MAIN_N, mesh=make_mesh((DIST_K,), ("data",),
                                                      device=device),
                 with_consensus=True, device=device)
    state = tr.init_state(torch.Generator().manual_seed(0))
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, phases = [], []
    for k in range(tcfg.steps):
        t0 = time.perf_counter()
        state = tr.run(state, steps=1, log_every=1)
        if card:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rec = tr.history[-1]
        phases.append(rec["phase"])
        print(f"{tag} step {k} phase={rec['phase']} loss={rec['loss']:.4f}"
              f" consensus={rec['consensus']:.6e} step_ms="
              f"{times[-1] * 1e3:.1f}", flush=True)
        if not math.isfinite(rec["loss"]):
            raise AssertionError(f"{tag} step {k}: loss {rec['loss']}")
        if (rec["phase"] == "slowmo") != (rec["consensus"] == 0.0):
            raise AssertionError(f"{tag} step {k}: consensus "
                                 f"{rec['consensus']} after a "
                                 f"{rec['phase']} step")
    launches = counts()
    expected = only(shard_mix=phases.count("gossip") * DIST_K)
    if card and launches != expected:
        raise AssertionError(f"{tag} launches {launches}, expected "
                             f"{expected} (phases {phases})")
    ref = smain_reference(torch, tr, state, launches)[1]
    ref["slots"] = slot_fingerprints(torch, state)
    steady = statistics.median(times[1:])
    STEADY[tag] = steady
    tokens = tcfg.global_batch * tcfg.seq_len
    print(f"{tag} pga-lm-100m, {tcfg.model.n_layers} layers, {MAIN_N} nodes "
          f"on {DIST_K} node shards in this process, SlowMo H=2 beta 0.5: "
          f"phases {phases}, shard_mix launches {launches['shard_mix']}; "
          f"steady step {steady * 1e3:.1f} ms (median of steps 1-"
          f"{tcfg.steps - 1}; the outer steps "
          f"{[round(t * 1e3, 1) for t, p in zip(times, phases) if p == 'slowmo']}"
          f" ms), {tokens / steady:.0f} tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9 if card else 0:.2f} GB",
          flush=True)
    del tr, state
    if card:
        torch.cuda.empty_cache()
    return launches, ref


def _d2ckpt_tcfg(card: bool):
    """[d2ckpt]'s configuration: [d2cmain]'s (int8 gossip + int8
    collective + EF, H = 3, AdamW, n = 4) at :data:`CKPT_CUT_LAYERS`
    layers, 6 steps, a checkpoint after step 2 into :data:`CKPT_DIR`."""
    tcfg = _dist_tcfg(True, reduced=not card, nodes=D2_N,
                      steps=D2CKPT_STEPS)
    return tcfg.replace(model=dataclasses.replace(
        tcfg.model, n_layers=CKPT_CUT_LAYERS), ckpt_every=3,
        ckpt_dir=str(CKPT_DIR))


def state_fingerprints(torch, state, k: int) -> list:
    """Per node shard r of k, ``{checkpoint key: fingerprint}`` of every
    tensor of the state (params, optimizer state, extras): its rows of the
    node-stacked leaves, the others whole."""
    from repro_torch.checkpoint.ckpt import _flatten, _node_axis_keys
    flat = {key: v for key, v in _flatten(state).items()
            if torch.is_tensor(v)}
    rows = flat[next(key for key in flat if key.startswith(".params/"))]
    m = rows.shape[0] // k
    stacked = _node_axis_keys(flat, rows.shape[0])
    return [{key: fingerprint(torch, v[r * m:(r + 1) * m] if key in stacked
                              else v) for key, v in flat.items()}
            for r in range(k)]


def d2ckpt_reference(torch, device: str = "cuda") -> dict:
    """The one-process twin of ``[d2ckpt]``: the (data=2, model=2) Trainer
    in this process, its 6 steps uninterrupted; its state after step 2
    kept on the host (a clone), its final state's fingerprints per node
    shard.  Checks the disk and this run's write budget for the ranks'
    file and counts it in :data:`CKPT_WRITTEN`."""
    import shutil

    from repro_torch.checkpoint.ckpt import _flatten
    from repro_torch.core.mesh import make_mesh
    from repro_torch.train import Trainer
    card = device != "cpu"
    tcfg = _d2ckpt_tcfg(card).replace(ckpt_every=0)
    tr = Trainer(tcfg, n_nodes=D2_N, mesh=make_mesh(*D2_AXES, device=device),
                 with_consensus=True, device=device)
    state = tr.init_state(torch.Generator().manual_seed(0))
    nbytes = _state_bytes(state)
    free = shutil.disk_usage(ROOT).free
    if free < nbytes + (1 << 30):
        raise AssertionError(f"[d2ckpt]: {free / 1e9:.1f} GB free on the "
                             f"disk, the ranks write a {nbytes / 1e9:.2f} GB "
                             f"checkpoint")
    if CKPT_WRITTEN[0] + nbytes > CKPT_WRITE_BUDGET:
        raise AssertionError(f"[d2ckpt]: a {nbytes / 1e9:.2f} GB checkpoint "
                             f"after {CKPT_WRITTEN[0] / 1e9:.2f} GB would "
                             f"pass this run's write budget of "
                             f"{CKPT_WRITE_BUDGET / 2**30:.0f} GiB")
    CKPT_WRITTEN[0] += nbytes
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    state = tr.run(state, steps=3, log_every=1)
    at3 = {key: v.detach().cpu().clone() if torch.is_tensor(v) else v
           for key, v in _flatten(state).items()}
    state = tr.run(state, steps=3, log_every=1)
    ref = dict(fps=state_fingerprints(torch, state, D2_AXES[0][0]),
               losses=[h["loss"] for h in tr.history], at3=at3,
               nbytes=nbytes)
    print(f"[d2ckpt] the one-process twin "
          f"({dict(zip(D2_AXES[1], D2_AXES[0]))}, "
          f"{D2_N} nodes, {tcfg.model.n_layers} layers, int8+EF): 6 steps "
          f"uninterrupted, losses {[round(x, 4) for x in ref['losses']]}; "
          f"state {nbytes / 1e9:.3f} GB, the step-3 state kept on the host; "
          f"{free / 1e9:.1f} GB free on the disk, "
          f"{CKPT_WRITTEN[0] / 1e9:.2f} GB of this run's checkpoint writes",
          flush=True)
    del tr, state
    if card:
        torch.cuda.empty_cache()
    return ref


def _d2ckpt_rank(torch, dist, mesh, ref, card: bool, twins: dict) -> dict:
    """This rank's ``[d2ckpt]``: steps 0-2 of :func:`_d2ckpt_tcfg` with
    ``ckpt_every=3`` (one collective save, timed, the exchange's bytes and
    pinned peak read around it), then a fresh Trainer restores the file on
    the same (data=2, model=2) mesh (timed) and runs steps 3-5.  Returns
    the times, bytes, losses, launches and whether each part of the
    resumed state is bitwise the twin's rows (``ref``)."""
    from repro_torch import checkpoint as ck
    from repro_torch.train import Trainer
    sync = torch.cuda.synchronize if card else (lambda: None)
    tcfg = _d2ckpt_tcfg(card)
    tr = Trainer(tcfg, n_nodes=D2_N, mesh=mesh, with_consensus=True,
                 device=mesh.device)
    state = tr.init_state(torch.Generator().manual_seed(0))
    ex = mesh.exchange                  # the save gathers over the node axis
    sync()
    dist.barrier()
    reset_counts()
    for key in twins:
        twins[key] = 0
    saves = []
    real_save = ck.save_checkpoint

    def timed_save(d, st, step, **kw):
        ex.reset_stats()
        sync()
        t0 = time.perf_counter()
        path = real_save(d, st, step, **kw)
        saves.append(dict(step=step, s=time.perf_counter() - t0,
                          bytes_in=ex.stats["bytes_in"],
                          bytes_out=ex.stats["bytes_out"],
                          size=os.path.getsize(path),
                          pinned_after=ex.pinned_bytes))
        return path

    ck.save_checkpoint = timed_save
    try:
        state = tr.run(state, steps=3, log_every=1)
    finally:
        ck.save_checkpoint = real_save
    losses = [h["loss"] for h in tr.history]
    del state, tr
    tr = Trainer(tcfg.replace(ckpt_every=0), n_nodes=D2_N, mesh=mesh,
                 with_consensus=True, device=mesh.device)
    template = tr.init_state(torch.Generator().manual_seed(0))
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    restored = ck.restore_checkpoint(str(CKPT_DIR), template, step=3,
                                     mesh=mesh)
    sync()
    restore_s = time.perf_counter() - t0
    del template
    resumed = tr.run(restored, steps=3, log_every=1)
    sync()
    del restored
    losses += [h["loss"] for h in tr.history]
    launches = counts()
    # each part of the resumed state bitwise the twin's rows of this
    # rank's node shard (whole leaves: the rank holds its rows only)
    from repro_torch.checkpoint.ckpt import _flatten
    equal = {}
    want = ref["fps"][mesh.node_rank] if ref else {}
    for key, v in _flatten(resumed).items():
        if not torch.is_tensor(v) or not ref:
            continue
        parts = key.lstrip(".").split("/")
        group = "/".join(parts[:2]) if parts[0] in ("opt_state", "extras") \
            else parts[0]
        equal[group] = equal.get(group, True) and \
            fingerprint(torch, v) == want.get(key)
    out = dict(saves=saves, restore_s=restore_s, losses=losses,
               launches=launches, twins=dict(twins), equal=equal,
               coords=(mesh.node_rank, mesh.model_rank),
               pinned_peak=mesh.exchange.pinned_peak,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9 if card
               else 0)
    del resumed, tr
    return out


def _report_dslowmo(recs: list, ref: dict, failures: list) -> None:
    """[dslowmo]'s slots against [sslowmo]'s on every rank, and its outer
    steps: the slowest rank's ms, each rank's exchange bytes (x̄'s halving
    and its broadcast)."""
    want = ref["slots"] if ref else None
    equal = [rec.get("slot_fps") == want for rec in recs]
    outer = []
    for k, s in enumerate(recs[0]["steps"]):
        if s["phase"] != "slowmo":
            continue
        moved = [(round(rec["steps"][k]["bytes"][0][0] / 1e9, 3),
                  round(rec["steps"][k]["bytes"][0][1] / 1e9, 3))
                 for rec in recs]
        outer.append(f"step {k} {max(rec['steps'][k]['ms'] for rec in recs):.1f}"
                     f" ms, GB (out, in) per rank {moved}")
    print(f"[dslowmo] slow_params and slow_u bitwise [sslowmo]'s on every "
          f"rank {equal}; the outer steps (slowest rank): "
          f"{'; '.join(outer)}", flush=True)
    if not all(equal):
        failures.append(f"[dslowmo] slots not bitwise [sslowmo]'s {equal}")


def _report_d2ckpt(recs: list, ref: dict, failures: list) -> dict:
    """[d2ckpt]: the save and restore times and rates, the bytes gathered
    to the writer, the pinned peak, and the gates: one save (after step 2)
    on every rank, the resumed state bitwise the twin's rows on every
    rank, its losses the twin's within rtol ``RANK_LOSS_RTOL``, B.4 once a
    rank a gossip step, no plain twin.  Returns the launches summed over
    the ranks."""
    summed = {k: sum(rec["launches"][k] for rec in recs) for k in counts()}
    per_rank = [rec["launches"]["shard_cmix"] for rec in recs]
    saves = [rec["saves"] for rec in recs]
    writer = recs[0]["saves"][0] if recs[0]["saves"] else None
    equal = [rec["equal"] for rec in recs]
    worst = max(abs(a - b) / abs(b) for a, b in
                zip(recs[0]["losses"], ref["losses"])) if ref else 0.0
    restore_s = max(rec["restore_s"] for rec in recs)
    if writer:
        size, save_s = writer["size"], max(s[0]["s"] for s in saves if s)
        print(f"[d2ckpt] pga-lm-100m at {CKPT_CUT_LAYERS} of 12 layers, "
              f"{D2_N} nodes on {DIST_K} ranks of {dict(zip(D2_AXES[1], D2_AXES[0]))}"
              f", int8+EF H=3: file {size / 1e9:.3f} GB ({size:,} bytes); "
              f"save {save_s:.2f} s (slowest rank, gathers and the write), "
              f"{size / save_s / 1e9:.2f} GB/s; restore {restore_s:.2f} s "
              f"(slowest rank, each reading its rows of every member), "
              f"{size / restore_s / 1e9:.2f} GB/s of the file; bytes gathered "
              f"to rank 0 {writer['bytes_in']:,}, sent per rank "
              f"{[s[0]['bytes_out'] if s else 0 for s in saves]}; pinned "
              f"peak per rank {[rec['pinned_peak'] for rec in recs]} bytes, "
              f"after the save {[s[0]['pinned_after'] if s else 0 for s in saves]}"
              f"; losses within rtol {worst:.3e} of the twin's; resumed "
              f"state bitwise the twin's rows per rank {equal}; shard_cmix "
              f"launches per rank {per_rank}; peak memory per rank "
              f"{[round(rec['peak_gb'], 2) for rec in recs]} GB", flush=True)
    if [[s["step"] for s in sv] for sv in saves] != [[3]] * DIST_K:
        failures.append(f"[d2ckpt] saves {[[s['step'] for s in sv] for sv in saves]}")
    if not all(e and all(e.values()) for e in equal):
        failures.append(f"[d2ckpt] resumed state not bitwise the twin's "
                        f"{equal}")
    if worst > RANK_LOSS_RTOL:
        failures.append(f"[d2ckpt] losses rtol {worst:.3e} against the twin")
    if per_rank != [4] * DIST_K or summed != only(shard_cmix=4 * DIST_K):
        failures.append(f"[d2ckpt] launches per rank {per_rank}, summed "
                        f"{summed}")
    if any(v for rec in recs for v in rec["twins"].values()):
        failures.append(f"[d2ckpt] plain twins called "
                        f"{[rec['twins'] for rec in recs]}")
    return summed


def _d2ckpt_twin_restores(torch, ref: dict, device: str,
                          failures: list) -> None:
    """Gate 2 of [d2ckpt]: the one-process twin restores the ranks' file
    (``mesh=`` its one-process (data=2, model=2) mesh) and its state is
    bitwise its own step-3 state, kept on the host; then the file goes."""
    import shutil

    from repro_torch import checkpoint as ck
    from repro_torch.checkpoint.ckpt import _flatten
    from repro_torch.core.mesh import make_mesh
    from repro_torch.train import Trainer
    card = device != "cpu"
    tr = Trainer(_d2ckpt_tcfg(card).replace(ckpt_every=0), n_nodes=D2_N,
                 mesh=make_mesh(*D2_AXES, device=device),
                 with_consensus=True, device=device)
    t0 = time.perf_counter()
    restored = ck.restore_checkpoint(str(CKPT_DIR), tr.init_state(
        torch.Generator().manual_seed(0)), step=3, mesh=tr.mesh)
    dt = time.perf_counter() - t0
    flat = _flatten(restored)
    want = ref["at3"]
    bad = [key for key, v in flat.items() if key not in want or (
        not _bitwise(torch, v.detach().cpu(), want[key])
        if torch.is_tensor(v) else v != want[key])]
    print(f"[d2ckpt] the one-process twin restores the ranks' file in "
          f"{dt:.2f} s: its state bitwise its own step-3 state "
          f"{not bad and len(flat) == len(want)} ({len(flat)} leaves)",
          flush=True)
    if bad or len(flat) != len(want):
        failures.append(f"[d2ckpt] the twin's restore differs at {bad[:5]}")
    del restored, tr
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    if card:
        torch.cuda.empty_cache()


def run_examples(torch) -> dict:
    """``[examples]``: each ``examples/torch_*.py`` on :data:`DEVICE` (the
    card) at small arguments (:data:`EXAMPLES`), run in this process
    (``runpy``), its output captured and held to the lines it must print.
    Returns each one's launches."""
    import contextlib
    import io
    import re
    import runpy
    import shutil
    launches = {}
    t_all = time.perf_counter()
    for script, args, lines in EXAMPLES:
        shutil.rmtree(EXAMPLES_DIR, ignore_errors=True)
        buf = io.StringIO()
        argv = sys.argv
        sys.argv = [script, "--device", DEVICE, *args]
        reset_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                runpy.run_path(str(ROOT / "examples" / script),
                               run_name="__main__")
            if DEVICE == "cuda":
                torch.cuda.synchronize()
        finally:
            sys.argv = argv
        dt = time.perf_counter() - t0
        if EXAMPLES_DIR.exists():
            CKPT_WRITTEN[0] += sum(p.stat().st_size
                                   for p in EXAMPLES_DIR.iterdir())
        out = buf.getvalue()
        missing = [p for p in lines if not re.search(p, out, re.M)]
        launches[script] = {k: v for k, v in counts().items() if v}
        last = out.strip().splitlines()[-1] if out.strip() else ""
        print(f"[examples] {script} {' '.join(args)}: {dt:.1f} s, launches "
              f"{launches[script]}; {len(out.splitlines())} lines, the last "
              f"{last!r}", flush=True)
        if missing:
            raise AssertionError(f"[examples] {script} printed none of "
                                 f"{missing}:\n{out[-2000:]}")
    shutil.rmtree(EXAMPLES_DIR, ignore_errors=True)
    print(f"[examples] the four examples in "
          f"{time.perf_counter() - t_all:.1f} s; this run's checkpoint "
          f"writes {CKPT_WRITTEN[0] / 1e9:.2f} GB of the "
          f"{CKPT_WRITE_BUDGET / 2**30:.0f} GiB budget", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Slice 18: the dry-run and roofline tooling on meta tensors with H100
# peaks ([dryrun]), held against a real pga-lm-100m step on the card
# ([drycard]); [main]'s step against the roofline ([roofline]); row 1b of
# the kernel table (mix.cu's generic instance at n = 2)
# ---------------------------------------------------------------------------
# [main]'s n, batch, length, topology and H (its optimizer is MAIN_OPT)
DRYCARD = dict(n=8, per_node=4, seq=512, topology="one_peer_exp", H=3)
# |measured - predicted| peak of a [drycard] step, in bytes: the caching
# allocator rounds every block up to 512 bytes (1,520-3,556 B over
# thousands of live blocks measured on an H100) and a CUDA op may take
# scratch the meta run does not see (PERF.md §2)
DRYCARD_PEAK_TOL = 16 * 2**20
DRYSERVE = ("2d", "tp_seq")                     # hillclimb exp1's variants


def _roofline_line(tag: str, what: str, rl: dict, wall_s: float,
                   coll_modelled: str) -> None:
    """One record's roofline terms; ``coll_modelled`` "none" (a serve
    step) prints no collective term and no collective verdict."""
    if coll_modelled == "none":
        coll = ("collective not modelled (of compute and memory, dominant "
                f"{rl['dominant']}")
    else:
        coll = (f"collective ({coll_modelled} only) {rl['collective_s']:.4e}"
                f" s a chip (dominant {rl['dominant']}; "
                f"{rl['coll_bytes']:.4e} collective bytes")
    print(f"{tag} {what}: compute {rl['compute_s']:.4e} s, memory "
          f"{rl['memory_s']:.4e} s, {coll}; {rl['flops']:.4e} FLOPs, "
          f"{rl['hlo_bytes']:.4e} bytes a chip; model FLOPs "
          f"{rl['model_flops']:.4e}); meta run {wall_s:.2f} s", flush=True)


def run_dryrun_path() -> dict:
    """``[dryrun]``: the dry-run on the host, on meta tensors, at full
    published size on the ``(data=16, model=16)`` production mesh
    description: ``run_one("pga-lm-100m", "train_4k", "single")`` (both
    phases) and gemma2-9b × decode_32k under ``param_sharding`` "2d" and
    "tp_seq" (hill-climb exp1's two variants).  Every figure is analytic
    for the H100 (``repro_torch.roofline``); a record that is not ok
    fails the run."""
    from repro_torch.configs import INPUT_SHAPES, get_model_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    tag = "[dryrun]"
    t0 = time.perf_counter()
    rec = dryrun.run_one("pga-lm-100m", "train_4k", "single")
    wall = time.perf_counter() - t0
    if not rec.get("ok"):
        raise AssertionError(f"{tag} pga-lm-100m train_4k: "
                             f"{rec.get('error')}\n{rec.get('traceback')}")
    for phase, p in rec["phases"].items():
        _roofline_line(tag, f"pga-lm-100m train_4k single {phase} "
                       f"({rec['n_nodes']} nodes, {rec['mode']})",
                       p["roofline"], p["compile_s"], p["coll_modelled"])
    gossip = rec["phases"]["gossip"]
    print(f"{tag} pga-lm-100m train_4k: memory a chip {gossip['memory']}, "
          f"wire {gossip['wire']}; run_one {wall:.2f} s", flush=True)
    mesh = make_production_mesh(device="meta")
    cfg = get_model_config("gemma2-9b")
    serve = {}
    for ps in DRYSERVE:
        t0 = time.perf_counter()
        r = dryrun.dryrun_serve(cfg, INPUT_SHAPES["decode_32k"], mesh,
                                param_sharding=ps)
        wall = time.perf_counter() - t0
        _roofline_line(tag, f"gemma2-9b decode_32k {ps} ({r['mode']})",
                       r["roofline"], wall, r["coll_modelled"])
        print(f"{tag} gemma2-9b decode_32k {ps}: memory a chip "
              f"{r['memory']}", flush=True)
        serve[ps] = r
    return {"train": rec, "serve": serve}


def run_drycard_path(torch) -> dict:
    """``[drycard]``: the dry-run held against the card.  pga-lm-100m at
    full width with [main]'s n = 8, per-node batch, sequence length,
    topology, H = 3 and optimizer (:data:`MAIN_OPT`), the default
    ``DistConfig()`` backend ("reference", where [main] runs mix.cu), on
    a one-process ``make_mesh((8, 1), ("data", "model"))`` with every
    block on this card, beside ``dryrun_train`` of the same config,
    optimizer, shape and mesh on meta tensors.  Three steps, each after
    ``reset_peak_memory_stats``: step 0 (gossip) and step 2 (global)
    under ``FlopCounterMode``, step 1 (gossip) under no dispatch mode (a
    Python dispatch mode makes autograd accumulate gradients out of
    place, so step 1 is the step users run).  Gates: the card's FLOPs
    equal the dry-run's (per chip × 8) in both phases; the argument bytes
    (per chip × 8, the replicated leaves once) equal the state's and the
    batch's bytes on the card; every step's peak above what else is live
    within :data:`DRYCARD_PEAK_TOL` of its phase's predicted argument +
    temp."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import (DistConfig, InputShape, OptimizerConfig,
                                     TrainConfig, get_model_config)
    from repro_torch.core.mesh import make_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import train_specs
    from repro_torch.train import Trainer

    tag, n = "[drycard]", DRYCARD["n"]
    cfg = get_model_config("pga-lm-100m")
    dist = DistConfig(algorithm="gossip_pga", topology=DRYCARD["topology"],
                      H=DRYCARD["H"])
    opt = OptimizerConfig(**MAIN_OPT)
    shape = InputShape("drycard", DRYCARD["seq"], n * DRYCARD["per_node"],
                       "train")
    meta_mesh = make_mesh((n, 1), ("data", "model"), device="meta")
    t0 = time.perf_counter()
    rec = dryrun.dryrun_train(cfg, shape, meta_mesh, dist=dist,
                              optimizer=opt)
    specs = train_specs(cfg, meta_mesh, shape, dist=dist, optimizer=opt)
    _, replicated = dryrun.argument_bytes(
        (specs.state_sds, specs.batch_sds),
        (specs.state_shardings, specs.batch_shardings), meta_mesh)
    dry_s = time.perf_counter() - t0
    del specs
    tcfg = TrainConfig(model=cfg, dist=dist, optimizer=opt,
                       global_batch=shape.global_batch, seq_len=shape.seq_len,
                       steps=3, log_every=1)
    tr = Trainer(tcfg, n_nodes=n, device=DEVICE,
                 mesh=make_mesh((n, 1), ("data", "model"), device=DEVICE))
    state = tr.init_state(torch.Generator().manual_seed(0))
    state_b = _state_bytes(state)
    batch_b = sum(t.numel() * t.element_size()
                  for t in tr.device_batch(0).values())
    print(f"{tag} pga-lm-100m at full width, {n} nodes x {DRYCARD['per_node']}"
          f" sequences of {DRYCARD['seq']}, {dist.algorithm} over "
          f"{dist.topology} H={dist.H}, backend {dist.comm_backend}, "
          f"{tcfg.optimizer.name} ({tcfg.optimizer.schedule}), mesh "
          f"(data={n}, model=1) on the card; state {state_b:,} bytes, batch "
          f"{batch_b:,}; dryrun_train {dry_s:.2f} s", flush=True)
    out = {"flops": {}, "bytes": {}, "peak": {}}
    failures = []
    card = DEVICE == "cuda"
    for k, (phase, counted) in enumerate((("gossip", True),
                                          ("gossip", False),
                                          ("global", True))):
        _sync(torch)
        other = torch.cuda.memory_allocated() - state_b if card else 0
        _reset_peak(torch)
        t0 = time.perf_counter()
        with (FlopCounterMode(display=False) if counted
              else contextlib.nullcontext()) as fc:
            state = tr.run(state, steps=1, log_every=1)
        _sync(torch)
        step_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - other if card else 0
        got = tr.history[-1]["phase"]
        p = rec["phases"][phase]
        predicted = (p["memory"]["argument_size_in_bytes"] - replicated) * n \
            + replicated + p["memory"]["temp_size_in_bytes"]
        mode = "under FlopCounterMode" if counted else "under no mode"
        print(f"{tag} step {k} phase={got} {mode}: peak predicted "
              f"{predicted:,} (argument + temp "
              f"{p['memory']['temp_size_in_bytes']:,}) vs "
              f"torch.cuda.max_memory_allocated {peak:,} above the "
              f"{other:,} other live bytes (measured - predicted "
              f"{peak - predicted:+,}, "
              f"{100 * (peak - predicted) / predicted:+.3f}%); step "
              f"{step_ms:.1f} ms", flush=True)
        out["peak"][phase if counted else "plain"] = (predicted, peak)
        if got != phase:
            failures.append(f"step {k} ran {got}, not {phase}")
        if abs(peak - predicted) > DRYCARD_PEAK_TOL:
            failures.append(f"step {k} {phase}: peak {peak} vs predicted "
                            f"{predicted} beyond {DRYCARD_PEAK_TOL}")
        if not counted:
            continue
        card_flops = fc.get_total_flops()
        dry_flops = p["roofline"]["flops"] * n
        arg = p["memory"]["argument_size_in_bytes"]
        arg_total = (arg - replicated) * n + replicated
        print(f"{tag} step {k} phase={got}: FLOPs on the card "
              f"{card_flops:,} (FlopCounterMode), dry-run {dry_flops:,.0f} "
              f"({p['roofline']['flops']:,.0f} a chip x {n}): equal "
              f"{card_flops == dry_flops}; argument bytes {arg:,} a chip x "
              f"{n} ({replicated:,} replicated, once) = {arg_total:,} vs the "
              f"state {state_b:,} + batch {batch_b:,} on the card: equal "
              f"{arg_total == state_b + batch_b}", flush=True)
        out["flops"][phase] = card_flops
        out["bytes"][phase] = p["roofline"]["hlo_bytes"] * n
        if card_flops != dry_flops:
            failures.append(f"{phase}: FLOPs {card_flops} != {dry_flops}")
        if arg_total != state_b + batch_b:
            failures.append(f"{phase}: argument bytes {arg_total} != "
                            f"{state_b + batch_b}")
    del state, tr
    if failures:
        raise AssertionError(f"{tag} {failures}")
    return out


def run_analysis_path() -> None:
    """``[analysis]``: the port's static analysis (RPR001-RPR006 over its
    default targets: ``src/repro_torch``, ``tests/test_torch_*.py``,
    ``examples/torch_*.py`` and this script) through the CLI's ``main``,
    in this process.  Fails unless it exits 0, i.e. no finding outside
    an allow marker or the port's baseline."""
    import io

    from repro_torch.analysis.__main__ import main as analysis_main
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = analysis_main(["--root", str(ROOT), "--format", "json"])
    seconds = time.perf_counter() - t0
    doc = json.loads(out.getvalue())
    print(f"[analysis] python -m repro_torch.analysis --root {ROOT}: exit "
          f"{rc}, {len(doc['findings'])} finding(s), {doc['suppressed']} "
          f"suppressed by allow markers, {doc['baselined']} baselined, in "
          f"{seconds:.2f} s", flush=True)
    if rc != 0:
        raise AssertionError(f"[analysis] exit {rc}: "
                             f"{json.dumps(doc['findings'], indent=1)}")


def run_roofline_report(drycard: dict) -> None:
    """``[roofline]``: [main]'s steady step (its ``STEADY`` entry) against
    the H100 roofline: the model-FLOP share ``model_flops_for(cfg, shape,
    1) / (step_s · PEAK_FLOPS)``, the counted FLOPs' share (the matmul
    FLOPs that ``FlopCounterMode`` counted in [drycard]'s gossip step:
    [main]'s model, batch, length, optimizer, topology and H) and the
    memory term (that step's unfused bytes from the dry-run, over
    ``HBM_BW``) against the step.  [drycard]'s round is the reference
    backend's where [main]'s is mix.cu, so the memory term counts the
    round's unfused passes, not the fused kernel's.  A share over 1.0
    fails the run: a count would be wrong."""
    from repro_torch.configs import InputShape, get_model_config
    from repro_torch.roofline import HBM_BW, PEAK_FLOPS, model_flops_for
    tag = "[roofline]"
    cfg = get_model_config("pga-lm-100m")
    shape = InputShape("[main]", DRYCARD["seq"],
                       DRYCARD["n"] * DRYCARD["per_node"], "train")
    step_s = STEADY["[main]"]
    mf = model_flops_for(cfg, shape, 1)
    shares = {"model FLOPs": mf / (step_s * PEAK_FLOPS),
              "counted FLOPs": drycard["flops"]["gossip"]
              / (step_s * PEAK_FLOPS)}
    mem_s = drycard["bytes"]["gossip"] / HBM_BW
    print(f"{tag} [main] steady step {step_s * 1e3:.1f} ms: model FLOPs "
          f"{mf:.4e} (6 x {mf / 6 / (shape.global_batch * shape.seq_len):,.0f}"
          f" active params x {shape.global_batch * shape.seq_len:,} tokens), "
          f"share {shares['model FLOPs']:.4f}; counted FLOPs "
          f"{drycard['flops']['gossip']:.4e}, share "
          f"{shares['counted FLOPs']:.4f}; memory term "
          f"{mem_s * 1e3:.1f} ms ({drycard['bytes']['gossip']:.4e} unfused "
          f"bytes of [drycard]'s gossip step, the reference round in "
          f"place of mix.cu, at {HBM_BW / 1e12:.2f} TB/s), "
          f"{mem_s / step_s:.3f} of the step", flush=True)
    print(f"{tag} each share divides by the step times PEAK_FLOPS = "
          f"{PEAK_FLOPS / 1e12:.1f} TFLOP/s, the H100's dense bf16 "
          f"tensor-core peak; [main] trains fp32 params with bf16 "
          f"matmuls and fp32 optimizer passes, and no peak is chosen here "
          f"for a benchmark", flush=True)
    over = {k: v for k, v in shares.items() if not 0.0 < v <= 1.0}
    if over:
        raise AssertionError(f"{tag} shares outside (0, 1]: {over}")


def check_mix_n2_kernel(torch, mc) -> dict:
    """Row 1b: mix.cu at n = 2 (the register instance at V = 4 since PR
    33; the generic one before), at [moetrain]'s widest dispatch group,
    read from the meta init of its config (no card memory): the fused
    gossip round with the consensus residual as the Trainer launches it,
    against its plain version (max|o − o_plain| and max|x̄ − x̄_plain| ≤
    1e-5·max|x|, the residual within rtol 1e-5) and bitwise against the
    generic instance (o and x̄), then both instances timed by
    :func:`device_ms` in turns beside the bound by bytes and
    ``torch.matmul`` of the mixing factor."""
    n = MOETRAIN["n"]
    widths = two_node_widths(mc)["[moetrain]"]
    D = max(widths)
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(n, D, device="cuda", generator=gen)
    if mc.mix_vector_width(x) != 4:
        raise AssertionError(f"n = 2 at D = {D}: vector width "
                             f"{mc.mix_vector_width(x)}, not 4")
    d, M = (torch.from_numpy(a).cuda()
            for a in mc.phase_matrices("gossip", "one_peer_exp", n))
    kw = dict(with_g=False, with_residual=True, wire=False)
    out = mc.mix_flat(x, None, None, d, M, **kw)
    ref = mc.mix_flat_plain(x, None, None, d, M, **kw)
    err = max(float((out[0] - ref[0]).abs().max()),
              float((out[1] - ref[1]).abs().max()))
    rel = abs(float(out[2]) - float(ref[2])) / max(abs(float(ref[2])), 1e-30)
    tol = 1e-5 * float(x.abs().max())
    del ref
    if err > tol or rel > 1e-5:
        raise AssertionError(f"mix n=2 D={D}: max abs err {err:.3e} (tol "
                             f"{tol:.3e}), residual rel err {rel:.3e}")
    old = mc.mix_generic(x, None, None, d, M, **kw)
    if not (torch.equal(out[0], old[0]) and torch.equal(out[1], old[1])):
        raise AssertionError(f"mix n=2 D={D}: the register instance differs "
                             f"from the generic one")
    del out, old
    old_ms, ms = _turns(
        torch, lambda: mc.mix_generic(x, None, None, d, M, **kw),
        lambda: mc.mix_vector(x, None, None, d, M, **kw))
    plain_ms = cuda_ms(torch,
                       lambda: mc.mix_flat_plain(x, None, None, d, M, **kw))
    W = M + torch.diag(d[:, 0])
    # the card's host takes ~8.5 ms to queue one such product: five fit
    # in device_ms's spin
    library_ms = device_ms(torch, lambda: torch.matmul(W, x), iters=5)
    bytes_moved = 4 * (n * D + n * D + D)      # read x, write o and x̄
    flops = 2 * n * n * D + 4 * n * D
    bound_ms, bound_by = _bound(bytes_moved, flops)
    print(f"[kernel] mix n={n} D={D:,} residual ([moetrain]'s widest of "
          f"{len(widths)} dispatch groups {widths}): register instance V = 4 "
          f"{ms:.4f} ms, generic instance {old_ms:.4f} ms (device_ms, in "
          f"turns; bitwise equal), plain {plain_ms:.4f} ms, "
          f"torch.matmul(W, x) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"by {bound_by} ({bytes_moved / (ms * 1e-3) / 1e9:.0f} GB/s "
          f"achieved, {100 * bound_ms / ms:.1f}% of the bound); max abs err "
          f"{err:.3e}", flush=True)
    del x
    return {"name": "mix_kernel_n2", "route": "cuda",
            "source": "src/repro_torch/csrc/mix.cu",
            "replaces": "src/repro/kernels/mixing_pallas.py:215",
            "launches": None, "max_abs_err": err, "ms": ms,
            "old_ms": old_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "shape": [n, D], "vector_width": 4}


def main() -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels, then stop (no main "
                         "paths, no ok line)")
    ap.add_argument("--overlap-compare", action="store_true",
                    help="build, then time the overlapped step serial "
                         "against issued in turns, in one process and on 4 "
                         "ranks, and stop (no ok line)")
    args = ap.parse_args()
    start = time.perf_counter()

    def lap(what: str) -> None:
        print(f"[time] {what} done at {time.perf_counter() - start:.1f} s "
              f"of the script", flush=True)

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
    from repro_torch.models import layers
    card = smi()
    print(f"[device] {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}; "
          f"{os.cpu_count()} host cores, the init's draw pool "
          f"{layers.INIT_THREADS} threads", flush=True)
    t0 = time.perf_counter()
    cuda_build.build()
    if args.overlap_compare:
        run_overlap_compare(torch)
        return 1
    print(f"[build] {', '.join(f'{k}.cu' for k in cuda_build.LIBRARIES)} "
          f"in {time.perf_counter() - t0:.1f} s, one nvcc each in parallel "
          f"({cuda_build._Libs.build_seconds})", flush=True)
    for name, log in cuda_build._Libs.build_log.items():
        print(f"[build] {name}.cu:\n{log.strip()}", flush=True)
    for name in ("flash_attention_wgmma", "mlstm_wgmma"):
        print(f"[build] {name}.cu: {hgmma_count(cuda_build, name)}",
              flush=True)
    for name, kernel in (("mix", "mix_vector_kernel"),
                         ("mix", "mix_nodes_kernel"),
                         ("cmix", "cmix_vector_kernel"),
                         ("cmix", "cmix_nodes_kernel"),
                         ("shard_cmix", "shard_cmix_nodes_kernel"),
                         ("collective", "collective_narrow_kernel"),
                         ("mlstm", "mlstm_kernel"),
                         ("mlstm_wgmma", "mlstm_wgmma_kernel"),
                         ("flash_attention", "flash_kernel")):
        log = cuda_build._Libs.build_log.get(name)
        lines = (["built before this run: no ptxas report"] if log is None
                 else register_report(log, kernel))
        if name in SASS_KERNELS and kernel.endswith("vector_kernel"):
            lines += sass_memory_counts(cuda_build, name)
        for line in lines:
            print(f"[build] {name}.cu: {line}", flush=True)
    records = {}

    def add(*found):
        for rec in found:
            records[rec["name"]] = rec

    add(check_mix_kernel(torch, mc))
    torch.cuda.empty_cache()
    add(check_mix_nodes_kernel(torch, mc))
    add(check_mix_n2_kernel(torch, mc))
    torch.cuda.empty_cache()
    add(*check_cmix_kernel(torch, mc))
    torch.cuda.empty_cache()
    add(check_cmix_nodes_kernel(torch, mc))
    records["mix_nodes_kernel"]["rule"] = nodes_rule_times(torch, mc)
    add(check_collective_kernel(torch, mc))
    add(check_collective_narrow_kernel(torch, mc))
    torch.cuda.empty_cache()
    add(*check_mlstm_kernel(torch, mk))
    torch.cuda.empty_cache()
    add(*check_shard_mix_kernel(torch, mc))
    add(*check_shard_cmix_kernel(torch, mc))
    add(check_shard_cmix_nodes_kernel(torch, mc))
    add(*check_flash_kernel(torch, fa))
    torch.cuda.empty_cache()
    add(check_rmsnorm_kernel(torch, rn))
    # rows 4d and 3 at the simulators' n = 100: each redesign against its
    # old instance, and the two dispatch rules' crossovers
    sim_rows = sim_shape_rows(torch, mc)
    for name, row, rule in (("shard_cmix_nodes_kernel", "apply",
                             "shard_rule"),
                            ("collective_narrow_kernel", "narrow",
                             "collective_rule")):
        rec = sim_rows[row]
        records[name].update(
            {k: rec[k] for k in ("ms", "old_ms", "floor_ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")},
            shape=rec["shape"], rule=sim_rows[rule])
    lap("the build and the kernel checks")
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
    # slice 10: the telemetry hub on [main]'s cell, right after it
    slice10 = {}
    for fence in (False, True):
        slice10["[telfence]" if fence else "[tel]"] = run_tel_path(
            torch, mc, fence)
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
    from repro_torch.tree import tree_leaves
    smain, shapes, ref_params = {}, None, {}
    for compressed in (False, True):
        tag = "[dcmain]" if compressed else "[dmain]"
        launches, tr, state = run_main_path(
            torch, mc, compressed=compressed, sharded=True, trace=compressed,
            snapshot_at=DIST_STEPS[tag] - 1)
        key = "shard_cmix" if compressed else "shard_mix"
        records[f"{key}_kernel"]["launches"] = launches[key]
        # what the rank phases of slice 15 and the 2-D paths of slice 16
        # are held against: the 1-D rank paths at their last step
        shapes, smain[tag] = smain_reference(
            torch, tr, state, launches,
            at=SNAPSHOT.pop("[scmain]" if compressed else "[smain]"))
        if compressed:
            smain[tag]["trace"] = TRACE["[scmain]"]
        ref_params["[scmain]" if compressed else "[smain]"] = [
            p.detach().clone() for p in tree_leaves(state.params)]
        sharded_round_times(torch, mc, tr, state, compressed)
        del tr, state
        torch.cuda.empty_cache()
    # slice 16: the same paths on a (data=4, model=2) mesh in this process
    run_m2round(torch, mc, shapes)
    for compressed in (False, True):
        launches, tr, state = run_main_path(torch, mc, compressed=compressed,
                                            sharded=True,
                                            model_shards=MAIN_2D_KM)
        key = "shard_cmix" if compressed else "shard_mix"
        records[f"{key}_kernel_2d"]["launches"] = launches[key]
        twin = "[scmain]" if compressed else "[smain]"
        m2_against_one_d(torch, "[m2cmain]" if compressed else "[m2main]",
                         twin, state, ref_params.pop(twin), compressed)
        del tr, state
        torch.cuda.empty_cache()
    d2ref = d2_references(torch)
    # slice 17: SlowMo on the one-process twin of [dslowmo], and the twin of
    # the 2-D rank checkpoint
    slice17 = {}
    slice17["[sslowmo]"], smain["[dslowmo]"] = run_sslowmo(torch, mc)
    d2ref["[d2ckpt]"] = d2ckpt_reference(torch)
    # slice 20: the one-process twin of the overlapped rank path
    smain["[dovmain]"] = dov_reference(torch)
    # slices 15-17: the same paths on rank meshes, 4 ranks sharing the card
    dist_launches = run_dist_paths(torch, mc, shapes, smain, d2ref)
    for tag in ("[dslowmo]", "[d2ckpt]"):
        slice17[tag] = dist_launches.pop(tag)
    for key in ("shard_mix", "shard_cmix"):
        for name, tags in ((f"{key}_kernel", ("[dmain]", "[dcmain]",
                                              "[dovmain]")),
                           (f"{key}_kernel_2d", ("[d2main]", "[d2cmain]"))):
            records[name]["launches_dist"] = {
                tag: {key: c[key]} for tag, c in dist_launches.items()
                if c[key] and tag in tags}
    del smain, d2ref
    torch.cuda.empty_cache()
    lap("slices 1-4, 15 and 16")
    cross_check(torch)
    cross_check(torch, compressed=True)
    cross_check(torch, sharded=True)
    cross_check(torch, compressed=True, sharded=True)
    for algorithm, dist_kw in ALGO_RUNS:
        cross_check(torch, algorithm=algorithm, dist_kw=dist_kw, steps=6)
    serving_cross_check(torch)
    torch.cuda.empty_cache()
    sim = run_sim_path(torch, mc)
    records["mix_nodes_kernel"]["launches"] = sim["mix_nodes"]
    records["cmix_nodes_kernel"]["launches"] = sim["cmix_nodes"]
    records["collective_narrow_kernel"]["launches"] = sim["collective_narrow"]
    run_sim_cross_check(torch)
    algos = {k: 0 for k in counts()}
    for algorithm, dist_kw in ALGO_RUNS:
        for k, v in run_algo_path(torch, mc, algorithm, dist_kw).items():
            algos[k] += v
    lap("slices 1-7")
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
    lap("slice 8")
    # slice 9: overlapped gossip
    overlap = {}
    overlap["[ovmain]"], tr, state = run_overlap_path(torch, mc)
    overlap_round_times(torch, mc, tr, state)
    del tr, state
    torch.cuda.empty_cache()
    overlap["[ovcmain]"], tr, state = run_overlap_path(torch, mc,
                                                       compressed=True)
    del tr, state
    torch.cuda.empty_cache()
    overlap["[sovmain]"], tr, state = run_overlap_path(torch, mc,
                                                       sharded=True)
    # slice 20: its finish with the halos issued ahead, against serial
    sovround(torch, mc, tr, state)
    del tr, state
    torch.cuda.empty_cache()
    for compressed, sharded in ((False, False), (True, False), (True, True)):
        cross_check(torch, compressed=compressed, sharded=sharded,
                    dist_kw=OVERLAP_CROSS, steps=4, tag="[ovcross]")
    overlap["[ovsim]"] = run_overlap_sim_path(torch, mc)
    records["shard_cmix_nodes_kernel"]["launches"] = \
        overlap["[ovsim]"]["shard_cmix_nodes"]
    lap("slice 9")
    # slice 10: checkpoints and resume, the occupancy calibration, the
    # simulator's and the server's telemetry
    slice10["[ckpt]"] = run_ckpt_path(torch, mc, "[ckpt]")
    slice10["[cckpt]"] = run_ckpt_path(torch, mc, "[cckpt]", **COMPRESSED)
    slice10["[psckpt]"] = run_ckpt_path(torch, mc, "[psckpt]",
                                        topology="directed_exp",
                                        push_sum=True)
    slice10["[agackpt]"] = run_ckpt_path(torch, mc, "[agackpt]",
                                         algorithm="gossip_aga",
                                         aga_h_init=2, aga_warmup=2)
    slice10["[occ]"] = run_occ_path(torch, mc)
    slice10["[simtel]"] = run_simtel_path(torch, mc)
    slice10["[servetel]"] = run_servetel_path(torch)
    lap("slice 10")
    # slice 11: the dense decoders served at full published size, then
    # card against CPU at their reduced configs
    for tag, kw in DENSE_SERVE.items():
        torch.cuda.empty_cache()
        model, params = run_dense_serve_path(torch, tag, **kw)
        if kw["arch"] == GLONG["arch"]:
            # slice 12: the 8,192-token prefill, on [gserve]'s params
            torch.cuda.empty_cache()
            run_glong_path(torch, model, params)
        del model, params
        lap(tag)
    torch.cuda.empty_cache()
    dense_cross_check(torch)
    lap("slice 11")
    # slice 12: bert-large training (encoder, LAMB, microbatches, remat)
    slice12 = {}
    slice12["[bert]"], bert_params = run_bert_path(torch, mc)
    torch.cuda.empty_cache()
    slice12["[bertmem]"] = run_bertmem_path(torch, mc, bert_params)
    del bert_params
    torch.cuda.empty_cache()
    encoder_cross_check(torch)
    lap("slice 12")
    # slice 13: MoE, MLA and prefix patterns
    torch.cuda.empty_cache()
    run_ds_path(torch)
    lap("[dsserve] and [dslong]")
    torch.cuda.empty_cache()
    run_qmoe_path(torch)
    lap("[qmoe]")
    torch.cuda.empty_cache()
    slice13 = {"[moetrain]": run_moetrain_path(torch, mc)}
    lap("[moetrain]")
    torch.cuda.empty_cache()
    reduced_cross_check(torch, MOEX_RUNS)
    torch.cuda.empty_cache()
    lap("slice 13")
    # slice 14: Mamba and the hybrid family, the VLM stub
    run_jserve_path(torch)
    lap("[jserve]")
    torch.cuda.empty_cache()
    run_lvserve_path(torch)
    lap("[lvserve] and [lvloss]")
    torch.cuda.empty_cache()
    slice14 = {"[jtrain]": run_jtrain_path(torch, mc)}
    lap("[jtrain]")
    torch.cuda.empty_cache()
    reduced_cross_check(torch, SLICE14X_RUNS)
    torch.cuda.empty_cache()
    lap("slice 14")
    slice17["[examples]"] = run_examples(torch)
    lap("[examples]")
    # slice 18: the dry-run on meta tensors, held against the card, and
    # [main]'s step against the H100 roofline
    run_dryrun_path()
    lap("[dryrun]")
    torch.cuda.empty_cache()
    drycard = run_drycard_path(torch)
    torch.cuda.empty_cache()
    lap("[drycard]")
    run_roofline_report(drycard)
    # slice 19: the port's own static analysis over this checkout
    run_analysis_path()
    lap("[analysis]")
    # row 1b: mix.cu's register instance at n = 2 on the two-node trainers
    records["mix_kernel_n2"]["launches"] = (
        slice13["[moetrain]"]["mix_vector"]
        + slice14["[jtrain]"]["mix_vector"])
    records["mix_kernel_n2"]["launches_by_path"] = {
        path: {"mix_vector": c["mix_vector"]} for path, c in (
            ("[moetrain]", slice13["[moetrain]"]),
            ("[jtrain]", slice14["[jtrain]"]))}
    # the slice-7 paths' launches beside the main paths' (B.1 to B.3)
    for name, keys in (("mix_vector_kernel", ("mix", "mix_vector")),
                       ("mix_nodes_kernel", ("mix_nodes",)),
                       ("cmix_vector_kernel", ("cmix", "cmix_vector")),
                       ("cmix_nodes_kernel", ("cmix_nodes",)),
                       ("cmix_absmax_kernel", ("cmix_absmax",)),
                       ("collective_kernel", ("collective",)),
                       ("collective_narrow_kernel", ("collective_narrow",))):
        records[name]["launches_sim_algos"] = {
            path: {k: c[k] for k in keys if c[k]}
            for path, c in (("[sim]", sim), ("[algos]", algos))}
    # the push paths' launches (B.1, B.2 and its row maxima, B.5)
    for name, keys in (("mix_vector_kernel", ("mix", "mix_vector")),
                       ("mix_nodes_kernel", ("mix_nodes",)),
                       ("cmix_vector_kernel", ("cmix", "cmix_vector")),
                       ("cmix_absmax_kernel", ("cmix_absmax",)),
                       ("shard_mix_kernel", ("shard_mix",))):
        records[name]["launches_push"] = {
            path: {k: c[k] for k in keys if c[k]}
            for path, c in push.items()}
    # the overlapped paths' launches (B.4 at the stacked apply's shape,
    # B.1 and B.3 on the flushes)
    for name, keys in (("shard_cmix_kernel", ("shard_cmix",)),
                       ("shard_cmix_nodes_kernel", ("shard_cmix_nodes",)),
                       ("mix_vector_kernel", ("mix", "mix_vector")),
                       ("mix_nodes_kernel", ("mix_nodes",)),
                       ("collective_kernel", ("collective",))):
        records[name]["launches_overlap"] = {
            path: {k: c[k] for k in keys if c[k]}
            for path, c in overlap.items()}
    # the slice-10 phases' launches (B.1-B.4 on the resume, telemetry and
    # occupancy paths; B.8 through the server)
    for name, keys in (("mix_vector_kernel", ("mix", "mix_vector")),
                       ("cmix_vector_kernel", ("cmix", "cmix_vector")),
                       ("cmix_absmax_kernel", ("cmix_absmax",)),
                       ("collective_kernel", ("collective",)),
                       ("shard_cmix_kernel", ("shard_cmix",)),
                       ("mlstm_wgmma_kernel", ("mlstm_wgmma",))):
        records[name]["launches_slice10"] = {
            path: {k: c[k] for k in keys if c[k]}
            for path, c in slice10.items() if any(c[k] for k in keys)}
    # the slice-12 training paths' launches (B.1 on bert-large's rounds)
    records["mix_vector_kernel"]["launches_slice12"] = {
        path: {k: c[k] for k in ("mix", "mix_vector") if c[k]}
        for path, c in slice12.items()}
    # the slice-13 training path's launches (B.1 on the MoE model's rounds)
    records["mix_vector_kernel"]["launches_slice13"] = {
        path: {k: c[k] for k in ("mix", "mix_vector") if c[k]}
        for path, c in slice13.items()}
    # the slice-14 training path's launches (B.1 on the hybrid model's
    # rounds)
    records["mix_vector_kernel"]["launches_slice14"] = {
        path: {k: c[k] for k in ("mix", "mix_vector") if c[k]}
        for path, c in slice14.items()}
    # the slice-17 phases' launches (B.5 on the SlowMo paths, B.4 at the
    # 2-D block shape on [d2ckpt], whatever the examples launch)
    for name, key in (("shard_mix_kernel", "[sslowmo]"),
                      ("shard_mix_kernel", "[dslowmo]"),
                      ("shard_cmix_kernel_2d", "[d2ckpt]")):
        records[name].setdefault("launches_slice17", {})[key] = {
            k: v for k, v in slice17[key].items() if v}
    for script, fired in slice17["[examples]"].items():
        for k, v in fired.items():
            records[KERNEL_OF_COUNT[k]].setdefault("launches_slice17", {})[
                f"[examples] {script}"] = {k: v}
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
