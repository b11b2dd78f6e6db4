"""Training launcher of the port: ``python -m repro_torch.launch.train``.

Runs the decentralized trainer with n simulated nodes stacked on one
device — the card by default, the CPU only with ``--device cpu``.  The
flags are the reference launcher's.  ``--telemetry-dir`` writes the
structured record stream to ``<dir>/telemetry.jsonl``; ``--trace`` saves
a Chrome trace of the host spans; ``--trace-fence`` makes each
``train/step`` span wait for the card (CUDA events), so it measures
device time.  ``--comm-overlap`` runs the overlapped gossip rounds.
``--push-sum`` and ``--fault-*`` build the reference's
:class:`repro_torch.core.faults.FaultSchedule` as it does (a fault flag
without ``--push-sum`` raises ``ValueError`` in the Trainer).  Like the
reference's, it builds no mesh: ``--comm-shard-mode sharded`` raises
``ValueError`` there as here; the sharded rounds are reached through the
library entry ``Trainer(tcfg, n, mesh=make_mesh(...))``.
"""
from __future__ import annotations

import argparse
import os

from repro_torch import obs
from repro_torch.configs import (DataConfig, DistConfig, OptimizerConfig,
                                 TrainConfig, get_model_config, list_archs)
from repro_torch.core.algo import algorithm_names
from repro_torch.core.faults import FaultSchedule, parse_fault_events
from repro_torch.train import Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(list_archs()))
    ap.add_argument("--algorithm", default="gossip_pga",
                    choices=list(algorithm_names()))
    ap.add_argument("--topology", default="one_peer_exp")
    ap.add_argument("--H", type=int, default=6)
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--comm-backend", default="reference",
                    choices=("reference", "pallas"),
                    help="mixing implementation: roll-based reference or "
                         "the fused hand-written CUDA kernel")
    ap.add_argument("--comm-shard-mode", default="auto",
                    choices=("auto", "stacked", "sharded"),
                    help="pallas backend under a mesh-sharded node axis: "
                         "auto-detect, force the local stacked kernels, or "
                         "require the sharded per-shard path")
    ap.add_argument("--leaf-threshold", type=int, default=262_144,
                    help="per-node elements at which a parameter leaf gets "
                         "its own kernel launch (skips the staging buffer)")
    ap.add_argument("--comm-compression", default="none",
                    choices=("none", "identity", "int8", "fp8", "topk",
                             "randk"),
                    help="wire compressor of the gossip rounds; identity "
                         "is bit-identical to none")
    ap.add_argument("--comm-compression-k", type=int, default=32,
                    help="elements kept per node per leaf for topk/randk")
    ap.add_argument("--comm-global-compression", default="none",
                    choices=("none", "identity", "int8", "fp8"),
                    help="compressed collective of the global/pod-"
                         "averaging rounds; identity is bit-identical to "
                         "none")
    ap.add_argument("--error-feedback", action="store_true",
                    help="per-node error-feedback memory: compression "
                         "error is fed back next round instead of dropped")
    ap.add_argument("--comm-overlap", action="store_true",
                    help="overlapped gossip: the mixing round of step t "
                         "overlaps the compute of step t+1 via a one-step-"
                         "stale double buffer; global/PGA rounds stay "
                         "synchronous")
    ap.add_argument("--push-sum", action="store_true",
                    help="push-sum gossip: column-stochastic directed "
                         "mixing with a per-node weight scalar, de-biased "
                         "at read time — required for directed topologies "
                         "and fault injection")
    ap.add_argument("--fault-drop", default="",
                    help="drop events as 'step:id,id[;step:id,...]', e.g. "
                         "'40:3,5;90:0' drops nodes 3,5 at step 40 and "
                         "node 0 at step 90 (requires --push-sum)")
    ap.add_argument("--fault-rejoin", default="",
                    help="rejoin events, same syntax as --fault-drop")
    ap.add_argument("--fault-resample", default="none",
                    choices=("none", "hop", "peer"),
                    help="re-draw the gossip wiring each step: 'hop' "
                         "resamples one shared power-of-two hop, 'peer' "
                         "gives every node its own draw")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the deterministic per-step fault/"
                         "resample draws (counter-based)")
    ap.add_argument("--full-config", action="store_true",
                    help="full published dims (default: reduced)")
    ap.add_argument("--iid", action="store_true")
    ap.add_argument("--telemetry-dir", default="",
                    help="write the structured telemetry stream to "
                         "<dir>/telemetry.jsonl: step records, per-round "
                         "comm byte meters, fault and checkpoint events")
    ap.add_argument("--trace", default="",
                    help="save a Chrome-trace-event timeline of the run's "
                         "host spans to this path (load in Perfetto / "
                         "chrome://tracing)")
    ap.add_argument("--trace-fence", action="store_true",
                    help="wait for the card at span exits (CUDA events) so "
                         "spans measure device time instead of launch time "
                         "(serializes the pipeline it measures)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="run on the card (default) or, explicitly, on the "
                         "CPU with the plain PyTorch kernels")
    args = ap.parse_args(argv)

    cfg = get_model_config(args.arch, reduced=not args.full_config)
    tcfg = TrainConfig(
        model=cfg,
        dist=DistConfig(algorithm=args.algorithm, topology=args.topology,
                        H=args.H, comm_backend=args.comm_backend,
                        comm_shard_mode=args.comm_shard_mode,
                        pallas_leaf_threshold=args.leaf_threshold,
                        comm_compression=args.comm_compression,
                        comm_compression_k=args.comm_compression_k,
                        comm_global_compression=args.comm_global_compression,
                        comm_error_feedback=args.error_feedback,
                        comm_overlap=args.comm_overlap,
                        push_sum=args.push_sum),
        optimizer=OptimizerConfig(name=args.optimizer, lr=args.lr,
                                  schedule="warmup_cosine", warmup_steps=10,
                                  total_steps=args.steps),
        data=DataConfig(non_iid=not args.iid),
        global_batch=args.global_batch, seq_len=args.seq_len,
        steps=args.steps, log_every=max(args.steps // 10, 1))
    fault_schedule = None
    if args.fault_drop or args.fault_rejoin or args.fault_resample != "none":
        fault_schedule = FaultSchedule(
            n_nodes=args.nodes,
            drops=parse_fault_events(args.fault_drop),
            rejoins=parse_fault_events(args.fault_rejoin),
            resample=args.fault_resample,
            seed=args.fault_seed)
    telemetry = None
    if args.telemetry_dir or args.trace or args.trace_fence:
        sinks = [obs.RingSink(), obs.PrettySink()]
        if args.telemetry_dir:
            os.makedirs(args.telemetry_dir, exist_ok=True)
            sinks.insert(0, obs.JsonlSink(
                os.path.join(args.telemetry_dir, "telemetry.jsonl")))
        telemetry = obs.Telemetry(sinks=sinks, fence=args.trace_fence)
    try:
        tr = Trainer(tcfg, n_nodes=args.nodes, with_consensus=True,
                     fault_schedule=fault_schedule, telemetry=telemetry,
                     device=args.device)
        state = tr.init_state()
        tr.run(state, steps=args.steps)
    finally:
        if telemetry is not None:
            if args.trace:
                print("trace:", telemetry.tracer.save(args.trace))
            telemetry.close()


if __name__ == "__main__":
    main()
