"""End-to-end training script through the PyTorch/CUDA port: a
~100M-parameter GPT-style LM trained with Gossip-PGA on simulated nodes
(synthetic non-iid stream, AdamW, cosine LR, checkpointing), as
``examples/train_lm.py`` through ``repro_torch``.

Default is a small run (reduced model, a few dozen steps).  ``--full``
trains the real pga-lm-100m config (12L/768d/32k vocab, 138M params a
replica).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 60
    PYTHONPATH=src python examples/torch_train_lm.py --full --steps 200
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --resume
"""
import argparse
import os
import tempfile

import torch

from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.configs import (DataConfig, DistConfig, OptimizerConfig,
                                 TrainConfig, get_model_config)
from repro_torch.train import Trainer
from repro_torch.tree import tree_leaves


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="the real ~100M-param config")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--algorithm", default="gossip_pga")
    ap.add_argument("--topology", default="one_peer_exp")
    ap.add_argument("--H", type=int, default=6)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    cfg = get_model_config("pga-lm-100m", reduced=not args.full)
    seq = args.seq_len or (256 if args.full else 64)
    gb = args.global_batch or (args.nodes * 2)
    tcfg = TrainConfig(
        model=cfg,
        dist=DistConfig(algorithm=args.algorithm, topology=args.topology,
                        H=args.H),
        optimizer=OptimizerConfig(name="adamw", lr=3e-4 if args.full else 3e-3,
                                  schedule="warmup_cosine", warmup_steps=20,
                                  total_steps=args.steps, grad_clip=1.0,
                                  weight_decay=0.01),
        data=DataConfig(non_iid=True),
        global_batch=gb, seq_len=seq, steps=args.steps,
        log_every=max(args.steps // 20, 1),
        ckpt_every=max(args.steps // 2, 1), ckpt_dir=args.ckpt_dir)

    tr = Trainer(tcfg, n_nodes=args.nodes, with_consensus=True,
                 device=args.device)
    state = tr.init_state(torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(state.params)) // args.nodes
    print(f"model {cfg.name}: ~{n_params / 1e6:.1f}M params, "
          f"{args.nodes} nodes, {args.algorithm}/{args.topology} H={args.H}")
    if args.resume and latest_step(args.ckpt_dir):
        state = restore_checkpoint(args.ckpt_dir, state)
        print(f"resumed from step {int(state.step)}")
    state = tr.run(state, steps=args.steps)
    first, last = tr.history[0], tr.history[-1]
    print(f"\nloss {first['loss']:.4f} -> {last['loss']:.4f} over "
          f"{args.steps} steps; final consensus {last['consensus']:.3e}")


if __name__ == "__main__":
    main()
