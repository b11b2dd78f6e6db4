"""Quickstart through the PyTorch/CUDA port: train a small LM with
Gossip-PGA on 8 simulated nodes and compare against Gossip SGD and Local
SGD (``examples/quickstart.py`` through ``repro_torch``).

    PYTHONPATH=src python examples/torch_quickstart.py [--steps 40]
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import torch

from repro_torch.configs import (DataConfig, DistConfig, OptimizerConfig,
                                 TrainConfig, get_model_config)
from repro_torch.train import Trainer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    cfg = get_model_config("pga-lm-100m", reduced=True)
    results = {}
    for algorithm in ("gossip", "local", "gossip_pga"):
        tcfg = TrainConfig(
            model=cfg,
            dist=DistConfig(algorithm=algorithm, topology="ring", H=6),
            optimizer=OptimizerConfig(name="adamw", lr=3e-3,
                                      schedule="constant", warmup_steps=5),
            data=DataConfig(non_iid=True),
            global_batch=16, seq_len=64, log_every=10)
        tr = Trainer(tcfg, n_nodes=args.nodes, with_consensus=True,
                     device=args.device)
        state = tr.init_state(torch.Generator().manual_seed(0))
        tr.run(state, steps=args.steps)
        results[algorithm] = tr.history[-1]

    print("\n=== final metrics (non-iid ring, H=6) ===")
    for alg, rec in results.items():
        print(f"{alg:12s} loss={rec['loss']:.4f} "
              f"consensus={rec['consensus']:.3e}")
    print("\nExpected: gossip_pga reaches the lowest loss with the lowest "
          "consensus error — the paper's §4 intuition at toy scale.")


if __name__ == "__main__":
    main()
