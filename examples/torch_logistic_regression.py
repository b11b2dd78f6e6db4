"""Paper §5.1 / Fig. 1 through the PyTorch/CUDA port: distributed
logistic regression over the ring topology, iid and non-iid, five
algorithms (``examples/logistic_regression.py`` through ``repro_torch``).

    PYTHONPATH=src python examples/torch_logistic_regression.py --n 20 --steps 1500
    PYTHONPATH=src python examples/torch_logistic_regression.py --device cpu
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import simulate
from repro_torch.data import make_logistic_problem


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--H", type=int, default=16)
    ap.add_argument("--iid", action="store_true")
    ap.add_argument("--topology", default="ring",
                    choices=["ring", "grid", "exp", "one_peer_exp"])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    device = resolve_device(args.device)
    prob = make_logistic_problem(n=args.n, M=2000, d=10, iid=args.iid,
                                 device=device)
    lr = lambda k: 0.2 * 0.5 ** (k // 1000)   # paper §5.1

    print(f"n={args.n} topology={args.topology} "
          f"{'iid' if args.iid else 'non-iid'} H={args.H}")
    print(f"{'iter':>6s} " + " ".join(f"{a:>12s}" for a in
          ["parallel", "gossip", "local", "gossip_pga", "gossip_aga"]))

    outs = {}
    for alg in ["parallel", "gossip", "local", "gossip_pga", "gossip_aga"]:
        outs[alg] = simulate(
            algorithm=alg, grad_fn=prob.grad_fn(batch=8),
            loss_fn=prob.loss_fn(),
            x0=torch.zeros(prob.d, device=device), n=prob.n,
            steps=args.steps, lr=lr, topology=args.topology, H=args.H,
            eval_every=max(args.steps // 10, 1), seed=0, device=device)

    its = outs["parallel"]["iteration"]
    for i, it in enumerate(its):
        row = " ".join(f"{outs[a]['loss'][i]:12.5f}" for a in outs)
        print(f"{it:6d} {row}")

    print("\nconsensus ‖x−x̄‖²/n at the end:")
    for a, o in outs.items():
        print(f"  {a:12s} {o['consensus'][-1]:.3e}")


if __name__ == "__main__":
    main()
