"""Serving launcher of the port: ``python -m repro_torch.launch.serve
--arch <id>`` — batched greedy decoding with random weights (seed 0),
reduced config by default, on the card unless ``--device cpu``.  The flags
are the reference launcher's, plus ``--device``; its telemetry flags are
not ported (ROADMAP A.6)."""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_model_config, list_archs
from repro_torch.configs.base import not_ported
from repro_torch.models.model import make_model
from repro_torch.serve import BatchedServer, Engine, Request


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(list_archs()))
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--s-max", type=int, default=64)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--telemetry-dir", default="",
                    help="not ported (ROADMAP A.6)")
    ap.add_argument("--trace", default="", help="not ported (ROADMAP A.6)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="run on the card (default) or, explicitly, on the "
                         "CPU with the plain PyTorch kernels")
    args = ap.parse_args(argv)

    if args.telemetry_dir or args.trace:
        raise not_ported("serve telemetry (--telemetry-dir, --trace)",
                         "A.6")
    cfg = get_model_config(args.arch, reduced=not args.full_config)
    if not cfg.causal:
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving")
    model = make_model(cfg)
    params = model.init(torch.Generator().manual_seed(0),
                        resolve_device(args.device))
    server = BatchedServer(Engine(model, s_max=args.s_max), params,
                           n_slots=args.slots)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=6),
                    max_new=args.max_new) for i in range(args.requests)]
    for r in sorted(server.run(reqs), key=lambda r: r.uid):
        print(f"req {r.uid}: {r.prompt.tolist()} -> {r.generated}")


if __name__ == "__main__":
    main()
