"""Batched serving through the PyTorch/CUDA port: continuous batching
over a queue of requests with a KV-cached decode loop (greedy), as
``examples/serve_requests.py`` through ``repro_torch``.

    PYTHONPATH=src python examples/torch_serve_requests.py --requests 6 --slots 2
    PYTHONPATH=src python examples/torch_serve_requests.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_model_config
from repro_torch.models.model import make_model
from repro_torch.serve import BatchedServer, Engine, Request


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="pga-lm-100m")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--s-max", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_model_config(args.arch, reduced=True)
    model = make_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device)
    engine = Engine(model, s_max=args.s_max)
    server = BatchedServer(engine, params, n_slots=args.slots)

    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=rng.integers(4, 12)),
                    max_new=args.max_new)
            for i in range(args.requests)]
    t0 = time.time()
    done = server.run(reqs)
    dt = time.time() - t0
    total_tokens = sum(len(r.generated) for r in done)
    print(f"served {len(done)} requests / {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s on {device.type}, {args.slots} "
          f"slots)")
    for r in sorted(done, key=lambda r: r.uid):
        print(f"  req {r.uid}: prompt[{len(r.prompt)}] -> {r.generated}")


if __name__ == "__main__":
    main()
