"""Serving launcher of the port: ``python -m repro_torch.launch.serve
--arch <id>`` — batched greedy decoding with random weights (seed 0),
reduced config by default, on the card unless ``--device cpu``.  The flags
are the reference launcher's, plus ``--device``: ``--telemetry-dir``
writes the ``serve_req`` records to ``<dir>/telemetry.jsonl``, ``--trace``
a Chrome trace of the ``serve/prefill`` and ``serve/decode`` spans."""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.configs import get_model_config, list_archs
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
                    help="write serve_req records (latency, tokens/s) to "
                         "<dir>/telemetry.jsonl")
    ap.add_argument("--trace", default="",
                    help="save a Chrome trace of serve/prefill + "
                         "serve/decode spans to this path")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="run on the card (default) or, explicitly, on the "
                         "CPU with the plain PyTorch kernels")
    args = ap.parse_args(argv)

    cfg = get_model_config(args.arch, reduced=not args.full_config)
    if not cfg.causal:
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving")
    model = make_model(cfg)
    params = model.init(torch.Generator().manual_seed(0),
                        resolve_device(args.device))
    telemetry = None
    if args.telemetry_dir or args.trace:
        sinks = [obs.PrettySink(types=("serve_req",))]
        if args.telemetry_dir:
            os.makedirs(args.telemetry_dir, exist_ok=True)
            sinks.insert(0, obs.JsonlSink(
                os.path.join(args.telemetry_dir, "telemetry.jsonl")))
        telemetry = obs.Telemetry(sinks=sinks)
    try:
        server = BatchedServer(Engine(model, s_max=args.s_max), params,
                               n_slots=args.slots, telemetry=telemetry)
        rng = np.random.default_rng(0)
        reqs = [Request(uid=i,
                        prompt=rng.integers(0, cfg.vocab_size, size=6),
                        max_new=args.max_new)
                for i in range(args.requests)]
        for r in sorted(server.run(reqs), key=lambda r: r.uid):
            print(f"req {r.uid}: {r.prompt.tolist()} -> {r.generated}")
    finally:
        if telemetry is not None:
            if args.trace:
                print("trace:", telemetry.tracer.save(args.trace))
            telemetry.close()


if __name__ == "__main__":
    main()
