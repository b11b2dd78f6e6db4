"""Serving engine: prefill + decode with KV / recurrent-state caches,
greedy or temperature sampling, and a slot-based continuous-batching loop
(counterpart of ``repro/serve/engine.py``).

The serving entry points take one replica's params in the reference's
layout (``Model.init``'s tree) and add the model's node axis of 1 inside;
:meth:`Engine.prefill` and :meth:`Engine.decode_step` return and take
caches in the reference's layout too (``(L, B, …)`` leaves of the scanned
layers, ``(B, …)`` of a prefix block; a KV leaf is ``(L, B, S_max, nkv,
hd)``, an MLA latent ``(L, B, S_max, r)``).  Decode writes each new key
and value (or latent row) in place into the caches it is given
(``Model.decode_step``).  Sampling at ``temperature > 0`` draws from an
explicit ``torch.Generator``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

# cache leaf names whose sequence axis is counted from the END (robust to
# leading stacked-layer and node dims)
_SEQ_AXIS_FROM_END = {"k": 3, "v": 3, "c_kv": 2, "k_rope": 2}


def pad_cache_to(caches: PyTree, s_max: int) -> PyTree:
    """Pad prefill-built attention caches out to the serving window (zeros
    after the prompt); every other leaf is returned as it is."""
    def pad(name, leaf):
        ax = _SEQ_AXIS_FROM_END.get(name)
        if ax is None or leaf.dim() < ax:
            return leaf
        axis = leaf.dim() - ax
        cur = leaf.shape[axis]
        if cur >= s_max:
            return leaf
        shape = list(leaf.shape)
        shape[axis] = s_max - cur
        return torch.cat([leaf, leaf.new_zeros(shape)], dim=axis)

    def walk(name, t):
        if isinstance(t, dict):
            return {k: walk(k, v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk("", v) for v in t)
        return None if t is None else pad(name, t)

    return walk("", caches)


def _node(tree: PyTree) -> PyTree:
    return tree_map(lambda t: t[None], tree)


def _unnode(tree: PyTree) -> PyTree:
    return tree_map(lambda t: t[0], tree)


def _device(params: PyTree) -> torch.device:
    return tree_leaves(params)[0].device


@dataclasses.dataclass
class Engine:
    model: Model
    s_max: int

    @property
    def cfg(self) -> ModelConfig:
        return self.model.cfg

    # node-stacked halves (params, caches with the node axis of 1)
    def _prefill(self, params1: PyTree, tokens: torch.Tensor
                 ) -> Tuple[torch.Tensor, PyTree]:
        logits, caches, _ = self.model.forward(
            params1, {"inputs": tokens[None]}, mode="prefill",
            want_cache=True)
        return logits[0, :, -1], pad_cache_to(caches, self.s_max)

    def _decode(self, params1: PyTree, caches1: PyTree, tokens: torch.Tensor,
                pos: torch.Tensor) -> Tuple[torch.Tensor, PyTree]:
        logits, caches1 = self.model.decode_step(params1, caches1,
                                                 tokens[None], pos)
        return logits[0, :, 0], caches1

    def prefill(self, params: PyTree, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, PyTree]:
        """tokens (B, S_prompt) int → (last-position fp32 logits (B, V),
        padded cache)."""
        logits, caches = self._prefill(_node(params), tokens)
        return logits, _unnode(caches)

    def decode_step(self, params: PyTree, caches: PyTree,
                    tokens: torch.Tensor, pos: torch.Tensor
                    ) -> Tuple[torch.Tensor, PyTree]:
        """tokens (B, 1) int, pos (B,) → (fp32 logits (B, V), caches)."""
        logits, caches = self._decode(_node(params), _node(caches), tokens,
                                      pos)
        return logits, _unnode(caches)

    def generate(self, params: PyTree, prompts, n_new: int, *,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Greedy/temperature generation for a fixed batch of equal-length
        prompts (B, S0), on the device of ``params``.  Returns (B, n_new)
        generated ids, fetched to the host once at the end."""
        dev = _device(params)
        prompts = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
        B, S0 = prompts.shape
        params1 = _node(params)
        logits, caches = self._prefill(params1, prompts)
        out = []
        tok = self._sample(logits, temperature, generator)
        pos = torch.full((B,), S0, dtype=torch.int32, device=dev)
        for _ in range(n_new):
            out.append(tok)
            logits, caches = self._decode(params1, caches, tok[:, None], pos)
            tok = self._sample(logits, temperature, generator)
            pos = pos + 1
        return torch.stack(out, dim=1).cpu().numpy()

    @staticmethod
    def _sample(logits: torch.Tensor, temperature: float,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """argmax, or at ``temperature > 0`` with a generator a draw from
        softmax(logits / temperature) by the Gumbel-max rule (the
        reference's ``jax.random.categorical``), its uniforms drawn on the
        generator's device."""
        if temperature <= 0.0 or generator is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        u = torch.rand(logits.shape, generator=generator,
                       device=generator.device).to(logits.device)
        u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(logits / temperature + gumbel,
                            dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# Continuous batching
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray
    max_new: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    t_admit: float = 0.0        # perf_counter at admission (telemetry)


class BatchedServer:
    """Slot-based continuous batching: fixed B decode slots; finished
    requests retire and free their slot for the next queued request.
    Per-slot prefill (B=1) keeps admission simple and bounded.  ``caches``
    holds every slot's state in the model's node-stacked layout: batch
    axis 1 of a prefix block's leaves, 2 of a scanned entry's.

    ``telemetry`` (a :class:`repro_torch.obs.Telemetry`, optional): each
    retired request emits a ``serve_req`` record (latency, prompt and new
    token counts, tokens/s), and prefill and decode run in ``serve/*``
    spans."""

    def __init__(self, engine: Engine, params: PyTree, n_slots: int,
                 telemetry=None):
        self.telemetry = telemetry
        self.engine = engine
        self.params = params
        self.n_slots = n_slots
        dev = _device(params)
        self._params1 = _node(params)
        self.caches = engine.model.init_cache(n_slots, engine.s_max,
                                              device=dev)
        self.tok = torch.zeros((n_slots, 1), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        self.slots: List[Optional[Request]] = [None] * n_slots

    def _span(self, name: str, **args):
        if self.telemetry is None:
            return contextlib.nullcontext()
        return self.telemetry.span(name, **args)

    def _admit(self, req: Request, slot: int) -> None:
        req.t_admit = time.perf_counter()
        prompt = torch.as_tensor(np.asarray(req.prompt)[None],
                                 dtype=torch.int32, device=self.tok.device)
        with self._span("serve/prefill", uid=req.uid, slot=slot):
            logits, cache = self.engine._prefill(self._params1, prompt)
        # a prefix block's leaves are (1, B, …), a scanned entry's (1, L,
        # B, …): a KV leaf takes the prompt's rows and the padding's zeros
        for name, sub in self.caches.items():
            axis = 2 if name == "scan" else 1
            for dst, src in zip(tree_leaves(sub), tree_leaves(cache[name])):
                dst.select(axis, slot).copy_(src.select(axis, 0))
        first = int(torch.argmax(logits[0]))
        req.generated.append(first)
        self.slots[slot] = req
        self.tok[slot, 0] = first
        self.pos[slot] = len(req.prompt)

    def _retire(self, req: Request) -> None:
        if self.telemetry is None:
            return
        latency = time.perf_counter() - req.t_admit
        new_tokens = len(req.generated)
        self.telemetry.emit(
            "serve_req", uid=req.uid, latency_s=latency,
            prompt_tokens=int(len(req.prompt)), new_tokens=new_tokens,
            tokens_per_s=new_tokens / max(latency, 1e-9))

    def run(self, requests: List[Request]) -> List[Request]:
        queue = list(requests)
        finished: List[Request] = []
        while queue or any(s is not None for s in self.slots):
            for i in range(self.n_slots):
                if self.slots[i] is None and queue:
                    self._admit(queue.pop(0), i)
            with self._span("serve/decode"):
                logits, self.caches = self.engine._decode(
                    self._params1, self.caches, self.tok, self.pos)
                nxt_dev = torch.argmax(logits, dim=-1).to(torch.int32)
                # the scheduler is host-side by design: admission and
                # completion need this tick's ids, so one fetch per tick
                nxt = nxt_dev.cpu().numpy()
            self.pos = self.pos + 1
            # every slot takes its own argmax; a free slot's is never read
            self.tok = nxt_dev[:, None]
            for i, req in enumerate(self.slots):
                if req is None:
                    continue
                req.generated.append(int(nxt[i]))
                if len(req.generated) >= req.max_new:
                    req.done = True
                    self._retire(req)
                    finished.append(req)
                    self.slots[i] = None
        return finished
