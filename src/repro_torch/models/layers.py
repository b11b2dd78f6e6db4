"""Shared building blocks (counterpart of ``repro/models/layers.py``):
parameter builder with logical sharding axes, RMSNorm, logit softcap,
rotary embedding, gated MLP, embedding.

Parameters are nested dicts of tensors in the reference's layout.  Every
parameter is created through :class:`ParamBuilder`, which records a
parallel tree of *logical axis names* (resolved to mesh specs by
``repro_torch.models.sharding``), so the value tree and the axes tree are
built by the same calls.  Every
function below takes tensors that carry the leading node axis ``n`` of
the decentralized layout — activations ``(n, B, S, …)``, weights
``(n, …)`` — so the n node replicas run as batched matrix products (the
reference ``vmap``s one node's function instead).
"""
from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

PyTree = Any
Axes = Tuple[Optional[str], ...]

# Logical axis vocabulary (resolved by sharding rules):
#   "node"   — decentralized replica axis (the paper's n nodes)
#   "vocab"  — vocabulary dim
#   "embed"  — model dim (the FSDP shard target in hierarchical mode)
#   "heads" / "kv_heads" — attention heads
#   "ffn"    — feed-forward hidden
#   "expert" — MoE expert dim
#   "layers" — stacked-layer dim (never sharded)
#   None     — replicated


# Every normal leaf takes one seed from the caller's generator, in creation
# order, and is drawn in pieces of INIT_PIECE elements, each from its own
# CPU generator seeded from the leaf's seed and the piece's index.  The
# pieces fill the leaf's host buffer from a pool of INIT_THREADS threads
# (``torch.randn`` releases the GIL).  INIT_PIECE is part of what an init
# draws; INIT_THREADS is not: any pool size gives the same values.
INIT_PIECE = 1 << 20
INIT_THREADS = min(os.cpu_count() or 1, 16)
_MIX = 0x9E3779B97F4A7C15           # 2^64 / golden ratio: spreads the seeds
_POOLS: Dict[int, ThreadPoolExecutor] = {}


def _pool(threads: int) -> ThreadPoolExecutor:
    if threads not in _POOLS:
        _POOLS[threads] = ThreadPoolExecutor(threads,
                                             thread_name_prefix="init")
    return _POOLS[threads]


def draw_normal(shape: Tuple[int, ...], std: float, seed: int,
                dtype: torch.dtype) -> torch.Tensor:
    """``std · N(0, 1)`` of ``shape`` on the host, cast to ``dtype``: piece
    k of :data:`INIT_PIECE` elements (row-major) is drawn in float32 from a
    generator seeded ``(seed + k · _MIX) mod 2^64``, scaled, and written
    into its slice of the buffer, the pieces spread over
    :data:`INIT_THREADS` threads."""
    out = torch.empty(shape, dtype=dtype)
    flat = out.view(-1)
    size, piece = flat.numel(), INIT_PIECE

    def draw(k: int) -> None:
        lo = k * piece
        dst = flat[lo:min(size, lo + piece)]
        gen = torch.Generator().manual_seed((seed + k * _MIX) % 2**64)
        if dtype == torch.float32:
            torch.randn(dst.numel(), generator=gen, out=dst).mul_(std)
        else:
            dst.copy_(torch.randn(dst.numel(), generator=gen).mul_(std))

    n_pieces = -(-size // piece)
    if n_pieces <= 1 or INIT_THREADS <= 1:
        for k in range(n_pieces):
            draw(k)
    else:
        list(_pool(INIT_THREADS).map(draw, range(n_pieces)))
    return out


class ParamBuilder:
    """Creates parameters and their logical-axes tree in lockstep, with
    the reference's init rules: ``normal`` (std ``scale`` or 0.02),
    ``fan_in`` (std ``scale/√fan_in``, fan_in the product of all but the
    last dim), ``zeros``, ``ones``, ``constant``.

    Each drawn leaf takes one seed from ``generator`` (a CPU
    ``torch.Generator``) in creation order and is drawn on the host by
    :func:`draw_normal`, then moved to ``device``, so an init is the same
    on every device and at every pool size.  The reference draws from
    split ``jax.random`` keys: the two give different numbers, so
    cross-package comparisons start from weights carried across
    (``repro_torch.interop``).

    On ``device="meta"`` the builder is shapes-only: every leaf is
    ``torch.empty(shape, dtype, device="meta")``, nothing is drawn and no
    seed is taken (``generator`` may be None), so a real init's seed
    stream does not depend on whether a meta init ran before it.
    """

    def __init__(self, generator: Optional[torch.Generator],
                 param_dtype: torch.dtype, device):
        self.generator = generator
        self.param_dtype = param_dtype
        self.device = torch.device(device)
        self.params: Dict[str, Any] = {}
        self.axes: Dict[str, Any] = {}

    @property
    def abstract(self) -> bool:
        """True for the shapes-only builder (``device="meta"``)."""
        return self.device.type == "meta"

    def child(self, device=None) -> "ParamBuilder":
        """An empty builder on the same generator and dtype (on
        ``device``, default this one's)."""
        return ParamBuilder(self.generator, self.param_dtype,
                            self.device if device is None else device)

    def _normal(self, shape, std: float) -> torch.Tensor:
        seed = int(torch.randint(0, 2**62, (), generator=self.generator))
        return draw_normal(shape, std, seed, self.param_dtype)

    def add(self, name: str, shape: Sequence[int], axes: Axes,
            init: str = "fan_in", scale: Optional[float] = None
            ) -> torch.Tensor:
        assert len(axes) == len(shape), (name, shape, axes)
        shape = tuple(int(s) for s in shape)
        if init not in ("zeros", "ones", "normal", "fan_in", "constant"):
            raise ValueError(f"unknown init {init!r}")
        if self.abstract:
            val = torch.empty(shape, dtype=self.param_dtype, device="meta")
        elif init == "zeros":
            val = torch.zeros(shape, dtype=self.param_dtype)
        elif init == "ones":
            val = torch.ones(shape, dtype=self.param_dtype)
        elif init == "normal":
            val = self._normal(shape, scale if scale is not None else 0.02)
        elif init == "fan_in":
            fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
            std = ((scale if scale is not None else 1.0)
                   / math.sqrt(max(fan_in, 1)))
            val = self._normal(shape, std)
        else:
            val = torch.full(shape, scale, dtype=self.param_dtype)
        val = val.to(self.device)
        self.params[name] = val
        self.axes[name] = tuple(axes)
        return val

    def sub(self, name: str) -> "ParamBuilder":
        """A child builder attached under ``name``: what it adds later
        lands in this builder's trees (``child()`` + ``attach()``)."""
        child = self.child()
        self.attach(name, child.params, child.axes)
        return child

    def attach(self, name: str, params: PyTree, axes: PyTree) -> None:
        self.params[name] = params
        self.axes[name] = axes


def built(fill: Callable[..., None], generator: Optional[torch.Generator],
          param_dtype: torch.dtype, device, *args) -> Tuple[PyTree, PyTree]:
    """``(params, axes)`` of ``fill(b, *args)`` on a fresh
    ``ParamBuilder(generator, param_dtype, device)``: the reference's call
    shape of an init (a key and a dtype in, its subtree and axes out) over
    the builder form the port's ``Model`` calls."""
    b = ParamBuilder(generator, param_dtype, device)
    fill(b, *args)
    return b.params, b.axes


def _stacked(blocks: Callable[[int], Tuple[PyTree, PyTree]], n: int,
             device, abstract: bool) -> Tuple[PyTree, PyTree]:
    """Blocks ``blocks(0) .. blocks(n - 1)`` (each ``(params, axes)``, made
    one after another) stacked leaf-wise on a new leading "layers" axis
    into tensors allocated once on ``device``, each block copied into its
    slot as it comes; ``abstract`` makes one block and stacks its
    shapes."""
    from repro_torch.models.sharding import _map_axes
    from repro_torch.tree import tree_flatten, tree_unflatten
    stacked = axes = None
    for i in range(n if not abstract else 1):
        params, block_axes = blocks(i)
        leaves, treedef = tree_flatten(params)
        if stacked is None:
            axes = _map_axes(lambda a: ("layers",) + tuple(a), block_axes)
            stacked = [torch.empty((n,) + t.shape, dtype=t.dtype,
                                   device=device) for t in leaves]
        if not abstract:
            for dst, src in zip(stacked, leaves):
                dst[i].copy_(src)
    return tree_unflatten(treedef, stacked), axes


def stack_inits(init_fn: Callable[[Optional[torch.Generator]],
                                  Tuple[PyTree, PyTree]],
                generator: Optional[torch.Generator], n: int, *,
                device="cuda") -> Tuple[PyTree, PyTree]:
    """``n`` structurally identical blocks, ``init_fn(generator) ->
    (params, axes)`` called ``n`` times in order, stacked leaf-wise on a
    new leading "layers" axis on ``device``: ``(stacked params,
    ("layers",) + axes of every leaf)`` (the reference's
    ``stack_inits(init_fn, key, n)``; the blocks draw one after another
    from the one generator, where the reference splits its key).  On
    ``device="meta"`` the stack holds shapes only."""
    return _stacked(lambda i: init_fn(generator), n, device,
                    torch.device(device).type == "meta")


def _stack_inits_into(init_fn: Callable[["ParamBuilder"], None],
                      b: "ParamBuilder", n: int) -> Tuple[PyTree, PyTree]:
    """The builder form of :func:`stack_inits`: ``n`` blocks, each built
    by ``init_fn`` into a fresh builder on ``b``'s generator and dtype.
    Blocks are drawn one after another on the host (in block order) and
    copied into their slot of the stacked leaves on ``b.device``, so the
    device holds the stack and no per-layer copy.  The shapes-only
    builder builds one block and stacks its shapes."""
    def block(i: int) -> Tuple[PyTree, PyTree]:
        one = b.child("meta" if b.abstract else "cpu")
        init_fn(one)
        return one.params, one.axes
    return _stacked(block, n, b.device, b.abstract)


# ---------------------------------------------------------------------------
# Functional layers
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm with fp32 accumulation; ``weight`` is ``(n, D)`` and
    broadcasts over the activation's middle dims."""
    dtype = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    w = weight.to(torch.float32)
    w = w.reshape(w.shape[:1] + (1,) * (x.dim() - 2) + w.shape[1:])
    return (y * (offset + w)).to(dtype)


def init_rms_norm(b: ParamBuilder, name: str, dim: int,
                  zeros: bool = False) -> None:
    b.add(name, (dim,), (None,), init="zeros" if zeros else "ones")


def softcap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 logit soft-capping: ``cap * tanh(logits / cap)`` (a division
    by cap, as the reference computes it)."""
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


def make_rope(positions: torch.Tensor, head_dim: int, theta: float,
              dtype: torch.dtype = torch.float32
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for rotary embedding, computed in fp32 and cast to
    ``dtype``; positions (..., S)."""
    half = head_dim // 2
    expo = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), expo)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); cos/sin: (..., S, head_dim//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def node_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-node ``x @ w``: x ``(n, …, d)``, w ``(n, d, f)`` → ``(n, …, f)``
    as one batched product."""
    lead = x.shape[1:-1]
    y = torch.matmul(x.reshape(x.shape[0], -1, x.shape[-1]), w)
    return y.reshape((x.shape[0],) + tuple(lead) + (w.shape[-1],))


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------
def init_mlp(generator: Optional[torch.Generator], d_model: int, d_ff: int,
             param_dtype: torch.dtype, *, device="cuda"
             ) -> Tuple[PyTree, PyTree]:
    """The gated MLP's ``(params, axes)`` (the reference's call shape)."""
    return built(_init_mlp_into, generator, param_dtype, device, d_model,
                 d_ff)


def _init_mlp_into(b: ParamBuilder, d_model: int, d_ff: int) -> None:
    b.add("w_gate", (d_model, d_ff), ("embed", "ffn"))
    b.add("w_up", (d_model, d_ff), ("embed", "ffn"))
    b.add("w_down", (d_ff, d_model), ("ffn", "embed"))


def apply_mlp(params: PyTree, x: torch.Tensor, *, act=F.silu) -> torch.Tensor:
    h = (act(node_matmul(x, params["w_gate"].to(x.dtype)))
         * node_matmul(x, params["w_up"].to(x.dtype)))
    return node_matmul(h, params["w_down"].to(x.dtype))


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def init_embedding(generator: Optional[torch.Generator], vocab: int,
                   d_model: int, param_dtype: torch.dtype, tie: bool, *,
                   device="cuda") -> Tuple[PyTree, PyTree]:
    """The embedding (and, untied, the unembedding): ``(params, axes)``
    (the reference's call shape)."""
    return built(_init_embedding_into, generator, param_dtype, device, vocab,
                 d_model, tie)


def _init_embedding_into(b: ParamBuilder, vocab: int, d_model: int,
                         tie: bool) -> None:
    b.add("embedding", (vocab, d_model), ("vocab", "embed"), init="normal",
          scale=0.02)
    if not tie:
        b.add("unembed", (d_model, vocab), ("embed", "vocab"))


def embed_tokens(params: PyTree, tokens: torch.Tensor, dtype: torch.dtype,
                 scale_by_dim: bool = False) -> torch.Tensor:
    """tokens (n, B, S) → (n, B, S, d): each node looks up its own
    table.  ``scale_by_dim`` (the Gemma convention) multiplies by
    ``sqrt(d)`` rounded to ``dtype`` first, as the reference does (59.75
    in bf16 for d = 3584, not 59.8665)."""
    emb = params["embedding"].to(dtype)
    n = tokens.shape[0]
    node = torch.arange(n, device=tokens.device).reshape(
        (n,) + (1,) * (tokens.dim() - 1))
    out = emb[node, tokens.long()]
    if scale_by_dim:
        scale = torch.tensor(math.sqrt(emb.shape[-1]), dtype=dtype).item()
        out = out * scale
    return out


def unembed(params: PyTree, h: torch.Tensor, tie: bool,
            final_softcap: Optional[float] = None) -> torch.Tensor:
    """``h @ Eᵀ`` (tied) or ``h @ U`` per node; fp32 logits, softcapped
    after the cast as in the reference."""
    if tie:
        w = params["embedding"].to(h.dtype).transpose(1, 2)
    else:
        w = params["unembed"].to(h.dtype)
    return softcap(node_matmul(h, w).to(torch.float32), final_softcap)
