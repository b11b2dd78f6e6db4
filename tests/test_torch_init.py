"""The port's parallel host init (``models.layers.draw_normal`` under
``ParamBuilder``) and ``get_model_config(long_context=)``.

Every normal leaf takes one seed from the caller's generator, in
creation order, and is drawn in pieces of ``INIT_PIECE`` elements, each
from its own generator; a pool of ``INIT_THREADS`` threads fills the
pieces.  What is held here, all bitwise: an init is the same at pool
sizes 1 and 4 with pieces small enough to split every leaf; a leaf is
its pieces, each drawn alone from its own seed; the seeds follow the
caller's generator (zeros, ones and constants take none).  The long-
context configs equal the reference's field for field.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro_torch.configs import get_model_config
from repro_torch.models import layers
from repro_torch.models.model import make_model
from repro_torch.tree import tree_flatten

torch.set_num_threads(2)


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("arch", ("jamba-1.5-large-398b",
                                  "llava-next-mistral-7b"))
def test_init_is_the_same_at_every_pool_size(arch, monkeypatch):
    """The reduced config (jamba at bf16 params too) with pieces of 1,000
    elements: every leaf of more than 1,000 is split, and the threads
    take the pieces in whatever order; the leaves are bitwise those of a
    single thread."""
    cfg = get_model_config(arch, reduced=True)
    if arch.startswith("jamba"):
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    model = make_model(cfg)
    monkeypatch.setattr(layers, "INIT_PIECE", 1000)
    got = {}
    for threads in (1, 4):
        monkeypatch.setattr(layers, "INIT_THREADS", threads)
        got[threads], _ = tree_flatten(
            model.init(torch.Generator().manual_seed(3), "cpu"))
    assert max(t.numel() for t in got[1]) > 100 * layers.INIT_PIECE
    for a, b in zip(got[1], got[4]):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    monkeypatch.setattr(layers, "INIT_PIECE", 1 << 20)
    other, _ = tree_flatten(model.init(torch.Generator().manual_seed(3),
                                       "cpu"))
    assert not all(torch.equal(a, b) for a, b in zip(got[1], other))


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_a_leaf_is_its_pieces(dtype, monkeypatch):
    """Piece k of a 2,500-element leaf is ``std · randn`` from a generator
    seeded ``(seed + k · _MIX) mod 2^64``, cast to the param dtype."""
    monkeypatch.setattr(layers, "INIT_PIECE", 1000)
    monkeypatch.setattr(layers, "INIT_THREADS", 3)
    seed, std = 12345, 0.02
    leaf = layers.draw_normal((50, 50), std, seed, dtype)
    assert leaf.shape == (50, 50) and leaf.dtype == dtype
    flat = leaf.reshape(-1)
    for k, (lo, hi) in enumerate(((0, 1000), (1000, 2000), (2000, 2500))):
        gen = torch.Generator().manual_seed(
            (seed + k * layers._MIX) % 2**64)
        want = (torch.randn(hi - lo, generator=gen) * std).to(dtype)
        assert torch.equal(_bits(flat[lo:hi]), _bits(want))


def test_one_seed_per_drawn_leaf_in_creation_order():
    gen = torch.Generator().manual_seed(7)
    b = layers.ParamBuilder(gen, torch.float32, "cpu")
    b.add("z", (3,), init="zeros")
    b.add("w", (4, 5), init="fan_in")
    b.add("c", (2,), init="constant", scale=1.5)
    b.add("e", (6,), init="normal")
    ref = torch.Generator().manual_seed(7)
    seeds = [int(torch.randint(0, 2**62, (), generator=ref))
             for _ in range(2)]
    assert torch.equal(b.params["w"], layers.draw_normal(
        (4, 5), 1 / np.sqrt(4), seeds[0], torch.float32))
    assert torch.equal(b.params["e"], layers.draw_normal(
        (6,), 0.02, seeds[1], torch.float32))
    assert torch.equal(gen.get_state(), ref.get_state())
    assert not b.params["z"].any() and bool((b.params["c"] == 1.5).all())


def test_drawn_values_have_the_init_rule_scale():
    """A 4,000 x 1,000 fan-in leaf (4 pieces of 2^20) has std 1/√4000 and
    mean 0 to sampling error."""
    b = layers.ParamBuilder(torch.Generator().manual_seed(0), torch.float32,
                            "cpu")
    w = b.add("w", (4000, 1000))
    std = 1 / np.sqrt(4000)
    assert abs(float(w.std()) / std - 1) < 5e-3
    assert abs(float(w.mean())) < 5 * std / 2000     # 5 standard errors


@pytest.mark.parametrize("arch", ("gemma2-9b", "jamba-1.5-large-398b",
                                  "qwen3-0.6b", "llava-next-mistral-7b"))
def test_long_context_configs_equal_the_references(arch):
    """gemma2-9b's switches its global layers to the sliding window
    (``gemma2-9b-sw``); jamba's is its full config; an arch without a
    ``long_context_config`` ignores the keyword, reduced or not."""
    for reduced in (False, True):
        want = jax_config(arch, reduced=reduced, long_context=True)
        got = get_model_config(arch, reduced=reduced, long_context=True)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if arch == "gemma2-9b":
        assert got.name == "gemma2-9b-sw"
        assert set(got.layers) == {("attn_sw", "dense")}
        make_model(got)
