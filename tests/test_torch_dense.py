"""Port parity: the dense decoders (pga-lm-100m, gemma2-9b, qwen3-0.6b,
qwen2-0.5b, qwen1.5-32b) at their reduced configs, JAX vs ``repro_torch``
on the CPU — configs, init, forward, prefill → decode, caches (the
engine, the batched server and the launcher:
``tests/test_torch_dense_serve.py``; the trainer:
``tests/test_torch_dense_train.py``).

Weights are drawn by the JAX package and carried across with
``repro_torch.interop``; prompts and batches are numpy from a seed.

Tolerances:
* float32 compute: logits and every cache leaf within 2e-5 · max|ref|
  (the same math, reductions summed in another order);
* bf16 compute (the production setting), the port's decode against its
  own full forward: the reference's own test's rule
  (``tests/test_decode_consistency.py``), ``|dec − fwd| ≤ 5e-2 + 5e-2 ·
  |fwd|`` elementwise; against the reference's logits 5e-2 · max|ref|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro.models import make_model as jax_make_model
from repro.serve import pad_cache_to as jax_pad_cache_to
from repro_torch import interop
from repro_torch.configs import get_model_config
from repro_torch.models.model import make_model
from repro_torch.serve import pad_cache_to
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(2)

ARCHS = ("pga-lm-100m", "gemma2-9b", "qwen3-0.6b", "qwen2-0.5b",
         "qwen1.5-32b")
NEW_CONFIGS = ("gemma2-9b", "qwen3-0.6b", "qwen2-0.5b", "qwen1.5-32b")


def _models(arch, dtype="float32"):
    jc = dataclasses.replace(jax_config(arch, reduced=True), dtype=dtype)
    tc = dataclasses.replace(get_model_config(arch, reduced=True),
                             dtype=dtype)
    return jax_make_model(jc), make_model(tc)


_WEIGHTS = {}


def _weights(arch):
    """One JAX init per arch (seed 0) as numpy, shared by the tests."""
    if arch not in _WEIGHTS:
        jm, _ = _models(arch)
        _WEIGHTS[arch] = jax.device_get(
            jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(0)))
    return _WEIGHTS[arch]


def _prompts(B, S, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _jit_prefill(jm):
    return jax.jit(lambda p, t: jm.forward(p, {"inputs": t}, mode="prefill",
                                           want_cache=True))


def _node(tree):
    return tree_map(lambda t: t[None], tree)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, rel):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def _check_caches(tcaches, jcaches, rel):
    jleaves = jax.tree.leaves(jcaches)
    tleaves = tree_leaves(tcaches)
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        assert str(t.dtype).split(".")[-1] == str(j.dtype), (t.dtype,
                                                              j.dtype)
        _close(t[0], j, rel)


# ---------------------------------------------------------------------------
# Configs and init
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", (False, True))
@pytest.mark.parametrize("arch", NEW_CONFIGS)
def test_config_equals_reference(arch, reduced):
    want = jax_config(arch, reduced=reduced)
    got = get_model_config(arch, reduced=reduced)
    names = {f.name for f in dataclasses.fields(got)}
    assert names == {f.name for f in dataclasses.fields(want)}
    for name in sorted(names):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("arch", ARCHS)
def test_init_keys_and_shapes_match_reference(arch):
    """``Model.init`` gives the reference's tree: ``unembed`` when untied,
    ``b_*``, ``q_norm``/``k_norm`` and ``post_ln*`` where the config has
    them."""
    _, tm = _models(arch)
    want = jax.tree.map(lambda a: tuple(a.shape), _weights(arch))
    got = tree_map(lambda t: tuple(t.shape),
                   tm.init(torch.Generator().manual_seed(0), "cpu"))
    assert got == want
    cfg = tm.cfg
    mixer = got["stack"]["scan"]["entry_0"]["mixer"]
    assert ("b_q" in mixer) == cfg.qkv_bias
    assert ("q_norm" in mixer) == cfg.qk_norm
    assert ("unembed" in got["embed"]) == (not cfg.tie_embeddings)
    assert ("post_ln2" in got["stack"]["scan"]["entry_0"]) == \
        cfg.post_block_norm


def test_full_gemma2_param_count():
    cfg = get_model_config("gemma2-9b")
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    per_layer = (d * nh * hd * 2 + d * nkv * hd * 2 + 3 * d * f + 4 * d)
    assert V * d + cfg.n_layers * per_layer + d == 9_241_705_984


# ---------------------------------------------------------------------------
# Forward, prefill and decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_float32_matches_reference(arch):
    jm, tm = _models(arch)
    w = _weights(arch)
    toks = _prompts(2, 13, 1)
    jl, _, _ = jm.forward(jax.tree.map(jnp.asarray, w), {"inputs": toks})
    tl, caches, lb = tm.forward(_node(interop.from_numpy(w, "cpu")),
                                {"inputs": torch.from_numpy(toks)[None]})
    assert caches is None and float(lb) == 0.0
    _close(tl[0], jl, 2e-5)
    if tm.cfg.final_logit_softcap is not None:
        assert float(tl.abs().max()) < tm.cfg.final_logit_softcap


@pytest.mark.parametrize("arch", ("gemma2-9b", "qwen3-0.6b",
                                  "qwen1.5-32b"))
def test_port_init_carries_into_the_reference(arch):
    """The other direction of ``interop``: the port's init (``unembed``,
    ``b_*``, ``q_norm``/``k_norm``, ``post_ln*`` leaves) as numpy runs in
    the reference and gives the port's logits, and a KV cache the port
    built decodes there as in the port."""
    jm, tm = _models(arch)
    tp = tm.init(torch.Generator().manual_seed(3), "cpu")
    host = interop.to_numpy(tp)
    jp = jax.tree.map(jnp.asarray, host)
    toks = _prompts(2, 7, 9)
    tl, tc, _ = tm.forward(_node(tp), {"inputs": torch.from_numpy(toks)[None]},
                           mode="prefill", want_cache=True)
    jl, _, _ = jm.forward(jp, {"inputs": toks})
    _close(tl[0], jl, 2e-5)
    tc = pad_cache_to(tc, 10)
    jc = jax.tree.map(jnp.asarray, tree_map(lambda a: a[0],
                                            interop.to_numpy(tc)))
    pos = np.full((2,), 7, np.int32)
    jl, _ = jm.decode_step(jp, jc, toks[:, :1], pos)
    tl, _ = tm.decode_step(_node(tp), tc, torch.from_numpy(toks[:, :1])[None],
                           torch.from_numpy(pos))
    _close(tl[0], jl, 2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill caches and four decode steps at float32, each package from
    its own state; positions differ between the two rows."""
    jm, tm = _models(arch)
    w = _weights(arch)
    jp, tp = jax.tree.map(jnp.asarray, w), _node(interop.from_numpy(w,
                                                                    "cpu"))
    toks = _prompts(2, 9, 2)
    jl, jc, _ = _jit_prefill(jm)(jp, toks)
    tl, tc, _ = tm.forward(tp, {"inputs": torch.from_numpy(toks)[None]},
                           mode="prefill", want_cache=True)
    _close(tl[0], jl, 2e-5)
    _check_caches(tc, jc, 2e-5)
    jc, tc = jax_pad_cache_to(jc, 16), pad_cache_to(tc, 16)
    nxt = _prompts(2, 4, 3)
    jstep = jax.jit(jm.decode_step)
    for t in range(4):
        pos = np.asarray((9 + t, 5 + t), np.int32)
        jl, jc = jstep(jp, jc, nxt[:, t:t + 1], pos)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(
            nxt[:, t:t + 1])[None], torch.from_numpy(pos))
        _close(tl[0], jl, 2e-5)
        _check_caches(tc, jc, 2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_forward_bf16(arch):
    """The port's counterpart of ``tests/test_decode_consistency.py``:
    bf16 compute, prompt of 6, decode of positions 6..11 against one full
    forward over the 12 tokens, the reference test's atol = rtol = 5e-2;
    and the same decode logits within 5e-2 · max|ref| of the
    reference's."""
    jm, tm = _models(arch, "bfloat16")
    w = _weights(arch)
    jp, tp = jax.tree.map(jnp.asarray, w), _node(interop.from_numpy(w,
                                                                    "cpu"))
    toks = _prompts(2, 12, 4)
    full, _, _ = tm.forward(tp, {"inputs": torch.from_numpy(toks)[None]})
    _, tc, _ = tm.forward(tp, {"inputs": torch.from_numpy(toks[:, :6])[None]},
                          mode="prefill", want_cache=True)
    _, jc, _ = _jit_prefill(jm)(jp, toks[:, :6])
    tc, jc = pad_cache_to(tc, 12), jax_pad_cache_to(jc, 12)
    jstep = jax.jit(jm.decode_step)
    for t in range(6, 12):
        pos = np.full((2,), t, np.int32)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(
            toks[:, t:t + 1])[None], torch.from_numpy(pos))
        jl, jc = jstep(jp, jc, toks[:, t:t + 1], pos)
        np.testing.assert_allclose(_f32(tl[0, :, 0]), _f32(full[0, :, t]),
                                   atol=5e-2, rtol=5e-2)
        _close(tl[0], jl, 5e-2)


@pytest.mark.parametrize("arch", ("pga-lm-100m", "gemma2-9b"))
def test_decode_from_reference_cache(arch):
    """The reference's bf16 prefill cache, carried across with ``interop``
    (bf16 KV leaves), decodes in the port as in the reference."""
    jm, tm = _models(arch, "bfloat16")
    w = _weights(arch)
    jp, tp = jax.tree.map(jnp.asarray, w), _node(interop.from_numpy(w,
                                                                    "cpu"))
    toks = _prompts(2, 9, 5)
    _, jc, _ = jm.forward(jp, {"inputs": toks}, mode="prefill",
                          want_cache=True)
    jc = jax_pad_cache_to(jc, 12)
    tc = _node(interop.from_numpy(jax.device_get(jc), "cpu"))
    _check_caches(tc, jc, 0.0)
    back = interop.to_numpy(tc)
    for a, b in zip(jax.tree.leaves(jax.device_get(jc)),
                    jax.tree.leaves(back)):
        np.testing.assert_array_equal(b[0], np.asarray(a, np.float32))
    pos = np.full((2,), 9, np.int32)
    jl, jc = jm.decode_step(jp, jc, toks[:, :1], pos)
    tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, :1])[None],
                            torch.from_numpy(pos))
    _close(tl[0], jl, 5e-2)
    _check_caches(tc, jc, 3e-2)


@pytest.mark.parametrize("arch", ("gemma2-9b", "qwen2-0.5b"))
def test_init_stack_cache_and_pad_match_reference(arch):
    jm, tm = _models(arch, "bfloat16")
    want = jm.init_cache(3, 20)
    got = tm.init_cache(3, 20, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda a: 0, want)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, _strip(got)))
    for t, j in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(t.shape) == (1,) + j.shape
        assert t.dtype == torch.bfloat16 and not t.any()
    # pad_cache_to on a prefill's KV leaves: zeros after the prompt
    toks = _prompts(1, 7, 6)
    _, tc, _ = tm.forward(_node(interop.from_numpy(_weights(arch), "cpu")),
                          {"inputs": torch.from_numpy(toks)[None]},
                          mode="prefill", want_cache=True)
    padded = pad_cache_to(tc, 20)
    jpadded = jax_pad_cache_to(jax.tree.map(lambda t: jnp.asarray(
        _f32(t[0])), tc), 20)
    for t, j in zip(tree_leaves(padded), jax.tree.leaves(jpadded)):
        assert tuple(t.shape[1:]) == j.shape
        np.testing.assert_array_equal(_f32(t[0]), np.asarray(j))
        assert not t[:, :, :, 7:].any()
    # a window no longer than the cache leaves every leaf as it is
    assert all(a is b for a, b in zip(tree_leaves(pad_cache_to(padded, 8)),
                                      tree_leaves(padded)))


def _strip(tree):
    return tree_map(lambda t: t[0], tree)
