"""Port parity: the attention mixer's full-sequence forward and its
one-token decode against a KV cache, JAX vs ``repro_torch`` on the CPU.

The reference's ``init_attention`` draws the weights (biases and qk-norm
weights then redrawn from a numpy seed, so that they are not zeros and
ones), ``repro_torch.interop`` carries them across, and both packages
see the same numpy activations, cache and positions.

Tolerances: float32 compute, outputs and the updated caches within
2e-5 · max|ref| (the same math; matmul and softmax reductions sum in
another order, so a written row is a few ulp off); bf16 compute, within
2e-2 · max|ref| (both round after every product, in differently fused
places).  Every row decode does not write stays bitwise what it was.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JCfg
from repro.models import attention as jattn
from repro_torch import interop
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.models import attention as tattn
from repro_torch.tree import tree_map

torch.set_num_threads(2)

BASE = dict(name="attn", family="dense", citation="test", n_layers=1,
            d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
            vocab_size=128, dtype="float32")
VARIANTS = {
    "global": dict(),
    "window": dict(sliding_window=5, pattern=(("attn_sw", "dense"),)),
    "softcap": dict(attn_logit_softcap=2.0),
    "qknorm_bias": dict(qk_norm=True, qkv_bias=True),
    "gemma": dict(sliding_window=5, attn_logit_softcap=2.0,
                  pattern=(("attn_sw", "dense"),)),
    "g7_kv1": dict(n_heads=7, n_kv_heads=1, d_model=56, head_dim=8,
                   qkv_bias=True),
}
B, S, S_MAX = 3, 11, 16


def _cfgs(variant, dtype="float32"):
    kw = dict(BASE, dtype=dtype, **VARIANTS[variant])
    kind = kw.get("pattern", (("attn", "dense"),))[0][0]
    return JCfg(**kw), TCfg(**kw), kind


def _weights(jcfg, seed=0):
    params, _ = jattn.init_attention(jax.random.PRNGKey(seed), jcfg,
                                     jnp.float32)
    host = jax.device_get(params)
    rng = np.random.default_rng(seed + 100)
    for name in ("b_q", "b_k", "b_v"):
        if name in host:
            host[name] = (0.5 * rng.standard_normal(
                host[name].shape)).astype(np.float32)
    for name in ("q_norm", "k_norm"):
        if name in host:
            host[name] = (1.0 + 0.3 * rng.standard_normal(
                host[name].shape)).astype(np.float32)
    return host


def _node(host):
    return tree_map(lambda t: t[None], interop.from_numpy(host, "cpu"))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, rel):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_attn_forward_matches_reference(variant, dtype):
    jcfg, tcfg, kind = _cfgs(variant, dtype)
    host = _weights(jcfg)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x = np.random.default_rng(1).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    jout, jcache = jattn.attn_forward(
        jax.tree.map(jnp.asarray, host), jcfg, jnp.asarray(x).astype(jd),
        layer_kind=kind)
    tx = torch.from_numpy(x)[None].to(getattr(torch, dtype))
    tout, tcache = tattn.attn_forward(_node(host), tcfg, tx, layer_kind=kind)
    _close(tout[0], jout, 2e-5 if dtype == "float32" else 2e-2)
    for key in ("k", "v"):
        _close(tcache[key][0], jcache[key],
               2e-5 if dtype == "float32" else 2e-2)


def _decode_inputs(jcfg, seed, pos):
    rng = np.random.default_rng(seed)
    shape = (B, S_MAX, jcfg.n_kv_heads, jcfg.resolved_head_dim)
    cache = {"k": rng.standard_normal(shape).astype(np.float32),
             "v": rng.standard_normal(shape).astype(np.float32)}
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    return cache, x, np.asarray(pos, np.int32)


# rows at different positions; the last row of the second case past S_max
# (an idle serving slot): the write lands in row S_max - 1 (XLA clamps
# dynamic_update_slice's start), RoPE and the mask take the raw position
POSITIONS = {"ragged": (0, 7, 15), "past_s_max": (3, S_MAX, S_MAX + 9)}


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("where", sorted(POSITIONS))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_attn_decode_matches_reference(variant, where, dtype):
    jcfg, tcfg, kind = _cfgs(variant, dtype)
    host = _weights(jcfg, seed=2)
    cache, x, pos = _decode_inputs(jcfg, 3, POSITIONS[where])
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    jout, jcache = jattn.attn_decode(
        jax.tree.map(jnp.asarray, host), jcfg, jnp.asarray(x).astype(jd),
        jax.tree.map(lambda a: jnp.asarray(a).astype(jd), cache),
        jnp.asarray(pos), layer_kind=kind)
    tcache = {k: torch.from_numpy(v)[None].to(td) for k, v in cache.items()}
    given = dict(tcache)
    tout, got = tattn.attn_decode(_node(host), tcfg,
                                  torch.from_numpy(x)[None].to(td), tcache,
                                  torch.from_numpy(pos), layer_kind=kind)
    rel = 2e-5 if dtype == "float32" else 2e-2
    _close(tout[0], jout, rel)
    written = np.zeros((B, S_MAX), bool)
    written[np.arange(B), np.minimum(pos, S_MAX - 1)] = True
    for key in ("k", "v"):
        # written in place: the tensors given are the tensors returned
        assert got[key] is given[key]
        _close(got[key][0], jcache[key], rel)
        before = _f32(torch.from_numpy(cache[key]).to(td))
        np.testing.assert_array_equal(_f32(got[key][0])[~written],
                                      before[~written])


def test_decode_again_from_the_written_cache_gives_the_reference_answer():
    """The in-place write is invisible to a caller that decodes again from
    the same tensors at the same or an earlier position: the rows past it
    are masked."""
    jcfg, tcfg, kind = _cfgs("gemma")
    host = _weights(jcfg, seed=4)
    cache, x, _ = _decode_inputs(jcfg, 5, (0, 0, 0))
    tparams = _node(host)
    tcache = {k: torch.from_numpy(v)[None] for k, v in cache.items()}
    later = np.asarray((9, 12, 15), np.int32)
    tattn.attn_decode(tparams, tcfg, torch.from_numpy(x)[None], tcache,
                      torch.from_numpy(later), layer_kind=kind)
    for pos in ((9, 12, 15), (4, 2, 14)):
        pos = np.asarray(pos, np.int32)
        jout, _ = jattn.attn_decode(
            jax.tree.map(jnp.asarray, host), jcfg, jnp.asarray(x),
            jax.tree.map(jnp.asarray, cache), jnp.asarray(pos),
            layer_kind=kind)
        tout, _ = tattn.attn_decode(tparams, tcfg,
                                    torch.from_numpy(x)[None], tcache,
                                    torch.from_numpy(pos), layer_kind=kind)
        _close(tout[0], jout, 2e-5)


def test_prefill_cache_then_decode_matches_forward():
    """The forward's cache, padded to S_max, then one decode step per
    remaining position: each step's output equals the full forward's row
    (sliding window and softcap on)."""
    jcfg, tcfg, kind = _cfgs("gemma")
    tcfg = dataclasses.replace(tcfg, sliding_window=4)
    tparams = _node(_weights(jcfg, seed=6))
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, B, S, tcfg.d_model)).astype(np.float32))
    full, _ = tattn.attn_forward(tparams, tcfg, x, layer_kind=kind)
    S0 = 5
    _, cache = tattn.attn_forward(tparams, tcfg, x[:, :, :S0],
                                  layer_kind=kind)
    pad = (1, B, S_MAX - S0, tcfg.n_kv_heads, tcfg.resolved_head_dim)
    cache = {k: torch.cat([v, v.new_zeros(pad)], dim=2)
             for k, v in cache.items()}
    for t in range(S0, S):
        out, cache = tattn.attn_decode(
            tparams, tcfg, x[:, :, t:t + 1], cache,
            torch.full((B,), t, dtype=torch.int32), layer_kind=kind)
        _close(out[0, :, 0], full[0, :, t], 2e-5)


@pytest.mark.parametrize("window", (None, 3))
def test_attention_mask_matches_reference(window):
    rng = np.random.default_rng(8)
    q = rng.integers(0, 12, (2, 5)).astype(np.int32)
    k = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    valid = rng.random((2, 12)) > 0.3
    for causal in (True, False):
        want = jattn.attention_mask(jnp.asarray(q), jnp.asarray(k),
                                    causal=causal, window=window,
                                    k_valid=jnp.asarray(valid))
        got = tattn.attention_mask(torch.from_numpy(q),
                                   torch.from_numpy(k.copy()),
                                   causal=causal, window=window,
                                   k_valid=torch.from_numpy(valid))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("variant", ("global", "window", "g7_kv1"))
def test_init_attn_cache_matches_reference(variant):
    jcfg, tcfg, kind = _cfgs(variant)
    want = jattn.init_attn_cache(jcfg, 3, 20, jnp.bfloat16, kind)
    got = tattn.init_attn_cache(tcfg, 3, 20, torch.bfloat16, "cpu", kind)
    assert sorted(got) == sorted(want) == ["k", "v"]
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert got[key].dtype == torch.bfloat16
        assert not got[key].any()


def test_init_attention_keys_match_reference():
    for variant in VARIANTS:
        jcfg, tcfg, _ = _cfgs(variant)
        want = jax.tree.map(lambda a: a.shape, jax.device_get(
            jattn.init_attention(jax.random.PRNGKey(0), jcfg,
                                 jnp.float32)[0]))
        params, _ = tattn.init_attention(torch.Generator().manual_seed(0),
                                         tcfg, torch.float32, device="cpu")
        got = {k: tuple(v.shape) for k, v in params.items()}
        assert got == want, variant
