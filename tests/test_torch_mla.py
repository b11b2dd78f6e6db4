"""Port parity: Multi-head Latent Attention (DeepSeek-V2), the latent
path of ``models/attention.py``, JAX vs ``repro_torch`` on the CPU —
forward, the blocked path, decode against the latent cache and the
cache's allocation.

The reference's ``init_attention`` draws the weights (``kv_norm`` then
redrawn from a numpy seed, so that it is not ones), ``repro_torch.interop``
carries them across, and both packages see the same numpy activations,
latent cache and positions.  The config is deepseek-v2-lite's reduced
one (MLA with r = 64, nope 32 + rope 16, v 32), and a second with the
published head split at small width.

Tolerances: float32 compute, outputs and the caches within 2e-5 ·
max|ref| (the same math; the products and the softmax sum in another
order); bf16 compute 2e-2 · max|ref| (both round after every product,
in differently fused places).  The blocked path against the port's plain
``_mla_attend`` on the same inputs: 1e-6 · max|plain|.  Every cache row
decode does not write stays bitwise what it was.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro.configs.base import MLAConfig as JMLA
from repro.models import attention as jattn
from repro_torch import interop
from repro_torch.configs import MLAConfig, get_model_config
from repro_torch.models import attention as tattn
from repro_torch.tree import tree_map

torch.set_num_threads(2)

B, S, S_MAX = 3, 11, 16
VARIANTS = ("reduced", "published_split")


def _cfgs(variant, dtype="float32"):
    jc = jax_config("deepseek-v2-lite-16b", reduced=True)
    tc = get_model_config("deepseek-v2-lite-16b", reduced=True)
    if variant == "published_split":
        split = dict(kv_lora_rank=48, rope_head_dim=64, nope_head_dim=128,
                     v_head_dim=128)
        jc = dataclasses.replace(jc, n_heads=2, n_kv_heads=2, d_model=64,
                                 mla=JMLA(**split))
        tc = dataclasses.replace(tc, n_heads=2, n_kv_heads=2, d_model=64,
                                 mla=MLAConfig(**split))
    return (dataclasses.replace(jc, dtype=dtype),
            dataclasses.replace(tc, dtype=dtype))


def _weights(jcfg, seed=0):
    params, _ = jattn.init_attention(jax.random.PRNGKey(seed), jcfg,
                                     jnp.float32)
    host = jax.device_get(params)
    host["kv_norm"] = (1.0 + 0.3 * np.random.default_rng(seed + 100)
                       .standard_normal(host["kv_norm"].shape)
                       ).astype(np.float32)
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


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_init_attention_keys_and_shapes_match_reference():
    for variant in VARIANTS:
        jcfg, tcfg = _cfgs(variant)
        want = jax.tree.map(lambda a: a.shape, _weights(jcfg))
        params, _ = tattn.init_attention(torch.Generator().manual_seed(0),
                                         tcfg, torch.float32, device="cpu")
        got = {k: tuple(v.shape) for k, v in params.items()}
        assert got == want, variant
        assert sorted(got) == ["kv_norm", "w_dkv", "w_kr", "w_o", "w_q",
                               "w_uk", "w_uv"]
        assert torch.equal(params["kv_norm"],
                           torch.ones(tcfg.mla.kv_lora_rank))


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("variant", VARIANTS)
def test_mla_forward_matches_reference(variant, dtype):
    jcfg, tcfg = _cfgs(variant, dtype)
    host = _weights(jcfg)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x = _x((B, S, jcfg.d_model), 1)
    jout, jcache = jattn.attn_forward(
        jax.tree.map(jnp.asarray, host), jcfg, jnp.asarray(x).astype(jd),
        layer_kind="attn")
    tout, tcache = tattn.attn_forward(
        _node(host), tcfg, torch.from_numpy(x)[None].to(getattr(torch,
                                                                dtype)),
        layer_kind="attn")
    rel = 2e-5 if dtype == "float32" else 2e-2
    _close(tout[0], jout, rel)
    assert sorted(tcache) == ["c_kv", "k_rope"]
    for key in ("c_kv", "k_rope"):
        _close(tcache[key][0], jcache[key], rel)


@pytest.mark.parametrize("chunk", (4, 5, 16))
@pytest.mark.parametrize("causal", (True, False))
def test_mla_attend_blocked_matches_reference_and_plain(causal, chunk):
    """Sq = 13 in chunks of 4 and 5 (the last padded with rows at
    position -1) and of 16 (one chunk, clipped to Sq)."""
    jcfg, tcfg = _cfgs("reduced")
    host = _weights(jcfg, seed=1)
    jp, tp = jax.tree.map(jnp.asarray, host), _node(host)
    sq = 13
    x = _x((1, sq, jcfg.d_model), 2)
    pos = np.arange(sq, dtype=np.int32)[None]
    jq = jattn._mla_qkv(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    want = jattn._mla_attend_blocked(jp, jcfg, *jq, jnp.asarray(pos),
                                     jnp.asarray(pos), causal=causal,
                                     chunk=chunk)
    tpos = torch.from_numpy(pos)
    tq = tattn._mla_qkv(tp, tcfg, torch.from_numpy(x)[None], tpos)
    got = tattn._mla_attend_blocked(tp, tcfg, *tq, tpos, tpos,
                                    causal=causal, chunk=chunk)
    _close(got[0], want, 2e-5)
    mask = tattn.attention_mask(tpos, tpos, causal=causal, window=None)
    plain = tattn._mla_attend(tp, tcfg, *tq, mask)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                               atol=1e-6 * float(plain.abs().max()))


def test_attn_forward_takes_the_blocked_path_from_the_threshold(
        monkeypatch):
    """``attn_forward`` at S ≥ ``BLOCKED_THRESHOLD`` (lowered to 8 in both
    packages) goes through ``_mla_attend_blocked``, and agrees with the
    reference's."""
    jcfg, tcfg = _cfgs("reduced")
    host = _weights(jcfg, seed=3)
    calls = []
    real = tattn._mla_attend_blocked

    def spy(*a, **k):
        calls.append(a[2].shape)
        return real(*a, **k)

    monkeypatch.setattr(jattn, "BLOCKED_THRESHOLD", 8)
    monkeypatch.setattr(tattn, "BLOCKED_THRESHOLD", 8)
    monkeypatch.setattr(tattn, "_mla_attend_blocked", spy)
    x = _x((2, 9, jcfg.d_model), 4)
    jout, _ = jattn.attn_forward(jax.tree.map(jnp.asarray, host), jcfg,
                                 jnp.asarray(x), layer_kind="attn")
    tout, _ = tattn.attn_forward(_node(host), tcfg,
                                 torch.from_numpy(x)[None],
                                 layer_kind="attn")
    assert calls == [(1, 2, 9, tcfg.n_heads, tcfg.mla.nope_head_dim)]
    _close(tout[0], jout, 2e-5)


def _decode_inputs(jcfg, seed, pos):
    rng = np.random.default_rng(seed)
    m = jcfg.mla
    cache = {"c_kv": rng.standard_normal((B, S_MAX, m.kv_lora_rank)
                                         ).astype(np.float32),
             "k_rope": rng.standard_normal((B, S_MAX, m.rope_head_dim)
                                           ).astype(np.float32)}
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    return cache, x, np.asarray(pos, np.int32)


# rows at different positions; past S_max (an idle serving slot) the
# write lands in row S_max - 1, RoPE and the mask take the raw position
POSITIONS = {"ragged": (0, 7, 15), "past_s_max": (3, S_MAX, S_MAX + 9)}


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("where", sorted(POSITIONS))
@pytest.mark.parametrize("variant", VARIANTS)
def test_mla_decode_matches_reference(variant, where, dtype):
    jcfg, tcfg = _cfgs(variant, dtype)
    host = _weights(jcfg, seed=2)
    cache, x, pos = _decode_inputs(jcfg, 3, POSITIONS[where])
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    jout, jcache = jattn.attn_decode(
        jax.tree.map(jnp.asarray, host), jcfg, jnp.asarray(x).astype(jd),
        jax.tree.map(lambda a: jnp.asarray(a).astype(jd), cache),
        jnp.asarray(pos), layer_kind="attn")
    tcache = {k: torch.from_numpy(v)[None].to(td) for k, v in cache.items()}
    given = dict(tcache)
    tout, got = tattn.attn_decode(_node(host), tcfg,
                                  torch.from_numpy(x)[None].to(td), tcache,
                                  torch.from_numpy(pos), layer_kind="attn")
    rel = 2e-5 if dtype == "float32" else 2e-2
    _close(tout[0], jout, rel)
    written = np.zeros((B, S_MAX), bool)
    written[np.arange(B), np.minimum(pos, S_MAX - 1)] = True
    for key in ("c_kv", "k_rope"):
        # written in place: the tensors given are the tensors returned
        assert got[key] is given[key]
        _close(got[key][0], jcache[key], rel)
        before = _f32(torch.from_numpy(cache[key]).to(td))
        np.testing.assert_array_equal(_f32(got[key][0])[~written],
                                      before[~written])


def test_prefill_cache_then_decode_matches_forward():
    """The forward's latent cache, padded to S_max, then one decode step
    per remaining position: each step's output equals the full forward's
    row."""
    _, tcfg = _cfgs("reduced")
    jcfg, _ = _cfgs("reduced")
    tparams = _node(_weights(jcfg, seed=6))
    x = torch.from_numpy(_x((1, B, S, tcfg.d_model), 7))
    full, _ = tattn.attn_forward(tparams, tcfg, x, layer_kind="attn")
    S0 = 5
    _, cache = tattn.attn_forward(tparams, tcfg, x[:, :, :S0],
                                  layer_kind="attn")
    cache = {k: torch.cat([v, v.new_zeros((1, B, S_MAX - S0, v.shape[-1]))],
                          dim=2) for k, v in cache.items()}
    for t in range(S0, S):
        out, cache = tattn.attn_decode(
            tparams, tcfg, x[:, :, t:t + 1], cache,
            torch.full((B,), t, dtype=torch.int32), layer_kind="attn")
        _close(out[0, :, 0], full[0, :, t], 2e-5)


@pytest.mark.parametrize("variant", VARIANTS)
def test_init_attn_cache_matches_reference(variant):
    jcfg, tcfg = _cfgs(variant)
    want = jattn.init_attn_cache(jcfg, 3, 20, jnp.bfloat16, "attn")
    got = tattn.init_attn_cache(tcfg, 3, 20, torch.bfloat16, "cpu", "attn")
    assert sorted(got) == sorted(want) == ["c_kv", "k_rope"]
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert got[key].dtype == torch.bfloat16
        assert not got[key].any()
