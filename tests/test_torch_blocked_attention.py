"""Port parity: the blocked attention path for long sequences
(``models.attention._sdpa_blocked``, taken by ``attn_forward`` from
``BLOCKED_THRESHOLD`` = 8,192 positions on), JAX vs ``repro_torch`` on
the CPU, float32.

The same numpy q, k and v go through the reference's ``_sdpa_blocked``
(its scan over query chunks) and the port's (a Python loop writing each
chunk into one preallocated output).  Tolerances: the output within
1e-5 · max|reference| (the same fp32 products and softmax, summed in
another order); against the port's own plain ``_sdpa`` on the same
inputs 1e-6 · max|plain| (the same ops on fewer rows at a time); grads
through the blocked path within 1e-5 · max|grad| of the plain path's.
The 8,192-token ``attn_forward`` at tiny widths: the output 1e-5 ·
max|reference|, the cached keys 1e-4 · max|k| (RoPE's fp32 cos and sin of
angles up to 8,191 rad round differently in XLA and PyTorch: 5.4e-5 at
worst on keys of a few units).
"""
import math

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

torch.set_num_threads(2)

B, SQ, NKV, G, HD = 1, 1000, 2, 2, 16


def _qkv(seed, sq=SQ, sk=SQ):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, sq, NKV, G, HD)).astype(np.float32)
    k = rng.standard_normal((B, sk, NKV, HD)).astype(np.float32)
    v = rng.standard_normal((B, sk, NKV, HD)).astype(np.float32)
    return q, k, v


def _pos(s):
    return np.tile(np.arange(s, dtype=np.int32)[None], (B, 1))


CASES = [
    dict(causal=True, window=None, cap=None),
    dict(causal=False, window=None, cap=None),
    dict(causal=True, window=100, cap=None),
    dict(causal=False, window=None, cap=5.0),
    dict(causal=True, window=64, cap=5.0),
]


def _ids(c):
    return "-".join(f"{k}{v}" for k, v in c.items())


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_sdpa_blocked_matches_reference(case):
    """Sq = 1,000 in chunks of 128: 7 full chunks and one padded with 24
    rows at position -1 (the masked padding path)."""
    q, k, v = _qkv(0)
    pos = _pos(SQ)
    scale = 1.0 / math.sqrt(HD)
    want = np.asarray(jattn._sdpa_blocked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(pos), causal=case["causal"], window=case["window"],
        scale=scale, cap=case["cap"], group=G, chunk=128))
    tq, tk, tv = (torch.from_numpy(a)[None] for a in (q, k, v))
    tpos = torch.from_numpy(pos)
    got = tattn._sdpa_blocked(tq, tk, tv, tpos, tpos,
                              causal=case["causal"], window=case["window"],
                              scale=scale, cap=case["cap"], chunk=128)
    assert got.shape == (1,) + want.shape
    scale_ref = float(np.abs(want).max())
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0,
                               atol=1e-5 * scale_ref)
    mask = tattn.attention_mask(tpos, tpos, causal=case["causal"],
                                window=case["window"])
    plain = tattn._sdpa(tq, tk, tv, mask, scale=scale, cap=case["cap"])
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                               atol=1e-6 * float(plain.abs().max()))


@pytest.mark.parametrize("causal", (True, False))
def test_blocked_grads_match_plain_and_stay_finite(causal):
    """The padded rows are fully masked; with the finite ``NEG_INF`` they
    stay finite, so nothing non-finite reaches the backward pass."""
    q, k, v = _qkv(1, sq=300, sk=300)
    pos = torch.from_numpy(_pos(300))
    scale = 1.0 / math.sqrt(HD)
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, B, 300, NKV, G, HD)).astype(np.float32))

    def grads(fn):
        ts = [torch.from_numpy(a)[None].requires_grad_(True)
              for a in (q, k, v)]
        (fn(*ts) * w).sum().backward()
        return [t.grad for t in ts]

    blocked = grads(lambda a, b, c: tattn._sdpa_blocked(
        a, b, c, pos, pos, causal=causal, window=None, scale=scale,
        cap=10.0, chunk=128))
    mask = tattn.attention_mask(pos, pos, causal=causal, window=None)
    plain = grads(lambda a, b, c: tattn._sdpa(a, b, c, mask, scale=scale,
                                              cap=10.0))
    for g1, g2 in zip(blocked, plain):
        assert bool(torch.isfinite(g1).all())
        np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=0,
                                   atol=1e-5 * float(g2.abs().max()))


def test_chunk_not_dividing_uses_one_short_chunk_when_sq_is_smaller():
    """``chunk`` is clipped to Sq, as in the reference: Sq = 40 with chunk
    512 is one chunk and no padding."""
    q, k, v = _qkv(3, sq=40, sk=40)
    pos = torch.from_numpy(_pos(40))
    tq, tk, tv = (torch.from_numpy(a)[None] for a in (q, k, v))
    got = tattn._sdpa_blocked(tq, tk, tv, pos, pos, causal=True,
                              window=None, scale=0.25)
    mask = tattn.attention_mask(pos, pos, causal=True, window=None)
    want = tattn._sdpa(tq, tk, tv, mask, scale=0.25)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


TINY = dict(name="tiny", family="dense", citation="test", n_layers=1,
            d_model=32, n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64,
            vocab_size=64, dtype="float32", sliding_window=3000,
            attn_logit_softcap=30.0)


@pytest.mark.parametrize("layer_kind", ("attn", "attn_sw"))
def test_attn_forward_at_8192_positions_takes_the_blocked_path(layer_kind):
    """One ``attn_forward`` at S = 8,192 (B = 1, 2 heads, 1 kv head, head
    dim 16) against the reference's, which takes its own blocked path
    there; the cache rows come out as the reference's."""
    assert tattn.BLOCKED_THRESHOLD == jattn.BLOCKED_THRESHOLD == 8192
    assert tattn._Q_CHUNK == jattn._Q_CHUNK == 512
    S = tattn.BLOCKED_THRESHOLD
    jcfg = JCfg(**TINY)
    tcfg = TCfg(**TINY)
    params = jax.device_get(jattn.init_attention(
        jax.random.PRNGKey(0), jcfg, jnp.float32)[0])
    x = (0.5 * np.random.default_rng(4).standard_normal(
        (1, S, 32))).astype(np.float32)
    want, wcache = jax.jit(lambda p, h: jattn.attn_forward(
        p, jcfg, h, layer_kind=layer_kind))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = {k: v[None] for k, v in interop.from_numpy(params, "cpu").items()}
    got, gcache = tattn.attn_forward(tp, tcfg, torch.from_numpy(x)[None],
                                     layer_kind=layer_kind)
    want = np.asarray(want)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    np.testing.assert_allclose(gcache["k"][0].numpy(),
                               np.asarray(wcache["k"]), rtol=0,
                               atol=1e-4 * float(np.abs(wcache["k"]).max()))


def test_attn_forward_routes_on_the_threshold(monkeypatch):
    """``attn_forward`` takes the blocked path from ``BLOCKED_THRESHOLD``
    positions on and the plain one below (the threshold lowered to 64 to
    keep the plain side small); the two agree to 1e-6 of their scale."""
    cfg = TCfg(**TINY)
    calls = []
    real = tattn._sdpa_blocked

    def counted(*a, **kw):
        calls.append(a[0].shape[2])
        return real(*a, chunk=16, **kw)

    monkeypatch.setattr(tattn, "_sdpa_blocked", counted)
    monkeypatch.setattr(tattn, "BLOCKED_THRESHOLD", 64)
    gen = torch.Generator().manual_seed(5)
    tp = {k: 0.2 * torch.randn((1, 32, 2 if k == "w_q" else 1, 16),
                               generator=gen)
          for k in ("w_q", "w_k", "w_v")}
    tp["w_o"] = 0.2 * torch.randn((1, 2, 16, 32), generator=gen)
    x = torch.randn((1, 1, 70, 32), generator=gen)
    outs = {}
    for S in (63, 64, 70):
        outs[S] = tattn.attn_forward(tp, cfg, x[:, :, :S],
                                     layer_kind="attn_sw")[0]
    assert calls == [64, 70]
    monkeypatch.setattr(tattn, "BLOCKED_THRESHOLD", 8192)
    plain = tattn.attn_forward(tp, cfg, x, layer_kind="attn_sw")[0]
    assert calls == [64, 70]
    np.testing.assert_allclose(outs[70].numpy(), plain.numpy(), rtol=0,
                               atol=1e-6 * float(plain.abs().max()))
