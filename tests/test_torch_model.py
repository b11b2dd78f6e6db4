"""Port parity: the dense decoder LM, JAX vs ``repro_torch`` on the CPU.

The JAX init is exported to numpy and carried into the port through
``repro_torch.interop``; both packages see the same numpy batch.

Tolerances: at fp32 compute, rtol 1e-5 on the loss and on the grads
(atol 1e-6 relative to each leaf's largest grad): same math, but matmul
and softmax reductions sum in another order.  At bf16 compute (the
production setting) both packages round activations to bf16 after every
matmul, but in differently fused places, so values agree to bf16
precision: rtol 1e-3 on the loss and a relative grad error of 5e-2 of
each leaf's norm (measured: 5e-5 and at most 1.8e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JCfg
from repro.models.model import make_model as jmake
from repro_torch import interop
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.models.model import make_model as tmake

torch.set_num_threads(2)

TINY = dict(name="tiny", family="dense", citation="test", n_layers=2,
            d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
            vocab_size=256, tie_embeddings=True)
B, S = 2, 16


def _models(dtype, **over):
    kw = dict(TINY, dtype=dtype, **over)
    return jmake(JCfg(**kw)), tmake(TCfg(**kw))


def _batch(seed=0, lead=()):
    rng = np.random.default_rng(seed)
    shape = lead + (B, S)
    return {"inputs": rng.integers(0, 256, shape).astype(np.int32),
            "targets": rng.integers(0, 256, shape).astype(np.int32)}


def _jax_loss_grads(jm, params, batch):
    def f(p):
        return jm.loss(p, batch)[0]
    return jax.value_and_grad(f)(params)


def _torch_loss_grads(tm, params, batch, remat="none"):
    leaves, treedef = jax.tree.flatten(params)
    live = [p.clone().requires_grad_(True) for p in leaves]
    loss, metrics = tm.loss(jax.tree.unflatten(treedef, live), batch,
                            remat=remat)
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), metrics, jax.tree.unflatten(treedef, list(grads))


def _check_grads(jg, tg, rel):
    for a, b in zip(jax.tree.leaves(jg), jax.tree.leaves(tg)):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape
        scale = float(np.abs(a).max())
        np.testing.assert_allclose(b, a, rtol=rel, atol=rel * scale)


@pytest.mark.parametrize("n_kv_heads", (4, 2))
def test_fp32_loss_and_grads_match(n_kv_heads):
    jm, tm = _models("float32", n_kv_heads=n_kv_heads)
    params, _ = jm.init(jax.random.PRNGKey(0))
    host = jax.device_get(params)
    batch = _batch(1)
    jl, jg = _jax_loss_grads(jm, params, jax.tree.map(jnp.asarray, batch))
    tb = interop.from_numpy(batch, "cpu")
    tl, metrics, tg = _torch_loss_grads(
        tm, interop.from_numpy(host, "cpu"), tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert set(metrics) == {"ce", "lb_loss", "loss"}
    _check_grads(jg, tg, 1e-5)
    # per-block recomputation changes nothing but memory
    tl2, _, tg2 = _torch_loss_grads(tm, interop.from_numpy(host, "cpu"), tb,
                                    remat="default")
    assert float(tl2) == float(tl)
    _check_grads(jax.tree.map(np.asarray, interop.to_numpy(tg)), tg2, 1e-6)


def test_bf16_loss_and_grads_match():
    jm, tm = _models("bfloat16")
    params, _ = jm.init(jax.random.PRNGKey(1))
    batch = _batch(2)
    jl, jg = _jax_loss_grads(jm, params, jax.tree.map(jnp.asarray, batch))
    tl, _, tg = _torch_loss_grads(
        tm, interop.from_numpy(jax.device_get(params), "cpu"),
        interop.from_numpy(batch, "cpu"))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)
    for a, b in zip(jax.tree.leaves(jg), jax.tree.leaves(tg)):
        a, b = np.asarray(a), b.numpy()
        err = np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-30)
        assert err < 5e-2, err


def test_node_losses_match_vmapped_reference():
    """All n replicas at once (the port's batched layout) equals the
    reference's ``vmap`` of one node's loss, per node."""
    jm, tm = _models("float32")
    n = 3
    keys = jax.random.split(jax.random.PRNGKey(2), n)
    stacked = jax.vmap(lambda k: jm.init(k)[0])(keys)
    batch = _batch(3, lead=(n,))
    jl, jmet = jax.vmap(jm.loss)(stacked, jax.tree.map(jnp.asarray, batch))
    tl, tmet = tm.node_losses(
        interop.from_numpy(jax.device_get(stacked), "cpu"),
        interop.from_numpy(batch, "cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(tmet["ce"].numpy(), np.asarray(jmet["ce"]),
                               rtol=1e-5)


def test_init_shapes_match_reference_layout():
    """Model.init gives the reference's keys and shapes; the full
    pga-lm-100m config has 138.4M parameters per replica."""
    jm, tm = _models("float32")
    jp, _ = jm.init(jax.random.PRNGKey(0))
    tp = tm.init(torch.Generator().manual_seed(0), "cpu")
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    tshapes = jax.tree.map(lambda a: tuple(a.shape), tp)
    assert jshapes == tshapes
    # same init rule per leaf: ones for norms, std 0.02 for the embedding,
    # 1/sqrt(fan_in) for the projections
    assert torch.equal(tp["final_norm"], torch.ones(64))
    emb = tp["embed"]["embedding"]
    assert abs(float(emb.std()) - 0.02) < 2e-3
    w_up = tp["stack"]["scan"]["entry_0"]["ffn"]["w_up"]
    assert abs(float(w_up.std()) - 64 ** -0.5) < 0.01
    from repro_torch.configs import get_model_config

    def count(cfg):
        d, f, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
        return V * d + L * (4 * d * d + 3 * d * f + 2 * d) + d

    assert sum(p.numel() for p in jax.tree.leaves(tp)) == count(tm.cfg)
    assert count(get_model_config("pga-lm-100m")) == 138_431_232


def test_unported_model_features_raise():
    """What A.8 waited for is ported, and each feature builds and runs:
    Mamba, the hybrid family, the VLM stub's config (a dense family
    ignores it, as the reference does), non-causal attention outside the
    encoder family, an MoE sub-config outside the moe family (no block
    uses it) — each forward within 2e-5 · max|ref| of the reference's
    (float32); a compressed query (MLA's ``q_lora_rank``) raises
    ``ValueError``, the reference having no params for it.  The dense
    features (qk-norm, softcaps, untied embeddings, ...), the encoder, a
    prefix pattern and the moe family build, and since the blocked path a
    forward at S ≥ 8192 runs."""
    from repro.configs.base import SSMConfig as JSSM
    from repro.configs.base import VisionStubConfig as JVision
    from repro_torch.configs import (MLAConfig, SSMConfig,
                                     VisionStubConfig, get_model_config)
    from repro_torch.tree import tree_map
    for jover, tover in (
            (dict(pattern=(("mamba", "none"),), ssm=JSSM()),
             dict(pattern=(("mamba", "none"),), ssm=SSMConfig())),
            (dict(family="hybrid"),) * 2,
            (dict(vision=JVision()), dict(vision=VisionStubConfig())),
            (dict(causal=False),) * 2, (dict(moe=object()),) * 2):
        jm, tm = (jmake(JCfg(**dict(TINY, dtype="float32", **jover))),
                  tmake(TCfg(**dict(TINY, dtype="float32", **tover))))
        w = jax.device_get(jm.init(jax.random.PRNGKey(0))[0])
        toks = _batch(1)["inputs"]
        jl, _, _ = jm.forward(w, {"inputs": toks})
        tl, _, _ = tm.forward(
            tree_map(lambda t: t[None], interop.from_numpy(w, "cpu")),
            {"inputs": torch.from_numpy(toks)[None]})
        err = float(np.abs(tl[0].numpy() - np.asarray(jl)).max())
        assert err <= 2e-5 * float(np.abs(np.asarray(jl)).max()), tover
    ds = get_model_config("deepseek-v2-lite-16b", reduced=True)
    with pytest.raises(ValueError, match="q_lora_rank"):
        tmake(dataclasses.replace(ds, mla=MLAConfig(kv_lora_rank=64,
                                                    q_lora_rank=32)))
    tmake(ds)
    tmake(dataclasses.replace(TCfg(**TINY), n_layers=3,
                              prefix_pattern=(("attn", "dense"),)))
    tmake(dataclasses.replace(TCfg(**TINY), family="moe"))
    tmake(dataclasses.replace(TCfg(**TINY), family="encoder", causal=False))
    tm = tmake(TCfg(**TINY))
    node = jax.tree.map(lambda t: t[None], tm.init(
        torch.Generator().manual_seed(0), "cpu"))
    logits, _, _ = tm.forward(node, {"inputs": torch.zeros(
        (1, 1, 8192), dtype=torch.int32)})
    assert logits.shape == (1, 1, 8192, 256)
    assert bool(torch.isfinite(logits).all())
    for over in (dict(qk_norm=True), dict(attn_logit_softcap=50.0),
                 dict(tie_embeddings=False), dict(qkv_bias=True),
                 dict(final_logit_softcap=30.0, post_block_norm=True,
                      sliding_window=4,
                      pattern=(("attn_sw", "dense"), ("attn", "dense")))):
        tmake(dataclasses.replace(TCfg(**TINY), **over))
