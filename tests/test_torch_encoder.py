"""Port parity: the encoder family (bert-large, hubert-xlarge), JAX vs
``repro_torch`` on the CPU at the reduced configs.

Weights are drawn by the JAX package and carried across with
``repro_torch.interop.from_numpy``; batches come from both packages'
``SyntheticStream`` and must be bitwise equal.

Tolerances: logits within 1e-5 · max|reference| at float32 compute (the
same products summed in another order) and 2e-2 · max|reference| at
bf16 compute (the products round to bf16 on both sides, each in its own
order); the masked loss and z-loss rtol 1e-5 (float32) and 1e-2 (bf16);
each gradient leaf within 1e-5 · its largest entry (float32).  GELU's
tanh form against ``jax.nn.gelu`` within 1e-6 absolute (float32
``tanh`` and ``pow`` in another library).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_model_config as jax_config
from repro.data.synthetic import SyntheticStream as JStream
from repro.models import make_model as jax_make_model
from repro.configs.base import DataConfig as JData
from repro_torch import interop
from repro_torch.configs import get_model_config, list_archs
from repro_torch.configs.base import DataConfig as TData
from repro_torch.data.synthetic import SyntheticStream as TStream
from repro_torch.models import blocks
from repro_torch.models.model import make_model

torch.set_num_threads(2)

ARCHS = ("bert-large", "hubert-xlarge")


def _models(arch, dtype="float32"):
    jc = dataclasses.replace(jax_config(arch, reduced=True), dtype=dtype)
    tc = dataclasses.replace(get_model_config(arch, reduced=True),
                             dtype=dtype)
    return jax_make_model(jc), make_model(tc)


def _weights(jm, seed=0):
    return jax.device_get(jax.jit(lambda k: jm.init(k)[0])(
        jax.random.PRNGKey(seed)))


def _batch(cfg_j, cfg_t, n=1, b=2, s=24, step=3, non_iid=True):
    jb = JStream(cfg_j, JData(non_iid=non_iid), n, b, s).get_batch(step)
    tb = TStream(cfg_t, TData(non_iid=non_iid), n, b, s).get_batch(step)
    return jb, tb


# ---------------------------------------------------------------------------
# Configs and params
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", (False, True))
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch, reduced):
    got = get_model_config(arch, reduced=reduced)
    want = jax_config(arch, reduced=reduced)
    assert arch in list_archs()
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "audio" and a is not None:
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b, f.name
    assert got.is_encoder and got.family == "encoder"


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(arch):
    """The port's tree at the reduced config has the reference's keys and
    shapes, ``mask_emb`` (d_model) among them; the full bert-large holds
    465,213,440 parameters a replica (shapes only, no draw)."""
    jm, tm = _models(arch)
    want = _weights(jm)
    got = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert got["mask_emb"].shape == (tm.cfg.d_model,)
    assert jax.tree.structure(jax.tree.map(lambda a: 0, want)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, got))
    assert [a.shape for a in jax.tree.leaves(want)] == \
        [tuple(t.shape) for t in jax.tree.leaves(got)]
    full = jax_make_model(jax_config(arch))
    shapes = jax.eval_shape(lambda k: full.init(k)[0],
                            jax.random.PRNGKey(0))
    count = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    cfg = get_model_config(arch)
    d, f, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
    assert count == 2 * V * d + L * (4 * d * d + 3 * d * f + 2 * d) + 2 * d
    if arch == "bert-large":
        assert count == 465_213_440


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("non_iid", (True, False))
@pytest.mark.parametrize("arch", ARCHS)
def test_encoder_batches_bitwise(arch, non_iid):
    jc, tc = jax_config(arch, reduced=True), get_model_config(arch,
                                                                reduced=True)
    for step in (0, 1, 5):
        jb, tb = _batch(jc, tc, n=3, b=2, s=20, step=step, non_iid=non_iid)
        assert sorted(jb) == sorted(tb)
        assert "mask" in tb and tb["mask"].dtype == np.bool_
        assert ("frames" in tb) == (arch == "hubert-xlarge")
        for key in jb:
            assert tb[key].dtype == jb[key].dtype
            np.testing.assert_array_equal(tb[key], jb[key])


# ---------------------------------------------------------------------------
# GELU and the block vocabulary
# ---------------------------------------------------------------------------
def test_gelu_is_the_tanh_form():
    x = np.linspace(-6, 6, 2001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = blocks._gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    erf = F.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4      # the form that would drift


def test_encoder_family_checks():
    """The encoder builds non-causal, and since slice 14 (ROADMAP A.8
    closed) every other combination builds too, as in the reference: a
    causal encoder, a non-causal decoder, an MoE sub-config no block uses,
    the moe family non-causal, and an audio stub outside the encoder
    family (ignored there: the batch is tokens)."""
    cfg = get_model_config("bert-large", reduced=True)
    make_model(cfg)
    for over in (dict(causal=True), dict(family="dense"),
                 dict(moe=object()), dict(family="moe")):
        model = make_model(dataclasses.replace(cfg, **over))
        assert model.cfg.causal == over.get("causal", False)
    model = make_model(dataclasses.replace(
        get_model_config("hubert-xlarge", reduced=True),
        family="dense", causal=True))
    assert model.cfg.audio is not None and model.cfg.family == "dense"


# ---------------------------------------------------------------------------
# Forward and loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_masked_loss_match_reference(arch, dtype):
    jm, tm = _models(arch, dtype)
    w = _weights(jm)
    jb, tb = _batch(jm.cfg, tm.cfg)
    one = {k: v[0] for k, v in jb.items()}
    jl, jmet = jax.jit(lambda p, b: jm.loss(p, b, z_loss=1e-4))(
        jax.tree.map(jnp.asarray, w), jax.tree.map(jnp.asarray, one))
    jlog, _, _ = jax.jit(lambda p, b: jm.forward(p, b))(
        jax.tree.map(jnp.asarray, w), jax.tree.map(jnp.asarray, one))
    tp = interop.from_numpy(w, "cpu")
    tl, tmet = tm.loss(tp, interop.from_numpy(one, "cpu"), z_loss=1e-4)
    tlog, _, _ = tm.forward(jax.tree.map(lambda t: t[None], tp),
                            interop.from_numpy(tb, "cpu"))
    jlog = np.asarray(jlog)
    rtol, frac = (1e-5, 1e-5) if dtype == "float32" else (1e-2, 2e-2)
    np.testing.assert_allclose(tlog[0].numpy(), jlog, rtol=0,
                               atol=frac * float(np.abs(jlog).max()))
    np.testing.assert_allclose(float(tl), float(jl), rtol=rtol)
    for key in ("ce", "z_loss", "loss"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=rtol)


@pytest.mark.parametrize("arch", ARCHS)
def test_node_losses_use_each_nodes_mask_count(arch):
    """Stacked over 3 nodes, each node's loss is its own masked mean
    (``max(Σ mask, 1)`` per node), the reference's vmapped loss; a node
    with an empty mask gets 0, not NaN."""
    jm, tm = _models(arch)
    w = _weights(jm)
    jb, tb = _batch(jm.cfg, tm.cfg, n=3, b=2, s=16)
    jb["mask"][2] = False
    tb["mask"][2] = False
    stacked = jax.tree.map(lambda a: np.stack([a] * 3), w)
    jl, _ = jax.jit(jax.vmap(lambda p, b: jm.loss(p, b)))(
        jax.tree.map(jnp.asarray, stacked), jax.tree.map(jnp.asarray, jb))
    tl, _ = tm.node_losses(interop.from_numpy(stacked, "cpu"),
                           interop.from_numpy(tb, "cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    assert float(tl[2]) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_match_reference(arch):
    jm, tm = _models(arch)
    w = _weights(jm)
    jb, _ = _batch(jm.cfg, tm.cfg)
    one = {k: v[0] for k, v in jb.items()}
    jg = jax.grad(lambda p: jm.loss(p, one)[0])(jax.tree.map(jnp.asarray,
                                                             w))
    leaves, treedef = jax.tree.flatten(interop.from_numpy(w, "cpu"))
    live = [t.clone().requires_grad_(True) for t in leaves]
    tl, _ = tm.loss(jax.tree.unflatten(treedef, live),
                    interop.from_numpy(one, "cpu"))
    grads = torch.autograd.grad(tl, live, allow_unused=True,
                                materialize_grads=True)
    for a, b in zip(jax.tree.leaves(jg), grads):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(a).max()))
    if arch == "hubert-xlarge":
        # frames feed the stack: the token table gets exact zeros
        assert float(np.abs(np.asarray(jg["embed"]["embedding"])).max()) \
            == 0.0


def test_serve_launcher_refuses_an_encoder():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "bert-large", "--device", "cpu"])
