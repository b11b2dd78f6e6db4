"""Port parity: training the MoE decoders (deepseek-v2-lite-16b,
qwen3-moe-30b-a3b) at their reduced configs, JAX vs ``repro_torch`` on the
CPU, float32 compute — ``Model.loss`` with the balance loss × ``aux_coef``
and its gradients, and the Trainer.

Weights are drawn by the JAX package and carried across with
``repro_torch.interop``; batches are numpy from a seed.

Tolerances: the loss and ``lb_loss`` rtol 1e-5 and each gradient leaf
within 1e-5 · its largest entry (the same math under autograd and
``jax.grad``, reductions summed in another order); two Trainer steps
(SGD) against the JAX Trainer: the loss rtol 1e-5, the params rtol 1e-5
with atol 1e-7, and the consensus after the global round exactly 0.0.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro.models import make_model as jax_make_model
from repro_torch import interop
from repro_torch.configs import get_model_config
from repro_torch.models.model import make_model

torch.set_num_threads(2)

ARCHS = ("deepseek-v2-lite-16b", "qwen3-moe-30b-a3b")


def _cfgs(arch):
    return (dataclasses.replace(jax_config(arch, reduced=True),
                                dtype="float32"),
            dataclasses.replace(get_model_config(arch, reduced=True),
                                dtype="float32"))


def _models(arch):
    jc, tc = _cfgs(arch)
    return jax_make_model(jc), make_model(tc)


def _prompts(B, S, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_with_aux_coef_and_grads_match_reference(arch):
    """``Model.loss`` = ce + aux_coef · lb_loss, as the reference's; its
    ``lb_loss`` metric and every gradient leaf (the router's through the
    balance loss and the top-k weights)."""
    jm, tm = _models(arch)
    w = jax.device_get(jm.init(jax.random.PRNGKey(0))[0])
    toks = _prompts(2, 17, 8)
    batch = {"inputs": toks, "targets": np.roll(toks, -1, axis=1)}
    (jl, jmet), jg = jax.value_and_grad(lambda p: jm.loss(p, batch),
                                        has_aux=True)(
        jax.tree.map(jnp.asarray, w))
    leaves, treedef = jax.tree.flatten(interop.from_numpy(w, "cpu"))
    live = [t.clone().requires_grad_(True) for t in leaves]
    tl, tmet = tm.loss(jax.tree.unflatten(treedef, live),
                       interop.from_numpy(batch, "cpu"))
    grads = torch.autograd.grad(tl, live)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    tmet = {k: float(v.detach()) for k, v in tmet.items()}
    np.testing.assert_allclose(tmet["lb_loss"], float(jmet["lb_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(
        tmet["loss"], tmet["ce"] + tm.cfg.moe.aux_coef * tmet["lb_loss"],
        rtol=1e-6)
    for a, b in zip(jax.tree.leaves(jg), grads):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(a).max()))


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_steps_match_reference(arch):
    """Two steps of Gossip-PGA (H = 2: a gossip round, then a global one)
    on 4 nodes, SGD, float32, fused backend: the port's Trainer against
    the JAX Trainer from the same weights (the balance loss in each
    node's loss)."""
    from repro.configs import base as jcfg
    from repro.train.trainer import Trainer as JTrainer
    from repro_torch.configs import base as tcfg
    from repro_torch.train import Trainer as TTrainer

    n = 4
    dist = dict(algorithm="gossip_pga", topology="one_peer_exp", H=2,
                comm_backend="pallas")
    opt = dict(name="sgd", lr=0.05, schedule="constant", warmup_steps=0)
    common = dict(global_batch=8, seq_len=16, log_every=1)
    jc, tc = _cfgs(arch)
    jt = jcfg.TrainConfig(model=jc, dist=jcfg.DistConfig(**dist),
                          optimizer=jcfg.OptimizerConfig(**opt), **common)
    tt = tcfg.TrainConfig(model=tc, dist=tcfg.DistConfig(**dist),
                          optimizer=tcfg.OptimizerConfig(**opt), **common)
    jtr = JTrainer(jt, n_nodes=n, with_consensus=True)
    jst = jtr.init_state(jax.random.PRNGKey(0))
    row0 = jax.tree.map(lambda p: np.asarray(p[0]),
                        jax.device_get(jst.params))
    jst = jtr.run(jst, steps=2, log_every=1)
    ttr = TTrainer(tt, n_nodes=n, with_consensus=True, device="cpu")
    tst = ttr.init_state(params=interop.from_numpy(row0, "cpu"))
    tst = ttr.run(tst, steps=2, log_every=1)
    assert [r["phase"] for r in ttr.history] == ["gossip", "global"]
    for jr, tr in zip(jtr.history, ttr.history):
        np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=1e-5)
    assert ttr.history[-1]["consensus"] == 0.0
    for a, b in zip(jax.tree.leaves(jax.device_get(jst.params)),
                    jax.tree.leaves(interop.to_numpy(tst.params))):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7)
