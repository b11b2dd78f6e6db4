"""Port parity: gradient accumulation over microbatches
(``TrainConfig.microbatches``) and the remat policies
(``DistConfig.remat``/``remat_policy``, ``models.blocks.make_remat``),
JAX vs ``repro_torch`` on the CPU.

Tolerances, with their reasons:
* one ``build_train_step`` (SGD, gossip) with 1 or 4 microbatches on the
  reduced pga-lm-100m and bert-large at float32, from the same weights
  and batch: the forward and backward sum in another order, so params
  rtol 1e-5 with atol 1e-5 · lr (measured: 1.8e-7 = 3.6e-6 · lr, on
  bert-large's few masked positions) and the metrics rtol 1e-5.  The
  encoder's microbatch mean
  is the mean of each slice's masked mean (each slice has its own mask
  count), not the full batch's, in both packages;
* the reference's own ``test_microbatch_equivalence`` in the port (bf16
  compute, 1 against 4 microbatches): loss rtol 1e-3, params atol 1e-4,
  its tolerances;
* ``build_grad_fn``'s 4-microbatch grads are the fp32 sum of the 4
  slices' one-batch grads ``/ 4``, the same ops in the same order:
  bitwise; its loss the slices' mean, rtol 1e-6;
* the three remat policies run the same ops in the same order on the
  CPU: their grads are bitwise equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import base as jcfg
from repro.configs import get_model_config as jax_config
from repro.models.model import make_model as jmake
from repro.train import state as jstate
from repro.train.step import build_train_step as jbuild
from repro_torch import interop
from repro_torch.configs import base as tcfg_mod
from repro_torch.configs import get_model_config
from repro_torch.data import make_stream
from repro_torch.models import blocks
from repro_torch.models.model import make_model as tmake
from repro_torch.optim import make_optimizer
from repro_torch.train import Trainer
from repro_torch.train.state import TrainState, stack_for_nodes
from repro_torch.train.step import build_grad_fn
from repro_torch.train.step import build_train_step as tbuild
from repro_torch.tree import tree_flatten, tree_unflatten

torch.set_num_threads(2)

N = 2
LR = 0.05


def _configs(arch, microbatches, dtype="float32", **dist_kw):
    dist = {"topology": "ring", "H": 4, **dist_kw}
    opt = dict(name="sgd", lr=LR, grad_clip=None, weight_decay=0.0)
    common = dict(global_batch=8, seq_len=32, log_every=0,
                  microbatches=microbatches)
    jt = jcfg.TrainConfig(
        model=dataclasses.replace(jax_config(arch, reduced=True),
                                  dtype=dtype),
        dist=jcfg.DistConfig(**dist), optimizer=jcfg.OptimizerConfig(**opt),
        **common)
    tt = tcfg_mod.TrainConfig(
        model=dataclasses.replace(get_model_config(arch, reduced=True),
                                  dtype=dtype),
        dist=tcfg_mod.DistConfig(**dist),
        optimizer=tcfg_mod.OptimizerConfig(**opt), **common)
    return jt, tt


def _port_state(tm, tt, params):
    tp = stack_for_nodes(params, N)
    return TrainState(params=tp, opt_state=make_optimizer(
        tt.optimizer, per_node=True).init(tp), step=0)


@pytest.mark.parametrize("microbatches", (1, 4))
@pytest.mark.parametrize("arch", ("pga-lm-100m", "bert-large"))
def test_step_with_microbatches_matches_reference(arch, microbatches):
    jt, tt = _configs(arch, microbatches)
    jm, tm = jmake(jt.model), tmake(tt.model)
    params, _ = jm.init(jax.random.PRNGKey(0))
    jp = jstate.stack_for_nodes(params, N)
    jst = jstate.TrainState(
        params=jp, opt_state={"momentum": jax.tree.map(jnp.zeros_like, jp)},
        step=jnp.zeros((), jnp.int32), extras={})
    batch = make_stream(tt.model, tt.data, n_nodes=N, global_batch=8,
                        seq_len=32).get_batch(0)
    jst, jmet = jax.jit(jbuild(jm, jt, N, phase="gossip"))(
        jst, jax.tree.map(jnp.asarray, batch), jnp.float32(LR))
    tst = _port_state(tm, tt, interop.from_numpy(jax.device_get(params),
                                                 "cpu"))
    tst, tmet = tbuild(tm, tt, N, phase="gossip")(
        tst, interop.from_numpy(batch, "cpu"), LR)
    for key in ("loss", "ce"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-5)
    for a, b in zip(jax.tree.leaves(jax.device_get(jst.params)),
                    jax.tree.leaves(interop.to_numpy(tst.params))):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * LR)


@pytest.mark.parametrize("mode", ("push", "overlap"))
def test_trainer_accumulates_in_every_step_mode(mode):
    """The push-sum and the overlapped steps accumulate too: two Trainer
    steps (gossip, then global) of the reduced bert-large with 2
    microbatches against the JAX Trainer from the same weights, at the
    step's tolerances (loss rtol 1e-5, params atol 1e-5 · lr)."""
    from repro.train import Trainer as JTrainer
    over = (dict(push_sum=True, topology="directed_exp") if mode == "push"
            else dict(comm_overlap=True, topology="one_peer_exp"))
    jt, tt = _configs("bert-large", 2, H=2, comm_backend="pallas")
    jt = jt.replace(dist=dataclasses.replace(jt.dist, **over),
                    global_batch=4 * N)
    tt = tt.replace(dist=dataclasses.replace(tt.dist, **over),
                    global_batch=4 * N)
    jtr = JTrainer(jt, n_nodes=N)
    jst = jtr.init_state(jax.random.PRNGKey(0))
    row0 = jax.tree.map(lambda p: np.asarray(p[0]),
                        jax.device_get(jst.params))
    jst = jtr.run(jst, steps=2, log_every=1)
    ttr = Trainer(tt, n_nodes=N, device="cpu")
    tst = ttr.run(ttr.init_state(params=interop.from_numpy(row0, "cpu")),
                  steps=2, log_every=1)
    assert [r["phase"] for r in ttr.history] == ["gossip", "global"]
    for jr, tr in zip(jtr.history, ttr.history):
        np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=1e-5)
    for a, b in zip(jax.tree.leaves(jax.device_get(jst.params)),
                    jax.tree.leaves(interop.to_numpy(tst.params))):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * LR)


def test_encoder_microbatch_loss_is_the_mean_of_slice_means():
    """bert-large: the step's loss with 4 microbatches is the mean over
    the 4 slices (rows ``[i·b/4, (i+1)·b/4)`` of each node) of each
    slice's node-mean masked loss — not the full batch's masked mean."""
    _, tt = _configs("bert-large", 4)
    tm = tmake(tt.model)
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    batch = interop.from_numpy(make_stream(
        tt.model, tt.data, n_nodes=N, global_batch=8,
        seq_len=32).get_batch(1), "cpu")
    _, met = tbuild(tm, tt, N, phase="none")(
        _port_state(tm, tt, params), batch, LR)
    stacked = stack_for_nodes(params, N)
    with torch.no_grad():
        slices = [tm.node_losses(stacked, {k: t[:, i:i + 1]
                                           for k, t in batch.items()})[0]
                  for i in range(4)]
        full = tm.node_losses(stacked, batch)[0]
    want = torch.stack([s.mean() for s in slices]).mean()
    np.testing.assert_allclose(float(met["loss"]), float(want), rtol=1e-6)
    assert abs(float(met["loss"]) - float(full.mean())) > 1e-4


@pytest.mark.parametrize("arch", ("pga-lm-100m", "bert-large"))
def test_grad_fn_is_the_mean_of_the_slices_grads(arch):
    """``build_grad_fn`` with 4 microbatches: the fp32 sum of the 4
    slices' one-batch grads, then ``/ 4`` (bitwise on the CPU), the
    metrics the mean of the slices'."""
    _, t1 = _configs(arch, 1)
    _, t4 = _configs(arch, 4)
    tm = tmake(t1.model)
    params = stack_for_nodes(
        tm.init(torch.Generator().manual_seed(0), "cpu"), N)
    batch = interop.from_numpy(Trainer(t1, n_nodes=N, device="cpu")
                               .stream.get_batch(0), "cpu")
    g4, m4 = build_grad_fn(tm, t4)(params, batch)
    one = build_grad_fn(tm, t1)
    b = tree_flatten(batch)[0][0].shape[1] // 4
    mean = [torch.zeros_like(g) for g in tree_flatten(g4)[0]]
    losses = []
    for i in range(4):
        gi, mi = one(params, {k: t[:, i * b:(i + 1) * b]
                              for k, t in batch.items()})
        for a, g in zip(mean, tree_flatten(gi)[0]):
            a.add_(g)
        losses.append(mi["loss"])
    for a, g in zip(mean, tree_flatten(g4)[0]):
        assert torch.equal(a / 4, g)
    np.testing.assert_allclose(float(m4["loss"]),
                               float(torch.stack(losses).mean()), rtol=1e-6)


def test_reference_microbatch_equivalence_in_the_port():
    """The reference's ``test_microbatch_equivalence`` (reduced
    pga-lm-100m, bf16 compute, ring, SGD without clip or decay) run in the
    port: 4 microbatches against 1, at its tolerances."""
    _, t1 = _configs("pga-lm-100m", 1, dtype="bfloat16")
    _, t4 = _configs("pga-lm-100m", 4, dtype="bfloat16")
    tm = tmake(t1.model)
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    batch = interop.from_numpy(Trainer(t1, n_nodes=N, device="cpu")
                               .stream.get_batch(0), "cpu")
    s1, m1 = tbuild(tm, t1, N, phase="gossip")(
        _port_state(tm, t1, params), batch, LR)
    s4, m4 = tbuild(tm, t4, N, phase="gossip")(
        _port_state(tm, t4, params), batch, LR)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-3)
    for a, b in zip(tree_flatten(s1.params)[0], tree_flatten(s4.params)[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)


def test_microbatches_must_divide_the_per_node_batch():
    _, tt = _configs("pga-lm-100m", 3)
    with pytest.raises(ValueError, match="not divisible by microbatches=3"):
        Trainer(tt, n_nodes=N, device="cpu")
    tm = tmake(tt.model)
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    step = tbuild(tm, tt, N, phase="gossip")
    batch = interop.from_numpy(make_stream(
        tt.model, tt.data, n_nodes=N, global_batch=8,
        seq_len=32).get_batch(0), "cpu")
    with pytest.raises(ValueError, match="not divisible"):
        step(_port_state(tm, tt, params), batch, LR)
    with pytest.raises(ValueError, match="microbatches=0"):
        dataclasses.replace(tt, microbatches=0).validate()


# ---------------------------------------------------------------------------
# Remat policies
# ---------------------------------------------------------------------------
def test_remat_policy_config():
    tcfg_mod.DistConfig(remat_policy="dots").validate()
    tcfg_mod.DistConfig(remat="none", remat_policy="dots").validate()
    with pytest.raises(ValueError, match="remat_policy"):
        tcfg_mod.DistConfig(remat_policy="everything").validate()
    with pytest.raises(ValueError, match="remat policy"):
        blocks.apply_stack({}, None, None, remat="offload")


def _grads(tm, params, batch, remat):
    leaves, treedef = tree_flatten(params)
    live = [p.clone().requires_grad_(True) for p in leaves]
    losses, _ = tm.node_losses(tree_unflatten(treedef, live), batch,
                               remat=remat)
    return torch.autograd.grad(losses.sum(), live, allow_unused=True,
                               materialize_grads=True)


@pytest.mark.parametrize("arch", ("pga-lm-100m", "bert-large"))
def test_remat_policies_give_the_same_grads(arch):
    _, tt = _configs(arch, 1)
    tm = tmake(tt.model)
    params = stack_for_nodes(
        tm.init(torch.Generator().manual_seed(0), "cpu"), N)
    batch = interop.from_numpy(make_stream(
        tt.model, tt.data, n_nodes=N, global_batch=4,
        seq_len=16).get_batch(0), "cpu")
    want = _grads(tm, params, batch, "none")
    for remat in ("default", "dots"):
        for a, b in zip(want, _grads(tm, params, batch, remat)):
            assert torch.equal(a, b), remat


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def test_stacked_block_products_are_all_batched():
    """Why ``"dots"`` is the plain checkpoint in the port: the reference's
    policy saves products without batch dimensions (``aten.mm``), and
    every product of the port's node-stacked block is batched over the
    nodes (``aten.bmm``), as the reference's are under its vmap."""
    _, tt = _configs("bert-large", 1)
    tm = tmake(tt.model)
    params = stack_for_nodes(
        tm.init(torch.Generator().manual_seed(0), "cpu"), N)
    batch = interop.from_numpy(make_stream(
        tt.model, tt.data, n_nodes=N, global_batch=4,
        seq_len=16).get_batch(0), "cpu")
    h = tm._embed_batch(params, batch, torch.float32)
    block = blocks._layer(params["stack"]["scan"]["entry_0"], 0)
    with _Ops() as rec:
        blocks.apply_block(block, tm.cfg, ("attn", "dense"), h, mode="train")
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert bmm in rec.ops and mm not in rec.ops


def test_reference_dots_saves_what_default_saves_under_the_node_vmap(
        capsys):
    """The finding the port's ``"dots"`` rests on: in the reference, the
    Trainer's ``jax.vmap`` over nodes gives every projection a batch
    dimension, so ``dots_with_no_batch_dims_saveable`` keeps the same
    residuals as the plain ``jax.checkpoint``."""
    from jax.ad_checkpoint import print_saved_residuals
    from repro.data.synthetic import SyntheticStream

    cfg = jax_config("bert-large", reduced=True)
    jm = jmake(cfg)
    params, _ = jm.init(jax.random.PRNGKey(0))
    sp = jstate.stack_for_nodes(params, N)
    batch = jax.tree.map(jnp.asarray, SyntheticStream(
        cfg, jcfg.DataConfig(), N, 2, 16).get_batch(0))

    def residuals(policy):
        def total(p, b):
            return jnp.sum(jax.vmap(
                lambda pi, bi: jm.loss(pi, bi, remat=policy)[0])(p, b))
        print_saved_residuals(total, sp, batch)
        lines = capsys.readouterr().out.splitlines()
        return sorted(ln.split(" from ")[0] for ln in lines)

    assert residuals("dots") == residuals("default")
