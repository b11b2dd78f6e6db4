"""Port parity: the LAMB optimizer (``optim.lamb``, ``make_optimizer(cfg,
per_node=...)``), the Trainer training bert-large (reduced) with it, its
checkpoints, and the launcher's ``--arch bert-large --optimizer lamb``,
JAX vs ``repro_torch`` on the CPU.

Tolerances, with their reasons:
* one LAMB update is elementwise fp32 arithmetic plus two fp32 norms a
  node: rtol 1e-6, and atol 1e-4 · lr · max(1, max|p|) for the bias
  correction ``1 − 0.999^count`` (XLA's fp32 pow and PyTorch's differ by
  an ulp, which the subtraction amplifies, as for AdamW) and the norms'
  other summation order;
* three Trainer steps of Gossip-PGA on the reduced bert-large at fp32
  with LAMB, ``warmup_poly`` and 2 microbatches: the forward and
  backward sum in another order and Adam's ``u`` swings where a gradient
  entry is within ~eps of zero (as ``test_torch_train.py`` states for
  AdamW), and LAMB scales that swing by the leaf's trust ratio.  Params
  rtol 1e-5 with atol 5e-3 · lr (measured: 3.2e-4 · lr), losses rtol
  1e-5 (measured 1.5e-7), the consensus 0.0 exactly after the global
  round;
* a LAMB checkpoint resumed: bitwise the uninterrupted run, and the
  reference restores the port's file bitwise.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore
from repro.configs import base as jcfg
from repro.configs import bert_large as jarch
from repro.optim import optimizers as jopt
from repro.train import Trainer as JTrainer
from repro_torch import interop
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import base as tcfg_mod
from repro_torch.configs import bert_large as tarch
from repro_torch.optim import optimizers as topt
from repro_torch.train import Trainer as TTrainer
from repro_torch.tree import tree_flatten

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
N = 4


def _tree(seed, zero_leaf=False):
    """A node-stacked tree (n = 4) with a layer-stacked leaf (n, L, d, f),
    a per-node vector and, optionally, an all-zero leaf."""
    rng = np.random.default_rng(seed)
    t = {"stack": rng.standard_normal((N, 3, 6, 5)).astype(np.float32),
         "norm": (1.0 + 0.1 * rng.standard_normal((N, 7))).astype(
             np.float32),
         "emb": (0.02 * rng.standard_normal((N, 11, 4))).astype(np.float32)}
    if zero_leaf:
        t["zero"] = np.zeros((N, 3), np.float32)
    return t


@pytest.mark.parametrize("per_node", (True, False))
@pytest.mark.parametrize("weight_decay", (0.0, 0.01))
def test_lamb_updates_match_reference(per_node, weight_decay):
    kw = dict(name="lamb", lr=0.05, weight_decay=weight_decay)
    jo = jopt.make_optimizer(jcfg.OptimizerConfig(**kw), per_node=per_node)
    to = topt.make_optimizer(tcfg_mod.OptimizerConfig(**kw),
                             per_node=per_node)
    params = _tree(0, zero_leaf=True)
    jp = jax.tree.map(jnp.asarray, params)
    tp = interop.from_numpy(params, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for k in range(3):
        grads = _tree(10 + k, zero_leaf=True)
        grads["zero"] = np.zeros_like(grads["zero"])
        jp, js = jo.update(jax.tree.map(jnp.asarray, grads), js, jp, 0.05)
        tp, ts = to.update(interop.from_numpy(grads, "cpu"), ts, tp, 0.05)
        for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
            a = np.asarray(a)
            np.testing.assert_allclose(
                b.numpy(), a, rtol=1e-6,
                atol=1e-4 * 0.05 * max(1.0, float(np.abs(a).max())))
        for a, b in zip(jax.tree.leaves((js["m"], js["v"])),
                        jax.tree.leaves((ts["m"], ts["v"]))):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-12)
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 3
    # the zero leaf: ‖p‖ = 0, so the trust ratio is 1 and p stays 0
    assert float(tp["zero"].abs().max()) == 0.0


def test_lamb_trust_ratio_is_per_node_across_a_layer_stacked_leaf():
    """A leaf stacked over layers ``(n, L, …)`` gets ONE trust ratio per
    node across its layers: scaling layer 0 of node 0 changes node 0's
    update of every layer and leaves node 1's bitwise."""
    cfg = tcfg_mod.OptimizerConfig(name="lamb", lr=0.1, weight_decay=0.0)
    opt = topt.make_optimizer(cfg, per_node=True)
    rng = np.random.default_rng(1)
    base = rng.standard_normal((2, 3, 4)).astype(np.float32)
    grads = {"w": torch.from_numpy(rng.standard_normal((2, 3, 4)).astype(
        np.float32))}
    scaled = base.copy()
    scaled[0, 0] *= 10.0
    out = {}
    for name, arr in (("base", base), ("scaled", scaled)):
        params = {"w": torch.from_numpy(arr)}
        new, _ = opt.update(grads, opt.init(params), params, 0.1)
        out[name] = (params["w"] - new["w"]).numpy()
    np.testing.assert_array_equal(out["base"][1], out["scaled"][1])
    ratio = out["scaled"][0, 1:] / out["base"][0, 1:]
    np.testing.assert_allclose(ratio, ratio.flat[0], rtol=1e-5)
    assert ratio.flat[0] > 1.5


def test_lamb_per_node_trust_ratio_is_per_replica():
    """The reference's own case: with per_node=True, scaling one node's
    params must not change the other node's update, and node 1's step is
    ~100× node 0's; the port's update equals the reference's."""
    cfg = dict(name="lamb", lr=0.1, weight_decay=0.0)
    params = {"w": np.stack([np.ones(4, np.float32),
                             100.0 * np.ones(4, np.float32)])}
    grads = {"w": np.ones((2, 4), np.float32)}
    opt = topt.make_optimizer(tcfg_mod.OptimizerConfig(**cfg), per_node=True)
    tp = interop.from_numpy(params, "cpu")
    new, _ = opt.update(interop.from_numpy(grads, "cpu"), opt.init(tp), tp,
                        0.1)
    delta = params["w"] - new["w"].numpy()
    assert delta[1].mean() / delta[0].mean() > 50
    jo = jopt.make_optimizer(jcfg.OptimizerConfig(**cfg), per_node=True)
    jp = jax.tree.map(jnp.asarray, params)
    jnew, _ = jo.update(jax.tree.map(jnp.asarray, grads), jo.init(jp), jp,
                        0.1)
    np.testing.assert_allclose(new["w"].numpy(), np.asarray(jnew["w"]),
                               rtol=1e-6)


def test_make_optimizer_names():
    for name in ("sgd", "adamw", "lamb"):
        topt.make_optimizer(tcfg_mod.OptimizerConfig(name=name),
                            per_node=True)
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer(tcfg_mod.OptimizerConfig(name="adagrad"))


# ---------------------------------------------------------------------------
# The Trainer on bert-large (reduced) with LAMB
# ---------------------------------------------------------------------------
LR = 2e-3


def _cfgs(ckpt_dir=None, ckpt_every=0, microbatches=2):
    dist = dict(algorithm="gossip_pga", topology="one_peer_exp", H=2,
                comm_backend="pallas")
    opt = dict(name="lamb", lr=LR, schedule="warmup_poly", warmup_steps=2,
               total_steps=10, weight_decay=0.01)
    common = dict(global_batch=8, seq_len=16, log_every=1,
                  microbatches=microbatches, ckpt_every=ckpt_every)
    if ckpt_dir is not None:
        common["ckpt_dir"] = str(ckpt_dir)
    jt = jcfg.TrainConfig(
        model=dataclasses.replace(jarch.reduced_config(), dtype="float32"),
        dist=jcfg.DistConfig(**dist), optimizer=jcfg.OptimizerConfig(**opt),
        **common)
    tt = tcfg_mod.TrainConfig(
        model=dataclasses.replace(tarch.reduced_config(), dtype="float32"),
        dist=tcfg_mod.DistConfig(**dist),
        optimizer=tcfg_mod.OptimizerConfig(**opt), **common)
    return jt, tt


def test_trainer_lamb_microbatches_matches_reference():
    """Three steps (gossip, global, gossip) of both Trainers from the same
    weights: reduced bert-large, LAMB with warmup_poly, 2 microbatches."""
    jt, tt = _cfgs()
    jtr = JTrainer(jt, n_nodes=N, with_consensus=True)
    jst = jtr.init_state(jax.random.PRNGKey(0))
    row0 = jax.tree.map(lambda p: np.asarray(p[0]),
                        jax.device_get(jst.params))
    jst = jtr.run(jst, steps=3, log_every=1)
    ttr = TTrainer(tt, n_nodes=N, with_consensus=True, device="cpu")
    tst = ttr.init_state(params=interop.from_numpy(row0, "cpu"))
    tst = ttr.run(tst, steps=3, log_every=1)
    assert [r["phase"] for r in ttr.history] == ["gossip", "global",
                                                 "gossip"]
    for jr, tr in zip(jtr.history, ttr.history):
        np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=1e-5)
        np.testing.assert_allclose(tr["lr"], jr["lr"], rtol=1e-6)
    assert ttr.history[1]["consensus"] == 0.0
    for a, b in zip(jax.tree.leaves(jax.device_get(jst.params)),
                    jax.tree.leaves(interop.to_numpy(tst.params))):
        np.testing.assert_allclose(b, a, rtol=1e-5,
                                   atol=5e-3 * LR)
    assert int(tst.opt_state["count"]) == 3


def test_lamb_checkpoint_resumes_bitwise(tmp_path):
    """LAMB's m, v and count ride the checkpoint: a resumed run ends
    bitwise where the uninterrupted one does, and the reference restores
    the port's file bit for bit."""
    jt, tt = _cfgs(tmp_path, ckpt_every=2)
    tr = TTrainer(tt, n_nodes=N, device="cpu")
    full = tr.run(tr.init_state(), steps=4)
    tr2 = TTrainer(tt, n_nodes=N, device="cpu")
    state = restore_checkpoint(str(tmp_path), tr2.init_state(), step=2)
    assert state.step == 2 and int(state.opt_state["count"]) == 2
    resumed = tr2.run(state, steps=2)
    for got, want in ((resumed.params, full.params),
                      (resumed.opt_state, full.opt_state)):
        gl, gd = tree_flatten(got)
        wl, wd = tree_flatten(want)
        assert gd == wd
        for g, w in zip(gl, wl):
            assert g.dtype == w.dtype and torch.equal(g, w)
    jstate = jrestore(str(tmp_path), JTrainer(jt, n_nodes=N).init_state(
        jax.random.PRNGKey(0)), step=4)
    for a, b in zip(jax.tree.leaves(jax.device_get(
            (jstate.params, jstate.opt_state))),
            jax.tree.leaves(interop.to_numpy((full.params,
                                              full.opt_state)))):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_cli_bert_large_lamb_runs_on_cpu():
    """``--arch bert-large --optimizer lamb`` through the launcher on the
    CPU: finite losses, consensus exactly 0 after each global round."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train",
         "--arch", "bert-large", "--optimizer", "lamb", "--nodes", "4",
         "--steps", "4", "--global-batch", "8", "--seq-len", "16",
         "--H", "2", "--comm-backend", "pallas", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if "] step" in ln]
    assert len(lines) == 4
    for k, line in enumerate(lines):
        assert np.isfinite(float(line.split("loss=")[1].split()[0]))
        if k % 2 == 1:
            assert "phase=global consensus=0.000e+00" in line
