"""Port parity: the ``Trainer`` with SlowMo, Hier-PGA, GT-PGA and
Gossip-AGA, JAX vs ``repro_torch`` on the CPU (the Gossip-AGA and
reference-backend GT-PGA cases and the CLI runs are in
``test_torch_trainer_aga_cli.py``).

Reduced pga-lm-100m at fp32 compute, 4 nodes over the ring, SGD (Nesterov
momentum, constant lr 0.05), global batch 8 × seq 32, from one set of
weights, 4 steps (5 for Gossip-AGA).  The forward and backward sum in
another order, so the tolerances are ``tests/test_torch_train.py``'s SGD
ones: params rtol 1e-5, atol 1e-7, losses and consensus rtol 1e-5, and
the extras (SlowMo's anchor, GT's tracker and last grads) the params';
SlowMo's momentum ``(anchor − x̄)/lr`` carries the anchor's error over
lr, so each leaf's atol is (1e-7 + 1e-5·max|anchor|)/0.05 (measured:
2.4e-6 on the norm weights near 1.0, one fp32 ulp of x̄ over lr; the
params 3.6e-7 absolute at most, losses 1.5e-7 and consensus 3.5e-6
relative).  Phase sequences,
Gossip-AGA's ``schedule.history`` and its counters are equal exactly;
its held losses (``F_init``, ``F_last``) differ like the losses, rtol
1e-5.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.configs import pga_lm_100m as jarch
from repro.train.trainer import Trainer as JTrainer
from repro_torch import interop
from repro_torch.configs import base as tcfg_mod
from repro_torch.configs import pga_lm_100m as tarch
from repro_torch.train import Trainer as TTrainer

torch.set_num_threads(2)

CASES = {
    "slowmo": (dict(H=2, slowmo_beta=0.5, slowmo_lr=0.7), 4,
               ["gossip", "slowmo", "gossip", "slowmo"]),
    "hier_pga": (dict(H=4, hier_h_pod=2, n_pods=2), 4,
                 ["gossip", "pod_avg", "gossip", "global"]),
    "gt_pga": (dict(H=2), 4, ["gossip", "global", "gossip", "global"]),
    "gossip_aga": (dict(aga_h_init=2, aga_warmup=2), 5,
                   ["gossip", "global", "gossip", "global", "gossip"]),
}


def _configs(algorithm, backend):
    dist = dict(algorithm=algorithm, topology="ring", comm_backend=backend,
                **CASES[algorithm][0])
    opt = dict(name="sgd", lr=0.05, schedule="constant", warmup_steps=0)
    common = dict(global_batch=8, seq_len=32, log_every=1)
    jt = jcfg.TrainConfig(
        model=dataclasses.replace(jarch.reduced_config(), dtype="float32"),
        dist=jcfg.DistConfig(**dist), optimizer=jcfg.OptimizerConfig(**opt),
        **common)
    tt = tcfg_mod.TrainConfig(
        model=dataclasses.replace(tarch.reduced_config(), dtype="float32"),
        dist=tcfg_mod.DistConfig(**dist),
        optimizer=tcfg_mod.OptimizerConfig(**opt), **common)
    return jt, tt


def _assert_trees(want, got, **tol):
    wl = jax.tree.leaves(jax.device_get(want))
    gl = jax.tree.leaves(interop.to_numpy(got))
    assert len(wl) == len(gl)
    for a, b in zip(wl, gl):
        np.testing.assert_allclose(b, a, **tol)


def check_trainer_matches_reference(algorithm, backend):
    """Both Trainers from one set of weights: phases, per-step loss and
    consensus, params, extras, and Gossip-AGA's schedule state."""
    n = 4
    _, steps, phases = CASES[algorithm]
    jt, tt = _configs(algorithm, backend)
    jtr = JTrainer(jt, n_nodes=n, with_consensus=True)
    jst = jtr.init_state(jax.random.PRNGKey(0))
    row0 = jax.tree.map(lambda p: np.asarray(p[0]),
                        jax.device_get(jst.params))
    jst = jtr.run(jst, steps=steps, log_every=1)
    ttr = TTrainer(tt, n_nodes=n, with_consensus=True, device="cpu")
    tst = ttr.init_state(params=interop.from_numpy(row0, "cpu"))
    assert sorted(tst.extras) == sorted(jst.extras)
    tst = ttr.run(tst, steps=steps, log_every=1)
    assert [r["phase"] for r in ttr.history] == \
        [r["phase"] for r in jtr.history] == phases
    for jr, tr in zip(jtr.history, ttr.history):
        for key in ("loss", "consensus"):
            np.testing.assert_allclose(tr[key], jr[key], rtol=1e-5)
        if tr["phase"] in ("global", "slowmo"):
            assert tr["consensus"] == 0.0
    tol = dict(rtol=1e-5, atol=1e-7)
    _assert_trees(jst.params, tst.params, **tol)
    for name in sorted(jst.extras):
        if name != "slow_u":
            _assert_trees(jst.extras[name], tst.extras[name], **tol)
    if "slow_u" in jst.extras:
        # SlowMo's momentum is (anchor - x̄)/lr: each leaf carries its
        # anchor's tolerance over lr
        anchors = jax.tree.leaves(jax.device_get(jst.extras["slow_params"]))
        want = jax.tree.leaves(jax.device_get(jst.extras["slow_u"]))
        got = jax.tree.leaves(interop.to_numpy(tst.extras["slow_u"]))
        for s, a, b in zip(anchors, want, got):
            bound = (tol["atol"] + tol["rtol"] * float(np.abs(s).max())) \
                / 0.05
            np.testing.assert_allclose(b, a, rtol=0, atol=bound)
    if algorithm == "gossip_aga":
        assert ttr.schedule.history == jtr.schedule.history
        want, got = jtr.schedule.state_dict(), ttr.schedule.state_dict()
        for key in ("C", "H", "history"):
            assert got[key] == want[key]
        for key in ("F_init", "F_last"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5)


@pytest.mark.parametrize("algorithm,backend", [
    ("slowmo", "pallas"), ("hier_pga", "pallas"), ("gt_pga", "pallas")])
def test_trainer_matches_reference(algorithm, backend):
    check_trainer_matches_reference(algorithm, backend)
