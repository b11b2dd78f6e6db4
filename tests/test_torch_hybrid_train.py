"""Port parity: the Trainer on the hybrid family, JAX vs ``repro_torch``
on the CPU, float32 compute: jamba-1.5-large-398b's reduced widths with
one layer of each of its block kinds, (mamba, dense), (mamba, moe) and
(attn, dense) — the pattern ``chip_smoke.py`` serves at full width.  (At
all eight reduced layers the reference's Trainer compiles for 25-30 s a
step on this CPU.)

Weights are drawn by the JAX package's Trainer and carried across with
``repro_torch.interop``; batches are the synthetic stream's, bitwise the
same in both packages.

Tolerances: two steps of Gossip-PGA (H = 2: a gossip round, then a
global one) on 4 nodes, SGD, fused backend, against the JAX Trainer: the
loss rtol 1e-5, the params rtol 1e-5 with atol 1e-7 (the same math under
autograd and ``jax.grad``, reductions summed in another order), the
consensus after the global round exactly 0.0.
"""
import dataclasses

import jax
import numpy as np
import torch

from repro.configs import base as jcfg
from repro.configs import get_model_config as jax_config
from repro.train.trainer import Trainer as JTrainer
from repro_torch import interop
from repro_torch.configs import base as tcfg
from repro_torch.configs import get_model_config
from repro_torch.train import Trainer as TTrainer

torch.set_num_threads(2)

ARCH = "jamba-1.5-large-398b"
PATTERN = (("mamba", "dense"), ("mamba", "moe"), ("attn", "dense"))


def test_trainer_steps_match_reference():
    n = 4
    dist = dict(algorithm="gossip_pga", topology="one_peer_exp", H=2,
                comm_backend="pallas")
    opt = dict(name="sgd", lr=0.05, schedule="constant", warmup_steps=0)
    common = dict(global_batch=8, seq_len=16, log_every=1)
    jc, tc = (dataclasses.replace(get(ARCH, reduced=True), dtype="float32",
                                  pattern=PATTERN, n_layers=3)
              for get in (jax_config, get_model_config))
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
