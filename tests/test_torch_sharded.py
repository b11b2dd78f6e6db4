"""Port parity: the sharded rounds (``communicate_sharded``, the per-shard
kernels ``shard_mix_block`` / ``shard_comp_mix_block``) against the live
JAX package on the CPU.

The port's mesh puts every node shard on one device and runs the shard
bodies one after another; the JAX side runs without a mesh (the stacked
reference), or its Pallas per-shard kernels in interpret mode.  Inputs are
made by numpy from a seed and handed to both.

Tolerances, with their reasons:
* per-shard kernels, plain twin and CPU wrapper vs the Pallas kernel in
  interpret mode: rtol/atol 1e-6 — the same fp32 products, summed over K
  halo rows (and m rows for the column sums) in another order;
* ``_shard_blocks``: bitwise (the same numpy code);
* uncompressed rounds vs the JAX stacked reference: atol 1e-5 fp32 and
  3e-2 with the bf16 wire, the tolerances of the reference's own sharded
  suite (``tests/test_mixing_kernels.py``): the sharded global/pod round
  averages fp32 sums of the wire-cast rows, the stacked reference rounds
  the mean back to bf16;
* the consensus residual: rtol 1e-4, atol 1e-6, as that suite;
* compressed rounds vs the JAX stacked compressed reference: atol 2e-5 on
  the mixed state and the EF state — the codes agree exactly on the same
  inputs, the mix sums in another order;
* the sharded Trainer vs the JAX Trainer without a mesh (reduced
  pga-lm-100m, fp32, SGD, 4 nodes on 2 shards, 4 steps): params rtol
  1e-5, atol 1e-7 and metrics rtol 1e-5, as the stacked trainer's parity
  in ``tests/test_torch_train.py`` (the forward and backward sum in
  another order); consensus exactly 0 after every global step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compress as JC
from repro.core import mixing as jmix
from repro.kernels import mixing_pallas as jmp
from repro_torch import compress as TC
from repro_torch import interop
from repro_torch.core import mixing as tmix
from repro_torch.core.mesh import make_mesh
from repro_torch.kernels import mixing_cuda as tmc

torch.set_num_threads(2)

N = 16
SHAPES = [(5, 3), (7,), ()]
TOPOLOGIES = ("ring", "exp", "one_peer_exp", "grid", "full",
              "disconnected")
# the 8 phase x topology cases of the reference's sharded suite
CASES = ([("gossip", t, 1) for t in ("ring", "exp", "one_peer_exp", "grid",
                                     "disconnected")]
         + [("global", "ring", 1), ("pod_avg", "ring", 2),
            ("pod_avg", "ring", 4)])


def _tree(seed=0, n=N, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return {f"leaf{i}": rng.standard_normal((n,) + s).astype(np.float32)
            for i, s in enumerate(shapes)}


def _jax(tree):
    return None if tree is None else jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return None if tree is None else jax.tree.map(torch.from_numpy, tree)


def _close(jtree, ttree, atol, rtol=0.0):
    jl, tl = jax.tree.leaves(jtree), jax.tree.leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(np.asarray(b, np.float32),
                                   np.asarray(a, np.float32), rtol=rtol,
                                   atol=atol)


def _mesh(k=8, names=("data",)):
    shape = (k,) if len(names) == 1 else k
    return make_mesh(shape, names, device="cpu")


def _specs(topology, n_pods=1, cd=None, *, mesh=None, name="none",
           global_name="none", k_comp=3, node_axis="data",
           shard_mode="auto"):
    """The JAX stacked reference spec and the port's sharded spec."""
    jspec = jmix.CommSpec(
        topology=topology, n_nodes=N, n_pods=n_pods, backend="reference",
        comm_dtype=None if cd is None else jnp.bfloat16,
        compressor=JC.make_compressor(name, k=k_comp),
        global_compressor=JC.make_compressor(global_name)).validate()
    tspec = tmix.CommSpec(
        topology=topology, n_nodes=N, n_pods=n_pods, backend="pallas",
        mesh=_mesh() if mesh is None else mesh, node_axis=node_axis,
        shard_mode=shard_mode,
        comm_dtype=None if cd is None else torch.bfloat16,
        compressor=TC.make_compressor(name, k=k_comp),
        global_compressor=TC.make_compressor(global_name)).validate()
    return jspec, tspec


# ---------------------------------------------------------------------------
# The per-shard kernels: plain twins and CPU wrappers vs Pallas (interpret)
# ---------------------------------------------------------------------------
def _shard_inputs(seed, m, K, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((m, D), (K, D), (m, 1), (m, K), (m, D))]


@pytest.mark.parametrize("m", (1, 2, 4))
@pytest.mark.parametrize("halo", (1, 2, 3))
def test_shard_mix_block_matches_pallas(m, halo):
    """``d⊙x + M·xs`` (+ column sums) at K = m, 2m, 3m halo rows, over a
    ragged D (four 512-column blocks and a tail) and a short one."""
    K = halo * m
    for D, with_residual in ((2100, True), (37, False)):
        x, xs, d, M, _ = _shard_inputs(10 * m + halo, m, K, D)
        want = jmp.shard_mix_block(*_jax([x, xs, d, M]),
                                   with_residual=with_residual, block_d=512,
                                   interpret=True)
        args = _torch([x, xs, d, M])
        plain = tmc.shard_mix_block_plain(*args, with_residual=with_residual)
        before = tmc.shard_mix_block.launches
        got = tmc.shard_mix_block(*args, with_residual=with_residual)
        out = torch.empty(m, D)
        into = tmc.shard_mix_block(*args, with_residual=with_residual,
                                   out=out)
        assert tmc.shard_mix_block.launches == before
        for res in (plain, got, into):
            _close(want, res, atol=1e-6, rtol=1e-6)
        o = into[0] if with_residual else into
        assert o.data_ptr() == out.data_ptr()


@pytest.mark.parametrize("m", (1, 2, 4))
@pytest.mark.parametrize("halo", (1, 3))
def test_shard_comp_mix_block_matches_pallas(m, halo):
    K = halo * m
    for D in ((2100,) if halo == 1 else (37,)):
        x, qs, w, M, q = _shard_inputs(20 * m + halo, m, K, D)
        want = jmp.shard_comp_mix_block(*_jax([x, q, qs, w, M]), block_d=512,
                                        interpret=True)
        args = _torch([x, q, qs, w, M])
        before = tmc.shard_comp_mix_block.launches
        for got in (tmc.shard_comp_mix_block_plain(*args),
                    tmc.shard_comp_mix_block(*args),
                    tmc.shard_comp_mix_block(*args, out=torch.empty(m, D))):
            _close(want, got, atol=1e-6, rtol=1e-6)
        assert tmc.shard_comp_mix_block.launches == before


def test_shard_wrappers_refuse_an_output_over_an_input():
    """A shard's output is a fresh buffer: writing over the round's input
    rows would feed a later shard's halo mixed rows."""
    x, xs, d, M, q = _torch(_shard_inputs(0, 2, 4, 50))
    with pytest.raises(ValueError, match="fresh output"):
        tmc.shard_mix_block(x, xs, d, M, out=x)
    with pytest.raises(ValueError, match="fresh output"):
        tmc.shard_comp_mix_block(x, q, xs, d, M, out=q)
    with pytest.raises(ValueError, match="M .m, K."):
        tmc.shard_mix_block(x, xs, d, M[:, :3])
    with pytest.raises(ValueError, match="float32"):
        tmc.shard_mix_block(x.double(), xs, d, M)


def test_flatten_nodes_sharded_is_flatten_nodes_at_one_model_shard():
    """The sharded rounds pack with ``flatten_nodes``: the reference's
    ``flatten_nodes_sharded`` at one model shard, byte for byte."""
    t = _torch(_tree(1))
    a, ua = tmc.flatten_nodes(t)
    ja, _ = jmp.flatten_nodes_sharded(_jax(_tree(1)), 1)
    np.testing.assert_array_equal(np.asarray(ja), a.numpy())
    for g, w in zip(jax.tree.leaves(ua(a)), jax.tree.leaves(t)):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# Block decomposition: bitwise
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", (2, 4, 8))
@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_shard_blocks_bitwise(topology, k):
    for step in range(4):
        d, M = jmp.phase_matrices("gossip", topology, N, step=step)
        want = jmix._shard_blocks(M, d, N, k)
        got = tmix._shard_blocks(M, d, N, k)
        assert got[0] == want[0]
        for a, b in zip(got[1:], want[1:]):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", (2, 4, 8))
@pytest.mark.parametrize("n_pods", (1, 2, 4))
def test_shard_blocks_bitwise_averaging(k, n_pods):
    for phase in ("global", "pod_avg"):
        d, M = jmp.phase_matrices(phase, "ring", N, n_pods=n_pods)
        want = jmix._shard_blocks(M, d, N, k)
        got = tmix._shard_blocks(M, d, N, k)
        assert got[0] == want[0]
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a, b)


def test_shard_blocks_of_one_peer_exp_at_four_shards():
    """n = 8, k = 4 (m = 2), the main path's rounds: hop 1 gathers the
    shard itself and its right neighbour, hops 2 and 4 one neighbour."""
    for step, offsets, K in ((0, [0, 1], 4), (1, [1], 2), (2, [2], 2)):
        d, M = tmc.phase_matrices("gossip", "one_peer_exp", 8, step=step)
        got = tmix._shard_blocks(M, d, 8, 4)
        assert got[0] == offsets and got[1].shape == (4, 2, K)
    d, M = tmc.phase_matrices("gossip", "disconnected", 8)
    offsets, Mstack, _ = tmix._shard_blocks(M, d, 8, 4)
    assert offsets == [0] and not Mstack.any()


# ---------------------------------------------------------------------------
# Uncompressed sharded rounds vs the JAX stacked reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cd", (None, "bfloat16"), ids=("fp32", "bf16"))
@pytest.mark.parametrize("phase,topology,n_pods", CASES)
def test_sharded_communicate_matches_reference(phase, topology, n_pods, cd):
    """k = 8 shards of m = 2 nodes, n = 16, step 3."""
    x = _tree(0)
    jspec, tspec = _specs(topology, n_pods, cd)
    want = jmix.communicate(_jax(x), jspec, phase=phase, step=3)
    before = tmc.shard_mix_block.launches, tmc.mix_flat.launches
    got = tmix.communicate(_torch(x), tspec, phase=phase, step=3)
    assert (tmc.shard_mix_block.launches, tmc.mix_flat.launches) == before
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(_torch(x))):
        assert g.dtype == w.dtype and g.shape == w.shape
    _close(want, got, atol=1e-5 if cd is None else 3e-2)


def test_sharded_round_reads_only_the_rounds_input():
    """one_peer_exp hop 1 at k = 4: shard 3 reads shard 0's rows, which an
    in-place shard 0 would already have overwritten.  The mixed state is
    W·x exactly as the stacked plain round gives it, and the input is
    untouched."""
    x = _torch(_tree(2, n=8, shapes=[(11,)]))
    before = {k: v.clone() for k, v in x.items()}
    spec = tmix.CommSpec(topology="one_peer_exp", n_nodes=8, backend="pallas",
                         mesh=_mesh(4)).validate()
    got = tmix.communicate(x, spec, phase="gossip", step=0)
    want = tmix.communicate(x, spec.replace(mesh=None), phase="gossip",
                            step=0)
    assert torch.equal(got["leaf0"], want["leaf0"])
    assert torch.equal(x["leaf0"], before["leaf0"])
    W = tmc.phase_matrices("gossip", "one_peer_exp", 8)[1] + np.diag(
        tmc.phase_matrices("gossip", "one_peer_exp", 8)[0][:, 0])
    np.testing.assert_allclose(got["leaf0"].numpy(),
                               W @ before["leaf0"].numpy(), rtol=1e-6)


@pytest.mark.parametrize("phase,topology", (("gossip", "ring"),
                                            ("gossip", "one_peer_exp"),
                                            ("pod_avg", "ring"),
                                            ("global", "ring")))
def test_sharded_residual_matches_reference(phase, topology):
    """``with_residual``: x̄ from the fixed-order sum of the per-shard column
    sums and Σ‖x_i − x̄‖² from the second pass, against the JAX stacked
    round's mean and direct residual; exactly 0 after a global round."""
    x = _tree(3)
    jspec, tspec = _specs(topology, 2)
    want = jmix.communicate(_jax(x), jspec, phase=phase, step=1)
    mixed, xbar, resid = tmix.communicate_sharded(
        _torch(x), tspec, phase=phase, step=1, with_residual=True)
    _close(want, mixed, atol=1e-5)
    _close(jax.tree.map(lambda p: jnp.mean(p, 0), want), xbar, atol=1e-5)
    want_r = sum(float(jnp.sum((p - jnp.mean(p, 0, keepdims=True)) ** 2))
                 for p in jax.tree.leaves(want))
    if phase == "global":
        assert float(resid) == 0.0
        for leaf in jax.tree.leaves(mixed):
            assert torch.equal(leaf, leaf[:1].expand_as(leaf))
    else:
        np.testing.assert_allclose(float(resid), want_r, rtol=1e-4,
                                   atol=1e-6)


def test_sharded_half_step_matches_reference():
    x, g = _tree(4), _tree(5)
    jspec, tspec = _specs("ring")
    got = tmix.communicate_sharded(_torch(x), tspec, phase="gossip",
                                   grads=_torch(g), gamma=0.37)
    want = jmix.communicate(
        jax.tree.map(lambda p, q: p - 0.37 * q, _jax(x), _jax(g)), jspec,
        phase="gossip", step=0)
    _close(want, got, atol=1e-5)
    with pytest.raises(ValueError, match="without gamma"):
        tmix.communicate_sharded(_torch(x), tspec, phase="gossip",
                                 grads=_torch(g))


def test_pod_data_mesh_flattens_into_one_node_axis():
    """``("pod", "data")`` with node_axis="data": 2 × 4 = 8 shards in
    row-major order; node_axis="pod" gossips over the 2 pod shards."""
    x = _tree(6)
    mesh = make_mesh((2, 4), ("pod", "data"), device="cpu")
    assert tmix.node_axis_names(mesh, "data") == ("pod", "data")
    assert tmix.node_shard_count(mesh, "data") == 8
    assert tmix.node_shard_count(mesh, "pod") == 2
    for node_axis in ("data", "pod"):
        jspec, tspec = _specs("exp", mesh=mesh, node_axis=node_axis)
        want = jmix.communicate(_jax(x), jspec, phase="gossip", step=0)
        got = tmix.communicate(_torch(x), tspec, phase="gossip", step=0)
        _close(want, got, atol=1e-5)


def test_stacked_override_and_reference_backend_ignore_the_mesh():
    x = _torch(_tree(7))
    _, tspec = _specs("ring", shard_mode="stacked")
    assert not tspec.uses_sharded()
    got = tmix.communicate(x, tspec, phase="gossip", step=0)
    want = tmix.communicate(x, tspec.replace(mesh=None), phase="gossip",
                            step=0)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert torch.equal(g, w)
    assert not tspec.replace(backend="reference",
                             shard_mode="auto").uses_sharded()


@pytest.mark.parametrize("phase,topology", (("gossip", "ring"),
                                            ("gossip", "exp"),
                                            ("pod_avg", "ring"),
                                            ("global", "ring")))
def test_constant_state_is_a_fixed_point(phase, topology):
    c = jax.tree.map(lambda p: torch.full(p.shape, 1.5), _tree(0))
    _, tspec = _specs(topology, 2)
    got = tmix.communicate(c, tspec, phase=phase, step=1)
    _close(c, got, atol=1e-6)


# ---------------------------------------------------------------------------
# Compressed sharded rounds vs the JAX stacked compressed reference
# ---------------------------------------------------------------------------
def _ctree(seed=0):
    rng = np.random.default_rng(seed)
    # ragged widths; "c" spans three 1024-column collective blocks
    return {"b": rng.standard_normal((N, 3, 5)).astype(np.float32),
            "a": {"w": rng.standard_normal((N, 37)).astype(np.float32)},
            "c": rng.standard_normal((N, 2100)).astype(np.float32)}


def _cef(seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (0.01 * rng.standard_normal(a.shape)).astype(np.float32),
        _ctree())


@pytest.mark.parametrize("with_ef", (False, True), ids=("noef", "ef"))
@pytest.mark.parametrize("name", ("int8", "fp8", "topk", "randk"))
def test_sharded_compressed_gossip_matches_reference(name, with_ef):
    """Every gossip hop of one_peer_exp (self + neighbour, neighbour only),
    ring, and the compensated global and pod rounds of the gossip codec;
    the EF state too."""
    x, ef = _ctree(4), (_cef() if with_ef else None)
    for phase, topology, step in (("gossip", "one_peer_exp", 0),
                                  ("gossip", "one_peer_exp", 1),
                                  ("gossip", "ring", 0),
                                  ("global", "ring", 0),
                                  ("pod_avg", "ring", 0)):
        jspec, tspec = _specs(topology, 2, name=name)
        jout = jmix.communicate(_jax(x), jspec, phase=phase, step=step,
                                ef_state=_jax(ef), seed=5 + step)
        before = tmc.shard_comp_mix_block.launches, tmc.cmix_flat.launches
        tout = tmix.communicate(_torch(x), tspec, phase=phase, step=step,
                                ef_state=_torch(ef), seed=5 + step)
        assert (tmc.shard_comp_mix_block.launches,
                tmc.cmix_flat.launches) == before
        _close(jout[0], tout[0], atol=2e-5)
        if with_ef:
            _close(jout[1], tout[1], atol=2e-5)
        else:
            assert tout[1] is None


@pytest.mark.parametrize("with_ef", (False, True), ids=("noef", "ef"))
@pytest.mark.parametrize("global_name", ("int8", "fp8"))
def test_sharded_collective_matches_reference(global_name, with_ef):
    """The compressed collective (stage-1 segments per owner, stage 2 at
    the owner's absolute columns) on global and pod_avg rounds."""
    x, ef = _ctree(5), (_cef(2) if with_ef else None)
    jspec, tspec = _specs("one_peer_exp", 2, global_name=global_name)
    for phase in ("global", "pod_avg"):
        jout = jmix.communicate(_jax(x), jspec, phase=phase, step=0,
                                ef_state=_jax(ef), seed=9)
        tout = tmix.communicate(_torch(x), tspec, phase=phase, step=0,
                                ef_state=_torch(ef), seed=9)
        _close(jout[0], tout[0], atol=2e-5)
        if with_ef:
            _close(jout[1], tout[1], atol=2e-5)


def test_sharded_identity_codecs_are_the_exact_path_bit_for_bit():
    x = _torch(_ctree(6))
    _, plain = _specs("one_peer_exp", 2)
    _, ident = _specs("one_peer_exp", 2, name="identity",
                      global_name="identity")
    for phase in ("gossip", "global", "pod_avg"):
        want = tmix.communicate(x, plain, phase=phase, step=1)
        got, ef = tmix.communicate(x, ident, phase=phase, step=1)
        assert ef is None
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# The sharded Trainer vs the JAX Trainer without a mesh
# ---------------------------------------------------------------------------
def test_sharded_trainer_matches_reference():
    """Reduced pga-lm-100m at fp32, 4 nodes on a 2-shard mesh, Gossip-PGA
    H = 2 over one_peer_exp with the fused consensus residual, SGD, 4 steps
    (gossip, global, gossip, global): the port's sharded Trainer on the CPU
    against the JAX Trainer without a mesh, from the same weights."""
    from repro.configs import base as jcfg
    from repro.configs import pga_lm_100m as jarch
    from repro.train.trainer import Trainer as JTrainer
    from repro_torch.configs import base as tcfg
    from repro_torch.configs import pga_lm_100m as tarch
    from repro_torch.train import Trainer as TTrainer

    n = 4
    dist = dict(algorithm="gossip_pga", topology="one_peer_exp", H=2,
                comm_backend="pallas")
    opt = dict(name="sgd", lr=0.05, schedule="constant", warmup_steps=0)
    common = dict(global_batch=8, seq_len=32, log_every=1)
    jt = jcfg.TrainConfig(
        model=dataclasses.replace(jarch.reduced_config(), dtype="float32"),
        dist=jcfg.DistConfig(**dist), optimizer=jcfg.OptimizerConfig(**opt),
        **common)
    tt = tcfg.TrainConfig(
        model=dataclasses.replace(tarch.reduced_config(), dtype="float32"),
        dist=tcfg.DistConfig(comm_shard_mode="sharded", **dist),
        optimizer=tcfg.OptimizerConfig(**opt), **common)
    jtr = JTrainer(jt, n_nodes=n, with_consensus=True)
    jst = jtr.init_state(jax.random.PRNGKey(0))
    row0 = jax.tree.map(lambda p: np.asarray(p[0]),
                        jax.device_get(jst.params))
    jst = jtr.run(jst, steps=4, log_every=1)
    ttr = TTrainer(tt, n_nodes=n, mesh=_mesh(2), with_consensus=True,
                   device="cpu")
    tst = ttr.init_state(params=interop.from_numpy(row0, "cpu"))
    before = tmc.mix_flat.launches
    tst = ttr.run(tst, steps=4, log_every=1)
    assert tmc.mix_flat.launches == before
    assert [r["phase"] for r in ttr.history] == ["gossip", "global",
                                                 "gossip", "global"]
    for jr, tr in zip(jtr.history, ttr.history):
        np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=1e-5)
        if tr["phase"] == "global":
            assert tr["consensus"] == 0.0
        else:
            np.testing.assert_allclose(tr["consensus"], jr["consensus"],
                                       rtol=1e-5)
    _close(jax.device_get(jst.params), interop.to_numpy(tst.params),
           atol=1e-7, rtol=1e-5)


# ---------------------------------------------------------------------------
# Errors
# ---------------------------------------------------------------------------
def test_sharded_mode_without_a_mesh_raises_value_error():
    from repro_torch.configs import (DistConfig, OptimizerConfig,
                                     TrainConfig, get_model_config)
    from repro_torch.train.step import build_train_step

    _, tspec = _specs("ring", shard_mode="sharded")
    with pytest.raises(ValueError, match="requires a mesh"):
        tspec.replace(mesh=None).uses_sharded()
    with pytest.raises(ValueError, match="requires a mesh"):
        tmix.communicate(_torch(_tree(0)), tspec.replace(mesh=None),
                         phase="gossip")
    with pytest.raises(ValueError, match="requires a mesh"):
        tspec.replace(mesh=make_mesh((1,), ("data",),
                                     device="cpu")).uses_sharded()
    with pytest.raises(ValueError, match="a mesh is required"):
        tmix.communicate_sharded(_torch(_tree(0)), tspec.replace(mesh=None),
                                 phase="gossip")
    tcfg = TrainConfig(model=get_model_config("pga-lm-100m", reduced=True),
                       dist=DistConfig(comm_backend="pallas",
                                       comm_shard_mode="sharded"),
                       optimizer=OptimizerConfig(name="adamw"),
                       global_batch=8, seq_len=16)
    from repro_torch.models.model import make_model
    with pytest.raises(ValueError, match="requires a mesh"):
        build_train_step(make_model(tcfg.model), tcfg, 4, phase="gossip")


def test_two_d_and_multi_device_meshes_raise_not_ported():
    """A one-process mesh over several cards raises (ROADMAP A.10); the
    2-D ``(data, model)`` and ``(pod, data, model)`` meshes build (A.10.2,
    ``tests/test_torch_mixing_2d.py`` runs their rounds)."""
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    assert mesh.shape == {"data": 2, "model": 4} and not mesh.distributed
    assert tmix.node_shard_count(mesh) == 2
    assert tmix.model_shard_count(mesh) == 4
    with pytest.raises(NotImplementedError, match="ROADMAP A.10"):
        make_mesh((2,), ("data",), devices=["cuda:0", "cuda:1"])
    with pytest.raises(NotImplementedError, match="ROADMAP A.10"):
        make_mesh((2,), ("data",), devices=["cpu", "cuda:0"])
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    assert tmix.node_shard_count(mesh) == 4
    assert tmix.model_shard_count(mesh) == 2
    make_mesh((4, 1), ("data", "model"), device="cpu")   # one model shard
    assert make_mesh((4,), ("data",), devices=["cpu"] * 4).device == \
        torch.device("cpu")


def test_mesh_shape_and_devices():
    mesh = make_mesh((2, 4), ("pod", "data"), device="cpu")
    assert mesh.shape == {"pod": 2, "data": 4} and mesh.size == 8
    assert mesh.devices == (torch.device("cpu"),) * 8
    with pytest.raises(ValueError):
        make_mesh((2, 4), ("data",), device="cpu")
    with pytest.raises(ValueError):
        make_mesh((3,), ("data",), devices=["cpu"] * 2)
    x = _torch(_tree(0))
    _, spec = _specs("ring", mesh=_mesh(3))
    with pytest.raises(ValueError, match="not divisible"):
        tmix.communicate(x, spec, phase="gossip")


def test_sharded_cli_flag_raises_without_a_mesh():
    """The launcher builds no mesh (as the reference's), so
    ``--comm-shard-mode sharded`` raises there; stacked runs."""
    from repro_torch.launch.train import main
    argv = ["--arch", "pga-lm-100m", "--nodes", "4", "--steps", "1",
            "--global-batch", "8", "--seq-len", "16", "--comm-backend",
            "pallas", "--device", "cpu", "--comm-shard-mode"]
    with pytest.raises(ValueError, match="requires a mesh"):
        main(argv + ["sharded"])
    main(argv + ["stacked"])
