"""Port parity: 2-D ``(node, model)`` meshes (the sharded rounds with the
packed columns also sliced over a model axis) against the live JAX
package on the CPU.

The reference's own 2-D suite (``tests/test_mixing_2d.py``) runs its
shard_map rounds on 8 forced host devices; under the installed JAX its
eager ``unflatten`` of a ``(data, model)``-sharded array fails, so the
port is held to what that suite itself compares with: the JAX **stacked**
round, and the JAX pieces that run on one device
(``flatten_nodes_sharded``, ``model_axis_names``, the sharding rules,
``round_wire_bytes``).

Tolerances, with their reasons:
* axis resolution, ``DistConfig`` validation, the sharding rules and the
  wire-bytes model: equal (the same arithmetic on integers and names);
  ``flatten_nodes_sharded`` and its ``unflatten``: bitwise;
* the 2-D rounds against the port's 1-D sharded round on the same node
  shards: **bitwise** for every round that is column-local (uncompressed
  gossip, global and pod_avg with the fp32 and bf16 wires, the half-step,
  identity codecs, int8/fp8 gossip — a leaf is padded to the model grid
  before it is compressed, so its per-row scales and the column hash's
  draws on real columns are the 1-D round's —, top-k and rand-k, which
  ride whole, push-sum and the overlapped apply); the consensus residual,
  a sum over blocks folded over the shards per chunk and then over the
  chunks, within rtol 1e-6;
* the compressed collective against the 1-D one: within one quantization
  step per compressed round (the argument of the reference's resume
  test): ``x + (r − ρ)`` moves by at most one stage-2 step of r and one of
  ρ, each at most the block's power-of-two scale ``2^(⌈log2 max|y|⌉ −
  7)`` (int8; − 8 for fp8), so 2·2^(⌈log2 max|y|⌉ − 7) over the whole
  operand; its EF ``y − q₁`` by one stage-1 step, 2^(⌈log2 max|y|⌉ − 7).
  Every stage is per column or per block at absolute columns, so these
  inputs give the 1-D bits, which is checked too;
* against the JAX stacked round: ``tests/test_torch_sharded.py``'s
  tolerances (atol 1e-5 fp32, 3e-2 with the bf16 wire, the residual rtol
  1e-4 atol 1e-6, compressed rounds and their EF atol 2e-5);
* the one-process 2-D Trainer: its params and losses bitwise the 1-D
  one-process Trainer's (the forward and the rounds are the same bits);
  against the JAX Trainer without a mesh at ``test_torch_sharded.py``'s
  tolerances (params rtol 1e-5 atol 1e-7, the loss rtol 1e-5); a
  checkpoint written on ``(data=2, model=4)`` resumed on ``(data=2,
  model=2)``: bitwise the uninterrupted run's iterates (the reference's
  own test allows 5e-3 and 5% of elements past 1e-5: its resharded run
  compiles a new program; here every column's arithmetic is the same).
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
from repro_torch.core import mixing as tmix
from repro_torch.core.mesh import make_mesh
from repro_torch.kernels import mixing_cuda as tmc

torch.set_num_threads(2)

N = 8
SHAPES = [(5, 3), (7,), (), (2100,)]
# (tag, 2-D mesh, the 1-D mesh of the same node shards)
MESHES = {"d2m4": ((2, 4), ("data", "model"), (2,), ("data",)),
          "p2d2m2": ((2, 2, 2), ("pod", "data", "model"), (2, 2),
                     ("pod", "data"))}
PHASES = [("gossip", "ring", 1), ("gossip", "one_peer_exp", 1),
          ("gossip", "grid", 1), ("gossip", "exp", 1),
          ("global", "ring", 1), ("pod_avg", "ring", 2),
          ("pod_avg", "ring", 4)]
# codecs: (gossip codec, global codec)
CODECS = [("none", "none"), ("identity", "identity"), ("int8", "none"),
          ("fp8", "none"), ("none", "int8"), ("none", "fp8"),
          ("topk", "none"), ("randk", "none")]


def _tree(seed=0, n=N, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return {f"leaf{i}": rng.standard_normal((n,) + s).astype(np.float32)
            for i, s in enumerate(shapes)}


def _ef(seed=1):
    rng = np.random.default_rng(seed)
    return {k: (0.01 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in _tree(seed + 50).items()}


def _jax(tree):
    return None if tree is None else jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return None if tree is None else jax.tree.map(torch.from_numpy, tree)


def _meshes(tag):
    s2, n2, s1, n1 = MESHES[tag]
    return (make_mesh(s2, n2, device="cpu"), make_mesh(s1, n1, device="cpu"))


def _tspec(mesh, topology, n_pods=1, cd=None, name="none",
           global_name="none"):
    return tmix.CommSpec(
        topology=topology, n_nodes=N, n_pods=n_pods, backend="pallas",
        mesh=mesh, shard_mode="sharded",
        comm_dtype=None if cd is None else torch.bfloat16,
        compressor=TC.make_compressor(name, k=3),
        global_compressor=TC.make_compressor(global_name)).validate()


def _jspec(topology, n_pods=1, cd=None, name="none", global_name="none"):
    return jmix.CommSpec(
        topology=topology, n_nodes=N, n_pods=n_pods, backend="reference",
        comm_dtype=None if cd is None else jnp.bfloat16,
        compressor=JC.make_compressor(name, k=3),
        global_compressor=JC.make_compressor(global_name)).validate()


def _leaves(tree):
    return [t for t in jax.tree.leaves(tree) if t is not None]


def _bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _close(jtree, ttree, atol, rtol=0.0):
    jl, tl = _leaves(jtree), _leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(np.asarray(b, np.float32),
                                   np.asarray(a, np.float32), rtol=rtol,
                                   atol=atol)


# ---------------------------------------------------------------------------
# Axis resolution and DistConfig
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tag", list(MESHES))
def test_model_axis_resolution_matches_reference(tag):
    """``model_axis_names``/``model_shard_count``/``node_shard_count`` of
    the port against the reference's functions on the same mesh (they
    read only its axis names and sizes)."""
    mesh, mesh1 = _meshes(tag)
    for m in (mesh, mesh1):
        for node_axis in ("data", "pod"):
            names = jmix.node_axis_names(m, node_axis)
            assert tmix.node_axis_names(m, node_axis) == names
            assert tmix.node_shard_count(m, node_axis) == \
                jmix.node_shard_count(m, node_axis)
            for model_axis in ("model", "tp", "data", "pod", ""):
                assert tmix.model_axis_names(
                    m, model_axis, node_names=names) == \
                    jmix.model_axis_names(m, model_axis, node_names=names)
                assert tmix.model_shard_count(m, model_axis, node_axis) == \
                    jmix.model_shard_count(m, model_axis, node_axis)
    assert tmix.model_shard_count(None) == jmix.model_shard_count(None) == 1
    assert tmix.model_shard_count(mesh) == MESHES[tag][0][-1]


def test_distconfig_validates_the_mesh_axes_as_the_reference():
    from repro.configs import DistConfig as JDist
    from repro_torch.configs import DistConfig as TDist
    for f in ("data_axis", "model_axis", "pod_axis"):
        assert getattr(TDist(), f) == getattr(JDist(), f)
    TDist().validate()
    assert TDist().comm_spec(4).model_axis == "model"
    assert TDist(model_axis="tp").comm_spec(4).model_axis == "tp"
    for kw in (dict(model_axis=""), dict(model_axis="data"),
               dict(model_axis="pod"), dict(model_axis="x", data_axis="x"),
               dict(model_axis="d", pod_axis="d")):
        with pytest.raises(ValueError) as want:
            JDist(**kw).validate()
        with pytest.raises(ValueError, match="model_axis") as got:
            TDist(**kw).validate()
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# The packed layout: flatten_nodes_sharded
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("km", (1, 2, 3, 4))
def test_flatten_nodes_sharded_bitwise_the_reference(km):
    """Ragged leaves (15, 7, 1 and 2100 columns and a bf16 leaf): the
    packed matrix bitwise JAX's, ``unflatten`` back to every leaf's dtype,
    shape and bits, and ``drop_node`` on one row."""
    t = _tree(3)
    t["bf"] = t["leaf1"].astype(np.float32)[:, :5]
    tt = _torch(t)
    tt["bf"] = tt["bf"].to(torch.bfloat16)
    jt = _jax(t)
    jt["bf"] = jt["bf"].astype(jnp.bfloat16)
    jf, junf = jmp.flatten_nodes_sharded(jt, km)
    tf, tunf = tmc.flatten_nodes_sharded(tt, km)
    assert tf.dtype == torch.float32 and tf.shape[1] % km == 0
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    back = tunf(tf)
    for k in tt:
        assert back[k].dtype == tt[k].dtype and torch.equal(back[k], tt[k])
    row = tunf(tf[:1], drop_node=True)
    want_row = junf(jf[:1], drop_node=True)
    for k in tt:
        np.testing.assert_array_equal(row[k].float().numpy(),
                                      np.asarray(want_row[k], np.float32))
    lay = tmc.ModelChunks(tt, km)
    for j in range(km):
        c = lay.chunk(tt, j)
        assert c.is_contiguous()
        assert torch.equal(c, tf[:, j * lay.W:(j + 1) * lay.W])


# ---------------------------------------------------------------------------
# The sharding rules and the wire-bytes model
# ---------------------------------------------------------------------------
LOGICAL = [("node", "layers", "embed", "ffn"), ("node", "vocab", "embed"),
           ("batch", "kv_seq", "kv_heads", None), ("node", "heads", None),
           ("per_node_batch", "expert", "ffn"), ("embed", "embed"),
           ("layers", "kv_heads"), ("vocab",), (), ("batch", "batch")]
LOGICAL_SHAPES = [(8, 4, 16, 32), (8, 30, 16), (4, 64, 3, 5), (6, 8, 2),
                  (4, 6, 16), (16, 16), (12, 4), (30,), (), (4, 4)]
MODES = ("train_data", "train_pod", "serve_tp", "serve_2d",
         "serve_tp_seq", "serve_cp")


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("mode", MODES)
def test_logical_to_spec_matches_reference(tag, mode):
    """Every mode of ``_rules`` on ``(data, model)`` and ``(pod, data,
    model)``, with and without shapes (divisible and not), and
    ``specs_for``/``shardings_for`` over a tree of axes; specs compared
    as tuples (both normalize a one-name tuple to the name)."""
    from repro.models import sharding as jsh
    from repro_torch.models import sharding as tsh
    mesh = _meshes(tag)[0]
    assert tsh._rules(mode, mesh) == jsh._rules(mode, mesh)
    for axes, shape in zip(LOGICAL, LOGICAL_SHAPES):
        for shp in (None, shape):
            assert tuple(tsh.logical_to_spec(axes, mode, mesh, shp)) == \
                tuple(jsh.logical_to_spec(axes, mode, mesh, shp))
    tree = {"a": LOGICAL[0], "b": [LOGICAL[1], LOGICAL[2]],
            "c": {"d": LOGICAL[4]}}
    want = jsh.specs_for(tree, mode, mesh)
    got = tsh.specs_for(tree, mode, mesh)
    assert jax.tree.map(tuple, want, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec)) == jax.tree.map(
            tuple, got, is_leaf=lambda x: isinstance(x, tuple))
    sh = tsh.shardings_for(tree, mode, mesh)
    assert sh["a"].mesh is mesh and sh["a"].spec == got["a"]
    x = torch.ones(3)
    assert tsh.constrain(x, got["a"]) is x
    with pytest.raises(ValueError, match="unknown sharding mode"):
        tsh._rules("train_fsdp", mesh)


def test_wire_column_spec_matches_reference():
    from repro.models.sharding import wire_column_spec as jw
    from repro_torch.models.sharding import wire_column_spec as tw
    for names in (("data",), ("pod", "data")):
        for mn in ((), ("model",)):
            for km in (1, 2, 4):
                for shape in ((8, 64), (8, 1), (8, 2), (1, 12), (8,), (),
                              (8, 3, 8), (4, 64), (8, 6)):
                    assert tuple(tw(shape, 8, names, mn, km)) == \
                        tuple(jw(shape, 8, names, mn, km)), (shape, names,
                                                             mn, km)


@pytest.mark.parametrize("phase", ("gossip", "global", "pod_avg"))
def test_round_wire_bytes_model_shards_matches_reference(phase):
    """Every topology and codec, the bf16 wire, divisible and ragged leaf
    sizes, at 1, 2, 3 and 4 model shards."""
    from repro.compress import round_wire_bytes as jrwb
    from repro_torch.compress import round_wire_bytes as trwb
    from repro_torch.configs.base import TOPOLOGIES
    for topology in TOPOLOGIES:
        for comp in ("none", "identity", "int8", "fp8", "topk", "randk"):
            for gcomp in ("none", "identity", "int8", "fp8"):
                for cd in ("float32", "bfloat16"):
                    for sizes in ([2048, 256], [2100, 37, 15, 1]):
                        for ms in (1, 2, 3, 4):
                            kw = dict(comm_dtype=cd, compression=comp,
                                      k=16, step=1, n_pods=2,
                                      leaf_sizes=sizes,
                                      global_compression=gcomp,
                                      model_shards=ms)
                            assert trwb(phase, topology, 8, sum(sizes),
                                        **kw) == jrwb(phase, topology, 8,
                                                      sum(sizes), **kw)


def test_round_meter_reports_model_shards():
    """The ``comm_round`` record of a 2-D round: ``model_shards`` k_model
    and analytic == measured bytes per device, 1/k_model of the 1-D
    round's for divisible leaves."""
    from repro_torch import obs
    mesh, mesh1 = _meshes("d2m4")
    x = _torch(_tree(0, shapes=[(64,), (8, 4)]))
    recs = {}
    for tag, m in (("2d", mesh), ("1d", mesh1)):
        tel = obs.Telemetry(sinks=[obs.RingSink()])
        with obs.telemetry_scope(tel):
            tmix.communicate(x, _tspec(m, "ring"), phase="gossip")
            tmix.communicate(x, _tspec(m, "ring", name="int8"),
                             phase="gossip", seed=1)
        recs[tag] = tel.ring().records("comm_round")
    for r2, r1 in zip(recs["2d"], recs["1d"]):
        assert r2["model_shards"] == 4 and r1["model_shards"] == 1
        assert r2["analytic_bytes"] == r2["measured_bytes"] or \
            r2["compression"] != "none"
    assert recs["2d"][0]["measured_bytes"] * 4 == \
        recs["1d"][0]["measured_bytes"]


# ---------------------------------------------------------------------------
# The one-process 2-D rounds
# ---------------------------------------------------------------------------
def _round(mesh, phase, topology, pods, codec, cd=None, ef=None, seed=7):
    name, gname = codec
    spec = _tspec(mesh, topology, pods, cd, name, gname)
    out = tmix.communicate(_torch(_tree(0)), spec, phase=phase, step=3,
                           ef_state=_torch(ef), seed=seed)
    return out if isinstance(out, tuple) else (out, None)


def _collective_bounds(codec, ef):
    """One quantization step per compressed round (module docstring):
    the mixed state's and the EF state's bounds."""
    kind = codec[1]
    y = np.concatenate([v.reshape(N, -1) for v in _tree(0).values()], 1)
    if ef is not None:
        y = y + np.concatenate([v.reshape(N, -1) for v in ef.values()], 1)
    shift = 7 if kind == "int8" else 8
    step = 2.0 ** (np.ceil(np.log2(np.abs(y).max())) - shift)
    return 2 * step, step


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("codec", CODECS, ids="-".join)
@pytest.mark.parametrize("phase,topology,pods", PHASES)
def test_two_d_round_matches_one_d_and_reference(tag, codec, phase,
                                                 topology, pods):
    """Every phase x codec on both 2-D meshes, with EF where the codec is
    lossy: against the 1-D round of the same node shards (bitwise where
    column-local, the collective within its bound) and the JAX stacked
    round; no kernel launches on the CPU."""
    name, gname = codec
    if gname in ("int8", "fp8") and phase == "gossip":
        codec = (name, "none")
        gname = "none"
    lossy = name in ("int8", "fp8", "topk", "randk") or gname in ("int8",
                                                                  "fp8")
    ef = _ef() if lossy else None
    mesh, mesh1 = _meshes(tag)
    before = tmc.shard_mix_block.launches, tmc.shard_comp_mix_block.launches
    got, got_ef = _round(mesh, phase, topology, pods, codec, ef=ef)
    assert (tmc.shard_mix_block.launches,
            tmc.shard_comp_mix_block.launches) == before
    one, one_ef = _round(mesh1, phase, topology, pods, codec, ef=ef)
    collective = gname in ("int8", "fp8") and phase != "gossip"
    if collective:
        bound, ef_bound = _collective_bounds(codec, ef)
        _close(one, got, atol=bound)
        _close(one_ef, got_ef, atol=ef_bound)
    # the collective too: every stage is per column or per block at
    # absolute columns
    _bitwise(got, one)
    if ef is not None:
        _bitwise(got_ef, one_ef)
    jout = jmix.communicate(_jax(_tree(0)), _jspec(topology, pods,
                                                   name=name,
                                                   global_name=gname),
                            phase=phase, step=3, ef_state=_jax(ef), seed=7)
    if isinstance(jout, tuple):
        _close(jout[0], got, atol=2e-5)
        if ef is not None:
            _close(jout[1], got_ef, atol=2e-5)
    else:
        _close(jout, got, atol=1e-5)


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("phase,topology,pods", PHASES)
def test_two_d_bf16_wire_round(tag, phase, topology, pods):
    mesh, mesh1 = _meshes(tag)
    got, _ = _round(mesh, phase, topology, pods, ("none", "none"),
                    cd="bfloat16")
    one, _ = _round(mesh1, phase, topology, pods, ("none", "none"),
                    cd="bfloat16")
    _bitwise(got, one)
    want = jmix.communicate(_jax(_tree(0)), _jspec(topology, pods,
                                                   cd="bfloat16"),
                            phase=phase, step=3)
    _close(want, got, atol=3e-2)


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("phase,topology", (("gossip", "ring"),
                                            ("gossip", "one_peer_exp"),
                                            ("pod_avg", "ring"),
                                            ("global", "ring")))
def test_two_d_residual_and_half_step(tag, phase, topology):
    """``with_residual``: the mixed rows and x̄ bitwise the 1-D round's,
    the residual within rtol 1e-6 of it and rtol 1e-4 of the JAX stacked
    one (exactly 0 after a global round); the fused half-step bitwise."""
    mesh, mesh1 = _meshes(tag)
    x, g = _torch(_tree(3)), _torch(_tree(4))
    outs = [tmix.communicate_sharded(x, _tspec(m, topology, 2), phase=phase,
                                     step=1, with_residual=True)
            for m in (mesh, mesh1)]
    (mixed, xbar, resid), (mixed1, xbar1, resid1) = outs
    _bitwise(mixed, mixed1)
    _bitwise(xbar, xbar1)
    want = jmix.communicate(_jax(_tree(3)), _jspec(topology, 2),
                            phase=phase, step=1)
    want_r = sum(float(jnp.sum((p - jnp.mean(p, 0, keepdims=True)) ** 2))
                 for p in jax.tree.leaves(want))
    if phase == "global":
        assert float(resid) == 0.0 == float(resid1)
    else:
        np.testing.assert_allclose(float(resid), float(resid1), rtol=1e-6)
        np.testing.assert_allclose(float(resid), want_r, rtol=1e-4,
                                   atol=1e-6)
    half = [tmix.communicate_sharded(x, _tspec(m, topology, 2), phase=phase,
                                     step=1, grads=g, gamma=0.37)
            for m in (mesh, mesh1)]
    _bitwise(half[0], half[1])
    _close(jmix.communicate(jax.tree.map(lambda p, q: p - 0.37 * q,
                                         _jax(_tree(3)), _jax(_tree(4))),
                            _jspec(topology, 2), phase=phase, step=1),
           half[0], atol=1e-5)


@pytest.mark.parametrize("tag", list(MESHES))
def test_two_d_constant_state_is_a_fixed_point(tag):
    """A constant state through every phase: the exact and int8 rounds
    within 1e-6, the int8 collective bitwise (its power-of-two scales make
    every stage exact on a constant)."""
    mesh = _meshes(tag)[0]
    c = jax.tree.map(lambda p: torch.full(p.shape, 1.5), _tree(0))
    for phase, topology, pods in PHASES:
        for codec in (("none", "none"), ("int8", "none")):
            out = tmix.communicate(c, _tspec(mesh, topology, pods, None,
                                             *codec), phase=phase, step=1,
                                   seed=5)
            _close(c, out[0] if isinstance(out, tuple) else out, atol=1e-6)
    for phase in ("global", "pod_avg"):
        got, _ = tmix.communicate(c, _tspec(mesh, "ring", 2,
                                            global_name="int8"),
                                  phase=phase, seed=5)
        _bitwise(got, c)


@pytest.mark.parametrize("tag", list(MESHES))
def test_two_d_push_sum_round(tag):
    """The sharded push-sum round (the weight column rides chunk 0) on a
    runtime column-stochastic W: bitwise the 1-D round, x and w."""
    from repro_torch.core.faults import push_round
    mesh, mesh1 = _meshes(tag)
    W, _ = push_round("directed_exp", N, "gossip", 1, 1, None)
    x = _torch(_tree(5))
    w = torch.from_numpy(np.random.default_rng(2).uniform(
        0.5, 1.5, (N, 1)).astype(np.float32))
    outs = [tmix.communicate_push_sum(x, w, W=W, n_nodes=N,
                                      backend="pallas", mesh=m)
            for m in (mesh, mesh1)]
    _bitwise(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    ref = tmix.communicate_push_sum(x, w, W=W, n_nodes=N)
    _close(ref[0], outs[0][0], atol=1e-5)


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("codec", ("none", "int8", "topk"))
def test_two_d_overlap_round(tag, codec):
    """``start_round``/``finish_round``/``overlap_flush`` on the 2-D mesh:
    the buffer (the wire arrays of the padded leaves for int8), the
    applied rows and the EF state bitwise the 1-D mesh's."""
    mesh, mesh1 = _meshes(tag)
    x, y = _torch(_tree(6)), _torch(_tree(7))
    ef = _torch(_ef()) if codec != "none" else None
    res = []
    for m in (mesh, mesh1):
        spec = _tspec(m, "one_peer_exp", name=codec)
        buf, ef1 = tmix.start_round(x, spec, ef_state=ef, seed=3)
        mixed = tmix.finish_round(y, buf, spec, step=1)
        flushed = tmix.overlap_flush(y, spec, phase="global", ef_state=ef1,
                                     seed=4)
        res.append((mixed, ef1, flushed[0], flushed[2]))
    for a, b in zip(res[0], res[1]):
        if a is not None:
            _bitwise(a, b)
    want = tmix.finish_round(y, tmix.start_round(
        x, _tspec(None, "one_peer_exp", name=codec).replace(
            shard_mode="auto", backend="reference"), ef_state=ef,
        seed=3)[0], _tspec(None, "one_peer_exp", name=codec).replace(
            shard_mode="auto", backend="reference"), step=1)
    _close(want, res[0][0], atol=1e-5 if codec == "none" else 2e-5)


# ---------------------------------------------------------------------------
# The Trainer on one-process 2-D meshes
# ---------------------------------------------------------------------------
def _trainer_cfg(tcfg, tarch, **dist_kw):
    dist = dict(algorithm="gossip_pga", topology="one_peer_exp", H=2,
                comm_backend="pallas", comm_shard_mode="sharded")
    dist.update(dist_kw)
    return tcfg.TrainConfig(
        model=dataclasses.replace(tarch.reduced_config(), dtype="float32"),
        dist=tcfg.DistConfig(**dist),
        optimizer=tcfg.OptimizerConfig(name="sgd", lr=0.05,
                                       schedule="constant", warmup_steps=0),
        global_batch=8, seq_len=32, log_every=1)


def test_two_d_trainer_bitwise_one_d_and_matches_reference():
    """Reduced pga-lm-100m at fp32, 4 nodes, Gossip-PGA H = 2 over
    one_peer_exp with the fused consensus residual, SGD, 4 steps: on
    ``(data=2, model=4)`` bitwise the ``(data=2)`` Trainer's params and
    losses, the consensus within rtol 1e-6 (0.0 after the global steps);
    against the JAX Trainer without a mesh as
    ``test_torch_sharded.py`` holds the 1-D one."""
    from repro.configs import base as jcfg
    from repro.configs import pga_lm_100m as jarch
    from repro.train.trainer import Trainer as JTrainer
    from repro_torch import interop
    from repro_torch.configs import base as tcfg
    from repro_torch.configs import pga_lm_100m as tarch
    from repro_torch.train import Trainer as TTrainer

    n = 4
    jt = jcfg.TrainConfig(
        model=dataclasses.replace(jarch.reduced_config(), dtype="float32"),
        dist=jcfg.DistConfig(algorithm="gossip_pga",
                             topology="one_peer_exp", H=2,
                             comm_backend="pallas"),
        optimizer=jcfg.OptimizerConfig(name="sgd", lr=0.05,
                                       schedule="constant", warmup_steps=0),
        global_batch=8, seq_len=32, log_every=1)
    jtr = JTrainer(jt, n_nodes=n, with_consensus=True)
    jst = jtr.init_state(jax.random.PRNGKey(0))
    row0 = jax.tree.map(lambda p: np.asarray(p[0]),
                        jax.device_get(jst.params))
    jst = jtr.run(jst, steps=4, log_every=1)
    runs = {}
    for tag, shape, names in (("2d", (2, 4), ("data", "model")),
                              ("1d", (2,), ("data",))):
        tr = TTrainer(_trainer_cfg(tcfg, tarch), n_nodes=n,
                      mesh=make_mesh(shape, names, device="cpu"),
                      with_consensus=True, device="cpu")
        st = tr.init_state(params=interop.from_numpy(row0, "cpu"))
        runs[tag] = (tr.run(st, steps=4, log_every=1), tr.history)
    (s2, h2), (s1, h1) = runs["2d"], runs["1d"]
    _bitwise(s2.params, s1.params)
    for a, b, jr in zip(h2, h1, jtr.history):
        assert a["phase"] == b["phase"] and a["loss"] == b["loss"]
        np.testing.assert_allclose(a["consensus"], b["consensus"],
                                   rtol=1e-6)
        np.testing.assert_allclose(a["loss"], jr["loss"], rtol=1e-5)
        if a["phase"] == "global":
            assert a["consensus"] == 0.0
    _close(jax.device_get(jst.params), interop.to_numpy(s2.params),
           atol=1e-7, rtol=1e-5)


def test_two_d_checkpoint_resumes_on_a_model_resharded_mesh(tmp_path):
    """The reference's resume test on the port: int8 collective + EF,
    ring, H = 2, SGD, non-IID data, 4 steps on ``(data=2, model=4)`` with
    a checkpoint after step 2; a fresh Trainer on ``(data=2, model=2)``
    restores it and runs steps 2-3: its params, EF state and step bitwise
    the uninterrupted run's."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import base as tcfg
    from repro_torch.configs import pga_lm_100m as tarch
    from repro_torch.train import Trainer as TTrainer

    cfg = dataclasses.replace(
        _trainer_cfg(tcfg, tarch, topology="ring",
                     comm_global_compression="int8",
                     comm_error_feedback=True),
        ckpt_every=2, ckpt_dir=str(tmp_path), steps=4, log_every=0)
    mesh_a = make_mesh((2, 4), ("data", "model"), device="cpu")
    mesh_b = make_mesh((2, 2), ("data", "model"), device="cpu")
    tr = TTrainer(cfg, n_nodes=4, mesh=mesh_a, device="cpu")
    full = tr.run(tr.init_state(torch.Generator().manual_seed(0)), steps=4)
    tr2 = TTrainer(cfg.replace(ckpt_every=0), n_nodes=4, mesh=mesh_b,
                   device="cpu")
    state = restore_checkpoint(str(tmp_path), tr2.init_state(
        torch.Generator().manual_seed(0)), step=2)
    assert state.step == 2
    resumed = tr2.run(state, steps=2)
    assert resumed.step == full.step == 4
    _bitwise(resumed.params, full.params)
    _bitwise(resumed.ef_state, full.ef_state)
