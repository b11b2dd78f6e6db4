"""Port parity: push-sum rounds (``repro_torch.core.mixing.
communicate_push_sum`` and the dense-W entry points of
``repro_torch.kernels.mixing_cuda``) vs the JAX reference on the CPU.

The same seeded numpy inputs go through both packages.  The JAX stacked
``backend="pallas"`` runs its Pallas kernels in interpret mode (the default
off-TPU); the port's wrappers take the kernels' plain twins on CPU tensors.
The JAX sharded push-sum is never the oracle (its acceptance test is red
under jax 0.9.0, ROADMAP C.4): the port's sharded rounds are held to the
JAX dense reference.

Tolerances, with their reasons:
* stacked rounds (fp32 and bf16 wire, with and without faults, the
  identity codec): atol 1e-6 against the JAX reference and interpret-mode
  pallas backends — the same fp32 operations, the (n, n) matmul summed in
  another order;
* compressed rounds (int8, fp8, error feedback): atol 1e-6 on the params
  and the EF memory (the codes agree bitwise, see
  ``test_torch_compress.py``); the weight is ``W @ w`` outside the codec,
  atol 1e-6 against numpy's float32 product and JAX's (measured: one
  ulp, 1.2e-7, the 8-term sum in another order);
* sharded rounds on the port's one-device mesh (k = 4 shards, n = 8 and
  16): atol 1e-5 against the JAX dense reference, the reference's own
  sharded tolerance (sums over shards in a fixed order);
* bitwise: ``push_sum_shard_offsets``, the halo refusal, the de-biased
  constant fixed point under full participation (dyadic weights), the
  node-scalar slot, ``debias`` on one leaf against the division it is;
* the bf16 wire cast of the weight column: ``w`` after a bf16 round
  equals ``d ⊙ w + M · bf16(w)`` bitwise in the port's twin and to 1e-6
  in the JAX reference, and differs from ``W @ w``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import init_ef_state as jinit_ef
from repro.compress import make_compressor as jmake
from repro.configs.base import DistConfig as JDist
from repro.core import algo as jalgo
from repro.core import mixing as jmix
from repro.core import topology as jtopo
from repro.kernels import mixing_pallas as jmp
from repro.train.state import debias as jdebias
from repro_torch import interop
from repro_torch.compress import init_ef_state as tinit_ef
from repro_torch.compress import make_compressor as tmake
from repro_torch.configs.base import DistConfig as TDist
from repro_torch.core import algo as talgo
from repro_torch.core import mixing as tmix
from repro_torch.core import topology as ttopo
from repro_torch.core.mesh import make_mesh
from repro_torch.kernels import mixing_cuda as tmc
from repro_torch.train.state import debias as tdebias
from repro_torch.train.state import init_push_weight

torch.set_num_threads(2)

DIRECTED = list(ttopo.DIRECTED_TOPOLOGIES)


def _tree(seed, n):
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.standard_normal((n,) + shape).astype(np.float32)

    return {"b": arr(3, 5), "a": {"z": arr(17), "w": arr(40)}, "c": arr(9)}


def _weight(seed, n):
    rng = np.random.default_rng(seed + 100)
    return rng.uniform(0.5, 1.5, size=(n, 1)).astype(np.float32)


def _matrix(t, n, fault, step=0):
    active = np.ones(n, dtype=bool)
    if fault:
        active[[1, n - 2]] = False
    return jtopo.push_sum_matrix(t, n, step=step, active=active)


def _close(jtree, ttree, atol):
    jl = jax.tree.leaves(jax.device_get(jtree))
    tl = jax.tree.leaves(interop.to_numpy(ttree))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=atol)


def _jround(tree, w, W, n, backend, **kw):
    return jmix.communicate_push_sum(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(w),
        W=jnp.asarray(W, jnp.float32), n_nodes=n, backend=backend, **kw)


def _tround(tree, w, W, n, backend, **kw):
    return tmix.communicate_push_sum(
        interop.from_numpy(tree, "cpu"), torch.from_numpy(w), W=W,
        n_nodes=n, backend=backend, **kw)


# ---------------------------------------------------------------------------
# Stacked rounds: reference and fused twin vs JAX reference and pallas
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("t", DIRECTED)
@pytest.mark.parametrize("fault", [False, True])
@pytest.mark.parametrize("wire", [None, "bfloat16"])
@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_stacked_round_matches_jax(t, fault, wire, backend):
    n = 8
    tree, w = _tree(0, n), _weight(0, n)
    W = _matrix(t, n, fault)
    jd = jnp.bfloat16 if wire else None
    td = torch.bfloat16 if wire else None
    tx, tw = _tround(tree, w, W, n, backend, comm_dtype=td)
    # the port's pallas twin against both JAX backends
    jbackends = ("reference", "pallas") if backend == "pallas" \
        else ("reference",)
    for jb in jbackends:
        jx, jw = _jround(tree, w, W, n, jb, comm_dtype=jd)
        _close(jx, tx, 1e-6)
        _close(jw, tw, 1e-6)
    assert tmc.mix_flat.launches == tmc.mix_flat.vector_launches == 0


@pytest.mark.parametrize("t", DIRECTED + ["ring", "one_peer_exp"])
@pytest.mark.parametrize("n", [4, 8, 16])
def test_reference_round_is_dense_matmul(t, n):
    tree, w = _tree(n, n), _weight(n, n)
    W = _matrix(t, n, fault=n > 4, step=1)
    tx, tw = _tround(tree, w, W, n, "reference")
    jx, jw = _jround(tree, w, W, n, "reference")
    _close(jx, tx, 1e-6)
    _close(jw, tw, 1e-6)
    W32 = W.astype(np.float32)
    np.testing.assert_allclose(tw.numpy(), W32 @ w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_bf16_wire_casts_the_weight_column(backend):
    """The weight rides the packed round: under a bf16 wire its neighbour
    term is cast like every leaf's, in the reference's stacked paths as in
    the port's (kept for parity: it moves Σw by bf16 rounding)."""
    n = 8
    tree, w = _tree(1, n), _weight(1, n)
    W = _matrix("directed_exp", n, fault=True)
    _, tw = _tround(tree, w, W, n, backend, comm_dtype=torch.bfloat16)
    W32 = torch.from_numpy(W.astype(np.float32))
    d = torch.diagonal(W32).reshape(n, 1)
    M = W32 - torch.diag(torch.diagonal(W32))
    wt = torch.from_numpy(w)
    want = d * wt + torch.matmul(M, wt.to(torch.bfloat16).to(torch.float32))
    if backend == "pallas":     # the twin is mix_flat_plain: same ops
        assert torch.equal(tw, want)
    else:
        torch.testing.assert_close(tw, want, rtol=0, atol=1e-6)
    assert not torch.allclose(tw, torch.matmul(W32, wt), rtol=0, atol=1e-6)
    _, jw = _jround(tree, w, W, n, backend, comm_dtype=jnp.bfloat16)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("codec", ["int8", "fp8"])
@pytest.mark.parametrize("backend", ["reference", "pallas"])
@pytest.mark.parametrize("fault", [False, True])
def test_compressed_round_matches_jax(codec, backend, fault):
    n = 8
    tree, w = _tree(2, n), _weight(2, n)
    W = _matrix("directed_exp", n, fault)
    jef = jinit_ef(jax.tree.map(jnp.asarray, tree))
    tef = tinit_ef(interop.from_numpy(tree, "cpu"))
    jx, jw, jef2 = _jround(tree, w, W, n, backend, compressor=jmake(codec),
                           ef_state=jef, seed=3)
    tx, tw, tef2 = _tround(tree, w, W, n, backend, compressor=tmake(codec),
                           ef_state=tef, seed=3)
    _close(jx, tx, 1e-6)
    _close(jef2, tef2, 1e-6)
    # the weight bypasses the codec: the exact dense W·w
    np.testing.assert_allclose(tw.numpy(), W.astype(np.float32) @ w,
                               rtol=0, atol=1e-6)
    _close(jw, tw, 1e-6)
    assert any(float(np.abs(e).max()) > 0 for e in jax.tree.leaves(
        interop.to_numpy(tef2)))
    assert tmc.cmix_flat.launches == tmc.cmix_flat.vector_launches == 0


def test_identity_codec_is_exact_passthrough():
    n = 8
    tree, w = _tree(3, n), _weight(3, n)
    W = _matrix("directed_ring", n, fault=True)
    for backend in ("reference", "pallas"):
        xi, wi, ef = _tround(tree, w, W, n, backend,
                             compressor=tmake("identity"))
        xe, we = _tround(tree, w, W, n, backend)
        for a, b in zip(jax.tree.leaves(interop.to_numpy(xi)),
                        jax.tree.leaves(interop.to_numpy(xe))):
            np.testing.assert_array_equal(a, b)
        assert torch.equal(wi, we) and ef is None
        jx, jw, jef = _jround(tree, w, W, n, backend,
                              compressor=jmake("identity"))
        _close(jx, xi, 1e-6)
        _close(jw, wi, 1e-6)
        assert jef is None


def test_w_may_be_a_host_array_or_a_tensor():
    n = 8
    tree, w = _tree(4, n), _weight(4, n)
    W = _matrix("directed_exp", n, fault=True)
    outs = [_tround(tree, w, Wx, n, "pallas")
            for Wx in (W, W.astype(np.float32),
                       torch.from_numpy(W.astype(np.float32)))]
    for x, wt in outs[1:]:
        assert torch.equal(wt, outs[0][1])
        for a, b in zip(jax.tree.leaves(interop.to_numpy(x)),
                        jax.tree.leaves(interop.to_numpy(outs[0][0]))):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="W must be"):
        _tround(tree, w, np.eye(n - 1), n, "reference")


def test_dense_entry_points_refuse_non_bf16_wire():
    x = {"w": torch.zeros(4, 8)}
    with pytest.raises(ValueError, match="bfloat16 only"):
        tmc.fused_step_mix_dense(x, torch.eye(4), n_nodes=4,
                                 comm_dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16 only"):
        jmp.fused_step_mix_dense({"w": jnp.zeros((4, 8))}, jnp.eye(4),
                                 n_nodes=4, comm_dtype=jnp.float16)


def test_dense_entry_points_match_pallas():
    """``fused_step_mix_dense`` and ``compressed_step_mix_dense`` on one
    runtime fault W against the JAX Pallas kernels (interpret mode)."""
    n = 8
    tree = _tree(5, n)
    W = _matrix("directed_exp", n, fault=True)
    Wj, Wt = jnp.asarray(W, jnp.float32), torch.from_numpy(
        W.astype(np.float32))
    for jd, td in ((None, None), (jnp.bfloat16, torch.bfloat16)):
        jo = jmp.fused_step_mix_dense(jax.tree.map(jnp.asarray, tree), Wj,
                                      n_nodes=n, comm_dtype=jd)
        to = tmc.fused_step_mix_dense(interop.from_numpy(tree, "cpu"), Wt,
                                      n_nodes=n, comm_dtype=td)
        _close(jo, to, 1e-6)
    ef = {k: v for k, v in _tree(6, n).items()}
    jo, je = jmp.compressed_step_mix_dense(
        jax.tree.map(jnp.asarray, tree), W=Wj, compressor=jmake("int8"),
        ef_state=jax.tree.map(lambda a: 0.01 * jnp.asarray(a), ef), seed=9,
        n_nodes=n)
    to, te = tmc.compressed_step_mix_dense(
        interop.from_numpy(tree, "cpu"), W=Wt, compressor=tmake("int8"),
        ef_state=jax.tree.map(lambda a: 0.01 * torch.from_numpy(a), ef),
        seed=9, n_nodes=n)
    _close(jo, to, 1e-6)
    _close(je, te, 1e-6)


# ---------------------------------------------------------------------------
# Sharded rounds on the port's one-device mesh vs the JAX dense reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("t", DIRECTED)
@pytest.mark.parametrize("fault", [False, True])
@pytest.mark.parametrize("wire", [None, "bfloat16"])
def test_sharded_round_matches_jax_reference(n, t, fault, wire):
    k = 4
    mesh = make_mesh((k,), ("data",), device="cpu")
    tree, w = _tree(7, n), _weight(7, n)
    W = _matrix(t, n, fault, step=1)
    shifts = set()
    for s in range(ttopo.schedule_period(t, n)):
        shifts |= set(ttopo.shift_weights(t, n, s))
    offs = tmix.push_sum_shard_offsets(n, k, shifts)
    assert offs == jmix.push_sum_shard_offsets(n, k, shifts)
    jd = jnp.bfloat16 if wire else None
    td = torch.bfloat16 if wire else None
    jx, jw = _jround(tree, w, W, n, "reference", comm_dtype=jd)
    for o in (None, offs):
        tx, tw = _tround(tree, w, W, n, "pallas", mesh=mesh,
                         shard_mode="sharded", offsets=o, comm_dtype=td)
        _close(jx, tx, 1e-5)
        _close(jw, tw, 1e-5)
    assert tmc.shard_mix_block.launches == 0


@pytest.mark.parametrize("n,k,shifts", [
    (16, 8, (1, 2, 4)), (8, 8, range(8)), (8, 4, (0, 1, 2, 4)),
    (16, 4, (0, 1, 2, 4, 8)), (8, 2, (1,)), (16, 4, (3, 5, 15))])
def test_push_sum_shard_offsets_equal(n, k, shifts):
    assert tmix.push_sum_shard_offsets(n, k, shifts) == \
        jmix.push_sum_shard_offsets(n, k, shifts)


def test_sharded_round_refuses_a_shift_outside_the_halo():
    """A W that mixes rows from a shard the static superset does not
    gather raises instead of mixing wrongly: from a host W without a
    device read, and from a tensor W by reading it back."""
    n, k = 16, 4
    mesh = make_mesh((k,), ("data",), device="cpu")
    tree, w = _tree(8, n), _weight(8, n)
    offs = tmix.push_sum_shard_offsets(n, k, (0, 1))       # (0, 1)
    W = ttopo.push_sum_matrix("directed_exp", n)            # shifts 1..8
    for Wx in (W, torch.from_numpy(W.astype(np.float32))):
        with pytest.raises(ValueError, match="outside the halo"):
            _tround(tree, w, Wx, n, "pallas", mesh=mesh,
                    shard_mode="sharded", offsets=offs)
    # the ring's shifts fit: no refusal, the reference's result
    Wr = ttopo.push_sum_matrix("directed_ring", n)
    tx, tw = _tround(tree, w, Wr, n, "pallas", mesh=mesh,
                     shard_mode="sharded", offsets=offs)
    jx, jw = _jround(tree, w, Wr, n, "reference")
    _close(jx, tx, 1e-5)
    _close(jw, tw, 1e-5)


def test_compressed_sharded_push_sum_raises():
    n = 8
    mesh = make_mesh((4,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="no sharded path"):
        _tround(_tree(9, n), _weight(9, n),
                ttopo.push_sum_matrix("directed_ring", n), n, "pallas",
                mesh=mesh, shard_mode="sharded", compressor=tmake("int8"))


# ---------------------------------------------------------------------------
# De-biasing, the weight slot, the global reset
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("t", DIRECTED)
def test_debiased_constant_fixed_point_bitwise(t):
    n, c = 8, 2.0 ** -3
    w = init_push_weight(n)
    x = torch.full((n, 4), c)
    for _ in range(6):
        W = ttopo.push_sum_matrix(t, n)
        x, w = tmix.communicate_push_sum(x, w, W=W, n_nodes=n,
                                         backend="pallas")
        assert torch.equal(tdebias(x, w), torch.full((n, 4), c))


def test_debias_and_init_match_the_reference():
    n = 8
    tree, w = _tree(10, n), _weight(10, n)
    jd = jdebias(jax.tree.map(jnp.asarray, tree), jnp.asarray(w))
    td = tdebias(interop.from_numpy(tree, "cpu"), torch.from_numpy(w))
    _close(jd, td, 0.0)
    assert tdebias(tree, None) is tree
    assert torch.equal(init_push_weight(n), torch.ones(n, 1))


def test_global_round_averages_weight_to_one():
    n = 8
    w = init_push_weight(n)
    x = torch.from_numpy(_tree(11, n)["c"])
    active = np.ones(n, dtype=bool)
    active[4] = False
    for _ in range(3):
        W = ttopo.push_sum_matrix("directed_exp", n, active=active)
        x, w = tmix.communicate_push_sum(x, w, W=W, n_nodes=n,
                                         backend="pallas")
    assert not torch.allclose(w, torch.ones(n, 1))
    torch.testing.assert_close(w.sum(), torch.tensor(float(n)), rtol=0,
                               atol=1e-5)
    x, w = tmix.communicate_push_sum(x, w, W=ttopo.global_push_matrix(n),
                                     n_nodes=n, backend="pallas")
    torch.testing.assert_close(w, torch.ones(n, 1), rtol=0, atol=1e-6)
    assert float((x - x[:1]).abs().max()) < 1e-6


def test_push_slot_and_registry_match_the_reference():
    assert talgo.push_sum_algorithm_names() == \
        jalgo.push_sum_algorithm_names()
    assert talgo.known_slot_names() == jalgo.known_slot_names()
    params = {"w": torch.zeros(4, 3)}
    for dist_kw in (dict(push_sum=True, topology="directed_exp"),
                    dict(push_sum=True, comm_compression="int8",
                         comm_error_feedback=True, topology="ring")):
        tdist, jdist = TDist(**dist_kw).validate(), JDist(**dist_kw)
        assert [s.name for s in talgo.state_slots(tdist)] == \
            [s.name for s in jalgo.state_slots(jdist)]
        extras = talgo.init_extras(tdist, params, 4)
        jextras = jalgo.init_extras(jdist, {"w": jnp.zeros((4, 3))}, 4)
        assert sorted(extras) == sorted(jextras)
        np.testing.assert_array_equal(extras["push_weight"].numpy(),
                                      np.asarray(jextras["push_weight"]))
        assert extras["push_weight"].dtype == torch.float32
