"""Port parity: the MoE FFN (``repro_torch.models.moe``) against
``repro.models.moe`` on the CPU — the router, the capacity, the dispatch
tables, the sort-based apply against the dense oracle and the
reference, the balance loss and the gradients.

Weights are drawn by the JAX package (``init_moe``) and carried across
with ``repro_torch.interop``; inputs are numpy from a seed.  The port
takes a leading node axis everywhere (``(n, …)``); the reference is
called once per node.

Tolerances:
* the dispatch tables, ``drop_frac`` and the router's indices: bitwise
  (integer arithmetic, sorts and gathers);
* the router's weights and ``lb_loss`` at fp32: 1e-6 (the softmax and
  the mean over tokens sum in another order);
* ``apply_moe`` against ``apply_moe_dense_reference`` at fp32: atol 2e-5,
  rtol 1e-3, as ``tests/test_moe.py``; against the reference's
  ``apply_moe`` at fp32 1e-6 · max|ref|;
* at bf16: 2e-2 · max|ref| (both packages round the expert products to
  bf16, in differently fused places: at most 1.5 bf16 ulps of the
  largest output measured);
* gradients at fp32, with drops: 1e-5 · max|ref| per leaf.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro.models import moe as jmoe
from repro_torch import interop
from repro_torch.configs import MoEConfig, get_model_config
from repro_torch.models import moe as tmoe
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(2)

ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b")


def _configs(arch, **moe):
    jc, tc = jax_config(arch, reduced=True), get_model_config(arch,
                                                              reduced=True)
    if moe:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe))
    return jc, tc


def _params(jc, seed=0):
    p, _ = jmoe.init_moe(jax.random.PRNGKey(seed), jc, jnp.float32)
    host = jax.device_get(p)
    return p, tree_map(lambda t: t[None], interop.from_numpy(host, "cpu"))


def _x(shape, seed=1, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, rel):
    got = got.detach().to(torch.float32).numpy() if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * max(float(np.abs(want).max()), 1e-30), err


# ---------------------------------------------------------------------------
# Router and capacity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch):
    jc, tc = _configs(arch)
    jp, tp = _params(jc)
    x = _x((2, 16, jc.d_model))
    jw, ji, jlb = jmoe.route(jp, jc.moe, jnp.asarray(x))
    tw, ti, tlb = tmoe.route(tp, tc.moe, torch.from_numpy(x)[None])
    np.testing.assert_array_equal(ti[0].numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw[0].numpy(), np.asarray(jw), rtol=0,
                               atol=1e-6)
    assert tlb.shape == (1,)
    np.testing.assert_allclose(float(tlb[0]), float(jlb), rtol=1e-6)


@pytest.mark.parametrize("tie", ("zero_router", "duplicated_columns"))
def test_route_ties_break_toward_the_lower_index(tie):
    """``jax.lax.top_k`` takes the lower index among equal values; the
    port's stable descending sort does the same.  A zero router (the
    reference's ``test_load_balance_loss_uniform_router_is_minimal``)
    ties all 128 experts; duplicated router columns tie pairs."""
    m = MoEConfig(n_routed=128, top_k=8, d_ff_expert=16)
    d = 32
    rng = np.random.default_rng(3)
    router = rng.standard_normal((d, m.n_routed)).astype(np.float32)
    if tie == "zero_router":
        router[:] = 0.0
    else:
        router[:, 1::2] = router[:, 0::2]
    x = _x((2, 8, d), seed=4)
    _, ji, jlb = jmoe.route({"router": jnp.asarray(router)}, m,
                            jnp.asarray(x))
    _, ti, tlb = tmoe.route({"router": torch.from_numpy(router)[None]}, m,
                            torch.from_numpy(x)[None])
    np.testing.assert_array_equal(ti[0].numpy(), np.asarray(ji))
    np.testing.assert_allclose(float(tlb[0]), float(jlb), rtol=1e-6)
    if tie == "zero_router":
        assert (ti[0].numpy() == np.arange(8)).all()
        np.testing.assert_allclose(float(tlb[0]), 1.0, rtol=1e-6)


@pytest.mark.parametrize("n_tokens", (1, 4, 16, 37, 1024, 4096))
@pytest.mark.parametrize("cf", (0.25, 1.0, 1.25, 64.0))
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_capacity_matches_reference(arch, cf, n_tokens):
    jc, tc = _configs(arch)
    for jm, tm in ((jc.moe, tc.moe),
                   (jax_config(arch).moe, get_model_config(arch).moe)):
        assert tmoe.expert_capacity(tm, n_tokens, cf) == \
            jmoe.expert_capacity(jm, n_tokens, cf)


# ---------------------------------------------------------------------------
# Dispatch tables
# ---------------------------------------------------------------------------
def _assignments(T, E, k, seed):
    """(T, k) distinct experts per token and softmax weights."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(
        np.int32)
    w = rng.random((T, k)).astype(np.float32)
    return idx, w / w.sum(-1, keepdims=True)


def _dispatch_both(idx, w, E, C):
    T = idx.shape[0]
    jt, jw, jd = jmoe._build_dispatch(jnp.asarray(idx), jnp.asarray(w), E,
                                      C, T)
    tt, tw, td = tmoe._build_dispatch(torch.from_numpy(idx).long(),
                                      torch.from_numpy(w), E, C, T)
    return (np.asarray(jt), np.asarray(jw), float(jd)), (
        tt.numpy(), tw.numpy(), float(td))


@pytest.mark.parametrize("T,E,k,C", ((64, 8, 2, 24), (64, 8, 2, 8),
                                     (37, 4, 2, 8), (16, 128, 8, 16),
                                     (200, 64, 6, 19), (5, 4, 3, 8)))
def test_build_dispatch_bitwise(T, E, k, C):
    """Tables and ``drop_frac`` bitwise the reference's, with and without
    drops."""
    idx, w = _assignments(T, E, k, seed=T + E + C)
    (jt, jw, jd), (tt, tw, td) = _dispatch_both(idx, w, E, C)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tw, jw)
    assert td == jd


def test_dropped_assignments_overwrite_expert_zeros_first_slot():
    """The reference fault kept for parity (ROADMAP C.4): T = 16, E = 4,
    C = 3, k = 2 with per-expert counts [8, 10, 8, 6].  Every dropped
    assignment is written to (0, 0) after the one that held it, so
    expert 0's first slot becomes the sentinel (token 16, weight 0): the
    lowest token routed to expert 0 loses that expert, and ``drop_frac``
    (20 of 32 = 0.625) does not count it."""
    T, E, C = 16, 4, 3
    rng = np.random.default_rng(0)
    want_counts = [8, 10, 8, 6]
    while True:
        flat = rng.permutation(np.repeat(np.arange(E), want_counts))
        idx = flat.reshape(T, 2).astype(np.int32)
        if (idx[:, 0] != idx[:, 1]).all():
            break
    w = np.full((T, 2), 0.5, np.float32)
    (jt, jw, jd), (tt, tw, td) = _dispatch_both(idx, w, E, C)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tw, jw)
    assert td == jd == 0.625
    first = np.flatnonzero((idx == 0).any(axis=1))
    assert tt[0, 0] == T and tw[0, 0] == 0.0
    assert list(tt[0, 1:]) == list(first[1:3])
    assert (tw[0, 1:] == 0.5).all()
    # without drops the first slot keeps its token
    (jt, _, jd), (tt, _, td) = _dispatch_both(idx, w, E, 10)
    assert td == jd == 0.0 and tt[0, 0] == jt[0, 0] == first[0]


def test_node_stacked_dispatch_is_n_reference_calls():
    T, E, k, C, n = 48, 8, 2, 10, 3
    cases = [_assignments(T, E, k, seed=s) for s in range(n)]
    tt, tw, td = tmoe._build_dispatch(
        torch.from_numpy(np.stack([c[0] for c in cases])).long(),
        torch.from_numpy(np.stack([c[1] for c in cases])), E, C, T)
    assert tt.shape == tw.shape == (n, E, C) and td.shape == (n,)
    for i, (idx, w) in enumerate(cases):
        jt, jw, jd = jmoe._build_dispatch(jnp.asarray(idx), jnp.asarray(w),
                                          E, C, T)
        np.testing.assert_array_equal(tt[i].numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tw[i].numpy(), np.asarray(jw))
        assert float(td[i]) == float(jd)


def test_node_stacked_apply_is_n_reference_calls():
    """Each node routes and drops on its own tokens (capacity from its
    own T), as the reference's vmap over nodes does."""
    jc, tc = _configs("deepseek-v2-lite-16b", capacity_factor=0.5)
    calls = [_params(jc, seed=s) for s in range(3)]
    tp = {k: torch.cat([c[1][k] for c in calls]) for k in calls[0][1]}
    x = _x((3, 2, 12, jc.d_model), seed=5)
    out, met = tmoe.apply_moe(tp, tc, torch.from_numpy(x))
    for i, (jp, _) in enumerate(calls):
        jo, jmet = jmoe.apply_moe(jp, jc, jnp.asarray(x[i]))
        _close(out[i], jo, 1e-6)
        assert float(met["drop_frac"][i]) == float(jmet["drop_frac"])
        np.testing.assert_allclose(float(met["lb_loss"][i]),
                                   float(jmet["lb_loss"]), rtol=1e-6)


# ---------------------------------------------------------------------------
# apply_moe
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_sort_dispatch_matches_dense_reference_when_no_drops(arch):
    jc, tc = _configs(arch)
    jp, tp = _params(jc)
    x = torch.from_numpy(_x((2, 16, jc.d_model)))[None]
    out, met = tmoe.apply_moe(tp, tc, x,
                              capacity_factor=float(tc.moe.n_routed))
    want = tmoe.apply_moe_dense_reference(tp, tc, x)
    assert float(met["drop_frac"][0]) == 0.0
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=2e-5,
                               rtol=1e-3)
    jwant = jmoe.apply_moe_dense_reference(jp, jc, jnp.asarray(x[0]))
    _close(want[0], jwant, 1e-6)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("cf", (None, 0.25, 0.5))
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_reference(arch, cf, dtype):
    """The default capacity, and 0.25 and 0.5 (drops, the (0, 0)
    overwrite in play)."""
    jc, tc = _configs(arch)
    jp, tp = _params(jc)
    x = _x((2, 16, jc.d_model))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jo, jmet = jmoe.apply_moe(jp, jc, jnp.asarray(x).astype(jdt),
                              capacity_factor=cf)
    to, tmet = tmoe.apply_moe(tp, tc, torch.from_numpy(x).to(tdt)[None],
                              capacity_factor=cf)
    assert to.dtype == tdt
    _close(to[0], jo, 1e-6 if dtype == "float32" else 2e-2)
    assert float(tmet["drop_frac"][0]) == float(jmet["drop_frac"])
    if cf is not None:
        assert float(tmet["drop_frac"][0]) > 0.0
    np.testing.assert_allclose(float(tmet["lb_loss"][0]),
                               float(jmet["lb_loss"]), rtol=1e-6)


def test_shared_experts_always_active():
    jc, tc = _configs("deepseek-v2-lite-16b")
    _, tp = _params(jc)
    zero = dict(tp)
    for k in ("w_gate", "w_up", "w_down"):
        zero[k] = torch.zeros_like(tp[k])
    x = torch.from_numpy(_x((1, 8, jc.d_model)))[None]
    out, _ = tmoe.apply_moe(zero, tc, x)
    assert float(out.abs().sum()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_with_drops_match_jax_grad(arch):
    """d/d(params, x) of ``Σ out·g + aux_coef·lb_loss`` at fp32 with a
    capacity that drops (and so the (0, 0) overwrite), against
    ``jax.grad``."""
    jc, tc = _configs(arch)
    jp, tp = _params(jc)
    x = _x((2, 16, jc.d_model))
    g = _x((2, 16, jc.d_model), seed=9)
    aux = tc.moe.aux_coef

    def jloss(p, xx):
        out, met = jmoe.apply_moe(p, jc, xx, capacity_factor=0.5)
        return jnp.sum(out * g) + aux * met["lb_loss"]

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x)[None].requires_grad_(True)
    out, met = tmoe.apply_moe(leaves, tc, tx, capacity_factor=0.5)
    assert float(met["drop_frac"][0]) > 0.0
    loss = torch.sum(out * torch.from_numpy(g)[None]) + aux * met["lb_loss"]
    grads = torch.autograd.grad(loss.sum(), [tx] + list(leaves.values()))
    _close(grads[0][0], jgx, 1e-5)
    for k, gt in zip(leaves, grads[1:]):
        _close(gt[0], jgp[k], 1e-5)
    assert len(tree_leaves(jgp)) == len(grads) - 1
