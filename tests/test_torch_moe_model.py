"""Port parity: the MoE decoders (deepseek-v2-lite-16b: MLA, a dense
prefix layer, 2 shared + routed experts; qwen3-moe-30b-a3b: GQA with
qk-norm, routed experts) at their reduced configs, JAX vs ``repro_torch``
on the CPU — configs, init, forward and ``lb_loss``, prefill → decode,
the engine, the batched server and both launchers (the loss with
``aux_coef``, its gradients and the trainer:
``tests/test_torch_moe_train.py``).

Weights are drawn by the JAX package and carried across with
``repro_torch.interop``; prompts and batches are numpy from a seed.

Tolerances:
* float32 compute: logits and every cache leaf within 2e-5 · max|ref|;
  ``lb_loss`` rtol 1e-5 (the same math, reductions summed in another
  order); greedy ids equal;
* bf16 compute: logits within 5e-2 · max|ref| and ``lb_loss`` rtol 1e-3
  (both round after every product, in differently fused places; a
  routing decision near a tie can flip at bf16);
* prefill → decode against the port's own forward: drop-free
  (``capacity_factor = n_routed``, as ``tests/test_decode_consistency.py``
  pins it) and float32, 2e-5 · max|fwd|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro.models import make_model as jax_make_model
from repro.serve import BatchedServer as JBatchedServer
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import pad_cache_to as jax_pad_cache_to
from repro_torch import interop
from repro_torch.configs import get_model_config
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models.model import make_model
from repro_torch.serve import BatchedServer, Engine, Request, pad_cache_to
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(2)

ARCHS = ("deepseek-v2-lite-16b", "qwen3-moe-30b-a3b")


def _cfgs(arch, dtype="float32", drop_free=False):
    jc = dataclasses.replace(jax_config(arch, reduced=True), dtype=dtype)
    tc = dataclasses.replace(get_model_config(arch, reduced=True),
                             dtype=dtype)
    if drop_free:
        cf = float(jc.moe.n_routed)
        jc = dataclasses.replace(jc, moe=dataclasses.replace(
            jc.moe, capacity_factor=cf))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, capacity_factor=cf))
    return jc, tc


def _models(arch, dtype="float32", drop_free=False):
    jc, tc = _cfgs(arch, dtype, drop_free)
    return jax_make_model(jc), make_model(tc)


_WEIGHTS = {}


def _weights(arch):
    """One JAX init per arch (seed 0) as numpy, shared by the tests."""
    if arch not in _WEIGHTS:
        jm, _ = _models(arch)
        _WEIGHTS[arch] = jax.device_get(
            jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(0)))
    return _WEIGHTS[arch]


def _prompts(B, S, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _node(tree):
    return tree_map(lambda t: t[None], tree)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, rel):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


# ---------------------------------------------------------------------------
# Configs and init
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", (False, True))
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch, reduced):
    want = jax_config(arch, reduced=reduced)
    got = get_model_config(arch, reduced=reduced)
    names = {f.name for f in dataclasses.fields(got)}
    assert names == {f.name for f in dataclasses.fields(want)}
    for name in sorted(names):
        g, w = getattr(got, name), getattr(want, name)
        if dataclasses.is_dataclass(w):
            assert dataclasses.asdict(g) == dataclasses.asdict(w), name
        else:
            assert g == w, name
    make_model(got)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_keys_and_shapes_match_reference(arch):
    """``Model.init`` gives the reference's tree: deepseek's unscanned
    ``prefix_0`` (dense MLP, MLA) beside the scanned MoE layers, the
    shared experts where ``n_shared`` > 0."""
    _, tm = _models(arch)
    want = jax.tree.map(lambda a: tuple(a.shape), _weights(arch))
    got = tree_map(lambda t: tuple(t.shape),
                   tm.init(torch.Generator().manual_seed(0), "cpu"))
    assert got == want
    stack = got["stack"]
    assert ("prefix_0" in stack) == bool(tm.cfg.prefix_pattern)
    ffn = stack["scan"]["entry_0"]["ffn"]
    assert ("sw_gate" in ffn) == bool(tm.cfg.moe.n_shared)
    assert ffn["w_gate"] == (tm.cfg.n_scan_blocks, tm.cfg.moe.n_routed,
                             tm.cfg.d_model, tm.cfg.moe.d_ff_expert)
    mixer = stack["scan"]["entry_0"]["mixer"]
    assert ("w_dkv" in mixer) == (tm.cfg.mla is not None)


@pytest.mark.parametrize("arch,count,layers", (
    ("deepseek-v2-lite-16b", 15_706_484_224, 27),
    ("qwen3-moe-30b-a3b", 30_532_122_624, 48)))
def test_full_param_counts(arch, count, layers):
    """The published sizes, reckoned from the reference's own init
    (``jax.eval_shape``) and the port's config."""
    jm = jax_make_model(jax_config(arch))
    shapes = jax.eval_shape(lambda k: jm.init(k)[0], jax.random.PRNGKey(0))
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)) == \
        count
    cfg = get_model_config(arch)
    d, m = cfg.d_model, cfg.moe
    nh = cfg.n_heads
    if cfg.mla is not None:
        a = cfg.mla
        attn_p = (d * nh * (a.nope_head_dim + a.rope_head_dim)
                  + d * a.kv_lora_rank + d * a.rope_head_dim + a.kv_lora_rank
                  + a.kv_lora_rank * nh * (a.nope_head_dim + a.v_head_dim)
                  + nh * a.v_head_dim * d)
    else:
        hd = cfg.resolved_head_dim
        attn_p = (2 * d * nh * hd + 2 * d * cfg.n_kv_heads * hd
                  + (2 * hd if cfg.qk_norm else 0))
    moe_p = (d * m.n_routed + 3 * m.n_routed * d * m.d_ff_expert
             + 3 * d * m.n_shared * m.d_ff_expert)
    dense_p = 3 * d * cfg.d_ff
    n_prefix = len(cfg.prefix_pattern)
    total = (2 * cfg.vocab_size * d + d
             + n_prefix * (attn_p + dense_p + 2 * d)
             + cfg.n_scan_blocks * (attn_p + moe_p + 2 * d))
    assert cfg.n_layers == layers and total == count


# ---------------------------------------------------------------------------
# Forward and lb_loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_lb_loss_match_reference(arch, dtype):
    jm, tm = _models(arch, dtype)
    w = _weights(arch)
    toks = _prompts(2, 13, 1)
    jl, _, jlb = jm.forward(jax.tree.map(jnp.asarray, w), {"inputs": toks})
    tl, caches, tlb = tm.forward(_node(interop.from_numpy(w, "cpu")),
                                 {"inputs": torch.from_numpy(toks)[None]})
    assert caches is None and tlb.shape == (1,)
    assert float(tlb[0]) > 0.0
    if dtype == "float32":
        _close(tl[0], jl, 2e-5)
        np.testing.assert_allclose(float(tlb[0]), float(jlb), rtol=1e-5)
    else:
        _close(tl[0], jl, 5e-2)
        np.testing.assert_allclose(float(tlb[0]), float(jlb), rtol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_carries_into_the_reference(arch):
    """The other direction of ``interop``: the port's init (``prefix_0``,
    the experts, MLA's latent weights) as numpy runs in the reference and
    gives the port's logits and ``lb_loss``, and a cache the port built
    (deepseek's latent cache beside the prefix block's) decodes there as
    in the port."""
    jm, tm = _models(arch)
    tp = tm.init(torch.Generator().manual_seed(3), "cpu")
    host = interop.to_numpy(tp)
    jp = jax.tree.map(jnp.asarray, host)
    toks = _prompts(2, 7, 9)
    tl, tc, tlb = tm.forward(_node(tp),
                             {"inputs": torch.from_numpy(toks)[None]},
                             mode="prefill", want_cache=True)
    jl, _, jlb = jm.forward(jp, {"inputs": toks})
    _close(tl[0], jl, 2e-5)
    np.testing.assert_allclose(float(tlb[0]), float(jlb), rtol=1e-5)
    tc = pad_cache_to(tc, 10)
    jc = jax.tree.map(jnp.asarray, tree_map(lambda a: a[0],
                                            interop.to_numpy(tc)))
    pos = np.full((2,), 7, np.int32)
    jl, _ = jm.decode_step(jp, jc, toks[:, :1], pos)
    tl, _ = tm.decode_step(_node(tp), tc, torch.from_numpy(toks[:, :1])[None],
                           torch.from_numpy(pos))
    _close(tl[0], jl, 2e-5)


# ---------------------------------------------------------------------------
# Prefill, decode and caches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill caches (deepseek's ``prefix_0`` latent cache beside the
    scanned ones) and four decode steps at float32, each package from its
    own state; positions differ between the two rows."""
    jm, tm = _models(arch)
    w = _weights(arch)
    jp, tp = jax.tree.map(jnp.asarray, w), _node(interop.from_numpy(w,
                                                                    "cpu"))
    toks = _prompts(2, 9, 2)
    jl, jc, _ = jax.jit(lambda p, t: jm.forward(
        p, {"inputs": t}, mode="prefill", want_cache=True))(jp, toks)
    tl, tc, _ = tm.forward(tp, {"inputs": torch.from_numpy(toks)[None]},
                           mode="prefill", want_cache=True)
    _close(tl[0], jl, 2e-5)
    assert sorted(tc) == sorted(jc)
    for t, j in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        _close(t[0], j, 2e-5)
    jc, tc = jax_pad_cache_to(jc, 16), pad_cache_to(tc, 16)
    nxt = _prompts(2, 4, 3)
    jstep = jax.jit(jm.decode_step)
    for t in range(4):
        pos = np.asarray((9 + t, 5 + t), np.int32)
        jl, jc = jstep(jp, jc, nxt[:, t:t + 1], pos)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(
            nxt[:, t:t + 1])[None], torch.from_numpy(pos))
        _close(tl[0], jl, 2e-5)
        for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
            _close(a[0], b, 2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_forward(arch):
    """The port's counterpart of ``tests/test_decode_consistency.py``,
    drop-free and float32 as the reference pins MoE configs there:
    prompt of 6, decode of positions 6..11 against one full forward."""
    _, tm = _models(arch, drop_free=True)
    tp = _node(interop.from_numpy(_weights(arch), "cpu"))
    toks = _prompts(2, 12, 4)
    full, _, _ = tm.forward(tp, {"inputs": torch.from_numpy(toks)[None]})
    _, tc, _ = tm.forward(tp, {"inputs": torch.from_numpy(toks[:, :6])[None]},
                          mode="prefill", want_cache=True)
    tc = pad_cache_to(tc, 12)
    for t in range(6, 12):
        pos = torch.full((2,), t, dtype=torch.int32)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(
            toks[:, t:t + 1])[None], pos)
        _close(tl[0, :, 0], full[0, :, t], 2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch):
    jm, tm = _models(arch, "bfloat16")
    want = jm.init_cache(3, 20)
    got = tm.init_cache(3, 20, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda a: 0, want)) == \
        jax.tree.structure(tree_map(lambda t: 0, tree_map(lambda t: t[0],
                                                          got)))
    for t, j in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(t.shape) == (1,) + j.shape
        assert t.dtype == torch.bfloat16 and not t.any()


# ---------------------------------------------------------------------------
# Engine, BatchedServer, launchers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_generate_matches_reference(arch):
    jm, tm = _models(arch)
    w = _weights(arch)
    prompts = _prompts(2, 11, 7)
    want = JEngine(jm, s_max=24).generate(jax.tree.map(jnp.asarray, w),
                                          jnp.asarray(prompts), n_new=6)
    got = Engine(tm, s_max=24).generate(interop.from_numpy(w, "cpu"),
                                        prompts, n_new=6)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_server_matches_reference(arch):
    """Three requests of 5, 9 and 3 tokens on 2 slots (a slot reused, the
    idle slot decoding on): each admission writes the slot's rows of
    deepseek's prefix-block cache (batch axis 1) and of the scanned
    caches (batch axis 2); greedy ids equal to the reference server's."""
    jm, tm = _models(arch)
    w = _weights(arch)
    prompts = [_prompts(1, s, 10 + i)[0] for i, s in enumerate((5, 9, 3))]
    jsrv = JBatchedServer(JEngine(jm, s_max=20),
                          jax.tree.map(jnp.asarray, w), n_slots=2)
    want = sorted(jsrv.run([JRequest(uid=i, prompt=p, max_new=5)
                            for i, p in enumerate(prompts)]),
                  key=lambda r: r.uid)
    tsrv = BatchedServer(Engine(tm, s_max=20), interop.from_numpy(w, "cpu"),
                         n_slots=2)
    got = sorted(tsrv.run([Request(uid=i, prompt=p, max_new=5)
                           for i, p in enumerate(prompts)]),
                 key=lambda r: r.uid)
    assert [r.generated for r in got] == [r.generated for r in want]
    if tm.cfg.prefix_pattern:
        c = tsrv.caches["prefix_0"]["c_kv"]
        assert c.shape[:3] == (1, 2, 20)
        assert bool(c[0, 0].any()) and bool(c[0, 1].any())


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_answers_every_request(arch, capsys):
    serve_cli.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                    "--max-new", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    for i, line in enumerate(lines):
        assert line.startswith(f"req {i}: [")
        ids = eval(line.split("->")[1])
        assert len(ids) == 4 and all(0 <= t < 512 for t in ids)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_the_reduced_config(arch, capsys):
    train_cli.main(["--arch", arch, "--nodes", "4", "--steps", "3",
                    "--global-batch", "8", "--seq-len", "16", "--H", "3",
                    "--comm-backend", "pallas", "--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if " step " in ln]
    assert len(lines) == 3
    for line in lines:
        loss = float(line.split("loss=")[1].split()[0])
        assert np.isfinite(loss) and 5.0 < loss < 8.0, line
