"""Port parity: the hybrid family (jamba-1.5-large-398b: Mamba and
attention 7:1, MoE on alternate layers) at its reduced config, JAX vs
``repro_torch`` on the CPU — configs and sizes, init, forward and
``lb_loss`` (either ``scan_dtype``), prefill → decode, the engine, the
batched server, both launchers, and the bf16 params across ``interop``
and both checkpoint formats (the Trainer is held in
``tests/test_torch_hybrid_train.py``).

Weights are drawn by the JAX package and carried across with
``repro_torch.interop``; prompts and batches are numpy from a seed.

Tolerances:
* float32 compute: logits and every cache leaf within 2e-5 · max|ref|;
  ``lb_loss`` rtol 1e-5 (the same math; ``F.softplus``/``F.silu`` an ulp
  from ``jax.nn``'s, reductions summed in another order); greedy ids
  equal;
* bf16 compute, or the bf16 scan: logits within 5e-2 · max|ref| and
  ``lb_loss`` rtol 5e-3 (bf16 rounds after every product, in differently
  fused places; through eight layers the balance loss drifts by 2e-3);
* prefill → decode against the port's own forward: drop-free
  (``capacity_factor = n_routed``, as ``tests/test_decode_consistency.py``
  pins it) and float32, 2e-5 · max|fwd|;
* bf16 params: across ``interop`` and through either package's checkpoint
  bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.configs import get_model_config as jax_config
from repro.models import make_model as jax_make_model
from repro.serve import BatchedServer as JBatchedServer
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import pad_cache_to as jax_pad_cache_to
from repro.train.state import TrainState as JState
from repro_torch import interop
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_model_config
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models.model import make_model
from repro_torch.serve import BatchedServer, Engine, Request, pad_cache_to
from repro_torch.train.state import TrainState
from repro_torch.tree import tree_flatten, tree_leaves, tree_map

torch.set_num_threads(2)

ARCH = "jamba-1.5-large-398b"
# the card's cuts at full width (chip_smoke.py [jserve], [jtrain]; the
# two-layer cut is the one [jtrain] could not hold)
SERVE_PATTERN = (("mamba", "dense"), ("mamba", "moe"), ("attn", "dense"))
TRAIN_PATTERN = (("mamba", "dense"),)
TWO_LAYER_PATTERN = (("mamba", "dense"), ("attn", "dense"))


def _cfgs(dtype="float32", drop_free=False, scan_dtype="float32"):
    out = []
    for get in (jax_config, get_model_config):
        cfg = dataclasses.replace(get(ARCH, reduced=True), dtype=dtype)
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, scan_dtype=scan_dtype))
        if drop_free:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(cfg.moe.n_routed)))
        out.append(cfg)
    return out


def _models(**kw):
    jc, tc = _cfgs(**kw)
    return jax_make_model(jc), make_model(tc)


_WEIGHTS = {}


def _weights():
    """One JAX init (seed 0) as numpy, shared by the tests."""
    if not _WEIGHTS:
        jm, _ = _models()
        _WEIGHTS["w"] = jax.device_get(
            jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(0)))
    return _WEIGHTS["w"]


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


def _count(cfg) -> int:
    jm = jax_make_model(cfg)
    shapes = jax.eval_shape(lambda k: jm.init(k)[0], jax.random.PRNGKey(0))
    return sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))


# ---------------------------------------------------------------------------
# Configs, sizes, init
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ("full", "reduced", "long_context"))
def test_config_equals_reference(kind):
    kw = {"reduced": kind == "reduced",
          "long_context": kind == "long_context"}
    want, got = jax_config(ARCH, **kw), get_model_config(ARCH, **kw)
    names = {f.name for f in dataclasses.fields(got)}
    assert names == {f.name for f in dataclasses.fields(want)}
    for name in sorted(names):
        g, w = getattr(got, name), getattr(want, name)
        if dataclasses.is_dataclass(w):
            assert dataclasses.asdict(g) == dataclasses.asdict(w), name
        else:
            assert g == w, name
    assert got.family == "hybrid" and got.param_dtype == "bfloat16" \
        or kind == "reduced"
    make_model(got)


@pytest.mark.parametrize("pattern,n_layers,count", (
    (None, 72, 398_555_111_424),
    (SERVE_PATTERN, 3, 12_937_224_192),
    (TRAIN_PATTERN, 1, 2_098_077_696),
    (TWO_LAYER_PATTERN, 2, 2_853_068_800)))
def test_full_width_param_counts(pattern, n_layers, count):
    """The published size and the card's two cuts at full width, reckoned
    from the reference's own init (``jax.eval_shape``) and from the port's
    config; the port's init tree has the same leaves at the reduced
    config (11,309,824 params)."""
    cfg = jax_config(ARCH)
    tcfg = get_model_config(ARCH)
    if pattern is not None:
        cfg = dataclasses.replace(cfg, pattern=pattern, n_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, pattern=pattern, n_layers=n_layers)
    assert _count(cfg) == count
    d, m = tcfg.d_model, tcfg.moe
    di, N = tcfg.ssm.expand * d, tcfg.ssm.d_state
    R = d // 16
    hd, nh, nkv = tcfg.resolved_head_dim, tcfg.n_heads, tcfg.n_kv_heads
    mixer = {"mamba": (d * 2 * di + tcfg.ssm.d_conv * di + di
                       + di * (R + 2 * N) + R * di + di + di * N + di
                       + di * d),
             "attn": 2 * d * nh * hd + 2 * d * nkv * hd}
    ffn = {"dense": 3 * d * tcfg.d_ff,
           "moe": d * m.n_routed + 3 * m.n_routed * d * m.d_ff_expert}
    total = 2 * tcfg.vocab_size * d + d + sum(
        mixer[a] + ffn[f] + 2 * d for a, f in tcfg.layers)
    assert tcfg.n_layers == n_layers and total == count


def test_init_keys_and_shapes_match_reference():
    _, tm = _models()
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        _weights())
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    got = tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), params)
    assert got == want
    assert sum(t.numel() for t in tree_leaves(params)) == 11_309_824
    mixer = got["stack"]["scan"]["entry_0"]["mixer"]
    assert mixer["A_log"][0] == (1, 512, 8)


def test_bf16_params_cross_and_checkpoint_bitwise(tmp_path):
    """jamba is the one bf16-param config: the reduced config at
    ``param_dtype="bfloat16"`` crosses from the reference exactly and back,
    and saves and restores through both packages' checkpoint formats
    bitwise (the bf16 bit views)."""
    jc = dataclasses.replace(jax_config(ARCH, reduced=True),
                             param_dtype="bfloat16")
    tc = dataclasses.replace(get_model_config(ARCH, reduced=True),
                             param_dtype="bfloat16")
    jw = jax.device_get(jax.jit(lambda k: jax_make_model(jc).init(k)[0])(
        jax.random.PRNGKey(1)))
    tp = interop.from_numpy(jw, "cpu")
    tree = make_model(tc).init(torch.Generator().manual_seed(1), "cpu")
    assert tree_map(lambda t: t.dtype, tree) == tree_map(lambda t: t.dtype,
                                                         tp)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tp))

    def bits(t):
        return t.contiguous().reshape(-1).view(torch.int16).numpy()

    want = [np.asarray(a).reshape(-1).view(np.int16)
            for a in jax.tree.leaves(jw)]
    assert all(np.array_equal(bits(t), w)
               for t, w in zip(tree_leaves(tp), want))
    back = interop.to_numpy(tp)
    assert all(np.array_equal(a, np.asarray(b, np.float32)) for a, b in
               zip(jax.tree.leaves(back), jax.tree.leaves(jw)))
    for writer in ("port", "jax"):
        d = str(tmp_path / writer)
        if writer == "port":
            save_checkpoint(d, TrainState(params=tp, opt_state={},
                                          step=2, extras={}), 2)
        else:
            jsave(d, JState(params=jax.tree.map(jnp.asarray, jw),
                            opt_state={}, step=jnp.asarray(2, jnp.int32),
                            extras={}), 2)
        got = restore_checkpoint(d, TrainState(
            params=tree_map(torch.zeros_like, tp), opt_state={}, step=0,
            extras={}))
        leaves, _ = tree_flatten(got.params)
        assert all(t.dtype == torch.bfloat16 and np.array_equal(bits(t), w)
                   for t, w in zip(leaves, want)), writer
        jgot = jrestore(d, JState(params=jax.tree.map(jnp.zeros_like, jw),
                                  opt_state={},
                                  step=jnp.asarray(0, jnp.int32),
                                  extras={}))
        assert all(np.array_equal(np.asarray(a).reshape(-1).view(np.int16),
                                  w) for a, w in
                   zip(jax.tree.leaves(jgot.params), want)), writer


# ---------------------------------------------------------------------------
# Forward and lb_loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,scan_dtype", (
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")))
def test_forward_and_lb_loss_match_reference(dtype, scan_dtype):
    jm, tm = _models(dtype=dtype, scan_dtype=scan_dtype)
    w = _weights()
    toks = _prompts(2, 13, 1)
    jl, _, jlb = jax.jit(lambda p, t: jm.forward(p, {"inputs": t}))(
        w, toks)
    tl, caches, tlb = tm.forward(_node(interop.from_numpy(w, "cpu")),
                                 {"inputs": torch.from_numpy(toks)[None]})
    assert caches is None and tlb.shape == (1,) and float(tlb[0]) > 0.0
    if dtype == scan_dtype == "float32":
        _close(tl[0], jl, 2e-5)
        np.testing.assert_allclose(float(tlb[0]), float(jlb), rtol=1e-5)
    else:
        _close(tl[0], jl, 5e-2)
        np.testing.assert_allclose(float(tlb[0]), float(jlb), rtol=5e-3)


# ---------------------------------------------------------------------------
# Prefill, decode and caches
# ---------------------------------------------------------------------------
def test_prefill_and_decode_match_reference():
    """Prefill caches (the attention layer's KV beside seven Mamba
    layers' conv windows and h) and four decode steps at float32, each
    package from its own state; positions differ between the two rows."""
    jm, tm = _models()
    w = _weights()
    jp, tp = jax.tree.map(jnp.asarray, w), _node(interop.from_numpy(w,
                                                                    "cpu"))
    toks = _prompts(2, 9, 2)
    jl, jc, _ = jax.jit(lambda p, t: jm.forward(
        p, {"inputs": t}, mode="prefill", want_cache=True))(jp, toks)
    tl, tc, _ = tm.forward(tp, {"inputs": torch.from_numpy(toks)[None]},
                           mode="prefill", want_cache=True)
    _close(tl[0], jl, 2e-5)
    assert sorted(tc["scan"]["entry_0"]) == ["conv", "h"]
    assert sorted(tc["scan"]["entry_4"]) == ["k", "v"]
    for t, j in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        _close(t[0], j, 2e-5)
    jc, tc = jax_pad_cache_to(jc, 16), pad_cache_to(tc, 16)
    assert tc["scan"]["entry_0"]["h"].shape == (1, 1, 2, 512, 8)
    assert tc["scan"]["entry_4"]["k"].shape[3] == 16
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


def test_prefill_then_decode_matches_forward():
    """The port's counterpart of ``tests/test_decode_consistency.py``'s
    jamba case, drop-free and float32 as the reference pins MoE configs
    there: prompt of 6, decode of positions 6..11 against one full
    forward."""
    _, tm = _models(drop_free=True)
    tp = _node(interop.from_numpy(_weights(), "cpu"))
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


def test_init_cache_matches_reference():
    jm, tm = _models(dtype="bfloat16")
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
def test_engine_generate_matches_reference():
    jm, tm = _models()
    w = _weights()
    prompts = _prompts(2, 11, 7)
    want = JEngine(jm, s_max=24).generate(jax.tree.map(jnp.asarray, w),
                                          jnp.asarray(prompts), n_new=6)
    got = Engine(tm, s_max=24).generate(interop.from_numpy(w, "cpu"),
                                        prompts, n_new=6)
    np.testing.assert_array_equal(got, want)


def test_batched_server_matches_reference():
    """Three requests of 5, 9 and 3 tokens on 2 slots (a slot reused, the
    idle slot decoding on): each admission writes the slot's rows of the
    Mamba states and the KV cache by their batch axis; greedy ids equal
    to the reference server's."""
    jm, tm = _models()
    w = _weights()
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
    h = tsrv.caches["scan"]["entry_0"]["h"]
    assert h.shape == (1, 1, 2, 512, 8)
    assert bool(h[0, 0, 0].any()) and bool(h[0, 0, 1].any())


def test_serve_cli_answers_every_request(capsys):
    serve_cli.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                    "--max-new", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    for i, line in enumerate(lines):
        assert line.startswith(f"req {i}: [")
        ids = eval(line.split("->")[1])
        assert len(ids) == 4 and all(0 <= t < 512 for t in ids)


def test_train_cli_runs_the_reduced_config(capsys):
    train_cli.main(["--arch", ARCH, "--nodes", "4", "--steps", "3",
                    "--global-batch", "8", "--seq-len", "16", "--H", "3",
                    "--comm-backend", "pallas", "--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if " step " in ln]
    assert len(lines) == 3
    for line in lines:
        loss = float(line.split("loss=")[1].split()[0])
        assert np.isfinite(loss) and 5.0 < loss < 8.0, line
