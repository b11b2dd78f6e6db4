"""Port parity: serving xlstm-125m (reduced), JAX vs ``repro_torch`` on the
CPU — the model's prefill and decode, the engine, the batched server and
the CLI.

Weights are drawn by the JAX package and carried across with
``repro_torch.interop``; prompts are numpy from a seed.  The JAX model's
mLSTM kernel (``use_pallas_mlstm=True``) runs in interpret mode.

Tolerances: at float32 compute, logits and every cache leaf within
2e-5 · max|ref| (measured ≤ 1.5e-6: the same math, sums in another order)
and greedy ids equal; at bf16 compute (the production setting) both round
activations to bf16 after every matmul, but in differently fused places,
so logits agree within 5e-2 · max|ref| (measured ≤ 1.5e-2) and cache
leaves within 3e-2 · max|ref| (measured ≤ 1.3e-2).
"""
import dataclasses
import json

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
from repro_torch.models.model import make_model
from repro_torch.serve import BatchedServer, Engine, Request, pad_cache_to
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(2)

ARCH = "xlstm-125m"


def _models(dtype, pallas=True):
    jc = jax_config(ARCH, reduced=True)
    tc = get_model_config(ARCH, reduced=True)
    jc = dataclasses.replace(jc, dtype=dtype, ssm=dataclasses.replace(
        jc.ssm, use_pallas_mlstm=pallas))
    tc = dataclasses.replace(tc, dtype=dtype, ssm=dataclasses.replace(
        tc.ssm, use_pallas_mlstm=pallas))
    return jax_make_model(jc), make_model(tc)


@pytest.fixture(scope="module")
def weights():
    """One JAX init (seed 0), as numpy; every test carries it across."""
    jm, _ = _models("float32")
    params, _ = jm.init(jax.random.PRNGKey(0))
    return jax.device_get(params)


def _prompts(B, S, seed):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, rel):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def _node(tree):
    return tree_map(lambda t: t[None], tree)


def _check_caches(tcaches, jcaches, rel):
    """Port caches (node axis first) against the reference's, leaf by leaf
    in sorted-key order, dtypes included."""
    jleaves = jax.tree.leaves(jcaches)
    tleaves = tree_leaves(tcaches)
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        assert str(t.dtype).split(".")[-1] == str(j.dtype), (t.dtype,
                                                              j.dtype)
        _close(t[0], j, rel)


# ---------------------------------------------------------------------------
# (e) Model.forward(mode="prefill") and decode_step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,rel,crel", [("float32", 2e-5, 2e-5),
                                            ("bfloat16", 5e-2, 3e-2)])
def test_prefill_and_decode_match(weights, dtype, rel, crel):
    jm, tm = _models(dtype)
    jp = jax.tree.map(jnp.asarray, weights)
    tp = _node(interop.from_numpy(weights, "cpu"))
    toks = _prompts(2, 21, 1)
    jl, jc, _ = jax.jit(lambda p, t: jm.forward(
        p, {"inputs": t}, mode="prefill", want_cache=True))(jp, toks)
    tl, tc, lb = tm.forward(tp, {"inputs": torch.from_numpy(toks)[None]},
                            mode="prefill", want_cache=True)
    assert float(lb) == 0.0
    _close(tl[0], jl, rel)
    _check_caches(tc, jc, crel)
    # four decode steps, each side from its own state
    jstep = jax.jit(jm.decode_step)
    nxt = _prompts(2, 4, 2)
    for t in range(4):
        pos = np.full((2,), 21 + t, np.int32)
        jl, jc = jstep(jp, jc, nxt[:, t:t + 1], pos)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(
            nxt[:, t:t + 1])[None], torch.from_numpy(pos))
        _close(tl[0], jl, rel)
        _check_caches(tc, jc, crel)


def test_decode_from_reference_cache(weights):
    """The reference's bf16 prefill cache carried across with ``interop``
    (bf16 leaves included) decodes in the port as in the reference."""
    jm, tm = _models("bfloat16")
    jp = jax.tree.map(jnp.asarray, weights)
    tp = _node(interop.from_numpy(weights, "cpu"))
    toks = _prompts(2, 9, 3)
    _, jc, _ = jm.forward(jp, {"inputs": toks}, mode="prefill",
                          want_cache=True)
    tc = _node(interop.from_numpy(jax.device_get(jc), "cpu"))
    _check_caches(tc, jc, 0.0)
    pos = np.full((2,), 9, np.int32)
    jl, jc = jm.decode_step(jp, jc, toks[:, :1], pos)
    tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, :1])[None],
                            torch.from_numpy(pos))
    _close(tl[0], jl, 5e-2)
    _check_caches(tc, jc, 3e-2)


def test_prefill_then_decode_matches_forward(weights):
    """Port-internal path equality at float32: decoding token by token after
    a prefill reproduces the full-sequence logits (2e-5 · max|ref|)."""
    _, tm = _models("float32")
    tp = _node(interop.from_numpy(weights, "cpu"))
    toks = torch.from_numpy(_prompts(2, 12, 4))[None]
    full, _, _ = tm.forward(tp, {"inputs": toks})
    _, caches, _ = tm.forward(tp, {"inputs": toks[:, :, :6]},
                              mode="prefill", want_cache=True)
    for t in range(6, 12):
        logits, caches = tm.decode_step(
            tp, caches, toks[:, :, t:t + 1],
            torch.full((2,), t, dtype=torch.int32))
        _close(logits[0, :, 0], full[0, :, t], 2e-5)


def test_train_mode_loss_matches(weights):
    """The trainer's call on the xLSTM family: ``Model.loss`` at float32
    against the reference's (rtol 1e-5; the scan, not the kernel, which
    has no gradient)."""
    jm, tm = _models("float32", pallas=False)
    toks = _prompts(2, 17, 5)
    batch = {"inputs": toks, "targets": np.roll(toks, -1, axis=1)}
    jl, _ = jm.loss(jax.tree.map(jnp.asarray, weights), batch)
    tl, _ = tm.loss(interop.from_numpy(weights, "cpu"),
                    interop.from_numpy(batch, "cpu"))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


# ---------------------------------------------------------------------------
# (f) Engine and BatchedServer
# ---------------------------------------------------------------------------
def test_engine_generate_matches_reference(weights):
    """Greedy ids at float32 equal the reference engine's; prefill logits
    and caches through ``Engine.prefill`` in the reference's layout."""
    jm, tm = _models("float32")
    prompts = _prompts(2, 11, 6)
    jeng, teng = JEngine(jm, s_max=32), Engine(tm, s_max=32)
    jp = jax.tree.map(jnp.asarray, weights)
    tp = interop.from_numpy(weights, "cpu")
    want = jeng.generate(jp, jnp.asarray(prompts), n_new=6)
    got = teng.generate(tp, prompts, n_new=6)
    np.testing.assert_array_equal(got, want)
    jl, jc = jeng.prefill(jp, jnp.asarray(prompts))
    tl, tc = teng.prefill(tp, torch.from_numpy(prompts))
    _close(tl, jl, 2e-5)
    _check_caches(_node(tc), jc, 2e-5)


def test_engine_bf16_logits_within_tolerance(weights):
    jm, tm = _models("bfloat16")
    prompts = _prompts(2, 11, 7)
    jl, _ = JEngine(jm, s_max=32).prefill(jax.tree.map(jnp.asarray, weights),
                                          jnp.asarray(prompts))
    tl, _ = Engine(tm, s_max=32).prefill(interop.from_numpy(weights, "cpu"),
                                         torch.from_numpy(prompts))
    _close(tl, jl, 5e-2)


def test_batched_server_matches_reference(weights):
    """3 requests of different prompt lengths on 2 slots, float32 greedy:
    the same ids as the reference's server, and as one-at-a-time
    generation."""
    jm, tm = _models("float32")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 512, size=s).astype(np.int32)
               for s in (5, 9, 3)]
    jsrv = JBatchedServer(JEngine(jm, s_max=24),
                          jax.tree.map(jnp.asarray, weights), n_slots=2)
    want = sorted(jsrv.run([JRequest(uid=i, prompt=p, max_new=4)
                            for i, p in enumerate(prompts)]),
                  key=lambda r: r.uid)
    teng = Engine(tm, s_max=24)
    tp = interop.from_numpy(weights, "cpu")
    got = sorted(BatchedServer(teng, tp, n_slots=2).run(
        [Request(uid=i, prompt=p, max_new=4) for i, p in enumerate(prompts)]),
        key=lambda r: r.uid)
    assert [r.uid for r in got] == [0, 1, 2]
    for g, w, p in zip(got, want, prompts):
        assert g.done and g.generated == w.generated
        np.testing.assert_array_equal(
            g.generated, teng.generate(tp, p[None], n_new=4)[0])


def test_sampling_draws_from_the_generator(weights):
    """temperature > 0 draws from the explicit generator: the same seed
    gives the same ids, another seed other ids; without a generator it is
    greedy."""
    _, tm = _models("float32")
    eng, tp = Engine(tm, s_max=32), interop.from_numpy(weights, "cpu")
    prompts = _prompts(4, 5, 9)

    def draw(seed):
        return eng.generate(tp, prompts, n_new=6, temperature=5.0,
                            generator=torch.Generator().manual_seed(seed))

    np.testing.assert_array_equal(draw(1), draw(1))
    assert not np.array_equal(draw(1), draw(2))
    np.testing.assert_array_equal(
        eng.generate(tp, prompts, n_new=3, temperature=5.0),
        eng.generate(tp, prompts, n_new=3))
    logits = torch.tensor([[0.0, 50.0, 0.0], [0.0, 0.0, 0.0]])
    picks = torch.stack([Engine._sample(
        logits, 1.0, torch.Generator().manual_seed(s)) for s in range(60)])
    assert (picks[:, 0] == 1).all()
    assert len(set(picks[:, 1].tolist())) == 3


def test_pad_cache_to_matches_reference():
    """Attention-shaped leaves grow to s_max along their sequence axis;
    every other leaf (the recurrent states) is returned unchanged."""
    rng = np.random.default_rng(10)
    tree = {"scan": {"entry_0": {
        "k": rng.standard_normal((2, 3, 5, 2, 4)).astype(np.float32),
        "v": rng.standard_normal((2, 3, 5, 2, 4)).astype(np.float32),
        "C": rng.standard_normal((2, 3, 2, 4, 4)).astype(np.float32),
        "c_kv": rng.standard_normal((2, 3, 5, 8)).astype(np.float32)}}}
    want = jax.device_get(jax_pad_cache_to(
        jax.tree.map(jnp.asarray, tree), 9))
    got = interop.to_numpy(pad_cache_to(interop.from_numpy(tree, "cpu"), 9))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)


def test_server_telemetry_raises(weights):
    """The server's telemetry (ROADMAP A.6, ported): a hub gets one
    ``serve_req`` record per retired request and the serve spans, and the
    answers are those of a server without one."""
    from repro_torch import obs
    _, tm = _models("float32")
    outs = []
    for tel in (None, obs.Telemetry(sinks=[obs.RingSink()])):
        server = BatchedServer(Engine(tm, s_max=8),
                               interop.from_numpy(weights, "cpu"),
                               n_slots=1, telemetry=tel)
        done = server.run([Request(uid=i, prompt=_prompts(1, 3, i)[0],
                                   max_new=2) for i in range(2)])
        outs.append(sorted((r.uid, r.generated) for r in done))
    assert outs[0] == outs[1]
    assert sorted(r["uid"] for r in tel.ring().records("serve_req")) == [0,
                                                                         1]
    assert {e["name"] for e in tel.tracer.events} == {"serve/prefill",
                                                      "serve/decode"}


# ---------------------------------------------------------------------------
# (g) the CLI
# ---------------------------------------------------------------------------
def test_serve_cli_answers_every_request(capsys):
    serve_cli.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                    "--slots", "2", "--max-new", "5"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("req ")]
    assert [ln.split(":")[0] for ln in lines] == ["req 0", "req 1", "req 2"]
    for ln in lines:
        prompt, gen = ln.split(": ", 1)[1].split(" -> ")
        assert len(eval(prompt)) == 6 and len(eval(gen)) == 5


def test_serve_cli_unported_flags_raise(tmp_path, capsys):
    """The serving CLI's telemetry flags (ROADMAP A.6, ported) run on the
    CPU and write their files: one ``serve_req`` line per request and a
    Chrome trace with the serve spans."""
    trace = tmp_path / "t.json"
    serve_cli.main(["--arch", ARCH, "--device", "cpu", "--requests", "2",
                    "--max-new", "3", "--telemetry-dir", str(tmp_path),
                    "--trace", str(trace)])
    recs = [json.loads(ln) for ln in open(tmp_path / "telemetry.jsonl")]
    assert sorted(r["uid"] for r in recs) == [0, 1]
    assert {r["type"] for r in recs} == {"serve_req"}
    names = {e["name"] for e in json.load(open(trace))["traceEvents"]}
    assert names == {"serve/prefill", "serve/decode"}
    assert "req 1:" in capsys.readouterr().out
