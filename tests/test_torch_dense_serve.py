"""Port parity: serving the dense decoders (pga-lm-100m, gemma2-9b,
qwen3-0.6b, qwen2-0.5b, qwen1.5-32b) at their reduced configs, JAX vs
``repro_torch`` on the CPU — ``Engine.generate``, ``BatchedServer`` and
the launcher.

Weights are drawn by the JAX package and carried across with
``repro_torch.interop``; prompts are numpy from a seed.  Tolerance: at
float32 compute the greedy ids equal the reference's exactly.
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
from repro_torch import interop
from repro_torch.configs import get_model_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models.model import make_model
from repro_torch.serve import BatchedServer, Engine, Request

torch.set_num_threads(2)

ARCHS = ("pga-lm-100m", "gemma2-9b", "qwen3-0.6b", "qwen2-0.5b",
         "qwen1.5-32b")


def _models(arch):
    jc = dataclasses.replace(jax_config(arch, reduced=True), dtype="float32")
    tc = dataclasses.replace(get_model_config(arch, reduced=True),
                             dtype="float32")
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


# ---------------------------------------------------------------------------
# Engine, BatchedServer, launcher
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
    idle slot decoding on), greedy ids equal to the reference server's."""
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


def test_idle_slot_runs_past_s_max():
    """An idle slot's position runs past ``S_max`` in a long run (the
    reference advances every slot's ``pos`` each tick): its writes land
    in the last row, clamped as XLA clamps, and the busy slot's answer
    stays the one a lone generate gives."""
    _, tm = _models("gemma2-9b")
    tp = interop.from_numpy(_weights("gemma2-9b"), "cpu")
    srv = BatchedServer(Engine(tm, s_max=12), tp, n_slots=2)
    for uid in range(4):
        prompt = _prompts(1, 4, 20 + uid)[0]
        done = srv.run([Request(uid=uid, prompt=prompt, max_new=7)])
        want = Engine(tm, s_max=12).generate(tp, prompt[None], n_new=7)
        assert done[0].generated == want[0].tolist()
    assert int(srv.pos[1]) == 24 > 12


@pytest.mark.parametrize("arch", ("gemma2-9b", "qwen3-0.6b", "qwen2-0.5b",
                                  "qwen1.5-32b", "pga-lm-100m"))
def test_serve_cli_answers_every_request(arch, capsys):
    serve_cli.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                    "--max-new", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    for i, line in enumerate(lines):
        assert line.startswith(f"req {i}: [")
        ids = eval(line.split("->")[1])
        assert len(ids) == 4 and all(0 <= t < 512 for t in ids)
