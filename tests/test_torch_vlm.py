"""Port parity: the VLM stub (llava-next-mistral-7b: a Mistral decoder
whose first ``n_img`` positions take pre-projected patch embeddings) at
its reduced config, JAX vs ``repro_torch`` on the CPU — configs and size,
the ``patches`` batches, forward and the per-node loss with patches, a
Trainer step, the edges S < n_img and S = n_img, the engine (tokens
only) and both launchers.

Weights are drawn by the JAX package and carried across with
``repro_torch.interop``; batches are the synthetic stream's.

Tolerances:
* the batches (``inputs``, ``targets``, ``patches``): bitwise;
* float32 compute: logits within 2e-5 · max|ref|, the per-node loss, ce
  and z-loss rtol 1e-5 (the same math, reductions summed in another
  order); greedy ids equal;
* bf16 compute: logits within 5e-2 · max|ref|, the loss rtol 1e-3 (bf16
  rounds after every product, in differently fused places);
* one Trainer step (SGD, float32) against the JAX Trainer: the loss rtol
  1e-5, the params rtol 1e-5 with atol 1e-7.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import DataConfig as JData
from repro.configs import get_model_config as jax_config
from repro.data.synthetic import make_stream as jax_stream
from repro.models import make_model as jax_make_model
from repro.serve import Engine as JEngine
from repro_torch import interop
from repro_torch.configs import DataConfig, get_model_config
from repro_torch.data.synthetic import make_stream
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models.model import make_model
from repro_torch.serve import Engine
from repro_torch.tree import tree_map

torch.set_num_threads(2)

ARCH = "llava-next-mistral-7b"
N_IMG = 32                          # the reduced config's 2 tiles x 16


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jax_config(ARCH, reduced=True), dtype=dtype),
            dataclasses.replace(get_model_config(ARCH, reduced=True),
                                dtype=dtype))


def _models(dtype="float32"):
    jc, tc = _cfgs(dtype)
    return jax_make_model(jc), make_model(tc)


_WEIGHTS = {}


def _weights():
    if not _WEIGHTS:
        jm, _ = _models()
        _WEIGHTS["w"] = jax.device_get(
            jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(0)))
    return _WEIGHTS["w"]


def _batches(n, per_node, S, step=0):
    """The step's batch from each package's stream (numpy)."""
    jc, tc = _cfgs()
    j = jax_stream(jc, JData(), n_nodes=n, global_batch=n * per_node,
                   seq_len=S).get_batch(step)
    t = make_stream(tc, DataConfig(), n_nodes=n,
                    global_batch=n * per_node, seq_len=S).get_batch(step)
    return j, t


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, rel):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def _stacked(n):
    w = interop.from_numpy(_weights(), "cpu")
    return tree_map(lambda t: t.expand((n,) + t.shape).clone(), w)


def _jax_node_losses(jm, batch, z_loss=0.0):
    """The reference Trainer's per-node loss: ``Model.loss`` vmapped over
    the nodes, each with the same weights."""
    w = jax.tree.map(jnp.asarray, _weights())
    return jax.jit(jax.vmap(
        lambda b: jm.loss(w, b, z_loss=z_loss)))(batch)


# ---------------------------------------------------------------------------
# Configs, size, batches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", (False, True))
def test_config_equals_reference(reduced):
    want = jax_config(ARCH, reduced=reduced)
    got = get_model_config(ARCH, reduced=reduced)
    names = {f.name for f in dataclasses.fields(got)}
    assert names == {f.name for f in dataclasses.fields(want)}
    for name in sorted(names):
        g, w = getattr(got, name), getattr(want, name)
        if dataclasses.is_dataclass(w):
            assert dataclasses.asdict(g) == dataclasses.asdict(w), name
        else:
            assert g == w, name
    # no long_context_config: the keyword is ignored, as in the reference
    assert get_model_config(ARCH, reduced=reduced, long_context=True) == got
    assert jax_config(ARCH, reduced=reduced, long_context=True) == want
    make_model(got)


def test_full_param_count():
    """7,241,732,096 params (28.97 GB in float32) from the reference's own
    init (``jax.eval_shape``), and 2,880 image positions."""
    cfg = jax_config(ARCH)
    jm = jax_make_model(cfg)
    shapes = jax.eval_shape(lambda k: jm.init(k)[0], jax.random.PRNGKey(0))
    count = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    tcfg = get_model_config(ARCH)
    d, hd = tcfg.d_model, tcfg.resolved_head_dim
    layer = (2 * d * tcfg.n_heads * hd + 2 * d * tcfg.n_kv_heads * hd
             + 3 * d * tcfg.d_ff + 2 * d)
    assert count == 7_241_732_096 == \
        2 * tcfg.vocab_size * d + d + tcfg.n_layers * layer
    v = tcfg.vision
    assert v.n_tiles * v.patches_per_tile == 2880


@pytest.mark.parametrize("step", (0, 3))
def test_patches_batches_are_bitwise_the_references(step):
    j, t = _batches(2, 3, 40, step)
    assert sorted(t) == sorted(j) == ["inputs", "patches", "targets"]
    for name in j:
        assert t[name].dtype == j[name].dtype, name
        np.testing.assert_array_equal(t[name], j[name])
    assert t["patches"].shape == (2, 3, N_IMG, 256)


# ---------------------------------------------------------------------------
# Forward and loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_forward_with_patches_matches_reference(dtype):
    """One node's batch: the logits with the patches in place of the first
    32 embeddings, and that they differ from a token-only forward."""
    jm, tm = _models(dtype)
    j, _ = _batches(1, 2, 40)
    jb = {k: v[0] for k, v in j.items()}
    w = _weights()
    jl, _, _ = jax.jit(lambda p, b: jm.forward(p, b))(w, jb)
    tb = {k: torch.from_numpy(v) for k, v in j.items()}
    tl, _, _ = tm.forward(tree_map(lambda t: t[None],
                                   interop.from_numpy(w, "cpu")), tb)
    _close(tl[0], jl, 2e-5 if dtype == "float32" else 5e-2)
    plain, _, _ = tm.forward(tree_map(lambda t: t[None],
                                      interop.from_numpy(w, "cpu")),
                             {"inputs": tb["inputs"]})
    assert not torch.allclose(plain[:, :, N_IMG:], tl[:, :, N_IMG:])


@pytest.mark.parametrize("z_loss", (0.0, 1e-4))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_node_losses_match_reference(dtype, z_loss):
    """``Model.node_losses`` on 3 nodes against the reference's loss
    vmapped over them: the image positions weigh 0, each node divides by
    its own count of text positions; the z-loss weighted the same."""
    jm, tm = _models(dtype)
    j, _ = _batches(3, 2, 40)
    jl, jmet = _jax_node_losses(jm, j, z_loss)
    tl, tmet = tm.node_losses(_stacked(3), interop.from_numpy(j, "cpu"),
                              z_loss=z_loss)
    rtol = 1e-5 if dtype == "float32" else 1e-3
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=rtol)
    for name in ("ce",) + (("z_loss",) if z_loss else ()):
        np.testing.assert_allclose(tmet[name].numpy(),
                                   np.asarray(jmet[name]), rtol=rtol)


def test_short_batch_raises_and_image_only_batch_matches():
    """S < n_img raises ``ValueError`` (the reference builds a sequence
    longer than its targets and fails later); S = n_img runs with every
    position weighted 0, as in the reference: ce 0, the loss 0, the
    z-loss 0."""
    jm, tm = _models()
    j, _ = _batches(2, 1, N_IMG - 1)
    with pytest.raises(ValueError, match="shorter than its 32 patches"):
        tm.node_losses(_stacked(2), interop.from_numpy(j, "cpu"))
    j, _ = _batches(2, 1, N_IMG)
    jl, jmet = _jax_node_losses(jm, j, 1e-4)
    tl, tmet = tm.node_losses(_stacked(2), interop.from_numpy(j, "cpu"),
                              z_loss=1e-4)
    np.testing.assert_array_equal(np.asarray(jl), 0.0)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tmet["z_loss"].numpy(),
                                  np.asarray(jmet["z_loss"]))


# ---------------------------------------------------------------------------
# Trainer, engine, launchers
# ---------------------------------------------------------------------------
def test_trainer_step_matches_reference():
    """One step of Gossip-PGA on 4 nodes with the stream's patches, SGD,
    float32, fused backend, against the JAX Trainer from the same
    weights."""
    from repro.configs import base as jcfg
    from repro.train.trainer import Trainer as JTrainer
    from repro_torch.configs import base as tcfg
    from repro_torch.train import Trainer as TTrainer

    n = 4
    dist = dict(algorithm="gossip_pga", topology="one_peer_exp", H=2,
                comm_backend="pallas")
    opt = dict(name="sgd", lr=0.05, schedule="constant", warmup_steps=0)
    common = dict(global_batch=8, seq_len=48, log_every=1)
    jc, tc = _cfgs()
    jt = jcfg.TrainConfig(model=jc, dist=jcfg.DistConfig(**dist),
                          optimizer=jcfg.OptimizerConfig(**opt), **common)
    tt = tcfg.TrainConfig(model=tc, dist=tcfg.DistConfig(**dist),
                          optimizer=tcfg.OptimizerConfig(**opt), **common)
    jtr = JTrainer(jt, n_nodes=n, with_consensus=True)
    jst = jtr.init_state(jax.random.PRNGKey(0))
    row0 = jax.tree.map(lambda p: np.asarray(p[0]),
                        jax.device_get(jst.params))
    jst = jtr.run(jst, steps=1, log_every=1)
    ttr = TTrainer(tt, n_nodes=n, with_consensus=True, device="cpu")
    assert "patches" in ttr.device_batch(0)
    tst = ttr.init_state(params=interop.from_numpy(row0, "cpu"))
    tst = ttr.run(tst, steps=1, log_every=1)
    np.testing.assert_allclose(ttr.history[0]["loss"],
                               jtr.history[0]["loss"], rtol=1e-5)
    for a, b in zip(jax.tree.leaves(jax.device_get(jst.params)),
                    jax.tree.leaves(interop.to_numpy(tst.params))):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7)


def test_engine_generate_takes_tokens_and_matches_reference():
    jm, tm = _models()
    w = _weights()
    prompts = np.random.default_rng(7).integers(0, 512, (2, 11)).astype(
        np.int32)
    want = JEngine(jm, s_max=24).generate(jax.tree.map(jnp.asarray, w),
                                          jnp.asarray(prompts), n_new=6)
    got = Engine(tm, s_max=24).generate(interop.from_numpy(w, "cpu"),
                                        prompts, n_new=6)
    np.testing.assert_array_equal(got, want)


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
                    "--global-batch", "8", "--seq-len", "48", "--H", "3",
                    "--comm-backend", "pallas", "--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if " step " in ln]
    assert len(lines) == 3
    for line in lines:
        loss = float(line.split("loss=")[1].split()[0])
        assert np.isfinite(loss) and 5.0 < loss < 8.0, line
