"""Port parity: optimizers, synthetic data and multi-step training, JAX vs
``repro_torch`` on the CPU.

Tolerances, with their reasons:
* optimizer updates are elementwise fp32 arithmetic on the same inputs:
  rtol 1e-6.  AdamW's bias correction ``1 − 0.999^count`` cancels, and
  XLA's fp32 pow and PyTorch's differ by an ulp (up to 6e-5 relative in
  ``1 − 0.999``), so AdamW params also get atol 1e-4·lr;
* training runs 4 steps of Gossip-PGA (H = 2: gossip and global rounds)
  at fp32 compute from shared params.  Forward/backward reductions sum in
  another order.  With SGD that stays at rounding level: params rtol
  1e-5, atol 1e-7, metrics rtol 1e-5 (measured: 6e-8 and 3.3e-6).  AdamW
  divides each coordinate by sqrt(v) + eps, so where a gradient entry is
  within ~eps of zero its update swings with that summation noise: params
  atol 5e-2·lr, metrics rtol 1e-4 (measured: 1.6e-2·lr and 7.4e-6);
* compressed Gossip-PGA (int8 gossip and collective, error feedback) on
  the reduced pga-lm-100m, 3 steps of the two Trainers from shared
  weights.  The codes agree exactly on the same inputs, but the forward
  and backward sum in another order, and stochastic rounding turns a
  1-ulp difference that lands on a code boundary into one code step.
  So: every param and EF element within one code step (1e-3 here), all
  but 1e-5 of them within 1e-6 (measured: 2 of 5,772,288 params off by
  3.8e-4, 1 EF element by 7.5e-4, the rest ≤ 2.9e-7), consensus and loss
  rtol 1e-4 (measured 1.3e-5).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.core import schedule as jsched
from repro.data import make_stream as jstream
from repro.models.model import make_model as jmake
from repro.optim import optimizers as jopt
from repro.train import state as jstate
from repro.train.step import build_train_step as jbuild
from repro_torch import interop
from repro_torch.configs import base as tcfg_mod
from repro_torch.data import make_stream as tstream
from repro_torch.optim import optimizers as topt
from repro_torch.train.state import TrainState, stack_for_nodes
from repro_torch.train.step import build_train_step as tbuild

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
LR = 1e-3
TINY = dict(name="tiny", family="dense", citation="test", n_layers=2,
            d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
            vocab_size=256, tie_embeddings=True, dtype="float32")


def _trees(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 6, 5)).astype(np.float32),
            "b": rng.standard_normal((4, 7)).astype(np.float32)}


def _close(jtree, ttree, rtol, atol=0.0):
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(ttree)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ("sgd", "adamw"))
@pytest.mark.parametrize("nesterov", (True, False))
def test_optimizer_updates_match(name, nesterov):
    kw = dict(name=name, lr=0.05, nesterov=nesterov, weight_decay=0.01)
    jo = jopt.make_optimizer(jcfg.OptimizerConfig(**kw))
    to = topt.make_optimizer(tcfg_mod.OptimizerConfig(**kw))
    params = _trees(0)
    jp, tp = jax.tree.map(jnp.asarray, params), interop.from_numpy(params,
                                                                   "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for k in range(3):
        grads = _trees(10 + k)
        jp, js = jo.update(jax.tree.map(jnp.asarray, grads), js, jp, 0.05)
        tp, ts = to.update(interop.from_numpy(grads, "cpu"), ts, tp, 0.05)
        _close(jp, tp, rtol=1e-6, atol=1e-4 * 0.05 if name == "adamw"
               else 1e-7)
    if name == "adamw":
        assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 3


def test_clip_is_joint_over_nodes():
    grads = _trees(3)
    jc = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), 0.5)
    tc = topt.clip_by_global_norm(interop.from_numpy(grads, "cpu"), 0.5)
    _close(jc, tc, rtol=1e-6)
    total = np.sqrt(sum(float(np.sum(np.square(t.numpy())))
                        for t in jax.tree.leaves(tc)))
    assert abs(total - 0.5) < 1e-5      # one norm over all nodes' grads


@pytest.mark.parametrize("iid", (False, True))
def test_synthetic_batches_bit_identical(iid):
    from repro.configs import pga_lm_100m as jarch
    from repro_torch.configs import pga_lm_100m as tarch
    js = jstream(jarch.reduced_config(), jcfg.DataConfig(non_iid=not iid),
                 n_nodes=4, global_batch=8, seq_len=32)
    ts = tstream(tarch.reduced_config(),
                 tcfg_mod.DataConfig(non_iid=not iid), n_nodes=4,
                 global_batch=8, seq_len=32)
    for k in (0, 1, 7):
        jb, tb = js.get_batch(k), ts.get_batch(k)
        assert sorted(jb) == sorted(tb)
        for key in jb:
            assert tb[key].dtype == jb[key].dtype == np.int32
            np.testing.assert_array_equal(tb[key], jb[key])


def _configs(backend, optimizer):
    dist = dict(algorithm="gossip_pga", topology="one_peer_exp", H=2,
                comm_backend=backend, pallas_leaf_threshold=4096)
    opt = dict(name=optimizer, lr=LR, schedule="constant", warmup_steps=0)
    common = dict(global_batch=8, seq_len=16)
    j = jcfg.TrainConfig(model=jcfg.ModelConfig(**TINY),
                         dist=jcfg.DistConfig(**dist),
                         optimizer=jcfg.OptimizerConfig(**opt), **common)
    t = tcfg_mod.TrainConfig(model=tcfg_mod.ModelConfig(**TINY),
                             dist=tcfg_mod.DistConfig(**dist),
                             optimizer=tcfg_mod.OptimizerConfig(**opt),
                             **common)
    return j, t


@pytest.mark.parametrize("optimizer", ("sgd", "adamw"))
@pytest.mark.parametrize("backend", ("reference", "pallas"))
def test_train_steps_match_reference(backend, optimizer):
    """4 steps of build_train_step (gossip, global, gossip, global) from
    shared params: the port tracks the JAX trainer step."""
    n = 4
    jt, tt = _configs(backend, optimizer)
    p_tol = (dict(rtol=1e-5, atol=1e-7) if optimizer == "sgd"
             else dict(rtol=1e-5, atol=5e-2 * LR))
    m_rtol = 1e-5 if optimizer == "sgd" else 1e-4
    jm = jmake(jt.model)
    params, _ = jm.init(jax.random.PRNGKey(0))
    jparams = jstate.stack_for_nodes(params, n)
    jo = jopt.make_optimizer(jt.optimizer)
    jst = jstate.TrainState(params=jparams, opt_state=jo.init(jparams),
                            step=jnp.zeros((), jnp.int32), extras={})
    from repro_torch.models.model import make_model as tmake
    tm = tmake(tt.model)
    tparams = stack_for_nodes(
        interop.from_numpy(jax.device_get(params), "cpu"), n)
    tst = TrainState(params=tparams,
                     opt_state=topt.make_optimizer(tt.optimizer).init(
                         tparams), step=0)
    sched = jsched.PGASchedule(H=2)
    stream = jstream(jt.model, jt.data, n_nodes=n, global_batch=8,
                     seq_len=16)
    phases, jsteps = [], {}
    for k in range(4):
        phase, shift = sched.peek_phase(k), k % 2
        phases.append(phase)
        batch = stream.get_batch(k)
        if (phase, shift) not in jsteps:
            jsteps[phase, shift] = jax.jit(jbuild(
                jm, jt, n, phase=phase, shift_step=shift,
                with_consensus=True))
        jst, jmet = jsteps[phase, shift](
            jst, jax.tree.map(jnp.asarray, batch), jnp.float32(LR))
        tstep = tbuild(tm, tt, n, phase=phase, shift_step=shift,
                       with_consensus=True)
        tst, tmet = tstep(tst, interop.from_numpy(batch, "cpu"), LR)
        for key in ("loss", "grad_norm", "consensus"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=m_rtol)
        _close(jst.params, tst.params, **p_tol)
    assert phases == ["gossip", "global", "gossip", "global"]
    assert float(tmet["consensus"]) == 0.0
    assert tst.step == 4


def test_cli_runs_on_cpu_when_asked():
    """``python -m repro_torch.launch.train --device cpu``: the reference's
    per-step line, exact consensus 0 after each global round."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train",
         "--arch", "pga-lm-100m", "--nodes", "4", "--steps", "4",
         "--global-batch", "8", "--seq-len", "16", "--H", "2",
         "--comm-backend", "pallas", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if "] step" in ln]
    assert len(lines) == 4
    for k, line in enumerate(lines):
        assert line.startswith(f"[gossip_pga] step     {k} loss=")
        loss = float(line.split("loss=")[1].split()[0])
        assert np.isfinite(loss)
        if k % 2 == 1:
            assert "phase=global consensus=0.000e+00" in line
        else:
            assert "phase=gossip" in line


def test_compressed_trainer_matches_reference():
    """Reduced pga-lm-100m, 4 nodes, H = 2 (gossip, global, gossip), int8
    gossip + int8 collective with error feedback, fused backend: the port's
    Trainer on the CPU against the JAX Trainer from the same weights."""
    from repro.configs import pga_lm_100m as jarch
    from repro.train.trainer import Trainer as JTrainer
    from repro_torch.configs import pga_lm_100m as tarch
    from repro_torch.train import Trainer as TTrainer

    n = 4
    dist = dict(algorithm="gossip_pga", topology="one_peer_exp", H=2,
                comm_backend="pallas", comm_compression="int8",
                comm_global_compression="int8", comm_error_feedback=True)
    opt = dict(name="sgd", lr=0.05, schedule="constant", warmup_steps=0)
    common = dict(global_batch=8, seq_len=32, log_every=1)
    jt = jcfg.TrainConfig(
        model=dataclasses.replace(jarch.reduced_config(), dtype="float32"),
        dist=jcfg.DistConfig(**dist), optimizer=jcfg.OptimizerConfig(**opt),
        **common)
    tt = tcfg_mod.TrainConfig(
        model=dataclasses.replace(tarch.reduced_config(), dtype="float32"),
        dist=tcfg_mod.DistConfig(**dist),
        optimizer=tcfg_mod.OptimizerConfig(**opt), **common)
    jtr = JTrainer(jt, n_nodes=n, with_consensus=True)
    jst = jtr.init_state(jax.random.PRNGKey(0))
    row0 = jax.tree.map(lambda p: np.asarray(p[0]),
                        jax.device_get(jst.params))
    jst = jtr.run(jst, steps=3, log_every=1)
    ttr = TTrainer(tt, n_nodes=n, with_consensus=True, device="cpu")
    tst = ttr.init_state(params=interop.from_numpy(row0, "cpu"))
    assert all(not e.any() for e in jax.tree.leaves(tst.ef_state))
    tst = ttr.run(tst, steps=3, log_every=1)
    assert [r["phase"] for r in ttr.history] == ["gossip", "global",
                                                 "gossip"]
    for jr, tr in zip(jtr.history, ttr.history):
        for key in ("loss", "consensus"):
            np.testing.assert_allclose(tr[key], jr[key], rtol=1e-4)
    for want, got in ((jst.params, tst.params),
                      (jst.extras["ef_state"], tst.ef_state)):
        wl = jax.tree.leaves(jax.device_get(want))
        gl = jax.tree.leaves(interop.to_numpy(got))
        size = sum(a.size for a in wl)
        off = sum(int((np.abs(a - b) > 1e-6).sum()) for a, b in zip(wl, gl))
        worst = max(float(np.abs(a - b).max()) for a, b in zip(wl, gl))
        assert off <= 1e-5 * size and worst <= 1e-3, (off, worst)
    assert sum(float(np.abs(e).sum())
               for e in jax.tree.leaves(interop.to_numpy(tst.ef_state))) > 0


@pytest.mark.parametrize("over,item", [
    (dict(fsdp=True), "A.10"),
])
def test_unported_options_still_raise_with_compression(over, item):
    """Compression, the sharded rounds, push-sum and overlap are ported;
    FSDP parameter sharding is not, and the Trainer refuses it before
    running anything."""
    from repro_torch.configs import get_model_config
    from repro_torch.train import Trainer as TTrainer

    tcfg = tcfg_mod.TrainConfig(
        model=get_model_config("pga-lm-100m", reduced=True),
        dist=tcfg_mod.DistConfig(comm_backend="pallas",
                                 comm_compression="int8",
                                 comm_error_feedback=True, **over),
        global_batch=8, seq_len=16)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        TTrainer(tcfg, n_nodes=4, device="cpu")


def test_overlap_with_compression_builds_as_the_reference():
    """Overlap with int8 gossip and error feedback (ROADMAP A.5, ported):
    the reference's Trainer accepts it and so does the port's, with the
    same extras slots; neither has primed its buffer before ``run()``."""
    from repro.configs import pga_lm_100m as jarch
    from repro.train.trainer import Trainer as JTrainer
    from repro_torch.configs import get_model_config
    from repro_torch.train import Trainer as TTrainer

    dist = dict(comm_backend="pallas", comm_compression="int8",
                comm_error_feedback=True, comm_overlap=True)
    tcfg = tcfg_mod.TrainConfig(
        model=get_model_config("pga-lm-100m", reduced=True),
        dist=tcfg_mod.DistConfig(**dist), global_batch=8, seq_len=16)
    jtcfg = jcfg.TrainConfig(
        model=jarch.reduced_config(), dist=jcfg.DistConfig(**dist),
        global_batch=8, seq_len=16)
    ttr = TTrainer(tcfg, n_nodes=4, device="cpu")
    jtr = JTrainer(jtcfg, n_nodes=4)
    tst = ttr.init_state()
    jst = jtr.init_state(jax.random.PRNGKey(0))
    assert sorted(tst.extras) == sorted(jst.extras) == ["ef_state"]
    assert ttr._comm_buf is None and jtr._comm_buf is None


def test_push_sum_with_compression_builds_as_the_reference():
    """Push-sum with int8 gossip and error feedback (ROADMAP A.4, ported):
    the reference's Trainer accepts it and so does the port's, with the
    same extras slots (the EF memory and the push weight)."""
    from repro.configs import pga_lm_100m as jarch
    from repro.train.trainer import Trainer as JTrainer
    from repro_torch.configs import get_model_config
    from repro_torch.train import Trainer as TTrainer

    dist = dict(comm_backend="pallas", comm_compression="int8",
                comm_error_feedback=True, push_sum=True)
    tcfg = tcfg_mod.TrainConfig(
        model=get_model_config("pga-lm-100m", reduced=True),
        dist=tcfg_mod.DistConfig(**dist), global_batch=8, seq_len=16)
    jtcfg = jcfg.TrainConfig(
        model=jarch.reduced_config(), dist=jcfg.DistConfig(**dist),
        global_batch=8, seq_len=16)
    tst = TTrainer(tcfg, n_nodes=4, device="cpu").init_state()
    jst = JTrainer(jtcfg, n_nodes=4).init_state(jax.random.PRNGKey(0))
    assert sorted(tst.extras) == sorted(jst.extras) == ["ef_state",
                                                        "push_weight"]
    assert torch.equal(tst.push_weight, torch.ones(4, 1))


def test_compressed_cli_runs_on_cpu_when_asked():
    """The reference's compression flags on the port's launcher: per-step
    lines with finite losses; a compressed global round leaves the nodes
    apart by their residuals, so consensus stays positive."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train",
         "--arch", "pga-lm-100m", "--nodes", "4", "--steps", "4",
         "--global-batch", "8", "--seq-len", "16", "--H", "2",
         "--comm-backend", "pallas", "--comm-compression", "int8",
         "--comm-global-compression", "int8", "--error-feedback",
         "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if "] step" in ln]
    assert len(lines) == 4
    for k, line in enumerate(lines):
        loss = float(line.split("loss=")[1].split()[0])
        consensus = float(line.split("consensus=")[1])
        assert np.isfinite(loss) and consensus > 0.0
        assert f"phase={'global' if k % 2 else 'gossip'}" in line


@pytest.mark.parametrize("flag,item", [
    (["--telemetry-dir", "telemetry"], "A.6"),
    (["--trace", "trace.json"], "A.6"),
    (["--trace-fence"], "A.6"),
])
def test_cli_unported_flags_raise_not_ported(flag, item, tmp_path,
                                             monkeypatch, capsys):
    """The reference launcher's telemetry flags, ported with ROADMAP
    ``item``, run on the CPU: ``--telemetry-dir`` writes the JSONL
    stream, ``--trace`` a Chrome trace of the ``train/step`` spans,
    ``--trace-fence`` fences them; the step lines print as without
    them."""
    from repro_torch.launch import train as tlaunch

    monkeypatch.chdir(tmp_path)
    tlaunch.main(["--arch", "pga-lm-100m", "--nodes", "4", "--steps", "2",
                  "--global-batch", "8", "--seq-len", "16", "--H", "2",
                  "--comm-backend", "pallas", "--device", "cpu", *flag])
    out = capsys.readouterr().out
    assert len([ln for ln in out.splitlines() if "] step" in ln]) == 2
    if flag[0] == "--telemetry-dir":
        recs = [json.loads(ln)
                for ln in open(tmp_path / flag[1] / "telemetry.jsonl")]
        assert [r["step"] for r in recs if r["type"] == "step"] == [0, 1]
        comm = [r for r in recs if r["type"] == "comm_round"]
        assert comm and all(r["analytic_bytes"] == r["measured_bytes"]
                            for r in comm)
    elif flag[0] == "--trace":
        events = json.load(open(tmp_path / flag[1]))["traceEvents"]
        assert [e["args"]["step"] for e in events
                if e["name"] == "train/step"] == [0, 1]
    else:
        assert "trace:" not in out


def test_cli_comm_overlap_runs_on_cpu_when_asked(capsys):
    """``--comm-overlap`` (ROADMAP A.5, ported) runs the overlapped
    rounds, as the reference's flag does: per-step lines with finite
    losses, the nodes apart after the gossip steps and exactly equal after
    the global flush."""
    from repro_torch.launch import train as tlaunch

    tlaunch.main(["--arch", "pga-lm-100m", "--nodes", "4", "--steps", "3",
                  "--global-batch", "8", "--seq-len", "16", "--H", "2",
                  "--comm-backend", "pallas", "--comm-overlap",
                  "--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "] step" in ln]
    assert len(lines) == 3
    for k, line in enumerate(lines):
        loss = float(line.split("loss=")[1].split()[0])
        consensus = float(line.split("consensus=")[1])
        assert np.isfinite(loss)
        if k % 2:
            assert "phase=global" in line and consensus == 0.0
        else:
            assert "phase=gossip" in line and consensus > 0.0


class _Recorder:
    """Stands in for a launcher's Trainer: records what the launcher built
    and runs nothing."""
    built = []

    def __init__(self, tcfg, n_nodes, **kw):
        _Recorder.built.append((tcfg, n_nodes, kw.get("fault_schedule")))

    def init_state(self, *a, **kw):
        return None

    def run(self, *a, **kw):
        return None


def _launch_both(monkeypatch, argv, record: bool):
    """Both launchers on the same flags: ``(reference's, port's)`` built
    ``(tcfg, n_nodes, fault_schedule)`` when ``record``, else each one's
    exception."""
    from repro.launch import train as jlaunch
    from repro_torch.launch import train as tlaunch

    out = []
    args = ["--arch", "pga-lm-100m", *argv]
    monkeypatch.setattr(sys, "argv", ["train", *args])
    for mod in (jlaunch, tlaunch):
        if record:
            monkeypatch.setattr(mod, "Trainer", _Recorder)
        _Recorder.built.clear()
        try:
            if mod is tlaunch:
                mod.main([*args, "--device", "cpu"])
            else:
                mod.main()
        except ValueError as e:
            out.append(e)
        else:
            out.append(_Recorder.built[-1])
    return out


@pytest.mark.parametrize("flag", [
    ["--push-sum"], ["--fault-drop", "40:3,5"], ["--fault-rejoin", "90:3"],
    ["--fault-resample", "hop"], ["--fault-seed", "0"]])
def test_cli_push_sum_flags_as_the_reference(monkeypatch, flag):
    """The push-sum and fault flags (ROADMAP A.4, ported) do what the
    reference launcher's do: ``--push-sum`` sets ``DistConfig.push_sum``;
    a drop, rejoin or resample flag builds the reference's FaultSchedule,
    which the Trainer refuses without ``--push-sum`` (the reference's
    ``ValueError``, raised before any model is built); ``--fault-seed``
    alone builds none."""
    builds_schedule = flag[0] in ("--fault-drop", "--fault-rejoin",
                                  "--fault-resample")
    if builds_schedule:
        jerr, terr = _launch_both(monkeypatch, flag, record=False)
        assert isinstance(jerr, ValueError) and isinstance(terr, ValueError)
        assert str(terr) == str(jerr)
        assert "requires DistConfig.push_sum" in str(terr)
    else:
        (jt, jn, jfs), (tt, tn, tfs) = _launch_both(monkeypatch, flag,
                                                    record=True)
        assert tt.dist.push_sum == jt.dist.push_sum == (flag == [
            "--push-sum"])
        assert jfs is None and tfs is None and tn == jn


def test_cli_fault_flags_build_the_reference_schedule(monkeypatch):
    """With ``--push-sum`` the fault flags build the reference's schedule:
    the same events, resampling and seed (``--fault-seed`` defaults to 0
    in both), hence the same masks and matrices."""
    argv = ["--push-sum", "--topology", "directed_exp", "--nodes", "8",
            "--fault-drop", "4:3,5;9:0", "--fault-rejoin", "12:3",
            "--fault-resample", "peer"]
    for extra in ([], ["--fault-seed", "7"]):
        (jt, _, jfs), (tt, _, tfs) = _launch_both(monkeypatch, argv + extra,
                                                  record=True)
        assert tt.dist.push_sum and tt.dist.topology == "directed_exp"
        for key in ("n_nodes", "drops", "rejoins", "resample", "seed"):
            assert getattr(tfs, key) == getattr(jfs, key), key
        for k in range(14):
            np.testing.assert_array_equal(tfs.matrix("directed_exp", k),
                                          jfs.matrix("directed_exp", k))


def test_cli_push_sum_fault_run_on_cpu():
    """The launcher's push-sum run with a drop and a rejoin, on the CPU:
    finite losses, one line per step, phases gossip/global at H = 3."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train",
         "--arch", "pga-lm-100m", "--nodes", "4", "--steps", "6",
         "--global-batch", "8", "--seq-len", "16", "--H", "3",
         "--topology", "directed_exp", "--push-sum", "--fault-drop", "2:1",
         "--fault-rejoin", "4:1", "--comm-backend", "pallas",
         "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if "] step" in ln]
    assert len(lines) == 6
    for k, line in enumerate(lines):
        loss = float(line.split("loss=")[1].split()[0])
        assert np.isfinite(loss)
        assert f"phase={'global' if k % 3 == 2 else 'gossip'}" in line
