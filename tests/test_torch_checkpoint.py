"""Port parity: checkpoints and resume (``repro_torch.checkpoint``, the
Trainer's checkpoint hooks and sidecars) against ``repro.checkpoint`` and
the JAX Trainer, on the CPU.

The file format is the reference's, so every format test runs with each
package as the writer and each as the reader.  Resume parity is bitwise
by construction (the schedule, lr, data stream and stochastic-rounding
seed all key on the absolute step), in three forms:

* within the port: save → restore in a fresh Trainer → continue equals
  the uninterrupted run, bit for bit (params, optimizer state, extras);
* across the packages: a checkpoint one package wrote restores in the
  other bit for bit, and the other package continues from it exactly as
  from the same state handed over in memory (the two packages' own runs
  differ by forward/backward summation order, ``test_torch_train.py``);
* the overlap resume is a flush in both packages: the buffer is re-primed
  from the restored params, so the port's resumed run follows the
  reference's resumed run (rtol 1e-5, atol 1e-7: summation order, as in
  ``test_torch_overlap.py``), not its own uninterrupted one.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.configs import base as jcfg
from repro.configs import pga_lm_100m as jarch
from repro.core.faults import FaultSchedule as JFaults
from repro.train import Trainer as JTrainer
from repro.train.state import TrainState as JState
from repro_torch import interop
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import base as tcfg_mod
from repro_torch.configs import pga_lm_100m as tarch
from repro_torch.core.faults import FaultSchedule as TFaults
from repro_torch.core.schedule import AGASchedule
from repro_torch.train import Trainer as TTrainer
from repro_torch.train.state import TrainState
from repro_torch.tree import tree_flatten

torch.set_num_threads(2)

N = 4
FAULTS = dict(n_nodes=N, drops={1: (2,)}, rejoins={3: (2,)}, seed=0)
# the three resume configurations of the acceptance criteria
RESUME = {
    "identity": dict(comm_compression="identity"),
    "int8_ef": dict(comm_compression="int8", comm_global_compression="int8",
                    comm_error_feedback=True),
    "push_faults": dict(topology="directed_exp", push_sum=True),
}


def _cfgs(ckpt_dir, ckpt_every=2, **dist_kw):
    """The same run in both packages: reduced pga-lm-100m at fp32,
    Gossip-PGA H = 2 over the ring, 4 nodes, SGD."""
    dist_kw = {"algorithm": "gossip_pga", "topology": "ring", "H": 2,
               "comm_backend": "pallas", **dist_kw}
    opt = dict(name="sgd", lr=0.05, schedule="constant", warmup_steps=0)
    common = dict(global_batch=8, seq_len=16, steps=4, log_every=0,
                  ckpt_every=ckpt_every, ckpt_dir=str(ckpt_dir))
    jt = jcfg.TrainConfig(
        model=dataclasses.replace(jarch.reduced_config(), dtype="float32"),
        dist=jcfg.DistConfig(**dist_kw), optimizer=jcfg.OptimizerConfig(**opt),
        **common)
    tt = tcfg_mod.TrainConfig(
        model=dataclasses.replace(tarch.reduced_config(), dtype="float32"),
        dist=tcfg_mod.DistConfig(**dist_kw),
        optimizer=tcfg_mod.OptimizerConfig(**opt), **common)
    return jt, tt


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _port_bitwise(got, want):
    gl, gd = tree_flatten(got)
    wl, wd = tree_flatten(want)
    assert gd == wd
    for g, w in zip(gl, wl):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w))


def _np_bitwise(got, want):
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(
            np.ascontiguousarray(g).reshape(-1).view(np.uint8),
            np.ascontiguousarray(w).reshape(-1).view(np.uint8))


def _state_numpy(state, port: bool):
    """(params, opt_state, step, extras) of either package's state as
    numpy trees, the step as the 0-d int32 both files hold."""
    if port:
        return (interop.to_numpy(state.params),
                interop.to_numpy(state.opt_state),
                np.asarray(state.step, np.int32),
                interop.to_numpy(state.extras))
    return jax.device_get(
        (state.params, state.opt_state, state.step, state.extras))


def _port_state(host) -> TrainState:
    params, opt, step, extras = host
    return TrainState(params=interop.from_numpy(params, "cpu"),
                      opt_state=interop.from_numpy(opt, "cpu"),
                      step=int(step),
                      extras=interop.from_numpy(extras, "cpu"))


def _jax_state(host) -> JState:
    params, opt, step, extras = host
    return JState(params=jax.tree.map(jnp.asarray, params),
                  opt_state=jax.tree.map(jnp.asarray, opt),
                  step=jnp.asarray(step, jnp.int32),
                  extras=jax.tree.map(jnp.asarray, extras))


def _faults(port: bool, name: str):
    if name != "push_faults":
        return None
    return (TFaults if port else JFaults)(**FAULTS)


# ---------------------------------------------------------------------------
# The format: bit views, dtype names, manifests
# ---------------------------------------------------------------------------
def _mixed_tree():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    return {"w": w, "b": rng.standard_normal(4).astype(np.float32),
            "q": rng.standard_normal((4, 2)).astype(np.float32),
            "s": np.float32(1.25)}


def _port_mixed():
    t = interop.from_numpy(_mixed_tree(), "cpu")
    return {"w": t["w"].to(torch.bfloat16), "b": t["b"],
            "q": t["q"].to(torch.float8_e4m3fn),
            "s": t["s"].to(torch.bfloat16)}


def _jax_mixed():
    t = jax.tree.map(jnp.asarray, _mixed_tree())
    return {"w": t["w"].astype(jnp.bfloat16), "b": t["b"],
            "q": t["q"].astype(jnp.float8_e4m3fn),
            "s": t["s"].astype(jnp.bfloat16)}


def _pstate(params, step=0, **extras):
    return TrainState(params=params, opt_state={"momentum": params},
                      step=step, extras=extras)


def _jstate(params, step=0, **extras):
    return JState(params=params, opt_state={"momentum": params},
                  step=jnp.asarray(step, jnp.int32), extras=extras)


def _bits_of(tree, port: bool):
    """Every leaf's raw bits as numpy uint8, flattened in key order."""
    if port:
        return [_bits(t).numpy() for t in tree_flatten(tree)[0]]
    return [np.asarray(a).reshape(-1).view(np.uint8)
            for a in jax.tree.leaves(tree)]


@pytest.mark.parametrize("reader", ("port", "jax"))
@pytest.mark.parametrize("writer", ("port", "jax"))
def test_bf16_and_fp8_leaves_roundtrip_bitwise(tmp_path, writer, reader):
    if writer == "port":
        save_checkpoint(str(tmp_path), _pstate(_port_mixed(), step=3), 3)
    else:
        jsave(str(tmp_path), _jstate(_jax_mixed(), step=3), 3)
    if reader == "port":
        tmpl = {k: torch.zeros_like(v) for k, v in _port_mixed().items()}
        got = restore_checkpoint(str(tmp_path), _pstate(tmpl))
        assert got.step == 3 and isinstance(got.step, int)
        assert {k: (v.dtype, v.shape) for k, v in got.params.items()} == {
            k: (v.dtype, v.shape) for k, v in _port_mixed().items()}
    else:
        tmpl = jax.tree.map(jnp.zeros_like, _jax_mixed())
        got = jrestore(str(tmp_path), _jstate(tmpl))
        assert int(got.step) == 3
        assert {k: (v.dtype, v.shape) for k, v in got.params.items()} == {
            k: (v.dtype, v.shape) for k, v in _jax_mixed().items()}
    want = _bits_of(_port_mixed(), True)
    assert [b.tobytes() for b in _bits_of(got.params, reader == "port")] \
        == [b.tobytes() for b in want]


def test_manifest_dtype_names_are_the_references(tmp_path):
    save_checkpoint(str(tmp_path / "p"), _pstate(_port_mixed()), 1)
    jsave(str(tmp_path / "j"), _jstate(_jax_mixed()), 1)
    man = {k: json.load(open(tmp_path / k / "manifest.json"))
           for k in ("p", "j")}
    assert man["p"] == man["j"]
    assert man["p"]["dtypes"][".params/w"] == "bfloat16"
    assert man["p"]["dtypes"][".params/q"] == "float8_e4m3fn"
    # the npz holds the bit views, readable by plain numpy, member for
    # member as the reference's
    dp = np.load(tmp_path / "p" / "ckpt_00000001.npz")
    dj = np.load(tmp_path / "j" / "ckpt_00000001.npz")
    assert sorted(dp.files) == sorted(dj.files)
    for k in dj.files:
        assert dp[k].dtype == dj[k].dtype and dp[k].shape == dj[k].shape
        np.testing.assert_array_equal(dp[k], dj[k])
    assert dp[".params/w"].dtype == np.uint16
    assert dp[".step"].dtype == np.int32 and dp[".step"].shape == ()


@pytest.mark.parametrize("writer", ("port", "jax"))
def test_old_step_keeps_its_own_dtypes(tmp_path, writer):
    """The dtype record rides in each npz: a later save with other leaf
    dtypes does not corrupt the restore of an older step."""
    d = str(tmp_path)
    if writer == "port":
        save_checkpoint(d, _pstate({"w": torch.full((3,), 1.5,
                                                    dtype=torch.bfloat16)}),
                        2)
        save_checkpoint(d, _pstate({"w": torch.full((3,), 1.5)}), 4)
    else:
        jsave(d, _jstate({"w": jnp.full((3,), 1.5, jnp.bfloat16)}), 2)
        jsave(d, _jstate({"w": jnp.full((3,), 1.5, jnp.float32)}), 4)
    got = restore_checkpoint(d, _pstate({"w": torch.zeros(
        3, dtype=torch.bfloat16)}), step=2)
    assert got.params["w"].dtype == torch.bfloat16
    assert got.params["w"].tolist() == [1.5] * 3       # not 16320.0


@pytest.mark.parametrize("reader", ("port", "jax"))
def test_bit_view_restores_without_any_manifest(tmp_path, reader):
    """A port file whose manifest.json is lost restores its bf16 bits in
    either package, never value-cast; so does a bit view whose in-file
    dtype entry is missing (reinterpreted through the template)."""
    d = str(tmp_path)
    save_checkpoint(d, _pstate({"w": torch.full((3,), 1.5,
                                                dtype=torch.bfloat16)}), 1)
    os.remove(os.path.join(d, "manifest.json"))
    if reader == "port":
        got = restore_checkpoint(d, _pstate({"w": torch.zeros(
            3, dtype=torch.bfloat16)}))
        assert got.params["w"].tolist() == [1.5] * 3
    else:
        got = jrestore(d, _jstate({"w": jnp.zeros(3, jnp.bfloat16)}))
        assert np.asarray(got.params["w"], np.float32).tolist() == [1.5] * 3
    # a bare npz of bit views with no dtype entry at all
    np.savez(os.path.join(d, "ckpt_00000002.npz"), **{
        ".params/w": np.full(3, 16320, np.uint16),
        ".opt_state/momentum/w": np.full(3, 16320, np.uint16),
        ".step": np.asarray(2, np.int32)})
    got = restore_checkpoint(d, _pstate({"w": torch.zeros(
        3, dtype=torch.bfloat16)}), step=2)
    assert got.params["w"].tolist() == [1.5] * 3 and got.step == 2


def test_unknown_leaf_raises(tmp_path):
    save_checkpoint(str(tmp_path), _pstate({"w": torch.ones(3)}), 1)
    with pytest.raises(KeyError, match="not in"):
        restore_checkpoint(str(tmp_path), _pstate({"v": torch.ones(3)}))
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), _pstate({}))
    assert latest_step(str(tmp_path)) == 1


# ---------------------------------------------------------------------------
# Extras reconcile, both directions, either package writing
# ---------------------------------------------------------------------------
def _save(d, writer, params, step, **extras):
    if writer == "port":
        save_checkpoint(d, _pstate(interop.from_numpy(params, "cpu"), step,
                                   **interop.from_numpy(extras, "cpu")),
                        step)
    else:
        jsave(d, _jstate(jax.tree.map(jnp.asarray, params), step,
                         **jax.tree.map(jnp.asarray, extras)), step)


@pytest.mark.parametrize("writer", ("port", "jax"))
@pytest.mark.parametrize("bare", (False, True))
def test_ef_state_reconciles_both_directions(tmp_path, writer, bare):
    ones = np.ones((4, 3), np.float32)
    params, ef = ({"w": ones}, {"w": ones * 0.25}) if not bare else \
        (ones, ones * 0.25)
    tp = interop.from_numpy(params, "cpu")
    # a checkpointed slot the template lacks grows into it
    _save(str(tmp_path / "a"), writer, params, 2, ef_state=ef)
    got = restore_checkpoint(str(tmp_path / "a"), _pstate(tp))
    assert "ef_state" in got.extras
    np.testing.assert_array_equal(
        np.asarray(jax.tree.leaves(interop.to_numpy(got.extras))[0]), 0.25)
    # a template slot the checkpoint predates restarts at zeros
    _save(str(tmp_path / "b"), writer, params, 2)
    tmpl = _pstate(tp, ef_state=interop.from_numpy(
        jax.tree.map(lambda a: a * 9, ef), "cpu"))
    got = restore_checkpoint(str(tmp_path / "b"), tmpl)
    for e in tree_flatten(got.extras["ef_state"])[0]:
        assert e.dtype == torch.float32 and not e.any()


@pytest.mark.parametrize("writer", ("port", "jax"))
def test_push_weight_roundtrips_and_backfills_ones(tmp_path, writer):
    params = {"w": np.ones((4, 3), np.float32)}
    tp = interop.from_numpy(params, "cpu")
    pw = np.asarray([[0.75], [1.25], [0.5], [1.5]], np.float32)
    _save(str(tmp_path / "a"), writer, params, 1, push_weight=pw)
    got = restore_checkpoint(str(tmp_path / "a"),
                             _pstate(tp, push_weight=torch.ones(4, 1)))
    np.testing.assert_array_equal(got.push_weight.numpy(), pw)
    # into a template without the slot: it grows
    got = restore_checkpoint(str(tmp_path / "a"), _pstate(tp))
    np.testing.assert_array_equal(got.push_weight.numpy(), pw)
    # a plain checkpoint into a push template: w starts at ONES
    _save(str(tmp_path / "b"), writer, params, 1)
    got = restore_checkpoint(str(tmp_path / "b"), _pstate(
        tp, push_weight=torch.full((4, 1), 9.0)))
    np.testing.assert_array_equal(got.push_weight.numpy(),
                                  np.ones((4, 1), np.float32))


def test_legacy_top_level_slots_restore_through_their_alias(tmp_path):
    np.savez(tmp_path / "ckpt_00000003.npz", **{
        ".params/w": np.ones(3, np.float32),
        ".opt_state/momentum/w": np.zeros(3, np.float32),
        ".ef_state/w": np.full(3, 0.5, np.float32),
        ".push_weight": np.full((3, 1), 2.0, np.float32),
        ".step": np.asarray(3, np.int32)})
    tmpl = _pstate({"w": torch.zeros(3)}, ef_state={"w": torch.zeros(3)},
                   push_weight=torch.ones(3, 1))
    got = restore_checkpoint(str(tmp_path), tmpl)
    assert got.step == 3
    assert got.extras["ef_state"]["w"].tolist() == [0.5] * 3
    assert got.push_weight.reshape(-1).tolist() == [2.0] * 3


# ---------------------------------------------------------------------------
# Resume within the port: bitwise the uninterrupted run
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(RESUME))
def test_port_resume_matches_uninterrupted(tmp_path, name):
    _, tt = _cfgs(tmp_path, **RESUME[name])
    tr = TTrainer(tt, n_nodes=N, fault_schedule=_faults(True, name),
                  device="cpu")
    full = tr.run(tr.init_state(), steps=4)
    tr2 = TTrainer(tt, n_nodes=N, fault_schedule=_faults(True, name),
                   device="cpu")
    state = restore_checkpoint(str(tmp_path), tr2.init_state(), step=2)
    assert state.step == 2
    resumed = tr2.run(state, steps=2)
    assert resumed.step == full.step == 4
    _port_bitwise(resumed.params, full.params)
    _port_bitwise(resumed.opt_state, full.opt_state)
    _port_bitwise(resumed.extras, full.extras)
    if name == "push_faults":
        assert tr2.fault_schedule.state_dict() == \
            tr.fault_schedule.state_dict()
        assert (tmp_path / "faults_00000002.json").exists()
    ckpts = [r["step"] for r in tr.telemetry.ring().records("ckpt")]
    assert ckpts == [2, 4]


def test_resume_across_ef_enablement(tmp_path):
    _, plain = _cfgs(tmp_path)
    tr = TTrainer(plain, n_nodes=N, device="cpu")
    tr.run(tr.init_state(), steps=2)
    _, comp = _cfgs(tmp_path, comm_compression="int8",
                    comm_error_feedback=True)
    tr2 = TTrainer(comp, n_nodes=N, device="cpu")
    state = restore_checkpoint(str(tmp_path), tr2.init_state(), step=2)
    for e in tree_flatten(state.ef_state)[0]:
        assert not e.any()
    state = tr2.run(state, steps=2)
    assert state.step == 4
    for p in tree_flatten(state.params)[0]:
        assert torch.isfinite(p).all()


def test_gt_pga_slots_resume_bitwise_and_read_in_jax(tmp_path):
    """GT-PGA's tracker slots ride the checkpoint: the port's resume is
    bitwise, and the reference restores the port's slots bit for bit."""
    jt, tt = _cfgs(tmp_path, algorithm="gt_pga")
    tr = TTrainer(tt, n_nodes=N, device="cpu")
    full = tr.run(tr.init_state(), steps=4)
    tr2 = TTrainer(tt, n_nodes=N, device="cpu")
    state = restore_checkpoint(str(tmp_path), tr2.init_state(), step=2)
    assert sorted(state.extras) == ["gt_prev_grad", "gt_tracker"]
    _port_bitwise(tr2.run(state, steps=2).params, full.params)
    jstate = jrestore(str(tmp_path), JTrainer(jt, n_nodes=N).init_state(
        jax.random.PRNGKey(0)), step=4)
    _np_bitwise(jax.device_get(jstate.extras),
                interop.to_numpy(full.extras))


def test_aga_schedule_state_resumes():
    def drive(sched, ks):
        out = []
        for k in ks:
            sched.observe_loss(k, 10.0 / (1 + k))
            out.append(sched.advance(k))
        return out

    full = AGASchedule(H_init=2, warmup=4, H_max=32)
    want = drive(full, range(24))
    first = AGASchedule(H_init=2, warmup=4, H_max=32)
    got = drive(first, range(12))
    resumed = AGASchedule(H_init=2, warmup=4, H_max=32)
    resumed.load_state_dict(first.state_dict())        # the sidecar payload
    got += drive(resumed, range(12, 24))
    assert got == want and resumed.current_H == full.current_H


def test_trainer_aga_resume_bitwise_through_the_sidecar(tmp_path):
    """gossip_aga's period counter is trajectory state: the sidecar the
    Trainer writes beside each checkpoint is reloaded by a fresh
    Trainer's first run(), so the resumed params (which depend on when
    the global rounds fired) are bitwise the uninterrupted run's."""
    _, tt = _cfgs(tmp_path, ckpt_every=3, algorithm="gossip_aga",
                  aga_h_init=2, aga_warmup=1)
    tr = TTrainer(tt, n_nodes=N, device="cpu")
    full = tr.run(tr.init_state(), steps=6)
    assert (tmp_path / "schedule_00000003.json").exists()
    tr2 = TTrainer(tt, n_nodes=N, device="cpu")
    state = restore_checkpoint(str(tmp_path), tr2.init_state(), step=3)
    resumed = tr2.run(state, steps=3)
    _port_bitwise(resumed.params, full.params)
    assert tr2.schedule.state_dict() == tr.schedule.state_dict()
    assert tr2.schedule.history == tr.schedule.history
    tr3 = TTrainer(tt, n_nodes=N, device="cpu")
    tr3.load_schedule(step=6)
    assert tr3.schedule.state_dict() == tr.schedule.state_dict()


# ---------------------------------------------------------------------------
# Across the packages: either one's checkpoint resumes in the other
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=sorted(RESUME))
def written(request, tmp_path_factory):
    """Both packages' runs to step 2 of one configuration, each saving its
    checkpoint at step 2; the JAX Trainer is kept (compiled) to continue."""
    name = request.param
    dj = tmp_path_factory.mktemp(f"jax_{name}")
    dp = tmp_path_factory.mktemp(f"port_{name}")
    jt, _ = _cfgs(dj, **RESUME[name])
    _, tt = _cfgs(dp, **RESUME[name])
    jtr = JTrainer(jt, n_nodes=N, fault_schedule=_faults(False, name))
    jst = jtr.run(jtr.init_state(jax.random.PRNGKey(0)), steps=2)
    ttr = TTrainer(tt, n_nodes=N, fault_schedule=_faults(True, name),
                   device="cpu")
    tst = ttr.run(ttr.init_state(), steps=2)
    return dict(name=name, jtr=jtr, jhost=_state_numpy(jst, False), dj=dj,
                thost=_state_numpy(tst, True), dp=dp)


def test_jax_checkpoint_resumes_in_the_port(written, tmp_path):
    name = written["name"]
    _, tt = _cfgs(written["dj"], ckpt_every=0, **RESUME[name])
    tr = TTrainer(tt, n_nodes=N, fault_schedule=_faults(True, name),
                  device="cpu")
    state = restore_checkpoint(str(written["dj"]), tr.init_state(), step=2)
    _np_bitwise(_state_numpy(state, True), written["jhost"])
    resumed = tr.run(state, steps=2)
    if name == "push_faults":   # the JAX sidecar's counters, reloaded
        assert tr.fault_schedule.state_dict()["steps_seen"] == 4
    tr2 = TTrainer(tt.replace(ckpt_dir=str(tmp_path)), n_nodes=N,
                   fault_schedule=_faults(True, name), device="cpu")
    handed = tr2.run(_port_state(written["jhost"]), steps=2)
    _port_bitwise(resumed.params, handed.params)
    _port_bitwise(resumed.opt_state, handed.opt_state)
    _port_bitwise(resumed.extras, handed.extras)


def test_port_checkpoint_resumes_in_jax(written):
    jtr = written["jtr"]
    state = jrestore(str(written["dp"]), jtr.init_state(
        jax.random.PRNGKey(0)), step=2)
    _np_bitwise(jax.device_get((state.params, state.opt_state, state.step,
                                state.extras)), written["thost"])
    resumed = jax.device_get(jtr.run(state, steps=2))
    handed = jax.device_get(jtr.run(_jax_state(written["thost"]), steps=2))
    _np_bitwise((resumed.params, resumed.opt_state, resumed.extras),
                (handed.params, handed.opt_state, handed.extras))
    assert int(resumed.step) == 4


def test_overlap_resume_is_a_flush_as_in_the_reference(tmp_path):
    """The checkpoint after step 0 leaves a gossip step next: the
    uninterrupted run applies the buffer step 0 primed (its half-step
    iterate), a resumed run (either package, from the same file)
    re-primes from the restored params, as the reference's resume does."""
    jt, tt = _cfgs(tmp_path, ckpt_every=1, algorithm="gossip_pga", H=3,
                   comm_overlap=True, topology="one_peer_exp")
    full_tr = TTrainer(tt, n_nodes=N, device="cpu")
    full = full_tr.run(full_tr.init_state(), steps=2)   # saves at 1 and 2
    jtr = JTrainer(jt.replace(ckpt_every=0), n_nodes=N)
    jres = jax.device_get(jtr.run(jrestore(str(tmp_path), jtr.init_state(
        jax.random.PRNGKey(0)), step=1), steps=1).params)
    ttr = TTrainer(tt.replace(ckpt_every=0), n_nodes=N, device="cpu")
    tres = ttr.run(restore_checkpoint(str(tmp_path), ttr.init_state(),
                                      step=1), steps=1)
    for a, b in zip(jax.tree.leaves(jres),
                    jax.tree.leaves(interop.to_numpy(tres.params))):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7)
    # the uninterrupted run applied step 0's buffer: another trajectory
    assert not all(torch.equal(a, b) for a, b in zip(
        tree_flatten(full.params)[0], tree_flatten(tres.params)[0]))
