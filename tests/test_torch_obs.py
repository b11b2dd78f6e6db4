"""Port parity: the observability layer (``repro_torch.obs``: the
telemetry hub and its sinks, span tracing, the comm-round meters) and its
hooks in the round entry points, the Trainer, ``simulate`` and the
server, against ``repro.obs`` on the CPU.

Records are compared field by field, leaving out ``ts`` (wall clock) and
``traced`` (the reference emits its round meters while tracing; the port
runs every round eagerly and installs the hub for a step variant's first
call only, so a run emits the same records: ROADMAP C.3).  The meters
are shape arithmetic, so the byte figures agree exactly.
"""
import collections
import dataclasses
import io
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import base as jcfg
from repro.configs import pga_lm_100m as jarch
from repro.core import mixing as jmix
from repro.core.algorithms import simulate as jsim
from repro.core.faults import FaultSchedule as JFaults
from repro.train import Trainer as JTrainer
from repro_torch import interop, obs
from repro_torch.compress import round_wire_bytes
from repro_torch.configs import base as tcfg_mod
from repro_torch.configs import get_model_config
from repro_torch.configs import pga_lm_100m as tarch
from repro_torch.core import mixing
from repro_torch.core.algorithms import simulate as tsim
from repro_torch.core.faults import FaultSchedule as TFaults
from repro_torch.core.mesh import make_mesh
from repro_torch.models.model import make_model
from repro_torch.serve import BatchedServer, Engine, Request
from repro_torch.train import Trainer as TTrainer
from repro_torch.tree import tree_flatten

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
N = 4


def _key(rec):
    return tuple(sorted((k, repr(v)) for k, v in rec.items()
                        if k not in ("ts", "traced")))


def _multiset(recs):
    return collections.Counter(_key(r) for r in recs)


def _cfgs(log_every=0, **dist_kw):
    dist_kw = {"algorithm": "gossip_pga", "topology": "ring", "H": 2,
               "comm_backend": "pallas", **dist_kw}
    opt = dict(name="sgd", lr=0.05, schedule="constant", warmup_steps=0)
    common = dict(global_batch=8, seq_len=16, log_every=log_every)
    jt = jcfg.TrainConfig(
        model=dataclasses.replace(jarch.reduced_config(), dtype="float32"),
        dist=jcfg.DistConfig(**dist_kw), optimizer=jcfg.OptimizerConfig(**opt),
        **common)
    tt = tcfg_mod.TrainConfig(
        model=dataclasses.replace(tarch.reduced_config(), dtype="float32"),
        dist=tcfg_mod.DistConfig(**dist_kw),
        optimizer=tcfg_mod.OptimizerConfig(**opt), **common)
    return jt, tt


def _quadratic(d=6, m=48):
    """Least squares with A and b drawn by numpy, in both packages."""
    rng = np.random.default_rng(11)
    A = rng.standard_normal((m, d)).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)

    def jloss(x):
        return 0.5 * jnp.mean((Aj @ x - bj) ** 2)

    def jgrad(xs, key, k):
        return jax.vmap(jax.grad(jloss))(xs)

    def tloss(x):
        return 0.5 * torch.mean((At @ x - bt) ** 2)

    def tgrad(xs, generator, k):
        return (xs @ At.T - bt) @ At / m

    return (jloss, jgrad), (tloss, tgrad), d


# ---------------------------------------------------------------------------
# Hub and sinks
# ---------------------------------------------------------------------------
def test_sink_schema_roundtrip(tmp_path):
    path = str(tmp_path / "t.jsonl")
    tel = obs.Telemetry(sinks=[obs.JsonlSink(path), obs.RingSink()],
                        tags={"algorithm": "unit"})
    tel.emit("step", step=3, phase="gossip", loss=torch.tensor(1.25))
    tel.emit("comm_round", phase="global", role="round",
             measured_bytes=128)
    tel.emit("ckpt", step=4)
    tel.close()
    recs = [json.loads(ln) for ln in open(path)]
    assert [r["type"] for r in recs] == ["step", "comm_round", "ckpt"]
    for r in recs:
        assert r["schema"] == obs.SCHEMA_VERSION == jobs.SCHEMA_VERSION
        assert r["algorithm"] == "unit"
        assert isinstance(r["ts"], float)
    assert recs[0]["loss"] == 1.25          # a 0-d tensor, as a float
    ring = tel.ring()
    assert [r["type"] for r in ring.records()] == [r["type"] for r in recs]
    assert ring.records("step")[0]["step"] == 3


def test_schema_is_the_references():
    assert obs.RECORD_TYPES == jobs.RECORD_TYPES
    tel = obs.Telemetry()
    with pytest.raises(ValueError, match="unknown record type"):
        tel.emit("nonsense", step=0)
    with pytest.raises(ValueError, match="missing required"):
        tel.emit("step", step=0)             # no phase


@pytest.mark.parametrize("rec", [
    dict(type="step", step=7, phase="gossip", loss=6.5, consensus=1e-3,
         algorithm="gossip_pga"),
    dict(type="step", step=12, phase="global", algorithm="local"),
    dict(type="serve_req", uid=3, latency_s=0.0125, tokens_per_s=80.0),
    dict(type="fault", step=2, kind="drop", nodes=[1], algorithm="x"),
])
def test_pretty_line_is_the_references(rec):
    outs = []
    for sink_cls in (obs.PrettySink, jobs.PrettySink):
        buf = io.StringIO()
        sink_cls(stream=buf, types=("step", "serve_req", "fault")).emit(
            dict(rec, ts=0.0, schema=1))
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    if rec["type"] == "step" and "loss" in rec:
        assert outs[0] == ("[gossip_pga] step     7 loss=6.5000 "
                           "phase=gossip consensus=1.000e-03\n")


def test_telemetry_scope_nesting():
    a, b = obs.Telemetry(), obs.Telemetry()
    assert obs.get_telemetry() is None
    with obs.telemetry_scope(a):
        assert obs.get_telemetry() is a
        with obs.telemetry_scope(b):
            assert obs.get_telemetry() is b
        assert obs.get_telemetry() is a
    assert obs.get_telemetry() is None


def test_fetch_is_one_counted_copy_back():
    tel = obs.Telemetry()
    tree = {"lr": 0.5, "m": {"loss": torch.tensor(1.5),
                             "n": torch.tensor(3, dtype=torch.int32)},
            "w": [torch.tensor(0.25), torch.ones(2, dtype=torch.bfloat16)]}
    host = tel.fetch(tree)
    assert tel.host_fetches == 1
    assert host["lr"] == 0.5 and float(host["m"]["loss"]) == 1.5
    assert host["m"]["n"].dtype == np.int32 and int(host["m"]["n"]) == 3
    assert host["w"][1].tolist() == [1.0, 1.0]


# ---------------------------------------------------------------------------
# Chrome trace export and the fenced timer
# ---------------------------------------------------------------------------
def test_chrome_trace_valid_and_nested(tmp_path):
    tr = obs.Tracer(fence=True)
    with tr.span("train/step", step=0) as sp:
        with tr.span("comm/issue"):
            pass
        with tr.span("comm/apply"):
            pass
        sp.fence(torch.ones(3))              # a CPU value: nothing to wait
    doc = json.load(open(tr.save(str(tmp_path / "trace.json"))))
    evs = doc["traceEvents"]
    assert {e["name"] for e in evs} == {"train/step", "comm/issue",
                                        "comm/apply"}
    for e in evs:
        assert e["ph"] == "X" and e["ts"] >= 0 and e["dur"] >= 0
    outer = next(e for e in evs if e["name"] == "train/step")
    for e in evs:
        if e is not outer:
            assert e["ts"] >= outer["ts"]
            assert e["ts"] + e["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    assert outer["args"] == {"step": 0}
    # the reference's Tracer exports the same layout
    jt = jobs.Tracer()
    with jt.span("train/step", step=0):
        pass
    assert sorted(jt.to_chrome()["traceEvents"][0]) == sorted(evs[0])


def test_fenced_time_records_spans():
    tr = obs.Tracer()
    us = obs.fenced_time(torch.sum, torch.arange(8.0), iters=3, warmup=1,
                         name="bench/sum", tracer=tr)
    assert us > 0
    assert [e["name"] for e in tr.events] == ["bench/sum"] * 3


# ---------------------------------------------------------------------------
# Comm meters: the reference's fields, measured == analytic
# ---------------------------------------------------------------------------
def _round_records(package, params, phase, dist_kw, step=1):
    if package == "port":
        spec = tcfg_mod.DistConfig(**dist_kw).comm_spec(N)
        tel = obs.Telemetry(sinks=[obs.RingSink()])
        with obs.telemetry_scope(tel):
            mixing.communicate(interop.from_numpy(params, "cpu"), spec,
                               phase=phase, step=step,
                               ef_state=None, seed=3)
        return tel.ring().records("comm_round")
    spec = jcfg.DistConfig(**dist_kw).comm_spec(N)
    tel = jobs.Telemetry(sinks=[jobs.RingSink()])
    with jobs.telemetry_scope(tel):
        jmix.communicate(jax.tree.map(jnp.asarray, params), spec,
                         phase=phase, step=step, seed=3)
    return tel.ring().records("comm_round")


@pytest.mark.parametrize("phase", ("gossip", "global", "pod_avg"))
@pytest.mark.parametrize("dist_kw", [
    dict(comm_compression="identity"),
    dict(comm_compression="int8"),
    dict(comm_compression="fp8"),
    dict(comm_compression="topk", comm_compression_k=4),
    dict(comm_global_compression="int8"),
    dict(comm_dtype="bfloat16"),
    dict(topology="grid"),
    dict(topology="one_peer_exp", comm_backend="reference"),
], ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_comm_round_fields_equal_the_references(phase, dist_kw):
    dist_kw = {"algorithm": "hier_pga", "topology": "ring", "n_pods": 2,
               "comm_backend": "pallas", **dist_kw}
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((N, 32)).astype(np.float32),
              "b": rng.standard_normal((N, 7)).astype(np.float32)}
    got = _round_records("port", params, phase, dist_kw)
    want = _round_records("jax", params, phase, dist_kw)
    assert len(got) == len(want) == 1
    assert _key(got[0]) == _key(want[0])
    r = got[0]
    assert r["phase"] == phase and r["role"] == "round"
    assert r["analytic_bytes"] == r["measured_bytes"]
    sizes = [32, 7]
    assert r["analytic_bytes"] == round_wire_bytes(
        phase, dist_kw["topology"], N, sum(sizes),
        comm_dtype=r["comm_dtype"], compression=r["compression"],
        k=dist_kw.get("comm_compression_k", 32), step=1, n_pods=2,
        leaf_sizes=sizes, global_compression=r["global_compression"])


def test_sharded_wire_meter_counts_the_wire_arrays():
    """The sharded lossy capture meters its wire arrays themselves: the
    codes and the per-row scales, equal to the analytic figure."""
    dist = tcfg_mod.DistConfig(algorithm="gossip_pga", topology="ring",
                               comm_backend="pallas",
                               comm_shard_mode="sharded",
                               comm_compression="int8", comm_overlap=True)
    spec = dist.comm_spec(N, mesh=make_mesh((2,), ("data",), device="cpu"))
    params = {"w": torch.randn(N, 33), "b": torch.randn(N, 5)}
    tel = obs.Telemetry(sinks=[obs.RingSink()])
    with obs.telemetry_scope(tel):
        rs, _ = mixing.start_round(params, spec, seed=1)
        mixing.finish_round(params, rs, spec, step=0)
    recs = tel.ring().records("comm_round")
    assert [r["role"] for r in recs] == ["issue", "apply"]
    assert "wire" in rs
    for r in recs:
        assert r["sharded"] and r["analytic_bytes"] == r["measured_bytes"]
    assert {e["name"] for e in tel.tracer.events} == {"comm/issue",
                                                      "comm/apply"}


def test_comm_meters_are_no_ops_without_a_hub():
    spec = tcfg_mod.DistConfig(algorithm="gossip_pga",
                               topology="ring").comm_spec(N)
    assert obs.get_telemetry() is None
    out = mixing.communicate([torch.ones(N, 8)], spec, phase="gossip")
    assert out[0].shape == (N, 8)
    w = torch.ones(N, 1)
    mixing.communicate_push_sum([torch.ones(N, 8)], w, W=np.eye(N),
                                n_nodes=N)


# ---------------------------------------------------------------------------
# simulate: overlap records, fault events, comm records as the reference's
# ---------------------------------------------------------------------------
def _sim_records(package, **kw):
    (jloss, jgrad), (tloss, tgrad), d = _quadratic()
    common = dict(algorithm="gossip_pga", n=N, steps=8, lr=0.05, H=4,
                  eval_every=4, **kw)
    if "fault_schedule" in kw:
        common["fault_schedule"] = (TFaults if package == "port"
                                    else JFaults)(**kw["fault_schedule"])
    if package == "port":
        tel = obs.Telemetry(sinks=[obs.RingSink()])
        tsim(grad_fn=tgrad, loss_fn=tloss, x0=torch.zeros(d), device="cpu",
             telemetry=tel, **common)
    else:
        tel = jobs.Telemetry(sinks=[jobs.RingSink()])
        jsim(grad_fn=jgrad, loss_fn=jloss, x0=jnp.zeros(d), telemetry=tel,
             **common)
    return tel


@pytest.mark.parametrize("overlap", (False, True))
def test_simulate_issue_apply_iff_overlap(overlap):
    tels = {p: _sim_records(p, topology="ring", overlap=overlap)
            for p in ("port", "jax")}
    tel = tels["port"]
    roles = {r["role"] for r in tel.ring().records("comm_round")}
    names = {e["name"] for e in tel.tracer.events}
    if overlap:
        assert {"issue", "apply", "flush"} <= roles
        assert {"comm/issue", "comm/apply", "comm/flush"} <= names
    else:
        assert roles == {"round"} and "comm/issue" not in names
    assert _multiset(tel.ring().records("comm_round")) == _multiset(
        tels["jax"].ring().records("comm_round"))
    steps = [(r["step"], r["phase"]) for r in tel.ring().records("step")]
    assert steps == [(r["step"], r["phase"])
                     for r in tels["jax"].ring().records("step")]


def test_fault_events_equal_the_references():
    fs = dict(n_nodes=N, drops={3: (1,)}, rejoins={6: (1,)})
    tels = {p: _sim_records(p, topology="directed_ring", push_sum=True,
                            fault_schedule=fs)
            for p in ("port", "jax")}
    got, want = (t.ring().records("fault") for t in tels.values())
    assert [(f["step"], f["kind"], f["nodes"]) for f in got] == \
        [(3, "drop", [1]), (6, "rejoin", [1])]
    assert [_key(r) for r in got] == [_key(r) for r in want]
    comm = tels["port"].ring().records("comm_round")
    assert comm and all(c["phase"] == "push_sum" for c in comm)
    assert _multiset(comm) == _multiset(
        tels["jax"].ring().records("comm_round"))
    steps = tels["port"].ring().records("step")
    assert steps and steps[-1]["mass"] == pytest.approx(N, abs=1e-5)


# ---------------------------------------------------------------------------
# The Trainer
# ---------------------------------------------------------------------------
TRAINER_RUNS = {
    "fused": (dict(topology="one_peer_exp"), None),
    "overlap_int8_ef": (dict(topology="one_peer_exp", comm_overlap=True,
                             comm_compression="int8",
                             comm_error_feedback=True), None),
    "push_faults": (dict(topology="directed_exp", push_sum=True),
                    dict(n_nodes=N, drops={1: (2,)}, rejoins={3: (2,)})),
}


@pytest.mark.parametrize("name", sorted(TRAINER_RUNS))
def test_trainer_records_equal_the_references(name):
    """comm_round, flush and fault records of a 4-step run: the same
    multiset as the reference Trainer's."""
    dist_kw, faults = TRAINER_RUNS[name]
    jt, tt = _cfgs(log_every=1, **dist_kw)
    jtel = jobs.Telemetry(sinks=[jobs.RingSink()])
    jtr = JTrainer(jt, n_nodes=N, with_consensus=True, telemetry=jtel,
                   fault_schedule=JFaults(**faults) if faults else None)
    jtr.run(jtr.init_state(jax.random.PRNGKey(0)), steps=4)
    ttel = obs.Telemetry(sinks=[obs.RingSink()])
    ttr = TTrainer(tt, n_nodes=N, with_consensus=True, telemetry=ttel,
                   fault_schedule=TFaults(**faults) if faults else None,
                   device="cpu")
    ttr.run(ttr.init_state(), steps=4)
    for rtype in ("comm_round", "flush", "fault"):
        got = ttel.ring().records(rtype)
        assert _multiset(got) == _multiset(jtel.ring().records(rtype)), \
            rtype
    comm = ttel.ring().records("comm_round")
    assert comm
    for r in comm:
        if r["analytic_bytes"] is not None:
            assert r["analytic_bytes"] == r["measured_bytes"]
    steps = ttel.ring().records("step")
    assert [r["step"] for r in steps] == [0, 1, 2, 3]
    assert sorted(steps[-1]) == sorted(jtel.ring().records("step")[-1])
    assert ttr.history == steps and steps[-1]["window"] == 1


def test_trainer_occupancy_record_and_bitwise_neutral():
    _, tt = _cfgs(topology="one_peer_exp", comm_overlap=True)
    runs = {}
    for mo in (False, True):
        tr = TTrainer(tt, n_nodes=N, measure_occupancy=mo, device="cpu")
        runs[mo] = (tr, tr.run(tr.init_state(), steps=4, log_every=2))
    occ = [r for r in runs[True][0].telemetry.ring().records("comm_round")
           if r["role"] == "occupancy"]
    assert len(occ) == 1 and 0.0 <= occ[0]["occupancy"] <= 1.0
    assert occ[0]["t_round_sync_us"] > 0 and occ[0]["step"] == 2
    assert not [r for r in runs[False][0].telemetry.ring().records(
        "comm_round") if r["role"] == "occupancy"]
    assert runs[True][0].telemetry.ring().records("flush")
    for a, b in zip(tree_flatten((runs[True][1].params,
                                  runs[True][1].opt_state))[0],
                    tree_flatten((runs[False][1].params,
                                  runs[False][1].opt_state))[0]):
        assert torch.equal(a, b)
    for a, b in zip(tree_flatten(runs[True][0]._comm_buf)[0],
                    tree_flatten(runs[False][0]._comm_buf)[0]):
        assert torch.equal(a, b)


def test_trainer_hot_path_reads_nothing_per_step(monkeypatch):
    """log_every=0 Gossip-AGA over two global boundaries: no host read of
    a tensor per step (.item(), .tolist(), .cpu(), .numpy(), float()),
    only the schedule's at its period boundaries, and no fetch."""
    _, tt = _cfgs(algorithm="gossip_aga", H=4)
    tr = TTrainer(tt, n_nodes=N, device="cpu")
    state = tr.init_state()
    calls = collections.Counter()
    for name in ("item", "tolist", "cpu", "numpy", "__float__"):
        real = getattr(torch.Tensor, name)

        def counting(self, *a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counting)
    steps = 10
    state = tr.run(state, steps=steps, log_every=0)
    monkeypatch.undo()
    assert sum(calls.values()) < steps, calls
    assert tr.telemetry.host_fetches == 0 and state.step == steps
    assert len(tr.schedule.history) >= 2


def test_trainer_log_boundary_is_one_fetch():
    _, tt = _cfgs()
    tr = TTrainer(tt, n_nodes=N, with_consensus=True, device="cpu")
    tr.run(tr.init_state(), steps=8, log_every=4)     # boundaries 0, 4, 7
    assert tr.telemetry.host_fetches == 3
    assert [r["step"] for r in tr.history] == [0, 4, 7]
    for rec in tr.history:
        for key in ("step", "phase", "lr", "time", "loss", "consensus",
                    "loss_window_mean", "window", "phase_counts"):
            assert key in rec
    assert [r["window"] for r in tr.history] == [1, 4, 3]
    assert tr.history[-1]["phase_counts"] == {"gossip": 4, "global": 4}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def test_serve_req_records():
    cfg = get_model_config("xlstm-125m", reduced=True)
    model = make_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tel = obs.Telemetry(sinks=[obs.RingSink()])
    server = BatchedServer(Engine(model, s_max=16), params, n_slots=2,
                           telemetry=tel)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=4),
                    max_new=3) for i in range(3)]
    assert len(server.run(reqs)) == 3
    recs = tel.ring().records("serve_req")
    assert sorted(r["uid"] for r in recs) == [0, 1, 2]
    for r in recs:
        assert r["latency_s"] > 0 and r["tokens_per_s"] > 0
        assert r["new_tokens"] == 3 and r["prompt_tokens"] == 4
    names = {e["name"] for e in tel.tracer.events}
    assert {"serve/prefill", "serve/decode"} <= names


# ---------------------------------------------------------------------------
# The port's JSONL through the reference's report
# ---------------------------------------------------------------------------
def test_port_jsonl_renders_in_the_report(tmp_path, capsys):
    sys.path.insert(0, str(REPO))
    from benchmarks.report import telemetry_table
    path = str(tmp_path / "telemetry.jsonl")
    _, tt = _cfgs(topology="one_peer_exp", comm_overlap=True)
    tel = obs.Telemetry(sinks=[obs.JsonlSink(path)])
    tr = TTrainer(tt, n_nodes=N, with_consensus=True, telemetry=tel,
                  device="cpu")
    tr.run(tr.init_state(), steps=4, log_every=3)
    tel.emit("serve_req", uid=0, latency_s=0.01, tokens_per_s=100.0)
    tel.emit("fault", step=3, kind="drop", nodes=[1])
    tel.close()
    recs = [json.loads(ln) for ln in open(path)]
    assert {r["type"] for r in recs} == {"comm_round", "flush", "step",
                                         "serve_req", "fault"}
    telemetry_table(path)
    out = capsys.readouterr().out
    assert "per-round communication" in out
    assert "| gossip | apply | one_peer_exp | pallas | none | 1 |" in out
    assert "pipeline occupancy: **" in out       # a JsonlSink turns it on
    assert "step 3 drop [1]" in out
    assert "latency p50 10.0ms" in out
    assert os.path.getsize(path) > 0
