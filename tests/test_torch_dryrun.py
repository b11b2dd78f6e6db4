"""Port parity: the dry-run (``repro_torch.launch.dryrun``) and the
hill-climbing records (``repro_torch.launch.hillclimb``) against the live
JAX package on the CPU, without compiling anything.

* ``plan_for`` for the ten assigned archs × four shapes, skip strings
  included, and the dry-run's arch tables: equal;
* the meta run's FLOPs of a train step (both phases) and of a decode step
  on reduced configs: equal to ``FlopCounterMode`` over the same steps
  run on CPU tensors (FLOPs depend on shapes only);
* the ``wire`` record: equal to the reference's ``round_wire_bytes`` on
  the reference's own leaf sizes;
* the record's keys: those the reference's ``dryrun_train``,
  ``dryrun_serve`` and ``_mem_dict`` write (read from its source), then
  ``coll_modelled``;
* ``run_one`` records ``ok: False`` with a traceback for a config made to
  raise; ``main`` writes one JSONL line; ``hillclimb.record`` writes the
  reference's fields;
* every hand-written kernel's wrapper raises on a meta tensor.

The reference's ``launch/dryrun.py`` and ``launch/hillclimb.py`` set
``XLA_FLAGS`` for 512 host devices when imported: the import happens
after JAX's backend is up (so the flag is inert) and the variable is
restored.
"""
import ast
import dataclasses
import json
import os
from pathlib import Path

import pytest
import torch

from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, DistConfig,
                                 InputShape, OptimizerConfig, TrainConfig,
                                 get_model_config)
from repro_torch.core.mesh import make_mesh
from repro_torch.launch import dryrun, hillclimb

torch.set_num_threads(2)

REF = Path(__file__).resolve().parents[1] / "src" / "repro" / "launch"
SMALL_MESH = ((4, 2), ("data", "model"))


@pytest.fixture(scope="module")
def ref_launch():
    import jax
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jd
        from repro.launch import hillclimb as jh
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jd, jh


def test_plans_and_tables_equal_the_references(ref_launch):
    jd, _ = ref_launch
    for name in ("LONG_OK_FAMILIES", "DECODE_SKIP_FAMILIES",
                 "HIERARCHICAL_ARCHS", "SERVE_2D_ARCHS"):
        assert getattr(dryrun, name) == getattr(jd, name), name
    n_skip = 0
    for arch in ASSIGNED_ARCHS:
        for shape in INPUT_SHAPES:
            got, want = dryrun.plan_for(arch, shape), jd.plan_for(arch, shape)
            assert sorted(got) == sorted(want)
            if "skip" in want:
                assert got["skip"] == want["skip"]
                n_skip += 1
                continue
            assert dataclasses.asdict(got["cfg"]) == dataclasses.asdict(
                want["cfg"])
            assert dataclasses.asdict(got["shape"]) == dataclasses.asdict(
                want["shape"])
    assert n_skip       # the encoder's decodes, full attention at 500k


def _cpu_state(model, tcfg, n, gen):
    from repro_torch.core import algo
    from repro_torch.optim import make_optimizer
    from repro_torch.train.state import TrainState, stack_for_nodes
    params = stack_for_nodes(model.init(gen, "cpu"), n)
    opt = make_optimizer(tcfg.optimizer, per_node=True)
    return TrainState(params=params, opt_state=opt.init(params), step=0,
                      extras=algo.init_extras(tcfg.dist, params, n))


def _cpu_batch(cfg, n, per_node, seq, gen):
    from repro_torch.launch.specs import batch_specs
    sds, _ = batch_specs(cfg, n, n * per_node, seq)
    out = {}
    for k, t in sds.items():
        if t.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab_size, t.shape,
                                   generator=gen).to(torch.int32)
        elif t.dtype == torch.bool:
            out[k] = torch.rand(t.shape, generator=gen) < 0.3
        else:
            out[k] = torch.randn(t.shape, generator=gen).to(t.dtype)
    return out


@pytest.mark.parametrize("arch,phases", (
    ("pga-lm-100m", ("gossip", "global")), ("qwen3-moe-30b-a3b", ("gossip",)),
    ("jamba-1.5-large-398b", ("global",)), ("bert-large", ("gossip",))))
def test_meta_flops_equal_a_cpu_steps(arch, phases):
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models.model import make_model
    from repro_torch.train.step import build_train_step
    cfg = get_model_config(arch, reduced=True)
    shape = InputShape("t", 16, 8, "train")
    meta_mesh = make_mesh(*SMALL_MESH, device="meta")
    cpu_mesh = make_mesh(*SMALL_MESH, device="cpu")
    dist = DistConfig(comm_compression="int8", comm_error_feedback=True)
    gen = torch.Generator().manual_seed(0)
    model = make_model(cfg)
    for phase in phases:
        costs, (state, _), specs, tcfg = dryrun._run_train(
            cfg, shape, meta_mesh, dist=dist, phase=phase)
        assert all(t.device.type == "meta"
                   for t in dryrun.tree_leaves(state.params))
        tcfg = TrainConfig(model=cfg, dist=dist,
                           optimizer=OptimizerConfig(), global_batch=8,
                           seq_len=16)
        step = build_train_step(model, tcfg, 4, phase=phase, mesh=cpu_mesh)
        cpu_state = _cpu_state(model, tcfg, 4, gen)
        batch = _cpu_batch(cfg, 4, 2, 16, gen)
        with FlopCounterMode(display=False) as fc:
            new, metrics = step(cpu_state, batch, tcfg.optimizer.lr)
        assert costs["flops"] == fc.get_total_flops() > 0, phase
        assert torch.isfinite(metrics["loss"])
    if cfg.family == "encoder":
        return
    kind = InputShape("d", 32, 2, "decode")
    costs, (logits, _), specs = dryrun._run_serve(cfg, kind, meta_mesh,
                                                  param_sharding="tp")
    params = model.init(gen, "cpu")
    caches = model.init_cache(2, 32, device="cpu")
    node = dryrun._node
    tokens = torch.randint(0, cfg.vocab_size, (1, 2, 1), generator=gen)
    with FlopCounterMode(display=False) as fc:
        out, _ = model.decode_step(node(params), caches, tokens.to(
            torch.int32), torch.tensor([3, 7], dtype=torch.int32))
    assert costs["flops"] == fc.get_total_flops() > 0
    assert tuple(logits.shape) == tuple(out.shape)


@pytest.mark.parametrize("over", (
    dict(),
    dict(comm_compression="int8", comm_error_feedback=True,
         comm_global_compression="int8"),
    dict(topology="one_peer_exp", comm_dtype="bfloat16"),
    dict(comm_compression="topk", comm_compression_k=8,
         comm_error_feedback=True),
))
def test_wire_record_equals_the_references_round_wire_bytes(over):
    import jax
    import numpy as np

    from repro.compress import round_wire_bytes as jwire
    from repro.configs import get_model_config as jget
    from repro.models.model import make_model as jmake
    arch = "deepseek-v2-lite-16b"
    cfg = get_model_config(arch, reduced=True)
    sds = jax.eval_shape(lambda k: jmake(jget(arch, reduced=True)).init(k)[0],
                         jax.random.PRNGKey(0))
    sizes = [int(np.prod(lf.shape)) for lf in jax.tree.leaves(sds)]
    mesh = make_mesh(*SMALL_MESH, device="meta")
    dist = DistConfig(**over)
    rec = dryrun.dryrun_train(cfg, InputShape("t", 16, 4, "train"), mesh,
                              dist=dist)
    for phase in ("gossip", "global"):
        wire = rec["phases"][phase]["wire"]
        kw = dict(comm_dtype=dist.comm_dtype,
                  compression=dist.comm_compression,
                  k=dist.comm_compression_k, n_pods=dist.n_pods,
                  leaf_sizes=sizes,
                  global_compression=dist.comm_global_compression)
        want = jwire(phase, dist.topology, 4, sum(sizes), **kw)
        assert wire["bytes_per_node"] == want
        assert wire["bytes_per_device"] == want      # reference backend
        assert wire["model_shards"] == 1
        assert wire["fp32_bytes_per_node"] == jwire(
            phase, dist.topology, 4, sum(sizes), n_pods=dist.n_pods)
        rl = rec["phases"][phase]["roofline"]
        assert rl == rec["phases"][phase]["roofline_raw_scan"]
        assert rl["collective_s"] * 450e9 == pytest.approx(rl["coll_bytes"])


def _dict_keys(node) -> list:
    return [k.value for k in node.keys if isinstance(k, ast.Constant)]


def test_record_keys_equal_the_references():
    tree = ast.parse((REF / "dryrun.py").read_text())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    phase_keys = wire_keys = serve_keys = mem_keys = None
    for node in ast.walk(fns["dryrun_train"]):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and "roofline" in _dict_keys(node.value):
            phase_keys = _dict_keys(node.value)
            wire_keys = _dict_keys(node.value.values[
                phase_keys.index("wire")])
    for node in ast.walk(fns["dryrun_serve"]):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            serve_keys = _dict_keys(node.value)
    for node in ast.walk(fns["_mem_dict"]):
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Tuple):
            mem_keys = [e.value for e in node.value.elts]
    mesh = make_mesh(*SMALL_MESH, device="meta")
    cfg = get_model_config("pga-lm-100m", reduced=True)
    rec = dryrun.dryrun_train(cfg, InputShape("t", 16, 4, "train"), mesh,
                              dist=DistConfig(), phases=("gossip",))
    assert sorted(rec) == ["mode", "n_nodes", "phases"]
    ph = rec["phases"]["gossip"]
    assert list(ph) == phase_keys + ["coll_modelled"]
    assert list(ph["wire"]) == wire_keys and ph["coll_modelled"] == "round"
    assert list(ph["memory"]) == mem_keys
    serve = dryrun.dryrun_serve(cfg, InputShape("d", 16, 2, "decode"), mesh,
                                param_sharding="tp")
    assert list(serve) == serve_keys + ["coll_modelled"]
    assert serve["coll_modelled"] == "none" and serve["roofline"][
        "coll_bytes"] == 0
    assert list(serve["memory"]) == mem_keys
    from repro.roofline.analysis import Roofline as JRoofline
    jkeys = list(JRoofline(0.0, 0.0, 0.0, {}, 0.0, 0.0, 0.0).to_dict())
    assert list(ph["roofline"]) == jkeys == list(serve["roofline"])


@pytest.mark.parametrize("opt", ("sgd", "adamw"))
def test_argument_bytes_equal_a_cpu_states(opt):
    """What ``[drycard]`` holds on the card, at a reduced size: the
    argument bytes of ``dryrun_train`` with the caller's optimizer (per
    chip × n, the replicated leaves once) equal the bytes of the real
    state and batch; AdamW's moments count."""
    from repro_torch.models.model import make_model
    from repro_torch.launch.specs import train_specs
    cfg = get_model_config("pga-lm-100m", reduced=True)
    n = 4
    shape = InputShape("t", 16, 8, "train")
    mesh = make_mesh((n, 1), ("data", "model"), device="meta")
    optimizer = OptimizerConfig(name=opt)
    dist = DistConfig(topology="one_peer_exp", H=3)
    rec = dryrun.dryrun_train(cfg, shape, mesh, dist=dist,
                              optimizer=optimizer)
    specs = train_specs(cfg, mesh, shape, dist=dist, optimizer=optimizer)
    _, replicated = dryrun.argument_bytes(
        (specs.state_sds, specs.batch_sds),
        (specs.state_shardings, specs.batch_shardings), mesh)
    tcfg = TrainConfig(model=cfg, dist=dist, optimizer=optimizer,
                       global_batch=8, seq_len=16)
    gen = torch.Generator().manual_seed(0)
    state = _cpu_state(make_model(cfg), tcfg, n, gen)
    batch = _cpu_batch(cfg, n, 2, 16, gen)
    real = sum(t.numel() * t.element_size() for t in dryrun.tree_leaves(
        (state.params, state.opt_state, state.extras, batch)))
    for phase in ("gossip", "global"):
        arg = rec["phases"][phase]["memory"]["argument_size_in_bytes"]
        assert (arg - replicated) * n + replicated == real, phase
    sgd = dryrun.dryrun_train(cfg, shape, mesh, dist=dist,
                              phases=("gossip",))
    more = rec["phases"]["gossip"]["roofline"]["hlo_bytes"] > sgd[
        "phases"]["gossip"]["roofline"]["hlo_bytes"]
    assert more == (opt == "adamw")


def test_run_one_records_a_failure_with_its_traceback(monkeypatch):
    bad = dataclasses.replace(
        get_model_config("deepseek-v2-lite-16b", reduced=True),
        mla=dataclasses.replace(
            get_model_config("deepseek-v2-lite-16b", reduced=True).mla,
            q_lora_rank=16))
    monkeypatch.setattr(dryrun, "plan_for", lambda arch, shape: {
        "cfg": bad, "shape": INPUT_SHAPES[shape]})
    rec = dryrun.run_one("deepseek-v2-lite-16b", "train_4k", "single")
    assert rec["ok"] is False
    assert rec["error"].startswith("ValueError: MLAConfig.q_lora_rank=16")
    assert "Traceback" in rec["traceback"] and "check_supported" in \
        rec["traceback"]
    assert sorted(rec) == ["arch", "error", "mesh", "ok", "shape",
                           "traceback"]


def test_main_writes_one_jsonl_line(tmp_path, monkeypatch, capsys):
    out = tmp_path / "r.jsonl"
    monkeypatch.setattr("sys.argv", ["dryrun", "--arch", "qwen2-0.5b",
                                     "--shape", "decode_32k", "--out",
                                     str(out)])
    assert dryrun.main() == 0
    lines = out.read_text().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["ok"]) == (
        "qwen2-0.5b", "decode_32k", "single", True)
    assert rec["mode"] == "serve_tp" and rec["roofline"]["flops"] > 0
    assert "1 ok, 0 skipped (documented), 0 FAILED" in capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["dryrun", "--arch", "hubert-xlarge",
                                     "--shape", "decode_32k", "--out",
                                     str(out)])
    assert dryrun.main() == 0
    assert json.loads(out.read_text().splitlines()[1])["skipped"] == \
        "hubert-xlarge is encoder-only: no decode step"


def test_hillclimb_record_writes_the_references_fields(ref_launch, tmp_path,
                                                      capsys):
    _, jh = ref_launch
    assert hillclimb.OUT == jh.OUT
    train = {"arch": "a", "phases": {"gossip": {"roofline": {
        "dominant": "memory", "compute_s": 1.0, "memory_s": 2.0,
        "collective_s": 0.5}}}}
    serve = {"mode": "serve_2d", "roofline": {
        "dominant": "collective", "compute_s": 1.0, "memory_s": 2.0,
        "collective_s": 3.0}}
    for rec in (train, serve):
        got, want = tmp_path / "got.jsonl", tmp_path / "want.jsonl"
        hillclimb.record("exp", "v", "hyp", rec, str(got))
        jh.record("exp", "v", "hyp", rec, str(want))
        assert got.read_text() == want.read_text()
        got.unlink()
        want.unlink()
    capsys.readouterr()
    hillclimb.record("exp", "v", "hyp", dict(serve, coll_modelled="none"),
                     str(tmp_path / "none.jsonl"))
    line = capsys.readouterr().out
    assert "coll=not modelled" in line and "dominant=" not in line
    assert json.loads((tmp_path / "none.jsonl").read_text())[
        "coll_modelled"] == "none"


def test_kernel_wrappers_raise_on_meta_tensors():
    """A hand-written kernel's wrapper never computes its plain version on
    a meta tensor: the dry-run would count work no device does."""
    from repro_torch.kernels import flash_attention_cuda as fa
    from repro_torch.kernels import mixing_cuda as mc
    from repro_torch.kernels import mlstm_cuda as mk
    from repro_torch.kernels import rmsnorm_cuda as rn

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    x, d, M = meta(4, 64), meta(4, 1), meta(4, 4)
    xb, xs, db, Mb = meta(2, 64), meta(4, 64), meta(2, 1), meta(2, 4)
    q = meta(1, 16, 2, 32, dtype=torch.bfloat16)
    calls = [
        lambda: mc.mix_flat(x, None, None, d, M, with_g=False,
                            with_residual=False, wire=False),
        lambda: mc.cmix_flat(x, None, None, 1, d, d, M, kind="int8",
                             with_ef=False, wire=False),
        lambda: mc.cmix_absmax(x),
        lambda: mc.collective_flat(x, None, 1, 2, kind="int8",
                                   with_ef=False, n_pods=1, qblock=1024),
        lambda: mc.shard_mix_block(xb, xs, db, Mb),
        lambda: mc.shard_comp_mix_block(xb, xb, xs, db, Mb),
        lambda: fa.flash_attention(q, q, q, causal=True),
        lambda: rn.rmsnorm(meta(4, 64), meta(64), eps=1e-6),
        lambda: mk.mlstm_chunk(q, q, q, meta(1, 16, 2), meta(1, 16, 2),
                               chunk=16),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="device"):
            call()
