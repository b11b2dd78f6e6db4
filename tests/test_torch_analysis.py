"""repro_torch.analysis: each rule's flagged and clean cases, the two
host-sync faults the card found (replayed), the CUDA launch contract on a
synthetic ``cuda_build.py`` + ``.cu`` pair, the engine's suppression,
baseline and report semantics, the CLI contract — and the gate: the
port's own files are clean.

Fixtures are written under ``tmp_path`` at the port's registered
root-relative paths, so the rules' path and function registries match as
they do on the real tree.  Nothing of ``repro`` or JAX is imported: the
port's analysis stands alone.
"""
import json
import re
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.analysis.__main__ import BASELINE_NAME, DEFAULT_TARGETS
from repro_torch.analysis.__main__ import main as cli
from repro_torch.analysis.engine import (Baseline, FileContext, all_rules,
                                         analyze_file, analyze_paths,
                                         apply_baseline, format_findings,
                                         load_baseline, write_baseline)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TRAINER = "src/repro_torch/train/trainer.py"
STEP = "src/repro_torch/train/step.py"
MIXING = "src/repro_torch/core/mixing.py"
ENGINE = "src/repro_torch/serve/engine.py"
KERNEL = "src/repro_torch/kernels/toy_cuda.py"
COMPRESS = "src/repro_torch/compress/toy.py"
ALGORITHMS = "src/repro_torch/core/algorithms.py"
FAULTS = "src/repro_torch/core/faults.py"


def run(root, relpath, source):
    """Write ``source`` at ``relpath`` under ``root`` and analyze it;
    returns (findings, n_suppressed)."""
    f = root / relpath
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(textwrap.dedent(source))
    return analyze_file(root, f)


def rules_of(findings):
    return {f.rule for f in findings}


# ---------------------------------------------------------------------------
# RPR001-RPR005: (rule, path, source, flagged?, message fragment)
# ---------------------------------------------------------------------------
CASES = {
    # RPR001 — host syncs in registered hot scopes
    "rpr001_float_in_trainer_loop": ("RPR001", TRAINER, """\
        class Trainer:
            def run(self, state, steps):
                for _ in range(steps):
                    state, metrics = self._step(state)
                    self.history.append(float(metrics["loss"]))
                return state
        """, True, "float()"),
    "rpr001_item_in_step": ("RPR001", STEP, """\
        def step(x):
            return x.sum().item()
        """, True, ".item()"),
    "rpr001_tolist_in_mixing": ("RPR001", MIXING, """\
        def rows(x):
            return x.tolist()
        """, True, ".tolist()"),
    "rpr001_cpu_in_server_tick": ("RPR001", ENGINE, """\
        class BatchedServer:
            def run(self, logits):
                return logits.argmax(-1).cpu()
        """, True, ".cpu()"),
    "rpr001_numpy_in_generate": ("RPR001", ENGINE, """\
        class Engine:
            def generate(self, ids):
                return ids.numpy()
        """, True, ".numpy()"),
    "rpr001_np_asarray_in_mixing": ("RPR001", MIXING, """\
        import numpy as np
        def host(W):
            return np.asarray(W)
        """, True, "np.asarray"),
    "rpr001_cuda_synchronize_in_kernel": ("RPR001", KERNEL, """\
        import torch
        def launch(x):
            torch.cuda.synchronize()
            return x
        """, True, "synchronize"),
    "rpr001_event_synchronize": ("RPR001", STEP, """\
        def step(ev):
            ev.synchronize()
        """, True, ".synchronize()"),
    # ROADMAP C.5: a CPU scalar tensor into torch.where, 24 syncs a step
    "rpr001_c5_replay_where_cpu_scalar": ("RPR001", STEP, """\
        import torch
        def _sdpa(q, k, mask):
            s = q @ k.transpose(-1, -2)
            neg = torch.tensor(-1e30, dtype=s.dtype)
            s = torch.where(mask, s, neg)
            return torch.softmax(s, -1)
        """, True, "torch.where"),
    "rpr001_c5_inline_masked_fill": ("RPR001", STEP, """\
        import torch
        def _sdpa(s, mask):
            return s.masked_fill(~mask, torch.as_tensor(-1e30))
        """, True, ".masked_fill"),
    # ROADMAP C.5's other fault: a scalar written into a CUDA tensor in
    # the MoE dispatch
    "rpr001_moe_replay_mask_scalar_write": ("RPR001", STEP, """\
        def _dispatch(slot, counts, cap):
            full = counts >= cap
            slot[full] = 0
            return slot
        """, True, "boolean mask"),
    "rpr001_moe_cpu_tensor_index_write": ("RPR001", STEP, """\
        import torch
        def _dispatch(tables, idx, T):
            tables[idx] = torch.tensor(T)
            return tables
        """, True, "written through an index"),
    "rpr001_clean_device_constants": ("RPR001", STEP, """\
        import torch
        def _sdpa(s, mask, slot, i):
            s = s.masked_fill(~mask, -1e30)          # a Python float
            neg = torch.tensor(-1e30, device=s.device)
            slot[i] = 0                              # a plain index
            n = int(s.shape[0])                      # host ints pass
            return torch.where(mask, s, neg), n
        """, False, ""),
    "rpr001_unregistered_function": ("RPR001", TRAINER, """\
        class Trainer:
            def _log_boundary(self, metrics):
                return float(metrics["loss"])
        """, False, ""),
    # RPR002 — the CommSpec call form
    "rpr002_kwargs_form": ("RPR002", "src/repro_torch/train/x.py", """\
        from repro_torch.core import mixing
        def f(p):
            return mixing.communicate(p, phase="gossip", topology="ring",
                                      n_nodes=4)
        """, True, "topology"),
    "rpr002_starred_dict": ("RPR002", "src/repro_torch/train/x.py", """\
        from repro_torch.core.mixing import communicate_sharded as cs
        def f(p):
            kw = dict(topology="ring", mesh=None)
            return cs(p, phase="gossip", **kw)
        """, True, "mesh"),
    "rpr002_module_local_call": ("RPR002", MIXING, """\
        def communicate(params, spec, *, phase, step=0):
            return params
        def flush(p):
            return communicate(p, phase="global", n_nodes=4)
        """, True, "n_nodes"),
    "rpr002_spec_form": ("RPR002", "src/repro_torch/train/x.py", """\
        from repro_torch.core import mixing
        def f(p, spec):
            return mixing.communicate(p, spec, phase="gossip", step=3)
        """, False, ""),
    # RPR003 (a) — the overlap buffer's alias-escape
    "rpr003_returned_alias": ("RPR003", STEP, """\
        from repro_torch.core import mixing
        def slowmo(y, spec):
            buf, ef = mixing.start_round(y, spec)
            return y, buf
        """, True, "returned beside it"),
    "rpr003_through_constructor": ("RPR003", STEP, """\
        from repro_torch.core import mixing
        def f(y, spec, opt):
            buf, _ = mixing.start_round(y, spec)
            st = TrainState(params=y, opt_state=opt, step=0)
            return st, buf
        """, True, "returned beside it"),
    "rpr003_attribute_store": ("RPR003", TRAINER, """\
        from repro_torch.core import mixing
        class Trainer:
            def _flush(self, state, spec):
                mixed, buf, ef = mixing.overlap_flush(state.params, spec,
                                                      phase="global")
                self._comm_buf = buf
                return mixed
        """, True, "stored without a copy"),
    "rpr003_copy_in_one_arm_only": ("RPR003", STEP, """\
        import torch
        from repro_torch.core import mixing
        from repro_torch.tree import tree_map
        def f(y, spec, phase):
            buf, _ = mixing.start_round(y, spec)
            if phase == "global":
                buf = tree_map(torch.clone, buf)
            return y, buf
        """, True, "returned beside it"),
    "rpr003_clone_rebind": ("RPR003", STEP, """\
        import torch
        from repro_torch.core import mixing
        from repro_torch.tree import tree_map
        def f(y, spec):
            buf, _ = mixing.start_round(y, spec)
            buf = tree_map(torch.clone, buf)
            return y, buf
        """, False, ""),
    # RPR003 (b) — in-place launches
    "rpr003_inplace_on_callers_tensor": ("RPR003", KERNEL, """\
        def round_(xf, d, M):
            return mix_flat(xf.contiguous(), None, None, d, M, with_g=False,
                            with_residual=False, wire=False, inplace=True)
        """, True, "in-place launch on 'xf'"),
    "rpr003_inplace_on_a_view_of_one": ("RPR003", KERNEL, """\
        def round_(params, d, M):
            xf = params["w"].reshape(4, -1)
            return mix_flat(xf, None, None, d, M, with_g=False,
                            with_residual=False, wire=False, inplace=True)
        """, True, "in-place launch on 'xf'"),
    "rpr003_pointer_test_on_another_tensor": ("RPR003", KERNEL, """\
        def round_(leaves, other, d, M):
            xf = _pack_rows(leaves, 4)
            private = other.data_ptr() != leaves[0].data_ptr()
            return mix_flat(xf, None, None, d, M, with_g=False,
                            with_residual=False, wire=False,
                            inplace=private)
        """, True, "in-place launch on 'xf'"),
    "rpr003_private_staging_buffer": ("RPR003", KERNEL, """\
        def round_(leaves, ef, d, M):
            xf = _pack_rows(leaves, 4)
            private = xf.data_ptr() != leaves[0].data_ptr()
            private = private and (ef.data_ptr() != leaves[1].data_ptr())
            return mix_flat(xf.contiguous(), None, None, d, M, with_g=False,
                            with_residual=False, wire=False,
                            inplace=private)
        """, False, ""),
    "rpr003_forwarded_decision_and_fresh_buffer": ("RPR003", KERNEL, """\
        import torch
        def mix_generic(xf, d, M, *, inplace=False):
            return _launch(xf, d, M, inplace=inplace)
        def check(x, d, M):
            stage, other = x.clone(), torch.empty_like(x)
            return mix_flat(stage, None, None, d, M, with_g=False,
                            with_residual=False, wire=False, inplace=True)
        """, False, ""),
    # RPR004 — runtime values out of the variant keys
    "rpr004_loop_target_in_key": ("RPR004", TRAINER, """\
        class Trainer:
            def _get_step_fn(self, phase, shift, buf_shift=0):
                key = (phase, shift, buf_shift)
                if key not in self._steps:
                    self._steps[key] = build(phase, shift)
                return self._steps[key]
            def _run(self, state, steps):
                for k in range(steps):
                    fn = self._get_step_fn("gossip", k)
                    state = fn(state)
                return state
        """, True, "loop-varying 'k'"),
    "rpr004_derived_from_step": ("RPR004", TRAINER, """\
        class Trainer:
            def _variant_scope(self, key):
                if key in self._metered:
                    return None
                self._metered.add(key)
            def _run(self, state, steps):
                for k in range(steps):
                    lr = self.lr_fn(k)
                    self._variant_scope(("gossip", lr))
        """, True, "loop-varying 'lr'"),
    "rpr004_schedule_answers_are_static": ("RPR004", TRAINER, """\
        class Trainer:
            def _get_step_fn(self, phase, shift, buf_shift=0):
                key = (phase, shift, buf_shift)
                if key not in self._steps:
                    self._steps[key] = build(phase, shift)
                return self._steps[key]
            def _run(self, state, steps):
                for k in range(steps):
                    phase = self.schedule.advance(k)
                    shift = self.schedule.gossip_shift_step(k, self.period)
                    bs = self._buf_shift if phase == "gossip" else 0
                    fn = self._get_step_fn(phase, shift, buf_shift=bs)
                    state, self._comm_buf = fn(state, self.batch(k))
                    self._buf_shift = shift
                return state
        """, False, ""),
    "rpr004_unhashable_key": ("RPR004", ALGORITHMS, """\
        def simulate(steps):
            metered = set()
            def once(key):
                if key in metered:
                    return None
                metered.add(key)
            once(["sync", "gossip"])
        """, True, "unhashable"),
    "rpr004_push_sum_W_in_key": ("RPR004", ALGORITHMS, """\
        import functools
        @functools.lru_cache(maxsize=8)
        def factors(phase, W):
            return phase
        def f(W):
            return factors("gossip", W)
        """, True, "'W'"),
    "rpr004_lru_cache_keyed_on_loop_step": ("RPR004", KERNEL, """\
        import functools
        @functools.lru_cache(maxsize=64)
        def _device_factors(phase, step):
            return phase, step
        def rounds(n):
            for k in range(n):
                _device_factors("gossip", k)
        """, True, "loop-varying 'k'"),
    # RPR005 — counter-hash-only randomness in device modules
    "rpr005_np_random": ("RPR005", MIXING, """\
        import numpy as np
        def noise(n):
            return np.random.standard_normal(n)
        """, True, "np.random"),
    "rpr005_stdlib_random": ("RPR005", COMPRESS, """\
        from random import random
        def coin():
            return random() < 0.5
        """, True, "stdlib"),
    "rpr005_torch_global_generator": ("RPR005", COMPRESS, """\
        import torch
        def dither(x):
            return x + torch.rand(x.shape)
        """, True, "torch.rand"),
    "rpr005_inplace_draw": ("RPR005", KERNEL, """\
        def fill(x):
            return x.uniform_(-1, 1)
        """, True, ".uniform_"),
    "rpr005_explicit_generator": ("RPR005", COMPRESS, """\
        import torch
        def dither(x, gen):
            return x + torch.rand(x.shape, generator=gen)
        """, False, ""),
    "rpr005_host_schedule_exempt": ("RPR005", FAULTS, """\
        import numpy as np
        def events(seed):
            return np.random.default_rng(seed).random(4)
        """, False, ""),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rule_cases(tmp_path, case):
    rule, path, source, flagged, fragment = CASES[case]
    findings, _ = run(tmp_path, path, source)
    mine = [f for f in findings if f.rule == rule]
    if flagged:
        assert mine, f"{case}: {rule} not reported"
        assert any(fragment in f.message for f in mine), \
            [f.message for f in mine]
    else:
        assert mine == [], format_findings(mine, "text")


# ---------------------------------------------------------------------------
# RPR006 — the CUDA launch contract on a synthetic cuda_build.py + .cu pair
# ---------------------------------------------------------------------------
TOY_BUILD = """\
import ctypes
_P, _LL, _I = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int)
ENTRY_POINTS = {
    "toy": ("toy", "repro_toy", [_P] * 2 + [_LL, _I] + [_P]),
    "toy_pair": ("toy", "repro_toy_pair", [_P] * 2 + [_I] * 2 + [_P]),
}


def entry(name):
    raise NotImplementedError
"""
TOY_CU = """\
extern "C" int repro_toy(const void* x, void* o, long long D, int n,
                         void* stream) {
  return 0;
}
extern "C" int repro_toy_pair(const void* x, void* o, int a, int b,
                              void* stream) {
  return 0;
}
"""
TOY_WRAPPER = """\
from repro_torch.kernels import cuda_build


def _check_launch(err, what):
    if err != 0:
        raise RuntimeError(what)


def _check_operands(x):
    if x.dim() != 2:
        raise ValueError("toy")


def toy(x, o, stream):
    _check_operands(x)
    err = cuda_build.entry("toy")(x, o, 4, 1, stream)
    _check_launch(err, "toy")
    return o


def _launch(lib, x, o, *extra):
    args = (x, o)
    err = cuda_build.entry(lib)(*args, *extra, 0)
    if err != 0:
        raise RuntimeError(lib)
    return o


def toy_pair(x, o):
    _check_operands(x)
    return _launch("toy_pair", x, o, 1, 2)


def toy_again(x, o):
    _check_operands(x)
    return _launch("toy", x, o, 4, 1)
"""
MUTATIONS = {
    "clean": (None, None, None, ""),
    "one_argument_too_many": (
        TOY_WRAPPER, 'entry("toy")(x, o, 4, 1, stream)',
        'entry("toy")(x, o, 4, 1, 1, stream)', "launched with 6"),
    "unknown_entry_name": (
        TOY_WRAPPER, 'entry("toy")(x', 'entry("toyy")(x',
        "not a key of ENTRY_POINTS"),
    "c_signature_one_parameter_short": (
        TOY_CU, "long long D, int n,", "long long D,",
        "takes 4 parameter(s)"),
    "c_type_cut_to_32_bits": (
        TOY_CU, "long long D, int n,", "int D, int n,", "need ['c_int']"),
    "dropped_return_code": (
        TOY_WRAPPER, '    err = cuda_build.entry("toy")(x, o, 4, 1, stream)\n'
        '    _check_launch(err, "toy")\n',
        '    cuda_build.entry("toy")(x, o, 4, 1, stream)\n',
        "return code is dropped"),
    "launch_before_operand_checks": (
        TOY_WRAPPER, '    _check_operands(x)\n    err =', '    err =',
        "operand checks"),
    "private_helper_with_an_unchecked_caller": (
        TOY_WRAPPER, '    _check_operands(x)\n    return _launch("toy_pair"',
        '    return _launch("toy_pair"', "operand checks"),
    "extra_arguments_miscounted": (
        TOY_WRAPPER, '_launch("toy_pair", x, o, 1, 2)',
        '_launch("toy_pair", x, o, 1)', "launched with 4"),
    "entry_name_not_a_literal": (
        TOY_WRAPPER, '_launch("toy", x, o, 4, 1)', '_launch(NAME, x, o, 4, 1)',
        "not resolvable"),
}


def _toy_tree(root, mutation):
    target, old, new, _ = MUTATIONS[mutation]
    files = {"src/repro_torch/kernels/cuda_build.py": TOY_BUILD,
             "src/repro_torch/csrc/toy.cu": TOY_CU, KERNEL: TOY_WRAPPER}
    if target is not None:
        name = next(k for k, v in files.items() if v is target)
        assert old in files[name], mutation
        files[name] = files[name].replace(old, new)
    for rel, text in files.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(text)


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_rpr006_launch_contract(tmp_path, mutation):
    _toy_tree(tmp_path, mutation)
    findings, _ = analyze_file(tmp_path, tmp_path / KERNEL)
    mine = [f for f in findings if f.rule == "RPR006"]
    fragment = MUTATIONS[mutation][3]
    if not fragment:
        assert mine == [], format_findings(mine, "text")
    else:
        assert mine and any(fragment in f.message for f in mine), \
            format_findings(mine, "text")


def test_rpr006_covers_every_launch_site_of_the_port():
    """The rule resolves all 15 ``cuda_build.entry(...)`` launch sites of
    ``kernels/*.py`` — the two that pass the name through ``lib`` to the
    literals of their callers, the ones that pass ``*args`` through their
    tuple — and between them they reach all 17 entry points."""
    import ast

    from repro_torch.analysis.rules import pallas_contracts as pc
    sites, names = 0, set()
    for f in sorted((REPO / "src" / "repro_torch" / "kernels").glob("*.py")):
        rel = f.relative_to(REPO).as_posix()
        src = f.read_text()
        ctx = FileContext(rel, src, ast.parse(src), REPO)
        for call in pc.launch_sites(ctx):
            sites += 1
            names |= {name for name, _ in pc.resolve_launch(ctx, call)}
    assert sites == 15
    assert names == set(pc.entry_points(REPO)) and len(names) == 17


# ---------------------------------------------------------------------------
# engine semantics: suppressions, RPR000, baseline
# ---------------------------------------------------------------------------
ONE_SYNC = """\
    class Trainer:
        def run(self, state):
            return float(state.loss)
    """


@pytest.mark.parametrize("marker,suppressed", [
    ("x = float(state.loss)  # repro: allow(RPR001)", 1),
    ("# repro: allow(RPR001) -- deliberate final fetch\n"
     "                x = float(state.loss)", 1),
    ("x = float(state.loss)  # repro: allow(RPR002, RPR001)", 1),
    ("x = float(state.loss)  # repro: allow(RPR002)", 0),
])
def test_suppression(tmp_path, marker, suppressed):
    findings, n = run(tmp_path, TRAINER, f"""\
        class Trainer:
            def run(self, state):
                {marker}
                return x
        """)
    assert n == suppressed
    assert rules_of(findings) == (set() if suppressed else {"RPR001"})


def test_syntax_error_is_a_finding(tmp_path):
    findings, _ = run(tmp_path, "src/repro_torch/broken.py", "def f(:\n")
    assert rules_of(findings) == {"RPR000"}


def test_baseline_absorbs_up_to_count(tmp_path):
    findings, _ = run(tmp_path, TRAINER, """\
        class Trainer:
            def run(self, state):
                a = float(state.a)
                b = float(state.b)
                return a, b
        """)
    assert len(findings) == 2
    kept, absorbed = apply_baseline(findings, Baseline(
        entries={("RPR001", TRAINER): (1, "known debt")}))
    assert absorbed == 1 and len(kept) == 1
    kept2, absorbed2 = apply_baseline(findings, Baseline(
        entries={("RPR001", "src/other.py"): (9, "")}))
    assert absorbed2 == 0 and len(kept2) == 2


def test_baseline_write_load_roundtrip(tmp_path):
    findings, _ = run(tmp_path, TRAINER, ONE_SYNC)
    bpath = tmp_path / "deep" / "baseline.json"
    write_baseline(bpath, findings)
    data = json.loads(bpath.read_text())
    assert data["version"] == 1
    assert data["entries"][0]["rule"] == "RPR001"
    assert data["entries"][0]["path"] == TRAINER
    kept, absorbed = apply_baseline(findings, load_baseline(bpath))
    assert kept == [] and absorbed == 1
    assert load_baseline(tmp_path / "missing.json").entries == {}


# ---------------------------------------------------------------------------
# report formats
# ---------------------------------------------------------------------------
def test_report_formats(tmp_path):
    findings, _ = run(tmp_path, TRAINER, ONE_SYNC)
    assert len(findings) == 1
    doc = json.loads(format_findings(findings, "json", suppressed=2,
                                     baselined=3))
    assert doc["version"] == 1 and doc["counts"] == {"RPR001": 1}
    assert doc["suppressed"] == 2 and doc["baselined"] == 3
    (f,) = doc["findings"]
    assert set(f) == {"rule", "path", "line", "col", "message"}
    assert f["rule"] == "RPR001" and f["path"] == TRAINER
    assert re.fullmatch(
        r"::error file=src/repro_torch/train/trainer\.py,line=\d+,col=\d+,"
        r"title=RPR001::.+", format_findings(findings, "github"))
    text = format_findings(findings, "text", suppressed=1, baselined=0)
    assert text.splitlines()[0].startswith(f"{TRAINER}:3:")
    assert text.splitlines()[-1] == "1 finding(s) (1 suppressed, 0 baselined)"
    with pytest.raises(ValueError):
        format_findings(findings, "xml")


# ---------------------------------------------------------------------------
# CLI contract
# ---------------------------------------------------------------------------
def test_cli_exit_codes_and_artifact(tmp_path, capsys):
    (tmp_path / "src" / "repro_torch").mkdir(parents=True)
    (tmp_path / "src" / "repro_torch" / "ok.py").write_text("X = 1\n")
    assert cli(["--root", str(tmp_path)]) == 0      # the default targets
    capsys.readouterr()
    (tmp_path / TRAINER).parent.mkdir(parents=True)
    (tmp_path / TRAINER).write_text(textwrap.dedent(ONE_SYNC))
    out_file = tmp_path / "findings.json"
    rc = cli(["src/repro_torch", "--root", str(tmp_path), "--format",
              "github", "--out", str(out_file)])
    assert rc == 1
    assert "::error file=" in capsys.readouterr().out
    # the --out artifact is always JSON, whatever the console format
    assert json.loads(out_file.read_text())["counts"] == {"RPR001": 1}
    # a glob target
    assert cli(["src/*/train/*.py", "--root", str(tmp_path)]) == 1
    capsys.readouterr()
    assert cli(["no/such/dir", "--root", str(tmp_path)]) == 2
    assert cli(["--root", str(tmp_path / "src")]) == 2   # not the port's
    assert cli(["tests/test_none_*.py", "--root", str(tmp_path)]) == 2
    with pytest.raises(SystemExit) as e:
        cli(["--format", "xml"])
    assert e.value.code == 2


def test_cli_write_baseline_is_the_ports_own_file(tmp_path, capsys):
    """Under a root that holds both packages' baselines, --write-baseline
    writes the port's and leaves the JAX package's byte for byte."""
    jax_baseline = tmp_path / "analysis_baseline.json"
    jax_bytes = b'{\n  "version": 1,\n  "entries": []\n}\n'
    jax_baseline.write_bytes(jax_bytes)
    (tmp_path / BASELINE_NAME).parent.mkdir(parents=True, exist_ok=True)
    (tmp_path / BASELINE_NAME).write_text('{"version": 1, "entries": []}\n')
    (tmp_path / TRAINER).parent.mkdir(parents=True)
    (tmp_path / TRAINER).write_text(textwrap.dedent(ONE_SYNC))
    assert cli(["--root", str(tmp_path)]) == 1
    assert cli(["--root", str(tmp_path), "--write-baseline"]) == 0
    capsys.readouterr()
    assert jax_baseline.read_bytes() == jax_bytes
    entries = json.loads((tmp_path / BASELINE_NAME).read_text())["entries"]
    assert [(e["rule"], e["path"]) for e in entries] == [("RPR001", TRAINER)]
    # the debt is tracked: the gate is green until the file changes
    assert cli(["--root", str(tmp_path)]) == 0
    assert "1 baselined" in capsys.readouterr().out
    assert cli(["--root", str(tmp_path), "--no-baseline"]) == 1


def test_cli_lists_the_six_rules(capsys):
    assert cli(["--list-rules"]) == 0
    out = capsys.readouterr().out
    ids = re.findall(r"^(RPR\d{3}) ", out, flags=re.M)
    assert ids == [f"RPR00{i}" for i in range(1, 7)]
    assert [r.id for r in all_rules()] == ids


# ---------------------------------------------------------------------------
# registry self-check: HOT_PATHS resolves against the real port tree
# ---------------------------------------------------------------------------
def _def_qualnames(path):
    import ast
    names = set()

    def walk(node, stack):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                qual = stack + [child.name]
                if not isinstance(child, ast.ClassDef):
                    names.add(".".join(qual))
                walk(child, qual)
            else:
                walk(child, stack)

    walk(ast.parse(path.read_text()), [])
    return names


def test_hot_paths_registry_resolves():
    """Every HOT_PATHS entry matches at least one file of the port, and
    each function glob a function defined there: a hot path renamed or
    moved must fail here instead of silently losing its protection."""
    import fnmatch

    from repro_torch.analysis.rules.host_sync import HOT_PATHS
    files = [p.relative_to(REPO).as_posix()
             for p in (REPO / "src" / "repro_torch").rglob("*.py")]
    for pat, fn_globs in HOT_PATHS:
        matches = [f for f in files if fnmatch.fnmatch(f, pat)]
        assert matches, f"HOT_PATHS glob {pat!r} matches no port file"
        quals = set()
        for m in matches:
            quals |= _def_qualnames(REPO / m)
        for g in fn_globs:
            assert g == "*" or any(fnmatch.fnmatch(q, g) for q in quals), (
                f"HOT_PATHS function glob {g!r} resolves to no function "
                f"under {pat!r}")


# ---------------------------------------------------------------------------
# the gate: the port's own files are clean
# ---------------------------------------------------------------------------
def test_port_is_clean():
    """The default targets carry zero unsuppressed findings, with the
    port's baseline empty: every deliberate exception is an allow marker
    with its reason on the line."""
    assert load_baseline(REPO / BASELINE_NAME).entries == {}
    findings, suppressed = analyze_paths(REPO, DEFAULT_TARGETS)
    assert findings == [], "\n" + format_findings(findings, "text")
    assert suppressed > 0
