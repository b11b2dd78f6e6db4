"""The port's examples and ``quick_train`` on the CPU.

Each ``examples/torch_*.py`` runs in a subprocess with ``--device cpu``
and small arguments and prints the lines the reference's script prints
(``torch_train_lm.py`` twice: the second run resumes from the first's
checkpoint through the port's ``restore_checkpoint``).
``repro_torch.train.quick_train(..., device="cpu")`` is bitwise a Trainer
built, initialised from the same seed and run by hand, and its history
has the phases of the reference's ``quick_train`` for the same config
(the two inits draw different values, so nothing else is compared).
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import base as tcfg
from repro_torch.configs import pga_lm_100m as tarch
from repro_torch.train import Trainer, quick_train

REPO = Path(__file__).resolve().parents[1]


def _run(script, *args, timeout=180):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, str(REPO / "examples" / script),
                          "--device", "cpu", *args], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_torch_quickstart_prints_the_final_metrics():
    out = _run("torch_quickstart.py", "--steps", "2", "--nodes", "4")
    assert "=== final metrics (non-iid ring, H=6) ===" in out
    for alg in ("gossip", "local", "gossip_pga"):
        assert re.search(rf"^{alg} +loss=\d+\.\d{{4}} consensus=", out,
                         re.M), out


def test_torch_train_lm_trains_checkpoints_and_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    args = ("--steps", "2", "--nodes", "4", "--seq-len", "16",
            "--ckpt-dir", ckpt)
    out = _run("torch_train_lm.py", *args)
    assert re.search(r"^model pga-lm-reduced: ~\d+\.\dM params, 4 nodes, "
                     r"gossip_pga/one_peer_exp H=6$", out, re.M), out
    assert re.search(r"^loss \d+\.\d{4} -> \d+\.\d{4} over 2 steps; final "
                     r"consensus ", out, re.M), out
    assert sorted(os.listdir(ckpt)) == ["ckpt_00000001.npz",
                                        "ckpt_00000002.npz", "manifest.json"]
    out = _run("torch_train_lm.py", *args, "--resume")
    assert "resumed from step 2" in out
    assert "step     3 " in out and "step     0 " not in out


def test_torch_serve_requests_serves_every_request():
    out = _run("torch_serve_requests.py", "--requests", "3", "--max-new",
               "4")
    assert re.search(r"^served 3 requests / 12 tokens in ", out, re.M), out
    for i in range(3):
        assert re.search(rf"^  req {i}: prompt\[\d+\] -> \[(\d+, ){{3}}\d+\]$",
                         out, re.M), out


def test_torch_logistic_regression_prints_the_table():
    out = _run("torch_logistic_regression.py", "--n", "8", "--steps", "20")
    lines = out.splitlines()
    assert lines[0] == "n=8 topology=ring non-iid H=16"
    assert lines[1].split() == ["iter", "parallel", "gossip", "local",
                                "gossip_pga", "gossip_aga"]
    rows = [ln for ln in lines if re.match(r"^ +\d+( +\d+\.\d{5}){5}$", ln)]
    # every 2nd iteration, and the last
    assert [int(r.split()[0]) for r in rows] == list(range(0, 20, 2)) + [19]
    assert "consensus ‖x−x̄‖²/n at the end:" in out
    assert re.search(r"^  parallel +0\.000e\+00$", out, re.M), out


def _tcfg():
    return tcfg.TrainConfig(
        model=dataclasses.replace(tarch.reduced_config(), dtype="float32"),
        dist=tcfg.DistConfig(algorithm="gossip_pga", topology="ring", H=2),
        optimizer=tcfg.OptimizerConfig(name="sgd", lr=0.05,
                                       schedule="constant", warmup_steps=0),
        global_batch=8, seq_len=8, log_every=1)


def test_quick_train_is_a_trainer_run_by_hand():
    """Bitwise: every field of every step record but the wall clock (the
    losses, consensus, gradient norm and lr of each step)."""
    tr = quick_train(_tcfg(), 4, 3, seed=5, with_consensus=True,
                     device="cpu")
    ref = Trainer(_tcfg(), 4, with_consensus=True, device="cpu")
    ref.run(ref.init_state(torch.Generator().manual_seed(5)), 3)

    def records(t):
        return [{k: v for k, v in h.items() if k not in ("time", "ts")}
                for h in t.history]
    assert len(tr.history) == 3
    assert records(tr) == records(ref)
    other = quick_train(_tcfg(), 4, 3, seed=6, with_consensus=True,
                        device="cpu")
    assert records(other) != records(ref)


def test_quick_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quick_train(_tcfg(), 4, 1)


def test_quick_train_phases_are_the_reference_quick_trains():
    from repro.configs import base as jcfg
    from repro.configs import pga_lm_100m as jarch
    from repro.train.trainer import quick_train as jquick_train
    jt = jcfg.TrainConfig(
        model=dataclasses.replace(jarch.reduced_config(), dtype="float32"),
        dist=jcfg.DistConfig(algorithm="gossip_pga", topology="ring", H=2),
        optimizer=jcfg.OptimizerConfig(name="sgd", lr=0.05,
                                       schedule="constant", warmup_steps=0),
        global_batch=8, seq_len=8, log_every=1)
    want = jquick_train(jt, 4, 3, seed=5, with_consensus=True)
    got = quick_train(_tcfg(), 4, 3, seed=5, with_consensus=True,
                      device="cpu")
    assert [h["phase"] for h in got.history] == \
        [h["phase"] for h in want.history] == ["gossip", "global", "gossip"]
    assert [h["step"] for h in got.history] == \
        [h["step"] for h in want.history]
