"""Port parity, continued from ``test_torch_trainer_algos.py`` (its
setup and tolerances): the Gossip-AGA Trainer, whose period moves within
the run, GT-PGA on the reference backend, and one CPU run of the training
CLI per new algorithm.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_trainer_algos import CASES, check_trainer_matches_reference

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("algorithm,backend", [
    ("gossip_aga", "pallas"), ("gt_pga", "reference")])
def test_trainer_matches_reference(algorithm, backend):
    check_trainer_matches_reference(algorithm, backend)


@pytest.mark.parametrize("algorithm", sorted(CASES))
def test_cli_runs_each_new_algorithm_on_cpu(algorithm):
    """``python -m repro_torch.launch.train --algorithm A --device cpu``:
    finite losses, the schedule's phases, consensus exactly 0 after every
    global (or SlowMo outer) step."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train",
         "--arch", "pga-lm-100m", "--algorithm", algorithm, "--nodes", "4",
         "--steps", "4", "--global-batch", "8", "--seq-len", "16",
         "--H", "2", "--topology", "ring", "--comm-backend", "pallas",
         "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if "] step" in ln]
    assert len(lines) == 4
    seen = set()
    for k, line in enumerate(lines):
        assert line.startswith(f"[{algorithm:10s}] step {k:5d} loss=")
        assert np.isfinite(float(line.split("loss=")[1].split()[0]))
        phase = line.split("phase=")[1].split()[0]
        seen.add(phase)
        if phase in ("global", "slowmo"):
            assert "consensus=0.000e+00" in line
        else:
            assert "consensus=0.000e+00" not in line
    want = {"slowmo": {"gossip", "slowmo"},
            "hier_pga": {"gossip", "pod_avg", "global"},
            "gt_pga": {"gossip", "global"},
            "gossip_aga": {"gossip", "global"}}[algorithm]
    assert seen == want
