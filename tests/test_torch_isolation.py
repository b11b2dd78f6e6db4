"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU
fallback.

Whether a card is present is decided inside each test, never at import
time; without one, the default device must raise.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs import (DistConfig, OptimizerConfig, TrainConfig,
                                 get_model_config)
from repro_torch.kernels import mixing_cuda
from repro_torch.train import Trainer

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_nothing_of_repro(path):
    bad = {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
    assert not bad, f"{path} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.train.trainer, repro_torch.launch.train, "
            "repro_torch.interop, repro_torch.compress.collective, "
            "repro_torch.compress.sparsify, repro_torch.kernels.cuda_build, "
            "repro_torch.launch.serve, repro_torch.serve, "
            "repro_torch.kernels.mlstm_cuda, repro_torch.models.ssm, "
            "repro_torch.configs.xlstm_125m, repro_torch.core.mesh, "
            "repro_torch.kernels, repro_torch.kernels.ops, "
            "repro_torch.kernels.ref, "
            "repro_torch.kernels.flash_attention_cuda, "
            "repro_torch.kernels.rmsnorm_cuda, repro_torch.configs.gemma2_9b; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _tcfg():
    return TrainConfig(model=get_model_config("pga-lm-100m", reduced=True),
                       dist=DistConfig(comm_backend="pallas"),
                       optimizer=OptimizerConfig(name="adamw"),
                       global_batch=8, seq_len=16)


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(_tcfg(), n_nodes=4)
    Trainer(_tcfg(), n_nodes=4, device="cpu")


def test_wrapper_takes_plain_twin_on_cpu_and_counts_no_launch():
    x = torch.randn(4, 1000)
    d, M = (torch.from_numpy(a) for a in
            mixing_cuda.phase_matrices("gossip", "ring", 4))
    before = mixing_cuda.mix_flat.launches
    out = mixing_cuda.mix_flat(x, None, None, d, M, with_g=False,
                               with_residual=False, wire=False)
    plain = mixing_cuda.mix_flat_plain(x, None, None, d, M, with_g=False,
                                       with_residual=False, wire=False)
    assert torch.equal(out, plain)
    assert mixing_cuda.mix_flat.launches == before == 0


def test_wrapper_rejects_other_devices_and_bad_operands():
    d, M = (torch.from_numpy(a) for a in
            mixing_cuda.phase_matrices("global", "ring", 4))
    with pytest.raises(ValueError, match="unsupported device"):
        mixing_cuda.mix_flat(torch.zeros(4, 8, device="meta"), None, None,
                             d.to("meta"), M.to("meta"), with_g=False,
                             with_residual=False, wire=False)
    with pytest.raises(ValueError, match="float32"):
        mixing_cuda.mix_flat(torch.zeros(4, 8, dtype=torch.float64), None,
                             None, d, M, with_g=False, with_residual=False,
                             wire=False)
    with pytest.raises(ValueError, match="bfloat16 only"):
        mixing_cuda.fused_step_mix({"w": torch.zeros(4, 8)}, phase="global",
                                   n_nodes=4, comm_dtype=torch.float16)


@pytest.mark.parametrize("over", [
    dict(comm_compression="int8", push_sum=True),
    dict(push_sum=True),
    dict(push_sum=True, topology="directed_exp", comm_backend="pallas"),
    dict(topology="directed_ring"),
    dict(push_sum=True, algorithm="slowmo"),
    dict(push_sum=True, topology="grid"),
    dict(push_sum=True, comm_global_compression="int8"),
    dict(push_sum=True, comm_overlap=True),
])
def test_push_sum_options_validate_as_the_reference(over):
    """Push-sum (ROADMAP A.4, ported): the port accepts what the
    reference accepts and raises the reference's ``ValueError``, message
    for message, where it refuses."""
    from repro.configs.base import DistConfig as JDist
    try:
        JDist(**over).validate()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            DistConfig(**over).validate()
        assert str(got.value) == str(e)
    else:
        DistConfig(**over).validate()


@pytest.mark.parametrize("over,item", [
    (dict(comm_overlap=True), "A.5"),
    (dict(fsdp=True), "A.10"),
    (dict(algorithm="slowmo", comm_overlap=True), "A.5"),
])
def test_unported_options_raise(over, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        DistConfig(**over).validate()


def test_unported_train_options_raise():
    for over, item in ((dict(microbatches=2), "A.8"),
                       (dict(ckpt_every=5), "A.7")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            Trainer(_tcfg().replace(**over), n_nodes=4, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
        Trainer(_tcfg().replace(optimizer=OptimizerConfig(name="lamb")),
                n_nodes=4, device="cpu").init_state()
