"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU
fallback.

Whether a card is present is decided inside each test, never at import
time; without one, the default device must raise.
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs import (DistConfig, OptimizerConfig, SSMConfig,
                                 TrainConfig, VisionStubConfig,
                                 get_model_config)
from repro_torch.kernels import mixing_cuda
from repro_torch.train import Trainer

REPO = Path(__file__).resolve().parents[1]
EXAMPLE_FILES = sorted((REPO / "examples").glob("torch_*.py"))
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"] + EXAMPLE_FILES


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
    bad = {"jax", "jaxlib", "ml_dtypes", "repro"} & set(
        _imported_roots(path))
    assert not bad, f"{path} imports {sorted(bad)}"


RANK_TEST_FILES = sorted((REPO / "tests").glob("test_torch_dist_*.py"))


@pytest.mark.parametrize("path", RANK_TEST_FILES, ids=lambda p: p.name)
def test_rank_test_modules_import_no_jax_at_module_top(path):
    """A spawned rank imports its test module to find its worker: the
    module's top level imports nothing of JAX or ``repro`` (the tests
    import it inside their bodies)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not {"jax", "jaxlib", "ml_dtypes", "repro"} & roots, roots


def test_rank_test_modules_load_no_jax_when_imported():
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "import test_torch_dist_mixing, test_torch_dist_train, "
            "test_torch_dist_mixing_2d, test_torch_dist_ckpt; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes', "
            "'repro')))")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_importing_the_examples_loads_no_jax():
    """The port's four examples, imported as modules (their ``main`` not
    run), load nothing of JAX or ``repro``."""
    assert [p.name for p in EXAMPLE_FILES] == [
        "torch_logistic_regression.py", "torch_quickstart.py",
        "torch_serve_requests.py", "torch_train_lm.py"]
    code = ("import sys, importlib; sys.path.insert(0, 'examples'); "
            + "; ".join(f"importlib.import_module({p.stem!r})"
                        for p in EXAMPLE_FILES)
            + "; print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes', "
            "'repro')))")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


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
            "repro_torch.kernels.rmsnorm_cuda, repro_torch.configs.gemma2_9b, "
            "repro_torch.checkpoint, repro_torch.obs, "
            "repro_torch.configs.qwen3_0_6b, repro_torch.configs.qwen2_0_5b, "
            "repro_torch.configs.qwen1_5_32b, repro_torch.models.attention, "
            "repro_torch.models.blocks, repro_torch.models.model, "
            "repro_torch.models.layers, repro_torch.data.synthetic, "
            "repro_torch.configs.jamba_1_5_large, "
            "repro_torch.configs.llava_next_mistral_7b, "
            "repro_torch.models.sharding, repro_torch.launch.mesh, "
            "repro_torch.roofline, repro_torch.roofline.analysis, "
            "repro_torch.launch.specs, repro_torch.launch.dryrun, "
            "repro_torch.launch.hillclimb, repro_torch.launch.hillclimb_exp3, "
            "repro_torch.launch.hillclimb_finish; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes', "
            "'repro')))")
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
    (dict(fsdp=True), "A.10"),
])
def test_unported_options_raise(over, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        DistConfig(**over).validate()


@pytest.mark.parametrize("over", [
    dict(comm_overlap=True),
    dict(algorithm="slowmo", comm_overlap=True),
    dict(comm_overlap=True, comm_compression="int8",
         comm_error_feedback=True, comm_global_compression="int8"),
    dict(comm_overlap=True, push_sum=True, topology="directed_ring"),
])
def test_overlap_options_validate_as_the_reference(over):
    """Overlapped gossip (ROADMAP A.5, ported): the port accepts what the
    reference accepts and raises the reference's ``ValueError`` (push-sum
    with overlap), message for message."""
    from repro.configs.base import DistConfig as JDist
    try:
        JDist(**over).validate()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            DistConfig(**over).validate()
        assert str(got.value) == str(e)
    else:
        assert DistConfig(**over).validate().comm_overlap


def test_unported_train_options_raise():
    """Gradient accumulation and LAMB (A.8) and checkpoints (A.7) are
    ported: the Trainer accepts them, checkpoints with the reference's
    default directory, a per-node batch the microbatches do not divide
    raises ``ValueError``; FSDP (A.10) still raises; since MoE (A.8) the
    moe family builds, and since slice 14 Mamba and the VLM stub build
    and take a finite step (the VLM's batch with its patches)."""
    from repro.configs.base import TrainConfig as JTrain
    tr = Trainer(_tcfg().replace(microbatches=2), n_nodes=4, device="cpu")
    assert tr.tcfg.microbatches == 2
    with pytest.raises(ValueError, match="microbatches=3"):
        Trainer(_tcfg().replace(microbatches=3), n_nodes=4, device="cpu")
    tr = Trainer(_tcfg().replace(ckpt_every=5), n_nodes=4, device="cpu")
    assert tr.tcfg.ckpt_every == 5
    assert tr.tcfg.ckpt_dir == JTrain(model=None).ckpt_dir
    state = Trainer(_tcfg().replace(optimizer=OptimizerConfig(name="lamb")),
                    n_nodes=4, device="cpu").init_state()
    assert sorted(state.opt_state) == ["count", "m", "v"]
    with pytest.raises(NotImplementedError, match="ROADMAP A.10"):
        Trainer(_tcfg().replace(dist=DistConfig(fsdp=True)), n_nodes=4,
                device="cpu")
    cfg = _tcfg()
    for over in (dict(family="vlm", vision=VisionStubConfig(
                     n_tiles=1, patches_per_tile=4)),
                 dict(pattern=(("mamba", "none"),), ssm=SSMConfig())):
        tr = Trainer(cfg.replace(model=dataclasses.replace(cfg.model,
                                                           **over)),
                     n_nodes=4, device="cpu")
        assert ("patches" in tr.device_batch(0)) == ("vision" in over)
        tr.run(tr.init_state(), steps=1)
        assert torch.isfinite(torch.tensor(tr.history[-1]["loss"]))
    Trainer(cfg.replace(model=dataclasses.replace(cfg.model, family="moe")),
            n_nodes=4, device="cpu")
