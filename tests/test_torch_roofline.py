"""Port parity: the H100 roofline (``repro_torch.roofline``) against the
live JAX package's arithmetic on the CPU, and its counterparts of the
XLA readers on ``meta`` tensors.

Exactly equal: ``count_params`` (``active_only`` both ways) and
``model_flops_for`` for the twelve configs × four input shapes ×
``n_chips`` ∈ {1, 256, 512}; ``scan_corrected_costs``, ``from_costs``
and ``Roofline.to_dict`` on the same inputs, the reference's peaks set
to the port's for the comparison (the arithmetic is the reference's; the
peaks are the H100's).  ``run_costs`` counts ``2·M·K·N`` per product on
meta tensors, the bytes of every op's operands and the peak of the live
bytes, which equals the CPU allocator's peak over the same train step;
``collective_bytes`` is the round meter's figure under the reference's
type names.
"""
import numpy as np
import pytest
import torch

from repro_torch import roofline
from repro_torch.configs import INPUT_SHAPES, get_model_config, list_archs
from repro_torch.roofline import analysis as ra

torch.set_num_threads(2)

ARCHS = sorted(list_archs())


def test_constants_are_the_h100s():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.ICI_BW) == (
        989.4e12, 3.35e12, 450e9)
    assert "H100" in ra.__doc__ and "NVLink" in ra.__doc__


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_model_flop_counts_equal_the_references(arch):
    from repro.configs import INPUT_SHAPES as JS
    from repro.configs import get_model_config as jget
    from repro.roofline import analysis as ja
    for long_context in (False, True):
        t = get_model_config(arch, long_context=long_context)
        j = jget(arch, long_context=long_context)
        for active in (False, True):
            assert ra.count_params(t, active_only=active) == \
                ja.count_params(j, active_only=active)
        for name in INPUT_SHAPES:
            for n_chips in (1, 256, 512):
                assert ra.model_flops_for(t, INPUT_SHAPES[name], n_chips) \
                    == ja.model_flops_for(j, JS[name], n_chips)


def _costs(rng, n_types=5, zero=False):
    names = ra._COLLECTIVES[:n_types]
    per = {k: 0 if zero else int(rng.integers(0, 1 << 40)) for k in names}
    return {"flops": float(rng.uniform(0, 1e18)),
            "bytes": float(rng.uniform(0, 1e15)),
            "coll": float(sum(per.values())),
            "coll_detail": {"total_bytes": sum(per.values()),
                            "per_type_bytes": per,
                            "counts": {k: int(rng.integers(0, 9))
                                       for k in names}}}


@pytest.mark.parametrize("seed", range(6))
def test_cost_arithmetic_equals_the_references(seed, monkeypatch):
    from repro.roofline import analysis as ja
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(ja, name, getattr(ra, name))
    rng = np.random.default_rng(seed)
    c1, c2 = _costs(rng), _costs(rng)
    if seed == 0:
        c2 = dict(c1)          # a variant no deeper: per-rep cost 0
    for reps in (1, 2, 7, 94):
        assert ra.scan_corrected_costs(c1, c2, reps) == \
            ja.scan_corrected_costs(c1, c2, reps)
    for costs in (c1, c2, ra.scan_corrected_costs(c1, c2, 12),
                  _costs(rng, zero=True) | {"flops": 0.0}):
        for mf in (None, float(rng.uniform(1, 1e17))):
            got = ra.from_costs(costs, model_flops=mf)
            want = ja.from_costs(costs, model_flops=mf)
            assert got.to_dict() == want.to_dict()
            assert (got.dominant, got.bound_time_s, got.useful_flops_ratio
                    ) == (want.dominant, want.bound_time_s,
                          want.useful_flops_ratio)


def test_run_costs_counts_a_matmul_on_meta():
    x = torch.empty(8, 512, 256, device="meta", requires_grad=True)
    w = torch.empty(256, 1024, device="meta", requires_grad=True)

    def step(x, w):
        y = torch.matmul(x, w).relu()
        y.sum().backward()
        return y.detach()

    out, costs = ra.run_costs(step, x, w)
    mkn = 8 * 512 * 256 * 1024
    assert costs["flops"] == 2 * mkn * 3          # forward + 2 backward
    assert out.device.type == "meta"
    # y (8 MiB fp32) and the grads are live at the end; the peak holds
    # at least y, relu's output and both grads
    y_bytes = 8 * 512 * 1024 * 4
    assert costs["peak_bytes"] >= 2 * y_bytes + x.nbytes + w.nbytes
    assert costs["bytes"] >= 2 * y_bytes + x.nbytes + w.nbytes
    rl = ra.from_run(step, x, w, model_flops=2.0 * mkn)
    assert rl.flops == 6 * mkn and rl.useful_flops_ratio == 1 / 3
    assert rl.collective_s == 0 and rl.dominant in ("compute", "memory")


def test_run_costs_tracks_frees_and_in_place_writes():
    a = torch.empty(1000, device="meta")

    def fn(a):
        b = a * 2          # 4,000 bytes
        c = b + 1          # 4,000 more: peak 8,000
        del b
        a.add_(1)          # into the argument: no new bytes
        return c

    _, costs = ra.run_costs(fn, a)
    assert costs["peak_bytes"] == 8000


def test_collective_bytes_are_the_round_meters():
    from repro_torch.obs.meters import measured_round_bytes
    params = {"w": torch.empty(8, 3, 5, device="meta"),
              "b": torch.empty(8, 7, device="meta")}
    for phase, topology, kind in (("gossip", "ring", "collective-permute"),
                                  ("gossip", "one_peer_exp",
                                   "collective-permute"),
                                  ("global", "ring", "all-reduce")):
        rec = ra.collective_bytes(params, phase=phase, topology=topology,
                                  n_nodes=8)
        want = measured_round_bytes(params, phase=phase, topology=topology,
                                    n_nodes=8)
        assert rec["total_bytes"] == rec["per_type_bytes"][kind] == want > 0
        assert sorted(rec["per_type_bytes"]) == sorted(ra._COLLECTIVES)
        assert rec["counts"][kind] == (2 if topology == "ring"
                                       and phase == "gossip" else 1)
    none = ra.collective_bytes(params, phase="none", topology="ring",
                               n_nodes=8)
    assert none["total_bytes"] == 0 and not any(none["counts"].values())


def test_meta_peak_equals_the_cpu_allocators_peak():
    """The tally's peak of a train step on meta tensors (the dry-run's
    ``temp_size_in_bytes``) equals the peak of the bytes the CPU
    allocator holds above the arguments while the same step runs on CPU
    tensors, read from the profiler's memory events: the tally follows
    the storages the step really allocates and frees (the arguments held
    inside ``TrainState`` included)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import DistConfig, InputShape, OptimizerConfig
    from repro_torch.core import algo
    from repro_torch.core.mesh import make_mesh
    from repro_torch.launch import dryrun
    from repro_torch.models.model import make_model
    from repro_torch.optim import make_optimizer
    from repro_torch.train.state import TrainState, stack_for_nodes
    from repro_torch.train.step import build_train_step
    cfg = get_model_config("pga-lm-100m", reduced=True)
    n, dist = 4, DistConfig(H=2)
    costs, _, specs, tcfg = dryrun._run_train(
        cfg, InputShape("t", 16, 8, "train"),
        make_mesh((n, 1), ("data", "model"), device="meta"), dist=dist,
        phase="gossip")
    model = make_model(cfg)
    step = build_train_step(model, tcfg, n, phase="gossip")
    params = stack_for_nodes(model.init(torch.Generator().manual_seed(0),
                                        "cpu"), n)
    opt = make_optimizer(OptimizerConfig(), per_node=True)
    state = TrainState(params=params, opt_state=opt.init(params), step=0,
                       extras=algo.init_extras(dist, params, n))
    batch = {k: torch.zeros(t.shape, dtype=t.dtype)
             for k, t in specs.batch_sds.items()}
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        out = step(state, batch, tcfg.optimizer.lr)
        del out
    events = sorted((e.start_ns(), e.nbytes())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "[memory]"
                    and e.device_type() == torch.autograd.DeviceType.CPU)
    live = peak = 0
    for _, nbytes in events:
        live += nbytes
        peak = max(peak, live)
    assert costs["peak_bytes"] == peak > 0
