"""Port parity: the port's copies of the topology and schedule modules
equal the JAX package's (exactly: both are numpy/python arithmetic)."""
import numpy as np
import pytest

from repro.configs.base import DistConfig as JDist
from repro.core import schedule as jsched
from repro.core import topology as jtopo
from repro_torch.configs.base import DistConfig as TDist
from repro_torch.core import schedule as tsched
from repro_torch.core import topology as ttopo

TOPOLOGIES = ("ring", "exp", "one_peer_exp", "full", "disconnected",
              "grid", "directed_ring", "directed_exp")


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("n", (1, 2, 4, 8, 16))
def test_matrices_and_beta_match(topology, n):
    assert ttopo.schedule_period(topology, n) == \
        jtopo.schedule_period(topology, n)
    for step in range(2 * ttopo.schedule_period(topology, n) + 1):
        W = ttopo.mixing_matrix(topology, n, step=step)
        np.testing.assert_array_equal(
            W, jtopo.mixing_matrix(topology, n, step=step))
        assert ttopo.beta(W) == jtopo.beta(W)
        if topology != "grid":
            assert ttopo.shift_weights(topology, n, step) == \
                jtopo.shift_weights(topology, n, step)


@pytest.mark.parametrize("n", (6, 9, 12))
def test_non_power_of_two_grid_and_ring(n):
    assert ttopo.grid_shape(n) == jtopo.grid_shape(n)
    assert ttopo.grid_shift_weights(n) == jtopo.grid_shift_weights(n)
    for topology in ("ring", "grid", "full"):
        np.testing.assert_array_equal(ttopo.mixing_matrix(topology, n),
                                      jtopo.mixing_matrix(topology, n))
    for topology in ("exp", "one_peer_exp"):
        with pytest.raises(ValueError):
            ttopo.shift_weights(topology, n)
    with pytest.raises(ValueError):
        ttopo.schedule_period("typo", n)


@pytest.mark.parametrize("algorithm", ("parallel", "gossip", "local",
                                       "gossip_pga"))
@pytest.mark.parametrize("H", (1, 3, 6))
def test_phase_sequences_match(algorithm, H):
    """50 steps of phases and one-peer shifts, port vs reference."""
    ts = tsched.make_schedule(TDist(algorithm=algorithm, H=H))
    js = jsched.make_schedule(JDist(algorithm=algorithm, H=H))
    period = ttopo.schedule_period("one_peer_exp", 8)
    for k in range(50):
        assert ts.peek_phase(k) == js.peek_phase(k)
        assert ts.advance(k) == js.advance(k)
        assert ts.gossip_shift_step(k, period) == \
            js.gossip_shift_step(k, period)


@pytest.mark.parametrize("algorithm", ("gossip_aga", "slowmo", "hier_pga",
                                       "gt_pga"))
def test_unported_schedules_raise(algorithm):
    """The adaptive, SlowMo, hierarchical and GT-PGA schedules, refused
    until they were ported, now validate and follow the reference's phase
    sequence for the same parameters: 60 steps of phases and one-peer
    shifts, AGA fed one loss sequence and its ``state_dict`` round-tripped
    halfway."""
    kw = dict(algorithm=algorithm, H=6, hier_h_pod=2, n_pods=2,
              aga_h_init=2, aga_warmup=5, aga_h_max=7)
    TDist(**kw).validate()
    ts, js = tsched.make_schedule(TDist(**kw)), \
        jsched.make_schedule(JDist(**kw))
    assert type(ts).__name__ == type(js).__name__
    period = ttopo.schedule_period("one_peer_exp", 8)
    losses = 3.0 / (1.0 + 0.2 * np.arange(60.0))
    for k in range(60):
        if k == 30:
            state = ts.state_dict()
            assert state == js.state_dict()
            ts = tsched.make_schedule(TDist(**kw))
            ts.load_state_dict(state)
        assert ts.peek_phase(k) == js.peek_phase(k)
        assert ts.advance(k) == js.advance(k)
        assert ts.gossip_shift_step(k, period) == \
            js.gossip_shift_step(k, period)
        ts.observe_loss(k, float(losses[k]))
        js.observe_loss(k, float(losses[k]))
    assert ts.state_dict() == js.state_dict()
    if algorithm == "gossip_aga":
        assert ts.history == js.history and len(set(ts.history)) > 1
