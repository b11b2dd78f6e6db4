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
    with pytest.raises(NotImplementedError, match="ROADMAP A.2"):
        tsched.make_schedule(TDist(algorithm=algorithm))
    with pytest.raises(NotImplementedError, match="ROADMAP A.2"):
        TDist(algorithm=algorithm).validate()
