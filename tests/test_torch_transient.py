"""Port parity: the paper's transient-stage quantities
(``repro_torch.core.topology``: ``c_beta``, ``d_beta``, ``transient_stage``,
``effective_beta``) against ``repro.core.topology``.

``c_beta``, ``d_beta`` and ``transient_stage`` are the same float
expressions in both packages: equal exactly on a grid of every
registered algorithm (the ones without a model raise ``ValueError`` in
both; gossip at β = 1 divides by zero in both), n ∈ {4, 16, 256}, β ∈
{0, 0.5, 0.9, 0.999, 1}, H ∈ {1, 6, 16}, IID and not.  ``effective_beta``
takes an SVD (and an eigendecomposition for the directed topologies):
within 1e-12 over every topology and n ∈ {1, 2, 8, 16}, a topology the
reference refuses refused alike, and exactly 0.0 for one_peer_exp at a
power of two.  The orderings of ``tests/test_topology.py`` (Tables 2
and 3: Gossip-PGA's transient stage the shortest) hold in the port.
"""
import numpy as np
import pytest

from repro.core import topology as jtopo
from repro_torch.core import topology as ttopo
from repro_torch.core.algo import algorithm_names

NS = (4, 16, 256)
BETAS = (0.0, 0.5, 0.9, 0.999, 1.0)
HS = (1, 6, 16)


def _outcome(fn, *args, **kw):
    """``fn``'s value, or the type of what it raised."""
    try:
        return fn(*args, **kw)
    except Exception as e:          # noqa: BLE001 - compared by type
        return type(e)


@pytest.mark.parametrize("name", ["c_beta", "d_beta"])
def test_c_beta_and_d_beta_equal_the_reference(name):
    for b in BETAS + (0.3, 0.99):
        for H in HS + (2, 64):
            want = getattr(jtopo, name)(b, H)
            got = getattr(ttopo, name)(b, H)
            assert type(got) is type(want) and got == want, (b, H)


@pytest.mark.parametrize("algorithm", algorithm_names())
def test_transient_stage_equals_the_reference(algorithm):
    modelled = algorithm in ("parallel", "gossip", "local", "gossip_pga",
                             "gossip_aga")
    for n in NS:
        for b in BETAS:
            for H in HS:
                for iid in (False, True):
                    want = _outcome(jtopo.transient_stage, algorithm, n, b,
                                    H, iid=iid)
                    got = _outcome(ttopo.transient_stage, algorithm, n, b,
                                   H, iid=iid)
                    assert got == want, (algorithm, n, b, H, iid)
                    if not modelled:
                        assert got is ValueError
    if not modelled:
        with pytest.raises(ValueError, match="no transient model for"):
            ttopo.transient_stage(algorithm, 4, 0.5, 2)


@pytest.mark.parametrize("topology", jtopo.KNOWN_TOPOLOGIES)
def test_effective_beta_matches_the_reference(topology):
    for n in (1, 2, 8, 16):
        want = _outcome(jtopo.effective_beta, topology, n)
        got = _outcome(ttopo.effective_beta, topology, n)
        if isinstance(want, type):
            assert got is want, (topology, n)
            continue
        assert isinstance(got, float)
        assert abs(got - want) <= 1e-12, (topology, n, got, want)
        if topology == "one_peer_exp" or n == 1:
            assert got == 0.0


def test_effective_beta_refuses_what_the_reference_refuses():
    for topology, n in (("one_peer_exp", 6), ("exp", 12), ("nope", 4)):
        want = _outcome(jtopo.effective_beta, topology, n)
        assert isinstance(want, type)
        assert _outcome(ttopo.effective_beta, topology, n) is want


@pytest.mark.parametrize("iid", [True, False])
@pytest.mark.parametrize("H", [4, 16, 64])
@pytest.mark.parametrize("beta", [0.3, 0.9, 0.999])
def test_transient_stage_orderings(iid, H, beta):
    """Gossip-PGA's transient stage is at most Gossip's and Local SGD's."""
    n = 64
    t_pga = ttopo.transient_stage("gossip_pga", n, beta, H, iid=iid)
    assert t_pga <= ttopo.transient_stage("gossip", n, beta, H,
                                          iid=iid) + 1e-9
    assert t_pga <= ttopo.transient_stage("local", n, beta, H,
                                          iid=iid) + 1e-9


def test_transient_gossip_blows_up_as_beta_to_one():
    """Gossip grows as (1 − β)^-4; Gossip-PGA is capped by H."""
    n = 64
    t = [ttopo.transient_stage("gossip", n, b, 16) for b in (0.9, 0.999)]
    p = [ttopo.transient_stage("gossip_pga", n, b, 16) for b in (0.9, 0.999)]
    assert t[1] / t[0] > 1e3
    assert p[1] / p[0] < 1e2


@pytest.mark.parametrize("beta", [0.1, 0.5, 0.9, 0.99])
def test_c_beta_is_the_geometric_sum_below_d_beta(beta):
    for H in (2, 6, 16, 64):
        cb = ttopo.c_beta(beta, H)
        assert cb < ttopo.d_beta(beta, H) + 1e-12
        np.testing.assert_allclose(cb, sum(beta ** k for k in range(H)))
