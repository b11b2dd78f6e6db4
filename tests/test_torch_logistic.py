"""Port parity: the §5.1 logistic problem, ``repro_torch.data.logistic``
against ``repro.data.logistic`` on the CPU.

* The builders copy the reference's numpy generation draw for draw: ``H``
  and ``y`` are bit for bit the reference's float32 arrays.
* The full gradient and the loss are fp32 einsums over the same inputs,
  summed in another order: rtol 1e-6, atol 1e-7 on the gradient
  (measured: every entry inside that bound; entries near zero carry the
  absolute part) and rtol 1e-6 on the loss (measured 9.4e-8).
* The stochastic gradient draws its indices from a ``torch.Generator``,
  another stream than the reference's ``jax.random`` keys (ROADMAP C.3),
  so it is held to the full-batch formula on the rows it drew.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import logistic as jlog
from repro_torch.data import logistic as tlog

torch.set_num_threads(2)


@pytest.mark.parametrize("iid", (False, True))
@pytest.mark.parametrize("n,M,d,seed", ((4, 64, 6, 0), (8, 300, 10, 3)))
def test_make_logistic_problem_bit_identical(n, M, d, seed, iid):
    jp = jlog.make_logistic_problem(n, M, d, iid=iid, seed=seed)
    tp = tlog.make_logistic_problem(n, M, d, iid=iid, seed=seed,
                                    device="cpu")
    assert (tp.n, tp.M, tp.d) == (jp.n, jp.M, jp.d) == (n, M, d)
    assert tp.H.dtype == tp.y.dtype == torch.float32
    np.testing.assert_array_equal(tp.H.numpy(), np.asarray(jp.H))
    np.testing.assert_array_equal(tp.y.numpy(), np.asarray(jp.y))


@pytest.mark.parametrize("alpha,shift", ((0.3, 2.0), (5.0, 0.0)))
def test_dirichlet_problem_bit_identical(alpha, shift):
    kw = dict(n=6, M=50, d=10, alpha=alpha, feature_shift=shift, seed=1)
    jp = jlog.dirichlet_noniid_problem(**kw)
    tp = tlog.dirichlet_noniid_problem(**kw, device="cpu")
    np.testing.assert_array_equal(tp.H.numpy(), np.asarray(jp.H))
    np.testing.assert_array_equal(tp.y.numpy(), np.asarray(jp.y))


def test_dirichlet_problem_rejects_bad_arguments():
    with pytest.raises(ValueError, match="n must be >= 1"):
        tlog.dirichlet_noniid_problem(0, device="cpu")
    with pytest.raises(ValueError, match="alpha must be > 0"):
        tlog.dirichlet_noniid_problem(4, alpha=0.0, device="cpu")


def test_problem_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        tlog.make_logistic_problem(2, 8, 3)


@pytest.mark.parametrize("iid", (False, True))
def test_full_gradient_and_loss_match(iid):
    jp = jlog.make_logistic_problem(8, 200, 10, iid=iid, seed=2)
    tp = tlog.make_logistic_problem(8, 200, 10, iid=iid, seed=2,
                                    device="cpu")
    x = np.random.default_rng(5).standard_normal((8, 10)).astype(np.float32)
    for k in range(2):
        jg = np.asarray(jp.grad_fn(0)(jnp.asarray(x), None, k))
        tg = tp.grad_fn(0)(torch.from_numpy(x), None, k).numpy()
        np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=1e-7)
        x = x - 0.3 * jg
    xbar = x.mean(0)
    np.testing.assert_allclose(
        float(tp.loss_fn()(torch.from_numpy(xbar))),
        float(jp.loss_fn()(jnp.asarray(xbar))), rtol=1e-6)


def test_stochastic_gradient_is_the_full_formula_on_its_rows():
    """The batch gradient equals the full-batch formula evaluated on the
    rows the generator drew (replayed from an equal seed)."""
    tp = tlog.make_logistic_problem(4, 100, 6, seed=0, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 6)).astype(np.float32))
    g = tp.grad_fn(batch=8)(x, torch.Generator().manual_seed(7), 0)
    idx = tlog.sample_indices(4, 8, 100, torch.Generator().manual_seed(7),
                              "cpu")
    assert idx.shape == (4, 8) and int(idx.min()) >= 0 \
        and int(idx.max()) < 100
    rows = tlog.LogisticProblem(
        torch.stack([tp.H[i, idx[i]] for i in range(4)]),
        torch.stack([tp.y[i, idx[i]] for i in range(4)]), 6, 4, 8)
    torch.testing.assert_close(g, rows.grad_fn(0)(x, None, 0), rtol=0,
                               atol=0)


def test_same_generator_seed_gives_the_same_draws():
    tp = tlog.make_logistic_problem(4, 100, 6, seed=0, device="cpu")
    fn = tp.grad_fn(batch=5)
    x = torch.zeros(4, 6)
    a = [fn(x + k, gen, k) for gen in [torch.Generator().manual_seed(3)]
         for k in range(3)]
    b = [fn(x + k, gen, k) for gen in [torch.Generator().manual_seed(3)]
         for k in range(3)]
    for ga, gb in zip(a, b):
        assert torch.equal(ga, gb)
    c = fn(x, torch.Generator().manual_seed(4), 0)
    assert not torch.equal(a[0], c)
