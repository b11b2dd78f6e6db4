"""Port parity: the Mamba (S6) mixer, JAX vs ``repro_torch`` on the CPU —
the associative scan, ``init_mamba``, ``mamba_forward``, ``mamba_decode``
and ``init_mamba_state``, at the reduced jamba config's widths (d 256,
d_inner 512, N 8, dt_rank 16).

Weights are drawn by the JAX package and carried across with
``repro_torch.interop``; inputs are numpy from a seed.  The port's
activations carry the node axis: each call adds one.

Tolerances:
* the scan (``models.ssm.associative_scan``) is **bitwise** the jitted
  ``jax.lax.associative_scan`` with Mamba's combine, float32 and bfloat16,
  odd and even S, S = 1 included (the same combine order; in float32 the
  fused multiply-add XLA contracts ``b_l·a_r + b_r`` into): h bitwise,
  the running products of a bitwise but where XLA's CPU code flushed a
  denormal product to zero (the port keeps it, or rounds it to bf16's
  smallest normal);
* the scan against the sequential recurrence: 1e-5 (the reference test's);
* ``init_mamba``: the keys, shapes and the leaves that are not drawn
  (``conv_b`` 0, ``dt_bias`` log(expm1(0.01)), ``D`` 1) bitwise;
  ``A_log`` within one float32 ulp (XLA's log is an ulp off at log 7; the
  port rounds float64's);
* ``mamba_forward`` and ``mamba_decode`` (output and state): float32
  compute and scan 2e-5 · max|ref| (``F.softplus`` and ``F.silu`` differ
  from ``jax.nn``'s in the last bit on some inputs; the conv and the C
  contraction sum in another order); bf16 compute or scan 3e-2 · max|ref|
  (bf16 rounds after every product, in differently fused places);
* forward against step-wise decode (the reference test's rule): atol
  2e-4, rtol 2e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro.models import ssm as jssm
from repro_torch import interop
from repro_torch.configs import get_model_config
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import ParamBuilder

torch.set_num_threads(2)

ARCH = "jamba-1.5-large-398b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dtype="float32", scan_dtype="float32"):
    out = []
    for get in (jax_config, get_model_config):
        cfg = dataclasses.replace(get(ARCH, reduced=True), dtype=dtype)
        out.append(dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, scan_dtype=scan_dtype)))
    return out


_WEIGHTS = {}


def _weights():
    if not _WEIGHTS:
        jc, _ = _cfgs()
        _WEIGHTS["w"] = jax.device_get(jax.jit(
            lambda k: jssm.init_mamba(k, jc, jnp.float32)[0])(
                jax.random.PRNGKey(0)))
    return _WEIGHTS["w"]


def _node(tree):
    return {k: v[None] for k, v in tree.items()}


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, rel):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def _jcombine(lhs, rhs):
    al, bl = lhs
    ar, br = rhs
    return al * ar, bl * ar + br


# ---------------------------------------------------------------------------
# The scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("S", (1, 2, 3, 7, 64, 333))
def test_scan_is_bitwise_the_reference(S, dtype):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 48, 8)).astype(np.float32)
    b = rng.standard_normal((2, S, 48, 8)).astype(np.float32)
    jd, td = DTYPES[dtype]
    ja, jb = jax.jit(lambda a, b: jax.lax.associative_scan(
        _jcombine, (a, b), axis=1))(jnp.asarray(a, jd), jnp.asarray(b, jd))
    ta, tb = tssm.associative_scan(
        tssm._mamba_combine, (torch.from_numpy(a).to(td),
                              torch.from_numpy(b).to(td)), dim=1)
    for got, want in ((ta, ja), (tb, jb)):
        assert got.dtype == td and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_f32(tb), _f32(jb))
    # the running products a underflow by S = 333: XLA's CPU code flushes
    # denormal results to zero, the port keeps them
    got, want = _f32(ta), _f32(ja)
    tiny = np.finfo(np.float32).tiny
    flushed = (want == 0.0) & (np.abs(got) <= tiny)
    np.testing.assert_array_equal(np.where(flushed, 0.0, got), want)


def test_scan_matches_sequential():
    """The port of the reference's test: the parallel scan of
    ``h_t = a_t h_{t−1} + b_t`` against the loop, 1e-5."""
    rng = np.random.default_rng(0)
    B, S, D, N = 2, 25, 4, 3
    a = torch.sigmoid(torch.from_numpy(
        rng.standard_normal((B, S, D, N)).astype(np.float32)))
    b = torch.from_numpy(rng.standard_normal((B, S, D, N)).astype(
        np.float32))
    _, h_par = tssm.associative_scan(tssm._mamba_combine, (a, b), dim=1)
    h = torch.zeros((B, D, N))
    hs = []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    np.testing.assert_allclose(h_par.numpy(), torch.stack(hs, 1).numpy(),
                               atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Init and state
# ---------------------------------------------------------------------------
def test_init_mamba_matches_reference():
    jc, tc = _cfgs()
    want = _weights()
    b = ParamBuilder(torch.Generator().manual_seed(0), torch.float32, "cpu")
    tssm.init_mamba(b, tc)
    got = b.params
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name in ("conv_b", "dt_bias", "D"):
            np.testing.assert_array_equal(g, w)
        elif name == "A_log":
            np.testing.assert_array_max_ulp(g, w, maxulp=1)
        else:
            std = float(np.std(w))      # the fan-in rule's scale
            assert abs(float(np.std(g)) / std - 1.0) < 0.1, name
    di, N, R = tssm._mamba_dims(tc)
    assert (di, N, R) == jssm._mamba_dims(jc) == (512, 8, 16)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_init_mamba_state_matches_reference(dtype):
    jc, tc = _cfgs(dtype)
    jd, td = DTYPES[dtype]
    want = jssm.init_mamba_state(jc, 3, jd)
    got = tssm.init_mamba_state(tc, 3, td, "cpu")
    assert sorted(got) == sorted(want) == ["conv", "h"]
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape
        assert got[name].dtype == td and not got[name].any()


def test_port_init_runs_in_the_reference():
    """``interop``'s other direction: the port's ``init_mamba`` as numpy
    gives the reference the port's forward."""
    jc, tc = _cfgs()
    b = ParamBuilder(torch.Generator().manual_seed(4), torch.float32, "cpu")
    tssm.init_mamba(b, tc)
    x = (0.5 * np.random.default_rng(4).standard_normal((2, 9, 256))
         ).astype(np.float32)
    jo, _ = jssm.mamba_forward(interop.to_numpy(b.params), jc,
                               jnp.asarray(x))
    to, _ = tssm.mamba_forward(_node(b.params), tc,
                               torch.from_numpy(x)[None])
    _close(to[0], jo, 2e-5)


# ---------------------------------------------------------------------------
# Forward and decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scan_dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_forward_and_decode_match_reference(dtype, scan_dtype):
    """``mamba_forward`` on 2 × 37 (output, the final conv window and h),
    then two ``mamba_decode`` steps from the reference's state in each
    package (output and the new state, h stored in the compute dtype)."""
    jc, tc = _cfgs(dtype, scan_dtype)
    jd, td = DTYPES[dtype]
    rel = 2e-5 if dtype == scan_dtype == "float32" else 3e-2
    w = _weights()
    tp = _node(interop.from_numpy(w, "cpu"))
    rng = np.random.default_rng(1)
    x = (0.5 * rng.standard_normal((2, 37, 256))).astype(np.float32)
    jo, js = jax.jit(lambda p, x: jssm.mamba_forward(p, jc, x))(
        w, jnp.asarray(x, jd))
    to, ts = tssm.mamba_forward(tp, tc, torch.from_numpy(x).to(td)[None])
    assert to.dtype == td
    _close(to[0], jo, rel)
    assert sorted(ts) == sorted(js)
    for name in js:
        assert ts[name].dtype == td
        _close(ts[name][0], js[name], rel)
    tstate = {k: torch.from_numpy(_f32(v).copy()).to(td)[None]
              for k, v in js.items()}
    jstep = jax.jit(lambda p, x, s: jssm.mamba_decode(p, jc, x, s))
    for t in range(2):
        xt = (0.5 * rng.standard_normal((2, 1, 256))).astype(np.float32)
        jo, js = jstep(w, jnp.asarray(xt, jd), js)
        to, tstate = tssm.mamba_decode(tp, tc,
                                       torch.from_numpy(xt).to(td)[None],
                                       tstate)
        _close(to[0], jo, rel)
        for name in js:
            assert tstate[name].dtype == td
            _close(tstate[name][0], js[name], rel)


def test_forward_equals_stepwise_decode():
    """The port of the reference's test: the full forward against S
    single-token decode steps from the empty state, float32."""
    _, tc = _cfgs()
    tp = _node(interop.from_numpy(_weights(), "cpu"))
    B, S = 2, 10
    x = torch.from_numpy((0.5 * np.random.default_rng(2).standard_normal(
        (B, S, 256))).astype(np.float32))[None]
    out_full, _ = tssm.mamba_forward(tp, tc, x)
    state = {k: v[None] for k, v in tssm.init_mamba_state(
        tc, B, torch.float32, "cpu").items()}
    outs = []
    for t in range(S):
        o, state = tssm.mamba_decode(tp, tc, x[:, :, t:t + 1], state)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, dim=2).numpy(),
                               out_full.numpy(), atol=2e-4, rtol=2e-3)
