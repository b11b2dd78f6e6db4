"""Port parity for the call shapes of ROADMAP C.6: the reference's public
names and keywords in files both packages have, held against the live JAX
output on the same inputs.

``TrainState``'s legacy keywords, ``slow_params``/``slow_u`` and
``with_extras``; ``CommSchedule.phase``; ``ParamBuilder.sub``;
``init_rms_norm(zeros=)`` and ``make_rope(dtype=)``.  And ROADMAP C.7: the
eleven model inits in the reference's form, ``(key, ..., param_dtype) ->
(params, axes)``, a CPU ``torch.Generator`` for the key: their trees'
keys, shapes and dtypes and their axes trees equal the reference's at
reduced configs (values are not compared: the two packages draw other
numbers), the public form is bitwise the builder form ``Model`` calls,
and ``device="meta"`` builds shapes without a seed.  Exact wherever both
sides are exact by construction (slot bookkeeping, schedules, ones and
zeros inits); ``make_rope``'s tables within 2e-6 at float32 (the two
packages raise theta to the exponents through different pow routines) and
within one bf16 ulp of values in [-1, 1] (2^-8) at bfloat16, where a
last-bit difference of the fp32 table may round the other way.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs.base import DistConfig as TDist
from repro_torch.core import schedule as tsched
from repro_torch.models import layers as tlayers
from repro_torch.train.state import TrainState as TState
from repro_torch.tree import tree_flatten, tree_unflatten

torch.set_num_threads(2)

RNG = np.random.default_rng(0)
SLOTS = {name: RNG.standard_normal((4, 3)).astype(np.float32)
         for name in ("slow_params", "slow_u", "ef_state")}
SLOTS["push_weight"] = np.ones((4, 1), np.float32)


def _states(extras=None, **slots):
    """The same state in both packages, from the numpy inputs above."""
    import jax.numpy as jnp

    from repro.train.state import TrainState as JState
    params = {"w": RNG.standard_normal((4, 3)).astype(np.float32)}
    j = JState(params={k: jnp.asarray(v) for k, v in params.items()},
               opt_state={}, step=jnp.asarray(0),
               extras={k: jnp.asarray(v) for k, v in (extras or {}).items()},
               **{k: jnp.asarray(v) for k, v in slots.items()})
    t = TState(params=interop.from_numpy(params, "cpu"), opt_state={},
               step=0, extras=interop.from_numpy(extras or {}, "cpu"),
               **interop.from_numpy(slots, "cpu"))
    return j, t


def _same_extras(j, t):
    assert sorted(j.extras) == sorted(t.extras)
    for k in j.extras:
        np.testing.assert_array_equal(np.asarray(j.extras[k]),
                                      interop.to_numpy(t.extras[k]))


@pytest.mark.parametrize("slots", [
    (), ("slow_params", "slow_u"), ("ef_state",), ("push_weight",),
    ("slow_params", "slow_u", "ef_state", "push_weight")])
def test_train_state_legacy_keywords_merge_into_extras(slots):
    other = {"gt_tracker": RNG.standard_normal((4, 3)).astype(np.float32)}
    j, t = _states(extras=other, **{s: SLOTS[s] for s in slots})
    _same_extras(j, t)
    for name in ("slow_params", "slow_u", "ef_state", "push_weight"):
        jv, tv = getattr(j, name), getattr(t, name)
        assert (jv is None) == (tv is None), name
        if jv is not None:
            np.testing.assert_array_equal(np.asarray(jv),
                                          interop.to_numpy(tv))


def test_train_state_keyword_overrides_the_extras_entry():
    """A legacy keyword wins over the same key in ``extras``, as in the
    reference (the keyword is merged last)."""
    j, t = _states(extras={"ef_state": np.zeros((4, 3), np.float32)},
                   ef_state=SLOTS["ef_state"])
    _same_extras(j, t)
    np.testing.assert_array_equal(interop.to_numpy(t.ef_state),
                                  SLOTS["ef_state"])


@pytest.mark.parametrize("updates", [
    {"slow_u": None},                              # delete
    {"ef_state": np.zeros((4, 3), np.float32)},    # replace
    {"gt_tracker": np.full((4, 3), 2.0, np.float32), "slow_params": None},
    {"absent": None},                              # deleting nothing
])
def test_with_extras_matches_reference_and_copies(updates):
    import jax.numpy as jnp
    j, t = _states(**SLOTS)
    before = dict(t.extras)
    j2 = j.with_extras(**{k: None if v is None else jnp.asarray(v)
                          for k, v in updates.items()})
    t2 = t.with_extras(**{k: None if v is None else torch.from_numpy(v)
                          for k, v in updates.items()})
    _same_extras(j2, t2)
    assert t2 is not t and t2.params is t.params and t2.step == t.step
    assert t.extras == before      # the original is untouched


def test_train_state_stays_a_tree_node():
    """The custom ``__init__`` keeps the registered dataclass working:
    flatten/unflatten, ``dataclasses.replace`` and ``fields``."""
    _, t = _states(**SLOTS)
    leaves, treedef = tree_flatten(t)
    assert len(leaves) == 2 + len(SLOTS)      # params' w, the step
    back = tree_unflatten(treedef, leaves)
    assert isinstance(back, TState) and sorted(back.extras) == sorted(SLOTS)
    assert [f.name for f in dataclasses.fields(TState)] == [
        "params", "opt_state", "step", "extras"]
    moved = dataclasses.replace(t, step=3)
    assert moved.step == 3 and moved.extras.keys() == t.extras.keys()


@pytest.mark.parametrize("kw", [
    dict(algorithm="gossip_pga", H=3), dict(algorithm="local", H=4),
    dict(algorithm="slowmo", H=3),
    dict(algorithm="hier_pga", H=6, hier_h_pod=2),
    dict(algorithm="gossip_aga", aga_h_init=2, aga_warmup=2)])
def test_schedule_phase_is_the_pure_peek(kw):
    from repro.configs.base import DistConfig as JDist
    from repro.core import schedule as jsched
    ts = tsched.make_schedule(TDist(**kw))
    js = jsched.make_schedule(JDist(**kw))
    before = ts.state_dict()
    assert [ts.phase(k) for k in range(12)] == \
        [js.phase(k) for k in range(12)] == \
        [ts.peek_phase(k) for k in range(12)]
    assert ts.state_dict() == before     # no side effects


def _build_port(use_sub: bool):
    b = tlayers.ParamBuilder(torch.Generator().manual_seed(7), torch.float32,
                             "cpu")
    b.add("embed", (6, 4), ("vocab", "embed"))
    if use_sub:
        c = b.sub("block")
    else:
        c = b.child()
    c.add("w", (4, 8), ("embed", "ffn"))
    c.add("scale", (8,), (None,), init="constant", scale=0.5)
    tlayers.init_rms_norm(c, "norm", 4, zeros=True)
    if not use_sub:
        b.attach("block", c.params, c.axes)
    b.add("head", (4, 6), ("embed", "vocab"), init="normal")
    return b


def test_sub_equals_child_and_attach():
    """``sub`` gives the same leaves (bitwise: the per-leaf seeds follow
    creation order on the shared generator) and axes as ``child()`` +
    ``attach()``, and what the child adds after ``sub`` lands in the
    parent's trees."""
    a, b = _build_port(True), _build_port(False)
    la, ta = tree_flatten(a.params)
    lb, tb = tree_flatten(b.params)
    assert ta == tb and a.axes == b.axes
    for x, y in zip(la, lb):
        assert torch.equal(x, y)
    assert sorted(a.params["block"]) == ["norm", "scale", "w"]


def test_sub_tree_and_axes_match_reference():
    """The reference's ``sub`` builds the same nesting, axes, shapes and
    dtypes; its deterministic leaves (constant, zeros) are equal."""
    import jax

    from repro.models import layers as jlayers
    jb = jlayers.ParamBuilder(jax.random.PRNGKey(0), np.float32)
    jb.add("embed", (6, 4), ("vocab", "embed"))
    jc = jb.sub("block")
    jc.add("w", (4, 8), ("embed", "ffn"))
    jc.add("scale", (8,), (None,), init="constant", scale=0.5)
    jlayers.init_rms_norm(jc, "norm", 4, zeros=True)
    jb.add("head", (4, 6), ("embed", "vocab"), init="normal")
    tb = _build_port(True)
    assert jb.axes == tb.axes
    jleaves = jax.tree.leaves(jb.params)
    tleaves, _ = tree_flatten(tb.params)
    assert [(tuple(x.shape), str(x.dtype)) for x in jleaves] == \
        [(tuple(x.shape), str(x.dtype).split(".")[1]) for x in tleaves]
    for name in ("scale", "norm"):
        np.testing.assert_array_equal(
            np.asarray(jb.params["block"][name]),
            interop.to_numpy(tb.params["block"][name]))


@pytest.mark.parametrize("zeros", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_rms_norm_zeros_matches_reference(zeros, dtype):
    import jax
    import jax.numpy as jnp

    from repro.models import layers as jlayers
    jb = jlayers.ParamBuilder(jax.random.PRNGKey(0), getattr(jnp, dtype))
    jlayers.init_rms_norm(jb, "ln", 16, zeros=zeros)
    tb = tlayers.ParamBuilder(torch.Generator().manual_seed(0),
                              getattr(torch, dtype), "cpu")
    tlayers.init_rms_norm(tb, "ln", 16, zeros=zeros)
    assert jb.axes == tb.axes
    assert str(tb.params["ln"].dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(
        np.asarray(jb.params["ln"], np.float32),
        interop.to_numpy(tb.params["ln"]))


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-6),
                                        ("bfloat16", 2.0 ** -8)])
def test_make_rope_dtype_matches_reference(dtype, atol):
    import jax.numpy as jnp

    from repro.models import layers as jlayers
    pos = np.arange(48, dtype=np.int32).reshape(2, 24)
    jc, js = jlayers.make_rope(jnp.asarray(pos), 16, 10000.0,
                               dtype=getattr(jnp, dtype))
    tc, ts = tlayers.make_rope(torch.from_numpy(pos), 16, 10000.0,
                               dtype=getattr(torch, dtype))
    for j, t in ((jc, tc), (js, ts)):
        assert t.dtype == getattr(torch, dtype) and t.shape == (2, 24, 8)
        np.testing.assert_allclose(interop.to_numpy(t),
                                   np.asarray(j, np.float32), rtol=0,
                                   atol=atol)
    # the default stays the fp32 tables
    assert tlayers.make_rope(torch.from_numpy(pos), 16, 1e4)[0].dtype == \
        torch.float32


# ---------------------------------------------------------------------------
# ROADMAP C.7: the model inits' call shape
# ---------------------------------------------------------------------------
def _cfgs(arch):
    from repro.configs import get_model_config as jax_config
    from repro_torch.configs import get_model_config
    return jax_config(arch, reduced=True), get_model_config(arch,
                                                           reduced=True)


def _call(module, fn, arch, args):
    """``fn`` of ``module`` in both packages: ``(jax_call, port_call)``,
    taking the key (the generator and ``device``): the reduced config of
    ``arch`` (if any) after the key, then ``args(side)``, the
    reference's remaining arguments in its order (``param_dtype``
    included)."""
    import importlib
    jm = importlib.import_module(f"repro.models.{module}")
    tm = importlib.import_module(f"repro_torch.models.{module}")
    jc, tc = _cfgs(arch) if arch else (None, None)

    def jcall(key):
        """Shapes only: ``jax.eval_shape`` traces the init without
        compiling a draw; the axes tree comes out of the trace."""
        import jax
        box = {}

        def init(k):
            params, box["axes"] = getattr(jm, fn)(
                k, *((jc,) if arch else ()), *args("jax"))
            return params
        return jax.eval_shape(init, key), box["axes"]

    def tcall(gen, device="cpu"):
        return getattr(tm, fn)(gen, *((tc,) if arch else ()),
                               *args("torch"), device=device)
    return jcall, tcall


def _dtype(dt, side):
    import jax.numpy as jnp
    return getattr(jnp if side == "jax" else torch, dt)


def _mlp(dt, side):
    return (256, 512, _dtype(dt, side))


def _emb(tie):
    return lambda dt, side: (512, 256, _dtype(dt, side), tie)


def _cfg_only(dt, side):
    return (_dtype(dt, side),)


def _block(kind):
    return lambda dt, side: (kind, _dtype(dt, side))


INIT_CASES = {
    "init_mlp": ("layers", "init_mlp", None, _mlp),
    "init_embedding tie": ("layers", "init_embedding", None, _emb(True)),
    "init_embedding untied": ("layers", "init_embedding", None,
                              _emb(False)),
    "init_attention pga-lm": ("attention", "init_attention", "pga-lm-100m",
                              _cfg_only),
    "init_attention gemma2": ("attention", "init_attention", "gemma2-9b",
                              _cfg_only),
    "init_attention qwen2 bias": ("attention", "init_attention",
                                  "qwen2-0.5b", _cfg_only),
    "init_attention qwen3 qk-norm": ("attention", "init_attention",
                                     "qwen3-0.6b", _cfg_only),
    "init_attention deepseek mla": ("attention", "init_attention",
                                    "deepseek-v2-lite-16b", _cfg_only),
    "init_moe deepseek": ("moe", "init_moe", "deepseek-v2-lite-16b",
                          _cfg_only),
    "init_mamba jamba": ("ssm", "init_mamba", "jamba-1.5-large-398b",
                         _cfg_only),
    "init_mlstm xlstm": ("ssm", "init_mlstm", "xlstm-125m", _cfg_only),
    "init_slstm xlstm": ("ssm", "init_slstm", "xlstm-125m", _cfg_only),
    "init_block pga-lm": ("blocks", "init_block", "pga-lm-100m",
                          _block(("attn", "dense"))),
    "init_block gemma2 sw post-norms": ("blocks", "init_block", "gemma2-9b",
                                        _block(("attn_sw", "dense"))),
    "init_block deepseek mla moe": ("blocks", "init_block",
                                    "deepseek-v2-lite-16b",
                                    _block(("attn", "moe"))),
    "init_block jamba mamba moe": ("blocks", "init_block",
                                   "jamba-1.5-large-398b",
                                   _block(("mamba", "moe"))),
    "init_block xlstm slstm": ("blocks", "init_block", "xlstm-125m",
                               _block(("slstm", "none"))),
    "init_block bert": ("blocks", "init_block", "bert-large",
                        _block(("attn", "dense"))),
    "init_stack pga-lm": ("blocks", "init_stack", "pga-lm-100m", _cfg_only),
    "init_stack gemma2": ("blocks", "init_stack", "gemma2-9b", _cfg_only),
    "init_stack qwen3": ("blocks", "init_stack", "qwen3-0.6b", _cfg_only),
    "init_stack deepseek": ("blocks", "init_stack", "deepseek-v2-lite-16b",
                            _cfg_only),
    "init_stack xlstm": ("blocks", "init_stack", "xlstm-125m", _cfg_only),
    "init_stack bert": ("blocks", "init_stack", "bert-large", _cfg_only),
}


def _flat(tree, leaf=lambda x: not isinstance(x, dict), path=()):
    """``{path: leaf}`` of a nested dict (tuples are leaves: axes)."""
    if leaf(tree):
        return {path: tree}
    out = {}
    for k in tree:
        out.update(_flat(tree[k], leaf, path + (k,)))
    return out


def _same_tree(jtree, ttree):
    """Keys, shapes and dtypes of the params; the axes trees equal."""
    (jp, ja), (tp, ta) = jtree, ttree
    jl, tl = _flat(jp), _flat(tp)
    assert sorted(jl) == sorted(tl)
    for k in jl:
        assert tuple(jl[k].shape) == tuple(tl[k].shape), k
        assert str(jl[k].dtype) == str(tl[k].dtype).split(".")[1], k
    ja = {k: tuple(v) for k, v in _flat(ja).items()}
    ta = {k: tuple(v) for k, v in _flat(ta).items()}
    assert ja == ta


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(INIT_CASES))
def test_model_inits_match_the_reference_call_shape(case, dtype):
    """C.7: each init takes (generator, the reference's arguments,
    param_dtype) and returns (params, axes) with the reference's keys,
    shapes, dtypes and axes."""
    import jax

    module, fn, arch, args = INIT_CASES[case]
    jcall, tcall = _call(module, fn, arch, lambda side: args(dtype, side))
    want = jcall(jax.random.PRNGKey(0))
    got = tcall(torch.Generator().manual_seed(0))
    _same_tree(want, got)


def _stack_inits_pair(n):
    """``stack_inits`` of ``init_mlp`` at n blocks, in both packages."""
    import jax
    import jax.numpy as jnp

    from repro.models import layers as jlayers
    box = {}

    def init(key):
        params, box["axes"] = jlayers.stack_inits(
            lambda k: jlayers.init_mlp(k, 32, 64, jnp.float32), key, n)
        return params
    want = jax.eval_shape(init, jax.random.PRNGKey(0)), box["axes"]
    got = tlayers.stack_inits(
        lambda g: tlayers.init_mlp(g, 32, 64, torch.float32, device="cpu"),
        torch.Generator().manual_seed(0), n, device="cpu")
    return want, got


def test_stack_inits_matches_the_reference_call_shape():
    """``stack_inits(init_fn, generator, n)`` at n = 3: init_fn(generator)
    -> (params, axes) called per block, the leaves stacked on a leading
    axis, every axes tuple prefixed with "layers", each block its own
    draw."""
    want, got = _stack_inits_pair(3)
    _same_tree(want, got)
    assert got[1]["w_up"] == ("layers", "embed", "ffn")
    w = got[0]["w_gate"]
    assert w.shape == (3, 32, 64)
    assert not torch.equal(w[0], w[1]) and not torch.equal(w[1], w[2])
    # the blocks are the generator's next three draws, in order
    gen = torch.Generator().manual_seed(0)
    blocks = [tlayers.init_mlp(gen, 32, 64, torch.float32, device="cpu")[0]
              for _ in range(3)]
    for i, blk in enumerate(blocks):
        for k in blk:
            assert torch.equal(got[0][k][i], blk[k])


def _builder_form(module, fn, gen, arch, args):
    """The private builder form behind public ``fn`` (the reference's
    arguments less ``param_dtype``, which the builder carries), on
    ``gen`` at float32."""
    import importlib
    tm = importlib.import_module(f"repro_torch.models.{module}")
    b = tlayers.ParamBuilder(gen, torch.float32, "cpu")
    rest = tuple(a for a in args("float32", "torch")
                 if not isinstance(a, torch.dtype))
    getattr(tm, f"_{fn}_into")(b, *((_cfgs(arch)[1],) if arch else ()),
                               *rest)
    return b.params, b.axes


@pytest.mark.parametrize("case", sorted(INIT_CASES))
def test_public_init_is_bitwise_the_builder_form(case):
    """The public form on a generator seeded s draws what the builder form
    (``Model``'s) draws on the same seed: every leaf bitwise, the same
    axes."""
    module, fn, arch, args = INIT_CASES[case]
    _, tcall = _call(module, fn, arch, lambda side: args("float32", side))
    got = tcall(torch.Generator().manual_seed(11))
    want = _builder_form(module, fn, torch.Generator().manual_seed(11),
                         arch, args)
    assert got[1] == want[1]
    gl, wl = _flat(got[0]), _flat(want[0])
    assert sorted(gl) == sorted(wl)
    for k in gl:
        assert gl[k].dtype == wl[k].dtype and torch.equal(gl[k], wl[k]), k


@pytest.mark.parametrize("case", sorted(INIT_CASES))
def test_meta_init_takes_no_seed(case):
    """``device="meta"`` with ``generator=None`` builds the shapes and the
    axes of the real init and draws nothing; a generator handed to it
    is left where it was."""
    module, fn, arch, args = INIT_CASES[case]
    _, tcall = _call(module, fn, arch, lambda side: args("float32", side))
    meta = tcall(None, device="meta")
    real = tcall(torch.Generator().manual_seed(0))
    assert meta[1] == real[1]
    ml, rl = _flat(meta[0]), _flat(real[0])
    assert sorted(ml) == sorted(rl)
    for k in ml:
        assert ml[k].device.type == "meta", k
        assert ml[k].shape == rl[k].shape and ml[k].dtype == rl[k].dtype
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    tcall(gen, device="meta")
    assert torch.equal(gen.get_state(), state)
