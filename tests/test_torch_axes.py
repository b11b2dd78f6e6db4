"""Port parity: the logical-axes trees (``ParamBuilder``'s lockstep
``axes``, ``Model.abstract_init``, the cache, state, optimizer and extras
axes), the dry-run's config names (``InputShape``, ``INPUT_SHAPES``,
``ASSIGNED_ARCHS``, ``has_mixer``, ``supports_long_context``) against
the live JAX package on the CPU, and the real init's seed stream.

Everything here is exactly equal: names, shapes and dtypes.  The
reference's side is ``jax.eval_shape`` of its ``Model.init`` (no
compile); the port's is ``Model.abstract_init`` on ``meta`` tensors, for
all twelve configs at full published size.
"""
import hashlib

import pytest
import torch

from repro_torch.configs import get_model_config, list_archs
from repro_torch.models.model import make_model
from repro_torch.tree import tree_flatten

torch.set_num_threads(2)

ARCHS = sorted(list_archs())

# sha256 (first 16 hex digits) of every leaf's shape, dtype and bytes of
# each reduced config's real init from torch.Generator().manual_seed(7),
# taken on the tree before the axes were added: the builder's seed stream
# (one seed per drawn leaf, in creation order) must not move
INIT_DIGESTS = {
    "bert-large": "8eea9dd40239733a",
    "deepseek-v2-lite-16b": "f4fa1c0319c1d8d0",
    "gemma2-9b": "2db22a5dca4a94fe",
    "hubert-xlarge": "f218eb1cbc4891f5",
    "jamba-1.5-large-398b": "b96cc18cb4fcd394",
    "llava-next-mistral-7b": "958b691b26b8c32b",
    "pga-lm-100m": "9caacb94b2be8b2a",
    "qwen1.5-32b": "8e1c1f29dd35c8fb",
    "qwen2-0.5b": "85ae9c4db8fa795c",
    "qwen3-0.6b": "e13fce08d6268651",
    "qwen3-moe-30b-a3b": "8467ef248236bab7",
    "xlstm-125m": "015ad4e8f327526c",
}


def _jax_init(arch: str):
    """The reference's abstract init: ``(shape/dtype leaves with paths,
    axes tree, cache axes)``."""
    import jax

    from repro.configs import get_model_config as jget
    from repro.models.model import make_model as jmake
    jm = jmake(jget(arch))
    box = {}

    def init(key):
        params, axes = jm.init(key)
        box["axes"] = axes
        return params

    sds = jax.eval_shape(init, jax.random.PRNGKey(0))
    return (jax.tree_util.tree_flatten_with_path(sds)[0], box["axes"],
            jm.cache_axes())


def _digest(params) -> str:
    h = hashlib.sha256()
    for t in tree_flatten(params)[0]:
        h.update(str(tuple(t.shape)).encode())
        h.update(str(t.dtype).encode())
        h.update(t.contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_init_equals_the_references_eval_shape(arch):
    """Leaf shapes, dtypes, the axes tree and the cache axes, at full
    published size (jamba-1.5-large-398b's 398.6e9 parameters included:
    meta tensors allocate nothing)."""
    jleaves, jaxes, jcache = _jax_init(arch)
    model = make_model(get_model_config(arch))
    params, axes = model.abstract_init()
    assert axes == jaxes
    assert model.cache_axes() == jcache
    leaves, _ = tree_flatten(params)
    assert len(leaves) == len(jleaves)
    for (path, j), t in zip(jleaves, leaves):
        assert t.device.type == "meta", path
        assert (tuple(t.shape), str(t.dtype)) == (
            tuple(j.shape), f"torch.{j.dtype}"), path
    # the axes tree has the params tree's structure, leaf for leaf
    axes_leaves = _axes_leaves(axes)
    assert len(axes_leaves) == len(leaves)
    for t, a in zip(leaves, axes_leaves):
        assert len(a) == t.dim()


def _axes_leaves(axes):
    if isinstance(axes, tuple):
        return [axes]
    return [a for k in sorted(axes) for a in _axes_leaves(axes[k])]


@pytest.mark.parametrize("arch", ARCHS)
def test_real_init_seed_stream_is_unchanged(arch):
    """A real init draws the values it drew before the builder recorded
    axes, and a meta init before it takes no seed."""
    model = make_model(get_model_config(arch, reduced=True))
    model.abstract_init()
    gen = torch.Generator().manual_seed(7)
    assert _digest(model.init(gen, "cpu")) == INIT_DIGESTS[arch]
    again = torch.Generator().manual_seed(7)
    model.init(again, "cpu")
    assert torch.equal(gen.get_state(), again.get_state())


def test_builder_checks_axes_against_the_shape():
    from repro_torch.models.layers import ParamBuilder
    b = ParamBuilder(torch.Generator().manual_seed(0), torch.float32, "cpu")
    with pytest.raises(AssertionError):
        b.add("w", (3, 4), ("embed",))
    m = ParamBuilder(None, torch.float32, "meta")
    w = m.add("w", (3, 4), ("embed", "ffn"), init="normal")
    assert w.device.type == "meta" and m.axes == {"w": ("embed", "ffn")}


def test_stack_inits_prefixes_layers():
    from repro_torch.models.layers import ParamBuilder, stack_inits

    for device in ("cpu", "meta"):
        def block(generator, device=device):
            b = ParamBuilder(generator, torch.float32, device)
            b.add("w", (2, 3), ("embed", "ffn"))
            b.add("n", (3,), (None,), init="ones")
            return b.params, b.axes

        gen = torch.Generator().manual_seed(1) if device == "cpu" else None
        params, axes = stack_inits(block, gen, 4, device=device)
        assert axes == {"w": ("layers", "embed", "ffn"),
                        "n": ("layers", None)}
        assert tuple(params["w"].shape) == (4, 2, 3)
        assert params["w"].device.type == device
        if device == "cpu":     # each layer its own draw
            assert not torch.equal(params["w"][0], params["w"][1])


@pytest.mark.parametrize("opt", ("sgd", "adamw", "lamb"))
def test_state_axes_equal_the_references(opt):
    import dataclasses

    from repro.configs import DistConfig as JDist
    from repro.core import algo as jalgo
    from repro.train import state as jstate
    from repro_torch.configs import DistConfig
    from repro_torch.core import algo as talgo
    from repro_torch.train import state as tstate
    jaxes = _jax_init("deepseek-v2-lite-16b")[1]
    _, axes = make_model(get_model_config(
        "deepseek-v2-lite-16b")).abstract_init()
    for over in (dict(), dict(algorithm="slowmo"),
                 dict(comm_compression="int8", comm_error_feedback=True)):
        st, jst = tstate.stacked_axes(axes), jstate.stacked_axes(jaxes)
        assert st == jst
        assert tstate.opt_state_axes(opt, st) == jstate.opt_state_axes(
            opt, jst)
        got = tstate.state_axes(st, opt, extras=talgo.extras_axes(
            DistConfig(**over), st, axes))
        want = jstate.state_axes(jst, opt, extras=jalgo.extras_axes(
            JDist(**over), jst, jaxes))
        assert {f.name: getattr(got, f.name)
                for f in dataclasses.fields(got)} == {
            f.name: getattr(want, f.name) for f in dataclasses.fields(want)}


def _algo_cases():
    from repro_torch.core import algo as talgo
    cases = []
    for name in talgo.algorithm_names():
        cases.append((name, {}))
        cases.append((name, dict(comm_compression="int8",
                                 comm_error_feedback=True)))
    for name in talgo.push_sum_algorithm_names():
        cases.append((name, dict(push_sum=True)))
    return cases


@pytest.mark.parametrize("name,over", _algo_cases())
def test_extras_axes_equal_the_references(name, over):
    from repro.configs import DistConfig as JDist
    from repro.core import algo as jalgo
    from repro.train import state as jstate
    from repro_torch.configs import DistConfig
    from repro_torch.core import algo as talgo
    from repro_torch.train import state as tstate
    _, axes = make_model(get_model_config("pga-lm-100m")).abstract_init()
    st = tstate.stacked_axes(axes)
    got = talgo.extras_axes(DistConfig(algorithm=name, **over), st, axes)
    want = jalgo.extras_axes(JDist(algorithm=name, **over),
                             jstate.stacked_axes(axes), axes)
    assert got == want
    # the axes tree has init_extras's structure
    params, _ = make_model(get_model_config("pga-lm-100m",
                                            reduced=True)).abstract_init()
    ex = talgo.init_extras(DistConfig(algorithm=name, **over),
                           tstate.stack_for_nodes(params, 4), 4)
    assert sorted(ex) == sorted(got)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_names_equal_the_references(arch):
    from repro.configs import get_model_config as jget
    for long_context in (False, True):
        t = get_model_config(arch, long_context=long_context)
        j = jget(arch, long_context=long_context)
        assert t.supports_long_context == j.supports_long_context
        for kinds in (("attn",), ("attn_sw",), ("mamba", "mlstm"),
                      ("slstm",), ("attn", "mamba")):
            assert t.has_mixer(*kinds) == j.has_mixer(*kinds), kinds


def test_input_shapes_and_assigned_archs_equal_the_references():
    import dataclasses

    from repro.configs import ASSIGNED_ARCHS as JA
    from repro.configs import INPUT_SHAPES as JS
    from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES
    assert ASSIGNED_ARCHS == JA
    assert list(INPUT_SHAPES) == list(JS)
    for k, s in INPUT_SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(JS[k])
