"""Port parity: ``repro_torch.launch.specs`` against the live JAX
package's ``repro.launch.specs`` on the CPU, on the production meshes
``(data=16, model=16)`` and ``(pod=2, data=16, model=16)``.

For one dense (qwen3-0.6b), one MoE (qwen3-moe-30b-a3b), the hybrid
(jamba-1.5-large-398b), one encoder (hubert-xlarge: frames and mask) and
the VLM (llava-next-mistral-7b: patches) at full published size: every
leaf's shape, dtype and ``PartitionSpec`` of the train specs (under the
dry-run's node axis for the arch) and of the serve specs in every serving
mode (``serve_tp``, ``serve_2d``, ``serve_tp_seq``, ``serve_cp``) for
prefill and decode, all exactly equal.  The reference's side is
``jax.eval_shape`` and its own ``_shardings``/``batch_specs`` on an
``AbstractMesh`` (no compile, no forced host devices); its abstract
params and caches are traced once per arch.  The port's train state
keeps its step as a host int, so ``step`` is compared apart.
"""
import functools

import pytest
import torch

from repro_torch.configs import INPUT_SHAPES, DistConfig, get_model_config
from repro_torch.launch import specs as tspecs
from repro_torch.launch.dryrun import HIERARCHICAL_ARCHS
from repro_torch.launch.mesh import make_production_mesh

torch.set_num_threads(2)

ARCHS = ("qwen3-0.6b", "qwen3-moe-30b-a3b", "jamba-1.5-large-398b",
         "hubert-xlarge", "llava-next-mistral-7b")
MESHES = ("single", "multi")
# mode -> the port's serve_specs arguments that select it
MODES = {"serve_tp": dict(param_sharding="tp", context_parallel=False),
         "serve_2d": dict(param_sharding="2d", context_parallel=False),
         "serve_tp_seq": dict(param_sharding="tp_seq",
                              context_parallel=False),
         "serve_cp": dict(param_sharding="tp", context_parallel=True)}


def _abstract_mesh(kind: str):
    from jax.sharding import AbstractMesh
    if kind == "multi":
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str):
    """The reference's abstract params and axes (one eval_shape)."""
    import jax

    from repro.configs import get_model_config as jget
    from repro.models.model import make_model as jmake
    jm = jmake(jget(arch))
    box = {}

    def init(key):
        params, axes = jm.init(key)
        box["axes"] = axes
        return params

    return jax.eval_shape(init, jax.random.PRNGKey(0)), box["axes"]


@functools.lru_cache(maxsize=None)
def _jax_cache(arch: str, batch: int, seq: int):
    import jax

    from repro.configs import get_model_config as jget
    from repro.models.model import make_model as jmake
    jm = jmake(jget(arch))
    return jax.eval_shape(lambda: jm.init_cache(batch, seq)), jm.cache_axes()


def _jax_rows(sds, shardings):
    """``[(path, shape, dtype, spec)]`` of a reference tree, in JAX's
    order (sorted dict keys)."""
    import jax
    leaves = jax.tree_util.tree_flatten_with_path(sds)[0]
    shs = jax.tree.leaves(shardings, is_leaf=lambda x: hasattr(x, "spec"))
    assert len(leaves) == len(shs)
    return [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype),
             tuple(s.spec)) for (p, a), s in zip(leaves, shs)]


def _port_rows(sds, shardings):
    if isinstance(sds, dict):
        return [r for k in sorted(sds)
                for r in _port_rows(sds[k], shardings[k])]
    assert sds.device.type == "meta"
    return [(None, tuple(sds.shape), str(sds.dtype).replace("torch.", ""),
             tuple(shardings.spec))]


def _same(port, ref):
    assert len(port) == len(ref)
    for (_, *p), (path, *r) in zip(port, ref):
        assert p == r, (path, p, r)


def _train_dist(arch, mesh_kind):
    node_axis = ("pod" if arch in HIERARCHICAL_ARCHS and mesh_kind == "multi"
                 else "data")
    return dict(node_axis=node_axis)


@pytest.mark.parametrize("mesh_kind", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_specs_equal_the_references(arch, mesh_kind):
    from repro.configs import DistConfig as JDist
    from repro.configs import INPUT_SHAPES as JS
    from repro.configs import get_model_config as jget
    from repro.launch import specs as jspecs
    am = _abstract_mesh(mesh_kind)
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                device="meta")
    over = _train_dist(arch, mesh_kind)
    want = jspecs.train_specs(jget(arch), am, JS["train_4k"],
                              dist=JDist(**over))
    got = tspecs.train_specs(get_model_config(arch), mesh,
                             INPUT_SHAPES["train_4k"],
                             dist=DistConfig(**over))
    assert (got.n_nodes, got.mode) == (want.n_nodes, want.mode)
    for field in ("params", "opt_state", "extras"):
        _same(_port_rows(getattr(got.state_sds, field),
                         getattr(got.state_shardings, field)),
              _jax_rows(getattr(want.state_sds, field),
                        getattr(want.state_shardings, field)))
    assert got.state_sds.step == 0 and tuple(want.state_sds.step.shape) == ()
    assert tuple(got.state_shardings.step.spec) == tuple(
        want.state_shardings.step.spec)
    _same(_port_rows(got.batch_sds, got.batch_shardings),
          _jax_rows(want.batch_sds, want.batch_shardings))
    assert (tuple(got.lr_sds.shape), tuple(got.lr_sharding.spec)) == (
        tuple(want.lr_sds.shape), tuple(want.lr_sharding.spec))


@pytest.mark.parametrize("mesh_kind", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_specs_equal_the_references(arch, mesh_kind):
    from repro.configs import get_model_config as jget
    from repro.launch import specs as jspecs
    from repro.models import sharding as jshd
    am = _abstract_mesh(mesh_kind)
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                device="meta")
    cfg, jcfg = get_model_config(arch), jget(arch)
    params_sds, axes = _jax_params(arch)
    kinds = ("prefill_32k",) + (("decode_32k",) if cfg.family != "encoder"
                                else ())
    for shape_name in kinds:
        shape = INPUT_SHAPES[shape_name]
        for mode, kw in MODES.items():
            got = tspecs.serve_specs(cfg, mesh, shape, **kw)
            assert got.mode == mode
            _same(_port_rows(got.params_sds, got.params_shardings),
                  _jax_rows(params_sds, jspecs._shardings(axes, mode, am,
                                                          params_sds)))
            B, S = shape.global_batch, shape.seq_len
            if shape.kind == "prefill":
                b_sds, b_axes = jspecs.batch_specs(jcfg, None, B, S)
                b_sds.pop("targets", None)
                b_axes.pop("targets", None)
                _same(_port_rows(got.batch_sds, got.batch_shardings),
                      _jax_rows(b_sds, jspecs._shardings(b_axes, mode, am,
                                                         b_sds)))
                assert got.cache_sds is None and got.tokens_sds is None
                continue
            c_sds, c_axes = _jax_cache(arch, B, S)
            _same(_port_rows(got.cache_sds, got.cache_shardings),
                  _jax_rows(c_sds, jspecs._shardings(c_axes, mode, am,
                                                     c_sds)))
            for t, sh, ax in ((got.tokens_sds, got.tokens_sharding,
                               ("batch", None)),
                              (got.pos_sds, got.pos_sharding, ("batch",))):
                assert t.dtype == torch.int32
                assert tuple(sh.spec) == tuple(jshd.logical_to_spec(
                    ax, mode, am, shape=tuple(t.shape)))
            assert tuple(got.tokens_sds.shape) == (B, 1)
            assert tuple(got.pos_sds.shape) == (B,)


@pytest.mark.parametrize("shape_name", ("decode_32k", "long_500k"))
def test_context_parallel_rule_equals_the_references(shape_name):
    """``context_parallel=None`` picks ``serve_cp`` when the decode batch
    is smaller than the data axis (long_500k's batch of 1), as the
    reference's ``serve_specs`` does."""
    from repro.configs import INPUT_SHAPES as JS
    from repro.configs import get_model_config as jget
    from repro.launch import specs as jspecs
    am = _abstract_mesh("single")
    mesh = make_production_mesh(device="meta")
    arch = "xlstm-125m"
    want = jspecs.serve_specs(jget(arch), am, JS[shape_name])
    got = tspecs.serve_specs(get_model_config(arch), mesh,
                             INPUT_SHAPES[shape_name])
    assert got.mode == want.mode
    _same(_port_rows(got.cache_sds, got.cache_shardings),
          _jax_rows(want.cache_sds, want.cache_shardings))
