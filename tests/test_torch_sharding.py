"""The port's sharding rules against the JAX package's: every spec tree
(``param_specs``, ``compute_specs``, ``opt_state_specs``, ``batch_specs``,
``decode_state_specs``) leaf for leaf for all ten archs, both production
axis sets and all three sharding modes; the placements a spec gives on a
mesh; the rules context and the mesh factory's refusals.

The reference's trees are cached per (arch, axes, mode), and within the
module its ``_dp_zero1_specs`` per (config, axes): each call traces the
whole init with ``jax.eval_shape``, and ``param_specs``, ``compute_specs``
and ``opt_state_specs`` each make one.
"""
import dataclasses
import functools
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ARCHS, get_config as jget  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as lmesh  # noqa: E402
from repro_torch.optim.adam import AdamState  # noqa: E402
from repro_torch.parallel import ctx, sharding as tsh  # noqa: E402

AXES = {"2d": ("data", "model"), "3d": ("pod", "data", "model")}
MODES = ("tp", "tp+fsdp", "dp+zero1")
BATCHES = (8, 16, 32)


def _norm(tree):
    """A spec tree as plain data: specs as ("P", tuple(spec)), named tuples
    by their type's name, dicts as dicts."""
    if isinstance(tree, (JP, tsh.P)):
        return ("P", tuple(tree))
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return (type(tree).__name__, tuple(_norm(v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_norm(v) for v in tree)
    return ("leaf", tree)


@pytest.fixture(scope="module", autouse=True)
def _zero1_cached():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsh, "_dp_zero1_specs", functools.lru_cache(maxsize=None)(jsh._dp_zero1_specs))
        yield


@functools.lru_cache(maxsize=None)
def _reference(arch, axes, mode):
    cfg = dataclasses.replace(jget(arch), sharding_mode=mode)
    return _norm({
        "param": jsh.param_specs(cfg, axes),
        "compute": jsh.compute_specs(cfg, axes),
        "opt": jsh.opt_state_specs(cfg, axes),
        **{f"batch{b}": jsh.batch_specs(cfg, axes, b) for b in BATCHES},
        **{f"decode{b}": jsh.decode_state_specs(cfg, axes, b) for b in BATCHES},
    })


def _port(arch, axes, mode):
    cfg = dataclasses.replace(get_config(arch), sharding_mode=mode)
    return _norm({
        "param": tsh.param_specs(cfg, axes),
        "compute": tsh.compute_specs(cfg, axes),
        "opt": tsh.opt_state_specs(cfg, axes),
        **{f"batch{b}": tsh.batch_specs(cfg, axes, b) for b in BATCHES},
        **{f"decode{b}": tsh.decode_state_specs(cfg, axes, b) for b in BATCHES},
    })


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("axes", sorted(AXES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_spec_trees_equal_the_reference(arch, axes, mode):
    """param, compute (None where the reference gives None), opt-state
    (AdamState), batch and decode-state specs at global batch 8, 16, 32."""
    want, got = _reference(arch, AXES[axes], mode), _port(arch, AXES[axes], mode)
    for name in want:
        assert got[name] == want[name], (arch, axes, mode, name)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_shapes_equal_the_reference(arch):
    """The shape walk (``param_shapes``: the init on ``meta``, no draw)
    gives every leaf of the reference's ``jax.eval_shape`` of the init at
    its shape and dtype, and each spec is no longer than its leaf's rank."""
    cfg = get_config(arch)
    shapes = dict(_leaves(tsh.param_shapes(cfg)))
    want = dict(_leaves(jax.eval_shape(lambda k: JT.init_params(k, jget(arch)),
                                       jax.ShapeDtypeStruct((2,), jnp.uint32))))
    assert set(shapes) == set(want)
    for name, t in shapes.items():
        assert tuple(t.shape) == tuple(want[name].shape), name
        assert str(t.dtype).replace("torch.", "") == str(want[name].dtype), name
    for mode in MODES:
        specs = dict(_leaves(tsh.param_specs(dataclasses.replace(cfg, sharding_mode=mode),
                                             AXES["3d"])))
        for name, t in shapes.items():
            assert t.device.type == "meta"
            assert len(specs[name]) <= t.dim(), (name, specs[name], t.shape)


def _leaves(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{pre}/{k}")
    else:
        yield pre, tree


def test_opt_state_specs_are_an_adam_state():
    s = tsh.opt_state_specs(get_config("llama3.2-1b"), AXES["2d"])
    assert isinstance(s, AdamState) and s.step == tsh.P()
    assert s.mu == s.nu and s.mu is not s.nu


def test_p_stores_a_one_name_tuple_as_the_name():
    assert tuple(tsh.P(("data",), None)) == ("data", None) == tuple(JP(("data",), None))
    assert tuple(tsh.P(("pod", "data"), "model")) == (("pod", "data"), "model")


def _mesh(*names):
    return types.SimpleNamespace(mesh_dim_names=names)


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    m = _mesh("pod", "data", "model")
    assert tsh.placements_of(m, tsh.P(("pod", "data"), "model")) == (Shard(0), Shard(0), Shard(1))
    assert tsh.placements_of(m, tsh.P(None, None)) == (Replicate(),) * 3
    assert tsh.placements_of(m, tsh.P()) == (Replicate(),) * 3
    assert tsh.placements_of(m, tsh.P(None, "data", None)) == (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        tsh.placements_of(m, tsh.P(("data", "pod")))


def test_to_shardings_keeps_nesting_and_none():
    m = _mesh("data", "model")
    lay = tsh.to_shardings(m, tsh.opt_state_specs(get_config("mamba2-370m"), AXES["2d"]))
    assert isinstance(lay, AdamState) and isinstance(lay.step, tsh.Layout)
    assert lay.mu["layers"]["ssm"]["w_x"].mesh is m
    assert tsh.to_shardings(m, {"a": None, "b": tsh.P("model")})["a"] is None


def test_rules_context_is_a_no_op_without_rules():
    x = torch.ones(3)
    assert ctx.constrain(x, "attn_seq_q") is x
    lp = {"w": x}
    assert ctx.constrain_layer_weights(lp) is lp
    assert ctx.like(x, torch.zeros(2)) is x and ctx.replicated(x) is x
    with ctx.sharding_rules(attn_seq_q=tsh.Layout(None, ())):
        assert ctx.constrain(x, "attn_seq_q") is x      # a plain tensor stays as it is
        assert "attn_seq_q" in ctx._RULES
    assert ctx._RULES == {}


def test_mesh_factory_needs_its_world():
    with pytest.raises(RuntimeError, match="256"):
        lmesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="512"):
        lmesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(RuntimeError, match="initialised"):
        lmesh.make_host_mesh(1, 2, device="cpu")


def test_data_axes():
    assert lmesh.data_axes(types.SimpleNamespace(mesh_dim_names=("data", "model"))) == ("data",)
    assert lmesh.data_axes(types.SimpleNamespace(
        mesh_dim_names=("pod", "data", "model"))) == ("pod", "data")
