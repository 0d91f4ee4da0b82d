"""The port's analytic HBM model against the JAX package's:
``_axis_sizes``, ``_shard_fraction``, ``sharded_bytes`` and every term of
``analytic_memory``, within 1e-9 relative, for every supported (arch,
shape) cell on both production meshes. The reference's trees are its own
(``jax.eval_shape`` of ``init_params``, its spec trees, its
``input_specs``); the port's its own (``param_shapes``, its spec trees,
its ``meta`` decode state, whose host-integer ``pos`` counts as the
reference's int32 scalar)."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ARCHS, get_config as jget  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.models.transformer import init_params as jinit  # noqa: E402
from repro.parallel import memmodel as jmm  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.parallel import memmodel as tmm  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402

AXES = {"16x16": ("data", "model"), "2x16x16": ("pod", "data", "model")}


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    cfg = jget(arch)
    return jax.eval_shape(lambda k: jinit(k, cfg), jax.ShapeDtypeStruct((2,), jnp.uint32))


@functools.lru_cache(maxsize=None)
def _tparams(arch):
    return tsh.param_shapes(get_config(arch))


def test_axis_sizes_and_shard_fraction():
    for axes in AXES.values():
        assert tmm._axis_sizes(axes) == jmm._axis_sizes(axes)
        sizes = jmm._axis_sizes(axes)
        for parts in ((), (None,), ("model",), (("pod", "data"), None, "model"),
                      (None, ("pod", "data", "model")), ("data", "model")):
            assert tmm._shard_fraction(tsh.P(*parts), sizes) == \
                jmm._shard_fraction(JP(*parts), sizes)


def _close(ours: dict, ref: dict, where: str) -> None:
    assert list(ours) == list(ref), where
    for k, v in ref.items():
        assert ours[k] == pytest.approx(v, rel=1e-9, abs=0), f"{where}: {k}"


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("mesh", list(AXES))
def test_analytic_memory_every_cell(arch, mesh):
    axes = AXES[mesh]
    cfg, jcfg = get_config(arch), jget(arch)
    sizes = jmm._axis_sizes(axes)
    assert tmm.sharded_bytes(_tparams(arch), tsh.param_specs(cfg, axes), sizes) == \
        pytest.approx(jmm.sharded_bytes(_jparams(arch), jsh.param_specs(jcfg, axes), sizes),
                      rel=1e-9)
    for shape, sp in jshapes.SHAPES.items():
        if not jshapes.cell_supported(jcfg, shape)[0]:
            continue
        B, S = sp.global_batch, sp.seq_len
        kind, ours = tshapes.input_specs(cfg, shape)
        _, ref = jshapes.input_specs(jcfg, shape)
        decode = kind == "decode"
        got = tmm.analytic_memory(
            cfg, kind, axes, B, S, _tparams(arch), tsh.param_specs(cfg, axes),
            tsh.compute_specs(cfg, axes), state_shape=ours.get("state"),
            state_specs=tsh.decode_state_specs(cfg, axes, B) if decode else None)
        want = jmm.analytic_memory(
            jcfg, kind, axes, B, S, _jparams(arch), jsh.param_specs(jcfg, axes),
            jsh.compute_specs(jcfg, axes), state_shape=ref.get("state"),
            state_specs=jsh.decode_state_specs(jcfg, axes, B) if decode else None)
        _close(got, want, f"{arch} {shape} {mesh}")


def test_sharded_bytes_counts_pos_as_int32():
    cfg, jcfg = get_config("zamba2-7b"), jget("zamba2-7b")
    axes = AXES["16x16"]
    sizes = jmm._axis_sizes(axes)
    ours = tshapes.decode_state_specs(cfg, 128, 32768)
    ref = jshapes.decode_state_specs(jcfg, 128, 32768)
    got = tmm.sharded_bytes(ours, tsh.decode_state_specs(cfg, axes, 128), sizes)
    want = jmm.sharded_bytes(ref, jsh.decode_state_specs(jcfg, axes, 128), sizes)
    assert got == want
    assert tmm.sharded_bytes({"pos": 0}, {"pos": tsh.P()}, sizes) == 4.0
