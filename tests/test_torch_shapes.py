"""The port's cell shapes against the JAX package's: ``SHAPES``,
``SUBQUADRATIC`` and ``cell_supported`` for all ten archs x four shapes,
and ``input_specs`` / ``decode_state_specs`` leaf for leaf (shape and
dtype of each ``meta`` tensor against the reference's
``jax.ShapeDtypeStruct``). The decode state's ``pos`` is a host integer in
the port (``init_decode_state``), an int32 scalar in the reference."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, get_config as jget  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402

DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.int32): torch.int32}


def test_shapes_table_and_subquadratic():
    assert tshapes.SUBQUADRATIC == jshapes.SUBQUADRATIC
    assert list(tshapes.SHAPES) == list(jshapes.SHAPES)
    for name, sp in jshapes.SHAPES.items():
        got = tshapes.SHAPES[name]
        assert (got.name, got.seq_len, got.global_batch, got.kind) == \
            (sp.name, sp.seq_len, sp.global_batch, sp.kind)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("shape", list(jshapes.SHAPES))
def test_cell_supported(arch, shape):
    assert tshapes.cell_supported(get_config(arch), shape) == \
        jshapes.cell_supported(jget(arch), shape)


def _compare(ours, ref, where=""):
    """A port spec tree against the reference's, leaf for leaf."""
    if isinstance(ref, dict):
        # (jax's tree functions rebuild a dict in sorted key order)
        assert isinstance(ours, dict) and sorted(ours) == sorted(ref), where
        for k in ref:
            _compare(ours[k], ref[k], f"{where}/{k}")
        return
    if where.endswith("/pos"):
        # the port's cache position is a host integer at 0, the
        # reference's an int32 scalar
        assert ours == 0 and isinstance(ours, int), where
        assert ref.shape == () and ref.dtype == jnp.int32, where
        return
    assert isinstance(ours, torch.Tensor) and ours.device.type == "meta", where
    assert tuple(ours.shape) == tuple(ref.shape), where
    assert ours.dtype == DTYPES[jnp.dtype(ref.dtype)], where


@pytest.mark.parametrize("arch", list(ARCHS))
def test_input_specs_leaf_for_leaf(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    for shape in jshapes.SHAPES:
        ok, why = jshapes.cell_supported(jcfg, shape)
        if not ok:
            with pytest.raises(ValueError, match="skipped"):
                tshapes.input_specs(cfg, shape)
            continue
        kind, ours = tshapes.input_specs(cfg, shape)
        jkind, ref = jshapes.input_specs(jcfg, shape)
        assert kind == jkind
        _compare(ours, ref, f"{arch}/{shape}")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-370m", "zamba2-7b"])
def test_decode_state_specs(arch):
    _compare(tshapes.decode_state_specs(get_config(arch), 4, 64),
             jshapes.decode_state_specs(jget(arch), 4, 64), arch)
