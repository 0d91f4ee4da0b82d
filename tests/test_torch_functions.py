"""The port's 18 benchmark functions agree with the JAX package's.

Inputs are drawn with numpy in ``[-5, 5]`` clipped to each function's box
(michalewicz's ``sin(i x^2 / pi)^20`` holds float32 parity only there) and
go through both packages; bounds are the JAX kernel suite's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.functions import benchmarks as jbm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.functions import benchmarks as tbm  # noqa: E402


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (np.abs(a) + 1.0)))


def test_registry_names_match():
    assert list(tbm.FUNCTIONS) == list(jbm.FUNCTIONS)
    for name, jf in jbm.FUNCTIONS.items():
        tf = tbm.FUNCTIONS[name]
        assert (tf.lo, tf.hi, tf.f_star, tf.smooth) == pytest.approx(
            (jf.lo, jf.hi, jf.f_star, jf.smooth)), name


@pytest.mark.parametrize("name", list(jbm.FUNCTIONS))
@pytest.mark.parametrize("P,D", [(8, 1), (9, 2), (37, 100), (13, 1000)])
def test_function_matches_jax(name, P, D):
    jf, tf = jbm.FUNCTIONS[name], tbm.FUNCTIONS[name]
    rng = np.random.default_rng([list(jbm.FUNCTIONS).index(name), P, D])
    x = rng.uniform(max(jf.lo, -5.0), min(jf.hi, 5.0), (P, D)).astype(np.float32)
    want = jax.vmap(jf.fn)(jnp.asarray(x))
    got = tf.fn(torch.from_numpy(x))
    assert got.shape == (P,)
    assert _rel(want, got.numpy()) < (1e-4 if name == "michalewicz" else 1e-5)


def test_function_batched_over_leading_axes():
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -5, 5, (3, 4, 10)).astype(np.float32))
    for f in tbm.FUNCTIONS.values():
        out = f.fn(x)
        assert out.shape == (3, 4)
        assert torch.allclose(out[1], f.fn(x[1]))


@pytest.mark.parametrize("dim", [2, 100, 1000])
def test_shifted_rosenbrock_matches_jax(dim):
    jf, tf = jbm.make_shifted_rosenbrock(dim), tbm.get("shifted_rosenbrock", dim)
    assert (tf.name, tf.lo, tf.hi, tf.f_star, tf.bias) == (
        jf.name, jf.lo, jf.hi, jf.f_star, jf.bias)
    x = np.random.default_rng(dim).uniform(-100, 100, (16, dim)).astype(np.float32)
    want = jax.vmap(jf.fn)(jnp.asarray(x))
    assert _rel(want, tf.fn(torch.from_numpy(x)).numpy()) < 1e-5


def test_function_from_numpy_carries_shift():
    jf = jbm.make_shifted_rosenbrock(50)
    tf = convert.function_from_numpy(jf.name, np.asarray(jf.shift), jf.bias)
    x = np.random.default_rng(1).uniform(-100, 100, (8, 50)).astype(np.float32)
    want = jax.vmap(jf.fn)(jnp.asarray(x))
    assert _rel(want, tf.fn(torch.from_numpy(x)).numpy()) < 1e-5
    g = convert.function_from_numpy("sphere", np.ones(50, np.float32), 2.0)
    out = g.fn(torch.ones(3, 50))
    assert torch.equal(out, torch.full((3,), 2.0))
    assert convert.function_from_numpy("sphere") is tbm.FUNCTIONS["sphere"]


def test_cache_token_keys_on_shift_content():
    a, b = tbm.make_shifted_rosenbrock(10), tbm.make_shifted_rosenbrock(10, seed=1)
    assert a.cache_token() != b.cache_token()
    assert a.cache_token()[2] == tbm.make_shifted_rosenbrock(10).cache_token()[2]
    with pytest.raises(ValueError):
        tbm.get("shifted_rosenbrock")
