"""The port's threefry key layer is bitwise equal to ``jax.random``.

Reference draws run with ``jax_threefry_partitionable`` pinned on, the
setting the port reproduces.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.functions import benchmarks as jbm  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.functions import benchmarks as tbm  # noqa: E402

SEEDS = [0, 7, 2008, 2 ** 31 - 1]


def _np(x):
    return np.asarray(x).astype(np.int64)


def _bits(x):
    """Bit pattern of a float32 array, for bitwise comparison."""
    return np.asarray(x, dtype=np.float32).view(np.int32)


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_split_fold_in(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert np.array_equal(_np(jk), tk.numpy())
    for n in (2, 3, 8):
        assert np.array_equal(_np(jax.random.split(jk, n)), prng.split(tk, n).numpy())
    for data in (0, 1, 5, 123456):
        assert np.array_equal(_np(jax.random.fold_in(jk, data)),
                              prng.fold_in(tk, data).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape,lo,hi", [((7, 13), 0.0, 1.0),
                                         ((64, 100), -100.0, 100.0),
                                         ((1000,), -90.0, 90.0),
                                         ((5, 3, 4), 0.0, 3.141592653589793)])
def test_uniform_bitwise(seed, shape, lo, hi):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    want = jax.random.uniform(jk, shape, minval=lo, maxval=hi)
    got = prng.uniform(tk, shape, lo, hi).numpy()
    assert got.shape == shape
    assert np.array_equal(_bits(want), _bits(got))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 15), (0, 799), (3, 1000),
                                   (0, 0), (-7, 12345)])
def test_randint_bitwise(seed, lo, hi):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    want = jax.random.randint(jk, (37,), lo, hi)
    assert np.array_equal(_np(want), prng.randint(tk, (37,), lo, hi).numpy())


def test_batched_keys_match_vmap():
    jks = jax.random.split(jax.random.PRNGKey(1), 4)
    tks = torch.from_numpy(_np(jks))
    u = jax.vmap(lambda k: jax.random.uniform(k, (3, 5)))(jks)
    assert np.array_equal(_bits(u), _bits(prng.uniform(tks, (3, 5)).numpy()))
    r = jax.vmap(lambda k: jax.random.randint(k, (9,), 0, 15))(jks)
    assert np.array_equal(_np(r), prng.randint(tks, (9,), 0, 15).numpy())
    s = jax.vmap(lambda k: jax.random.split(k, 3))(jks)
    assert np.array_equal(_np(s), prng.split(tks, 3).numpy())
    f = jax.vmap(lambda k: jax.random.fold_in(k, 6))(jks)
    assert np.array_equal(_np(f), prng.fold_in(tks, 6).numpy())
    # two leading key axes
    s2 = jax.vmap(lambda k: jax.random.split(k, 3))(jks)
    t2 = prng.split(tks, 3)
    u2 = jax.vmap(jax.vmap(lambda k: jax.random.uniform(k, (2, 6))))(s2)
    assert np.array_equal(_bits(u2), _bits(prng.uniform(t2, (2, 6)).numpy()))


def test_shift_vector_bitwise():
    want = jbm.shift_vector(1000)
    got = tbm.shift_vector(1000).numpy()
    assert np.array_equal(_bits(want), _bits(got))


def test_prng_bounds_raise():
    k = prng.PRNGKey(0)
    with pytest.raises(ValueError):
        prng.PRNGKey(-1)
    with pytest.raises(ValueError):
        prng.randint(k, (3,), 0, 2 ** 31)
