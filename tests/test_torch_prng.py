"""The port's threefry key layer is bitwise equal to ``jax.random``.

Reference draws run with ``jax_threefry_partitionable`` pinned on, the
setting the port reproduces.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

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


def _ulps(a, b):
    """Distance in float32 ulps (same-sign values)."""
    return np.abs(_bits(a).astype(np.int64) - _bits(b).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_bound(seed):
    """XLA's erf_inv polynomial step by step, log1p rounded once: within
    4 ulps and 1e-6 relative of jax.random.normal (measured: under 1% of
    values differ, by at most 3 ulps, 2.4e-7 relative)."""
    shape = (500, 1000)
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = prng.normal(prng.PRNGKey(seed), shape).numpy()
    ulp = _ulps(got, want)
    big = np.abs(want) > 1e-3
    rel = np.abs(got[big].astype(np.float64) - want[big]) / np.abs(want[big])
    msg = (f"{int((ulp > 0).sum())} of {want.size} differ, max {ulp.max()} ulp, "
           f"max rel {rel.max():.3g}")
    assert ulp.max() <= 4 and rel.max() < 1e-6, msg
    assert (ulp > 0).mean() < 0.02, msg


def test_normal_scale_and_loc_follow_xla():
    """``loc + scale * normal`` as XLA computes it inside a jitted function
    (scale folded into sqrt(2), the add fused), batched over keys."""
    jks = jax.random.split(jax.random.PRNGKey(5), 3)
    loc = np.random.default_rng(0).uniform(-5, 5, (3, 64, 100)).astype(np.float32)
    want = jax.jit(jax.vmap(lambda k, l: l + 1.024 * jax.random.normal(k, (64, 100))))(
        jks, jnp.asarray(loc))
    got = prng.normal(torch.from_numpy(_np(jks)), (64, 100), 1.024,
                      torch.from_numpy(loc)).numpy()
    want = np.asarray(want)
    # An ulp of the larger term: the sum can cancel to far below both.
    scale = np.abs(loc) + np.abs(want - loc)
    err = np.abs(got - want) / np.spacing(scale)
    n_diff = int((got != want).sum())
    assert err.max() <= 2 and n_diff < 0.02 * want.size, (n_diff, err.max())
    want = jax.jit(jax.vmap(lambda k: 20.48 * jax.random.normal(k, (50,))))(jks)
    got = prng.normal(torch.from_numpy(_np(jks)), (50,), 20.48).numpy()
    assert _ulps(got, np.asarray(want)).max() <= 4


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_within_bound(seed):
    """GA's draw: (2, n_off) parents from one pop-sized roulette per
    island. The gumbel noise takes log in float64, within 2e-6 of JAX's; a
    sample can differ only where two categories tie that closely."""
    jks = jax.random.split(jax.random.PRNGKey(seed), 4)
    rng = np.random.default_rng(seed)
    w = rng.uniform(0, 1, (4, 800)).astype(np.float32)
    w[:, :50] = 0.0                                   # dead slots
    logits = np.log(w + np.float32(1e-30)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda k, l: jax.random.categorical(
        k, l, shape=(2, 200)))(jks, jnp.asarray(logits)))
    got = prng.categorical(torch.from_numpy(_np(jks)), torch.from_numpy(logits),
                           (2, 200)).numpy()
    assert got.shape == want.shape == (4, 2, 200)
    n_diff = int((got != want).sum())
    assert n_diff <= want.size // 1000, f"{n_diff} of {want.size} samples differ"
    g = jax.vmap(lambda k: jax.random.gumbel(k, (2, 200, 800)))(jks)
    u = prng.uniform(torch.from_numpy(_np(jks)), (2, 200, 800),
                     float(np.finfo(np.float32).tiny), 1.0)
    tg = -torch.log(-torch.log(u.double()).float().double()).float()
    assert float(np.max(np.abs(tg.numpy() - np.asarray(g)))) < 2e-6
    assert not np.isin(got, np.arange(50)).any()      # dead slots never drawn


# 16-bit draws (model parameters in ``param_dtype``): jax.random's bits for
# uint8/uint16 are the low bits of the 32-bit word; bfloat16 draws 8 of
# them for its 7 mantissa bits, float16 16 for its 10.
HALF = [(jnp.bfloat16, torch.bfloat16), (jnp.float16, torch.float16)]


def _bits16(x):
    """Bit pattern of a 16-bit float array (numpy or torch), as int64."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy().astype(np.int64) & 0xFFFF
    return np.asarray(x).view(np.uint16).astype(np.int64)


def _ulps16(a, b):
    """Distance in ulps of the 16-bit type, across zero."""
    ia, ib = _bits16(a), _bits16(b)
    ia = np.where(ia >= 0x8000, 0x8000 - ia, ia)
    ib = np.where(ib >= 0x8000, 0x8000 - ib, ib)
    return np.abs(ia - ib)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("width,jdt", [(8, jnp.uint8), (16, jnp.uint16), (32, jnp.uint32)])
def test_random_bits_narrow_bitwise(seed, width, jdt):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    want = _np(jax.random.bits(jk, (37, 53), jdt))
    got = prng.random_bits(tk, (37, 53), width=width).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("jdt,tdt", HALF)
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-100.0, 100.0), (-3.0, 0.7),
                                   (0.0, 3.141592653589793)])
def test_uniform_16bit_bitwise(seed, jdt, tdt, lo, hi):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    want = jax.random.uniform(jk, (64, 100), jdt, lo, hi)
    got = prng.uniform(tk, (64, 100), lo, hi, dtype=tdt)
    assert got.dtype == tdt
    assert np.array_equal(_bits16(got), _bits16(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("jdt,tdt", HALF)
def test_normal_16bit_within_one_ulp(seed, jdt, tdt):
    """float32 ``erf_inv`` of the type's uniform, rounded to the type, times
    sqrt(2) in the type: within one ulp of the type (measured: equal on
    these draws; the float32 ``erf_inv`` is within 4 float32 ulps of
    XLA's, which a 16-bit rounding rarely shows)."""
    shape = (500, 400)
    want = jax.random.normal(jax.random.PRNGKey(seed), shape, jdt)
    got = prng.normal(prng.PRNGKey(seed), shape, dtype=tdt)
    ulp = _ulps16(got, want)
    print(f"{tdt} seed {seed}: {int((ulp > 0).sum())} of {ulp.size} differ")
    assert got.dtype == tdt and ulp.max() <= 1
    jks = jax.random.split(jax.random.PRNGKey(seed), 3)
    want = jax.vmap(lambda k: jax.random.normal(k, (7, 9), jdt))(jks)
    got = prng.normal(torch.from_numpy(_np(jks)), (7, 9), dtype=tdt)
    assert _ulps16(got, want).max() <= 1


def test_normal_16bit_refuses_scale():
    with pytest.raises(ValueError):
        prng.normal(prng.PRNGKey(0), (3,), 2.0, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        prng.random_bits(prng.PRNGKey(0), (3,), width=12)
