"""The port's int8 gradient compression against the JAX package's
(``parallel/compress.py``): on the same keys the int8 payload and the
scales are the reference's bits, for single leaves and whole trees, and
``compressed_pod_mean`` over 2 gloo ranks of a (2, 1, 1) pod mesh is the
reference's under ``jax.vmap(..., axis_name="pod")`` over the two ranks'
gradients, bit for bit. The reference's own error-bound, unbiasedness and
round-trip tests (``tests/test_compress.py``) are repeated on the port,
the error bound over fixed seeds and scales in place of hypothesis's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_sharding_cases as cases  # noqa: E402
from repro.parallel import compress as jc  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import mesh as cmesh  # noqa: E402
from repro_torch.parallel import compress as tc  # noqa: E402

SHAPES = [(256,), (32, 8), (5,), (3, 7, 11)]


def _x(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 3)).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", [0, 123])
def test_quantize_bits_equal_the_reference(seed, shape):
    x = _x(seed, shape)
    q, s = jc.quantize(jnp.asarray(x), jax.random.PRNGKey(seed))
    q2, s2 = tc.quantize(torch.from_numpy(x), prng.PRNGKey(seed))
    assert q2.dtype == torch.int8
    np.testing.assert_array_equal(q2.numpy(), np.asarray(q))
    assert s2.numpy().tobytes() == np.asarray(s).tobytes()
    d = tc.dequantize(q2, s2).numpy()
    np.testing.assert_array_equal(d, np.asarray(jc.dequantize(q, s)))


def _tree(seed):
    return {"a": _x(seed, (32, 8)), "b": {"c": _x(seed + 1, (5,)), "d": _x(seed + 2, (4, 3))}}


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{pre}/{k}")
    else:
        yield pre, np.asarray(tree)


def test_compress_tree_bits_equal_the_reference():
    tree = _tree(3)
    jq, js = jc.compress_tree(jax.tree.map(jnp.asarray, tree), jax.random.PRNGKey(5))
    tt = {"a": torch.from_numpy(tree["a"]),
          "b": {k: torch.from_numpy(v) for k, v in tree["b"].items()}}
    tq, ts = tc.compress_tree(tt, prng.PRNGKey(5))
    for (n1, a), (n2, b) in zip(_flat(jq), _flat({k: v for k, v in _np_tree(tq).items()})):
        assert n1 == n2
        np.testing.assert_array_equal(b, a)
    for (n1, a), (n2, b) in zip(_flat(js), _flat(_np_tree(ts))):
        assert n1 == n2 and a.tobytes() == b.tobytes()
    jd = jc.decompress_tree(jq, js)
    td = tc.decompress_tree(tq, ts)
    for (_, a), (_, b) in zip(_flat(jd), _flat(_np_tree(td))):
        np.testing.assert_array_equal(b, a)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.mark.parametrize("scale", [1e-3, 0.37, 12.0, 1e3])
@pytest.mark.parametrize("seed", [0, 17, 2 ** 31 - 1])
def test_quantize_error_bound(seed, scale):
    """Stochastic rounding's error is within one quantization step."""
    x = prng.normal(prng.PRNGKey(seed), (256,)) * scale
    q, s = tc.quantize(x, prng.fold_in(prng.PRNGKey(seed), 1))
    err = torch.abs(tc.dequantize(q, s) - x)
    assert float(err.max()) <= float(s) * 1.0 + 1e-6


def test_quantize_unbiased():
    """E[dequantize(quantize(x))] = x under stochastic rounding."""
    x = torch.full((64,), 0.3)
    key = prng.PRNGKey(9)
    acc = torch.zeros_like(x)
    n = 300
    for i in range(n):
        q, s = tc.quantize(x, prng.fold_in(key, i))
        acc = acc + tc.dequantize(q, s)
    np.testing.assert_allclose((acc / n).numpy(), 0.3, atol=2e-3)


def test_tree_roundtrip():
    key = prng.PRNGKey(9)
    tree = {"a": prng.normal(key, (32, 8)),
            "b": {"c": prng.normal(prng.fold_in(key, 1), (5,))}}
    q, s = tc.compress_tree(tree, prng.fold_in(key, 2))
    out = tc.decompress_tree(q, s)
    for (_, a), (_, b) in zip(_flat(_np_tree(tree)), _flat(_np_tree(out))):
        assert float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-9)) < 0.02
    assert all(v.dtype == np.int8 for _, v in _flat(_np_tree(q)))


def test_compressed_pod_mean_bits_equal_the_reference():
    """Two ranks' gradients through ``compressed_pod_mean`` on the pod group
    against the reference's under ``vmap`` over the stacked gradients: the
    scales MAX-reduced, the int8 values summed in int32, the same key."""
    grads = [_tree(10), _tree(20)]
    got = cmesh.spawn(2, cases.pod_mean, grads, 4, timeout=120.0)
    stacked = jax.tree.map(lambda a, b: jnp.stack([a, b]), *grads)
    want = jax.vmap(lambda g: jc.compressed_pod_mean(g, jax.random.PRNGKey(4)),
                    axis_name="pod")(stacked)
    want = dict(_flat(jax.tree.map(np.asarray, want)))
    assert set(got) == set(want)
    for name, w in want.items():
        assert w[0].tobytes() == w[1].tobytes()
        assert got[name].tobytes() == w[0].tobytes(), name
