"""The port's island DE engine against the JAX engine, run for run.

Both packages draw the same keys, so a fixed seed gives the same trajectory
up to float32 rounding of the fitness. Bound: rtol 1e-4 on ``value`` and on
every ``history`` entry — no tighter than the reference's own gap between
its fused and unfused paths (1.36e-5, ``BENCH_kernels.json``). Evaluation
accounting must match exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.core import islands as jislands  # noqa: E402
from repro.functions import benchmarks as jbm  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import migration as tmig  # noqa: E402
from repro_torch.core.mesh import MeshConfig  # noqa: E402
from repro_torch.functions import benchmarks as tbm  # noqa: E402

RTOL = 1e-4


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


def _fns(name, dim):
    if name == "shifted_rosenbrock":
        jf = jbm.make_shifted_rosenbrock(dim)
        return jf, convert.function_from_numpy(name, np.asarray(jf.shift), jf.bias)
    return jbm.FUNCTIONS[name], tbm.FUNCTIONS[name]


def _pair(fn="rastrigin", pop=16, dim=8, islands=2, migration="ring", gens=9,
          params=None, backends=("xla", "torch"), callback=False, seed=3,
          port_only=False):
    """Run both engines on one configuration; return (jax result, port
    result, port callback log). ``port_only`` skips the JAX run."""
    jf, tf = _fns(fn, dim)
    kw = dict(n_islands=islands, pop=pop, dim=dim, sync_every=3,
              migration=migration, max_evals=islands * pop * (gens + 1))
    params = {"w": 0.5, "px": 0.3, **(params or {})}
    seen = []
    jo = jcore.IslandOptimizer(
        jcore.ALGORITHMS["de"], jcore.IslandConfig(**kw), params=params,
        exec_cfg=jcore.ExecutorConfig(backend=backends[0]),
        round_callback=(lambda r, a, b: None) if callback else None)
    to = tcore.IslandOptimizer(
        tcore.ALGORITHMS["de"], tcore.IslandConfig(**kw), params=params,
        exec_cfg=tcore.ExecutorConfig(backend=backends[1]), device="cpu",
        round_callback=(lambda r, a, b: seen.append((r, float(b.min()))))
        if callback else None)
    jr = None if port_only else jo.minimize(jf, jax.random.PRNGKey(seed))
    return jr, to.minimize(tf, prng.PRNGKey(seed)), seen


def _assert_same_run(jr, tr):
    assert tr.n_evals == jr.n_evals and tr.n_gens == jr.n_gens
    np.testing.assert_allclose(tr.value, jr.value, rtol=RTOL)
    np.testing.assert_allclose(tr.history, np.asarray(jr.history), rtol=RTOL)
    assert tr.arg.shape == np.asarray(jr.arg).shape


@pytest.mark.parametrize("case", [
    dict(),                                                   # sync, rand1bin
    dict(params={"strategy": "best1bin"}),
    dict(pop=37, params={"barrier_mode": "chunked"}),         # clamped overlap
    dict(params={"fused": True}, backends=("pallas", "cuda")),
    dict(fn="shifted_rosenbrock", params={"fused": True},
         backends=("pallas", "cuda")),
    dict(fn="shifted_rosenbrock", islands=1, migration="none",
         backends=("pallas", "cuda")),
], ids=["sync", "best1bin", "chunked37", "fused", "fused_shifted",
        "single_island_cuda_backend"])
def test_minimize_matches_jax(case):
    jr, tr, _ = _pair(**case)
    _assert_same_run(jr, tr)


def test_round_callback_driver_matches_jax_and_resident():
    jr, tr, seen = _pair(fn="sphere", callback=True)
    _assert_same_run(jr, tr)
    assert [r for r, _ in seen] == list(range(len(tr.history)))
    np.testing.assert_array_equal([v for _, v in seen], tr.history)
    _, resident, _ = _pair(fn="sphere", port_only=True)
    np.testing.assert_array_equal(resident.history, tr.history)
    assert resident.value == tr.value


def test_round_from_shared_state():
    """Both engines start one round from the same state (carried across by
    ``convert``) and the same round key, and end in the same state."""
    jf, tf = _fns("rastrigin", 8)
    cfg = dict(n_islands=2, pop=16, dim=8, sync_every=3, migration="ring")
    params = {"w": 0.5, "px": 0.3}
    jo = jcore.IslandOptimizer(jcore.ALGORITHMS["de"], jcore.IslandConfig(**cfg),
                               params=params)
    to = tcore.IslandOptimizer(tcore.ALGORITHMS["de"], tcore.IslandConfig(**cfg),
                               params=params, device="cpu")
    ja, ta = jo._build(jf), to._build(tf)
    rng = np.random.default_rng(0)
    pop = rng.uniform(-5.12, 5.12, (2, 16, 8)).astype(np.float32)
    fit = np.asarray(jax.vmap(jax.vmap(jf.fn))(jnp.asarray(pop)))
    i = fit.argmin(axis=1)
    state = {"pop": pop, "fit": fit, "best_arg": pop[np.arange(2), i],
             "best_val": fit[np.arange(2), i]}
    key = jax.random.PRNGKey(5)
    js = jo._round_fn(ja)({k: jnp.asarray(v) for k, v in state.items()}, key)
    ts = to._round_fn(ta)(convert.state_from_numpy(state, "cpu"),
                          torch.from_numpy(np.asarray(key).astype(np.int64)))
    got = convert.state_to_numpy(ts)
    for k in convert.STATE_KEYS:
        np.testing.assert_allclose(got[k], np.asarray(js[k]), rtol=RTOL, atol=1e-5)


def test_state_from_numpy_adds_island_axis():
    s = convert.state_from_numpy({"pop": np.zeros((4, 3)), "fit": np.zeros(4),
                                  "best_arg": np.zeros(3), "best_val": 0.0}, "cpu")
    assert [tuple(s[k].shape) for k in convert.STATE_KEYS] == [
        (1, 4, 3), (1, 4), (1, 3), (1,)]


def test_ring_migration_matches_jax():
    from repro.core import migration as jmig
    rng = np.random.default_rng(4)
    pop = rng.normal(size=(3, 10, 4)).astype(np.float32)
    fit = rng.integers(0, 5, (3, 10)).astype(np.float32)    # ties on purpose
    jp, jfit = jmig.ring(jnp.asarray(pop), jnp.asarray(fit), k=2)
    tp, tfit = tmig.migrate("ring", torch.from_numpy(pop), torch.from_numpy(fit), 2)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tfit.numpy(), np.asarray(jfit))
    one = tmig.ring(torch.from_numpy(pop[:1]), torch.from_numpy(fit[:1]))
    assert torch.equal(one[0], torch.from_numpy(pop[:1]))


def test_chain_split_matches_jax():
    key = jax.random.PRNGKey(9)
    want = np.asarray(jislands._chain_split(key, 5))
    got = tcore.islands._chain_split(prng.PRNGKey(9), 5)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_device_none_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the machine without one")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tcore.IslandOptimizer(tcore.ALGORITHMS["de"], tcore.IslandConfig())


def _de_opt(cfg, **kw):
    return tcore.IslandOptimizer(tcore.ALGORITHMS["de"], tcore.IslandConfig(**cfg),
                                 device="cpu", **kw)


@pytest.mark.parametrize("later,error,match", [
    # Population sharding names its mesh axes in IslandConfig.pop_axes;
    # without a mesh the reference accepts and ignores them, and so does the
    # port: the run is the plain engine's.
    (lambda: _de_opt(dict(pop_axes=("data",), max_evals=2000)), None, None),
    # Async islands and portfolios are ported: what raises is the
    # reference's validation (async starvation; an algo_maker with a
    # portfolio).
    (lambda: _de_opt(dict(sync_policy="async", n_islands=2, migration="starvation")),
     ValueError, "starvation"),
    (lambda: _de_opt(dict(portfolio=("de", "pso"), n_islands=2)),
     ValueError, "algo_maker=None"),
    # Island sharding is ported (core/mesh.py): what raises is the
    # reference's refusal of a mesh over one island.
    (lambda: _de_opt(dict(), mesh_cfg=MeshConfig(devices=2)), ValueError, "n_islands > 1"),
], ids=["pop_axes", "async", "portfolio", "mesh"])
def test_later_slice_features_raise(later, error, match):
    if error is None:
        f = tbm.FUNCTIONS["sphere"]
        want = _de_opt(dict(max_evals=2000)).minimize(f, prng.PRNGKey(1))
        got = later().minimize(f, prng.PRNGKey(1))
        assert got.value == want.value
        np.testing.assert_array_equal(got.history, want.history)
        return
    with pytest.raises(error, match=match):
        later()


def test_executor_retry_then_evict():
    calls = []

    def fn(x):
        calls.append(x.clone())
        out = torch.sum(x * x, dim=-1)
        # row 0 fails once, row 1 fails on every attempt
        if len(calls) == 1:
            out[0] = float("nan")
        out[1] = float("inf")
        return out

    f = tbm.Function("flaky", fn, -1.0, 1.0)
    ev = tcore.make_batch_evaluator(f, tcore.ExecutorConfig())
    assert ev is tcore.make_batch_evaluator(f, tcore.ExecutorConfig())
    x = torch.ones(3, 2)
    out = ev(x)
    assert len(calls) == 2                       # whole batch re-evaluated
    assert torch.equal(calls[1], x + 1e-6)
    assert torch.isfinite(out[0]) and out[1] == float("inf")
    assert out[2] == 2.0
