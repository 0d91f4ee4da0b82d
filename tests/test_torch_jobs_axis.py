"""The port's jobs axis against the JAX package and against itself:
``minimize_many``, ``BucketStepper``, warm starts and
``explore_then_polish_many``.

Against the reference, a bucket of jobs on the ``torch`` backend is held to
JAX's ``minimize_many`` on ``xla`` within the engine bound of the parity
contract: rtol 1e-4 on every value and history entry, never tighter than the
reference's own fused/unfused gap (1.36e-5 relative, ``ROADMAP.md``). GA and
SA take JAX's normals and categorical samples through the ``jax_draws`` shim
of ``tests/test_torch_engines.py``. Accounting must match exactly.

Within the port, a job's result must not depend on its bucket: each job of a
bucket is bit-identical to a standalone ``minimize`` with its key, whatever
its bucket-mates are.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_engines import _fns, _partitionable, jax_draws  # noqa: E402,F401
from test_torch_polish import _shared_fns  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.optim import descent as tdesc  # noqa: E402

RTOL = 1e-4
SEEDS = (3, 11)
POLISH = dict(polish="asd", polish_every=2, polish_topk=2, polish_steps=2)


def _cfg(pkg, islands=3, migration="ring", pop=16, dim=8, gens=12, **kw):
    return pkg.IslandConfig(n_islands=islands, pop=pop, dim=dim, sync_every=3,
                            migration=migration if islands > 1 else "none",
                            max_evals=islands * pop * (gens + 1), **kw)


def _opts(algo, params=None, **kw):
    jo = jcore.IslandOptimizer(jcore.ALGORITHMS[algo], _cfg(jcore, **kw),
                               params=params)
    to = tcore.IslandOptimizer(tcore.ALGORITHMS[algo], _cfg(tcore, **kw),
                               params=params, device="cpu")
    return jo, to


def _jkeys(seeds=SEEDS):
    return jnp.stack([jax.random.PRNGKey(s) for s in seeds])


def _tkeys(seeds=SEEDS):
    return torch.stack([prng.PRNGKey(s) for s in seeds])


def _assert_close(tr, jr):
    assert tr.n_evals == jr.n_evals and tr.n_gens == jr.n_gens
    np.testing.assert_allclose(tr.value, jr.value, rtol=RTOL)
    np.testing.assert_allclose(tr.history, np.asarray(jr.history), rtol=RTOL)
    assert tr.arg.shape == np.asarray(jr.arg).shape


def _assert_same(a, b):
    assert a.value == b.value and a.n_evals == b.n_evals and a.n_gens == b.n_gens
    np.testing.assert_array_equal(a.arg, b.arg)
    np.testing.assert_array_equal(a.history, b.history)


# -- against the reference ----------------------------------------------------------

@pytest.mark.parametrize("algo,islands,migration,params", [
    ("de", 1, "none", {"w": 0.5, "px": 0.3}),
    ("de", 3, "ring", {}),
    ("pso", 3, "ring", {}),
    ("ga", 3, "starvation", {"pm": 0.3, "n_offspring": 1, "age_mean": 2.0,
                             "age_sd": 6.0}),
    ("sa", 3, "ring", {"T0": 10.0}),
], ids=["de-1", "de-3-ring", "pso-3-ring", "ga-3-starvation", "sa-3-ring"])
def test_minimize_many_matches_jax(jax_draws, algo, islands, migration, params):
    """Two jobs of different seeds in one bucket, in both packages. GA's
    steady state at 32 dimensions makes its islands starve (and adopt)."""
    dim = 32 if algo == "ga" else 8
    jf, tf = _fns("rastrigin", dim)
    jo, to = _opts(algo, params, islands=islands, migration=migration, dim=dim)
    for jr, tr in zip(jo.minimize_many(jf, _jkeys()), to.minimize_many(tf, _tkeys())):
        _assert_close(tr, jr)


def test_warm_start_matches_jax(jax_draws):
    """``minimize(warm=)`` on 1 and 3 islands, with PSO's and GA's adoption
    of the immigrants; the best warm row is never lost. GA runs at 32
    dimensions, where a child never copies its parent exactly (see
    ``tests/test_torch_engines.py``)."""
    rng = np.random.default_rng(0)
    for algo, islands, params, dim in (("pso", 1, {}, 8), ("ga", 3, {"pm": 0.3}, 32)):
        jf, tf = _fns("rastrigin", dim)
        warm = rng.uniform(-0.3, 0.3, (3, dim)).astype(np.float32)
        best_warm = float(np.min(np.asarray(jax.vmap(jf.fn)(jnp.asarray(warm)))))
        jo, to = _opts(algo, params, islands=islands, gens=6, dim=dim)
        jr = jo.minimize(jf, jax.random.PRNGKey(5), warm=warm)
        tr = to.minimize(tf, prng.PRNGKey(5), warm=warm)
        _assert_close(tr, jr)
        assert tr.value <= best_warm * (1 + RTOL)


def test_explore_then_polish_many_matches_jax(monkeypatch):
    """The jobs-axis pipeline on the shared objective shim of
    ``tests/test_torch_polish.py``: the same accounting. Stage 1 agrees
    within the engine bound; stage 2's six descent steps part as the
    polish does when only the reduction order of its norms changes (a
    one-ulp move is amplified by the next Richardson probes), so the
    final values are held to the bound the reference holds its own polish
    to in that case, rtol 1e-3 (``tests/test_torch_polish.py``,
    ``test_make_polish_matches_reference``)."""
    jf, tf = _shared_fns("levy", 6, monkeypatch)
    pcfg = dict(steps=6)
    jo, to = _opts("de", islands=2, dim=6)
    jres = jcore.explore_then_polish_many(jo, jf, _jkeys(), jcore.pipeline.descent
                                          .PolishConfig(**pcfg))
    tres = tcore.explore_then_polish_many(to, tf, _tkeys(), tdesc.PolishConfig(**pcfg))
    stage1 = to.minimize_many(tf, _tkeys())
    for jr, tr, t1 in zip(jres, tres, stage1):
        assert tr.n_evals == jr.n_evals and tr.n_gens == jr.n_gens
        np.testing.assert_allclose(t1.history, np.asarray(jr.history), rtol=RTOL)
        np.testing.assert_allclose(tr.value, jr.value, rtol=1e-3)


@pytest.mark.parametrize("polish", [False, True], ids=["plain", "hybrid"])
def test_accounting_matches_jax(polish):
    """The rounds and ``evals_done`` after every round, as the reference's
    stepper counts, and a bucket's ``n_evals`` and ``n_gens`` by the same
    rule (``test_minimize_many_matches_jax`` holds them to the
    reference's results)."""
    jf, tf = _fns("sphere", 6)
    kw = dict(islands=2, dim=6, gens=40, **(POLISH if polish else {}))
    jo, to = _opts("de", **kw)
    jst, tst = jo.bucket_stepper(jf), to.bucket_stepper(tf)
    assert (tst.n_rounds, tst.per_round, tst.per_polish, tst.init_evals) == (
        jst.n_rounds, jst.per_round, jst.per_polish, jst.init_evals)
    assert [tst.evals_done(r) for r in range(tst.n_rounds + 1)] == [
        jst.evals_done(r) for r in range(jst.n_rounds + 1)]
    tr = to.minimize_many(tf, _tkeys((1,)))[0]
    assert tr.n_gens == tst.n_rounds * 3 == jst.n_rounds * 3
    assert tr.n_evals == tst.evals_done(tst.n_rounds) <= kw["islands"] * 16 * 41


@pytest.mark.parametrize("algo,islands", [("de", 3), ("pso", 1)])
def test_stepper_from_jax_state_matches_jax(algo, islands):
    """Both steppers from JAX's job-stacked init state, carried across by
    ``convert.state_from_numpy``: after two rounds every state leaf agrees
    within the engine bound, and the state carried back has JAX's layout."""
    jf, tf = _fns("rastrigin", 8)
    jo, to = _opts(algo, islands=islands)
    jst, tst = jo.bucket_stepper(jf), to.bucket_stepper(tf)
    jstate, jrk = jst.init(_jkeys())
    tstate = convert.state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    trk = tst.round_keys(_tkeys())
    np.testing.assert_array_equal(trk.numpy(), np.asarray(jrk).astype(np.int64))
    for r in range(2):
        jstate, jv = jst.step(jstate, jrk, r)
        tstate, tv = tst.step(tstate, trk, r)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL)
    back = convert.state_to_jax(tstate, islands, jobs=True)
    for k, v in jstate.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_allclose(back[k], np.asarray(v), rtol=RTOL, atol=1e-5,
                                   err_msg=k)


def test_convert_round_trip():
    rng = np.random.default_rng(1)
    for islands, jobs, lead in ((1, False, ()), (3, False, (3,)), (1, True, (2,)),
                                (3, True, (2, 3))):
        d = {"pop": rng.normal(size=(*lead, 5, 4)), "fit": rng.normal(size=(*lead, 5)),
             "best_arg": rng.normal(size=(*lead, 4)), "best_val": rng.normal(size=lead),
             "alive": rng.random((*lead, 5)) < 0.5}
        s = convert.state_from_numpy(d, "cpu")
        n = int(np.prod(lead)) if lead else 1
        assert tuple(s["pop"].shape) == (n, 5, 4) and s["alive"].dtype == torch.bool
        back = convert.state_to_jax(s, islands, jobs=jobs)
        for k, v in d.items():
            np.testing.assert_array_equal(back[k], np.asarray(v, back[k].dtype), err_msg=k)
    with pytest.raises(ValueError, match="shape"):
        convert.state_from_numpy({"pop": np.zeros(4)}, "cpu")
    with pytest.raises(ValueError, match="islands"):
        convert.state_to_jax(s, 1)


# -- within the port, bit for bit ------------------------------------------------------

@pytest.mark.parametrize("algo", list(tcore.ALGORITHMS))
def test_each_job_equals_standalone_minimize(algo):
    """Two jobs of different seeds in one bucket of 3 ring islands: each is
    bit-identical to ``minimize`` alone (nothing leaks through the fold)."""
    _, tf = _fns("rastrigin", 8)
    params = {"fused": True} if algo in ("de", "pso", "ga", "sa") else {}
    to = tcore.IslandOptimizer(tcore.ALGORITHMS[algo], _cfg(tcore, gens=6),
                               params=params, device="cpu")
    for s, r in zip(SEEDS, to.minimize_many(tf, _tkeys())):
        _assert_same(r, to.minimize(tf, prng.PRNGKey(s)))


@pytest.mark.parametrize("algo,migration,params", [
    ("de", "ring", {}),
    ("ga", "starvation", {"n_offspring": 1, "age_mean": 2.0, "age_sd": 6.0}),
], ids=["de-ring", "ga-starvation"])
def test_a_job_ignores_its_bucket_mates(algo, migration, params):
    """A job's result is the same next to any bucket-mate, share_incumbent
    included (the incumbent is shared within a job only). The steady-state
    GA's islands starve, so starvation moves migrants."""
    _, tf = _fns("rastrigin", 8)
    to = tcore.IslandOptimizer(tcore.ALGORITHMS[algo], _cfg(
        tcore, migration=migration, share_incumbent=True, gens=6),
        params=params, device="cpu")
    a = to.minimize_many(tf, _tkeys((4, 5)))[0]
    b = to.minimize_many(tf, _tkeys((4, 6, 7)))[0]
    _assert_same(a, b)
    _assert_same(a, to.minimize(tf, prng.PRNGKey(4)))


def test_stepper_with_polish_matches_minimize_many_and_minimize():
    """Driven a round at a time, with a polish cadence, the stepper gives
    ``minimize_many``'s results, and each job equals its ``minimize``."""
    _, tf = _fns("levy", 6)
    to = tcore.IslandOptimizer(tcore.ALGORITHMS["de"], _cfg(
        tcore, islands=2, dim=6, gens=20, **POLISH), device="cpu")
    st = to.bucket_stepper(tf)
    assert st is to.bucket_stepper(tf) and st.has_polish
    state, rks = st.init(_tkeys())
    hist = []
    for r in range(st.n_rounds):
        state, vals = st.step(state, rks, r)
        hist.append(vals.numpy())
    args, vals = st.best(state)
    many = to.minimize_many(tf, _tkeys())
    for j, s in enumerate(SEEDS):
        assert float(vals[j]) == many[j].value
        np.testing.assert_array_equal(args[j].numpy(), many[j].arg)
        np.testing.assert_array_equal(np.stack(hist, 1)[j], many[j].history)
        _assert_same(many[j], to.minimize(tf, prng.PRNGKey(s)))


def test_stepper_inject_equals_minimize_warm():
    """A bucket's warm injection, then its rounds, equals each job's
    ``minimize(warm=)``; the stepper's meta template has the state's
    shapes and dtypes."""
    _, tf = _fns("rastrigin", 8)
    to = tcore.IslandOptimizer(tcore.ALGORITHMS["pso"], _cfg(tcore, gens=6),
                               device="cpu")
    warm = np.full((2, 8), 0.01, np.float32)
    st = to.bucket_stepper(tf)
    state, rks = st.init(_tkeys())
    meta = st.state_shape(_tkeys())
    assert {k: (v.shape, v.dtype) for k, v in meta.items()} == {
        k: (v.shape, v.dtype) for k, v in state.items()}
    assert all(v.device.type == "meta" for v in meta.values())
    state = st.inject(state, warm)
    for r in range(st.n_rounds):
        state, _ = st.step(state, rks, r)
    args, vals = st.best(state)
    for j, s in enumerate(SEEDS):
        one = to.minimize(tf, prng.PRNGKey(s), warm=warm)
        assert float(vals[j]) == one.value
        np.testing.assert_array_equal(args[j].numpy(), one.arg)


def test_explore_then_polish_many_accounts_per_job():
    _, tf = _fns("rosenbrock", 6)
    to = tcore.IslandOptimizer(tcore.ALGORITHMS["de"], _cfg(tcore, islands=2, dim=6),
                               device="cpu")
    pcfg = tdesc.PolishConfig(steps=4)
    base = to.minimize_many(tf, _tkeys())
    res = tcore.explore_then_polish_many(to, tf, _tkeys(), pcfg)
    for s, b, r in zip(SEEDS, base, res):
        assert r.value <= b.value and r.n_gens == b.n_gens and r.arg.shape == (6,)
        assert r.n_evals == b.n_evals + tdesc.polish_evals_per_point(6, pcfg)
        _assert_same(r, tcore.explore_then_polish(to, tf, prng.PRNGKey(s), pcfg))


def test_minimize_many_rejects_round_callback():
    _, tf = _fns("sphere", 4)
    to = tcore.IslandOptimizer(tcore.ALGORITHMS["de"], _cfg(tcore, dim=4),
                               round_callback=lambda *a: None, device="cpu")
    with pytest.raises(ValueError, match="round_callback"):
        to.minimize_many(tf, _tkeys())
