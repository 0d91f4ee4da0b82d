"""The port's PSO, GA and SA engines, starvation migration and migrant
adoption against the JAX package, generation by generation and run by run.

PSO draws only uniforms, which both packages give bit for bit. GA and SA
also draw normals and categorical samples, which the port computes within a
few ulps of ``jax.random`` (``tests/test_torch_prng.py``). So that their
trajectories can be held as tightly as DE's, these tests hand the port
JAX's own normals and categorical samples through ``jax_draws``: the keys
are bit-exact, and the shim turns each port key into a JAX key and calls
``jax.random``. The shim lives here, never in the package.

Bounds: rtol 1e-4 on ``value`` and every ``history`` entry, as
``tests/test_torch_de_engine.py`` holds DE — no tighter than the reference's
own gap between its fused and unfused paths (1.36e-5,
``BENCH_kernels.json``). Evaluation accounting must match exactly.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.core import migration as jmig  # noqa: E402
from repro.core import portfolio as jpf  # noqa: E402
from repro.functions import benchmarks as jbm  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import migration as tmig  # noqa: E402
from repro_torch.core import portfolio as tpf  # noqa: E402
from repro_torch.functions import benchmarks as tbm  # noqa: E402

RTOL = 1e-4


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


def _jkeys(keys):
    """Port keys ``(..., 2)`` as a flat batch of JAX keys ``(n, 2)``."""
    return jnp.asarray(keys.cpu().numpy().astype(np.uint32).reshape(-1, 2))


@functools.lru_cache(maxsize=None)
def _jax_normal_fn(shape, scale, with_loc):
    if with_loc:
        return jax.jit(jax.vmap(
            lambda k, loc: loc + scale * jax.random.normal(k, shape)))
    return jax.jit(jax.vmap(lambda k: scale * jax.random.normal(k, shape)))


@functools.lru_cache(maxsize=None)
def _jax_categorical_fn(shape):
    return jax.jit(jax.vmap(
        lambda k, logits: jax.random.categorical(k, logits, shape=shape)))


def _jax_normal(key, shape, scale=1.0, loc=None):
    """``prng.normal`` with JAX's bits: the same expression, jitted, so XLA
    folds and contracts it as the JAX engine does."""
    lead, shape = tuple(key.shape[:-1]), tuple(shape)
    ks = _jkeys(key)
    if loc is None:
        out = _jax_normal_fn(shape, float(scale), False)(ks)
    else:
        loc = np.broadcast_to(np.asarray(loc.cpu() if torch.is_tensor(loc) else loc,
                                         np.float32), lead + shape)
        out = _jax_normal_fn(shape, float(scale), True)(
            ks, jnp.asarray(loc.reshape((-1,) + shape)))
    return torch.from_numpy(np.asarray(out).reshape(lead + shape)).to(key.device)


def _jax_categorical(key, logits, shape):
    lead, shape = tuple(key.shape[:-1]), tuple(shape)
    lg = jnp.asarray(logits.cpu().numpy().reshape(-1, logits.shape[-1]))
    out = _jax_categorical_fn(shape)(_jkeys(key), lg)
    return torch.from_numpy(np.asarray(out).astype(np.int64).reshape(lead + shape))


@pytest.fixture
def jax_draws(monkeypatch):
    """Route the port's normal and categorical draws through jax.random."""
    monkeypatch.setattr(prng, "normal", _jax_normal)
    monkeypatch.setattr(prng, "categorical", _jax_categorical)


def _fns(name, dim):
    if name == "shifted_rosenbrock":
        jf = jbm.make_shifted_rosenbrock(dim)
        return jf, convert.function_from_numpy(name, np.asarray(jf.shift), jf.bias)
    return jbm.FUNCTIONS[name], tbm.FUNCTIONS[name]


def _backends(fused):
    return ("pallas", "cuda") if fused else ("xla", "torch")


# -- one generation from one state ------------------------------------------

def _state(algo, fn, P, D, seed):
    """A mid-run single-island state made with numpy, in the JAX layout."""
    rng = np.random.default_rng(seed)
    jf, _ = _fns(fn, D)
    lo, hi = max(jf.lo, -5.0), min(jf.hi, 5.0)
    pop = rng.uniform(lo, hi, (P, D)).astype(np.float32)
    fit = np.asarray(jax.vmap(jf.fn)(jnp.asarray(pop)))
    st = {"pop": pop, "fit": fit}
    if algo == "pso":
        pb = rng.uniform(lo, hi, (P, D)).astype(np.float32)
        st.update(vel=rng.uniform(-1, 1, (P, D)).astype(np.float32), pbest=pb,
                  pbest_f=np.asarray(jax.vmap(jf.fn)(jnp.asarray(pb))))
        src, srcf = pb, st["pbest_f"]
    elif algo == "ga":
        alive = rng.uniform(size=P) < 0.8
        alive[np.argmin(fit)] = True
        st.update(fit=np.where(alive, fit, np.inf).astype(np.float32),
                  age=rng.integers(0, 8, P).astype(np.float32),
                  age_limit=rng.normal(6.0, 2.0, P).astype(np.float32),
                  alive=alive)
        src, srcf = pop, st["fit"]
    else:
        st["t"] = np.float32(37.0)
        src, srcf = pop, fit
    i = int(np.argmin(srcf))
    st.update(best_arg=src[i].copy(), best_val=np.float32(srcf[i] * 0.999 + 1e-3))
    return st


GEN_CASES = [
    ("pso", {}), ("ga", {}), ("ga", {"age_mean": 6.0, "age_sd": 2.0}),
    ("sa", {"schedule": "linear"}), ("sa", {"schedule": "exponential"}),
    ("sa", {"schedule": "boltzmann"}), ("sa", {"schedule": "cauchy", "T0": 5.0}),
]


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("algo,params", GEN_CASES,
                         ids=["pso", "ga", "ga_aging", "sa_linear", "sa_exp",
                              "sa_boltzmann", "sa_cauchy"])
def test_one_generation_matches_jax(jax_draws, algo, params, fused):
    P, D, fn = 24, 20, "rastrigin"
    jf, tf = _fns(fn, D)
    params = {**params, "fused": fused}
    jb, tb = _backends(fused)
    ja = jcore.ALGORITHMS[algo](
        f=jf, evaluator=jcore.make_batch_evaluator(jf, jcore.ExecutorConfig(backend=jb)),
        pop=P, dim=D, **params)
    ta = tcore.ALGORITHMS[algo](
        f=tf, evaluator=tcore.make_batch_evaluator(tf, tcore.ExecutorConfig(backend=tb)),
        pop=P, dim=D, **params)
    st = _state(algo, fn, P, D, seed=len(algo) + 10 * fused)
    key = jax.random.PRNGKey(21)
    jstep = ja.step_override if fused else ja.gen
    tstep = ta.step_override if fused else ta.gen
    assert (ja.step_override is None) == (ta.step_override is None) == (not fused)
    js = jax.jit(jstep)({k: jnp.asarray(v) for k, v in st.items()}, key)
    ts = tstep(convert.state_from_numpy(st, "cpu"), prng.PRNGKey(21)[None])
    got = convert.state_to_numpy(ts)
    assert set(got) == set(js)
    for k, v in js.items():
        want = np.asarray(v)[None]
        assert got[k].shape == want.shape, k
        if want.dtype == bool:
            np.testing.assert_array_equal(got[k], want, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want, rtol=1e-5, atol=1e-5, err_msg=k)
    # Same decisions: every row moved (or stayed) in both.
    moved_j = np.any(np.asarray(js["pop"]) != st["pop"], axis=-1)
    moved_t = np.any(got["pop"][0] != st["pop"], axis=-1)
    np.testing.assert_array_equal(moved_t, moved_j)
    assert ta.evals_per_gen == ja.evals_per_gen and ta.init_evals == ja.init_evals


def test_pso_draws_are_bit_exact_without_the_shim():
    """PSO draws only uniforms: its positions and velocities after a
    generation equal the JAX engine's bit for bit."""
    P, D, fn = 24, 20, "sphere"
    jf, tf = _fns(fn, D)
    ja = jcore.ALGORITHMS["pso"](f=jf, evaluator=jf.fn, pop=P, dim=D)
    ta = tcore.ALGORITHMS["pso"](f=tf, evaluator=tf.fn, pop=P, dim=D)
    st = _state("pso", fn, P, D, seed=3)
    js = jax.jit(ja.gen)({k: jnp.asarray(v) for k, v in st.items()},
                         jax.random.PRNGKey(4))
    ts = ta.gen(convert.state_from_numpy(st, "cpu"), prng.PRNGKey(4)[None])
    for k in ("pop", "vel"):
        np.testing.assert_array_equal(ts[k][0].numpy(), np.asarray(js[k]), err_msg=k)


@pytest.mark.parametrize("algo", ["pso", "ga", "sa"])
def test_init_matches_jax(jax_draws, algo):
    jf, tf = _fns("rastrigin", 16)
    params = {"age_mean": 6.0, "age_sd": 2.0} if algo == "ga" else {}
    js = jcore.ALGORITHMS[algo](f=jf, evaluator=jf.fn, pop=20, dim=16,
                                **params).init(jax.random.PRNGKey(8))
    ts = tcore.ALGORITHMS[algo](f=tf, evaluator=tf.fn, pop=20, dim=16,
                                **params).init(prng.PRNGKey(8)[None])
    got = convert.state_to_numpy(ts)
    assert set(got) == set(js)
    for k, v in js.items():
        np.testing.assert_allclose(got[k][0], np.asarray(v), rtol=1e-6, err_msg=k)
    np.testing.assert_array_equal(got["pop"][0], np.asarray(js["pop"]))


# -- whole runs -----------------------------------------------------------------

def _pair(algo, fn="rastrigin", pop=16, dim=8, islands=2, migration="ring",
          gens=9, params=None, fused=False, seed=3):
    jf, tf = _fns(fn, dim)
    params = {**(params or {}), "fused": fused}
    jb, tb = _backends(fused)
    jo = jcore.IslandOptimizer(jcore.ALGORITHMS[algo], jcore.IslandConfig(
        n_islands=islands, pop=pop, dim=dim, sync_every=3, migration=migration,
        max_evals=islands * pop * (gens + 1)), params=params,
        exec_cfg=jcore.ExecutorConfig(backend=jb))
    to = tcore.IslandOptimizer(tcore.ALGORITHMS[algo], tcore.IslandConfig(
        n_islands=islands, pop=pop, dim=dim, sync_every=3, migration=migration,
        max_evals=islands * pop * (gens + 1)), params=params,
        exec_cfg=tcore.ExecutorConfig(backend=tb), device="cpu")
    return (jo.minimize(jf, jax.random.PRNGKey(seed)),
            to.minimize(tf, prng.PRNGKey(seed)))


def _assert_same_run(jr, tr):
    assert tr.n_evals == jr.n_evals and tr.n_gens == jr.n_gens
    np.testing.assert_allclose(tr.value, jr.value, rtol=RTOL)
    np.testing.assert_allclose(tr.history, np.asarray(jr.history), rtol=RTOL)
    assert tr.arg.shape == np.asarray(jr.arg).shape


@pytest.mark.parametrize("islands,fused", [(2, False), (4, True)],
                         ids=["2-unfused", "4-fused"])
def test_pso_ring_matches_jax(islands, fused):
    """Bit-exact draws, no shim; ring migration and PSO adoption."""
    jr, tr = _pair("pso", islands=islands, fused=fused, gens=15,
                   params={"w": 0.6})
    _assert_same_run(jr, tr)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_ga_aging_starvation_matches_jax(jax_draws, fused):
    """32 dimensions and pm 0.3 make a child that copies its parent exactly
    (no crossover, no mutated allele) all but impossible. Such a copy ties
    with its parent, and the reference's XLA evaluator rounds one row to
    different last bits at different positions in a batch, so the elite
    between the two would be chosen by that rounding alone."""
    jr, tr = _pair("ga", islands=4, pop=20, dim=32, migration="starvation",
                   gens=30, fused=fused,
                   params={"pm": 0.3, "age_mean": 6.0, "age_sd": 2.0})
    _assert_same_run(jr, tr)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_ga_starvation_adopts_migrants_matches_jax(jax_draws, fused, monkeypatch):
    """A steady-state DGA (one offspring per island and generation, short,
    widely spread lives) keeps a few live members per island, whose counts
    differ by the ratio that makes a host starve; at the default pop / 4
    offspring they never do. So here starvation must move migrants into a
    host, and GA's adoption must revive them, in at least one round."""
    adopted = []
    adopt = tpf.adopt_native

    def counting(name, state, mask):
        adopted.append(int(mask.sum()))
        return adopt(name, state, mask)

    monkeypatch.setattr(tpf, "adopt_native", counting)
    jr, tr = _pair("ga", islands=4, pop=20, dim=32, migration="starvation",
                   gens=3, fused=fused,
                   params={"pm": 0.3, "n_offspring": 1, "age_mean": 2.0,
                           "age_sd": 6.0})
    _assert_same_run(jr, tr)
    assert tr.n_gens == 60 and len(adopted) == 20
    assert any(adopted), "no starving host adopted migrants"


def test_ga_ring_shifted_matches_jax(jax_draws):
    jr, tr = _pair("ga", fn="shifted_rosenbrock", dim=32, islands=2, gens=12,
                   fused=True, params={"pm": 0.3})
    _assert_same_run(jr, tr)


@pytest.mark.parametrize("schedule,fused", [
    ("linear", False), ("linear", True), ("exponential", True),
    ("boltzmann", False), ("cauchy", True)])
def test_sa_schedules_match_jax(jax_draws, schedule, fused):
    jr, tr = _pair("sa", islands=2, gens=9, fused=fused,
                   params={"schedule": schedule, "T0": 10.0, "n_gens_hint": 12})
    _assert_same_run(jr, tr)


@pytest.mark.parametrize("algo", ["pso", "ga", "sa"])
def test_single_island_shifted_rosenbrock_matches_jax(jax_draws, algo):
    jr, tr = _pair(algo, fn="shifted_rosenbrock", dim=12, islands=1,
                   migration="none", gens=9, fused=True)
    _assert_same_run(jr, tr)


def test_ga_budget_accounting():
    """GA charges n_off evaluations per generation and stays in budget."""
    jf, tf = _fns("sphere", 6)
    for budget in (530,):
        cfg = dict(n_islands=2, pop=20, dim=6, sync_every=5, max_evals=budget,
                   migration="starvation")
        jr = jcore.IslandOptimizer(jcore.ALGORITHMS["ga"], jcore.IslandConfig(**cfg)
                                   ).minimize(jf, jax.random.PRNGKey(1))
        to = tcore.IslandOptimizer(tcore.ALGORITHMS["ga"], tcore.IslandConfig(**cfg),
                                   device="cpu")
        tr = to.minimize(tf, prng.PRNGKey(1))
        algo = to._build(tf)
        assert algo.evals_per_gen == 20 // 4
        assert tr.n_evals == jr.n_evals <= budget
        assert tr.n_evals == 2 * 20 + (tr.n_gens // 5) * 5 * 2 * 5


# -- starvation and adoption ------------------------------------------------------

def _starvation_pair(pop, fit, k=2, alive=None):
    jp, jf = jmig.starvation(jnp.asarray(pop), jnp.asarray(fit), k=k,
                             alive=None if alive is None else jnp.asarray(alive))
    tp, tf = tmig.migrate("starvation", torch.from_numpy(pop), torch.from_numpy(fit),
                          k, alive=None if alive is None else torch.from_numpy(alive))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    return tp.numpy(), tf.numpy()


def test_starvation_matches_jax_host_picks():
    """The host picks of ``tests/test_metaheuristics.py``: the emptiest
    island hosts, donors are untouched, at most 2 leave a donor."""
    I, P, D = 3, 6, 2
    pop = np.zeros((I, P, D), np.float32)
    fit = np.full((I, P), 10.0, np.float32)
    alive = np.ones((I, P), bool)
    fit[1, 1:], alive[1, 1:] = np.inf, False
    fit[2, 4:], alive[2, 4:] = np.inf, False
    fit[0, 0], pop[0, 0] = 1.0, 5.0
    _, nf = _starvation_pair(pop, fit, alive=alive)
    assert nf[1].min() == 1.0
    assert np.array_equal(nf[0], fit[0]) and np.array_equal(nf[2], fit[2])
    # A host with zero live members, k clamped to the paper's 2.
    fit = np.stack([np.arange(8, dtype=np.float32),
                    np.arange(8, dtype=np.float32) + 10.0,
                    np.full(8, np.inf, np.float32)])
    _, nf = _starvation_pair(np.zeros((3, 8, 2), np.float32), fit, k=5)
    assert (nf[2] < 10.0).sum() == 2 and nf[2].min() == 0.0


@pytest.mark.parametrize("seed", range(6))
def test_starvation_matches_jax_random(seed):
    """Random populations with +inf dead slots and tied counts; with and
    without an explicit alive mask; no host starving on some seeds."""
    rng = np.random.default_rng(seed)
    I, P, D = 4, 10, 3
    pop = rng.normal(size=(I, P, D)).astype(np.float32)
    fit = rng.integers(0, 6, (I, P)).astype(np.float32)     # ties on purpose
    alive = rng.uniform(size=(I, P)) < rng.uniform(0.1, 1.0, (I, 1))
    fit = np.where(alive, fit, np.inf).astype(np.float32)
    _starvation_pair(pop, fit, alive=alive)
    _starvation_pair(pop, fit)
    _starvation_pair(pop[:1], fit[:1])


@pytest.mark.parametrize("algo", ["ga", "pso", "sa", "de"])
def test_adopt_native_after_ring_matches_jax(algo):
    rng = np.random.default_rng(5)
    I, P, D = 3, 8, 4
    st = {"pop": rng.normal(size=(I, P, D)).astype(np.float32),
          "fit": rng.uniform(0, 10, (I, P)).astype(np.float32)}
    if algo == "ga":
        st.update(age=rng.integers(1, 9, (I, P)).astype(np.float32),
                  age_limit=rng.uniform(3, 9, (I, P)).astype(np.float32),
                  alive=rng.uniform(size=(I, P)) < 0.7)
    elif algo == "pso":
        st.update(vel=rng.normal(size=(I, P, D)).astype(np.float32),
                  pbest=rng.normal(size=(I, P, D)).astype(np.float32),
                  pbest_f=rng.uniform(0, 10, (I, P)).astype(np.float32))
    elif algo == "sa":
        st["t"] = np.full(I, 4.0, np.float32)
    jp, jfit = jmig.ring(jnp.asarray(st["pop"]), jnp.asarray(st["fit"]), k=2)
    adopted = np.any(np.asarray(jp) != st["pop"], -1) | (np.asarray(jfit) != st["fit"])
    assert adopted.any()
    jst = {**{k: jnp.asarray(v) for k, v in st.items()}, "pop": jp, "fit": jfit}
    want = jax.vmap(functools.partial(jpf.adopt_native, algo))(jst, jnp.asarray(adopted))
    tst = convert.state_from_numpy({**st, "pop": np.asarray(jp),
                                    "fit": np.asarray(jfit)}, "cpu")
    got = tpf.adopt_native(algo, tst, torch.from_numpy(adopted))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    assert tpf.has_adopt_state(algo) == jpf.has_adopt_state(algo)


def test_policy_slot_table_matches_jax():
    for name, spec in tpf.REGISTRY.items():
        js = jpf.REGISTRY[name]
        assert (spec.algo_id, spec.needs_alive) == (js.algo_id, js.needs_alive)
        assert [(s.name, s.kind, s.adopt) for s in spec.slots] == [
            (s.name, s.kind, s.adopt) for s in js.slots]
    assert sorted(tcore.ALGORITHMS) == sorted(jcore.ALGORITHMS)


def test_state_from_numpy_carries_policy_state():
    s = convert.state_from_numpy({"pop": np.zeros((4, 3)), "fit": np.zeros(4),
                                  "alive": np.ones(4), "t": 2.0,
                                  "vel": np.zeros((4, 3))}, "cpu")
    assert s["alive"].dtype == torch.bool and tuple(s["alive"].shape) == (1, 4)
    assert tuple(s["t"].shape) == (1,) and tuple(s["vel"].shape) == (1, 4, 3)
    with pytest.raises(ValueError, match="unknown state key"):
        convert.state_from_numpy({"mystery": np.zeros(3)}, "cpu")
