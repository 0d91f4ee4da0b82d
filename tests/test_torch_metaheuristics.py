"""The port's EA, FA, BH and MC engines against the JAX package: one
generation from one numpy state, whole runs of 1 and 4 islands, evaluation
accounting for all eight policies, migrant adoption and the policy table.

MC and FA draw only uniforms, which both packages give bit for bit. EA and
BH also draw normals, which the port computes within a few ulps of
``jax.random``; their tests take JAX's own normals through the ``jax_draws``
shim of ``tests/test_torch_engines.py``, so trajectories can be held as
tightly as DE's.

Bounds: one generation within rtol 1e-5 (atol 1e-5) on every state entry,
with the same rows moved; whole runs within rtol 1e-4 on ``value`` and every
``history`` entry, as ``tests/test_torch_engines.py`` holds PSO/GA/SA — no
tighter than the reference's own gap between its fused and unfused paths
(1.36e-5 relative, ``ROADMAP.md``). Evaluation accounting must match exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_engines import _fns, _partitionable, jax_draws  # noqa: E402,F401

from repro import core as jcore  # noqa: E402
from repro.core import migration as jmig  # noqa: E402
from repro.core import portfolio as jpf  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import ea as tea  # noqa: E402
from repro_torch.core import migration as tmig  # noqa: E402
from repro_torch.core import portfolio as tpf  # noqa: E402

RTOL = 1e-4
NEW = ("ea", "fa", "bh", "mc")
# Policies that draw normals take JAX's through the shim.
NORMALS = {"ea", "bh"}


@pytest.fixture
def draws(request):
    """The shim for the policies that draw normals, nothing for the rest."""
    if request.getfixturevalue("algo") in NORMALS:
        request.getfixturevalue("jax_draws")


def test_algorithms_table_matches_reference():
    assert set(tcore.ALGORITHMS) == set(jcore.ALGORITHMS)
    assert list(tcore.ALGORITHMS) == list(jcore.ALGORITHMS)
    for name, spec in jpf.REGISTRY.items():
        mine = tpf.REGISTRY[name]
        assert mine.algo_id == spec.algo_id and mine.needs_alive == spec.needs_alive
        assert [(s.name, s.kind, s.adopt) for s in mine.slots] == \
            [(s.name, s.kind, s.adopt) for s in spec.slots]
        assert tpf.has_adopt_state(name) == jpf.has_adopt_state(name)


# -- one generation from one state ------------------------------------------------

def _state(algo, fn, P, D, seed):
    """A mid-run single-island state made with numpy, in the JAX layout."""
    rng = np.random.default_rng(seed)
    jf, _ = _fns(fn, D)
    lo, hi = max(jf.lo, -5.0), min(jf.hi, 5.0)
    pop = rng.uniform(lo, hi, (P, D)).astype(np.float32)
    fit = np.asarray(jax.vmap(jf.fn)(jnp.asarray(pop)))
    st = {"pop": pop, "fit": fit}
    if algo == "ea":
        st["sigma"] = np.float32(0.3 * (hi - lo))
    elif algo == "fa":
        st["alpha"] = np.float32(0.7)
    i = int(np.argmin(fit))
    st.update(best_arg=pop[i].copy(), best_val=np.float32(fit[i] * 0.999 + 1e-3))
    return st


def _one_gen(algo, fn, P, D, seed, params=None):
    jf, tf = _fns(fn, D)
    params = params or {}
    ja = jcore.ALGORITHMS[algo](f=jf, evaluator=jax.vmap(jf.fn), pop=P, dim=D, **params)
    ta = tcore.ALGORITHMS[algo](f=tf, evaluator=tf.fn, pop=P, dim=D, **params)
    st = _state(algo, fn, P, D, seed)
    js = jax.jit(ja.gen)({k: jnp.asarray(v) for k, v in st.items()},
                         jax.random.PRNGKey(seed))
    ts = ta.gen(convert.state_from_numpy(st, "cpu"), prng.PRNGKey(seed)[None])
    got = convert.state_to_numpy(ts)
    assert set(got) == set(js)
    for k, v in js.items():
        np.testing.assert_allclose(got[k], np.asarray(v)[None], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    moved_j = np.any(np.asarray(js["pop"]) != st["pop"], axis=-1)
    moved_t = np.any(got["pop"][0] != st["pop"], axis=-1)
    np.testing.assert_array_equal(moved_t, moved_j)
    assert (ta.evals_per_gen, ta.init_evals) == (ja.evals_per_gen, ja.init_evals)
    return st, got, js


GEN_CASES = [("ea", {}), ("ea", {"lam": 9}), ("fa", {}), ("fa", {"gamma": 0.5}),
             ("bh", {}), ("bh", {"n_ls": 3, "T": 3.0}), ("mc", {})]


@pytest.mark.parametrize("algo,params", GEN_CASES,
                         ids=["ea", "ea_lam9", "fa", "fa_gamma0.5", "bh", "bh_T3", "mc"])
def test_one_generation_matches_jax(draws, algo, params):
    _one_gen(algo, "rastrigin", 24, 20, seed=len(algo) + len(params), params=params)


def test_fa_chunked_pairs_equal_one_chunk(monkeypatch):
    """The chunked pairwise pass gives what one chunk of all rows gives."""
    _, tf = _fns("rastrigin", 6)
    st = convert.state_from_numpy(_state("fa", "rastrigin", 13, 6, 4), "cpu")
    fa = tcore.fa
    whole = fa.attraction(st["pop"], st["fit"], 1.0, 0.5)
    monkeypatch.setattr(fa, "CHUNK_ELEMS", 3 * 13 * 6)      # chunks of 3, 3, ..., 1
    np.testing.assert_array_equal(fa.attraction(st["pop"], st["fit"], 1.0, 0.5).numpy(),
                                  whole.numpy())
    assert float(whole.abs().max()) > 0.0


def test_ea_median_is_jnp_median():
    """jnp.median of an even-length vector is the mean of its two middle
    values (torch.median would give the lower one); NaN anywhere gives NaN."""
    rng = np.random.default_rng(0)
    cases = [rng.standard_normal(n).astype(np.float32) for n in (1, 2, 7, 8, 64)]
    cases += [np.array([3.0, 1.0, np.inf, 2.0], np.float32),
              np.array([1.0, np.inf, np.inf, 2.0], np.float32),
              np.array([1.0, np.nan, 0.0, 2.0, 5.0], np.float32),
              np.array([3e38, 3e38, 1.0], np.float32)]
    for a in cases:
        want = np.asarray(jnp.median(jnp.asarray(a)))
        got = tea.median(torch.from_numpy(a)[None])[0].numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(a))
    a = torch.tensor([[4.0, 1.0, 2.0, 3.0]])
    assert float(tea.median(a)[0]) == 2.5 != float(torch.median(a))


def test_ea_even_pop_generation_matches_jax(jax_draws):
    """An even pop whose selected fitness has two different middle values:
    the success count, and so sigma, follow jnp.median's mean of the two."""
    st, got, js = _one_gen("ea", "rastrigin", 16, 10, seed=5)
    s = np.sort(got["fit"][0])
    assert s[7] != s[8]
    np.testing.assert_array_equal(got["sigma"][0], np.asarray(js["sigma"]))


def test_bh_probe_steps_are_float32_powers():
    """step0 * ls_shrink ** c as the reference computes it inside fori_loop:
    a float32 power of the traced probe counter."""
    step0, shrink = 0.05 * 10.24, 0.6
    want = jax.jit(lambda c: step0 * (shrink ** c))
    from repro_torch import f32
    for c in range(8):
        got = np.float32(f32.const(step0) * f32.pow(shrink, torch.tensor(float(c))))
        assert got == np.float32(want(jnp.int32(c))), c


@pytest.mark.parametrize("algo", NEW)
def test_init_matches_jax(algo):
    jf, tf = _fns("rastrigin", 16)
    js = jcore.ALGORITHMS[algo](f=jf, evaluator=jax.vmap(jf.fn), pop=20,
                                dim=16).init(jax.random.PRNGKey(8))
    ts = tcore.ALGORITHMS[algo](f=tf, evaluator=tf.fn, pop=20,
                                dim=16).init(prng.PRNGKey(8)[None])
    got = convert.state_to_numpy(ts)
    assert set(got) == set(js)
    np.testing.assert_array_equal(got["pop"][0], np.asarray(js["pop"]))
    for k, v in js.items():
        np.testing.assert_allclose(got[k][0], np.asarray(v), rtol=1e-6, err_msg=k)


# -- whole runs -----------------------------------------------------------------

def _pair(algo, islands, fn="rastrigin", pop=16, dim=8, gens=12, seed=3,
          migration="ring", params=None):
    jf, tf = _fns(fn, dim)
    params = params or {}
    cfg = dict(n_islands=islands, pop=pop, dim=dim, sync_every=3,
               migration=migration if islands > 1 else "none")
    ja = jcore.ALGORITHMS[algo](f=jf, evaluator=jf.fn, pop=pop, dim=dim, **params)
    cfg["max_evals"] = islands * (ja.init_evals + ja.evals_per_gen * gens)
    jo = jcore.IslandOptimizer(jcore.ALGORITHMS[algo], jcore.IslandConfig(**cfg),
                               params=params)
    to = tcore.IslandOptimizer(tcore.ALGORITHMS[algo], tcore.IslandConfig(**cfg),
                               params=params, device="cpu")
    return jo.minimize(jf, jax.random.PRNGKey(seed)), to.minimize(tf, prng.PRNGKey(seed))


def _assert_same_run(jr, tr, gens):
    assert tr.n_evals == jr.n_evals and tr.n_gens == jr.n_gens == gens
    np.testing.assert_allclose(tr.value, jr.value, rtol=RTOL)
    np.testing.assert_allclose(tr.history, np.asarray(jr.history), rtol=RTOL)
    assert tr.arg.shape == np.asarray(jr.arg).shape


@pytest.mark.parametrize("islands", [1, 4])
@pytest.mark.parametrize("algo", NEW)
def test_run_matches_jax(draws, algo, islands):
    jr, tr = _pair(algo, islands)
    _assert_same_run(jr, tr, 12)


@pytest.mark.parametrize("algo", NEW)
def test_shifted_rosenbrock_run_matches_jax(draws, algo):
    """Table I's objective (its float32 shift vector is a uniform draw,
    bit-exact in both packages) at a small width, 2 islands, ring."""
    jr, tr = _pair(algo, 2, fn="shifted_rosenbrock", dim=12, gens=9, seed=5)
    _assert_same_run(jr, tr, 9)


def test_ea_starvation_matches_jax(jax_draws):
    """EA islands under starvation migration."""
    jr, tr = _pair("ea", 4, migration="starvation", params={"lam": 10}, gens=9)
    _assert_same_run(jr, tr, 9)


# -- evaluation accounting (all eight policies) -------------------------------------

PARITY_CASES = [(name, {}) for name in sorted(jcore.ALGORITHMS)] + [
    ("de", {"barrier_mode": "chunked", "n_chunks": 8}),
]


@pytest.mark.parametrize("name,params", PARITY_CASES,
                         ids=[n + ("-chunked" if p else "") for n, p in PARITY_CASES])
def test_evals_per_gen_parity(name, params):
    """Charged accounting == rows the evaluator sees, per init and per
    generation, for every policy, at a pop (37) that is not the paper's and
    that chunked DE's 8 chunks do not divide; and equal to the reference's
    charges."""
    pop, dim = 37, 5
    jf, f = _fns("sphere", dim)
    counted: list[int] = []

    def counting(p):
        counted.append(p.shape[0])
        return f.fn(p)

    algo = tcore.ALGORITHMS[name](f=f, evaluator=counting, pop=pop, dim=dim, **params)
    ref = jcore.ALGORITHMS[name](f=jf, evaluator=None, pop=pop, dim=dim, **params)
    assert (algo.evals_per_gen, algo.init_evals) == (ref.evals_per_gen, ref.init_evals)
    state = algo.init(prng.PRNGKey(0)[None])
    assert sum(counted) == algo.init_evals, counted
    counted.clear()
    algo.gen(state, prng.PRNGKey(1)[None])
    assert sum(counted) == algo.evals_per_gen, counted


# -- migrant adoption -------------------------------------------------------------

@pytest.mark.parametrize("algo", ["ea", "fa"])
def test_adopt_native_after_ring(algo):
    """Ring migration moves rows into both packages' 4-island states; the
    adoption of the policy's own slots (a scalar each, never re-initialised)
    leaves the same state in both."""
    I, P, D = 4, 12, 6
    sts = [_state(algo, "rastrigin", P, D, seed) for seed in range(I)]
    st = {k: np.stack([s[k] for s in sts]) for k in sts[0]}
    jp, jf = jmig.ring(jnp.asarray(st["pop"]), jnp.asarray(st["fit"]), 2)
    tp, tf = tmig.ring(torch.from_numpy(st["pop"]), torch.from_numpy(st["fit"]), 2)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    adopted = np.any(np.asarray(jp) != st["pop"], axis=-1)
    assert adopted.any()
    jstate = jax.vmap(lambda s, m: jpf.adopt_native(algo, s, m))(
        {**{k: jnp.asarray(v) for k, v in st.items()}, "pop": jp, "fit": jf},
        jnp.asarray(adopted))
    tstate = tpf.adopt_native(algo, {**convert.state_from_numpy(st, "cpu"),
                                     "pop": tp, "fit": tf}, torch.from_numpy(adopted))
    got = convert.state_to_numpy(tstate)
    assert set(got) == set(jstate)
    for k, v in jstate.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
