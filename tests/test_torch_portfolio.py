"""The port's heterogeneous portfolios against the JAX package and against
the port's plain engine (mirrors ``tests/test_portfolio.py`` but its mesh
cases).

* Against the reference: the registry, the unified schema (keys, shapes,
  dtypes), one generation per island of a mixed portfolio, the adopt
  rules, whole mixed runs through ``minimize`` and ``minimize_many`` and
  the budget accounting. A mixed portfolio is held within the engine bound
  of the parity contract, rtol 1e-4 (never tighter than the reference's own
  fused/unfused gap of 1.36e-5); accounting must match exactly. GA and SA
  take JAX's normals and categorical samples through the ``jax_draws`` shim
  of ``tests/test_torch_engines.py``.
* Within the port: a homogeneous portfolio calls its policy directly and is
  bit-identical to the plain ``algo_maker`` engine, and a job of a bucket is
  bit-identical to a standalone ``minimize``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_engines import _fns, _partitionable, jax_draws  # noqa: E402,F401

from repro import core as jcore  # noqa: E402
from repro.core import portfolio as jpf  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import portfolio as tpf  # noqa: E402
from repro_torch.functions import benchmarks as tbm  # noqa: E402
from repro_torch.launch import opt_serve as tserve  # noqa: E402

RTOL = 1e-4
KEY = 11
MIXED = ("de", "pso", "sa", "ga")
# 32 dimensions and pm 0.3 keep a GA child from copying its parent exactly
# (see tests/test_torch_engines.py); SA's T0 keeps it accepting.
MIXED_PARAMS = {"sa": {"T0": 50.0}, "ga": {"pm": 0.3}}


def _mixed_params(names=MIXED):
    """Fresh per-policy dicts: the reference's ``build_portfolio`` writes
    ``kernel_cfg`` into the dicts it is given."""
    return {k: dict(v) for k, v in MIXED_PARAMS.items() if k in names}


def _cfg(pkg, **kw):
    base = dict(n_islands=4, pop=16, dim=6, sync_every=5, migration="ring",
                max_evals=6000)
    base.update(kw)
    return pkg.IslandConfig(**base)


def _topt(cfg_kw, algo=None, params=None, **kw):
    maker = None if algo is None else tcore.ALGORITHMS[algo]
    return tcore.IslandOptimizer(maker, _cfg(tcore, **cfg_kw), params=params,
                                 device="cpu", **kw)


def _jopt(cfg_kw, algo=None, params=None, **kw):
    maker = None if algo is None else jcore.ALGORITHMS[algo]
    return jcore.IslandOptimizer(maker, _cfg(jcore, **cfg_kw), params=params, **kw)


def _assert_same(a, b):
    assert a.value == b.value
    assert a.n_evals == b.n_evals and a.n_gens == b.n_gens
    np.testing.assert_array_equal(np.asarray(a.arg), np.asarray(b.arg))
    np.testing.assert_array_equal(np.asarray(a.history), np.asarray(b.history))


def _assert_close(tr, jr):
    assert tr.n_evals == jr.n_evals and tr.n_gens == jr.n_gens
    np.testing.assert_allclose(tr.value, jr.value, rtol=RTOL)
    np.testing.assert_allclose(tr.history, np.asarray(jr.history), rtol=RTOL)
    assert tr.arg.shape == np.asarray(jr.arg).shape


def _unified(pkg, name, f, pop=6, dim=3, **kw):
    spec = pkg.REGISTRY[name]
    ev = f.eval_population if pkg is jpf else tcore.make_batch_evaluator(
        f, tcore.ExecutorConfig())
    algo = spec.maker(f=f, evaluator=ev, pop=pop, dim=dim, **kw)
    return pkg.UnifiedPolicy(spec, algo, pop, dim)


# -- registry and schema ----------------------------------------------------------

def test_registry_covers_all_engine_algorithms():
    """Every ALGORITHMS entry is registered with the reference's frozen
    algo_id, slots and maker."""
    assert set(tpf.REGISTRY) == set(tcore.ALGORITHMS) == set(jpf.REGISTRY)
    for name, spec in tpf.REGISTRY.items():
        assert spec.algo_id == jpf.REGISTRY[name].algo_id
        assert spec.maker is tcore.ALGORITHMS[name]
    ids = [s.algo_id for s in tpf.REGISTRY.values()]
    assert len(ids) == len(set(ids))


def test_schema_matches_jax():
    assert tpf.schema() == jpf.schema()
    nv, np_, ns = tpf.schema()
    assert nv >= 2 and np_ >= 2 and ns >= 1


def test_register_rejects_duplicates_and_bad_slots():
    with pytest.raises(ValueError, match="already registered"):
        tpf.register(tpf.PolicySpec("de", 99, tcore.ALGORITHMS["de"]))
    with pytest.raises(ValueError, match="already taken"):
        tpf.register(tpf.PolicySpec("de2", 0, tcore.ALGORITHMS["de"]))
    with pytest.raises(ValueError, match="unknown slot kind"):
        tpf.register(tpf.PolicySpec("de3", 98, tcore.ALGORITHMS["de"],
                                    slots=(tpf.AuxSlot("x", "matrix"),)))
    assert set(tpf.REGISTRY) == set(tcore.ALGORITHMS)


@pytest.mark.parametrize("name", sorted(jpf.REGISTRY))
def test_unified_init_matches_jax(name):
    """Each policy's unified init of two islands: the reference's keys,
    shapes and dtypes (island-stacked), the same positions and slots, and
    fitness within float32 rounding."""
    jf, tf = _fns("rastrigin", 4)
    keys = prng.split(prng.PRNGKey(KEY), 2)
    got = _unified(tpf, name, tf, pop=8, dim=4).init(keys)
    want = jax.vmap(_unified(jpf, name, jf, pop=8, dim=4).init)(
        jnp.asarray(keys.numpy().astype(np.uint32)))
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).replace("torch.", "") == str(w.dtype), k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-6, err_msg=k)
    assert got["alive"].all()


def test_expand_cycles_and_validates():
    assert tpf.expand(("de", "pso"), 5) == ("de", "pso", "de", "pso", "de")
    assert tpf.expand(("de", "pso", "sa"), 3) == ("de", "pso", "sa")
    assert tpf.expand(("de", "pso", "sa", "ga"), 8) == jpf.expand(("de", "pso", "sa", "ga"), 8)
    with pytest.raises(ValueError, match="unknown"):
        tpf.expand(("nope",), 2)
    with pytest.raises(ValueError, match="empty"):
        tpf.expand((), 2)
    with pytest.raises(ValueError, match="only 2 islands"):
        tpf.expand(("de", "pso", "sa"), 2)


def test_build_portfolio_rejects_params_for_absent_policies():
    f = tbm.FUNCTIONS["sphere"]
    with pytest.raises(ValueError, match="not in the portfolio"):
        tpf.build_portfolio(("de", "pso"), f, f.fn, 8, 4, params={"sa": {"T0": 1.0}})


def test_build_portfolio_branch_table_matches_jax():
    names = tpf.expand(MIXED, 8)
    jf, tf = _fns("sphere", 4)
    t = tpf.build_portfolio(names, tf, tf.fn, 8, 4, params={"pso": (("w", 0.7),)})
    j = jpf.build_portfolio(names, jf, jf.eval_population, 8, 4, params={"pso": (("w", 0.7),)})
    np.testing.assert_array_equal(t.branch_of, j.branch_of)
    np.testing.assert_array_equal(t.owns_alive, j.owns_alive)
    assert t.algo_ids == j.algo_ids and t.n_branches == j.n_branches == 4
    assert (t.per_gen_total, t.init_total) == (j.per_gen_total, j.init_total)


# -- homogeneous portfolios: the plain engine, bit for bit -------------------------

@pytest.mark.parametrize("algo", ["de", "pso", "sa", "bh"])
def test_homogeneous_portfolio_bit_identical_minimize(algo):
    f = tbm.FUNCTIONS["rastrigin"]
    plain = _topt({}, algo).minimize(f, prng.PRNGKey(KEY))
    port = _topt({"portfolio": (algo,)}).minimize(f, prng.PRNGKey(KEY))
    _assert_same(plain, port)


def test_homogeneous_de_portfolio_bit_identical_minimize_many():
    f = tbm.FUNCTIONS["sphere"]
    keys = torch.stack([prng.PRNGKey(s) for s in (0, 3, 11)])
    plain = _topt({}, "de").minimize_many(f, keys)
    port = _topt({"portfolio": ("de",)}).minimize_many(f, keys)
    for a, b in zip(plain, port):
        _assert_same(a, b)


def test_plain_ga_matches_homogeneous_ga_portfolio():
    """A ga island's adopted migrants revive and their age resets in both
    forms, so the plain engine and the homogeneous ga portfolio agree bit
    for bit under starvation and ring migration."""
    f = tbm.FUNCTIONS["rastrigin"]
    params = {"age_mean": 6.0, "age_sd": 1.0}
    for mig in ("starvation", "ring"):
        kw = dict(n_islands=4, pop=12, max_evals=8000, migration=mig)
        plain = _topt(kw, "ga", params).minimize(f, prng.PRNGKey(KEY))
        port = _topt({**kw, "portfolio": ("ga",)}, params={"ga": params}).minimize(
            f, prng.PRNGKey(KEY))
        _assert_same(plain, port)
        assert np.isfinite(plain.value)


def test_homogeneous_portfolio_starvation_matches_plain_under_eviction():
    """Starvation counts live slots as isfinite(fit) for policies that do
    not own an alive mask; the portfolio's all-True common mask must not
    change that. An objective that fails on half the domain (the executor
    evicts to +inf) makes the trigger depend on it."""
    def half_bad(x):
        s = torch.sum(x * x, dim=-1)
        return torch.where(x[..., 0] > 0.0, torch.nan, s)

    f = tbm.Function("half_bad_sphere", half_bad, -10.0, 10.0)
    kw = dict(n_islands=4, pop=12, max_evals=5000, migration="starvation")
    plain = _topt(kw, "de").minimize(f, prng.PRNGKey(KEY))
    port = _topt({**kw, "portfolio": ("de",)}).minimize(f, prng.PRNGKey(KEY))
    _assert_same(plain, port)
    assert np.isfinite(plain.value)


# -- mixed portfolios against the reference ---------------------------------------

def _unified_state(names, P, D, seed):
    """A mid-run unified state of one island per name, made with numpy in
    the JAX layout (``(I, ...)``): each island's slots filled as its policy
    fills them, the rest zero, as ``UnifiedPolicy._pack`` pads."""
    from test_torch_engines import _state
    nv, npp, ns = jpf.schema()
    out = {k: [] for k in ("pop", "fit", "alive", "best_arg", "best_val",
                           "aux_vec", "aux_ind", "aux_scl")}
    for i, name in enumerate(names):
        st = _state(name if name in ("pso", "ga") else "sa", "rastrigin", P, D, seed + i)
        spec = jpf.REGISTRY[name]
        vec = [st[s.name] for s in spec.slots if s.kind == "vec"]
        ind = [st[s.name] for s in spec.slots if s.kind == "ind"]
        scl = [np.float32(37.0 if s.name == "t" else 0.5)
               for s in spec.slots if s.kind == "scl"]
        out["pop"].append(st["pop"])
        out["fit"].append(st["fit"])
        out["alive"].append(st.get("alive", np.ones(P, bool)))
        out["best_arg"].append(st["best_arg"])
        out["best_val"].append(st["best_val"])
        out["aux_vec"].append(np.stack(vec + [np.zeros((P, D), np.float32)] * (nv - len(vec))))
        out["aux_ind"].append(np.stack(ind + [np.zeros(P, np.float32)] * (npp - len(ind))))
        out["aux_scl"].append(np.asarray(scl + [np.float32(0)] * (ns - len(scl)), np.float32))
    return {k: np.stack(v) for k, v in out.items()}


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_step_stacked_matches_jax(jax_draws, fused):
    """One generation of every island of a mixed portfolio (two islands per
    policy, cycled) from the same unified state and keys: the port's
    grouped step against the reference's ``lax.switch``, fused through the
    Pallas kernels in interpret mode."""
    names = tpf.expand(MIXED, 8)
    P, D = 16, 32
    st = _unified_state(names, P, D, seed=5)
    jf, tf = _fns("rastrigin", D)
    params = {k: {**v, "fused": fused} for k, v in _mixed_params().items()}
    params.update(de={"fused": fused}, pso={"fused": fused})
    jb, tb = ("pallas", "cuda") if fused else ("xla", "torch")
    jport = jpf.build_portfolio(names, jf, jcore.make_batch_evaluator(
        jf, jcore.ExecutorConfig(backend=jb)), P, D, params=params)
    tport = tpf.build_portfolio(names, tf, tcore.make_batch_evaluator(
        tf, tcore.ExecutorConfig(backend=tb)), P, D, params=params)
    keys = prng.split(prng.PRNGKey(KEY), len(names))
    want = jax.jit(jport.step_stacked)(
        {k: jnp.asarray(v) for k, v in st.items()},
        jnp.asarray(keys.numpy().astype(np.uint32)))
    got = tport.step_stacked({k: torch.from_numpy(v.copy()) for k, v in st.items()}, keys)
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == (torch.bool if k == "alive" else torch.float32), k
        if k == "alive":
            np.testing.assert_array_equal(got[k].numpy(), w)
        else:
            np.testing.assert_allclose(got[k].numpy(), w, rtol=RTOL, atol=1e-5, err_msg=k)


def test_adopt_stacked_matches_jax():
    """Every policy's adopt rules on its own islands of a mixed portfolio,
    against the reference's switch over the same state and mask."""
    names = tpf.expand(("de", "pso", "sa", "ga", "ea", "fa", "bh", "mc"), 8)
    P, D = 6, 3
    st = _unified_state(names, P, D, seed=9)
    st["alive"][3, 2] = False                       # a dead ga slot, revived
    mask = np.random.default_rng(0).uniform(size=(8, P)) < 0.4
    jf, tf = _fns("sphere", D)
    jport = jpf.build_portfolio(names, jf, jf.eval_population, P, D)
    tport = tpf.build_portfolio(names, tf, tf.fn, P, D)
    want = jport.adopt_stacked({k: jnp.asarray(v) for k, v in st.items()},
                               jnp.asarray(mask))
    got = tport.adopt_stacked({k: torch.from_numpy(v.copy()) for k, v in st.items()},
                              torch.from_numpy(mask))
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w), err_msg=k)


@pytest.mark.parametrize("portfolio,migration", [
    (("de", "pso", "sa"), "ring"), (MIXED, "ring"), (("ga", "pso", "ga", "sa"), "starvation"),
], ids=["de-pso-sa-ring", "four-ring", "ga-starvation"])
def test_mixed_portfolio_minimize_matches_jax(jax_draws, portfolio, migration):
    """Whole mixed runs on the same keys; ga islands with aging under
    starvation refill from the other policies' best."""
    jf, tf = _fns("rastrigin", 32)
    aging = {"ga": {"pm": 0.3, "age_mean": 6.0, "age_sd": 1.0}}

    def params():
        return {**_mixed_params(portfolio), **(aging if migration == "starvation" else {})}

    kw = dict(n_islands=8, pop=16, dim=32, max_evals=8 * 16 * 31, sync_every=3,
              migration=migration, portfolio=portfolio)
    _assert_close(_topt(kw, params=params()).minimize(tf, prng.PRNGKey(KEY)),
                  _jopt(kw, params=params()).minimize(jf, jax.random.PRNGKey(KEY)))


def test_mixed_portfolio_minimize_many_matches_jax(jax_draws):
    jf, tf = _fns("rastrigin", 32)
    kw = dict(n_islands=4, pop=16, dim=32, max_evals=4 * 16 * 31, sync_every=3,
              portfolio=MIXED, share_incumbent=True)
    seeds = (0, 5)
    got = _topt(kw, params=_mixed_params()).minimize_many(
        tf, torch.stack([prng.PRNGKey(s) for s in seeds]))
    want = _jopt(kw, params=_mixed_params()).minimize_many(
        jf, jnp.stack([jax.random.PRNGKey(s) for s in seeds]))
    for tr, jr in zip(got, want):
        _assert_close(tr, jr)


def test_mixed_portfolio_minimize_many_matches_minimize():
    """A job's result does not depend on its bucket: bit-identical to a
    standalone run, though its groups hold twice the rows."""
    f = tbm.FUNCTIONS["rastrigin"]
    kw = dict(n_islands=6, max_evals=9000, portfolio=("de", "pso", "sa"))
    seeds = (0, 5)
    many = _topt(kw).minimize_many(f, torch.stack([prng.PRNGKey(s) for s in seeds]))
    for s, got in zip(seeds, many):
        _assert_same(_topt(kw).minimize(f, prng.PRNGKey(s)), got)


def test_mixed_portfolio_deterministic_and_improves():
    f = tbm.FUNCTIONS["rastrigin"]
    kw = dict(n_islands=6, max_evals=9000, portfolio=("de", "pso", "sa"))
    params = {"sa": {"T0": 50.0}}
    r1 = _topt(kw, params=params).minimize(f, prng.PRNGKey(KEY))
    r2 = _topt(kw, params=params).minimize(f, prng.PRNGKey(KEY))
    _assert_same(r1, r2)
    assert r1.value < 50.0 and np.isfinite(r1.value)
    assert r1.n_evals <= 9000
    assert np.all(np.diff(r1.history) <= 0)


def test_portfolio_composes_with_polish_and_incumbent_sharing():
    """Deterministic, within the budget, and charged as the reference
    charges (the polish parts from the reference on the objective's last
    bits: ``tests/test_torch_polish.py``)."""
    jf, tf = _fns("rosenbrock", 6)
    kw = dict(n_islands=4, max_evals=8000, portfolio=("de", "pso"),
              share_incumbent=True, polish="asd", polish_every=2,
              polish_topk=2, polish_steps=2)
    r1 = _topt(kw).minimize(tf, prng.PRNGKey(KEY))
    r2 = _topt(kw).minimize(tf, prng.PRNGKey(KEY))
    _assert_same(r1, r2)
    jr = _jopt(kw).minimize(jf, jax.random.PRNGKey(KEY))
    assert (r1.n_evals, r1.n_gens) == (jr.n_evals, jr.n_gens)
    assert r1.n_evals <= 8000


def test_portfolio_heterogeneous_budget_accounting():
    """Islands charge their own policy's evals_per_gen: a ga island (n_off
    per generation) costs less than a de island (pop per generation), and
    the round total is the per-island sum — as the reference charges."""
    jf, tf = _fns("sphere", 4)
    kw = dict(n_islands=2, pop=16, dim=4, migration="none", portfolio=("de", "ga"),
              max_evals=2000)
    opt = _topt(kw)
    port = opt._build(tf)
    assert port.per_gen_total == 16 + 4 and port.init_total == 32
    res = opt.minimize(tf, prng.PRNGKey(KEY))
    jres = _jopt(kw).minimize(jf, jax.random.PRNGKey(KEY))
    rounds = res.n_gens // 5
    assert res.n_evals == 32 + rounds * 5 * 20 == jres.n_evals
    assert res.n_gens == jres.n_gens


def test_portfolio_mode_validation():
    with pytest.raises(ValueError, match="algo_maker=None"):
        _topt({"portfolio": ("de", "pso")}, "de")
    with pytest.raises(ValueError, match="n_islands > 1"):
        _topt({"n_islands": 1, "migration": "none", "portfolio": ("de",)})
    with pytest.raises(ValueError, match="algo_maker is required"):
        _topt({})
    with pytest.raises(ValueError, match="does not support portfolio"):
        _topt({"portfolio": ("de", "pso")}).bucket_stepper(tbm.FUNCTIONS["sphere"])


# -- adoption across policies ------------------------------------------------------

def _adopt_pair(name, mutate, mask, **kw):
    """The port's and the reference's ``UnifiedPolicy.adopt`` on the same
    unified state of one island."""
    jf, tf = _fns("sphere", 3)
    keys = prng.split(prng.PRNGKey(KEY), 1)
    t = _unified(tpf, name, tf, **kw)
    j = _unified(jpf, name, jf, **kw)
    u = {k: v[0].numpy() for k, v in t.init(keys).items()}
    u = mutate(u)
    want = j.adopt({k: jnp.asarray(v) for k, v in u.items()}, jnp.asarray(mask))
    got = t.adopt({k: torch.from_numpy(v[None].copy()) for k, v in u.items()},
                  torch.from_numpy(mask[None]))
    for k, w in want.items():
        np.testing.assert_array_equal(got[k][0].numpy(), np.asarray(w), err_msg=k)
    return u, {k: v[0].numpy() for k, v in got.items()}


def test_adopt_reinitializes_pso_aux_slots():
    mask = np.asarray([False, True, False, False, True, False])

    def mutate(u):
        u["pop"][1], u["pop"][4] = 7.0, -7.0
        u["fit"][1], u["fit"][4] = 0.5, 0.25
        return u

    u, v = _adopt_pair("pso", mutate, mask)
    vel, pbest, pbest_f = v["aux_vec"][0], v["aux_vec"][1], v["aux_ind"][0]
    assert (vel[[1, 4]] == 0).all()
    np.testing.assert_array_equal(pbest[[1, 4]], v["pop"][[1, 4]])
    assert pbest_f[1] == 0.5 and pbest_f[4] == 0.25
    np.testing.assert_array_equal(vel[0], u["aux_vec"][0][0])
    np.testing.assert_array_equal(pbest[2], u["aux_vec"][1][2])
    assert v["alive"].all()


def test_adopt_revives_and_rejuvenates_ga_slots():
    mask = np.asarray([False, False, True, False, False, False])

    def mutate(u):
        u["aux_ind"][0] = 9.0
        u["alive"][2] = False
        return u

    u, v = _adopt_pair("ga", mutate, mask, age_mean=10.0, age_sd=0.0)
    age, limit = v["aux_ind"][0], v["aux_ind"][1]
    assert age[2] == 0.0 and age[0] == 9.0
    assert limit[2] == u["aux_ind"][1][2]
    assert v["alive"][2] and not u["alive"][2]


@pytest.mark.parametrize("name", ["sa", "ea", "fa"])
def test_adopt_keeps_per_island_scalars(name):
    def mutate(u):
        u["aux_scl"][0] = 3.25
        return u

    _, v = _adopt_pair(name, mutate, np.ones(6, bool))
    assert v["aux_scl"][0] == 3.25


def test_ring_migration_across_policies_matches_jax():
    """A 2-island de -> pso ring: the pso island adopts de's best only when
    it beats its own worst, and the adopted particle restarts at rest."""
    jf, tf = _fns("rastrigin", 8)
    kw = dict(n_islands=2, pop=12, dim=8, max_evals=1200, sync_every=3, n_migrants=2,
              portfolio=("de", "pso"))
    r1 = _topt(kw).minimize(tf, prng.PRNGKey(KEY))
    _assert_same(r1, _topt(kw).minimize(tf, prng.PRNGKey(KEY)))
    _assert_close(r1, _jopt(kw).minimize(jf, jax.random.PRNGKey(KEY)))
    assert np.all(np.diff(r1.history) <= 0)


def test_portfolio_round_from_jax_state_matches_jax(jax_draws):
    """A round of the port started from JAX's mixed portfolio state
    (carried across by ``convert.state_from_numpy``) against JAX's next
    round from the same state and round key."""
    jf, tf = _fns("rastrigin", 32)
    kw = dict(n_islands=8, pop=16, dim=32, sync_every=3, portfolio=MIXED,
              share_incumbent=True)
    jo, to = _jopt(kw, params=_mixed_params()), _topt(kw, params=_mixed_params())
    jalgo, talgo = jo._build(jf), to._build(tf)
    jstate = jo._init_state(jalgo, jax.random.PRNGKey(3))
    rk = jax.random.PRNGKey(4)
    want = jax.jit(jo._round_fn(jalgo))(jstate, rk)
    tstate = convert.state_from_numpy({k: np.asarray(v) for k, v in jstate.items()}, "cpu")
    assert tstate["alive"].dtype == torch.bool
    assert tuple(tstate["aux_vec"].shape) == (8, *tpf.schema()[:1], 16, 32)
    got = to._round_fn(talgo)(tstate, torch.from_numpy(np.asarray(rk).astype(np.int64)))
    back = convert.state_to_jax(got, 8)
    for k, w in want.items():
        w = np.asarray(w)
        assert back[k].shape == w.shape and back[k].dtype == w.dtype, k
        np.testing.assert_allclose(back[k], w, rtol=RTOL, atol=1e-5, err_msg=k)


# -- the service --------------------------------------------------------------------

def test_scheduler_portfolio_bucket_matches_standalone():
    """A portfolio bucket runs resident (no stepper, as in the reference):
    every job bit-identical to its standalone run, and split from the plain
    bucket of the same shape."""
    base = {"fn": "rastrigin", "dim": 6, "pop": 16, "n_islands": 6,
            "sync_every": 5, "max_evals": 6000,
            "portfolio": ["de", "pso", "sa"], "params": {"sa": {"T0": 50.0}}}
    sched = tcore.ShapeBucketScheduler(device="cpu")
    ids = [sched.submit(tcore.OptRequest.from_dict({**base, "seed": s})) for s in (0, 4)]
    plain_id = sched.submit(tcore.OptRequest(fn="rastrigin", dim=6, pop=16, n_islands=6,
                                             sync_every=5, max_evals=6000, seed=0))
    assert len(sched.pending_buckets()) == 2
    assert sched.flush() == 3
    f = tbm.FUNCTIONS["rastrigin"]
    for jid, seed in zip(ids, (0, 4)):
        got = sched.result(jid)
        assert got.status == "done"
        want = _topt({"n_islands": 6, "portfolio": ("de", "pso", "sa")},
                     params={"sa": {"T0": 50.0}}).minimize(f, prng.PRNGKey(seed))
        _assert_same(got.result, want)
    assert sched.result(plain_id).status == "done"
    assert sched.stats()["dispatches"] == 2


def test_scheduler_warm_portfolio_bucket_runs_per_job():
    """A warm-started portfolio bucket runs one ``minimize(warm=)`` per job."""
    warm = [[0.1] * 4, [0.2] * 4]
    base = {"fn": "sphere", "dim": 4, "pop": 16, "n_islands": 4, "sync_every": 5,
            "max_evals": 3000, "portfolio": ["de", "pso"], "warm": warm}
    sched = tcore.ShapeBucketScheduler(device="cpu")
    ids = [sched.submit(tcore.OptRequest.from_dict({**base, "seed": s})) for s in (1, 2)]
    sched.flush()
    f = tbm.FUNCTIONS["sphere"]
    for jid, seed in zip(ids, (1, 2)):
        want = _topt({"n_islands": 4, "dim": 4, "max_evals": 3000,
                      "portfolio": ("de", "pso")}).minimize(
            f, prng.PRNGKey(seed), warm=np.asarray(warm, np.float32))
        _assert_same(sched.result(jid).result, want)


def test_opt_serve_portfolio_round_trip():
    svc = tserve.OptimizationService(max_batch=8, flush_ms=5.0, device="cpu")
    out = svc.handle({"op": "submit", "request": {
        "fn": "sphere", "dim": 4, "pop": 16, "n_islands": 4,
        "portfolio": ["de", "pso"], "max_evals": 3000, "seed": 0}})
    assert out["status"] == "queued"
    res = svc.handle({"op": "result", "id": out["id"]})
    assert res["status"] == "done" and np.isfinite(res["value"])
    assert len(res["arg"]) == 4
