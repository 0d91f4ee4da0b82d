"""The port's memetic layer against the JAX package: numeric gradients, the
batched polish (``make_polish`` for asd, fcg, avd and bfgs), the hybrid
island engine's accounting, the explore→polish pipeline, the observer
coupling, the budget-capped descent methods and Adam.

A Richardson gradient multiplies the objective's rounding by about
``1/(12h)`` (833 at ``h = 1e-4``), so comparing the polish on each package's
own objective would test the objective's last bits, not the polish. The
first set of tests therefore gives both sides the same objective values: a
test-only shim evaluates every row batch with the reference's jitted
``jax.vmap(f.fn)``; the reference reaches it through ``jax.pure_callback``
and the port through a plain call. The second set runs the port's own
evaluator and checks properties, as ``tests/test_hybrid.py`` does for the
reference: monotone, exact evaluation accounting, batched equal to
single-start.

Bounds, each stated where it is used; none is tighter than the reference's
own fused/unfused gap (1.36e-5 relative, ``ROADMAP.md``) where the two
packages' arithmetic can differ.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_engines import _fns, _partitionable  # noqa: E402,F401

from repro import core as jcore  # noqa: E402
from repro.core import coupling as jcoupling  # noqa: E402
from repro.core import islands as jislands  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro.optim import descent as jdesc  # noqa: E402
from repro.optim import numgrad as jnum  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.configs import popt_bench as tbench  # noqa: E402
from repro_torch.core import coupling as tcoupling  # noqa: E402
from repro_torch.core import islands as tislands  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from repro_torch.optim import descent as tdesc  # noqa: E402
from repro_torch.optim import numgrad as tnum  # noqa: E402

METHODS = ("asd", "fcg", "avd", "bfgs")
# Shared objective values: only the polish arithmetic differs (summation
# order of norms and dot products).
SHARED_RTOL = 1e-6


class Shared:
    """One objective, evaluated for both packages by the reference's jitted
    ``vmap(f.fn)``, row batch by row batch."""

    def __init__(self, jf):
        self.jf = jf
        self._fn = jax.jit(jax.vmap(jf.fn))

    def host(self, rows):
        rows = np.asarray(rows)
        flat = rows.reshape(-1, rows.shape[-1])
        return np.asarray(self._fn(jnp.asarray(flat)), np.float32).reshape(rows.shape[:-1])

    def jax(self, rows):
        return jax.pure_callback(
            self.host, jax.ShapeDtypeStruct(rows.shape[:-1], jnp.float32), rows,
            vmap_method="expand_dims")

    def torch(self, rows):
        return torch.from_numpy(self.host(rows.numpy()))


def _shared_fns(fn, dim, monkeypatch=None):
    """Both packages' objective with ``fn`` replaced by the shared shim;
    with ``monkeypatch``, also both engines' batch evaluators."""
    jf, tf = _fns(fn, dim)
    sh = Shared(jf)
    if monkeypatch is not None:
        monkeypatch.setattr(jislands, "make_batch_evaluator", lambda *a, **k: sh.jax)
        monkeypatch.setattr(tislands, "make_batch_evaluator", lambda *a, **k: sh.torch)
    return dataclasses.replace(jf, fn=sh.jax), dataclasses.replace(tf, fn=sh.torch)


def _starts(fn, k, dim, seed=7, box=None):
    """``k`` uniform starts in the function's box (or in ``box``)."""
    jf, tf = _fns(fn, dim)
    lo, hi = box or (jf.lo, jf.hi)
    xs = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (k, dim),
                                       minval=lo, maxval=hi))
    return jf, tf, xs, np.asarray(jax.vmap(jf.fn)(jnp.asarray(xs)))


def _close(got, want, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


# -- numeric gradients ----------------------------------------------------------

@pytest.mark.parametrize("fn", ["sphere", "rosenbrock", "levy"])
def test_richardson_grad_matches_reference(fn):
    """Same probe values: the Richardson combination and its product with
    the float32 reciprocal of 12h are XLA's, bit for bit."""
    jf, tf, xs, _ = _starts(fn, 1, 7)
    sh = Shared(jf)
    want, n = jax.jit(lambda x: jnum.richardson_grad(sh.jax, x)[0])(jnp.asarray(xs[0])), 28
    got, m = tnum.richardson_grad(sh.torch, torch.from_numpy(xs[0]))
    assert m == n == 4 * 7
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_grad_modes_and_accounting():
    _, tf = _fns("sphere", 7)
    x = torch.linspace(-2.0, 3.0, 7)
    g, n = tnum.make_grad(tf.fn, "richardson", h=1e-2)(x)
    ga, na = tnum.make_grad(tf.fn, "autodiff")(x)
    assert (n, na) == (28, 2)
    np.testing.assert_allclose(g.numpy(), 2 * x.numpy(), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(ga.numpy(), 2 * x.numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="unknown grad mode"):
        tnum.make_grad(tf.fn, "secant")


def test_batched_richardson_matches_reference():
    jf, tf, xs, _ = _starts("rosenbrock", 3, 6)
    sh = Shared(jf)
    want = jax.jit(lambda x: jdesc._batched_richardson(sh.jax, x, 1e-4))(jnp.asarray(xs))
    got = tdesc._batched_richardson(sh.torch, torch.from_numpy(xs), 1e-4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ladder_search_matches_reference():
    """The ladder's steps, candidates, Armijo test and choice (first
    admissible step, else the best trial, else stay)."""
    jf, tf, xs, fs = _starts("rosenbrock", 5, 6)
    sh = Shared(jf)
    g = np.asarray(jax.jit(lambda x: jdesc._batched_richardson(sh.jax, x, 1e-4))(
        jnp.asarray(xs)))
    d = -g
    d[1] = g[1]                      # an uphill direction: the row must stay
    cfg = jdesc.PolishConfig(gamma=30.0)
    want = jax.jit(lambda *a: jdesc._ladder_search(sh.jax, *a, jf.lo, jf.hi, cfg))(
        *map(jnp.asarray, (xs, fs, g, d)))
    got = tdesc._ladder_search(sh.torch, *map(torch.from_numpy, (xs, fs, g, d)),
                               tf.lo, tf.hi, tdesc.PolishConfig(gamma=30.0))
    _close(got[1], want[1], SHARED_RTOL)
    _close(got[0], want[0], SHARED_RTOL, 1e-5)
    assert got[1][1] == fs[1] and (got[1] < torch.from_numpy(fs)).sum() >= 3


FIRST_STEP_CASES = [(m, fn) for m in METHODS for fn in ("rosenbrock", "levy", "rastrigin")]


@pytest.mark.parametrize("method,fn", FIRST_STEP_CASES)
def test_make_polish_first_step_matches_reference(method, fn):
    """One step of each method from the same starts on the same objective
    values: within rtol 1e-6 (one float32 ulp of a position, where a norm
    summed in another order moves a candidate by one ulp). Rosenbrock's
    starts lie in [-2, 2]: far out in its box (values near 1e10, an ulp of
    1024) a Richardson difference at h = 1e-4 is itself about one ulp."""
    box = (-2.0, 2.0) if fn == "rosenbrock" else None
    jf, tf, xs, fs = _starts(fn, 4, 6, box=box)
    sh = Shared(jf)
    cfg = dict(method=method, steps=1)
    want = jax.jit(jdesc.make_polish(jf, sh.jax, 6, jdesc.PolishConfig(**cfg)))(
        jnp.asarray(xs), jnp.asarray(fs))
    got = tdesc.make_polish(tf, sh.torch, 6, tdesc.PolishConfig(**cfg))(
        torch.from_numpy(xs), torch.from_numpy(fs))
    _close(got[1], want[1], 1e-6)
    _close(got[0], want[0], 1e-6, 1e-6)
    assert bool((got[1] < torch.from_numpy(fs)).all())


@pytest.mark.parametrize("method", METHODS)
def test_make_polish_matches_reference(method):
    """Three steps of each method on levy from the same starts on the same
    objective values. After the first step a one-ulp difference in a
    position gives the next Richardson probes other values, and the
    difference of two probes amplifies that by about f / (2h |g|); so the
    bound is the one the reference holds its own polish to when only XLA's
    reduction order changes (``tests/test_hybrid.py``, batched against
    single-start): rtol 1e-3 on values, 1e-2 on positions. AVD has no
    gradient and must agree exactly."""
    jf, tf, xs, fs = _starts("levy", 4, 6)
    sh = Shared(jf)
    cfg = dict(method=method, steps=3)
    want = jax.jit(jdesc.make_polish(jf, sh.jax, 6, jdesc.PolishConfig(**cfg)))(
        jnp.asarray(xs), jnp.asarray(fs))
    got = tdesc.make_polish(tf, sh.torch, 6, tdesc.PolishConfig(**cfg))(
        torch.from_numpy(xs), torch.from_numpy(fs))
    if method == "avd":
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1], want[1], 1e-3, 1e-5)
    _close(got[0], want[0], 1e-2, 1e-2)
    assert bool((got[1] < torch.from_numpy(fs)).all())


def test_polish_config_rejects_unknown_method():
    with pytest.raises(ValueError, match="unknown polish method"):
        tdesc.PolishConfig(method="adam")


@pytest.mark.parametrize("method", METHODS)
def test_polish_evals_per_point_matches_reference(method):
    for dim, steps in ((6, 2), (1000, 2), (33, 5)):
        assert (tdesc.polish_evals_per_point(dim, tdesc.PolishConfig(method, steps))
                == jdesc.polish_evals_per_point(dim, jdesc.PolishConfig(method, steps)))


# -- the port's own evaluator: properties -------------------------------------------

@pytest.mark.parametrize("method", METHODS)
def test_polish_monotone(method):
    _, tf, xs, fs = _starts("rosenbrock", 5, 6)
    xs2, fs2 = tdesc.make_polish(tf, None, 6, tdesc.PolishConfig(method=method, steps=4))(
        torch.from_numpy(xs), torch.from_numpy(fs))
    assert bool((fs2 <= torch.from_numpy(fs)).all())
    assert bool((fs2 < torch.from_numpy(fs)).any())
    np.testing.assert_allclose(tf.fn(xs2).numpy(), fs2.numpy(), rtol=1e-6)


@pytest.mark.parametrize("method", METHODS)
def test_polish_eval_accounting_is_exact(method):
    """The evaluator sees exactly polish_evals_per_point(dim) rows per point."""
    _, tf, xs, fs = _starts("sphere", 3, 5)
    cfg = tdesc.PolishConfig(method=method, steps=4)
    rows = []

    def counting(p):
        rows.append(p.shape[0])
        return tf.fn(p)

    tdesc.make_polish(tf, counting, 5, cfg)(torch.from_numpy(xs), torch.from_numpy(fs))
    assert sum(rows) == 3 * tdesc.polish_evals_per_point(5, cfg)
    assert len(rows) == (1 if method == "avd" else 2) * cfg.steps


@pytest.mark.parametrize("method", METHODS)
def test_polish_batched_matches_single_start(method):
    """Rows are independent: K starts in one batch follow each start's own
    trajectory (the reference's bounds, rtol 1e-3 on values, 1e-2 on
    positions; its batch shapes change XLA's reduction order)."""
    _, tf, xs, fs = _starts("levy", 4, 6)
    polish = tdesc.make_polish(tf, None, 6, tdesc.PolishConfig(method=method, steps=3))
    bx, bf = polish(torch.from_numpy(xs), torch.from_numpy(fs))
    for i in range(4):
        sx, sf = polish(torch.from_numpy(xs[i:i + 1]), torch.from_numpy(fs[i:i + 1]))
        _close(sx[0], bx[i], 1e-2, 1e-2)
        _close(sf[0], bf[i], 1e-3, 1e-5)


# -- the hybrid engine ---------------------------------------------------------------

HYBRID = dict(polish="asd", polish_every=2, polish_topk=3, polish_steps=2)


def _island_cfg(pkg, **kw):
    base = dict(n_islands=2, pop=16, dim=6, sync_every=5, migration="ring",
                max_evals=5000)
    return pkg.IslandConfig(**{**base, **kw})


@pytest.mark.parametrize("method", METHODS)
def test_hybrid_minimize_matches_reference(method, monkeypatch):
    """A hybrid DE run (2 islands, ring, polish every 2 rounds) in both
    engines, each evaluating through the shared shim: DE's draws are
    bit-exact, so only the polish arithmetic differs. The accounting must
    equal the reference's exactly. The incumbent history up to the first
    polish event is held to the reference's batched-polish bound, rtol 1e-3
    (atol 1e-6 near levy's optimum, where its values come down to float32's
    resolution of its O(1) terms). Past it the runs part: a polished point
    one ulp away changes which DE trials win, and a run is chaotic in that."""
    jf, tf = _shared_fns("levy", 6, monkeypatch)
    kw = {**HYBRID, "polish": method}
    jr = jcore.IslandOptimizer(jcore.ALGORITHMS["de"], _island_cfg(jcore, **kw)).minimize(
        jf, jax.random.PRNGKey(7))
    tr = tcore.IslandOptimizer(tcore.ALGORITHMS["de"], _island_cfg(tcore, **kw),
                               device="cpu").minimize(tf, prng.PRNGKey(7))
    assert tr.n_evals == jr.n_evals and tr.n_gens == jr.n_gens
    first = HYBRID["polish_every"]
    np.testing.assert_allclose(tr.history[:first], np.asarray(jr.history)[:first],
                               rtol=1e-3, atol=1e-6)
    assert tr.history[first - 1] < tr.history[0] and tr.history[-1] < tr.history[first - 1]


def test_hybrid_budget_counts_polish_evals():
    """init + rounds * per_round + polish events * per_event, within the
    budget, with fewer generations than the plain run."""
    _, tf = _fns("rosenbrock", 6)
    cfg = _island_cfg(tcore, **HYBRID)
    plain = tcore.IslandOptimizer(tcore.ALGORITHMS["de"], _island_cfg(tcore),
                                  device="cpu").minimize(tf, prng.PRNGKey(7))
    hyb = tcore.IslandOptimizer(tcore.ALGORITHMS["de"], cfg, device="cpu").minimize(
        tf, prng.PRNGKey(7))
    assert hyb.n_evals <= 5000 and hyb.n_gens < plain.n_gens
    per_event = (tdesc.polish_evals_per_point(6, tdesc.PolishConfig("asd", 2))
                 * cfg.polish_topk * cfg.n_islands)
    n_rounds = hyb.n_gens // cfg.sync_every
    assert hyb.n_evals == (16 * 2 + n_rounds * 16 * 2 * 5
                           + (n_rounds // cfg.polish_every) * per_event)


def test_hybrid_host_stepped_matches_device_resident():
    _, tf = _fns("sphere", 6)
    cfg = _island_cfg(tcore, **HYBRID)
    dev = tcore.IslandOptimizer(tcore.ALGORITHMS["de"], cfg, device="cpu").minimize(
        tf, prng.PRNGKey(7))
    seen = []
    host = tcore.IslandOptimizer(tcore.ALGORITHMS["de"], cfg, device="cpu",
                                 round_callback=lambda r, a, v: seen.append(r))
    res = host.minimize(tf, prng.PRNGKey(7))
    assert res.value == dev.value and res.n_evals == dev.n_evals
    np.testing.assert_array_equal(dev.history, res.history)
    assert len(seen) == len(res.history)


def test_hybrid_config_n_evals_matches_reference():
    """HYBRID_CONFIG's accounting (chunked DE, asd every 8 rounds, top-2,
    2 steps) at Table I's width, without running it: the same rounds, polish
    events and n_evals as the reference's _budget for a budget of 8 rounds
    and their one polish event."""
    hc = tbench.HYBRID_CONFIG
    from repro.configs import popt_bench as jbench
    assert dataclasses.asdict(hc) == dataclasses.asdict(jbench.HYBRID_CONFIG)
    assert dataclasses.asdict(tbench.CONFIG) == dataclasses.asdict(jbench.CONFIG)
    per_gen = (hc.pop // 8) * 8
    per_round = per_gen * 10
    pp = tdesc.polish_evals_per_point(hc.dim, tdesc.PolishConfig(hc.polish, hc.polish_steps))
    max_evals = hc.pop + 8 * per_round + hc.polish_topk * pp
    out = []
    for pkg in (tcore, jcore):
        cfg = pkg.IslandConfig(n_islands=1, pop=hc.pop, dim=hc.dim, sync_every=10,
                               migration="none", max_evals=max_evals, polish=hc.polish,
                               polish_every=hc.polish_every, polish_topk=hc.polish_topk,
                               polish_steps=hc.polish_steps)
        opt = pkg.IslandOptimizer(pkg.ALGORITHMS["de"], cfg, **(
            {"device": "cpu"} if pkg is tcore else {}))
        out.append(opt._budget(per_gen, hc.pop, pp))
    assert out[0] == out[1] == (8, per_round, 1, hc.polish_topk * pp)


@pytest.mark.parametrize("polish", ["none", "asd"])
def test_table1_launcher_accounts(polish):
    """``launch.table1`` on a cut popt-bench config on the CPU: whole
    rounds, polish events every ``polish_every`` rounds, n_evals as the
    engine's budget rule charges them."""
    from repro_torch.launch import table1
    cfg = dataclasses.replace(tbench.CONFIG, dim=12, pop=16, polish=polish,
                              polish_every=2, polish_topk=2, polish_steps=1)
    out = table1.measure_single_device(cfg, gens=45, device="cpu")
    events = 2 if polish == "asd" else 0
    per_point = tdesc.polish_evals_per_point(12, tdesc.PolishConfig(polish, 1)) if events else 0
    assert out["gens"] == 40 and out["polish_events"] == events
    assert out["n_evals"] == 16 + 40 * 16 + events * 2 * per_point
    assert np.isfinite(out["best"]) and out["ms_per_gen"] > 0


def test_explore_then_polish_improves_and_accounts():
    _, tf = _fns("rosenbrock", 6)
    opt = tcore.IslandOptimizer(tcore.ALGORITHMS["de"], _island_cfg(tcore), device="cpu")
    base = opt.minimize(tf, prng.PRNGKey(7))
    pcfg = tdesc.PolishConfig(steps=8)
    res = tcore.explore_then_polish(opt, tf, prng.PRNGKey(7), pcfg)
    assert res.value <= base.value
    assert res.n_evals == base.n_evals + tdesc.polish_evals_per_point(6, pcfg)
    assert res.n_gens == base.n_gens and res.arg.shape == (6,)


def test_explore_then_polish_matches_reference(monkeypatch):
    """The staged pipeline on the same DE run (bit-exact draws) through the
    shared shim: the same accounting, and values within rtol 1e-4."""
    jf, tf = _shared_fns("levy", 6, monkeypatch)
    pcfg = dict(steps=8)
    jr = jcore.explore_then_polish(
        jcore.IslandOptimizer(jcore.ALGORITHMS["de"], _island_cfg(jcore)), jf,
        jax.random.PRNGKey(3), jdesc.PolishConfig(**pcfg))
    tr = tcore.explore_then_polish(
        tcore.IslandOptimizer(tcore.ALGORITHMS["de"], _island_cfg(tcore), device="cpu"),
        tf, prng.PRNGKey(3), tdesc.PolishConfig(**pcfg))
    assert tr.n_evals == jr.n_evals
    np.testing.assert_allclose(tr.value, jr.value, rtol=1e-4)


# -- observer coupling ---------------------------------------------------------------

def test_observer_hub_refinement():
    hub = tcore.ObserverHub()
    calls = []

    def refine(arg, val):
        calls.append(float(val))
        return arg * 0.5, val / 2.0

    hub.register(refine)
    arg, val = hub.notify(torch.ones(3), 8.0)
    assert val == 4.0 and len(calls) == 1 and float(arg[0]) == 0.5
    arg, val = hub.notify(torch.ones(3), 9.0)   # worse incumbent -> no refine
    assert val == 4.0 and len(calls) == 1


def test_observed_local_search_matches_reference():
    """An FCG observer refines each notified incumbent from key 0, as the
    reference's does, on the shared shim's values: the same refined value
    within rtol 1e-4."""
    jf, tf = _shared_fns("rosenbrock", 5)
    x0 = np.linspace(-3.0, 4.0, 5).astype(np.float32)
    v0 = float(jf.fn(jnp.asarray(x0[None]))[0])
    hubs = (jcore.ObserverHub(), tcore.ObserverHub())
    # A budget of one FCG iteration (21 evaluations to start, 20 and the
    # line search's for the iteration): past it, one ulp of an iterate would
    # draw a new Richardson gradient (see test_descent_on_sphere_matches_reference).
    jcoupling.observed_local_search(jf, 5, hubs[0], budget_per_refine=40)
    tcoupling.observed_local_search(tf, 5, hubs[1], budget_per_refine=40, device="cpu")
    (ja, jv), (ta, tv) = hubs[0].notify(jnp.asarray(x0), v0), hubs[1].notify(x0, v0)
    assert tv < v0 and jv < v0
    np.testing.assert_allclose(tv, jv, rtol=1e-4)
    np.testing.assert_allclose(ta, np.asarray(ja), rtol=1e-4, atol=1e-4)


def test_fcg_postprocessing_matches_reference():
    """Fig. 4's X/FCG 50-50 split, with DE (bit-exact draws) as the global
    phase (336 evaluations), then about 35 FCG iterations from its incumbent
    on autodiff gradients (see test_descent_on_sphere_matches_reference):
    the same accounting, and the value within rtol 1e-4 (atol 1e-6 near
    sphere's optimum)."""
    jf, tf = _fns("sphere", 6)
    cfg = dict(n_islands=1, pop=16, dim=6, migration="none")
    jr = jcoupling.with_fcg_postprocessing(
        jcore.IslandOptimizer(jcore.ALGORITHMS["de"], jcore.IslandConfig(**cfg)),
        jf, jax.random.PRNGKey(5), 6, total_evals=450, split=0.8,
        dcfg=jdesc.DescentConfig(grad_mode="autodiff"))
    tr = tcoupling.with_fcg_postprocessing(
        tcore.IslandOptimizer(tcore.ALGORITHMS["de"], tcore.IslandConfig(**cfg),
                              device="cpu"),
        tf, prng.PRNGKey(5), 6, total_evals=450, split=0.8,
        dcfg=tdesc.DescentConfig(grad_mode="autodiff"))
    assert tr.n_evals == jr.n_evals and tr.n_evals <= 500
    np.testing.assert_allclose(tr.value, jr.value, rtol=1e-4, atol=1e-6)


# -- budget-capped descent and Adam on sphere ----------------------------------------

DESCENT = {"asd": (jdesc.asd, tdesc.asd), "fcg": (jdesc.fcg, tdesc.fcg),
           "avd": (jdesc.avd, tdesc.avd), "bfgs": (jdesc.bfgs, tdesc.bfgs)}


DESCENT_CASES = [("asd", "richardson", {}), ("asd", "autodiff", {}),
                 ("fcg", "autodiff", {}), ("fcg", "autodiff", {"cg_update": "pr"}),
                 ("bfgs", "autodiff", {}), ("avd", "richardson", {}),
                 ("avd", "richardson", {"avd_quantum": 0.5})]


@pytest.mark.parametrize("method,grad,extra", DESCENT_CASES,
                         ids=["asd", "asd-autodiff", "fcg-autodiff", "fcg-pr-autodiff",
                              "bfgs-autodiff", "avd", "avd-quantum"])
def test_descent_on_sphere_matches_reference(method, grad, extra):
    """The same key: the same draws, the same number of evaluations (every
    backtrack and restart decided alike) and the incumbent within rtol 1e-4.

    Richardson runs take the shared shim's values; even so a one-ulp
    difference in an iterate is amplified by the next Richardson difference
    (at |x| ~ 50 one ulp of f is 5e-4 against a difference of 4|x|h = 0.02),
    and only ASD's normalized steps do not feed it back. So FCG and BFGS
    run on autodiff gradients (each package differentiating its own
    sphere): the loop's logic, not Richardson's noise, is under test."""
    jf, tf = _shared_fns("sphere", 4) if grad == "richardson" else _fns("sphere", 4)
    j, t = DESCENT[method]
    # Autodiff iterations cost 3 evaluations or so: 60 keep the run far from
    # the optimum, where the Armijo tests compare values of a few ulps.
    cfg = dict(max_evals=700 if grad == "richardson" else 60, grad_mode=grad, **extra)
    jr = j(jf, jax.random.PRNGKey(5), 4, jdesc.DescentConfig(**cfg))
    tr = t(tf, prng.PRNGKey(5), 4, tdesc.DescentConfig(**cfg))
    assert tr.n_evals == jr.n_evals
    np.testing.assert_allclose(tr.value, jr.value, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tr.arg, np.asarray(jr.arg), rtol=1e-4, atol=1e-4)


def test_descent_rosenbrock_progress_and_budget():
    """All four methods make progress down the Rosenbrock valley within the
    budget plus one in-flight iteration (the reference's own bounds)."""
    _, tf = _fns("rosenbrock", 6)
    for method, (_, t) in DESCENT.items():
        res = t(tf, prng.PRNGKey(5), 6, tdesc.DescentConfig(max_evals=20_000))
        assert res.value < (1e5 if method == "avd" else 1e4), method
        assert res.n_evals <= 20_000 + 6 * 2 * 17 + 50, method


def test_adam_minimize_matches_reference():
    """Autodiff gradients (each package its own sphere): the same
    evaluations, the incumbent within rtol 1e-4."""
    jf, tf = _fns("sphere", 5)
    kw = dict(max_evals=800, lr=1.0, grad_mode="autodiff")
    jr = jadam.adam_minimize(jf, jax.random.PRNGKey(5), 5, **kw)
    tr = tadam.adam_minimize(tf, prng.PRNGKey(5), 5, **kw)
    assert tr.n_evals == jr.n_evals
    np.testing.assert_allclose(tr.value, jr.value, rtol=1e-4)


def test_adam_update_matches_reference():
    """Five Adam(W) steps on a dict of tensors (one nested), with clipping,
    weight decay and the warmup+cosine schedule: within rtol 1e-6."""
    rng = np.random.default_rng(3)
    shapes = {"w": (3, 4), "b": (4,), "blk": {"k": (2, 2)}}

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else
                rng.standard_normal(v).astype(np.float32) for k, v in tree.items()}

    def to(tree, f):
        return {k: to(v, f) if isinstance(v, dict) else f(v) for k, v in tree.items()}

    cfg = dict(lr=0.1, weight_decay=0.01, grad_clip=1.0, warmup_steps=2, total_steps=6)
    params = draw(shapes)
    jp, tp = to(params, jnp.asarray), to(params, torch.from_numpy)
    js, ts = jadam.init(jp), tadam.init(tp)
    for step in range(5):
        grads = draw(shapes)
        jp, js = jadam.update(to(grads, jnp.asarray), js, jp, jadam.AdamConfig(**cfg))
        tp, ts = tadam.update(to(grads, torch.from_numpy), ts, tp, tadam.AdamConfig(**cfg))
        np.testing.assert_allclose(float(tadam.schedule(ts.step, tadam.AdamConfig(**cfg))),
                                   float(jadam.schedule(js.step, jadam.AdamConfig(**cfg))),
                                   rtol=1e-6)
    assert int(ts.step) == int(js.step) == 5
    for t_leaf, j_leaf in zip(tadam.tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(t_leaf.numpy(), np.asarray(j_leaf), rtol=1e-6, atol=1e-7)
