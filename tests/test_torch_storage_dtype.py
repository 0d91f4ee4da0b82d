"""bfloat16 population storage (``KernelConfig(dtype="bfloat16")``) in the
port's five population kernels against the JAX package's.

The JAX kernels run in Pallas interpret mode with
``KernelConfig(dtype="bfloat16", interpret=True)``: each rounds its ``(P, D)``
operands and broadcast rows to bfloat16, computes in float32 and stores its
``(P, D)`` outputs in bfloat16. The port's plain versions (what a wrapper
runs on a CPU tensor) round the same operands with ``.to(torch.bfloat16)``.

Bounds: fitness as ``tests/test_kernels.py`` holds the kernels (1e-5
relative for ``bench_eval`` and ``de_step``, 1e-4 for michalewicz and for
the ``|a-b| / (|b|+1)`` kernels); each stored ``(P, D)`` element within one
bfloat16 ulp (a float32 result one bit apart rounds one ulp apart at
worst) and equal bits on at least 99% of them; decisions equal on every
row whose candidate fitness is clear of its comparand by the bound. The
island runs hold ``value`` and ``history`` to rtol 1e-4, as the engine
tests do, no tighter than the reference's own fused-versus-unfused gap
(1.36e-5, ``BENCH_kernels.json``). The ``gpu`` tests hold the kernels on
the card to their plain versions in both storage types.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import core as tcore  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.functions import benchmarks as tbm  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels import bench_eval as be  # noqa: E402
from repro_torch.kernels import de_step as ds  # noqa: E402
from repro_torch.kernels import eval_select as es  # noqa: E402
from repro_torch.kernels import ga_step as gs  # noqa: E402
from repro_torch.kernels import pso_step as ps  # noqa: E402
from repro_torch.kernels.autotune import KernelConfig  # noqa: E402

try:
    import jax
    import jax.numpy as jnp

    from repro import core as jcore
    from repro.kernels.autotune import KernelConfig as JKernelConfig

    # The modules: ``repro.kernels`` binds the function names over them.
    jbe, jde, jes, jga, jps = (importlib.import_module(f"repro.kernels.{m}") for m in (
        "bench_eval", "de_step", "eval_select", "ga_step", "pso_step"))
    from test_torch_engines import jax_draws  # noqa: F401
except ImportError:     # a machine with the card but without JAX
    jax = None

BF16 = KernelConfig(dtype="bfloat16")
FNS = ("sphere", "shifted_rosenbrock", "rastrigin", "michalewicz")
# (lead, P, D): odd sizes, one island and two.
SHAPES = [((), 37, 50), ((2,), 13, 130)]
FUSED_TOL = 1e-4


@pytest.fixture(autouse=True)
def _partitionable(request):
    if jax is None:
        if request.node.get_closest_marker("gpu") is None:
            pytest.skip("the comparison with the JAX package needs JAX")
        yield
        return
    with jax.threefry_partitionable(True):
        yield


def _jcfg():
    return JKernelConfig(dtype="bfloat16", interpret=True)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (np.abs(b) + 1.0), initial=0.0))


def _fit_tol(fn):
    return 1e-4 if fn == "michalewicz" else 1e-5


def _representable(x) -> bool:
    x = torch.as_tensor(np.asarray(x))
    return bool(torch.equal(x.to(torch.bfloat16).float(), x.float()))


def _assert_stored(got, want, rows=None):
    """Each element within one bfloat16 ulp of the reference's, the same
    bits on at least 99% of them, and every element bfloat16-representable
    (``rows``: the rows to compare)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if rows is not None:
        got, want = got[rows], want[rows]
    assert _representable(got) and _representable(want)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.ldexp(np.float32(1.0), np.frexp(mag)[1] - 8)
    diff = np.abs(got - want)
    assert np.all((diff <= ulp) | (np.isnan(got) & np.isnan(want)))
    if got.size:
        assert np.mean(got.view(np.uint32) == want.view(np.uint32)) >= 0.99


def _args(fn, D, rng):
    if fn == "shifted_rosenbrock":
        return rng.uniform(-80, 80, D).astype(np.float32), 390.0, -100.0, 100.0
    f = tbm.FUNCTIONS[fn]
    return None, 0.0, max(f.lo, -5.0), min(f.hi, 5.0)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _per_island(fn_jax, lead, *arrays, **kw):
    """The JAX kernel (which takes ``(P, D)``) once per island, stacked."""
    if not lead:
        return fn_jax(*arrays, **kw)
    outs = [fn_jax(*(a if a is None or np.ndim(a) == 0 else a[i] for a in arrays), **kw)
            for i in range(lead[0])]
    if not isinstance(outs[0], (tuple, list)):
        return np.stack([np.asarray(o) for o in outs])
    return tuple(np.stack([np.asarray(o[k]) for o in outs]) for k in range(len(outs[0])))


def _clear(cand, comp, tol):
    cand, comp = np.asarray(cand, np.float64), np.asarray(comp, np.float64)
    return np.abs(cand - comp) > tol * (np.abs(comp) + 1.0)


# -- bench_eval -----------------------------------------------------------------

@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("lead,P,D", SHAPES)
def test_bench_eval_bf16_matches_pallas(fn, lead, P, D):
    rng = np.random.default_rng(P + D)
    shift, bias, lo, hi = _args(fn, D, rng)
    x = rng.uniform(lo, hi, (*lead, P, D)).astype(np.float32).reshape(-1, D)
    want = jbe.bench_eval(_j(x), fn, _j(shift), bias, kernel_cfg=_jcfg())
    got = be.bench_eval(_t(x), fn, _t(shift), bias, kernel_cfg=BF16)
    assert _rel(got.numpy(), want) < _fit_tol(fn)
    # The rounding is what the reference does: the float32 route differs.
    f32 = be.bench_eval(_t(x), fn, _t(shift), bias)
    assert not np.array_equal(f32.numpy(), got.numpy())


# -- de_step --------------------------------------------------------------------

@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("lead,P,D", SHAPES)
def test_de_step_bf16_matches_pallas(fn, lead, P, D):
    rng = np.random.default_rng(3 * P + D)
    shift, bias, lo, hi = _args(fn, D, rng)
    pop = rng.uniform(lo, hi, (*lead, P, D)).astype(np.float32)
    fit = be.bench_eval_ref(_t(pop), fn, _t(shift), bias).numpy()
    u = rng.uniform(0, 1, (*lead, P, D)).astype(np.float32)
    idx = ((np.arange(P) + 1 + rng.integers(0, P - 1, (3, *lead, P))) % P).astype(np.int32)
    jr = rng.integers(0, D, (*lead, P)).astype(np.int32)
    kw = dict(w=0.5, px=0.3, lo=lo, hi=hi)
    got = ds.de_step(_t(pop), _t(fit), _t(idx), _t(u), _t(jr), fn, _t(shift), bias,
                     kernel_cfg=BF16, **kw)
    if lead:
        want = _per_island(
            lambda p, f, i, uu, j, s: jde.de_step(_j(p), _j(f), _j(i), _j(uu), _j(j), fn,
                                                  _j(s), bias, kernel_cfg=_jcfg(), **kw),
            lead, pop, fit, np.moveaxis(idx, 1, 0), u, jr, None if shift is None else
            np.broadcast_to(shift, (*lead, D)))
    else:
        want = jde.de_step(_j(pop), _j(fit), _j(idx), _j(u), _j(jr), fn, _j(shift), bias,
                           kernel_cfg=_jcfg(), **kw)
    npop, nfit = got[0].numpy(), got[1].numpy()
    jpop, jfit = np.asarray(want[0]), np.asarray(want[1])
    trial = ds.trial_ref(be.storage(_t(pop), "bfloat16"), _t(idx), be.storage(_t(u), "bfloat16"),
                         _t(jr), lo=lo, hi=hi, w=0.5, px=0.3)
    # The trial is evaluated before it is rounded; the shift is rounded.
    tfit = be.bench_eval_ref(trial, fn, be.storage(_t(shift), "bfloat16"), bias).numpy()
    took, jtook = nfit != fit, jfit != fit
    clear = _clear(tfit, fit, _fit_tol(fn))
    assert np.array_equal(took[clear], jtook[clear])
    same = took == jtook
    assert _rel(nfit[same], jfit[same]) < _fit_tol(fn)
    _assert_stored(npop, jpop, same)
    assert 0 < int(took.sum()) < took.size


# -- pso_step -------------------------------------------------------------------

@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("lead,P,D", SHAPES)
def test_pso_step_bf16_matches_pallas(fn, lead, P, D):
    rng = np.random.default_rng(5 * P + D)
    shift, bias, lo, hi = _args(fn, D, rng)
    sh = (*lead, P, D)
    x = rng.uniform(lo, hi, sh).astype(np.float32)
    v = (0.1 * rng.uniform(-1, 1, sh)).astype(np.float32)
    pb = rng.uniform(lo, hi, sh).astype(np.float32)
    pbf = be.bench_eval_ref(_t(pb), fn, _t(shift), bias).numpy()
    r1, r2 = (rng.uniform(0, 1, sh).astype(np.float32) for _ in range(2))
    g = rng.uniform(lo, hi, (*lead, D)).astype(np.float32)
    kw = dict(w=0.6, fp=1.3, fg=0.7, vmax=0.4 * (hi - lo), lo=lo, hi=hi)
    got = [t.numpy() for t in ps.pso_step(*map(_t, (x, v, pb, pbf, r1, r2, g)), fn,
                                          _t(shift), bias, kernel_cfg=BF16, **kw)]
    want = _per_island(
        lambda *a: jps.pso_step(*map(_j, a), fn=fn, shift=_j(shift), bias=bias,
                                kernel_cfg=_jcfg(), **kw), lead, x, v, pb, pbf, r1, r2, g)
    want = [np.asarray(w) for w in want]
    for k in (0, 1):                       # position and velocity
        _assert_stored(got[k], want[k])
    assert _rel(got[2], want[2]) < FUSED_TOL
    took, jtook = got[4] != pbf, want[4] != pbf
    clear = _clear(want[2], pbf, FUSED_TOL)
    assert np.array_equal(took[clear], jtook[clear])
    same = took == jtook
    _assert_stored(got[3], want[3], same)
    assert _rel(got[4][same], want[4][same]) < FUSED_TOL


# -- ga_step --------------------------------------------------------------------

@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("lead,P,D", SHAPES)
def test_ga_step_bf16_matches_pallas(fn, lead, P, D):
    rng = np.random.default_rng(7 * P + D)
    shift, bias, lo, hi = _args(fn, D, rng)
    sh = (*lead, P, D)
    p1, p2, slot = (rng.uniform(lo, hi, sh).astype(np.float32) for _ in range(3))
    slot_f = be.bench_eval_ref(_t(slot), fn, _t(shift), bias).numpy()
    cut = rng.integers(0, D + 1, (*lead, P)).astype(np.int32)
    co = rng.uniform(0, 1, (*lead, P)).astype(np.float32)
    um = rng.uniform(0, 1, sh).astype(np.float32)
    nz = rng.normal(0, 1, sh).astype(np.float32)
    kw = dict(pc=0.7, pm=0.3, sigma_m=0.1 * (hi - lo), lo=lo, hi=hi)
    arrs = (p1, p2, slot, slot_f, cut, co, um, nz)
    got = [t.numpy() for t in gs.ga_step(*map(_t, arrs), fn, _t(shift), bias,
                                         kernel_cfg=BF16, **kw)]
    want = _per_island(
        lambda *a: jga.ga_step(*map(_j, a), fn=fn, shift=_j(shift), bias=bias,
                               kernel_cfg=_jcfg(), **kw), lead, *arrs)
    want = [np.asarray(w) for w in want]
    # The child's fitness: the new slot fitness where either package took it.
    cfit = np.where(got[2], got[1], want[1])
    clear = _clear(cfit, slot_f, FUSED_TOL) & (got[2] | want[2])
    assert np.array_equal(got[2][clear], want[2][clear])
    same = got[2] == want[2]
    _assert_stored(got[0], want[0], same)
    assert _rel(got[1][same], want[1][same]) < FUSED_TOL


# -- eval_select ----------------------------------------------------------------

@pytest.mark.parametrize("metropolis", [False, True], ids=["greedy", "metropolis"])
@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("lead,P,D", SHAPES)
def test_eval_select_bf16_matches_pallas(fn, lead, P, D, metropolis):
    rng = np.random.default_rng(11 * P + D)
    shift, bias, lo, hi = _args(fn, D, rng)
    sh = (*lead, P, D)
    pop = rng.uniform(lo, hi, sh).astype(np.float32)
    trial = np.clip(pop + 0.05 * (hi - lo) * rng.normal(0, 1, sh), lo, hi).astype(np.float32)
    fit = be.bench_eval_ref(_t(pop), fn, _t(shift), bias).numpy()
    th = None
    if metropolis:
        th = (-np.abs(fit).mean() * 0.05 * np.log(rng.uniform(0, 1, (*lead, P)))
              ).astype(np.float32)
    got = [t.numpy() for t in es.eval_select(_t(pop), _t(fit), _t(trial), _t(th), fn,
                                             _t(shift), bias, kernel_cfg=BF16)]
    want = _per_island(
        lambda p, f, t, h: jes.eval_select(_j(p), _j(f), _j(t), _j(h), fn=fn,
                                           shift=_j(shift), bias=bias, kernel_cfg=_jcfg()),
        lead, pop, fit, trial, th)
    want = [np.asarray(w) for w in want]
    tfit = be.bench_eval_ref(_t(trial), fn, _t(shift), bias, dtype="bfloat16").numpy()
    dF = tfit - fit
    clear = _clear(tfit, fit, FUSED_TOL)
    if th is not None:
        clear &= np.abs(dF - th) > FUSED_TOL * (np.abs(th) + 1.0)
    assert np.array_equal(got[2][clear], want[2][clear])
    same = got[2] == want[2]
    _assert_stored(got[0], want[0], same)
    assert _rel(got[1][same], want[1][same]) < FUSED_TOL


# -- one fused generation, and island runs through ExecutorConfig -----------------

def _fns(fn, dim):
    from repro.functions import benchmarks as jbm
    from repro_torch import convert
    if fn == "shifted_rosenbrock":
        jf = jbm.make_shifted_rosenbrock(dim)
        return jf, convert.function_from_numpy(fn, np.asarray(jf.shift), jf.bias)
    return jbm.FUNCTIONS[fn], tbm.FUNCTIONS[fn]


@pytest.mark.parametrize("algo", ["de", "pso", "ga", "sa"])
def test_fused_generation_stores_bf16(algo):
    """After one fused generation at bfloat16 storage every population
    element the kernel wrote (and PSO's velocities and personal bests) is
    bfloat16-representable; the float32 route's are not. DE, PSO and SA
    write every row; GA writes the slots its offspring compete for."""
    _, f = _fns("rastrigin", 24)
    stored = ("pop", "vel", "pbest") if algo == "pso" else ("pop",)
    for cfg, want in ((BF16, True), (None, False)):
        a = tcore.ALGORITHMS[algo](f=f, evaluator=f.fn, pop=12, dim=24, fused=True,
                                   kernel_cfg=cfg)
        st0 = a.init(prng.split(prng.PRNGKey(4), 2))
        st = a.step_override(st0, prng.split(prng.PRNGKey(5), 2))
        for k in stored:
            x = st[k]
            assert x.dtype == torch.float32
            if algo == "ga":
                x = x[(x != st0[k]).any(-1)]
                assert len(x) > 0
            assert _representable(x.numpy()) == want, (k, cfg)


@pytest.mark.parametrize("algo", ["de", "pso", "ga", "sa"])
def test_island_run_bf16_matches_jax(algo, request):
    """Two islands, ring migration, fused, bfloat16 storage set only on
    ExecutorConfig.kernel, against the reference's pallas backend."""
    if algo in ("ga", "sa"):
        request.getfixturevalue("jax_draws")
    fn = "shifted_rosenbrock" if algo == "de" else "rastrigin"
    jf, tf = _fns(fn, 8)
    cfg = dict(n_islands=2, pop=16, dim=8, sync_every=3, migration="ring",
               max_evals=2 * 16 * 10)
    jo = jcore.IslandOptimizer(jcore.ALGORITHMS[algo], jcore.IslandConfig(**cfg),
                               params={"fused": True},
                               exec_cfg=jcore.ExecutorConfig(backend="pallas",
                                                             kernel=_jcfg()))
    to = tcore.IslandOptimizer(tcore.ALGORITHMS[algo], tcore.IslandConfig(**cfg),
                               params={"fused": True},
                               exec_cfg=tcore.ExecutorConfig(backend="cuda", kernel=BF16),
                               device="cpu")
    jr, tr = jo.minimize(jf, jax.random.PRNGKey(3)), to.minimize(tf, prng.PRNGKey(3))
    assert tr.n_evals == jr.n_evals and tr.n_gens == jr.n_gens
    np.testing.assert_allclose(tr.value, jr.value, rtol=FUSED_TOL)
    np.testing.assert_allclose(tr.history, np.asarray(jr.history), rtol=FUSED_TOL)
    assert _representable(np.asarray(tr.arg))


# -- the kernels on the card ----------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


CARD_SHAPES = [((), 37, 50), ((), 800, 1000), ((8,), 800, 1000), ((2,), 13, 130),
               ((), 16, 4100)]
DTYPES = ["float32", "bfloat16"]


def _card_inputs(lead, P, D, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g, device=dev)   # noqa: E731
    sh = (*lead, P, D)
    pop = u(*sh) * 200 - 100
    shift = u(D) * 160 - 80
    return g, u, sh, pop, shift


def _card_stored(got, want, rows=None):
    _assert_stored(got.cpu().numpy(), want.cpu().numpy(),
                   None if rows is None else rows.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lead,P,D", CARD_SHAPES)
def test_bench_eval_kernel_matches_plain_at_storage(cuda_dev, lead, P, D, dtype):
    _, _, _, pop, shift = _card_inputs(lead, P, D, cuda_dev, P)
    pop = pop.reshape(-1, D)
    cfg = KernelConfig(dtype=dtype)
    n, nb = be.LAUNCHES, be.BF16_LAUNCHES
    got = be.bench_eval(pop, "shifted_rosenbrock", shift, 390.0, kernel_cfg=cfg)
    assert be.LAUNCHES == n + 1 and be.BF16_LAUNCHES == nb + (dtype == "bfloat16")
    want = be.bench_eval_ref(pop, "shifted_rosenbrock", shift, 390.0, dtype=dtype)
    assert _rel(got.cpu(), want.cpu()) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lead,P,D", CARD_SHAPES)
def test_de_step_kernel_matches_plain_at_storage(cuda_dev, lead, P, D, dtype):
    g, u, sh, pop, shift = _card_inputs(lead, P, D, cuda_dev, P + 1)
    args = ("shifted_rosenbrock", shift, 390.0)
    fit = be.bench_eval_ref(pop, *args)
    idx = (torch.arange(P, device=cuda_dev) + 1
           + torch.randint(0, P - 1, (3, *lead, P), generator=g, device=cuda_dev)) % P
    uu = u(*sh)
    jr = torch.randint(0, D, (*lead, P), generator=g, device=cuda_dev)
    cfg = KernelConfig(dtype=dtype)
    npop, nfit = ds.de_step(pop, fit, idx, uu, jr, *args, kernel_cfg=cfg)
    rpop, rfit = ds.de_step_ref(pop, fit, idx, uu, jr, *args, dtype=dtype)
    s = lambda t: be.storage(t, dtype)   # noqa: E731
    tfit = be.bench_eval_ref(ds.trial_ref(s(pop), idx, s(uu), jr), args[0], s(shift), args[2])
    clear = (tfit - fit).abs() > 1e-5 * (fit.abs() + 1.0)
    agree = (nfit != fit) == (rfit != fit)
    assert bool(agree[clear].all())
    assert _rel(nfit[agree].cpu(), rfit[agree].cpu()) < 1e-5
    if dtype == "float32":
        assert float((npop - rpop).abs()[agree].max()) < 1e-5
    else:
        _card_stored(npop, rpop, agree)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lead,P,D", CARD_SHAPES)
def test_pso_step_kernel_matches_plain_at_storage(cuda_dev, lead, P, D, dtype):
    g, u, sh, x, shift = _card_inputs(lead, P, D, cuda_dev, P + 2)
    args = ("shifted_rosenbrock", shift, 390.0)
    v, pb, r1, r2 = u(*sh) - 0.5, u(*sh) * 200 - 100, u(*sh), u(*sh)
    pbf = be.bench_eval_ref(pb, *args)
    gb = u(*lead, D) * 200 - 100
    kw = dict(w=0.6, fp=1.3, fg=0.7, vmax=80.0)
    got = ps.pso_step(x, v, pb, pbf, r1, r2, gb, *args, kernel_cfg=KernelConfig(dtype=dtype),
                      **kw)
    want = ps.pso_step_ref(x, v, pb, pbf, r1, r2, gb, *args, dtype=dtype, **kw)
    assert _rel(got[2].cpu(), want[2].cpu()) < FUSED_TOL
    took, rtook = got[4] != pbf, want[4] != pbf
    clear = (want[2] - pbf).abs() > FUSED_TOL * (pbf.abs() + 1.0)
    assert bool((took == rtook)[clear].all())
    if dtype == "bfloat16":
        for k in (0, 1):
            _card_stored(got[k], want[k])
        _card_stored(got[3], want[3], took == rtook)
    else:
        for k in (0, 1):
            assert torch.equal(got[k], want[k])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lead,P,D", CARD_SHAPES)
def test_ga_step_kernel_matches_plain_at_storage(cuda_dev, lead, P, D, dtype):
    g, u, sh, p1, shift = _card_inputs(lead, P, D, cuda_dev, P + 3)
    args = ("shifted_rosenbrock", shift, 390.0)
    p2, slot = u(*sh) * 200 - 100, u(*sh) * 200 - 100
    slot_f = be.bench_eval_ref(slot, *args)
    cut = torch.randint(0, D + 1, (*lead, P), generator=g, device=cuda_dev)
    co, um, nz = u(*lead, P), u(*sh), torch.randn(*sh, generator=g, device=cuda_dev)
    kw = dict(pc=0.7, pm=0.3, sigma_m=20.0)
    got = gs.ga_step(p1, p2, slot, slot_f, cut, co, um, nz, *args,
                     kernel_cfg=KernelConfig(dtype=dtype), **kw)
    want = gs.ga_step_ref(p1, p2, slot, slot_f, cut, co, um, nz, *args, dtype=dtype, **kw)
    cfit = torch.where(got[2], got[1], want[1])
    clear = ((cfit - slot_f).abs() > FUSED_TOL * (slot_f.abs() + 1.0)) & (got[2] | want[2])
    assert bool((got[2] == want[2])[clear].all())
    same = got[2] == want[2]
    assert _rel(got[1][same].cpu(), want[1][same].cpu()) < FUSED_TOL
    _card_stored(got[0], want[0], same) if dtype == "bfloat16" else \
        torch.testing.assert_close(got[0][same], want[0][same], rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lead,P,D", CARD_SHAPES)
def test_eval_select_kernel_matches_plain_at_storage(cuda_dev, lead, P, D, dtype):
    g, u, sh, pop, shift = _card_inputs(lead, P, D, cuda_dev, P + 4)
    args = ("shifted_rosenbrock", shift, 390.0)
    trial = (pop + 5.0 * torch.randn(*sh, generator=g, device=cuda_dev)).clamp(-100, 100)
    fit = be.bench_eval_ref(pop, *args)
    th = -fit.abs().mean() * 0.05 * torch.log(u(*lead, P))
    got = es.eval_select(pop, fit, trial, th, *args, kernel_cfg=KernelConfig(dtype=dtype))
    want = es.eval_select_ref(pop, fit, trial, th, *args, dtype=dtype)
    tfit = be.bench_eval_ref(trial, *args, dtype=dtype)
    dF = tfit - fit
    clear = ((dF.abs() > FUSED_TOL * (fit.abs() + 1.0))
             & ((dF - th).abs() > FUSED_TOL * (th.abs() + 1.0)))
    assert bool((got[2] == want[2])[clear].all())
    same = got[2] == want[2]
    assert _rel(got[1][same].cpu(), want[1][same].cpu()) < FUSED_TOL
    assert torch.equal(got[0][same], want[0][same])


@pytest.mark.gpu
def test_nan_lane_survives_bf16_storage(cuda_dev):
    """A NaN velocity stays NaN through pso_step's bfloat16 store, and a
    NaN DE trial keeps its parent, as in float32."""
    P, D = 8, 64
    x = torch.zeros(P, D, device=cuda_dev)
    v = torch.zeros_like(x)
    v[0, 3] = float("nan")
    pbf = torch.full((P,), 1e30, device=cuda_dev)
    got = ps.pso_step(x, v, x, pbf, x, x, x[0], "sphere", kernel_cfg=BF16, w=1.0)
    assert torch.isnan(got[1][0, 3]) and torch.isnan(got[2][0])
    pop = torch.ones(P, D, device=cuda_dev)
    pop[1, 5] = float("nan")
    fit = torch.full((P,), float(D), device=cuda_dev)
    idx = torch.stack([torch.full((P,), 1, device=cuda_dev)] * 3)
    npop, nfit = ds.de_step(pop, fit, idx, torch.zeros_like(pop),
                            torch.full((P,), 5, device=cuda_dev), "sphere", kernel_cfg=BF16)
    assert torch.equal(nfit, fit) and torch.equal(npop[0], pop[0])
