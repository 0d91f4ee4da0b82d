"""The port's fused-generation kernels — ``eval_select``, ``pso_step``,
``ga_step`` — against the JAX package's.

On the CPU each wrapper runs its plain PyTorch version; those are held
against ``repro.kernels.ref`` for every eval tag on ``tests/test_kernels.py``'s
odd shapes, and against the Pallas kernels (interpret mode, through
``repro.kernels.ops``) for every tag at one shape. Jitted, XLA contracts
PSO's velocity update into fused multiply-adds; the port rounds it the same
way, so against the Pallas kernel and the jitted ``ref`` its velocities and
positions must be bit-exact.
The bound is the one ``tests/test_kernels.py`` sets for these kernels:
``max |a - b| / (|b| + 1) < 1e-4``, with identical accept/take decisions on
every row whose candidate fitness is clear of its comparand by that
tolerance. The CUDA kernels are compared with the plain versions by the
``gpu`` tests, which skip without a Hopper GPU. They need no JAX (the
inputs' fitness then comes from the port's plain ``bench_eval``), so the
file also runs where JAX is not installed (the JAX comparisons skip there):

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_fused_kernels.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.functions import benchmarks as tbm  # noqa: E402
from repro_torch.kernels import bench_eval as be  # noqa: E402
from repro_torch.kernels import eval_select as es  # noqa: E402
from repro_torch.kernels import ga_step as gs  # noqa: E402
from repro_torch.kernels import pso_step as ps  # noqa: E402

try:
    import jax.numpy as jnp

    from repro.kernels import ops, ref
except ImportError:     # a machine with the card but without JAX
    jnp = None

TAGS = list(be.EVAL_TAGS)
SHAPES = [(5, 1), (37, 64), (99, 100), (130, 333)]
TOL = 1e-4


@pytest.fixture(autouse=True)
def _needs_jax(request):
    if jnp is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the comparison with the JAX package needs JAX")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (np.abs(b) + 1.0))) if a.size else 0.0


def _args(fn, D):
    """(shift, bias, lo, hi) for an eval tag: the Table I shift and bias for
    shifted_rosenbrock, the clipped [-5, 5] box of ``test_kernels.py``
    otherwise (michalewicz holds its bound only there)."""
    if fn == "shifted_rosenbrock":
        return np.asarray(tbm.shift_vector(D)), 390.0, -100.0, 100.0
    f = tbm.FUNCTIONS[fn]
    return None, 0.0, max(f.lo, -5.0), min(f.hi, 5.0)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _fit(x, fn, shift, bias):
    if jnp is None:     # the port's plain version, held to JAX on the CPU
        return be.bench_eval_ref(_t(x), fn, _t(shift), bias).numpy()
    return np.asarray(ref.bench_eval_ref(jnp.asarray(x), fn, _j(shift), bias))


def _clear(cand, comp):
    """Rows whose candidate value is clear of its comparand by the bound."""
    cand, comp = np.asarray(cand, np.float64), np.asarray(comp, np.float64)
    with np.errstate(invalid="ignore"):
        return ~(np.abs(cand - comp) <= TOL * (np.abs(comp) + 1.0))


def _decisions_agree(got, want, clear):
    """Decisions must agree on every clear row; returns the rows that were
    not clear."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(got[clear], want[clear]), np.nonzero(got != want)
    return int((~clear).sum())


# -- eval_select -----------------------------------------------------------------

def _es_inputs(fn, P, D, seed, metropolis):
    rng = np.random.default_rng(seed)
    shift, bias, lo, hi = _args(fn, D)
    pop = rng.uniform(lo, hi, (P, D)).astype(np.float32)
    trial = rng.uniform(lo, hi, (P, D)).astype(np.float32)
    fit = _fit(pop, fn, shift, bias)
    th = None
    if metropolis:
        # -T ln(u) at a temperature of half the median |dF|, so that some
        # uphill moves pass and some fail; one u exactly 0 (threshold +inf:
        # the row must accept).
        u = rng.uniform(0, 1, P).astype(np.float32)
        u[0] = 0.0
        T = np.float32(0.5 * np.median(np.abs(_fit(trial, fn, shift, bias) - fit)))
        with np.errstate(divide="ignore"):
            th = (-T * np.log(u)).astype(np.float32)
    return pop, fit, trial, th, shift, bias


def _es_clear(fit, tfit, th):
    clear = _clear(tfit, fit)
    if th is not None:
        clear &= _clear(tfit - fit, th) | ~np.isfinite(th)
    return clear


def _check_es(got, want, pop, fit, trial, th, fn, shift, bias):
    tfit = _fit(trial, fn, shift, bias)
    _decisions_agree(got[2].numpy(), want[2], _es_clear(fit, tfit, th))
    if th is not None:
        assert bool(got[2][0])               # u = 0: threshold +inf
    same = got[2].numpy() == np.asarray(want[2])
    assert _rel(got[0].numpy()[same], np.asarray(want[0])[same]) < TOL
    assert _rel(got[1].numpy()[same], np.asarray(want[1])[same]) < TOL
    assert 0 < int(got[2].sum()) < len(fit) or len(fit) < 8, int(got[2].sum())


@pytest.mark.parametrize("metropolis", [False, True], ids=["greedy", "metropolis"])
@pytest.mark.parametrize("P,D", SHAPES)
def test_eval_select_matches_ref(P, D, metropolis):
    for k, fn in enumerate(TAGS):
        pop, fit, trial, th, shift, bias = _es_inputs(fn, P, D, P + D + k, metropolis)
        want = ref.eval_select_ref(_j(pop), _j(fit), _j(trial), _j(th), fn,
                                   _j(shift), bias)
        got = es.eval_select(_t(pop), _t(fit), _t(trial), _t(th), fn, _t(shift), bias)
        assert got[0].shape == (P, D) and got[2].dtype == torch.bool
        _check_es(got, want, pop, fit, trial, th, fn, shift, bias)


@pytest.mark.parametrize("fn", TAGS)
def test_eval_select_matches_pallas_interpret(fn):
    pop, fit, trial, th, shift, bias = _es_inputs(fn, 37, 100, 7, True)
    want = ops.eval_select(_j(pop), _j(fit), _j(trial), _j(th), fn=fn,
                           shift=_j(shift), bias=bias)
    got = es.eval_select(_t(pop), _t(fit), _t(trial), _t(th), fn, _t(shift), bias)
    _check_es(got, want, pop, fit, trial, th, fn, shift, bias)


# -- pso_step ---------------------------------------------------------------------

def _pso_inputs(fn, P, D, seed):
    rng = np.random.default_rng(seed)
    shift, bias, lo, hi = _args(fn, D)
    x = rng.uniform(lo, hi, (P, D)).astype(np.float32)
    v = (0.1 * rng.uniform(-1, 1, (P, D))).astype(np.float32)
    pb = rng.uniform(lo, hi, (P, D)).astype(np.float32)
    pbf = _fit(pb, fn, shift, bias)
    r1, r2 = (rng.uniform(0, 1, (P, D)).astype(np.float32) for _ in range(2))
    g = pb[np.argmin(pbf)].copy()
    kw = dict(bias=bias, w=0.6, fp=1.3, fg=0.7, vmax=0.4 * (hi - lo), lo=lo, hi=hi)
    return (x, v, pb, pbf, r1, r2, g), shift, kw


def _check_pso(got, want, pbf, exact=True):
    got = [t.numpy() for t in got]
    want = [np.asarray(t) for t in want]
    if exact:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert _rel(got[0], want[0]) < TOL and _rel(got[1], want[1]) < TOL
    assert _rel(got[2], want[2]) < TOL
    took_t, took_j = got[4] != pbf, want[4] != pbf
    _decisions_agree(took_t, took_j, _clear(want[2], pbf))
    same = took_t == took_j
    assert _rel(got[3][same], want[3][same]) < TOL
    assert _rel(got[4][same], want[4][same]) < TOL


@pytest.mark.parametrize("P,D", SHAPES)
def test_pso_step_matches_ref(P, D):
    for k, fn in enumerate(TAGS):
        arrs, shift, kw = _pso_inputs(fn, P, D, P + D + k)
        want = ref.pso_step_ref(*map(_j, arrs), fn, _j(shift), **kw)
        got = ps.pso_step(*map(_t, arrs), fn, _t(shift), **kw)
        _check_pso(got, want, arrs[3], exact=False)


@pytest.mark.parametrize("fn", TAGS)
def test_pso_step_matches_pallas_interpret(fn):
    arrs, shift, kw = _pso_inputs(fn, 37, 100, 11)
    got = ps.pso_step(*map(_t, arrs), fn, _t(shift), **kw)
    for use_pallas in (True, False):
        want = ops.pso_step(*map(_j, arrs), fn=fn, shift=_j(shift),
                            use_pallas=use_pallas, **kw)
        _check_pso(got, want, arrs[3])


# -- ga_step ----------------------------------------------------------------------

def _ga_inputs(fn, N, D, seed):
    rng = np.random.default_rng(seed)
    shift, bias, lo, hi = _args(fn, D)
    p1, p2, slot = (rng.uniform(lo, hi, (N, D)).astype(np.float32) for _ in range(3))
    slot_f = np.array(_fit(slot, fn, shift, bias))
    slot_f[:2] = np.inf                      # dead slots: any child takes them
    cut = rng.integers(1, max(D, 2), N).astype(np.int32)
    co = rng.uniform(0, 1, N).astype(np.float32)
    um = rng.uniform(0, 1, (N, D)).astype(np.float32)
    nz = rng.normal(size=(N, D)).astype(np.float32)
    kw = dict(bias=bias, pc=0.7, pm=0.3, sigma_m=0.05 * (hi - lo), lo=lo, hi=hi)
    return (p1, p2, slot, slot_f, cut, co, um, nz), shift, kw


def _ga_child(p1, p2, slot, slot_f, cut, co, um, nz, kw):
    """The children ga_step builds, by the plain version's arithmetic."""
    child = gs.crossover(p1, p2, cut, co, kw["pc"])
    child = child + torch.where(um < kw["pm"], kw["sigma_m"] * nz, 0.0)
    return torch.clamp(child, kw["lo"], kw["hi"])


def _check_ga(got, want, arrs, fn, shift, kw):
    cfit = _fit(_ga_child(*map(_t, arrs), kw).numpy(), fn, shift, kw["bias"])
    _decisions_agree(got[2].numpy(), want[2], _clear(cfit, arrs[3]))
    assert bool(got[2][:2].all())
    same = got[2].numpy() == np.asarray(want[2])
    # Slot rows carry no evaluation: bit-exact wherever the decisions agree.
    np.testing.assert_array_equal(got[0].numpy()[same], np.asarray(want[0])[same])
    assert _rel(got[1].numpy()[same], np.asarray(want[1])[same]) < TOL


@pytest.mark.parametrize("N,D", SHAPES)
def test_ga_step_matches_ref(N, D):
    for k, fn in enumerate(TAGS):
        arrs, shift, kw = _ga_inputs(fn, N, D, N + D + k)
        want = ref.ga_step_ref(*map(_j, arrs), fn, _j(shift), **kw)
        got = gs.ga_step(*map(_t, arrs), fn, _t(shift), **kw)
        assert got[2].dtype == torch.bool
        _check_ga(got, want, arrs, fn, shift, kw)


@pytest.mark.parametrize("fn", TAGS)
def test_ga_step_matches_pallas_interpret(fn):
    arrs, shift, kw = _ga_inputs(fn, 37, 100, 13)
    want = ops.ga_step(*map(_j, arrs), fn=fn, shift=_j(shift), **kw)
    got = gs.ga_step(*map(_t, arrs), fn, _t(shift), **kw)
    _check_ga(got, want, arrs, fn, shift, kw)


# -- island stacking, dispatch ------------------------------------------------------

def test_island_stacked_equals_per_island():
    """One call over (I, P, D) gives each island's own result; pso_step's
    gbest is per island."""
    I, P, D, fn = 3, 12, 16, "rastrigin"
    per = [_pso_inputs(fn, P, D, s)[0] for s in range(I)]
    stacked = [torch.from_numpy(np.stack(a)) for a in zip(*per)]
    out = ps.pso_step(*stacked, fn)
    for i in range(I):
        for a, b in zip(out, ps.pso_step(*map(_t, per[i]), fn)):
            assert torch.equal(a[i], b)
    per = [_ga_inputs(fn, P, D, s)[0] for s in range(I)]
    stacked = [torch.from_numpy(np.stack(a)) for a in zip(*per)]
    out = gs.ga_step(*stacked, fn)
    for i in range(I):
        for a, b in zip(out, gs.ga_step(*map(_t, per[i]), fn)):
            assert torch.equal(a[i], b)
    per = [_es_inputs(fn, P, D, s, True)[:4] for s in range(I)]
    stacked = [torch.from_numpy(np.stack(a)) for a in zip(*per)]
    out = es.eval_select(*stacked, fn=fn)
    for i in range(I):
        for a, b in zip(out, es.eval_select(*map(_t, per[i]), fn=fn)):
            assert torch.equal(a[i], b)


def test_cpu_tensors_run_the_plain_version_and_tags_are_checked():
    before = (es.LAUNCHES, ps.LAUNCHES, gs.LAUNCHES)
    pop, fit, trial, th, _, _ = _es_inputs("sphere", 8, 4, 0, True)
    es.eval_select(_t(pop), _t(fit), _t(trial), _t(th), "sphere")
    ps.pso_step(*map(_t, _pso_inputs("sphere", 8, 4, 0)[0]), "sphere")
    gs.ga_step(*map(_t, _ga_inputs("sphere", 8, 4, 0)[0]), "sphere")
    assert (es.LAUNCHES, ps.LAUNCHES, gs.LAUNCHES) == before
    for call in (lambda: es.eval_select(_t(pop), _t(fit), _t(trial), fn="weierstrass"),
                 lambda: ps.pso_step(*map(_t, _pso_inputs("sphere", 8, 4, 0)[0]),
                                     "weierstrass"),
                 lambda: gs.ga_step(*map(_t, _ga_inputs("sphere", 8, 4, 0)[0]),
                                    "weierstrass")):
        with pytest.raises(ValueError, match="weierstrass"):
            call()


# -- on the card ---------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _cuda(arrs, dev):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrs]


@pytest.mark.gpu
@pytest.mark.parametrize("fn", TAGS)
@pytest.mark.parametrize("P,D", [(800, 1000), (200, 1000), (37, 100), (5, 1),
                                 (16, 4100), (16, 1027), (100, 1001)])
def test_fused_kernels_match_plain_on_card(cuda_dev, fn, P, D):
    """Each kernel against its plain version on the same card tensors:
    decisions identical on clear rows, positions and children bit-exact.
    D = 4100 and 1027 are past the staging cap of eval_row.cuh (ga_step's
    and eval_select's stream kernels, 16-byte and scalar slots)."""
    shift = None if fn != "shifted_rosenbrock" else tbm.shift_vector(D, device=cuda_dev)
    np_shift = None if shift is None else shift.cpu().numpy()
    pop, fit, trial, th, _, bias = _es_inputs(fn, P, D, P, True)
    args = _cuda((pop, fit, trial, th), cuda_dev)
    n = es.LAUNCHES
    got = es.eval_select(*args, fn, shift, bias)
    assert es.LAUNCHES == n + 1
    want = es.eval_select_ref(*args, fn, shift, bias)
    tfit = _fit(trial, fn, np_shift, bias)
    _decisions_agree(got[2].cpu(), want[2].cpu(), _es_clear(fit, tfit, th))
    same = (got[2] == want[2]).cpu().numpy()
    assert _rel(got[1].cpu()[same], want[1].cpu()[same]) < TOL

    arrs, _, kw = _pso_inputs(fn, P, D, P)
    args = _cuda(arrs, cuda_dev)
    n = ps.LAUNCHES
    got = ps.pso_step(*args, fn, shift, **kw)
    assert ps.LAUNCHES == n + 1
    want = ps.pso_step_ref(*args, fn, shift, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _rel(got[2].cpu(), want[2].cpu()) < TOL
    _decisions_agree((got[4] != args[3]).cpu(), (want[4] != args[3]).cpu(),
                     _clear(want[2].cpu(), arrs[3]))

    arrs, _, kw = _ga_inputs(fn, P, D, P)
    args = _cuda(arrs, cuda_dev)
    n = gs.LAUNCHES
    got = gs.ga_step(*args, fn, shift, **kw)
    assert gs.LAUNCHES == n + 1
    want = gs.ga_step_ref(*args, fn, shift, **kw)
    cfit = be.bench_eval_ref(_ga_child(*args, kw), fn, shift, bias)
    _decisions_agree(got[2].cpu(), want[2].cpu(), _clear(cfit.cpu(), arrs[3]))
    same = got[2] == want[2]
    assert torch.equal(got[0][same], want[0][same])
    assert _rel(got[1][same].cpu(), want[1][same].cpu()) < TOL
