"""The port's kernel wrappers against the JAX package's kernels.

On the CPU each wrapper runs its plain PyTorch version; those are held
against ``repro.kernels.ref`` on ``tests/test_kernels.py``'s shapes and
bounds, and against the Pallas kernels (interpret mode, through
``repro.kernels.ops``) at one shape each. The CUDA kernels themselves are
compared with the plain versions by the ``gpu`` tests, which skip without a
Hopper GPU. They need no JAX, so the file also runs where JAX is not
installed (the JAX comparisons skip there):

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels.py
"""
import math
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.functions import benchmarks as tbm  # noqa: E402
from repro_torch.kernels import _build, registry  # noqa: E402
from repro_torch.kernels import bench_eval as be  # noqa: E402
from repro_torch.kernels import de_step as ds  # noqa: E402
from repro_torch.kernels import eval_select as es  # noqa: E402
from repro_torch.kernels import ga_step as gs  # noqa: E402

try:
    import jax
    import jax.numpy as jnp

    from repro.functions import get as jget
    from repro.kernels import ops, ref
except ImportError:     # a machine with the card but without JAX
    jax = None

BENCH_FNS = [n for n in registry.registered() if n != "shifted_rosenbrock"]


@pytest.fixture(autouse=True)
def _partitionable(request):
    if jax is None:
        if request.node.get_closest_marker("gpu") is None:
            pytest.skip("the comparison with the JAX package needs JAX")
        yield
        return
    with jax.threefry_partitionable(True):
        yield


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (np.abs(b) + 1.0)))


def _box_pop(fn, P, D, seed, full_box=False):
    f = jget(fn)
    lo, hi = (f.lo, f.hi) if full_box else (max(f.lo, -5.0), min(f.hi, 5.0))
    return np.random.default_rng(seed).uniform(lo, hi, (P, D)).astype(np.float32)


def _de_inputs(P, D, lead=(), seed=0, lo=-100.0, hi=100.0):
    rng = np.random.default_rng(seed)
    pop = rng.uniform(lo, hi, (*lead, P, D)).astype(np.float32)
    u = rng.uniform(0, 1, (*lead, P, D)).astype(np.float32)
    idx = (np.arange(P) + 1 + rng.integers(0, P - 1, (3, *lead, P))) % P
    jr = rng.integers(0, D, (*lead, P))
    return pop, u, idx.astype(np.int32), jr.astype(np.int32)


def test_registry_matches_jax():
    from repro.kernels import registry as jreg
    assert registry.registered() == jreg.registered()
    assert set(registry.registered()) == set(be.EVAL_TAGS)
    with pytest.raises(KeyError, match="weierstrass"):
        registry.get_spec("weierstrass")


@pytest.mark.parametrize("fn", BENCH_FNS)
@pytest.mark.parametrize("P,D", [(8, 64), (37, 100), (130, 1000)])
def test_bench_eval_matches_ref(fn, P, D):
    x = _box_pop(fn, P, D, seed=P + D)
    want = ref.bench_eval_ref(jnp.asarray(x), fn)
    got = be.bench_eval(torch.from_numpy(x), fn)
    assert got.shape == (P,)
    assert _rel(got.numpy(), want) < (1e-4 if fn == "michalewicz" else 1e-5)


@pytest.mark.parametrize("fn", BENCH_FNS)
def test_bench_eval_in_domain(fn):
    x = _box_pop(fn, 33, 48, seed=13, full_box=True)
    want = ref.bench_eval_ref(jnp.asarray(x), fn)
    assert _rel(be.bench_eval(torch.from_numpy(x), fn).numpy(), want) < 1e-4


def test_bench_eval_shifted():
    rng = np.random.default_rng(6)
    x = rng.uniform(-100, 100, (16, 100)).astype(np.float32)
    sh = rng.uniform(-80, 80, (100,)).astype(np.float32)
    want = ref.bench_eval_ref(jnp.asarray(x), "shifted_rosenbrock",
                              shift=jnp.asarray(sh), bias=390.0)
    got = be.bench_eval(torch.from_numpy(x), "shifted_rosenbrock",
                        torch.from_numpy(sh), 390.0)
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("fn", ["rastrigin", "shifted_rosenbrock"])
def test_bench_eval_matches_pallas_interpret(fn):
    x = _box_pop("rosenbrock" if fn == "shifted_rosenbrock" else fn, 37, 100, 3)
    sh = np.asarray(tbm.shift_vector(100)) if fn == "shifted_rosenbrock" else None
    want = ops.bench_eval(jnp.asarray(x), fn,
                          None if sh is None else jnp.asarray(sh), 390.0)
    got = be.bench_eval(torch.from_numpy(x), fn,
                        None if sh is None else torch.from_numpy(sh), 390.0)
    assert _rel(got.numpy(), want) < 1e-5


def test_bench_eval_unregistered_raises():
    with pytest.raises(ValueError, match="weierstrass"):
        be.bench_eval(torch.zeros(8, 8), "weierstrass")
    with pytest.raises(ValueError, match="weierstrass"):
        ds.de_step(torch.zeros(8, 8), torch.zeros(8), torch.zeros(3, 8, dtype=torch.long),
                   torch.zeros(8, 8), torch.zeros(8, dtype=torch.long), "weierstrass")


def test_cpu_tensors_run_the_plain_version():
    """A CPU tensor never reaches the kernel: nothing is built or counted."""
    before = (be.LAUNCHES, ds.LAUNCHES)
    pop, u, idx, jr = (torch.from_numpy(a) for a in _de_inputs(16, 8))
    fit = be.bench_eval(pop, "sphere")
    ds.de_step(pop, fit, idx, u, jr, "sphere")
    assert (be.LAUNCHES, ds.LAUNCHES) == before


@pytest.mark.parametrize("P,D", [(50, 100), (128, 1000), (99, 333)])
def test_de_step_matches_ref(P, D):
    pop, u, idx, jr = _de_inputs(P, D, seed=P)
    fit = ref.bench_eval_ref(jnp.asarray(pop), "rastrigin")
    want = ref.de_step_ref(jnp.asarray(pop), fit, jnp.asarray(idx), jnp.asarray(u),
                           jnp.asarray(jr), fn="rastrigin")
    got = ds.de_step(torch.from_numpy(pop), torch.from_numpy(np.array(fit)),
                     torch.from_numpy(idx), torch.from_numpy(u),
                     torch.from_numpy(jr), fn="rastrigin")
    assert float(np.max(np.abs(got[0].numpy() - np.asarray(want[0])))) < 1e-5
    assert _rel(got[1].numpy(), want[1]) < 1e-5


def test_de_step_matches_pallas_interpret():
    """Against the Pallas kernel on shifted Rosenbrock: where the plain
    trial fitness is clear of the parent's, the decisions are identical."""
    P, D = 37, 100
    pop, u, idx, jr = _de_inputs(P, D, seed=5)
    sh = np.asarray(tbm.shift_vector(D))
    fit = np.asarray(ref.bench_eval_ref(jnp.asarray(pop), "shifted_rosenbrock",
                                        jnp.asarray(sh), 390.0))
    # Perturb the parents' fitness so roughly half the trials win.
    fit = fit * np.random.default_rng(7).uniform(0.5, 1.5, P).astype(np.float32)
    want = ops.de_step(jnp.asarray(pop), jnp.asarray(fit), jnp.asarray(idx),
                       jnp.asarray(u), jnp.asarray(jr), fn="shifted_rosenbrock",
                       shift=jnp.asarray(sh), bias=390.0)
    got = ds.de_step(torch.from_numpy(pop), torch.from_numpy(fit),
                     torch.from_numpy(idx), torch.from_numpy(u),
                     torch.from_numpy(jr), "shifted_rosenbrock",
                     torch.from_numpy(sh), 390.0)
    took = got[1].numpy() != fit
    assert 0 < took.sum() < P
    assert np.array_equal(took, np.asarray(want[1]) != fit)
    assert float(np.max(np.abs(got[0].numpy() - np.asarray(want[0])))) < 1e-5
    assert _rel(got[1].numpy(), want[1]) < 1e-5


def test_de_step_island_stacked_equals_per_island():
    I, P, D = 3, 20, 16
    pop, u, idx, jr = (torch.from_numpy(a) for a in _de_inputs(P, D, (I,), seed=2))
    fit = be.bench_eval_ref(pop, "sphere")
    npop, nfit = ds.de_step(pop, fit, idx, u, jr, "sphere")
    for i in range(I):
        p1, f1 = ds.de_step(pop[i], fit[i], idx[:, i], u[i], jr[i], "sphere")
        assert torch.equal(npop[i], p1) and torch.equal(nfit[i], f1)


def test_de_step_monotone_and_nan_keeps_parent():
    pop, u, idx, jr = (torch.from_numpy(a) for a in _de_inputs(64, 50, seed=9))
    fit = be.bench_eval_ref(pop, "sphere")
    _, nfit = ds.de_step(pop, fit, idx, u, jr, "sphere")
    assert bool((nfit <= fit).all())
    npop, nfit = ds.de_step(pop, fit, idx, u, jr, "sphere",
                            shift=torch.full((50,), float("nan")))
    assert torch.equal(npop, pop) and torch.equal(nfit, fit)


def test_build_needs_nvcc():
    """Without nvcc a build raises; the package imports without building."""
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is present: this checks the machine without it")
    if (_build.build_dir() / "libbench_eval.so").exists():
        pytest.skip("a built library is already present")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library("bench_eval")


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


# Shapes the kernels are held at on the card: Table I's population and its
# 100-row chunk, odd sizes, D = 333 and 1001 (scalar slots), and rows past
# the staging cap of 4096 lanes (16-byte slots) or 1024 (scalar), which
# de_step walks in two passes.
STAGE_CAP_D = (4100, 1027)


@pytest.mark.gpu
@pytest.mark.parametrize("fn", list(be.EVAL_TAGS))
@pytest.mark.parametrize("P,D", [(800, 1000), (37, 100), (5, 1), (100, 1000), (800, 333),
                                 (100, 1001), (6, STAGE_CAP_D[0]), (6, STAGE_CAP_D[1])])
def test_bench_eval_kernel_matches_plain(cuda_dev, fn, P, D):
    f = tbm.FUNCTIONS.get(fn, tbm.FUNCTIONS["rosenbrock"])
    x = np.random.default_rng(P).uniform(max(f.lo, -5.0), min(f.hi, 5.0), (P, D))
    pop = torch.from_numpy(x.astype(np.float32)).to(cuda_dev)
    n = be.LAUNCHES
    got = be.bench_eval(pop, fn)
    assert be.LAUNCHES == n + 1
    want = be.bench_eval_ref(pop, fn)
    assert _rel(got.cpu(), want.cpu()) < (1e-4 if fn == "michalewicz" else 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("P,rows", [(800, slice(100, 200)), (6400, slice(None))])
def test_bench_eval_kernel_row_views_and_many_waves(cuda_dev, P, rows):
    """A row slice with a storage offset (the chunked path's input) and a
    grid of several waves (the 8-island init) match the plain version."""
    x = np.random.default_rng(P).uniform(-100.0, 100.0, (P, 1000))
    pop = torch.from_numpy(x.astype(np.float32)).to(cuda_dev)[rows]
    args = ("shifted_rosenbrock", tbm.shift_vector(1000, device=cuda_dev), 390.0)
    got = be.bench_eval(pop, *args)
    want = be.bench_eval_ref(pop, *args)
    assert _rel(got.cpu(), want.cpu()) < 1e-5


def _unaligned(x: np.ndarray, dev) -> torch.Tensor:
    """``x`` on ``dev`` as a contiguous view one float past an aligned
    start: every row pointer is 4-byte aligned only."""
    flat = torch.zeros(x.size + 1, dtype=torch.float32, device=dev)
    view = flat[1:].view(x.shape)
    view.copy_(torch.from_numpy(x))
    assert be.pointer_alignment(view) == 4
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("fn", list(be.EVAL_TAGS))
@pytest.mark.parametrize("P,D", [(800, 1000), (100, 333)])
def test_bench_eval_kernel_unaligned_view(cuda_dev, fn, P, D):
    """``pop.view(-1)[1:1 + P * D].view(P, D)``: scalar slots."""
    f = tbm.FUNCTIONS.get(fn, tbm.FUNCTIONS["rosenbrock"])
    x = np.random.default_rng(D).uniform(max(f.lo, -5.0), min(f.hi, 5.0), (P, D))
    pop = _unaligned(x.astype(np.float32), cuda_dev)
    assert not be.geometry_for(P, D, pop).vec
    got = be.bench_eval(pop, fn)
    want = be.bench_eval_ref(pop, fn)
    assert _rel(got.cpu(), want.cpu()) < (1e-4 if fn == "michalewicz" else 1e-5)


def _check_de_step(pop, u, idx, jr, D):
    """One de_step launch against the plain version on shifted Rosenbrock:
    identical selections on clear rows, the population within 1e-5 and the
    fitness within 1e-5 relative where the selections agree."""
    shift = tbm.shift_vector(D, device=pop.device)
    args = ("shifted_rosenbrock", shift, 390.0)
    fit = be.bench_eval_ref(pop, *args)
    n = ds.LAUNCHES
    npop, nfit = ds.de_step(pop, fit, idx, u, jr, *args)
    assert ds.LAUNCHES == n + 1
    rpop, rfit = ds.de_step_ref(pop, fit, idx, u, jr, *args)
    tfit = be.bench_eval_ref(ds.trial_ref(pop, idx, u, jr), *args)
    clear = (tfit - fit).abs() > 1e-5 * (fit.abs() + 1.0)
    agree = (nfit != fit) == (tfit <= fit)
    assert bool(agree[clear].all())
    assert float((npop - rpop).abs()[agree].max()) < 1e-5
    assert _rel(nfit[agree].cpu(), rfit[agree].cpu()) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("lead,P,D", [
    ((), 800, 1000), ((), 99, 333), ((4,), 64, 100), ((8,), 800, 1000), ((), 100, 1001),
    ((), 16, STAGE_CAP_D[0]), ((), 16, STAGE_CAP_D[1])])
def test_de_step_kernel_matches_plain(cuda_dev, lead, P, D):
    pop, u, idx, jr = (torch.from_numpy(a).to(cuda_dev)
                       for a in _de_inputs(P, D, lead, seed=P))
    staged = be.geometry_for(pop[..., 0].numel(), D, pop, u).staged
    assert staged == (D not in STAGE_CAP_D)
    _check_de_step(pop, u, idx, jr, D)


@pytest.mark.gpu
@pytest.mark.parametrize("P,D", [(800, 1000), (99, 333)])
def test_de_step_kernel_unaligned_views(cuda_dev, P, D):
    pop, u, idx, jr = _de_inputs(P, D, seed=P)
    pop, u = (_unaligned(a, cuda_dev) for a in (pop, u))
    assert not be.geometry_for(P, D, pop, u).vec
    _check_de_step(pop, u, torch.from_numpy(idx).to(cuda_dev),
                   torch.from_numpy(jr).to(cuda_dev), D)


# ga_step and eval_select on eval_row.cuh: at the shapes the fused GA and SA
# generations launch them at ((8, 1, 1000) is the steady state over 8
# islands), odd sizes and rows past the staging cap, on shifted Rosenbrock.
FUSED_ROW_SHAPES = [(200, 1000), (8, 200, 1000), (8, 1, 1000), (1, 800, 1000), (800, 1000),
                    (37, 100), (5, 1), (100, 1001), (16, STAGE_CAP_D[0]),
                    (16, STAGE_CAP_D[1])]
FUSED_TOL = 1e-4    # tests/test_kernels.py's bound for the fused kernels


def _clear(cand, comp):
    """Rows whose candidate is clear of its comparand by FUSED_TOL (a NaN
    candidate or an infinite comparand always is)."""
    return ~((cand.double() - comp.double()).abs() <= FUSED_TOL * (comp.double().abs() + 1.0))


def _check_decided(got, want, clear, label):
    """Decisions identical on clear rows; where they agree, rows bit-exact
    and the new fitness within FUSED_TOL."""
    agree = got[2] == want[2]
    assert bool(agree[clear].all()), (label, int((~agree & clear).sum()))
    a, b = got[0][agree], want[0][agree]
    assert bool(((a == b) | (a.isnan() & b.isnan())).all()), label
    f, g = got[1][agree].double(), want[1][agree].double()
    same = (f == g) | (f.isnan() & g.isnan())
    assert bool((same | ((f - g).abs() / (g.abs() + 1.0) < FUSED_TOL)).all()), label


def _ga_on_card(shape, dev, seed, unaligned=False):
    """ga_step inputs: two dead slots per island (any child with a finite
    fitness takes them) and, in the first row, a NaN parent lane that the
    child takes (no crossover; a NaN fitness never takes, even a dead
    slot)."""
    rng = np.random.default_rng(seed)
    *lead, N, D = shape
    p1, p2, slot = (rng.uniform(-100.0, 100.0, shape).astype(np.float32) for _ in range(3))
    p1.reshape(-1, D)[0, 0] = np.nan
    co = rng.uniform(0, 1, (*lead, N)).astype(np.float32)
    co.reshape(-1)[0] = 1.0
    cut = rng.integers(0, D + 2, (*lead, N))
    um = rng.uniform(0, 1, shape).astype(np.float32)
    nz = rng.normal(size=shape).astype(np.float32)
    put = _unaligned if unaligned else (lambda a, d: torch.from_numpy(a).to(d))
    p1, p2, slot, um, nz = (put(a, dev) for a in (p1, p2, slot, um, nz))
    shift = tbm.shift_vector(D, device=dev)
    slot_f = be.bench_eval_ref(slot, "shifted_rosenbrock", shift, 390.0)
    slot_f[..., :2] = torch.inf
    return (p1, p2, slot, slot_f, torch.from_numpy(cut).to(dev), torch.from_numpy(co).to(dev),
            um, nz), shift


def _check_ga_step(arrs, shift, label):
    kw = dict(pc=0.7, pm=0.1, sigma_m=20.0, lo=-100.0, hi=100.0)
    n = gs.LAUNCHES
    got = gs.ga_step(*arrs, "shifted_rosenbrock", shift, 390.0, **kw)
    assert gs.LAUNCHES == n + 1
    want = gs.ga_step_ref(*arrs, "shifted_rosenbrock", shift, 390.0, **kw)
    child = torch.clamp(gs.crossover(*arrs[:2], arrs[4], arrs[5], kw["pc"])
                        + torch.where(arrs[6] < kw["pm"], kw["sigma_m"] * arrs[7], 0.0),
                        kw["lo"], kw["hi"])
    cfit = be.bench_eval_ref(child, "shifted_rosenbrock", shift, 390.0)
    _check_decided(got, want, _clear(cfit, arrs[3]), label)
    if arrs[0].shape[-1] > 1:   # (at D = 1 Rosenbrock has no pair to carry a NaN)
        assert not bool(got[2].reshape(-1)[0]), label      # the NaN child
    assert bool(got[2][..., :2].reshape(-1)[1:].all()), label  # dead slots


def _es_on_card(shape, dev, seed, unaligned=False):
    """eval_select inputs, Metropolis thresholds: +inf on the first two
    rows, whose first trial holds a NaN (never accepted)."""
    rng = np.random.default_rng(seed)
    *lead, P, D = shape
    pop, trial = (rng.uniform(-100.0, 100.0, shape).astype(np.float32) for _ in range(2))
    trial.reshape(-1, D)[0, D // 2] = np.nan
    put = _unaligned if unaligned else (lambda a, d: torch.from_numpy(a).to(d))
    pop, trial = put(pop, dev), put(trial, dev)
    shift = tbm.shift_vector(D, device=dev)
    fit = be.bench_eval_ref(pop, "shifted_rosenbrock", shift, 390.0)
    dF = be.bench_eval_ref(trial, "shifted_rosenbrock", shift, 390.0) - fit
    u = torch.from_numpy(rng.uniform(0, 1, (*lead, P)).astype(np.float32)).to(dev)
    th = -(0.5 * dF.abs().nanmedian()) * torch.log(u)
    th.view(-1)[:2] = torch.inf
    return (pop, fit, trial, th), shift, dF


def _check_eval_select(arrs, shift, dF, label):
    pop, fit, trial, th = arrs
    for thresh in (None, th):
        n = es.LAUNCHES
        got = es.eval_select(pop, fit, trial, thresh, "shifted_rosenbrock", shift, 390.0)
        assert es.LAUNCHES == n + 1
        want = es.eval_select_ref(pop, fit, trial, thresh, "shifted_rosenbrock", shift, 390.0)
        t = torch.zeros_like(fit) if thresh is None else thresh
        clear = _clear(dF + fit, fit) & (_clear(dF, t) | ~torch.isfinite(t))
        _check_decided(got, want, clear, label)
        if trial.shape[-1] > 1:
            assert not bool(got[2].reshape(-1)[0]), label


@pytest.mark.gpu
@pytest.mark.parametrize("shape", FUSED_ROW_SHAPES)
def test_ga_step_kernel_matches_plain(cuda_dev, shape):
    arrs, shift = _ga_on_card(shape, cuda_dev, seed=shape[-1])
    *lead, N, D = shape
    assert be.geometry_for(math.prod(lead) * N, D, *arrs[:3]).staged == (D not in STAGE_CAP_D)
    _check_ga_step(arrs, shift, shape)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", FUSED_ROW_SHAPES)
def test_eval_select_kernel_matches_plain(cuda_dev, shape):
    arrs, shift, dF = _es_on_card(shape, cuda_dev, seed=shape[-1])
    _check_eval_select(arrs, shift, dF, shape)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(200, 1000), (800, 1000), (99, 333), (16, STAGE_CAP_D[0])])
def test_ga_step_and_eval_select_kernels_unaligned_views(cuda_dev, shape):
    """Every row input one float past an aligned start: scalar slots."""
    arrs, shift = _ga_on_card(shape, cuda_dev, seed=1, unaligned=True)
    assert not be.geometry_for(shape[0], shape[1], *arrs[:3]).vec
    _check_ga_step(arrs, shift, shape)
    arrs, shift, dF = _es_on_card(shape, cuda_dev, seed=2, unaligned=True)
    assert not be.geometry_for(shape[0], shape[1], arrs[0], arrs[2]).vec
    _check_eval_select(arrs, shift, dF, shape)
