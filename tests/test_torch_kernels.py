"""The port's kernel wrappers against the JAX package's kernels.

On the CPU each wrapper runs its plain PyTorch version; those are held
against ``repro.kernels.ref`` on ``tests/test_kernels.py``'s shapes and
bounds, and against the Pallas kernels (interpret mode, through
``repro.kernels.ops``) at one shape each. The CUDA kernels themselves are
compared with the plain versions by the ``gpu`` tests, which skip without a
Hopper GPU.
"""
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.functions import get as jget  # noqa: E402
from repro.kernels import ops, ref  # noqa: E402
from repro_torch.functions import benchmarks as tbm  # noqa: E402
from repro_torch.kernels import _build, registry  # noqa: E402
from repro_torch.kernels import bench_eval as be  # noqa: E402
from repro_torch.kernels import de_step as ds  # noqa: E402

BENCH_FNS = [n for n in registry.registered() if n != "shifted_rosenbrock"]


@pytest.fixture(autouse=True)
def _partitionable():
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


@pytest.mark.gpu
@pytest.mark.parametrize("fn", list(be.EVAL_TAGS))
@pytest.mark.parametrize("P,D", [(800, 1000), (37, 100), (5, 1)])
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


@pytest.mark.gpu
@pytest.mark.parametrize("lead,P,D", [((), 800, 1000), ((), 99, 333), ((4,), 64, 100)])
def test_de_step_kernel_matches_plain(cuda_dev, lead, P, D):
    pop, u, idx, jr = (torch.from_numpy(a).to(cuda_dev)
                       for a in _de_inputs(P, D, lead, seed=P))
    shift = tbm.shift_vector(D, device=cuda_dev)
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
