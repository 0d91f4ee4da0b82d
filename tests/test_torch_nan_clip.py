"""A NaN lane through the clip of ``de_step`` and ``pso_step``.

``jnp.clip`` and ``torch.clamp`` keep a NaN; ``fminf(fmaxf(x, lo), hi)``
turns it into ``lo``. The kernels clip with ``popt::clip``
(``csrc/eval_tile.cuh``), which keeps it, so:

  * DE: a trial row with a NaN lane has a NaN fitness and never wins
    (``tfit <= fit`` is false), so the parent stays;
  * PSO: a NaN velocity lane stays NaN, the position with it, its fitness
    is NaN and the personal best is not replaced (strict ``<``).

On the CPU the wrappers run their plain versions, held here to the Pallas
kernels in interpret mode and to ``repro.kernels.ref``: positions bit for
bit (NaN where NaN), fitness within the bound of ``tests/test_kernels.py``
(1e-5 relative for DE, ``max |a-b| / (|b|+1) < 1e-4`` for PSO). The ``gpu``
tests hold the CUDA kernels to the plain versions on the same card tensors
with the same bounds; they skip without a Hopper GPU and need no JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.functions import benchmarks as tbm  # noqa: E402
from repro_torch.kernels import bench_eval as be  # noqa: E402
from repro_torch.kernels import de_step as ds  # noqa: E402
from repro_torch.kernels import pso_step as ps  # noqa: E402

try:
    import jax.numpy as jnp

    from repro.kernels import ops
except ImportError:     # a machine with the card but without JAX
    jnp = None

P, D = 37, 100
NAN_ROW, NAN_LANE = 5, 17


@pytest.fixture
def jax_ref():
    if jnp is None:
        pytest.skip("the comparison with the JAX package needs JAX")


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ok = ~(np.isnan(a) & np.isnan(b))
    return float(np.max(np.abs(a - b)[ok] / (np.abs(b)[ok] + 1.0)))


def de_nan_inputs(seed=3):
    """Shifted Rosenbrock-100 DE inputs, pop row NAN_ROW NaN at NAN_LANE,
    and every row crossing over at NAN_LANE, so each row drawing that row as
    a donor builds a NaN trial lane. The parents' fitness is perturbed so
    that about half the finite trials win."""
    rng = np.random.default_rng(seed)
    pop = rng.uniform(-100.0, 100.0, (P, D)).astype(np.float32)
    pop[NAN_ROW, NAN_LANE] = np.nan
    u = rng.uniform(0, 1, (P, D)).astype(np.float32)
    u[:, NAN_LANE] = 0.0
    idx = ((np.arange(P) + 1 + rng.integers(0, P - 1, (3, P))) % P).astype(np.int32)
    idx[1, :8] = NAN_ROW                  # rows 0-7 take the NaN row as donor b
    idx[1, NAN_ROW] = (NAN_ROW + 1) % P   # a row is never its own donor
    jr = rng.integers(0, D, P).astype(np.int32)
    shift = np.asarray(tbm.shift_vector(D))
    fit = be.bench_eval_ref(torch.from_numpy(pop), "shifted_rosenbrock",
                            torch.from_numpy(shift), 390.0).numpy()
    fit = (fit * rng.uniform(0.5, 1.5, P)).astype(np.float32)
    return pop, fit, idx, u, jr, shift


def _de_args(arrays, dev="cpu"):
    pop, fit, idx, u, jr, shift = (torch.from_numpy(a).to(dev) for a in arrays)
    return (pop, fit, idx, u, jr, "shifted_rosenbrock", shift, 390.0, 0.5, 0.2,
            -100.0, 100.0)


def _same(a, b):
    """Equal, NaN where NaN."""
    np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


def _check_de(npop, nfit, args):
    """NaN trials keep their parents, no finite parent turns NaN, and some
    but not all finite trials win."""
    pop, fit, idx, u, jr = args[:5]
    trial = ds.trial_ref(pop, idx, u, jr)
    nan_trial = torch.isnan(trial).any(dim=-1)
    assert int(nan_trial.sum()) >= 8
    _same(npop[nan_trial], pop[nan_trial])
    _same(nfit[nan_trial], fit[nan_trial])
    assert not bool(torch.isnan(nfit[~torch.isnan(fit)]).any())
    took = (nfit != fit) & ~torch.isnan(fit)
    assert 0 < int(took.sum()) < P - int(nan_trial.sum())


def test_de_step_nan_trial_never_wins(jax_ref):
    arrays = de_nan_inputs()
    args = _de_args(arrays)
    npop, nfit = ds.de_step(*args)
    _check_de(npop, nfit, args)
    pop, fit, idx, u, jr, shift = arrays
    for use_pallas in (True, False):
        want = ops.de_step(jnp.asarray(pop), jnp.asarray(fit), jnp.asarray(idx),
                           jnp.asarray(u), jnp.asarray(jr), fn="shifted_rosenbrock",
                           shift=jnp.asarray(shift), bias=390.0, use_pallas=use_pallas)
        np.testing.assert_array_equal(npop.numpy(), np.asarray(want[0]))
        assert _rel(nfit.numpy(), want[1]) < 1e-5
        np.testing.assert_array_equal(np.isnan(nfit.numpy()), np.isnan(np.asarray(want[1])))


def pso_nan_inputs(seed=4):
    """Shifted Rosenbrock-100 PSO inputs with one NaN velocity lane."""
    rng = np.random.default_rng(seed)
    shift = np.asarray(tbm.shift_vector(D))
    x, pb = (rng.uniform(-100.0, 100.0, (P, D)).astype(np.float32) for _ in range(2))
    v = rng.uniform(-20.0, 20.0, (P, D)).astype(np.float32)
    v[NAN_ROW, NAN_LANE] = np.nan
    r1, r2 = (rng.uniform(0, 1, (P, D)).astype(np.float32) for _ in range(2))
    pbf = be.bench_eval_ref(torch.from_numpy(pb), "shifted_rosenbrock",
                            torch.from_numpy(shift), 390.0).numpy()
    g = pb[np.argmin(pbf)].copy()
    return (x, v, pb, pbf, r1, r2, g), shift


PSO_KW = dict(bias=390.0, w=0.6, fp=1.0, fg=1.0, vmax=40.0, lo=-100.0, hi=100.0)


def _check_pso(got, arrays):
    x, v, pb, pbf = arrays[:4]
    nx, nv, fit, npb, npbf = (t.cpu().numpy() for t in got)
    assert np.isnan(nv[NAN_ROW, NAN_LANE]) and np.isnan(nx[NAN_ROW, NAN_LANE])
    assert np.isnan(fit[NAN_ROW]) and np.isnan(fit).sum() == 1
    np.testing.assert_array_equal(npb[NAN_ROW], pb[NAN_ROW])
    assert npbf[NAN_ROW] == pbf[NAN_ROW]
    assert (npbf != pbf).any()


def test_pso_step_nan_velocity_stays_nan(jax_ref):
    arrays, shift = pso_nan_inputs()
    got = ps.pso_step(*map(torch.from_numpy, arrays), "shifted_rosenbrock",
                      torch.from_numpy(shift), **PSO_KW)
    _check_pso(got, arrays)
    for use_pallas in (True, False):
        want = ops.pso_step(*map(jnp.asarray, arrays), fn="shifted_rosenbrock",
                            shift=jnp.asarray(shift), use_pallas=use_pallas, **PSO_KW)
        for k in (0, 1, 3):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=str(k))
        for k in (2, 4):
            assert _rel(got[k].numpy(), want[k]) < 1e-4
            np.testing.assert_array_equal(np.isnan(got[k].numpy()),
                                          np.isnan(np.asarray(want[k])))


@pytest.mark.gpu
def test_de_step_kernel_nan_trial_never_wins(cuda_dev):
    args = _de_args(de_nan_inputs(), cuda_dev)
    n = ds.LAUNCHES
    npop, nfit = ds.de_step(*args)
    assert ds.LAUNCHES == n + 1
    rpop, rfit = ds.de_step_ref(*args)
    _check_de(npop, nfit, args)
    _same(npop, rpop)
    assert _rel(nfit.cpu(), rfit.cpu()) < 1e-5


@pytest.mark.gpu
def test_pso_step_kernel_nan_velocity_stays_nan(cuda_dev):
    arrays, shift = pso_nan_inputs()
    args = [torch.from_numpy(a).to(cuda_dev) for a in arrays]
    sh = torch.from_numpy(shift).to(cuda_dev)
    n = ps.LAUNCHES
    got = ps.pso_step(*args, "shifted_rosenbrock", sh, **PSO_KW)
    assert ps.LAUNCHES == n + 1
    want = ps.pso_step_ref(*args, "shifted_rosenbrock", sh, **PSO_KW)
    _check_pso(got, arrays)
    for k in (0, 1, 3):
        _same(got[k], want[k])
    for k in (2, 4):
        assert _rel(got[k].cpu(), want[k].cpu()) < 1e-4
