"""``ga_step`` and ``eval_select`` as ``csrc/ga_step.cu`` and
``csrc/eval_select.cu`` compute them on ``csrc/eval_row.cuh``, checked on
the CPU against the JAX package's Pallas kernels (interpret mode, through
``repro.kernels.ops``).

``ga_child_model`` repeats ga_step.cu's child slot by slot in float32
PyTorch: each slot takes its lanes from the parent the cut gives them (a
16-byte slot wholly below the split from p1, wholly at or above it from p2,
the one slot that straddles it lane by lane from both; a scalar slot is one
lane), noise is read only for slots where a lane mutates, the mutation is a
product and a sum rounded apart, and the clip keeps a NaN. The child must be
bit-exact with ``ref.ga_step_ref``'s. Its fitness in ``eval_row.cuh``'s
order of summation (``eval_row_model`` of
``tests/test_torch_eval_geometry.py``), the strict ``<`` and the placement
are held against the Pallas ``ga_step`` for every tag at D = 4k, 4k + 1,
4k + 2 and 4k + 3, under 1, 2, 4 and 8 warps a row with 16-byte and scalar
slots, on rows whose cut is 0, on a slot boundary, inside a slot, D and
above D, one whose ``co`` equals ``pc`` exactly, and one whose child is NaN.
``eval_select_model`` does the same for eval_select.cu, with no threshold
and with +inf, negative and Metropolis thresholds, and a NaN trial. The
bounds are ``tests/test_kernels.py``'s: ``max |a - b| / (|b| + 1) < 1e-4``,
identical decisions on every row clear of its comparand by that bound, and
rows bit-exact.

The geometry test holds ``launch_geometry`` at the shapes the fused GA and
SA generations launch these kernels at: every row and lane once.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops, ref  # noqa: E402
from repro_torch.functions import benchmarks as tbm  # noqa: E402
from repro_torch.kernels import bench_eval as be  # noqa: E402
from repro_torch.kernels import eval_select as es  # noqa: E402
from repro_torch.kernels import ga_step as gs  # noqa: E402
from test_torch_eval_geometry import (N_SMS, block_rows, eval_row_model,  # noqa: E402
                                      lane_layout)

TAGS = list(be.EVAL_TAGS)
TOL = 1e-4
PC, PM = 0.7, 0.3


def _geometries(D):
    """1, 2, 4 and 8 warps a row, with 16-byte slots where D % 4 == 0 and
    with scalar ones."""
    return [be.launch_geometry(12, D, align, N_SMS)._replace(warps_per_row=W)
            for align in ((16, 4) if D % 4 == 0 else (4,)) for W in (1, 2, 4, 8)]


def _box(fn, D):
    """(shift, bias, lo, hi): Table I's shift and bias for
    shifted_rosenbrock, the [-5, 5]-clipped box of ``tests/test_kernels.py``
    otherwise."""
    if fn == "shifted_rosenbrock":
        return np.asarray(tbm.shift_vector(D)), 390.0, -100.0, 100.0
    f = tbm.FUNCTIONS[fn]
    return None, 0.0, max(f.lo, -5.0), min(f.hi, 5.0)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _clear(cand, comp):
    """Rows whose candidate is clear of its comparand by the bound; a NaN
    candidate or an infinite comparand is always clear."""
    cand, comp = np.asarray(cand, np.float64), np.asarray(comp, np.float64)
    with np.errstate(invalid="ignore"):
        return ~(np.abs(cand - comp) <= TOL * (np.abs(comp) + 1.0))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not a.size:
        return 0.0
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    with np.errstate(invalid="ignore"):
        d = np.where(same, 0.0, np.abs(a - b) / (np.abs(b) + 1.0))
    return float(np.max(d))


def _check(got, want, clear):
    """Decisions identical on clear rows; where they agree, rows bit-exact
    and the new fitness within the bound. ``got``/``want``: (rows, fit,
    decided)."""
    g_rows, g_fit, g_dec = (np.asarray(a) for a in got)
    w_rows, w_fit, w_dec = (np.asarray(a) for a in want)
    assert np.array_equal(g_dec[clear], w_dec[clear]), np.nonzero(g_dec != w_dec)
    same = g_dec == w_dec
    np.testing.assert_array_equal(g_rows[same], w_rows[same])
    assert _rel(g_fit[same], w_fit[same]) < TOL


# -- ga_step ------------------------------------------------------------------

def ga_child_model(p1, p2, cut, co, um, nz, vec, pc, pm, sigma_m, lo, hi):
    """ga_step.cu's child of every row, slot by slot, in float32."""
    N, D = p1.shape
    V = 4 if vec else 1
    d = torch.arange(D)
    d0 = d - d % V                                        # the lane's slot start
    split = torch.where(co < pc, cut.long(), D)[:, None]  # p1 below it
    parent = torch.where(d0 + V <= split, p1,             # the slot from p1
                         torch.where(d0 >= split, p2,     # the slot from p2
                                     torch.where(d < split, p1, p2)))  # straddling
    mutated = um < pm
    slot_mutates = mutated.view(N, D // V, V).any(-1).repeat_interleave(V, dim=-1)
    noise = torch.where(slot_mutates, nz, 0.0)            # read only there
    c = parent + torch.where(mutated, sigma_m * noise, 0.0)
    clipped = torch.fmin(torch.fmax(c, torch.tensor(lo)), torch.tensor(hi))
    return torch.where(torch.isnan(c), c, clipped)


def _ga_rows(fn, D, seed):
    """Rows that cover the crossover's cases: cut 0, on a slot boundary,
    inside a slot (three lanes), D and above D, each crossing over; co ==
    pc (no crossover); a NaN child competing for a dead slot; random rows.
    Slots 1 and 5 are dead (+inf): any child takes them."""
    rng = np.random.default_rng(seed)
    shift, bias, lo, hi = _box(fn, D)
    cuts = [0, 8, 9, 10, 11, D, D + 5, 50, 50] + list(rng.integers(1, D, 3))
    N = len(cuts)
    p1, p2, slot = (rng.uniform(lo, hi, (N, D)).astype(np.float32) for _ in range(3))
    co = rng.uniform(0, PC, N).astype(np.float32)        # crossover everywhere...
    co[7] = np.float32(PC)                               # ...but where co == pc
    co[9:] = rng.uniform(0, 1, 3)
    p1[8, 3] = np.nan                                    # lane 3 < cut: a NaN child
    slot_f = np.asarray(ref.bench_eval_ref(jnp.asarray(slot), fn, _j(shift), bias))
    slot_f = np.array(slot_f, np.float32)
    slot_f[[1, 5, 8]] = np.inf
    um = rng.uniform(0, 1, (N, D)).astype(np.float32)
    um[2] = 0.9                                          # a row that never mutates
    nz = rng.normal(size=(N, D)).astype(np.float32)
    kw = dict(bias=bias, pc=PC, pm=PM, sigma_m=0.05 * (hi - lo), lo=lo, hi=hi)
    return (p1, p2, slot, slot_f, np.array(cuts, np.int32), co, um, nz), shift, kw


@pytest.mark.parametrize("D", [100, 101, 102, 103])
def test_ga_child_model_is_bit_exact_with_ref(D):
    arrs, shift, kw = _ga_rows("sphere", D, D)
    p1, p2, slot, slot_f, cut, co, um, nz = arrs
    args = (kw["pc"], kw["pm"], kw["sigma_m"], kw["lo"], kw["hi"])
    # Every child, the NaN one too, against the plain version's.
    plain = torch.clamp(gs.crossover(_t(p1), _t(p2), _t(cut), _t(co), kw["pc"])
                        + torch.where(_t(um) < kw["pm"], kw["sigma_m"] * _t(nz), 0.0),
                        kw["lo"], kw["hi"])
    # Every child that takes a dead slot, against the reference's.
    dead = np.full_like(slot_f, np.inf)
    placed, _, took = ref.ga_step_ref(*map(_j, (p1, p2, slot, dead, cut, co, um, nz)),
                                      "sphere", None, **kw)
    took = np.asarray(took)
    assert took.sum() == len(took) - 1 and not took[8]
    for vec in ((True, False) if D % 4 == 0 else (False,)):
        child = ga_child_model(*map(_t, (p1, p2, cut, co, um, nz)), vec, *args).numpy()
        np.testing.assert_array_equal(child, plain.numpy())
        np.testing.assert_array_equal(child[took], np.asarray(placed)[took])
        assert np.isnan(child[8, 3]) and np.isfinite(np.delete(child[8], 3)).all()
        # Row 2 (cut 9, inside a 16-byte slot) does not mutate: p1 below the
        # cut, p2 from it on.
        np.testing.assert_array_equal(child[2, :9], p1[2, :9])
        np.testing.assert_array_equal(child[2, 9:], p2[2, 9:])


@pytest.mark.parametrize("D", [100, 101, 102, 103])
@pytest.mark.parametrize("fn", TAGS)
def test_ga_step_rows_match_pallas(fn, D):
    arrs, shift, kw = _ga_rows(fn, D, D + TAGS.index(fn))
    p1, p2, slot, slot_f, cut, co, um, nz = arrs
    want = ops.ga_step(*map(_j, arrs), fn=fn, shift=_j(shift), **kw)
    args = (kw["pc"], kw["pm"], kw["sigma_m"], kw["lo"], kw["hi"])
    sf = _t(slot_f)
    for g in _geometries(D):
        child = ga_child_model(*map(_t, (p1, p2, cut, co, um, nz)), g.vec, *args)
        cfit = eval_row_model(child, fn, g, _t(shift), kw["bias"])
        take = cfit < sf
        got = (torch.where(take[:, None], child, _t(slot)), torch.where(take, cfit, sf), take)
        assert not bool(take[8]) and bool(take[1]) and bool(take[5]), g
        _check(got, want, _clear(cfit, slot_f))


# -- eval_select --------------------------------------------------------------

def eval_select_model(pop, fit, trial, thresh, fn, g, shift, bias):
    """eval_select.cu's rows: the trial's fitness in eval_row.cuh's order,
    dF rounded once, accepted on (dF <= 0) | (dF < thresh), 0 when there is
    no threshold."""
    tfit = eval_row_model(trial, fn, g, shift, bias)
    dF = tfit - fit
    th = torch.zeros_like(fit) if thresh is None else thresh
    acc = (dF <= 0.0) | (dF < th)
    return torch.where(acc[:, None], trial, pop), torch.where(acc, tfit, fit), acc


def _es_rows(fn, D, seed):
    """Trial rows against incumbents, and thresholds: +inf on rows 0 (whose
    trial holds a NaN: it must not be accepted) and 1, negative on rows 2
    and 3, Metropolis (-T ln u, T half the median |dF|) elsewhere."""
    rng = np.random.default_rng(seed)
    shift, bias, lo, hi = _box(fn, D)
    P = 12
    pop, trial = (rng.uniform(lo, hi, (P, D)).astype(np.float32) for _ in range(2))
    trial[0, 5] = np.nan
    fit = np.asarray(ref.bench_eval_ref(jnp.asarray(pop), fn, _j(shift), bias))
    tfit = np.asarray(ref.bench_eval_ref(jnp.asarray(trial), fn, _j(shift), bias))
    T = np.float32(0.5 * np.nanmedian(np.abs(tfit - fit)))
    th = (-T * np.log(rng.uniform(0.01, 1, P))).astype(np.float32)
    th[:2] = np.inf
    th[2:4] = -np.abs(th[2:4]) - 1.0
    return pop, fit, trial, th, shift, bias


def _es_clear(fit, tfit, th):
    with np.errstate(invalid="ignore"):
        return _clear(tfit, fit) & (_clear(tfit - fit, th) | ~np.isfinite(th))


@pytest.mark.parametrize("D", [100, 101, 102, 103])
@pytest.mark.parametrize("fn", TAGS)
def test_eval_select_rows_match_pallas(fn, D):
    pop, fit, trial, th, shift, bias = _es_rows(fn, D, D + TAGS.index(fn))
    tfit_ref = np.asarray(ref.bench_eval_ref(jnp.asarray(trial), fn, _j(shift), bias))
    for thresh in (None, th):
        want = ops.eval_select(_j(pop), _j(fit), _j(trial), _j(thresh), fn=fn,
                               shift=_j(shift), bias=bias)
        th_np = np.zeros_like(fit) if thresh is None else thresh
        for g in _geometries(D):
            got = eval_select_model(_t(pop), _t(fit), _t(trial), _t(thresh), fn, g,
                                    _t(shift), bias)
            assert not bool(got[2][0]), g                 # a NaN trial never
            if thresh is not None:
                assert bool(got[2][1]), g                 # +inf accepts
            _check(got, want, _es_clear(fit, tfit_ref, th_np))


def test_eval_select_model_matches_plain_version():
    """The model's decisions and rows against the port's plain version on
    the same inputs (both in float32 PyTorch)."""
    pop, fit, trial, th, shift, bias = _es_rows("rastrigin", 101, 0)
    g = _geometries(101)[2]
    for thresh in (None, _t(th)):
        got = eval_select_model(_t(pop), _t(fit), _t(trial), thresh, "rastrigin", g,
                                None, bias)
        want = es.eval_select_ref(_t(pop), _t(fit), _t(trial), thresh, "rastrigin")
        _check(got, want, _es_clear(fit, want[1].numpy(), np.zeros_like(fit) if thresh
                                    is None else th))


# -- the geometry at the fused GA and SA shapes ---------------------------------

@pytest.mark.parametrize("rows", [8 * 1, 200, 8 * 200, 800])
def test_launch_geometry_covers_the_fused_shapes(rows):
    """GA's steady state over 8 islands (8 x 1), its Table I wave (200) and
    8 islands of it (8 x 200), SA's population (800), at D = 1000: 16-byte
    slots where aligned, scalar ones where not; every row and lane once."""
    D = 1000
    for align in (16, 4):
        g = be.launch_geometry(rows, D, align, N_SMS)
        assert g.vec == (align == 16) and g.staged, g
        got = block_rows(rows, g)
        assert np.array_equal(np.sort(got[got < rows]), np.arange(rows)), g
        d, _ = lane_layout(D, g)
        assert np.array_equal(np.sort(d[d >= 0]), np.arange(D)), g
