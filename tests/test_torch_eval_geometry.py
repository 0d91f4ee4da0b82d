"""The launch geometry of ``bench_eval.cu`` and ``de_step.cu``, and their
row evaluation's order of summation, checked on the CPU.

``kernels.bench_eval.launch_geometry`` decides how a population is laid over
the card: 16-byte or scalar slots, warps per row, rows per block, slots per
thread, and whether a row fits one batch of registers (``staged``). The
geometry tests hold it to CUDA's limits and check, by repeating the
kernel's indexing (``csrc/eval_row.cuh``, ``Place``), that every row and
every lane of it is covered exactly once.

``eval_row_model`` repeats the kernel's arithmetic in float32 PyTorch: each
thread adds its own lanes' terms in increasing lane order (Rosenbrock's
pairs included, the pair that crosses into the next warp excepted), a
butterfly of shuffles combines a warp, the crossing pairs join the warp
partials, and one more butterfly combines the warps. It is held against
the JAX package's Pallas ``bench_eval`` in interpret mode for all ten tags
at D = 4k + 1, 4k + 2, 4k + 3 (scalar slots, so every Rosenbrock pair
crosses a thread) and 4k (16-byte slots), with several geometries each,
at ``tests/test_kernels.py``'s bounds: 1e-5 relative, 1e-4 for
michalewicz on [-5, 5].
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.functions import get as jget  # noqa: E402
from repro.kernels import ops  # noqa: E402
from repro_torch.kernels import bench_eval as be  # noqa: E402

N_SMS = 132                  # the H100 SXM's SMs
MAX_THREADS = 1024           # CUDA's limit on threads per block
MAX_GRID = 2**31 - 1         # CUDA's limit on blocks in x
STAGE_CAP = {True: 4 * 32 * be.MAX_BLOCK_WARPS * be.MAX_SLOTS,   # lanes, 16-byte slots
             False: 32 * be.MAX_BLOCK_WARPS * be.MAX_SLOTS}      # lanes, scalar slots


def lane_layout(D: int, g: be.Geometry) -> tuple[np.ndarray, np.ndarray]:
    """The lanes each thread of a row holds, as ``eval_row.cuh``'s ``Place``
    assigns them: ``(W, 32, iters * V)`` lane indices in the thread's order
    (-1 where it holds none), and each warp's slot end ``(W,)``."""
    V = 4 if g.vec else 1
    slots = D // V
    W = g.warps_per_row
    iters = -(-slots // (32 * W))
    seg0 = np.arange(W) * 32 * iters
    seg_end = np.minimum(seg0 + 32 * iters, slots)
    slot = (seg0[:, None, None] + 32 * np.arange(iters)[None, None, :]
            + np.arange(32)[None, :, None])
    held = slot < seg_end[:, None, None]
    d = slot[..., None] * V + np.arange(V)
    d = np.where(held[..., None], d, -1)
    return d.reshape(W, 32, iters * V), seg_end


def block_rows(P: int, g: be.Geometry) -> np.ndarray:
    """The row of every (block, row group) of the grid, as ``Place`` has it."""
    return (np.arange(g.blocks)[:, None] * g.rows_per_block
            + np.arange(g.rows_per_block)[None, :]).ravel()


# -- the geometry ---------------------------------------------------------------

@pytest.mark.parametrize("D", [1, 3, 4, 100, 333, 1000, 1001, 4100, 5003])
@pytest.mark.parametrize("P", [1, 5, 37, 100, 800, 6400])
def test_launch_geometry_covers_everything_once(P, D):
    for align in (16, 8, 4):
        g = be.launch_geometry(P, D, align, N_SMS)
        label = f"P={P} D={D} align={align}: {g}"
        # 16-byte slots only where every pointer is 16-byte aligned and
        # D % 4 == 0; and there they are taken.
        assert g.vec == (align % 16 == 0 and D % 4 == 0), label
        # CUDA's limits and eval_row.cuh's: at most 8 warps a block.
        assert g.threads == 32 * g.warps_per_row * g.rows_per_block <= MAX_THREADS, label
        assert g.warps_per_row * g.rows_per_block <= be.MAX_BLOCK_WARPS, label
        assert 1 <= g.blocks <= MAX_GRID, label
        assert g.smem_bytes <= be.SMEM_LIMIT == 227 * 1024, label
        assert g.slots_per_thread in (2, 4), label
        # Staged exactly when the row fits one batch of registers.
        assert g.staged == (g.iters <= g.slots_per_thread), label
        assert g.staged == (D <= STAGE_CAP[g.vec]), label
        # Every row once.
        rows = block_rows(P, g)
        assert np.array_equal(np.sort(rows[rows < P]), np.arange(P)), label
        assert (rows >= P).sum() < g.rows_per_block, label
        # Every lane of a row once.
        d, _ = lane_layout(D, g)
        held = d[d >= 0]
        assert np.array_equal(np.sort(held), np.arange(D)), label
        assert d.shape[-1] == g.iters * (4 if g.vec else 1), label


@pytest.mark.parametrize("P", [8_000, 25_600, 32_000, 128_000])
def test_launch_geometry_at_polish_batch_rows(P):
    """The polish layer's batches reach five and six digits of rows (ASD's
    4·K·D probes, AVD's K·D·2·L): one row a block at D = 1000, four short
    rows a block at D = 100, every row once, within CUDA's grid."""
    for D, per_block in ((1000, 1), (100, 4)):
        g = be.launch_geometry(P, D, 16, N_SMS)
        assert g.rows_per_block == per_block and g.blocks == P // per_block
        assert 1 <= g.blocks <= MAX_GRID
        rows = block_rows(P, g)
        assert np.array_equal(rows, np.arange(P))


def test_launch_geometry_at_the_main_path_shapes():
    """Table I's population, its chunk and the 8-island stack: 16-byte
    slots, 4 warps a row, 2 slots a thread, one row a block; an unaligned
    view of the same rows takes scalar slots, 8 warps a row."""
    for P in (800, 100, 6400):
        g = be.launch_geometry(P, 1000, 16, N_SMS)
        assert g.vec and g.staged
        assert (g.warps_per_row, g.slots_per_thread, g.rows_per_block) == (4, 2, 1)
        assert g.blocks == P
    g = be.launch_geometry(800, 1000, 4, N_SMS)
    assert not g.vec and g.staged
    assert (g.warps_per_row, g.slots_per_thread, g.iters) == (8, 4, 4)
    # Short rows share a block: four warps in all.
    g = be.launch_geometry(800, 100, 16, N_SMS)
    assert (g.warps_per_row, g.rows_per_block, g.slots_per_thread) == (1, 4, 2)


def test_pointer_alignment():
    x = torch.zeros(64)
    assert be.pointer_alignment(x) == 16
    assert be.pointer_alignment(x[1:]) == 4
    assert be.pointer_alignment(x[2:]) == 8
    assert be.pointer_alignment(x, None, x[1:]) == 4


# -- the order of summation -----------------------------------------------------

F32 = torch.float32
PI = torch.tensor(math.pi, dtype=F32)
TWO_PI = torch.tensor(2.0 * math.pi, dtype=F32)
E = torch.tensor(math.e, dtype=F32)


def _sq(t):
    return t * t


def _pow20(s):
    s4 = _sq(_sq(s))
    return s4 * _sq(_sq(s4))


def _butterfly(v, prod=False):
    """eval_row.cuh's butterfly over the last axis (32 lanes): lane 0."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        u = v[..., lanes ^ o]
        v = v * u if prod else v + u
    return v[..., 0]


def _lane_terms(fn, x, d, D):
    """The terms ``lane_term`` adds for lanes ``x`` at indices ``d``, in its
    order: a list of (a-term, mask) and the b-term (or None)."""
    i = (d + 1).to(F32)
    if fn in ("sphere", "dropwave"):
        return [(x * x, None)], None
    if fn == "rastrigin":
        return [(x * x - 10.0 * torch.cos(TWO_PI * x) + 10.0, None)], None
    if fn == "ackley":
        return [(x * x, None)], torch.cos(TWO_PI * x)
    if fn == "griewank":
        return [(x * x, None)], torch.cos(x / torch.sqrt(i))
    if fn == "schwefel":
        return [(x * torch.sin(torch.sqrt(x.abs())), None)], None
    if fn == "levy":
        w = 1.0 + (x - 1.0) / 4.0
        return [(_sq(torch.sin(PI * w)), d == 0),
                (_sq(w - 1.0) * (1.0 + 10.0 * _sq(torch.sin(PI * w + 1.0))), d < D - 1),
                (_sq(w - 1.0) * (1.0 + _sq(torch.sin(TWO_PI * w))), d == D - 1)], None
    if fn == "michalewicz":
        return [(torch.sin(x) * _pow20(torch.sin(i * x * x / PI)), None)], None
    raise ValueError(fn)


def _rosen_pair(x0, x1):
    return 100.0 * _sq(x1 - x0 * x0) + _sq(1.0 - x0)


def _finish(fn, a, b, D, bias):
    if fn == "ackley":
        s1, s2 = a / float(D), b / float(D)
        return -20.0 * torch.exp(-0.2 * torch.sqrt(s1)) - torch.exp(s2) + 20.0 + E + bias
    if fn == "griewank":
        return a / 4000.0 - b + 1.0 + bias
    if fn == "schwefel":
        return torch.tensor(418.9829 * D, dtype=F32) - a + bias
    if fn == "dropwave":
        return -(1.0 + torch.cos(12.0 * torch.sqrt(a))) / (0.5 * a + 2.0) + bias
    if fn == "michalewicz":
        return -a + bias
    return a + bias


def eval_row_model(x, fn, g, shift=None, bias=0.0):
    """``bench_eval.cu``'s fitness of every row of ``x`` (P, D) float32 under
    geometry ``g``, in float32 torch with the kernel's order of summation."""
    P, D = x.shape
    z = x if shift is None else x - shift
    if fn == "shifted_rosenbrock":
        z = z + 1.0
    d_np, seg_end = lane_layout(D, g)
    W = g.warps_per_row
    V = 4 if g.vec else 1
    d = torch.from_numpy(d_np)
    held = d >= 0
    zl = z[:, d.clamp(min=0)]                                   # (P, W, 32, n)
    rosen = fn in ("rosenbrock", "shifted_rosenbrock")
    # A warp whose part ends before the row does has its last pair
    # crossing into the next warp: it joins at the warps' combination.
    crossing = [(w, int(seg_end[w]) * V - 1) for w in range(W - 1)
                if seg_end[w] < D // V]
    if rosen:
        right = z[:, (d + 1).clamp(max=D - 1)]
        last = torch.zeros_like(d, dtype=torch.bool)
        for w, e in crossing:
            last[w] |= d[w] == e
        terms, b_term = [(_rosen_pair(zl, right), (d < D - 1) & ~last)], None
    else:
        terms, b_term = _lane_terms(fn, zl, d, D)
    prod = fn == "griewank"
    a = torch.zeros(zl.shape[:-1], dtype=F32)
    b = torch.full(zl.shape[:-1], 1.0 if prod else 0.0, dtype=F32)
    for p in range(zl.shape[-1]):
        for t, m in terms:
            keep = held[..., p] if m is None else held[..., p] & m[..., p]
            a = torch.where(keep, a + t[..., p], a)
        if b_term is not None:
            nb = b * b_term[..., p] if prod else b + b_term[..., p]
            b = torch.where(held[..., p], nb, b)
    a, b = _butterfly(a), _butterfly(b, prod)                   # (P, W)
    if W == 1:
        return _finish(fn, a[:, 0], b[:, 0], D, bias)
    for w, e in crossing if rosen else ():
        a[:, w] = a[:, w] + _rosen_pair(z[:, e], z[:, e + 1])
    pad = 32 - W
    a = torch.cat([a, torch.zeros(P, pad, dtype=F32)], dim=1)
    b = torch.cat([b, torch.full((P, pad), 1.0 if prod else 0.0, dtype=F32)], dim=1)
    return _finish(fn, _butterfly(a), _butterfly(b, prod), D, bias)


def _geometries(D):
    """Row layouts the kernels take for rows of D lanes: 1, 2, 4 and 8 warps
    a row (one warp walking many slots, up to eight sharing the row), with
    16-byte slots where D % 4 == 0 and with scalar ones."""
    return [be.launch_geometry(6, D, align, N_SMS)._replace(warps_per_row=W)
            for align in ((16, 4) if D % 4 == 0 else (4,)) for W in (1, 2, 4, 8)]


@pytest.mark.parametrize("D", [101, 102, 103, 100, 1027, 4100])
@pytest.mark.parametrize("fn", list(be.EVAL_TAGS))
def test_eval_row_order_matches_pallas(fn, D):
    P = 6
    f = jget("rosenbrock" if fn == "shifted_rosenbrock" else fn)
    rng = np.random.default_rng(D)
    x = rng.uniform(max(f.lo, -5.0), min(f.hi, 5.0), (P, D)).astype(np.float32)
    shift, bias = None, 0.0
    if fn == "shifted_rosenbrock":
        shift = rng.uniform(-1.0, 1.0, (D,)).astype(np.float32)
        bias = 390.0
    want = np.asarray(ops.bench_eval(jnp.asarray(x), fn,
                                     None if shift is None else jnp.asarray(shift), bias),
                      np.float64)
    tol = 1e-4 if fn == "michalewicz" else 1e-5
    for g in _geometries(D):
        got = eval_row_model(torch.from_numpy(x), fn, g,
                             None if shift is None else torch.from_numpy(shift), bias)
        err = np.max(np.abs(got.double().numpy() - want) / (np.abs(want) + 1.0))
        assert err < tol, (g, err)
