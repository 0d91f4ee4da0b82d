"""The gradients of the port's ``flash_attention`` and ``ssd_scan``.

On the CPU each wrapper runs its plain version, which autograd
differentiates; those gradients are held against ``jax.grad`` of the JAX
package's plain functions (``repro.kernels.ref.flash_attention_ref``,
``ssd_ref``) on the same numpy inputs: flash within 1e-5 and the SSD scan
within 1e-4 of each gradient's largest |value| (float32; the sums run in
another order, and the SSD gradient runs through a 64-step recurrence). The
backward kernels' arithmetic (``csrc/flash_attention_bwd.cu``: P from the
forward's row log-sum-exp, D = dO . O; ``csrc/ssd_scan_bwd.cu``: two passes
and the log-decay gradient as a reverse sum of C . dC - dt v) is repeated
in float64 torch and held to the same bounds, so the CPU sees the algorithm
the card runs; its float32 rounding is held on the card. So are the bf16
routes' tensor-core algorithms (``csrc/flash_attention_bwd_tc.cu``: a dK/dV
pass over query tiles and a dQ pass over key tiles, each skipping the tiles
the masks drop; ``csrc/ssd_scan_bwd_tc.cu``: the chunked form, with the
chunk-entry states and their gradients in two sequential passes and dB, dC
summed over groups of heads): in float64 to the same bounds, and with
bfloat16 inputs rounded where the kernels round (P and dS; the SSD's
operands Mx, Lc, diag(w) X, diag(e) dY and the states), in float32, to the
card's bfloat16 bound against ``jax.grad`` on the same rounded inputs.

The ``gpu`` tests hold each backward kernel against its plain version on
the card (bounds of the forward kernels' tests, doubled for the extra
products) and check which route each case took (``TC_LAUNCHES``), hold the
CUDA-core designs at bf16 (their C entries) to the same bounds, check that
the wrappers carry a gradient on a CUDA tensor that requires one, and that
the kernels give the same bits twice. They need no JAX:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernel_grads.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fb  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.kernels import ssd_scan_bwd as sb  # noqa: E402

try:
    import jax
    import jax.numpy as jnp

    from repro.kernels import ref
except ImportError:     # a machine with the card but without JAX
    jax = jnp = ref = None

FLASH_GRAD_TOL = 1e-5   # of each gradient's largest |value|, float32
SSD_GRAD_TOL = 1e-4
# On the card, kernel against plain version, of each gradient's largest
# |value|: float32 sums in another order; bfloat16 outputs round to 8
# significant bits (2^-9 of a value) and the plain version's bf16 inputs
# to its own products round at other points.
CARD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture
def needs_jax():
    if jnp is None:
        pytest.skip("the comparison with the JAX package needs JAX")


def _rel(got, want):
    g = got.detach().double().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.max(np.abs(g - w))) / max(float(np.max(np.abs(w))), 1e-30)


# -- flash attention ----------------------------------------------------------

FLASH_CASES = [  # (BH, S, T, hd, causal, window, softcap)
    (2, 48, 48, 32, True, 0, 0.0),
    (2, 48, 48, 32, True, 16, 0.0),
    (2, 48, 48, 32, True, 0, 30.0),
    (2, 40, 40, 32, False, 0, 0.0),
    (2, 40, 56, 32, True, 12, 50.0),
    (1, 40, 40, 256, True, 16, 50.0),
    (1, 36, 36, 256, True, 0, 0.0),
]


def _flash_np(BH, S, T, hd, seed):
    return [_normal(sh, seed + i) for i, sh in
            enumerate(((BH, S, hd), (BH, T, hd), (BH, T, hd), (BH, S, hd)))]


def _jax_flash_grads(q, k, v, do, **kw):
    def f(q, k, v):
        return jnp.vdot(ref.flash_attention_ref(q, k, v, **kw), do)
    return jax.jit(jax.grad(f, argnums=(0, 1, 2)))(*(jnp.asarray(a) for a in (q, k, v)))


def _flash_bwd_as_kernel(q, k, v, do, *, causal, window, softcap):
    """csrc/flash_attention_bwd.cu's arithmetic in float64 torch: P from the
    row log-sum-exp, D = dO . O, dS through the softcap's derivative."""
    hd = q.shape[-1]
    scale = fa.scale_of(hd)
    s = torch.einsum("bsh,bth->bst", q, k) * scale
    deriv = torch.ones_like(s)
    if softcap > 0.0:
        t = softcap * torch.tanh(s / softcap)
        deriv = 1.0 - (t / softcap) ** 2
        s = t
    qp = torch.arange(q.shape[1])[:, None]
    kp = torch.arange(k.shape[1])[None, :]
    ok = torch.ones(s.shape[1:], dtype=torch.bool)
    if causal:
        ok &= qp >= kp
    if window > 0:
        ok &= (qp - kp) < window
    lse = torch.logsumexp(torch.where(ok, s, -1e30), dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - lse), 0.0)
    o = torch.einsum("bst,bth->bsh", p, v)
    D = (do * o).sum(-1, keepdim=True)
    dp = torch.einsum("bsh,bth->bst", do, v)
    ds = p * (dp - D) * deriv
    return (torch.einsum("bst,bth->bsh", ds, k) * scale,
            torch.einsum("bst,bsh->bth", ds, q) * scale,
            torch.einsum("bst,bsh->bth", p, do))


@pytest.mark.parametrize("BH,S,T,hd,causal,window,softcap", FLASH_CASES)
def test_flash_plain_backward_matches_jax(needs_jax, BH, S, T, hd, causal, window, softcap):
    q, k, v, do = _flash_np(BH, S, T, hd, seed=hd + S)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = _jax_flash_grads(q, k, v, do, **kw)
    got = fb.flash_attention_bwd(*(torch.from_numpy(a) for a in (q, k, v)), None,
                                 torch.from_numpy(do), None, **kw)
    emulated = _flash_bwd_as_kernel(*(torch.from_numpy(a).double() for a in (q, k, v, do)),
                                    **kw)
    for name, g, e, w in zip("qkv", got, emulated, want):
        assert _rel(g, w) < FLASH_GRAD_TOL, name
        assert _rel(e, w) < FLASH_GRAD_TOL, name


def test_flash_wrapper_is_differentiable_on_the_cpu():
    """flash_attention on CPU tensors that require grad: autograd of the
    plain version, equal to the backward wrapper's plain version."""
    q, k, v, do = (torch.from_numpy(a) for a in _flash_np(2, 24, 24, 16, seed=1))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*ins, causal=True, window=8, softcap=20.0)
    got = torch.autograd.grad(out, ins, do)
    want = fb.flash_attention_bwd(q, k, v, None, do, None, causal=True, window=8,
                                  softcap=20.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert fb.LAUNCHES == 0


def _tile_range(kv, f0, S, T, BM, causal, window):
    """csrc/flash_attention_bwd_tc.cu's streamed tiles [begin, end) of a
    dK/dV block (``kv``: keys f0.., query tiles) or a dQ block (queries
    f0.., key tiles)."""
    if kv:
        begin, end = 0, -(-S // BM)
        if causal:
            begin = f0 // BM
        if window > 0:
            end = min(end, (f0 + BM + window - 2) // BM + 1)
    else:
        begin, end = 0, -(-T // BM)
        if causal:
            end = min(end, (f0 + BM - 1) // BM + 1)
        if window > 0:
            begin = max(0, f0 - window + 1) // BM
    return begin, end


def _flash_bwd_tc_as_kernel(q, k, v, do, *, causal, window, softcap, BM=64, rnd=None):
    """csrc/flash_attention_bwd_tc.cu's algorithm in torch: D = dO . O,
    then for each BM-row tile of keys the query tiles of its range (S^T,
    dP^T, dV += P^T dO, dK += dS^T Q) and for each tile of queries the key
    tiles of its range (S, dP, dQ += dS K); P from the row log-sum-exp.
    ``rnd`` rounds P and dS where they enter their products (bf16 on the
    card); None keeps them. O is the forward's output, rounded by ``rnd``
    too."""
    r = rnd or (lambda t: t)
    BH, S, hd = q.shape
    T = k.shape[1]
    scale = fa.scale_of(hd)

    def scores(qr, kr):
        s = torch.einsum("bsh,bth->bst", q[:, qr], k[:, kr]) * scale
        deriv = torch.ones_like(s)
        if softcap > 0.0:
            t = softcap * torch.tanh(s / softcap)
            deriv = 1.0 - (t / softcap) ** 2
            s = t
        qp = torch.arange(S)[qr][:, None]
        kp = torch.arange(T)[kr][None, :]
        ok = torch.ones(s.shape[1:], dtype=torch.bool)
        if causal:
            ok &= qp >= kp
        if window > 0:
            ok &= (qp - kp) < window
        return s, deriv, ok

    s, _, ok = scores(slice(None), slice(None))
    lse = torch.logsumexp(torch.where(ok, s, -1e30), dim=-1)
    o = r(torch.einsum("bst,bth->bsh", r(torch.where(ok, torch.exp(s - lse[..., None]), 0.0)),
                       v))
    D = (do * o).sum(-1)

    def pair(qr, kr):
        s, deriv, ok = scores(qr, kr)
        p = torch.where(ok, torch.exp(s - lse[:, qr, None]), 0.0)
        dp = torch.einsum("bsh,bth->bst", do[:, qr], v[:, kr])
        return p, p * (dp - D[:, qr, None]) * deriv

    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for f0 in range(0, T, BM):
        kr = slice(f0, min(f0 + BM, T))
        begin, end = _tile_range(True, f0, S, T, BM, causal, window)
        for it in range(begin, end):
            qr = slice(it * BM, min(it * BM + BM, S))
            p, ds = pair(qr, kr)
            dv[:, kr] += torch.einsum("bst,bsh->bth", r(p), do[:, qr])
            dk[:, kr] += torch.einsum("bst,bsh->bth", r(ds), q[:, qr])
    for f0 in range(0, S, BM):
        qr = slice(f0, min(f0 + BM, S))
        begin, end = _tile_range(False, f0, S, T, BM, causal, window)
        for it in range(begin, end):
            kr = slice(it * BM, min(it * BM + BM, T))
            _, ds = pair(qr, kr)
            dq[:, qr] += torch.einsum("bst,bth->bsh", r(ds), k[:, kr])
    return dq * scale, dk * scale, dv


def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


TC_FLASH_CASES = [c for c in FLASH_CASES if c[3] <= fb.TC_MAX_HEAD_DIM] + [
    (2, 56, 56, 24, True, 20, 0.0), (1, 40, 40, 128, True, 0, 30.0)]


@pytest.mark.parametrize("BH,S,T,hd,causal,window,softcap", TC_FLASH_CASES)
def test_flash_tc_algorithm_matches_jax(needs_jax, BH, S, T, hd, causal, window, softcap):
    """The tensor-core route's tiling (16-row tiles here, so every case
    crosses several tiles and skips some) in float64 within the float32
    bound; in float32 on bf16 inputs with P and dS rounded to bf16 within
    the card's bf16 bound."""
    q, k, v, do = _flash_np(BH, S, T, hd, seed=hd + S + 1)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = _jax_flash_grads(q, k, v, do, **kw)
    tens = [torch.from_numpy(a) for a in (q, k, v, do)]
    got = _flash_bwd_tc_as_kernel(*(t.double() for t in tens), BM=16, **kw)
    for name, g, w in zip("qkv", got, want):
        assert _rel(g, w) < FLASH_GRAD_TOL, name
    rounded = [_bf16(t) for t in tens]
    want = _jax_flash_grads(*(t.numpy() for t in rounded), **kw)
    got = _flash_bwd_tc_as_kernel(*rounded, BM=16, rnd=_bf16, **kw)
    for name, g, w in zip("qkv", got, want):
        assert _rel(g, w) < CARD_TOL["bfloat16"], name


# -- SSD scan -----------------------------------------------------------------

SSD_CASES = [  # (BH, S, P, N, H)
    (4, 64, 16, 16, 2),
    (4, 48, 24, 32, 2),
    (2, 32, 64, 128, 1),
]


def _ssd_np(BH, S, P, N, H, seed):
    x, b, c, dy = (_normal(sh, seed + i) for i, sh in
                   enumerate(((BH, S, P), (BH // H, S, N), (BH // H, S, N), (BH, S, P))))
    dt = np.log1p(np.exp(_normal((BH, S), seed + 5).astype(np.float64))).astype(np.float32)
    A = -np.exp(_normal((BH,), seed + 6).astype(np.float64)).astype(np.float32)
    return x, dt, A, b, c, dy


def _jax_ssd_grads(x, dt, A, b, c, dy, H):
    def f(x, dt, A, b, c):
        y = ref.ssd_ref(x, dt, A, jnp.repeat(b, H, axis=0), jnp.repeat(c, H, axis=0))
        return jnp.vdot(y, dy)
    return jax.jit(jax.grad(f, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(a) for a in (x, dt, A, b, c)))


def _ssd_bwd_as_kernel(x, dt, A, b, c, dy):
    """csrc/ssd_scan_bwd.cu's two passes in float64 torch: forward for dC
    and r = C . dC, backward for g, dB, u, dx, v and the running
    Q = sum (r - dt v) of the log-decay's gradient; dB, dC summed over
    the heads of each B/C row in head order."""
    BH, S, P = x.shape
    R, N = b.shape[0], b.shape[-1]
    H = BH // R
    bf, cf = b.repeat_interleave(H, 0), c.repeat_interleave(H, 0)
    a = torch.exp(dt * A[:, None])
    st = torch.zeros(BH, N, P, dtype=x.dtype)
    dC, r = torch.zeros(BH, S, N, dtype=x.dtype), torch.zeros(BH, S, dtype=x.dtype)
    for t in range(S):
        st = st * a[:, t, None, None] + bf[:, t, :, None] * (x[:, t] * dt[:, t, None])[:, None]
        dC[:, t] = torch.einsum("bnp,bp->bn", st, dy[:, t])
        r[:, t] = (cf[:, t] * dC[:, t]).sum(-1)
    g = torch.zeros(BH, N, P, dtype=x.dtype)
    dB, dx, ddt = torch.zeros_like(dC), torch.zeros_like(x), torch.zeros_like(dt)
    q, dA = torch.zeros_like(A), torch.zeros_like(A)
    for t in reversed(range(S)):
        g = g + cf[:, t, :, None] * dy[:, t, None, :]
        dB[:, t] = torch.einsum("bnp,bp->bn", g, x[:, t]) * dt[:, t, None]
        u = torch.einsum("bn,bnp->bp", bf[:, t], g)
        dx[:, t] = dt[:, t, None] * u
        v = (x[:, t] * u).sum(-1)
        q = q + r[:, t] - dt[:, t] * v
        ddt[:, t] = v + A * q
        dA = dA + dt[:, t] * q
        g = g * a[:, t, None, None]

    def heads(m):
        out = m[0::H].clone()
        for h in range(1, H):
            out += m[h::H]
        return out
    return dx, ddt, dA, heads(dB), heads(dC)


@pytest.mark.parametrize("BH,S,P,N,H", SSD_CASES)
def test_ssd_plain_backward_matches_jax(needs_jax, BH, S, P, N, H):
    arrays = _ssd_np(BH, S, P, N, H, seed=S + N)
    want = _jax_ssd_grads(*arrays, H)
    tens = [torch.from_numpy(a) for a in arrays]
    got = sb.ssd_scan_bwd(*tens)
    emulated = _ssd_bwd_as_kernel(*(t.double() for t in tens))
    for name, g, e, w in zip(("x", "dt", "A", "B", "C"), got, emulated, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert _rel(g, w) < SSD_GRAD_TOL, name
        assert _rel(e, w) < SSD_GRAD_TOL, name


def _ssd_bwd_tc_as_kernel(x, dt, A, b, c, dy, *, Q=64, groups=None, rnd=None):
    """csrc/ssd_scan_bwd_tc.cu's algorithm in torch at a chunk of Q steps
    (the last chunk padded with dt = 0 and x = B = C = dy = 0): the
    chunk-entry states H forward and their gradients G in reverse, then
    every chunk at once: Mx, Lc, U, dx, dC, dB and the log-decay gradient
    Q_t from the chunk's pairs (row and column sums of R), the H and G
    parts and exp(total) <G, H>; dB and dC summed over each group's heads
    in order, then over the groups (``head_groups`` when None). ``rnd``
    rounds the products' operands where the kernel does (bf16 on the
    card)."""
    r = rnd or (lambda t: t)
    BH, S, P = x.shape
    R, N = b.shape[0], b.shape[-1]
    H = BH // R
    nC = -(-S // Q)
    G = sb.head_groups(R, nC, H) if groups is None else groups
    pad = nC * Q - S

    def chunks(t, rows):
        t = torch.nn.functional.pad(t, (0, 0, 0, pad) if t.dim() == 3 else (0, pad))
        return t.reshape(rows, nC, Q, *t.shape[2:])
    xq, yq, dtq = chunks(x, BH), chunks(dy, BH), chunks(dt, BH)
    bq = chunks(b, R).repeat_interleave(H, 0)
    cq = chunks(c, R).repeat_interleave(H, 0)
    seg = torch.cumsum(dtq * A[:, None, None], -1)
    total = seg[..., -1]
    e, ex = torch.exp(seg), torch.exp(total[..., None] - seg)
    w = dtq * ex
    zero = torch.zeros(BH, N, P, dtype=x.dtype)
    Hs = [zero]                                   # entering chunk c
    for ci in range(nC - 1):
        Hs.append(Hs[-1] * torch.exp(total[:, ci, None, None])
                  + torch.einsum("bjn,bjp->bnp", bq[:, ci], r(xq[:, ci] * w[:, ci, :, None])))
    Gs = [zero] * nC                              # leaving chunk c
    for ci in range(nC - 1, 0, -1):
        Gs[ci - 1] = (Gs[ci] * torch.exp(total[:, ci, None, None])
                      + torch.einsum("bin,bip->bnp", cq[:, ci], r(yq[:, ci] * e[:, ci, :, None])))
    Hc, Gc = r(torch.stack(Hs, 1)), r(torch.stack(Gs, 1))
    i = torch.arange(Q)
    low = i[:, None] >= i[None, :]
    L = torch.where(low, torch.exp(torch.where(low, seg[..., :, None] - seg[..., None, :], 0.0)),
                    0.0)
    cb = torch.einsum("bcin,bcjn->bcij", cq, bq)
    yx = torch.einsum("bcip,bcjp->bcij", yq, xq)
    Rm = yx * cb * L * dtq[..., None, :]
    Mx, Lc = r(yx * L * dtq[..., None, :]), r(cb * L)
    bg = torch.einsum("bcjn,bcnp->bcjp", bq, Gc)
    U = torch.einsum("bcij,bcip->bcjp", Lc, yq) + ex[..., None] * bg
    dx = dtq[..., None] * U
    v = (xq * U).sum(-1)
    yh = torch.einsum("bcip,bcnp->bcin", yq, Hc)
    dC = torch.einsum("bcij,bcjn->bcin", Mx, bq) + e[..., None] * yh
    dB = (torch.einsum("bcij,bcin->bcjn", Mx, cq)
          + w[..., None] * torch.einsum("bcjp,bcnp->bcjn", xq, Gc))
    a_ = (Rm.sum(-1) - Rm.sum(-2)) + e * (cq * yh).sum(-1)
    b_ = dtq * ex * (xq * bg).sum(-1)
    gh = torch.exp(total) * (Gc * Hc).sum((-1, -2))
    Qt = (torch.flip(torch.cumsum(torch.flip(a_, [-1]), -1), [-1])
          + torch.cumsum(b_, -1) - b_ + gh[..., None])
    ddt = v + A[:, None, None] * Qt
    dA = (dtq * Qt).sum(-1).sum(-1)

    def heads(m):
        m = m.reshape(R, G, H // G, nC * Q, N)
        part = m[:, :, 0].clone()
        for h in range(1, H // G):
            part += m[:, :, h]
        out = part[:, 0].clone()
        for gi in range(1, G):
            out += part[:, gi]
        return out[:, :S]
    return (dx.reshape(BH, nC * Q, P)[:, :S], ddt.reshape(BH, nC * Q)[:, :S], dA,
            heads(dB), heads(dC))


TC_SSD_CASES = [  # (BH, S, P, N, H, groups)
    (4, 40, 16, 16, 2, 1),
    (6, 50, 24, 32, 3, 3),
    (8, 64, 16, 16, 4, 2),
    (2, 24, 64, 128, 1, None),
]


@pytest.mark.parametrize("BH,S,P,N,H,groups", TC_SSD_CASES)
def test_ssd_tc_algorithm_matches_jax(needs_jax, BH, S, P, N, H, groups):
    """The tensor-core route's chunked algorithm at a chunk of 16 (S not a
    multiple of it but in the last case, H > 1 but in the last) in float64
    within the float32 bound; in float32 on bf16 inputs with the kernel's
    roundings within the card's bf16 bound."""
    arrays = _ssd_np(BH, S, P, N, H, seed=S + N + 1)
    want = _jax_ssd_grads(*arrays, H)
    tens = [torch.from_numpy(a) for a in arrays]
    got = _ssd_bwd_tc_as_kernel(*(t.double() for t in tens), Q=16, groups=groups)
    for name, g, w in zip(("x", "dt", "A", "B", "C"), got, want):
        assert _rel(g, w) < SSD_GRAD_TOL, name
    rounded = [_bf16(t) if t.dim() == 3 else t for t in tens]
    want = _jax_ssd_grads(*(t.numpy() for t in rounded), H)
    got = _ssd_bwd_tc_as_kernel(*rounded, Q=16, groups=groups, rnd=_bf16)
    for name, g, w in zip(("x", "dt", "A", "B", "C"), got, want):
        assert _rel(g, w) < CARD_TOL["bfloat16"], name


def test_head_groups_fill_one_wave_of_blocks():
    assert sb.head_groups(8, 8, 32) == 2        # mamba2-370m at 8 x 512: 128 blocks
    assert sb.head_groups(1, 4, 32) == 32       # phase 24's 1 x 256: 128 blocks
    assert sb.head_groups(2, 4, 3) == 3
    assert sb.head_groups(2, 200, 3) == 1       # 400 chunks already fill the card
    assert sb.head_groups(8, 8, 6) == 2


def test_ssd_wrapper_is_differentiable_on_the_cpu():
    x, dt, A, b, c, dy = (torch.from_numpy(a) for a in _ssd_np(4, 32, 16, 16, 2, seed=2))
    ins = [t.clone().requires_grad_(True) for t in (x, dt, A, b, c)]
    got = torch.autograd.grad(ss.ssd_scan(*ins, chunk=16), ins, dy)
    want = sb.ssd_scan_bwd(x, dt, A, b, c, dy)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert sb.LAUNCHES == 0


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _card(a, dev, dtype="float32"):
    return torch.from_numpy(a).to(dev).to(getattr(torch, dtype))


def _card_rel(got, want):
    g, w = got.double(), want.double()
    return float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)


# The training shapes (llama3.2-1b at 8 x 512 has BH 256, hd 64; the CPU
# cases are shorter) and gemma2's window with softcap at hd 256.
CARD_FLASH = [(4, 512, 512, 64, True, 0, 0.0), (2, 200, 200, 64, True, 64, 50.0),
              (2, 160, 160, 256, True, 64, 50.0), (2, 100, 180, 128, False, 0, 0.0),
              (3, 70, 70, 20, True, 24, 0.0)]   # hd % 8 != 0: rows copied without cp.async


@pytest.mark.gpu
@pytest.mark.parametrize("BH,S,T,hd,causal,window,softcap", CARD_FLASH)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernel_matches_plain(cuda_dev, BH, S, T, hd, causal, window, softcap,
                                        dtype):
    q, k, v, do = (_card(a, cuda_dev, dtype) for a in _flash_np(BH, S, T, hd, seed=3))
    kw = dict(causal=causal, window=window, softcap=softcap)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    n0, tc0 = fb.LAUNCHES, fb.TC_LAUNCHES
    out = fa.flash_attention(*ins, **kw)
    got = torch.autograd.grad(out, ins, do)
    assert fb.LAUNCHES == n0 + 1
    # bf16 at hd <= 128 takes the tensor-core kernel, the rest the CUDA cores.
    assert fb.TC_LAUNCHES == tc0 + int(dtype == "bfloat16" and hd <= 128)
    want = fb.flash_attention_bwd_ref(q, k, v, do, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == q.dtype and _card_rel(g, w) < CARD_TOL[dtype]


CARD_SSD = [(64, 512, 64, 128, 32), (6, 200, 40, 32, 3),
            (4, 100, 20, 16, 2)]   # P % 8 != 0: rows copied without cp.async


@pytest.mark.gpu
@pytest.mark.parametrize("BH,S,P,N,H", CARD_SSD)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_bwd_kernel_matches_plain(cuda_dev, BH, S, P, N, H, dtype):
    x, dt, A, b, c, dy = _ssd_np(BH, S, P, N, H, seed=4)
    x, b, c, dy = (_card(a, cuda_dev, dtype) for a in (x, b, c, dy))
    dt, A = _card(dt, cuda_dev), _card(A, cuda_dev)
    ins = [t.clone().requires_grad_(True) for t in (x, dt, A, b, c)]
    n0, tc0 = sb.LAUNCHES, sb.TC_LAUNCHES
    got = torch.autograd.grad(ss.ssd_scan(*ins, chunk=S), ins, dy)
    assert sb.LAUNCHES == n0 + 1
    assert sb.TC_LAUNCHES == tc0 + int(dtype == "bfloat16")
    want = sb.ssd_scan_bwd_ref(x, dt, A, b, c, dy)
    torch.cuda.synchronize()
    for g, w, t in zip(got, want, (x, dt, A, b, c)):
        assert g.dtype == t.dtype and _card_rel(g, w) < CARD_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("BH,S,T,hd,causal,window,softcap",
                         [c for c in CARD_FLASH if c[3] <= 128])
def test_flash_bwd_cuda_core_design_and_tensor_cores_match_plain_at_bf16(
        cuda_dev, BH, S, T, hd, causal, window, softcap):
    """The CUDA-core design through its C entry at bf16 (dtype 1) and the
    tensor-core kernel, on the same forward output and log-sum-exp, both
    within the bf16 bound of the plain version."""
    q, k, v, do = (_card(a, cuda_dev, "bfloat16") for a in _flash_np(BH, S, T, hd, seed=7))
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = fa.forward_with_lse(q, k, v, **kw)
    want = fb.flash_attention_bwd_ref(q, k, v, do, **kw)
    old = [torch.empty_like(t) for t in (q, k, v)]
    D = torch.empty((BH, S), dtype=torch.float32, device=cuda_dev)
    fb._build.launch("flash_attention_bwd", cuda_dev, q, k, v, out, do, lse, D, *old, BH, S, T,
                     hd, 1, fa.scale_of(hd), int(causal), window, softcap)
    new = fb.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    for o, n, w in zip(old, new, want):
        assert _card_rel(o, w) < CARD_TOL["bfloat16"]
        assert _card_rel(n, w) < CARD_TOL["bfloat16"]


@pytest.mark.gpu
@pytest.mark.parametrize("BH,S,P,N,H", CARD_SSD)
def test_ssd_bwd_cuda_core_design_and_tensor_cores_match_plain_at_bf16(cuda_dev, BH, S, P,
                                                                       N, H):
    """The CUDA-core design through its C entry at bf16 (dtype 1) and the
    chunked tensor-core kernel, both within the bf16 bound of the plain
    version."""
    x, dt, A, b, c, dy = _ssd_np(BH, S, P, N, H, seed=8)
    x, b, c, dy = (_card(a, cuda_dev, "bfloat16") for a in (x, b, c, dy))
    dt, A = _card(dt, cuda_dev), _card(A, cuda_dev)
    want = sb.ssd_scan_bwd_ref(x, dt, A, b, c, dy)
    old = [torch.empty_like(t) for t in (x, dt, A, b, c)]
    part = torch.empty((2, BH, S, N), dtype=torch.float32, device=cuda_dev)
    sb._build.launch("ssd_scan_bwd", cuda_dev, x, dt, A, b, c, dy, *old[:3], part[0], part[1],
                     *old[3:], BH, S, P, N, H, 1)
    new = sb.ssd_scan_bwd(x, dt, A, b, c, dy)
    torch.cuda.synchronize()
    for o, n, w in zip(old, new, want):
        assert _card_rel(o, w) < CARD_TOL["bfloat16"]
        assert _card_rel(n, w) < CARD_TOL["bfloat16"]


@pytest.mark.gpu
def test_card_wrappers_carry_the_gradient_and_repeat_their_bits(cuda_dev):
    """No wrapper drops the gradient on a CUDA tensor: every input of both
    kernels gets a nonzero gradient through the backward kernels (both
    tensor-core routes in bf16, the SSD's CUDA-core route in float32 too),
    and a second backward gives the same bits (no atomics)."""
    q, k, v, do = (_card(a, cuda_dev, "bfloat16") for a in _flash_np(2, 128, 128, 64, seed=5))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tc0 = fb.TC_LAUNCHES
    out = fa.flash_attention(*ins, causal=True)
    assert out.grad_fn is not None
    g1 = torch.autograd.grad(out, ins, do, retain_graph=True)
    g2 = torch.autograd.grad(out, ins, do)
    assert fb.TC_LAUNCHES == tc0 + 2
    for a, b_ in zip(g1, g2):
        assert bool(a.abs().max() > 0) and torch.equal(a, b_)
    x, dt, A, b, c, dy = _ssd_np(8, 200, 64, 64, 4, seed=6)
    for dtype in ("float32", "bfloat16"):
        ins = [_card(a, cuda_dev, dtype if a.ndim == 3 else "float32").requires_grad_(True)
               for a in (x, dt, A, b, c)]
        tc0 = sb.TC_LAUNCHES
        y = ss.ssd_scan(*ins, chunk=200)
        assert y.grad_fn is not None
        dyc = _card(dy, cuda_dev, dtype)
        g1 = torch.autograd.grad(y, ins, dyc, retain_graph=True)
        g2 = torch.autograd.grad(y, ins, dyc)
        assert sb.TC_LAUNCHES == tc0 + 2 * int(dtype == "bfloat16")
        for a, b_ in zip(g1, g2):
            assert bool(a.abs().max() > 0) and torch.equal(a, b_)


@pytest.mark.gpu
def test_ssd_wrapper_refuses_a_gradient_it_cannot_take(cuda_dev):
    x = torch.zeros((2, 32, 80), device=cuda_dev, requires_grad=True)
    dt, A = torch.zeros((2, 32), device=cuda_dev), torch.zeros(2, device=cuda_dev)
    b = torch.zeros((2, 32, 16), device=cuda_dev)
    with pytest.raises(ValueError, match="head dims up to 64"):
        ss.ssd_scan(x, dt, A, b, b, chunk=32)
