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
the card runs; its float32 rounding is held on the card.

The ``gpu`` tests hold each backward kernel against its plain version on
the card (bounds of the forward kernels' tests, doubled for the extra
products), check that the wrappers carry a gradient on a CUDA tensor that
requires one, and that the kernels give the same bits twice. They need no
JAX:

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
              (2, 160, 160, 256, True, 64, 50.0), (2, 100, 180, 128, False, 0, 0.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("BH,S,T,hd,causal,window,softcap", CARD_FLASH)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernel_matches_plain(cuda_dev, BH, S, T, hd, causal, window, softcap,
                                        dtype):
    q, k, v, do = (_card(a, cuda_dev, dtype) for a in _flash_np(BH, S, T, hd, seed=3))
    kw = dict(causal=causal, window=window, softcap=softcap)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    n0 = fb.LAUNCHES
    out = fa.flash_attention(*ins, **kw)
    got = torch.autograd.grad(out, ins, do)
    assert fb.LAUNCHES == n0 + 1
    want = fb.flash_attention_bwd_ref(q, k, v, do, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == q.dtype and _card_rel(g, w) < CARD_TOL[dtype]


CARD_SSD = [(64, 512, 64, 128, 32), (6, 200, 40, 32, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("BH,S,P,N,H", CARD_SSD)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_bwd_kernel_matches_plain(cuda_dev, BH, S, P, N, H, dtype):
    x, dt, A, b, c, dy = _ssd_np(BH, S, P, N, H, seed=4)
    x, b, c, dy = (_card(a, cuda_dev, dtype) for a in (x, b, c, dy))
    dt, A = _card(dt, cuda_dev), _card(A, cuda_dev)
    ins = [t.clone().requires_grad_(True) for t in (x, dt, A, b, c)]
    n0 = sb.LAUNCHES
    got = torch.autograd.grad(ss.ssd_scan(*ins, chunk=S), ins, dy)
    assert sb.LAUNCHES == n0 + 1
    want = sb.ssd_scan_bwd_ref(x, dt, A, b, c, dy)
    torch.cuda.synchronize()
    for g, w, t in zip(got, want, (x, dt, A, b, c)):
        assert g.dtype == t.dtype and _card_rel(g, w) < CARD_TOL[dtype]


@pytest.mark.gpu
def test_card_wrappers_carry_the_gradient_and_repeat_their_bits(cuda_dev):
    """No wrapper drops the gradient on a CUDA tensor: every input of both
    kernels gets a nonzero gradient through the backward kernels, and a
    second backward gives the same bits (no atomics)."""
    q, k, v, do = (_card(a, cuda_dev, "bfloat16") for a in _flash_np(2, 128, 128, 64, seed=5))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*ins, causal=True)
    assert out.grad_fn is not None
    g1 = torch.autograd.grad(out, ins, do, retain_graph=True)
    g2 = torch.autograd.grad(out, ins, do)
    for a, b_ in zip(g1, g2):
        assert bool(a.abs().max() > 0) and torch.equal(a, b_)
    x, dt, A, b, c, dy = _ssd_np(8, 128, 64, 64, 4, seed=6)
    ins = [_card(a, cuda_dev).requires_grad_(True) for a in (x, dt, A, b, c)]
    y = ss.ssd_scan(*ins, chunk=64)
    assert y.grad_fn is not None
    g1 = torch.autograd.grad(y, ins, _card(dy, cuda_dev), retain_graph=True)
    g2 = torch.autograd.grad(y, ins, _card(dy, cuda_dev))
    for a, b_ in zip(g1, g2):
        assert bool(a.abs().max() > 0) and torch.equal(a, b_)


@pytest.mark.gpu
def test_ssd_wrapper_refuses_a_gradient_it_cannot_take(cuda_dev):
    x = torch.zeros((2, 32, 80), device=cuda_dev, requires_grad=True)
    dt, A = torch.zeros((2, 32), device=cuda_dev), torch.zeros(2, device=cuda_dev)
    b = torch.zeros((2, 32, 16), device=cuda_dev)
    with pytest.raises(ValueError, match="head dims up to 64"):
        ss.ssd_scan(x, dt, A, b, b, chunk=32)
