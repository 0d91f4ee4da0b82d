"""The tensor-core kernels' rounding scheme, held to the bfloat16 bounds on
the CPU.

The bfloat16 routes of ``flash_attention`` and ``ssd_scan`` run on the card's
tensor cores (``csrc/flash_attention_tc.cu``, ``csrc/ssd_scan_tc.cu``), whose
operands are bfloat16: they round intermediate values the float32
algorithms keep. The helpers below repeat each kernel's arithmetic in plain
float32 PyTorch with the same operand roundings and the same tiling:

- flash attention: 64-row query tiles over 64-key tiles, the tiles the
  kernel skips skipped, the online softmax from -1e30, and P rounded to
  bfloat16 before P V (l sums P in float32);
- the SSD scan: the chunked form at the kernel's own 64-step chunk, with
  (C B^T o L) diag(dt), (x dt) o exp(total - seg) and the carried state
  rounded to bfloat16 where they enter a product (x, B and C enter as they
  are), and exp(seg) scaling the float32 product C state.

Each is held against the JAX package's Pallas kernel in interpret mode (and
its ``ref``) on the same numpy-seeded inputs, at ``tests/test_kernels.py``'s
bfloat16 bounds: 2e-2 absolute for flash attention, 3e-2 of the largest |y|
for the scan. The shapes are that suite's, llama3.2-1b's head dim 64 at
S 512, and mamba2-370m's N 128, P 64 with 32 heads sharing one B/C row.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402

FLASH_TOL = 2e-2     # bfloat16, absolute
SSD_TOL = 3e-2       # bfloat16, of the reference's largest |y|
BM = BN = 64         # flash_attention_tc.cu's query rows per warpgroup, keys per tile
Q = ss.TC_CHUNK      # ssd_scan_tc.cu's chunk


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _bf16_pair(a):
    """The same values as a bfloat16 JAX array and torch tensor."""
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _f64(a):
    if isinstance(a, torch.Tensor):
        return a.double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def _bf16(t):
    return t.to(torch.bfloat16).float()


# -- flash attention -----------------------------------------------------------

def _key_range(q0, T, causal, window):
    """Key tiles [begin, end) the kernel visits for the 64-row tile at q0."""
    n_tiles = -(-T // BN)
    begin, end = 0, n_tiles
    if causal:
        end = min(end, (q0 + BM - 1) // BN + 1)
    if window > 0:
        x = q0 - BN + 2 - window
        if x > 0:
            begin = -(-x // BN)
    if begin >= end:
        begin, end = 0, n_tiles
    return begin, end


def flash_tc_model(q, k, v, *, causal=True, window=0, softcap=0.0):
    """flash_attention_tc.cu's arithmetic in float32 PyTorch."""
    BH, S, hd = q.shape
    T = k.shape[1]
    n_tiles = -(-T // BN)
    pad = n_tiles * BN - T
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    scale = fa.scale_of(hd)
    out = torch.empty((BH, S, hd))
    for q0 in range(0, S, BM):
        qi = torch.arange(q0, min(q0 + BM, S))
        qt = q[:, q0:q0 + BM].float()
        m = torch.full((BH, len(qi)), fa.NEG_INF)
        l = torch.zeros((BH, len(qi)))
        acc = torch.zeros((BH, len(qi), hd))
        begin, end = _key_range(q0, T, causal, window)
        for kt in range(begin, end):
            kj = torch.arange(kt * BN, kt * BN + BN)
            s = qt @ kf[:, kt * BN:(kt + 1) * BN].transpose(1, 2) * scale
            if softcap > 0.0:
                s = softcap * torch.tanh(s / softcap)
            ok = (kj < T)[None, :].expand(len(qi), BN)
            if causal:
                ok = ok & (qi[:, None] >= kj[None, :])
            if window > 0:
                ok = ok & ((qi[:, None] - kj[None, :]) < window)
            s = torch.where(ok, s, fa.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + _bf16(p) @ vf[:, kt * BN:(kt + 1) * BN]
            m = m_new
        out[:, q0:q0 + BM] = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(q.dtype)


def _flash_case(BH, S, T, hd, seed, **kw):
    (jq, tq), (jk, tk), (jv, tv) = (_bf16_pair(_normal(sh, seed + i)) for i, sh in
                                    enumerate(((BH, S, hd), (BH, T, hd), (BH, T, hd))))
    got = flash_tc_model(tq, tk, tv, **kw)
    assert got.shape == (BH, S, hd) and got.dtype == torch.bfloat16
    for want in (ops.flash_attention(jq, jk, jv, **kw), ref.flash_attention_ref(jq, jk, jv, **kw)):
        assert np.max(np.abs(_f64(got) - _f64(want))) < FLASH_TOL


@pytest.mark.parametrize("S,T,hd", [(128, 128, 64), (256, 256, 64),
                                    (128, 256, 128), (100, 200, 64)])
def test_flash_rounding_suite_shapes(S, T, hd):
    _flash_case(2, S, T, hd, seed=0, causal=True)


@pytest.mark.parametrize("window,softcap,causal", [(0, 0.0, True), (64, 0.0, True),
                                                   (0, 50.0, True), (0, 0.0, False),
                                                   (32, 30.0, True)])
def test_flash_rounding_masks(window, softcap, causal):
    _flash_case(2, 192, 192, 64, seed=3, causal=causal, window=window, softcap=softcap)


@pytest.mark.parametrize("BH,S,T,hd", [(4, 512, 512, 64), (3, 77, 77, 16),
                                       (2, 130, 130, 112), (2, 300, 300, 64)])
def test_flash_rounding_llama_and_ragged(BH, S, T, hd):
    """llama3.2-1b's head dim at S 512; ragged lengths and head dims the
    kernel pads to 16 and 128."""
    _flash_case(BH, S, T, hd, seed=7, causal=True)


def test_flash_rounding_model_rounds_p():
    """The helper is not the float32 algorithm: rounding P moves the output
    at llama's shape, by less than the bound."""
    _, q = _bf16_pair(_normal((2, 256, 64), 1))
    _, k = _bf16_pair(_normal((2, 256, 64), 2))
    _, v = _bf16_pair(_normal((2, 256, 64), 3))
    d = (flash_tc_model(q, k, v).float()
         - fa.flash_attention_ref(q, k, v).float()).abs().max()
    assert 0.0 < float(d) < FLASH_TOL


# -- the SSD scan --------------------------------------------------------------

def ssd_tc_model(xh, dt, A, Bm, Cm):
    """ssd_scan_tc.cu's arithmetic in float32 PyTorch: the chunked form at
    chunk Q, B/C rows shared by BH / R heads, C B^T once per B/C row."""
    BH, S, P = xh.shape
    R, _, N = Bm.shape
    H = BH // R
    nC = -(-S // Q)
    pad = nC * Q - S
    x = torch.nn.functional.pad(xh.float(), (0, 0, 0, pad))
    d = torch.nn.functional.pad(dt.float(), (0, pad))
    B = torch.nn.functional.pad(Bm.float(), (0, 0, 0, pad))
    C = torch.nn.functional.pad(Cm.float(), (0, 0, 0, pad))
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    state = torch.zeros((BH, N, P))
    ys = []
    for c in range(nC):
        sl = slice(c * Q, (c + 1) * Q)
        seg = torch.cumsum(d[:, sl] * A.float()[:, None], -1)          # (BH, Q)
        total = seg[:, -1]
        cb = (C[:, sl] @ B[:, sl].transpose(1, 2)).repeat_interleave(H, 0)
        li = torch.where(causal, seg[:, :, None] - seg[:, None, :], 0.0)
        L = torch.where(causal, torch.exp(li), 0.0)
        Ch = C[:, sl].repeat_interleave(H, 0)
        Bh = B[:, sl].repeat_interleave(H, 0)
        y = (torch.exp(seg)[..., None] * (Ch @ _bf16(state))
             + _bf16(cb * L * d[:, None, sl]) @ x[:, sl])
        ys.append(y)
        xp = _bf16(x[:, sl] * (d[:, sl] * torch.exp(total[:, None] - seg))[..., None])
        state = torch.exp(total)[:, None, None] * state + Bh.transpose(1, 2) @ xp
    return torch.cat(ys, 1)[:, :S].to(xh.dtype)


def _ssd_case(BH, S, P, N, H, chunk, seed):
    """dt = softplus(normal), A = -exp(normal) as in tests/test_kernels.py;
    B/C one row per H heads (expanded for the Pallas kernel)."""
    R = BH // H
    x, b, c = (_normal(sh, seed + i) for i, sh in enumerate(((BH, S, P), (R, S, N), (R, S, N))))
    dt = np.log1p(np.exp(_normal((BH, S), seed + 3).astype(np.float64))).astype(np.float32)
    A = -np.exp(_normal((BH,), seed + 4).astype(np.float64)).astype(np.float32)
    (jx, tx), (jb, tb), (jc, tc) = (_bf16_pair(a) for a in (x, b, c))
    jb, jc = (jnp.repeat(a, H, axis=0) for a in (jb, jc))
    got = ssd_tc_model(tx, torch.from_numpy(dt), torch.from_numpy(A), tb, tc)
    assert got.shape == (BH, S, P) and got.dtype == torch.bfloat16
    jargs = (jx, jnp.asarray(dt), jnp.asarray(A), jb, jc)
    for want in (ops.ssd_scan(*jargs, chunk=chunk), ref.ssd_ref(*jargs)):
        w = _f64(want)
        rel = float(np.max(np.abs(_f64(got) - w))) / (float(np.max(np.abs(w))) + 1e-6)
        assert rel < SSD_TOL


@pytest.mark.parametrize("S,P,N,chunk", [(128, 32, 16, 32), (256, 64, 64, 64),
                                         (256, 64, 128, 128)])
def test_ssd_rounding_suite_shapes(S, P, N, chunk):
    _ssd_case(3, S, P, N, 1, chunk, seed=0)


def test_ssd_rounding_mamba2_shared_bc():
    """mamba2-370m's state 128 and head dim 64, 32 heads sharing one B/C
    row, batch 1, S 256."""
    _ssd_case(32, 256, 64, 128, 32, 64, seed=5)


def test_ssd_rounding_ragged_chunk():
    """S 96 at chunk 32: the kernel's second 64-step chunk is half padding."""
    _ssd_case(8, 96, 64, 64, 4, 32, seed=2)


def test_ssd_rounding_model_is_the_scan():
    """In float32 the helper's chunked form is the recurrence (the plain
    version) up to summation order and the bfloat16 operand roundings."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((4, 160, 16), generator=gen)
    dt = torch.nn.functional.softplus(torch.randn((4, 160), generator=gen))
    A = -torch.exp(torch.randn(4, generator=gen))
    b, c = torch.randn((2, 160, 32), generator=gen), torch.randn((2, 160, 32), generator=gen)
    want = ss.ssd_ref(x, dt, A, b, c)
    got = ssd_tc_model(x, dt, A, b, c)
    rel = float((got - want).abs().max() / want.abs().max())
    assert 0.0 < rel < SSD_TOL
