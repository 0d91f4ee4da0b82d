"""The port's ``flash_attention`` and ``ssd_scan`` against the JAX package's.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the Pallas kernels (interpret mode, through ``repro.kernels.ops``)
and against ``repro.kernels.ref`` on ``tests/test_kernels.py``'s shapes,
masks and bounds: flash attention within 2e-6 absolute in float32 and 2e-2
in bfloat16 (the bf16 outputs round to 8 bits of mantissa), the SSD scan
within 1e-4 (float32) and 3e-2 (bfloat16) of the reference's largest |y|
(the Pallas kernel's chunked form sums in another order than the
recurrence). Inputs come from numpy with fixed seeds; bfloat16 inputs are
the same float32 values rounded to nearest even in both packages.

The CUDA kernels are compared with the plain versions on the card by the
``gpu`` tests, which skip without a Hopper GPU. They need no JAX, so the
file also runs where JAX is not installed (the JAX comparisons skip there):

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_attention_ssd.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402

try:
    import jax.numpy as jnp

    from repro.kernels import ops, ref
except ImportError:     # a machine with the card but without JAX
    jnp = ops = ref = None

FLASH_TOL = {"float32": 2e-6, "bfloat16": 2e-2}
SSD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# bfloat16 flash on the card is also held row by row to 2^-4 of the plain
# row's rms: at long rows |out| is about sqrt(e / n) (0.02 at n = 6144),
# where the absolute 2e-2 passes a fault that moves such rows by 0.01. Two
# outputs rounded once to 8 significant bits differ by at most a unit in
# the last place, 2^-7 of an element of up to about 4.5 row rms.
FLASH_ROW_TOL = 2.0 ** -4


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture
def needs_jax():
    if jnp is None:
        pytest.skip("the comparison with the JAX package needs JAX")


def _pair(a, dtype):
    """The same values as a JAX array (None without JAX) and a torch tensor
    of ``dtype``."""
    return (None if jnp is None else jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _f64(a):
    if isinstance(a, torch.Tensor):
        return a.double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def _flash_inputs(BH, S, T, hd, dtype, seed=0):
    return [_pair(_normal(sh, seed + i), dtype)
            for i, sh in enumerate(((BH, S, hd), (BH, T, hd), (BH, T, hd)))]


@pytest.mark.parametrize("S,T,hd", [(128, 128, 64), (256, 256, 64),
                                    (128, 256, 128), (100, 200, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_shapes(needs_jax, S, T, hd, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _flash_inputs(2, S, T, hd, dtype)
    got = fa.flash_attention(tq, tk, tv, causal=True)
    assert got.shape == (2, S, hd) and got.dtype == tq.dtype
    for want in (ops.flash_attention(jq, jk, jv, causal=True),
                 ref.flash_attention_ref(jq, jk, jv, causal=True)):
        assert np.max(np.abs(_f64(got) - _f64(want))) < FLASH_TOL[dtype]


@pytest.mark.parametrize("window,softcap,causal", [(0, 0.0, True), (64, 0.0, True),
                                                   (0, 50.0, True), (0, 0.0, False),
                                                   (32, 30.0, True)])
def test_flash_attention_masks(needs_jax, window, softcap, causal):
    (jq, tq), (jk, tk), (jv, tv) = _flash_inputs(2, 192, 192, 64, "float32", seed=3)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = fa.flash_attention(tq, tk, tv, **kw)
    for want in (ops.flash_attention(jq, jk, jv, **kw),
                 ref.flash_attention_ref(jq, jk, jv, **kw)):
        assert np.max(np.abs(_f64(got) - _f64(want))) < 2e-6


@pytest.mark.parametrize("S,T,window,softcap", [(96, 96, 0, 0.0), (96, 96, 32, 50.0),
                                                 (64, 128, 0, 30.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_head_dim_256(needs_jax, S, T, window, softcap, dtype):
    """gemma's head dim, with gemma2's window and attention softcap: the
    Pallas kernel takes any head dim, and so does the port."""
    (jq, tq), (jk, tk), (jv, tv) = _flash_inputs(2, S, T, 256, dtype, seed=7)
    kw = dict(causal=True, window=window, softcap=softcap)
    got = fa.flash_attention(tq, tk, tv, **kw)
    assert got.shape == (2, S, 256) and got.dtype == tq.dtype
    for want in (ops.flash_attention(jq, jk, jv, **kw),
                 ref.flash_attention_ref(jq, jk, jv, **kw)):
        assert np.max(np.abs(_f64(got) - _f64(want))) < FLASH_TOL[dtype]


def _ssd_inputs(BH, S, P, N, dtype, seed=0):
    """(jax args, torch args) with dt = softplus(normal), A = -exp(normal)
    as in ``tests/test_kernels.py``; dt and A stay float32."""
    x, b, c = (_normal(sh, seed + i) for i, sh in enumerate(((BH, S, P), (BH, S, N),
                                                              (BH, S, N))))
    dt = np.log1p(np.exp(_normal((BH, S), seed + 3).astype(np.float64))).astype(np.float32)
    A = -np.exp(_normal((BH,), seed + 4).astype(np.float64)).astype(np.float32)
    (jx, tx), (jb, tb), (jc, tc) = (_pair(a, dtype) for a in (x, b, c))
    jargs = None if jnp is None else (jx, jnp.asarray(dt), jnp.asarray(A), jb, jc)
    return jargs, (tx, torch.from_numpy(dt), torch.from_numpy(A), tb, tc)


def _rel_to_max(got, want):
    w = _f64(want)
    return float(np.max(np.abs(_f64(got) - w))) / (float(np.max(np.abs(w))) + 1e-6)


@pytest.mark.parametrize("S,P,N,chunk", [(128, 32, 16, 32), (256, 64, 64, 64),
                                         (256, 64, 128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan(needs_jax, S, P, N, chunk, dtype):
    jargs, targs = _ssd_inputs(3, S, P, N, dtype)
    got = ss.ssd_scan(*targs, chunk=chunk)
    assert got.shape == (3, S, P) and got.dtype == targs[0].dtype
    for want in (ops.ssd_scan(*jargs, chunk=chunk), ref.ssd_ref(*jargs)):
        assert _rel_to_max(got, want) < SSD_TOL[dtype]


def test_ssd_scan_shared_bc_rows_match_expanded():
    """B/C given once per batch row, shared by H heads, is the scan of the
    expanded (BH, S, N) form: row bh reads row bh // H."""
    B, H = 2, 3
    _, (x, dt, A, b, c) = _ssd_inputs(B * H, 64, 16, 16, "float32", seed=5)
    bg, cg = b[::H].contiguous(), c[::H].contiguous()
    want = ss.ssd_scan(x, dt, A, bg.repeat_interleave(H, 0), cg.repeat_interleave(H, 0), chunk=16)
    got = ss.ssd_scan(x, dt, A, bg, cg, chunk=16)
    assert torch.equal(got, want)


def test_ssd_scan_needs_whole_chunks():
    _, targs = _ssd_inputs(2, 48, 16, 16, "float32")
    with pytest.raises(ValueError, match="chunk"):
        ss.ssd_scan(*targs, chunk=32)


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _card(t, dev):
    return t.to(dev)


def _row_err(got, want):
    """Largest over rows of max |got - want| over the rms of want's row."""
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(-1).sqrt()
    return float(((g - w).abs().amax(-1) / (rms + 1e-6)).max())


@pytest.mark.gpu
@pytest.mark.parametrize("BH,S,T,hd", [(2, 128, 128, 64), (2, 100, 200, 64), (3, 77, 77, 16),
                                       (2, 130, 130, 112), (2, 128, 256, 128), (64, 1, 1, 64),
                                       (8, 300, 300, 64), (2, 50, 70, 20), (2, 130, 130, 256),
                                       (3, 70, 200, 200), (16, 1, 1, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,softcap,causal", [(0, 0.0, True), (32, 30.0, True),
                                                   (0, 0.0, False), (64, 0.0, False)])
def test_flash_attention_kernel_matches_plain(cuda_dev, BH, S, T, hd, dtype, window,
                                              softcap, causal):
    """hd 20 is not a multiple of 8: its rows are copied without 16-byte
    copies. hd 200 and 256 run the kernels' 256-column instances."""
    q, k, v = (_card(t, cuda_dev) for _, t in _flash_inputs(BH, S, T, hd, dtype, seed=BH))
    kw = dict(causal=causal, window=window, softcap=softcap)
    n, tc = fa.LAUNCHES, fa.TC_LAUNCHES
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.LAUNCHES == n + 1
    # bfloat16 goes to the tensor-core kernel, float32 to the CUDA-core one.
    assert fa.TC_LAUNCHES == tc + (dtype == "bfloat16")
    want = fa.flash_attention_ref(q, k, v, **kw)
    assert got.dtype == q.dtype
    assert float((got.float() - want.float()).abs().max()) < FLASH_TOL[dtype]
    if dtype == "bfloat16":
        assert _row_err(got, want) < FLASH_ROW_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("BH,S,hd,window,softcap", [
    (128, 2048, 64, 0, 0.0), (32, 4096, 64, 0, 0.0),      # llama3.2-1b
    (128, 2048, 128, 0, 0.0),                             # granite-3-8b
    (64, 2048, 256, 0, 0.0),                              # gemma-7b
    (32, 4096, 256, 4096, 50.0), (32, 4096, 256, 0, 50.0),  # gemma2-9b local, global
    (16, 6144, 256, 4096, 50.0),                          # gemma2-9b local, serve
    (64, 2048, 112, 0, 0.0)])                             # zamba2-7b's shared block
def test_flash_attention_kernel_main_path_shapes(cuda_dev, BH, S, hd, window, softcap):
    """The models' prefills (batch 4 x 2048 and 1 x 4096 for llama, batch
    4 x 2048 for granite and gemma-7b, 2 x 4096 and 1 x 6144 for
    gemma2-9b's two kinds of layer, 2 x 2048 for zamba2-7b), bfloat16 and
    causal, through the tensor-core kernel. The row bound rejects what a
    faulty kernel would return: the kernel on keys whose next-to-last
    64-key tile repeats the tile before it (only the longest rows see it),
    and past the window the kernel with window 0."""
    q, k, v = (_card(t, cuda_dev) for _, t in _flash_inputs(BH, S, S, hd, "bfloat16"))
    tc = fa.TC_LAUNCHES
    kw = dict(causal=True, window=window, softcap=softcap)
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.TC_LAUNCHES == tc + 1
    want = fa.flash_attention_ref(q, k, v, **kw)
    assert float((got.float() - want.float()).abs().max()) < FLASH_TOL["bfloat16"]
    assert _row_err(got, want) < FLASH_ROW_TOL
    t0 = S // 64 * 64 - 128
    k2, v2 = k.clone(), v.clone()
    k2[:, t0:t0 + 64], v2[:, t0:t0 + 64] = k[:, t0 - 64:t0], v[:, t0 - 64:t0]
    assert _row_err(fa.flash_attention(q, k2, v2, **kw), want) >= FLASH_ROW_TOL
    if 0 < window < S:
        assert _row_err(fa.flash_attention(q, k, v, **{**kw, "window": 0}), want) >= FLASH_ROW_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("BH,S,P,N,H", [(3, 128, 32, 16, 1), (3, 256, 64, 128, 1),
                                        (8, 96, 64, 64, 4), (4, 64, 20, 32, 2),
                                        (4, 160, 72, 128, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_kernel_matches_plain(cuda_dev, BH, S, P, N, H, dtype):
    """S 96 and 160 are not multiples of the tensor-core kernel's 64-step
    chunk; P 72 spans two of its 64-column tiles."""
    _, (x, dt, A, b, c) = _ssd_inputs(BH, S, P, N, dtype, seed=BH)
    x, dt, A = (_card(t, cuda_dev) for t in (x, dt, A))
    b, c = (_card(t[::H].contiguous(), cuda_dev) for t in (b, c))
    n, tc = ss.LAUNCHES, ss.TC_LAUNCHES
    got = ss.ssd_scan(x, dt, A, b, c, chunk=32)
    assert ss.LAUNCHES == n + 1
    assert ss.TC_LAUNCHES == tc + (dtype == "bfloat16")
    want = ss.ssd_ref(x, dt, A, b, c)
    assert _rel_to_max(got.cpu(), want.cpu()) < SSD_TOL[dtype]


@pytest.mark.gpu
def test_ssd_scan_kernel_main_path_shape(cuda_dev):
    """mamba2-370m's prefill (batch 4 x 2048, 32 heads sharing one B/C row,
    P 64, N 128, chunk 256), bfloat16, through the tensor-core kernel."""
    B, H = 4, 32
    _, (x, dt, A, b, c) = _ssd_inputs(B * H, 2048, 64, 128, "bfloat16", seed=9)
    x, dt, A = (_card(t, cuda_dev) for t in (x, dt, A))
    b, c = (_card(t[::H].contiguous(), cuda_dev) for t in (b, c))
    tc = ss.TC_LAUNCHES
    got = ss.ssd_scan(x, dt, A, b, c, chunk=256)
    assert ss.TC_LAUNCHES == tc + 1
    want = ss.ssd_ref(x, dt, A, b, c)
    assert _rel_to_max(got.cpu(), want.cpu()) < SSD_TOL["bfloat16"]


@pytest.mark.gpu
def test_card_wrappers_raise_on_what_the_kernels_do_not_take(cuda_dev):
    q = torch.zeros((2, 8, 64), dtype=torch.float16, device=cuda_dev)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    q = torch.zeros((2, 8, 257), device=cuda_dev)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    x = torch.zeros((2, 32, 16), device=cuda_dev)
    dt, A = torch.zeros((2, 32), device=cuda_dev), torch.zeros(2, device=cuda_dev)
    b = torch.zeros((2, 32, 48), device=cuda_dev)
    with pytest.raises(ValueError):
        ss.ssd_scan(x, dt, A, b, b, chunk=32)
