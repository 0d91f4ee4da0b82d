"""The port's model serving path against the JAX package's.

Both packages run the reduced configs of every arch the port runs
(``ARCHS``, the JAX package's ten) in float32 on the same weights: the JAX
parameter pytree carried across with ``convert.params_from_numpy``.
musicgen-medium's audio frontend takes frame embeddings in place of
tokens, so its cases feed those, and ``serve`` (tokens only) leaves it
out; ``tests/test_torch_moe.py`` and ``tests/test_torch_frontends.py``
hold the MoE layers and the frontends case by case. On the CPU the port's attention and SSD scan
run the plain versions of ``flash_attention`` and ``ssd_scan``, where the
JAX models take their XLA paths (``_attend_direct``/``_attend_chunked``,
``_ssd_chunked``): the same functions summed in another order, so values
are held to 1e-5 of the largest |value|, and greedy tokens must be
identical. ``init_params`` draws with ``prng.normal``, within
its bound of ``jax.random.normal`` (4 ulps, 1e-6 relative; ``tests/test_torch_prng.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

TOL = 1e-5      # of the largest |value|
ARCH_LIST = sorted(ARCHS)
# The archs ``serve`` drives: all but the audio frontend's.
SERVE_ARCHS = [a for a in ARCH_LIST if get_config(a).frontend != "audio_stub"]


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


def _cfgs(arch, **over):
    return jget(arch).reduced(**over), get_config(arch).reduced(**over)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _close(got, want, tol=TOL):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    scale = max(float(np.max(np.abs(w))), 1e-30) if w.size else 1.0
    err = float(np.max(np.abs(g - w))) / scale if w.size else 0.0
    assert err < tol, err


def _leaves(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{pre}/{k}")
    else:
        yield pre, tree


_PARAMS = {}


def _params(arch, jcfg):
    """JAX init_params(PRNGKey(0)) and the same leaves as port tensors."""
    key = (arch, jcfg)
    if key not in _PARAMS:
        jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
        _PARAMS[key] = jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return _PARAMS[key]


def _tokens(cfg, B, S, seed=0):
    t = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return jnp.asarray(t), torch.from_numpy(t).long()


def _embeds(cfg, B, S, seed=0):
    e = np.random.default_rng(seed).standard_normal((B, S, cfg.frontend_dim))
    e = e.astype(np.float32)
    return jnp.asarray(e), torch.from_numpy(e)


def _batch(cfg, B, S, seed=0):
    """(JAX batch, port batch) of S positions: frame embeddings for the
    audio frontend, tokens for every other arch."""
    if cfg.frontend == "audio_stub":
        je, te = _embeds(cfg, B, S, seed)
        return {"embeds": je}, {"embeds": te}
    jt, tt = _tokens(cfg, B, S, seed)
    return {"tokens": jt}, {"tokens": tt}


@pytest.mark.parametrize("arch", ARCH_LIST)
def test_init_params_matches_jax(arch):
    jc, tc = _cfgs(arch)
    jp = dict(_leaves(jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), jc))))
    tp = dict(_leaves(TT.init_params(prng.PRNGKey(0), tc)))
    assert sorted(tp) == sorted(jp)
    for name, w in jp.items():
        g = tp[name].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        ok = np.abs(g.astype(np.float64) - w) <= 1e-6 * np.abs(w)
        assert ok.all(), (name, float(np.max(np.abs(g - w))))
    assert TT.param_count(TT.init_params(prng.PRNGKey(0), tc)) == JT.param_count(
        JT.init_params(jax.random.PRNGKey(0), jc))


@pytest.mark.parametrize("arch", ARCH_LIST)
def test_forward_logits_match_jax(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _params(arch, jc)
    jb, tb = _batch(jc, 2, 32)
    jl, jaux = jax.jit(lambda p, b: JT.forward(p, jc, **b))(jp, jb)
    tl, aux = TT.forward(tp, tc, **tb)
    assert tl.dtype == torch.float32
    assert (float(aux) > 0) == bool(jc.num_experts)
    _close(aux, jaux)
    _close(tl, jl)


@pytest.mark.parametrize("arch", ARCH_LIST)
def test_prefill_step_matches_jax(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _params(arch, jc)
    jb, tb = _batch(jc, 2, 48, seed=1)
    want = jax.jit(jsteps.make_prefill_step(jc))(jp, jb)
    got = tsteps.make_prefill_step(tc)(tp, tb)
    assert got.shape == (2, tc.padded_vocab)
    _close(got, want)
    _close(TT.prefill(tp, tc, **tb), want)


def test_cast_params_matches_jax():
    jc, tc = _cfgs("mamba2-370m", compute_dtype="bfloat16")
    jp, tp = _params("mamba2-370m", jc)
    jcast = dict(_leaves(jsteps._cast_params(jp, jc)))
    tcast = dict(_leaves(tsteps._cast_params(tp, tc)))
    for name, w in jcast.items():
        assert str(tcast[name].dtype).split(".")[-1] == str(w.dtype), name
    once = tsteps._cast_params(tp, tc)
    assert tsteps._cast_params(once, tc)["embed"] is once["embed"]


@pytest.mark.parametrize("S", [8, 48])
def test_ssm_block_matches_jax(S):
    """The port's ``ssd_scan`` path against JAX's ``_ssd_chunked`` (chunk
    16: one short chunk at S = 8, three at S = 48)."""
    jc, tc = _cfgs("mamba2-370m")
    jp, tp = _params("mamba2-370m", jc)
    x = np.random.default_rng(S).standard_normal((2, S, jc.d_model)).astype(np.float32)
    lp_j = jax.tree.map(lambda v: v[1], jp["layers"]["ssm"])
    lp_t = TT.tree_map(lambda v: v[1], tp["layers"]["ssm"])
    want = JS.ssm_block(lp_j, jnp.asarray(x), jc)
    _close(TS.ssm_block(lp_t, torch.from_numpy(x), tc), want)


def _attn_params(arch_cfg):
    jp, tp = _params("llama3.2-1b", arch_cfg)
    return (jax.tree.map(lambda v: v[0], jp["layers"]["attn"]),
            TT.tree_map(lambda v: v[0], tp["layers"]["attn"]))


@pytest.mark.parametrize("S,over", [
    (32, {}),                                             # JAX: _attend_direct
    (64, {"attn_direct_max": 16, "attn_kv_block": 16}),   # JAX: _attend_chunked
    (40, {"window": 8, "attn_softcap": 20.0}),
])
def test_attention_without_cache_matches_jax(S, over):
    jc, tc = _cfgs("llama3.2-1b", **over)
    lj, lt = _attn_params(jc)
    x = np.random.default_rng(S).standard_normal((2, S, jc.d_model)).astype(np.float32)
    (yj, (kj, vj)) = JL.attention(lj, jnp.asarray(x), jc)
    (yt, (kt, vt)) = TL.attention(lt, torch.from_numpy(x), tc)
    _close(yt, yj)
    _close(kt, kj)
    _close(vt, vj)


@pytest.mark.parametrize("pos,S,over", [
    (0, 16, {}),                      # flash kernel; JAX: grouped einsum
    (0, 16, {"attn_direct_max": 8}),  # flash kernel; JAX: _attend_chunked, padded cache
    (16, 1, {}),                      # decode step: grouped einsum in both
    (5, 4, {"window": 8}),            # several tokens at a later position
])
def test_attention_through_cache_matches_jax(pos, S, over):
    jc, tc = _cfgs("llama3.2-1b", **over)
    lj, lt = _attn_params(jc)
    rng = np.random.default_rng(pos + S)
    T = 24
    x = rng.standard_normal((2, S, jc.d_model)).astype(np.float32)
    ck = rng.standard_normal((2, T, jc.n_kv_heads, jc.hd)).astype(np.float32)
    cv = rng.standard_normal((2, T, jc.n_kv_heads, jc.hd)).astype(np.float32)
    positions = pos + np.arange(S)
    yj, (kj, vj) = JL.attention(lj, jnp.asarray(x), jc, positions=jnp.asarray(positions),
                                kv_cache=(jnp.asarray(ck), jnp.asarray(cv)),
                                cache_pos=jnp.asarray(pos))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    yt, (kt, vt) = TL.attention(lt, torch.from_numpy(x), tc,
                                positions=torch.from_numpy(positions), kv_cache=(tk, tv),
                                cache_pos=pos)
    assert kt is tk and vt is tv      # written in place
    _close(yt, yj)
    _close(kt, kj)
    _close(vt, vj)


def _jax_prefill_decode(jc, jp, jt, B, max_len):
    """JAX's cache-filling prefill of ``jt``: tokens, or a batch dict."""
    state = JT.init_decode_state(jc, B, max_len)
    batch = jt if isinstance(jt, dict) else {"tokens": jt}
    return jax.jit(jsteps.make_prefill_decode(jc))(jp, state, batch)


@pytest.mark.parametrize("arch", ARCH_LIST)
def test_prefill_decode_state_and_steps_match_jax(arch):
    """The cache after ``make_prefill_decode``, then three decode steps
    from JAX's own state carried across."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(arch, jc)
    B, S, max_len = 2, 12, 20
    jb, tb = _batch(jc, B, S, seed=2)
    jl, js = _jax_prefill_decode(jc, jp, jb, B, max_len)
    ts = TT.init_decode_state(tc, B, max_len, "cpu")
    tl, ts = tsteps.make_prefill_decode(tc)(tp, ts, tb)
    _close(tl, jl)
    assert ts["pos"] == int(js["pos"]) == S
    assert sorted(ts) == sorted(js)
    for name in js:
        if name != "pos":
            _close(ts[name], js[name])

    jstep = jax.jit(jsteps.make_decode_step(jc))
    tstep = tsteps.make_decode_step(tc)
    ts = convert.decode_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    for i in range(3):
        jb, tb = _batch(jc, B, 1, seed=10 + i)
        jl, js = jstep(jp, js, jb)
        tl, ts = tstep(tp, ts, tb)
        _close(tl, jl)
    assert ts["pos"] == int(js["pos"]) == S + 3


@pytest.mark.parametrize("arch", SERVE_ARCHS)
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_serve_tokens_match_jax(arch, temperature):
    """Whole ``serve`` runs, each package drawing its own weights and prompt
    from PRNGKey(0): the same tokens, greedy and sampled."""
    jc, tc = _cfgs(arch)
    jo, _, _ = jserve.serve(jc, 2, 16, 8, temperature)
    to, tp_s, td_s = tserve.serve(tc, 2, 16, 8, temperature, device="cpu")
    assert to.dtype == torch.int32 and tp_s > 0 and td_s > 0
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_serve_on_carried_weights_matches_jax():
    jc, tc = _cfgs("llama3.2-1b")
    _, tp = _params("llama3.2-1b", jc)
    jo, _, _ = jserve.serve(jc, 2, 16, 8)
    to, _, _ = tserve.serve(tc, 2, 16, 8, device="cpu", params=tp)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_model_options_match_jax():
    """Sliding window, attention and final softcaps, sandwich norms, scaled
    embeddings, GeGLU and an untied head, on the llama layer stack."""
    over = dict(window=8, attn_softcap=20.0, final_softcap=15.0, post_norm=True,
                scale_embeddings=True, activation="gelu", tie_embeddings=False)
    jc, tc = _cfgs("llama3.2-1b", **over)
    jp = JT.init_params(jax.random.PRNGKey(3), jc)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jt, tt = _tokens(jc, 2, 24, seed=4)
    jl, _ = JT.forward(jp, jc, tokens=jt)
    _close(TT.forward(tp, tc, tokens=tt)[0], jl)


def test_convert_keeps_bfloat16_leaves():
    jc = jget("llama3.2-1b").reduced(compute_dtype="bfloat16")
    js = JT.init_decode_state(jc, 2, 8)
    js = {**js, "k": js["k"] + jnp.asarray(1.5, jnp.bfloat16)}
    ts = convert.decode_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert ts["pos"] == 0 and ts["k"].dtype == torch.bfloat16
    assert float(ts["k"].float().min()) == float(ts["k"].float().max()) == 1.5


def test_training_and_other_archs_are_not_ported_yet():
    """Training is ported (``tests/test_torch_train.py`` holds it against
    the reference): ``loss_fn`` gives a finite loss with its ``ce`` and
    ``aux``. Every arch of the JAX package is ported, so only a name
    neither package knows raises KeyError."""
    cfg = get_config("llama3.2-1b").reduced()
    _, tokens = _tokens(cfg, 2, cfg.seq_len)
    loss, metrics = TT.loss_fn(TT.init_params(prng.PRNGKey(0), cfg), cfg,
                               {"tokens": tokens, "labels": tokens})
    assert bool(torch.isfinite(loss)) and sorted(metrics) == ["aux", "ce"]
    with pytest.raises(KeyError):
        get_config("llama5")


def test_archs_of_the_port():
    assert sorted(ARCHS) == sorted(["llama3.2-1b", "mamba2-370m", "granite-3-8b",
                                    "gemma-7b", "gemma2-9b", "zamba2-7b",
                                    "qwen2-moe-a2.7b", "llama4-scout-17b-a16e",
                                    "internvl2-2b", "musicgen-medium"])
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jget(arch)), arch


# gemma2 at head dim 256 with a prompt longer than the reduced window (8):
# its local (even) and global (odd) layers mask differently.
GEMMA2_HD256 = {"head_dim": 256}


def test_gemma2_local_and_global_layers_mask_differently():
    jc, tc = _cfgs("gemma2-9b", **GEMMA2_HD256)
    jp, tp = _params("gemma2-9b", jc)
    x = np.random.default_rng(7).standard_normal((2, 24, jc.d_model)).astype(np.float32)
    lj = jax.tree.map(lambda v: v[0], jp["layers"]["attn"])
    lt = TT.tree_map(lambda v: v[0], tp["layers"]["attn"])
    outs = {}
    for local in (True, False):
        yj, _ = JL.attention(lj, jnp.asarray(x), jc, layer_is_local=local)
        yt, _ = TL.attention(lt, torch.from_numpy(x), tc, layer_is_local=local)
        _close(yt, yj)
        outs[local] = yt
    # The first `window` positions see the same keys in both; later ones do not.
    assert torch.equal(outs[True][:, :jc.window], outs[False][:, :jc.window])
    assert float((outs[True][:, jc.window:] - outs[False][:, jc.window:]).abs().max()) > 1e-3


def test_gemma2_hd256_forward_and_decode_match_jax():
    jc, tc = _cfgs("gemma2-9b", **GEMMA2_HD256)
    assert jc.hd == 256 and jc.window == 8
    jp, tp = _params("gemma2-9b", jc)
    jt, tt = _tokens(jc, 2, 24, seed=5)
    jl, _ = jax.jit(lambda p, t: JT.forward(p, jc, tokens=t))(jp, jt)
    _close(TT.forward(tp, tc, tokens=tt)[0], jl)
    B, S, max_len = 2, 20, 28
    jl, js = _jax_prefill_decode(jc, jp, jt[:, :S], B, max_len)
    ts = TT.init_decode_state(tc, B, max_len, "cpu")
    tl, ts = tsteps.make_prefill_decode(tc)(tp, ts, {"tokens": tt[:, :S]})
    _close(tl, jl)
    for name in ("k", "v"):
        _close(ts[name], js[name])
    jstep, tstep = jax.jit(jsteps.make_decode_step(jc)), tsteps.make_decode_step(tc)
    for i in range(4):
        jl, js = jstep(jp, js, {"tokens": jt[:, S + i:S + i + 1]})
        tl, ts = tstep(tp, ts, {"tokens": tt[:, S + i:S + i + 1]})
        _close(tl, jl)


def test_zamba2_decode_across_shared_attention_matches_jax():
    """Five Mamba2 layers with the shared block after layers 1 and 3 (two
    applications, each with its own KV cache) and a tail layer: the
    prefill's state and every decode step's logits and state against
    JAX's."""
    jc, tc = _cfgs("zamba2-7b", n_layers=5)
    assert jc.n_layers // jc.shared_attn_every == 2
    jp, tp = _params("zamba2-7b", jc)
    B, S, max_len = 2, 10, 16
    jt, tt = _tokens(jc, B, S + 4, seed=6)
    jl, js = _jax_prefill_decode(jc, jp, jt[:, :S], B, max_len)
    ts = TT.init_decode_state(tc, B, max_len, "cpu")
    tl, ts = tsteps.make_prefill_decode(tc)(tp, ts, {"tokens": tt[:, :S]})
    _close(tl, jl)
    assert ts["k"].shape == tuple(js["k"].shape) == (2, B, max_len, jc.n_kv_heads, jc.hd)
    jstep, tstep = jax.jit(jsteps.make_decode_step(jc)), tsteps.make_decode_step(tc)
    for i in range(4):
        jl, js = jstep(jp, js, {"tokens": jt[:, S + i:S + i + 1]})
        tl, ts = tstep(tp, ts, {"tokens": tt[:, S + i:S + i + 1]})
        _close(tl, jl)
        for name in ("conv", "ssd", "k", "v"):
            _close(ts[name], js[name])
    assert ts["pos"] == int(js["pos"]) == S + 4
    jl, _ = jax.jit(lambda p, t: JT.forward(p, jc, tokens=t))(jp, jt)
    _close(TT.forward(tp, tc, tokens=tt)[0], jl)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_blocked_draw_equals_one_draw(monkeypatch, lead):
    """``normal_leaf`` with a block of a few rows (counters offset per
    block, one key per leading index) gives the bits of one
    ``prng.normal`` of the whole stacked leaf."""
    key = prng.split(prng.PRNGKey(5), 3) if lead else prng.PRNGKey(5)
    want = prng.normal(key, (37, 11)) * TL.inv_sqrt(37)
    monkeypatch.setattr(TL, "DRAW_BLOCK", 50)       # 4 rows of 11 a block
    got = TL.normal_leaf(key, (37, 11), TL.inv_sqrt(37))
    assert got.shape == (*lead, 37, 11)
    assert torch.equal(got, want)


def test_blocked_init_params_equals_unblocked(monkeypatch):
    """A whole init drawn in blocks of 100 elements equals the one drawn
    in single blocks, leaf for leaf, the hybrid's shared block included."""
    tc = get_config("zamba2-7b").reduced()
    want = dict(_leaves(TT.init_params(prng.PRNGKey(2), tc)))
    monkeypatch.setattr(TL, "DRAW_BLOCK", 100)
    got = dict(_leaves(TT.init_params(prng.PRNGKey(2), tc)))
    assert sorted(got) == sorted(want) and "/shared_attn/attn/wq" in got
    for name, w in want.items():
        assert torch.equal(got[name], w), name


def test_serve_cli_on_cpu(capsys):
    tserve.main(["--arch", "mamba2-370m", "--reduced", "--device", "cpu",
                 "--batch", "1", "--prompt-len", "8", "--decode-steps", "3"])
    out = capsys.readouterr().out
    assert "decoded=3 tokens on cpu" in out and "ms/token" in out
