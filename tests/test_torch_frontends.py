"""The port's stub frontends and sinusoidal positions against the JAX
package's.

internvl2-2b (``vlm_stub``: patch embeddings through ``frontend.proj`` in
front of the tokens) and musicgen-medium (``audio_stub``: frame embeddings
in place of tokens, sinusoidal positions, an untied head and no embedding
table) at reduced size in float32, on the JAX weights carried across with
``convert.params_from_numpy``: logits within 1e-5 of the largest |value|.
The reference adds the sinusoidal positions from 0 on every call, so a
decode step adds position 0 whatever the cache position; the port keeps
that. A recurrent arch steps frame embeddings through its cache one
position at a time.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_models import (_close, _embeds, _jax_prefill_decode,  # noqa: E402,F401
                               _partitionable, _tokens)

from repro.configs import get_config as jget  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

VLM, AUDIO = "internvl2-2b", "musicgen-medium"
_PARAMS = {}


def _setup(arch, **over):
    """Both configs and the jitted JAX init_params(PRNGKey(0)) with its
    port copy (both packages run on these weights)."""
    jc, tc = jget(arch).reduced(**over), get_config(arch).reduced(**over)
    if jc not in _PARAMS:
        jp = jax.jit(JT.init_params, static_argnums=1)(jax.random.PRNGKey(0), jc)
        _PARAMS[jc] = jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return (jc, tc, *_PARAMS[jc])


@pytest.mark.parametrize("d", [64, 1536])
def test_sinusoidal_pos_matches_jax(d):
    """Against JAX's eager form, whose float32 ``pow`` the port's rounded
    float64 one equals at d = 64 and misses by one ulp at one frequency of
    musicgen's 768 (the angle then moves by an ulp times the position):
    within the spread between JAX's own jitted and eager forms, 3e-5 at
    300 positions, and within 1e-6 at d = 64."""
    pos = np.arange(300)
    eager = np.asarray(JL.sinusoidal_pos(pos, d))
    jitted = np.asarray(jax.jit(lambda: JL.sinusoidal_pos(jnp.arange(300), d))())
    got = TL.sinusoidal_pos(torch.from_numpy(pos), d).numpy()
    err = float(np.abs(got - eager).max())
    assert got.dtype == np.float32 and got.shape == (300, d)
    assert err <= max(float(np.abs(jitted - eager).max()), 1e-6), err


def test_frontend_params_follow_jax():
    """No embedding table for the audio frontend, its own head; the VLM's
    projection beside a tied embedding."""
    for arch, keys in ((VLM, {"embed", "frontend"}), (AUDIO, {"lm_head", "frontend"})):
        jc, tc, jp, tp = _setup(arch)
        assert set(jp) - {"final_norm", "layers"} == keys
        assert set(tp) == set(jp)
        assert tuple(tp["frontend"]["proj"].shape) == (jc.frontend_dim, jc.d_model)


def test_vlm_forward_and_prefill_match_jax():
    """Patch embeddings plus tokens: forward logits over both, and the
    prefill step's last position."""
    jc, tc, jp, tp = _setup(VLM)
    je, te = _embeds(jc, 2, jc.frontend_len, seed=1)
    jt, tt = _tokens(jc, 2, 20, seed=2)
    jl, _ = jax.jit(lambda p, e, t: JT.forward(p, jc, tokens=t, embeds=e))(jp, je, jt)
    tl, _ = TT.forward(tp, tc, tokens=tt, embeds=te)
    assert tl.shape == (2, jc.frontend_len + 20, tc.padded_vocab)
    _close(tl, jl)
    want = jax.jit(jsteps.make_prefill_step(jc))(jp, {"tokens": jt, "embeds": je})
    _close(tsteps.make_prefill_step(tc)(tp, {"tokens": tt, "embeds": te}), want)


def test_vlm_prefill_decode_then_tokens_match_jax():
    """The cache filled from patch embeddings plus tokens, then decode
    steps from tokens alone, teacher-forced."""
    jc, tc, jp, tp = _setup(VLM)
    B, S, max_len = 2, 10, 24
    je, te = _embeds(jc, B, jc.frontend_len, seed=3)
    jt, tt = _tokens(jc, B, S + 3, seed=4)
    jl, js = _jax_prefill_decode(jc, jp, {"tokens": jt[:, :S], "embeds": je}, B, max_len)
    ts = TT.init_decode_state(tc, B, max_len, "cpu")
    tl, ts = tsteps.make_prefill_decode(tc)(tp, ts, {"tokens": tt[:, :S], "embeds": te})
    _close(tl, jl)
    assert ts["pos"] == int(js["pos"]) == jc.frontend_len + S
    jstep, tstep = jax.jit(jsteps.make_decode_step(jc)), tsteps.make_decode_step(tc)
    for i in range(3):
        jl, js = jstep(jp, js, {"tokens": jt[:, S + i:S + i + 1]})
        tl, ts = tstep(tp, ts, {"tokens": tt[:, S + i:S + i + 1]})
        _close(tl, jl)
    for name in ("k", "v"):
        _close(ts[name], js[name])


def test_audio_forward_matches_jax():
    jc, tc, jp, tp = _setup(AUDIO)
    je, te = _embeds(jc, 2, 40, seed=5)
    jl, _ = jax.jit(lambda p, e: JT.forward(p, jc, embeds=e))(jp, je)
    tl, _ = TT.forward(tp, tc, embeds=te)
    _close(tl, jl)


def test_audio_prefill_decode_and_steps_match_jax():
    """musicgen through ``launch.steps`` on frame embeddings: the
    cache-filling prefill, then decode steps, each of which adds the
    sinusoidal position 0 (the reference's positions restart on every
    call), against JAX's."""
    jc, tc, jp, tp = _setup(AUDIO)
    B, S, max_len = 2, 16, 24
    je, te = _embeds(jc, B, S + 4, seed=6)
    jl, js = _jax_prefill_decode(jc, jp, {"embeds": je[:, :S]}, B, max_len)
    ts = TT.init_decode_state(tc, B, max_len, "cpu")
    tl, ts = tsteps.make_prefill_decode(tc)(tp, ts, {"embeds": te[:, :S]})
    _close(tl, jl)
    jstep, tstep = jax.jit(jsteps.make_decode_step(jc)), tsteps.make_decode_step(tc)
    for i in range(4):
        jl, js = jstep(jp, js, {"embeds": je[:, S + i:S + i + 1]})
        tl, ts = tstep(tp, ts, {"embeds": te[:, S + i:S + i + 1]})
        _close(tl, jl)
    for name in ("k", "v"):
        _close(ts[name], js[name])
    assert ts["pos"] == int(js["pos"]) == S + 4


def test_audio_decode_step_adds_position_zero():
    """A one-frame input at any cache position gets sin(0) = 0 on the first
    half and cos(0) = 1 on the second, in both packages."""
    jc, tc, jp, tp = _setup(AUDIO)
    je, te = _embeds(jc, 2, 1, seed=7)
    x = TT.embed_inputs(tp, tc, None, te)
    proj = te @ tp["frontend"]["proj"]
    half = tc.d_model // 2
    want = torch.cat([torch.zeros(half), torch.ones(half)])
    torch.testing.assert_close(x - proj, want.expand_as(x), rtol=0, atol=1e-6)
    _close(x, JT.embed_inputs(jp, jc, None, je))
    # At cache position 5 the step also attends to five (zero) cached keys,
    # so its logits differ from the step at 0 though its embedding is the
    # same; JAX's step at position 5 agrees.
    state = TT.init_decode_state(tc, 2, 8, "cpu")
    at0, _ = tsteps.make_decode_step(tc)(tp, state, {"embeds": te})
    state = TT.init_decode_state(tc, 2, 8, "cpu")
    state["pos"] = 5
    at5, _ = tsteps.make_decode_step(tc)(tp, state, {"embeds": te})
    assert not torch.equal(at0, at5)      # a cache of five zero keys differs
    jst = JT.init_decode_state(jc, 2, 8)
    jl, _ = jax.jit(jsteps.make_decode_step(jc))(jp, {**jst, "pos": jnp.asarray(5)},
                                                 {"embeds": je})
    _close(at5, jl)


def test_recurrent_prefill_steps_frame_embeddings_like_jax():
    """A Mamba2 stack with a frontend: ``make_prefill_decode`` steps the
    frame embeddings through the cache one at a time, as JAX's scan does."""
    over = dict(frontend="vlm_stub", frontend_dim=32)
    jc, tc, jp, tp = _setup("mamba2-370m", **over)
    B, S, max_len = 2, 6, 10
    je, te = _embeds(jc, B, S, seed=8)
    jl, js = _jax_prefill_decode(jc, jp, {"embeds": je}, B, max_len)
    ts = TT.init_decode_state(tc, B, max_len, "cpu")
    tl, ts = tsteps.make_prefill_decode(tc)(tp, ts, {"embeds": te})
    _close(tl, jl)
    for name in ("conv", "ssd"):
        _close(ts[name], js[name])
    assert ts["pos"] == int(js["pos"]) == S


def test_serve_cli_refuses_audio():
    with pytest.raises(SystemExit, match="audio arch serving needs frame embeddings"):
        tserve.main(["--arch", AUDIO, "--reduced", "--device", "cpu"])


def test_vlm_serve_runs_on_tokens():
    """The VLM serves from a token prompt, as the reference's ``serve``."""
    tc = get_config(VLM).reduced()
    out, _, _ = tserve.serve(tc, 2, 8, 3, device="cpu")
    assert out.shape == (2, 3) and bool(((out >= 0) & (out < tc.vocab)).all())
