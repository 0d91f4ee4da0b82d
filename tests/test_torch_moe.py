"""The port's MoE layers and 16-bit parameters against the JAX package's.

qwen2-moe-a2.7b (top-4 of its routed experts plus a shared expert) and
llama4-scout-17b-a16e (top-1 plus a shared expert) at reduced size, in
float32 on the JAX weights carried across with
``convert.params_from_numpy``: the ``moe`` layer's output and aux loss
within 1e-5 of the largest |value|, its routing (each (token, k)'s expert
``eidx`` and slot ``dest``) identical, also with ``moe_groups`` > 1,
forced drops and an all-tie router; ``forward``, prefill, the
cache-filling prefill and decode steps (capacity 1 at decode, as the
reference drops most colliding pairs there) within the same bound (greedy
and sampled ``serve`` tokens are held identical with every arch's in
``tests/test_torch_models.py``). ``init_params`` with ``param_dtype="bfloat16"``
leaf by leaf within one ulp of the type.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_models import (_close, _jax_prefill_decode, _leaves,  # noqa: E402,F401
                               _partitionable, _tokens)

from repro.configs import get_config as jget  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

QWEN, LLAMA4 = "qwen2-moe-a2.7b", "llama4-scout-17b-a16e"
MOE_ARCHS = [QWEN, LLAMA4]
# qwen2's own top-4 (``reduced()`` caps top_k at 2) over 8 experts.
QWEN_K4 = {"num_experts": 8, "top_k": 4}


def _cfgs(arch, **over):
    return jget(arch).reduced(**over), get_config(arch).reduced(**over)


_PARAMS = {}


def _params(jc):
    """JAX init_params(PRNGKey(0)), jitted (both packages run on these
    weights), and its port copy; the routing's own settings draw nothing,
    so configs that differ only there share one."""
    key = dataclasses.replace(jc, moe_groups=1, capacity_factor=1.25)
    if key not in _PARAMS:
        jp = jax.jit(JT.init_params, static_argnums=1)(jax.random.PRNGKey(0), key)
        _PARAMS[key] = jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return _PARAMS[key]


def _layer_moe(jp, tp, i=0):
    return (jax.tree.map(lambda v: v[i], jp["layers"]["moe"]),
            TT.tree_map(lambda v: v[i], tp["layers"]["moe"]))


def _jax_routing(lp, x, cfg):
    """The reference's (eidx (G, Tg, K), dest (G, Tg*K)) for x (B, S, D):
    its own top_k on its own router probabilities, and ``dest`` from its
    ``_moe_dispatch_group`` under ``vmap``, grouped as ``moe`` groups."""
    B, S, D = x.shape
    T = B * S
    G = cfg.moe_groups if T % cfg.moe_groups == 0 and T >= cfg.moe_groups else 1
    cap = max(1, int(cfg.capacity_factor * (T // G) * cfg.top_k / cfg.num_experts))

    @jax.jit
    def route(lp, x):
        xt = x.reshape(G, T // G, D)
        probs = jax.nn.softmax((xt @ lp["router"]).astype(jnp.float32), axis=-1)
        _, eidx = jax.lax.top_k(probs, cfg.top_k)
        _, dest, _, _ = jax.vmap(lambda xg: JL._moe_dispatch_group(lp, xg, cfg, cap))(xt)
        return eidx, dest

    eidx, dest = route(lp, x)
    return np.asarray(eidx), np.asarray(dest), cap


@pytest.fixture
def routing(monkeypatch):
    """Records every ``moe`` call's routing in the port: (eidx, dest, cap),
    the experts through ``ROUTING_HOOK`` (which changes nothing) and the
    slots from ``moe_dispatch``."""
    seen, experts = [], []

    def hook(probs, eidx):
        experts.append(eidx)
        return eidx

    inner = TL.moe_dispatch

    def dispatch(params, xt, cfg, cap):
        out = inner(params, xt, cfg, cap)
        seen.append((experts.pop(), out[1], cap))
        return out

    monkeypatch.setattr(TL, "ROUTING_HOOK", hook)
    monkeypatch.setattr(TL, "moe_dispatch", dispatch)
    return seen


@pytest.mark.parametrize("arch,over,B,S,zero_router", [
    (QWEN, QWEN_K4, 2, 16, False),                             # K = 4, shared expert
    (LLAMA4, {}, 2, 16, False),                                # K = 1, shared expert
    (QWEN, {**QWEN_K4, "moe_groups": 4}, 2, 16, False),        # 4 groups of 8 tokens
    (LLAMA4, {"moe_groups": 4}, 2, 7, False),                  # T = 14: one group
    (QWEN, {**QWEN_K4, "capacity_factor": 0.25}, 2, 16, False),  # forced drops
    (LLAMA4, {"capacity_factor": 0.3, "moe_groups": 2}, 2, 12, False),
    (QWEN, QWEN_K4, 2, 8, True),                               # every probability ties
    (LLAMA4, {}, 2, 8, True),
])
def test_moe_layer_matches_jax(routing, arch, over, B, S, zero_router):
    jc, tc = _cfgs(arch, **over)
    jp, tp = _params(jc)
    lj, lt = _layer_moe(jp, tp)
    if zero_router:
        lj = {**lj, "router": jnp.zeros_like(lj["router"])}
        lt = {**lt, "router": torch.zeros_like(lt["router"])}
    x = np.random.default_rng(S + B).standard_normal((B, S, jc.d_model)).astype(np.float32)
    yj, auxj = jax.jit(lambda lp, x: JL.moe(lp, x, jc))(lj, jnp.asarray(x))
    yt, auxt = TL.moe(lt, torch.from_numpy(x), tc)
    _close(yt, yj)
    _close(auxt, auxj)
    eidx, dest, cap = _jax_routing(lj, jnp.asarray(x), jc)
    (teidx, tdest, tcap), = routing
    assert tcap == cap
    np.testing.assert_array_equal(teidx.numpy(), eidx)
    np.testing.assert_array_equal(tdest.numpy(), dest)
    E, K = jc.num_experts, jc.top_k
    dropped = int((dest == E * cap).sum())
    if over.get("capacity_factor", 1.25) < 1:
        assert dropped > 0
    if zero_router:
        # jax.lax.top_k takes the lower index first: experts 0..K-1.
        assert (eidx == np.arange(K)).all()
        assert dropped == B * S * K - K * cap


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_and_aux_match_jax(arch):
    over = QWEN_K4 if arch == QWEN else {}
    jc, tc = _cfgs(arch, **over, moe_groups=4)
    jp, tp = _params(jc)
    jt, tt = _tokens(jc, 2, 24)
    jl, jaux = jax.jit(lambda p, t: JT.forward(p, jc, tokens=t))(jp, jt)
    tl, taux = TT.forward(tp, tc, tokens=tt)
    _close(tl, jl)
    _close(taux, jaux)
    assert float(taux) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_and_decode_match_jax(routing, arch):
    """The prefill step; the cache-filling prefill, its cache, then decode
    steps teacher-forced from JAX's state carried across: at batch 2 each
    step routes 2 tokens with capacity 1, dropping colliding pairs."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc)
    B, S, max_len = 2, 12, 20
    jt, tt = _tokens(jc, B, S + 4, seed=3)
    want = jax.jit(jsteps.make_prefill_step(jc))(jp, {"tokens": jt[:, :S]})
    _close(tsteps.make_prefill_step(tc)(tp, {"tokens": tt[:, :S]}), want)
    jl, js = _jax_prefill_decode(jc, jp, jt[:, :S], B, max_len)
    ts = TT.init_decode_state(tc, B, max_len, "cpu")
    tl, ts = tsteps.make_prefill_decode(tc)(tp, ts, {"tokens": tt[:, :S]})
    _close(tl, jl)
    for name in ("k", "v"):
        _close(ts[name], js[name])
    routing.clear()
    jstep, tstep = jax.jit(jsteps.make_decode_step(jc)), tsteps.make_decode_step(tc)
    ts = convert.decode_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    for i in range(4):
        jl, js = jstep(jp, js, {"tokens": jt[:, S + i:S + i + 1]})
        tl, ts = tstep(tp, ts, {"tokens": tt[:, S + i:S + i + 1]})
        _close(tl, jl)
    assert {cap for _, _, cap in routing} == {1}
    assert len(routing) == 4 * jc.n_layers


def test_routing_hook_replays_experts(monkeypatch):
    """The experts ``ROUTING_HOOK`` returns are the ones dispatched to, with
    their gates: a negated router replaying the first router's experts
    fills the same slots from the same tokens, its gates its own
    probabilities at those experts (the card-vs-CPU check's replay)."""
    jc, tc = _cfgs(QWEN, **QWEN_K4)
    _, lt = _layer_moe(*_params(jc))
    xt = torch.from_numpy(np.random.default_rng(9).standard_normal((1, 16, jc.d_model))
                          .astype(np.float32))
    seen = []
    monkeypatch.setattr(TL, "ROUTING_HOOK", lambda p, e: seen.append(e) or e)
    eb, dest, _, _ = TL.moe_dispatch(lt, xt, tc, 6)
    flipped = {**lt, "router": -lt["router"]}
    monkeypatch.setattr(TL, "ROUTING_HOOK", None)
    _, own_dest, _, _ = TL.moe_dispatch(flipped, xt, tc, 6)
    assert not torch.equal(own_dest, dest)
    monkeypatch.setattr(TL, "ROUTING_HOOK", lambda p, e: seen[0])
    eb2, dest2, gate2, _ = TL.moe_dispatch(flipped, xt, tc, 6)
    assert torch.equal(dest2, dest) and torch.equal(eb2, eb)
    probs = torch.softmax(xt @ flipped["router"], dim=-1).gather(-1, seen[0])
    torch.testing.assert_close(gate2, probs / probs.sum(-1, keepdim=True))


def test_top_k_takes_the_lower_index_on_ties():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                          [0.4, 0.1, 0.4, 0.1]])
    vals, idx = TL.top_k(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def _ulps16(a, b):
    ia = a.contiguous().view(torch.int16).numpy().astype(np.int64) & 0xFFFF
    ib = np.asarray(b).view(np.uint16).astype(np.int64)
    ia = np.where(ia >= 0x8000, 0x8000 - ia, ia)
    ib = np.where(ib >= 0x8000, 0x8000 - ib, ib)
    return np.abs(ia - ib)


@pytest.mark.parametrize("arch", [QWEN, "llama3.2-1b", "mamba2-370m"])
def test_init_params_bfloat16_within_one_ulp(arch):
    jc, tc = _cfgs(arch, param_dtype="bfloat16")
    jp = dict(_leaves(JT.init_params(jax.random.PRNGKey(0), jc)))
    tp = dict(_leaves(TT.init_params(prng.PRNGKey(0), tc)))
    assert sorted(tp) == sorted(jp)
    n_diff = n = 0
    for name, w in jp.items():
        g = tp[name]
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, name
        assert tuple(g.shape) == w.shape, name
        ulp = _ulps16(g, w)
        assert ulp.max() <= 1, (name, int(ulp.max()))
        n_diff, n = n_diff + int((ulp > 0).sum()), n + ulp.size
    print(f"{arch} bfloat16 init: {n_diff} of {n} elements differ by one ulp")


def test_bfloat16_params_forward_matches_jax():
    """qwen2-moe with bfloat16 parameters and compute (the card's form):
    the port on the JAX weights within bfloat16's bound of JAX's logits."""
    jc, tc = _cfgs(QWEN, param_dtype="bfloat16", compute_dtype="bfloat16")
    jp, tp = _params(jc)
    assert all(t.dtype == torch.bfloat16 for _, t in _leaves(tp))
    jt, tt = _tokens(jc, 2, 16, seed=5)
    jl, _ = jax.jit(lambda p, t: JT.forward(p, jc, tokens=t))(jp, jt)
    tl, _ = TT.forward(tp, tc, tokens=tt)
    _close(tl, jl, tol=2e-2)


def test_convert_carries_moe_and_frontend_subtrees():
    jc = dataclasses.replace(jget(QWEN).reduced(param_dtype="bfloat16"),
                             frontend="vlm_stub", frontend_dim=32, frontend_len=4)
    jp = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(1), jc))
    tp = convert.params_from_numpy(jp, "cpu")
    want = dict(_leaves(jp))
    got = dict(_leaves(tp))
    assert sorted(got) == sorted(want)
    assert "/frontend/proj" in got and "/layers/moe/shared/w_up" in got
    for name, w in want.items():
        assert got[name].dtype == torch.bfloat16, name
        assert np.array_equal(got[name].contiguous().view(torch.int16).numpy(),
                              w.view(np.int16)), name


@pytest.mark.parametrize("arch,over,B,S,zero_router", [
    (QWEN, {**QWEN_K4, "moe_groups": 4}, 4, 16, False),                   # 2 groups a rank
    (QWEN, {**QWEN_K4, "moe_groups": 2, "capacity_factor": 0.25}, 2, 16, False),  # drops
    (LLAMA4, {"moe_groups": 4, "capacity_factor": 0.3}, 2, 12, False),
    (LLAMA4, {"moe_groups": 2}, 2, 8, True),                               # every tie
    (QWEN, {**QWEN_K4, "moe_groups": 4}, 2, 8, True),
])
def test_group_local_dispatch_stitches_to_the_unsharded_bits(arch, over, B, S, zero_router):
    """What each of 2 ranks computes when its batch rows are split over
    ``data`` (``moe`` on a DTensor: its own rows' groups, ``_dispatch_rows``
    on its local tensor), stitched back along the groups, is the unsharded
    dispatch's buffers, slots, gates and aux bit for bit: with capacity
    drops forced and with an all-tie router (the lower expert index first)
    too. On the replicated route (G not a multiple of the ranks, or 1) a
    rank runs the unsharded call itself."""
    _, tc = _cfgs(arch, **over)
    _, lt = _layer_moe(*_params(_cfgs(arch, **over)[0]))
    router = torch.zeros_like(lt["router"]) if zero_router else lt["router"]
    x = torch.from_numpy(np.random.default_rng(B * S).standard_normal(
        (B, S, tc.d_model)).astype(np.float32))
    G, cap = TL._groups(tc, B * S)
    Tg = B * S // G
    assert G % 2 == 0
    want = TL._dispatch_rows(x, router, tc, cap, Tg)
    ranks = [TL._dispatch_rows(rows, router, tc, cap, Tg) for rows in x.chunk(2)]
    for w, *parts in zip(want, *ranks):
        got = torch.cat(parts)
        assert got.dtype == w.dtype and got.numpy().tobytes() == w.numpy().tobytes()
    dropped = int((want[1] == tc.num_experts * cap).sum())
    if over.get("capacity_factor", 1.25) < 1:
        assert dropped > 0
    if zero_router:
        assert dropped == G * (Tg * tc.top_k - tc.top_k * cap)
