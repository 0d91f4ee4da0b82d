"""The port's async staleness-bounded islands against the JAX package and
against the port's barrier engine (mirrors ``tests/test_async_islands.py``
but its mesh case).

* Degradation: ``sync_policy="async"`` with ``max_staleness=0`` under the
  default all-ones schedule is bit-identical to the port's barrier engine,
  for ``minimize`` and ``minimize_many``, across de/pso/ga/sa.
* Record/replay: a run records the masks it used; feeding them back
  reproduces it bit for bit, and adopted staleness stays within the bound.
* Against the reference: the schedules, the mailbox primitives on the same
  arrays, and whole async runs (also with a portfolio) on the same keys
  within the engine bound, rtol 1e-4. GA and SA take JAX's normals and
  categorical samples through the ``jax_draws`` shim of
  ``tests/test_torch_engines.py``.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_engines import _fns, _partitionable, jax_draws  # noqa: E402,F401

from repro import core as jcore  # noqa: E402
from repro.core import migration as jmig  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import migration as tmig  # noqa: E402
from repro_torch.functions import benchmarks as tbm  # noqa: E402

RTOL = 1e-4
KEY = 7
F6 = tbm.FUNCTIONS["rastrigin"]
ALGOS = ["de", "pso", "ga", "sa"]


def _cfg(pkg=tcore, **kw):
    base = dict(n_islands=4, pop=16, dim=6, sync_every=3, migration="ring",
                n_migrants=2, max_evals=3000)
    base.update(kw)
    return pkg.IslandConfig(**base)


def _topt(algo, cfg, **kw):
    maker = None if algo is None else tcore.ALGORITHMS[algo]
    return tcore.IslandOptimizer(maker, cfg, device="cpu", **kw)


def _same(a, b):
    return (a.value == b.value and a.n_evals == b.n_evals and a.n_gens == b.n_gens
            and np.array_equal(np.asarray(a.arg), np.asarray(b.arg))
            and np.array_equal(np.asarray(a.history), np.asarray(b.history)))


def _assert_close(tr, jr):
    assert tr.n_evals == jr.n_evals and tr.n_gens == jr.n_gens
    np.testing.assert_allclose(tr.value, jr.value, rtol=RTOL)
    np.testing.assert_allclose(tr.history, np.asarray(jr.history), rtol=RTOL)


# -- degradation: max_staleness=0 is the barrier engine ------------------------------

@pytest.mark.parametrize("algo", ALGOS)
def test_async_staleness0_bit_identical_to_barrier(algo):
    cb = _cfg()
    ca = dataclasses.replace(cb, sync_policy="async", max_staleness=0)
    rb = _topt(algo, cb).minimize(F6, prng.PRNGKey(KEY))
    oa = _topt(algo, ca)
    ra = oa.minimize(F6, prng.PRNGKey(KEY))
    assert _same(rb, ra)
    # uniform cadence: every adoption is exactly 0 rounds stale
    assert oa.last_max_staleness == 0


def test_async_staleness0_minimize_many_bit_identical():
    cb = _cfg()
    ca = dataclasses.replace(cb, sync_policy="async", max_staleness=0)
    keys = prng.split(prng.PRNGKey(3), 3)
    mb = _topt("de", cb).minimize_many(F6, keys)
    oa = _topt("de", ca)
    ma = oa.minimize_many(F6, keys)
    for rb, ra in zip(mb, ma):
        assert _same(rb, ra)
    assert oa.last_max_staleness == 0 and oa.recorded_schedule.step.all()


def test_async_callback_path_bit_identical_to_resident():
    """The host-stepped path (``round_callback``) runs the same rounds."""
    ca = _cfg(sync_policy="async", max_staleness=2)
    seen = []
    r1 = _topt("pso", ca, schedule=tcore.AsyncSchedule(seed=4)).minimize(F6, prng.PRNGKey(KEY))
    o2 = _topt("pso", ca, schedule=tcore.AsyncSchedule(seed=4),
               round_callback=lambda r, a, v: seen.append(r))
    r2 = o2.minimize(F6, prng.PRNGKey(KEY))
    assert _same(r1, r2) and seen == list(range(len(r1.history)))
    assert 0 <= o2.last_max_staleness <= 2


def test_async_bucket_stepper_runs_all_ones_schedule():
    """A stepped async bucket (the service's path) runs the barrier cadence:
    each round equal to the barrier bucket's, and its state carries the
    mailbox leaves as int32."""
    cb = _cfg()
    ca = dataclasses.replace(cb, sync_policy="async")
    keys = prng.split(prng.PRNGKey(5), 2)
    sb, sa = _topt("de", cb).bucket_stepper(F6), _topt("de", ca).bucket_stepper(F6)
    (xb, kb), (xa, ka) = sb.init(keys), sa.init(keys)
    assert set(xa) - set(xb) == set(tmig.MAILBOX_KEYS)
    assert all(xa[k].dtype == torch.int32 for k in tmig.MAILBOX_KEYS[2:])
    shape = sa.state_shape(keys)
    assert {k: (tuple(v.shape), v.dtype) for k, v in shape.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in xa.items()}
    for r in range(sb.n_rounds):
        xb, vb = sb.step(xb, kb, r)
        xa, va = sa.step(xa, ka, r)
        assert torch.equal(vb, va)
    assert (xa["round_ctr"] == sa.n_rounds).all()


# -- record/replay -------------------------------------------------------------------

def test_recorded_schedule_replays_bit_identically():
    ca = _cfg(sync_policy="async", max_staleness=3)
    o1 = _topt("de", ca, schedule=tcore.AsyncSchedule(seed=11))
    r1 = o1.minimize(F6, prng.PRNGKey(KEY))
    rec = o1.recorded_schedule
    assert rec is not None and rec.step is not None
    o2 = _topt("de", ca, schedule=rec)
    r2 = o2.minimize(F6, prng.PRNGKey(KEY))
    assert _same(r1, r2)
    np.testing.assert_array_equal(o2.recorded_schedule.step, rec.step)
    np.testing.assert_array_equal(o2.recorded_schedule.deliver, rec.deliver)
    assert -1 <= o1.last_max_staleness <= 3


@pytest.mark.parametrize("seed,p_step,p_deliver", [(0, 0.3, 1.0), (5, 0.75, 0.75),
                                                   (123, 1.0, 0.3)])
def test_random_schedules_replay_and_bound_staleness(seed, p_step, p_deliver):
    cfg = _cfg(pop=8, max_evals=1500, sync_every=2, sync_policy="async", max_staleness=4)
    sched = tcore.AsyncSchedule(seed=seed, step_prob=p_step, deliver_prob=p_deliver)
    o1 = _topt("de", cfg, schedule=sched)
    r1 = o1.minimize(F6, prng.PRNGKey(KEY))
    assert -1 <= o1.last_max_staleness <= cfg.max_staleness
    o2 = _topt("de", cfg, schedule=o1.recorded_schedule)
    assert _same(r1, o2.minimize(F6, prng.PRNGKey(KEY)))
    assert o2.last_max_staleness == o1.last_max_staleness


def test_async_schedule_actually_desynchronizes():
    cb = _cfg()
    ca = dataclasses.replace(cb, sync_policy="async", max_staleness=3)
    rb = _topt("de", cb).minimize(F6, prng.PRNGKey(KEY))
    ra = _topt("de", ca, schedule=tcore.AsyncSchedule(seed=11)).minimize(F6, prng.PRNGKey(KEY))
    assert not np.array_equal(rb.history, ra.history)


def test_cadence_schedule_construction():
    s = tcore.AsyncSchedule.from_cadences([1, 2, 4], n_rounds=8)
    step, deliver = s.materialize(8, 3)
    assert step.shape == (8, 3) and deliver.all()
    assert step[:, 0].all()
    assert list(step[:, 2]) == [True, False, False, False] * 2
    with pytest.raises(ValueError, match="cadences"):
        tcore.AsyncSchedule.from_cadences([0, 1], 4)
    with pytest.raises(ValueError, match="shape"):
        s.materialize(7, 3)


@pytest.mark.parametrize("sched", [
    dict(seed=11), dict(seed=3, step_prob=0.5, deliver_prob=0.9), dict(),
    dict(step=np.eye(5, 4, dtype=bool)),
], ids=["seed", "probs", "ones", "explicit"])
def test_schedule_materialize_matches_jax(sched):
    t = tcore.AsyncSchedule(**sched).materialize(5, 4)
    j = jcore.AsyncSchedule(**sched).materialize(5, 4)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tcore.AsyncSchedule.from_cadences([4, 1, 2, 1], 6).materialize(6, 4),
                    jcore.AsyncSchedule.from_cadences([4, 1, 2, 1], 6).materialize(6, 4)):
        np.testing.assert_array_equal(a, b)


# -- mailbox edge cases and the primitives against the reference ----------------------

def test_mailbox_ring_full_overwrites_oldest():
    box = tmig.mailbox_init(n_islands=2, slots=2, k=1, dim=3)
    pop = torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(2, 4, 3)
    fit = torch.arange(2 * 4, dtype=torch.float32).reshape(2, 4)
    post = torch.ones(2, dtype=torch.bool)
    for tick in range(3):                       # 3 posts into 2 slots
        box = tmig.mailbox_post(box, pop + tick, fit, k=1, post=post)
        box = {**box, "round_ctr": box["round_ctr"] + 1}
    assert box["mbox_head"].tolist() == [1, 1]
    assert box["mbox_tag"][0].tolist() == [2, 1]
    torch.testing.assert_close(box["mbox_pop"][0, 0, 0], pop[1, 0] + 2, rtol=0, atol=0)


def test_mailbox_too_stale_migrant_dropped():
    box = tmig.mailbox_init(n_islands=2, slots=2, k=1, dim=3)
    pop = torch.ones((2, 4, 3))
    fit = torch.full((2, 4), 5.0)
    box = tmig.mailbox_post(box, pop * 0.5, fit * 0.0, k=1,
                            post=torch.ones(2, dtype=torch.bool))
    box = {**box, "round_ctr": torch.full((2,), 4, dtype=torch.int32)}
    gate = torch.ones(2, dtype=torch.bool)
    npop, nfit, nbox = tmig.mailbox_adopt(box, pop, fit, max_staleness=2, gate=gate)
    assert torch.equal(npop, pop) and torch.equal(nfit, fit)
    assert (nbox["stale_seen"] == -1).all()
    fresh = {**box, "round_ctr": torch.full((2,), 2, dtype=torch.int32)}
    npop, nfit, nbox = tmig.mailbox_adopt(fresh, pop, fit, max_staleness=2, gate=gate)
    assert not torch.equal(nfit, fit)
    assert (nbox["stale_seen"] == 2).all()
    assert (nbox["mbox_tag"] == -1).all()       # the adopted slot is consumed


def test_mailbox_adopt_picks_first_maximal_slot():
    """Two valid slots with the same tag: the first, as ``jnp.argmax``."""
    box = tmig.mailbox_init(n_islands=1, slots=3, k=1, dim=2)
    box["mbox_tag"] = torch.tensor([[0, 1, 1]], dtype=torch.int32)
    box["mbox_fit"] = torch.tensor([[[0.5], [0.25], [0.125]]])
    box["mbox_pop"] = torch.arange(6, dtype=torch.float32).reshape(1, 3, 1, 2)
    box["round_ctr"] = torch.tensor([1], dtype=torch.int32)
    pop, fit = torch.ones((1, 3, 2)), torch.full((1, 3), 9.0)
    gate = torch.ones(1, dtype=torch.bool)
    got = tmig.mailbox_adopt(box, pop, fit, 1, gate)
    want = jmig.mailbox_adopt({k: jnp.asarray(v.numpy()) for k, v in box.items()},
                              jnp.asarray(pop.numpy()), jnp.asarray(fit.numpy()), 1,
                              jnp.asarray(gate.numpy()))
    assert got[1].min() == 0.25
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for k, w in want[2].items():
        np.testing.assert_array_equal(got[2][k].numpy(), np.asarray(w), err_msg=k)


@pytest.mark.parametrize("jobs", [1, 3], ids=["one-job", "three-jobs"])
def test_mailbox_post_adopt_match_jax(jobs):
    """Ticks of post and adopt under random gates on the same arrays, with a
    leading job dimension (vmapped in JAX): the ring rolls within a job."""
    rng = np.random.default_rng(2)
    I, P, D, S, k = 4, 6, 3, 2, 2
    tbox = tmig.mailbox_init(jobs * I, S, k, D)
    tbox = {kk: v.reshape(jobs, I, *v.shape[1:]) for kk, v in tbox.items()}
    jbox = jax.vmap(lambda _: jmig.mailbox_init(I, S, k, D))(jnp.arange(jobs))
    post_j = jax.jit(jax.vmap(lambda b, p, f, g: jmig.mailbox_post(b, p, f, k, g)))
    adopt_j = jax.jit(jax.vmap(lambda b, p, f, g: jmig.mailbox_adopt(b, p, f, 1, g)))
    for tick in range(6):
        pop = rng.uniform(-1, 1, (jobs, I, P, D)).astype(np.float32)
        fit = rng.uniform(0, 1, (jobs, I, P)).astype(np.float32)
        post = rng.uniform(size=I) < 0.7
        gate = rng.uniform(size=I) < 0.7
        tbox = tmig.mailbox_post(tbox, torch.from_numpy(pop), torch.from_numpy(fit), k,
                                 torch.from_numpy(post))
        jbox = post_j(jbox, pop, fit, jnp.broadcast_to(post, (jobs, I)))
        tp, tf, tbox = tmig.mailbox_adopt(tbox, torch.from_numpy(pop),
                                          torch.from_numpy(fit), 1, torch.from_numpy(gate))
        jp, jf, jbox = adopt_j(jbox, pop, fit, jnp.broadcast_to(gate, (jobs, I)))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        for kk, w in jbox.items():
            assert tbox[kk].dtype == (torch.float32 if kk in ("mbox_pop", "mbox_fit")
                                      else torch.int32), kk
            np.testing.assert_array_equal(tbox[kk].numpy(), np.asarray(w), err_msg=kk)
        step = torch.from_numpy(rng.uniform(size=I) < 0.8)
        tbox = {**tbox, "round_ctr": tbox["round_ctr"] + step.to(torch.int32)}
        jbox = {**jbox, "round_ctr": jbox["round_ctr"] + jnp.asarray(step.numpy(), jnp.int32)}


@pytest.mark.parametrize("algo", ALGOS)
def test_async_single_island_is_selfloop_noop(algo):
    cb = _cfg(n_islands=1, pop=24, max_evals=1500)
    ca = dataclasses.replace(cb, sync_policy="async", max_staleness=2)
    rb = _topt(algo, cb).minimize(F6, prng.PRNGKey(KEY))
    oa = _topt(algo, ca)
    assert not oa._async
    assert _same(rb, oa.minimize(F6, prng.PRNGKey(KEY)))


def test_async_config_validation():
    with pytest.raises(ValueError, match="sync_policy"):
        _topt("de", _cfg(sync_policy="nope"))
    with pytest.raises(ValueError, match="starvation"):
        _topt("de", _cfg(sync_policy="async", migration="starvation"))
    with pytest.raises(ValueError, match="max_staleness"):
        _topt("de", _cfg(sync_policy="async", max_staleness=-1))
    with pytest.raises(ValueError, match="mailbox_slots"):
        _topt("de", _cfg(sync_policy="async", mailbox_slots=0))
    with pytest.raises(ValueError, match="AsyncSchedule"):
        _topt("de", _cfg(), schedule=tcore.AsyncSchedule(seed=1))
    with pytest.raises(ValueError, match="AsyncSchedule"):
        _topt("de", _cfg(n_islands=1, sync_policy="async"),
              schedule=tcore.AsyncSchedule(seed=1))


# -- whole async runs against the reference ---------------------------------------------

def _pair(algo, sched, dim=8, portfolio=(), params=None, many=False, **kw):
    jf, tf = _fns("rastrigin", dim)
    base = dict(n_islands=4, pop=16, dim=dim, sync_every=3, migration="ring",
                max_evals=4 * 16 * 37, sync_policy="async", max_staleness=2,
                portfolio=portfolio)
    base.update(kw)
    jcfg, tcfg = jcore.IslandConfig(**base), tcore.IslandConfig(**base)
    jmaker = None if portfolio else jcore.ALGORITHMS[algo]
    tmaker = None if portfolio else tcore.ALGORITHMS[algo]
    mk = (lambda: {k: dict(v) for k, v in params.items()}) if portfolio else (
        lambda: dict(params or {}))
    jo = jcore.IslandOptimizer(jmaker, jcfg, params=mk(), schedule=jcore.AsyncSchedule(**sched))
    to = tcore.IslandOptimizer(tmaker, tcfg, params=mk(), device="cpu",
                               schedule=tcore.AsyncSchedule(**sched))
    if many:
        seeds = (0, 9)
        got = to.minimize_many(tf, torch.stack([prng.PRNGKey(s) for s in seeds]))
        want = jo.minimize_many(jf, jnp.stack([jax.random.PRNGKey(s) for s in seeds]))
    else:
        got = [to.minimize(tf, prng.PRNGKey(KEY))]
        want = [jo.minimize(jf, jax.random.PRNGKey(KEY))]
    for tr, jr in zip(got, want):
        _assert_close(tr, jr)
    assert to.last_max_staleness == jo.last_max_staleness
    np.testing.assert_array_equal(to.recorded_schedule.step, jo.recorded_schedule.step)
    return got


@pytest.mark.parametrize("algo,params", [
    ("de", {}), ("pso", {}), ("sa", {"T0": 10.0}),
], ids=["de", "pso", "sa"])
def test_async_matches_jax(jax_draws, algo, params):
    """A seeded random schedule (0.75/0.75) on the same keys."""
    _pair(algo, dict(seed=0), params=params)


def test_async_ga_matches_jax(jax_draws):
    _pair("ga", dict(seed=0), dim=32, params={"pm": 0.3}, max_evals=4 * 16 * 100)


def test_async_straggler_cadence_matches_jax(jax_draws):
    """The straggler shape of ``benchmarks/distributed.py``: island 0 on
    cadence 4, the rest every tick; staleness up to 4 is adopted."""
    sched = tcore.AsyncSchedule.from_cadences([4, 1, 1, 1], 12)
    _pair("de", dict(step=sched.step, deliver=sched.deliver), max_staleness=4,
          max_evals=4 * 16 + 12 * 3 * 4 * 16)


def test_async_minimize_many_matches_jax(jax_draws):
    """Every job replays one schedule, in both packages."""
    _pair("de", dict(seed=0), many=True, share_incumbent=True)


def test_async_portfolio_matches_jax(jax_draws):
    """Portfolio and async together: mixed policies behind the mailbox."""
    got = _pair(None, dict(seed=0), dim=32, portfolio=("de", "pso", "sa", "ga"),
                params={"sa": {"T0": 50.0}, "ga": {"pm": 0.3}}, n_islands=8,
                max_evals=8 * 16 * 31)
    assert np.isfinite(got[0].value)


def test_async_portfolio_minimize_many_matches_minimize():
    """Within the port, a job of an async portfolio bucket is a standalone
    run, bit for bit."""
    cfg = _cfg(n_islands=4, portfolio=("de", "pso"), sync_policy="async", max_staleness=1)
    seeds = (1, 2)
    many = _topt(None, cfg, schedule=tcore.AsyncSchedule(seed=6)).minimize_many(
        F6, torch.stack([prng.PRNGKey(s) for s in seeds]))
    for s, got in zip(seeds, many):
        solo = _topt(None, cfg, schedule=tcore.AsyncSchedule(seed=6)).minimize(
            F6, prng.PRNGKey(s))
        assert _same(solo, got)


def test_async_round_from_jax_state_matches_jax(jax_draws):
    """A round of the port started from JAX's async state (mailbox leaves
    carried across as int32) against JAX's next round, on a tick that
    steps and delivers for some islands only."""
    jf, tf = _fns("rastrigin", 8)
    kw = dict(n_islands=4, pop=16, dim=8, sync_every=3, sync_policy="async",
              max_staleness=2, mailbox_slots=2)
    jo = jcore.IslandOptimizer(jcore.ALGORITHMS["pso"], _cfg(jcore, **kw))
    to = tcore.IslandOptimizer(tcore.ALGORITHMS["pso"], _cfg(tcore, **kw), device="cpu")
    jalgo, talgo = jo._build(jf), to._build(tf)
    jround = jax.jit(jo._async_round_fn(jalgo))
    state = jo._init_state(jalgo, jax.random.PRNGKey(3))
    ones = jnp.ones(4, bool)
    for r in range(3):                       # fill the mailboxes
        state = jround(state, jax.random.PRNGKey(10 + r), ones, ones)
    step = np.asarray([True, False, True, True])
    deliver = np.asarray([True, True, False, True])
    rk = jax.random.PRNGKey(4)
    want = jround(state, rk, jnp.asarray(step), jnp.asarray(deliver))
    tstate = convert.state_from_numpy({k: np.asarray(v) for k, v in state.items()}, "cpu")
    assert tstate["mbox_tag"].dtype == torch.int32
    got = to._round_fn(talgo)(tstate, torch.from_numpy(np.asarray(rk).astype(np.int64)),
                              torch.from_numpy(step), torch.from_numpy(deliver))
    back = convert.state_to_jax(got, 4)
    for k, w in want.items():
        w = np.asarray(w)
        assert back[k].dtype == w.dtype, k
        np.testing.assert_allclose(back[k], w, rtol=RTOL, atol=1e-5, err_msg=k)


# -- the service ------------------------------------------------------------------

def test_scheduler_async_bucket_checkpoints_and_resumes(tmp_path):
    """An async bucket runs stepped: abandoned at round 6 with snapshots
    every 2 rounds, a fresh scheduler's ``resume`` restores its int32
    mailbox leaves and finishes it bit-identically to ``minimize``."""
    req = dict(fn="rastrigin", dim=6, pop=16, n_islands=4, sync_every=2,
               max_evals=4 * 16 * 25, sync_policy="async", max_staleness=1)
    fired = threading.Event()

    def hook(key, r):
        if r == 6:
            fired.set()
            raise tcore.AbandonRun(f"injected kill at round {r}")

    sched = tcore.ShapeBucketScheduler(device="cpu", workers=1, checkpoint_dir=str(tmp_path),
                                       checkpoint_every=2, fault_hook=hook)
    sched.submit(tcore.OptRequest(seed=3, **req), job_id="a")
    sched.flush()
    assert fired.wait(120), "fault hook never fired"
    deadline = time.monotonic() + 120
    while sched._ready or sched.poll("a").status != "running":
        assert time.monotonic() < deadline, "the worker never let go"
        time.sleep(0.002)
    time.sleep(0.05)
    sched.close()
    fresh = tcore.ShapeBucketScheduler(device="cpu")
    summary = fresh.resume(str(tmp_path))
    assert summary["failed"] == [] and summary["resumed"][0]["round"] == 6
    got = fresh.result("a")
    assert got.status == "done"
    cfg = _cfg(n_islands=4, pop=16, dim=6, sync_every=2, max_evals=4 * 16 * 25,
               sync_policy="async", max_staleness=1)
    assert _same(got.result, _topt("de", cfg).minimize(F6, prng.PRNGKey(3)))
