"""The port's multi-job service against the JAX package and against its own
contracts: the request/response types, ``CheckpointStore``, the
``ShapeBucketScheduler`` (bucketing, bit-identity with ``minimize``,
streaming progress, cancellation, priority lanes, backpressure, LRU caps,
fault isolation, kill and resume) and ``launch.opt_serve`` (in process, over
stdin and over TCP with a SIGKILL).

The service behaviours are those ``tests/test_scheduler.py`` and
``tests/test_service.py`` hold the reference to, on the plain PyTorch path
(``device="cpu"``). One JSONL script goes through both packages' services:
the replies must have the same keys, ids, statuses, errors and accounting,
and values within the engine bound of the parity contract (rtol 1e-4, never
tighter than the reference's own fused/unfused gap of 1.36e-5 relative,
``ROADMAP.md``). Every wait on a thread or a subprocess has its own timeout.
"""
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_engines import _partitionable  # noqa: E402,F401

from repro.checkpoint import store as jstore  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.launch import opt_serve as jserve  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.functions import get  # noqa: E402
from repro_torch.launch import opt_serve as tserve  # noqa: E402

RTOL = 1e-4
WAIT = 120.0      # seconds any one wait on a thread or subprocess may take
SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")


def _req(seed=0, **kw):
    base = dict(fn="sphere", algo="de", dim=4, pop=16, n_islands=2,
                sync_every=5, max_evals=1500, migration="ring")
    base.update(kw)
    return tapi.OptRequest(seed=seed, **base)


def _long_req(seed=3, **kw):
    """Many cheap sync rounds to stream, cancel and checkpoint at:
    2 islands x pop 16 x sync_every 1 = 32 evaluations a round."""
    base = dict(fn="rastrigin", algo="de", dim=6, pop=16, n_islands=2,
                sync_every=1, max_evals=32 + 32 * 120, migration="ring")
    base.update(kw)
    return tapi.OptRequest(seed=seed, **base)


def _sched(**kw):
    return tcore.ShapeBucketScheduler(device="cpu", **kw)


def _sequential(req):
    cfg = tcore.IslandConfig(
        n_islands=req.n_islands, pop=req.pop, dim=req.dim, sync_every=req.sync_every,
        migration=req.migration, n_migrants=req.n_migrants,
        share_incumbent=req.share_incumbent, max_evals=req.max_evals)
    opt = tcore.IslandOptimizer(tcore.ALGORITHMS[req.algo], cfg,
                                params=dict(req.params), device="cpu")
    return opt.minimize(get(req.fn, req.dim), prng.PRNGKey(req.seed))


def _uninterrupted(req):
    sched = _sched()
    return sched.result(sched.submit(req)).result


def _assert_same(got, ref):
    assert got.value == ref.value
    np.testing.assert_array_equal(np.asarray(got.arg), np.asarray(ref.arg))
    np.testing.assert_array_equal(np.asarray(got.history), np.asarray(ref.history))
    assert got.n_evals == ref.n_evals and got.n_gens == ref.n_gens


def _wait_for(cond, what):
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.002)
    pytest.fail(f"timed out waiting for {what}")


# -- the service types against the reference ---------------------------------------

REQUEST_DICTS = [
    {"fn": "sphere"},
    {"fn": "rastrigin", "algo": "pso", "dim": 8, "seed": 4, "backend": "pallas"},
    {"fn": "sphere", "params": {"w": 0.7, "px": 0.1}},
    {"fn": "sphere", "params": [["w", 0.7]]},
    {"fn": "sphere", "n_islands": 4, "portfolio": ["de", "pso"], "algo": "ga",
     "params": {"de": {"w": 0.5}, "pso": {"fp": 1.0, "fg": [1, 2]}}},
    {"fn": "sphere", "dim": 2, "warm": [[0.1, 0.2], [0.3, 0.4]]},
    {"fn": "rosenbrock", "polish": "asd", "polish_every": 3, "sync_policy": "async",
     "max_staleness": 2, "devices": 2},
]


@pytest.mark.parametrize("d", REQUEST_DICTS, ids=[str(i) for i in range(len(REQUEST_DICTS))])
def test_shape_class_matches_jax(d):
    t, j = tapi.OptRequest.from_dict(d), japi.OptRequest.from_dict(d)
    assert t.shape_class() == j.shape_class()
    assert tapi.SHAPE_CLASS_FIELDS == japi.SHAPE_CLASS_FIELDS
    assert [f.name for f in tapi.dataclasses.fields(t)] == [
        f.name for f in japi.dataclasses.fields(j)]
    assert tapi.dataclasses.asdict(t) == japi.dataclasses.asdict(j)
    hash(t.shape_class())


def test_unknown_fields_rejected_alike():
    for pkg in (tapi, japi):
        with pytest.raises(ValueError, match=r"unknown OptRequest fields: \['bogus'\]"):
            pkg.OptRequest.from_dict({"fn": "sphere", "bogus": 1})


def test_response_to_dict_matches_jax():
    res = dict(arg=np.arange(3, dtype=np.float32), value=1.5, n_evals=10, n_gens=2,
               history=np.ones(2, np.float32))
    t = tapi.OptResponse("job0", "done", tapi.OptimizeResult(**res), round=2,
                         n_rounds=2, best_val=1.5, evals_done=10)
    j = japi.OptResponse("job0", "done", japi.OptimizeResult(**res), round=2,
                         n_rounds=2, best_val=1.5, evals_done=10)
    assert t.to_dict() == j.to_dict()
    assert list(t.to_dict()) == list(j.to_dict())
    assert tapi.OptResponse("a", error="x").to_dict() == japi.OptResponse(
        "a", error="x").to_dict()


# -- CheckpointStore ------------------------------------------------------------------

def _tree():
    g = torch.Generator().manual_seed(0)
    return {"state": {"pop": torch.rand((3, 4, 5), generator=g),
                      "alive": torch.rand((3, 4), generator=g) < 0.5},
            "history": np.arange(6, dtype=np.float32).reshape(3, 2)}


def test_checkpoint_round_trip_and_manifest_matches_jax(tmp_path):
    tree = _tree()
    st = CheckpointStore(str(tmp_path / "t"))
    st.save(4, tree, extra={"round": 4})
    step, got, extra = st.restore(tree)
    assert step == 4 and extra == {"round": 4}
    assert torch.equal(got["state"]["pop"], tree["state"]["pop"])
    assert torch.equal(got["state"]["alive"], tree["state"]["alive"])
    np.testing.assert_array_equal(got["history"].numpy(), tree["history"])
    # The reference writes the same manifest for the same values.
    host = {"state": {k: v.numpy() for k, v in tree["state"].items()},
            "history": tree["history"]}
    jst = jstore.CheckpointStore(str(tmp_path / "j"))
    jst.save(4, host, extra={"round": 4})
    tm, jm = st.read_manifest(), jst.read_manifest()
    assert tm == jm
    # and the port restores the reference's checkpoint
    _, back, _ = CheckpointStore(str(tmp_path / "j")).restore(tree)
    assert torch.equal(back["state"]["pop"], tree["state"]["pop"])


def test_checkpoint_async_writes_and_gc(tmp_path):
    st = CheckpointStore(str(tmp_path), keep=2)
    tree = _tree()
    for step in range(1, 5):
        tree["history"] = tree["history"] + step
        st.save(step, tree, blocking=False)
    st.wait()
    assert st.list_steps() == [3, 4] and st.latest_step() == 4
    _, got, _ = st.restore(tree)
    np.testing.assert_array_equal(got["history"].numpy(), tree["history"])
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]


def test_checkpoint_rejects_bad_checksum_and_shapes(tmp_path):
    st = CheckpointStore(str(tmp_path))
    tree = _tree()
    st.save(1, tree)
    meta = {"state": {"pop": torch.empty((3, 4, 5), device="meta"),
                      "alive": torch.empty((3, 4), dtype=torch.bool, device="meta")},
            "history": np.empty((3, 2), np.float32)}
    st.restore(meta)                                   # a meta template is enough
    for bad, match in (({**meta, "history": np.empty((3, 3), np.float32)}, "history"),
                       ({**meta, "history": np.empty((3, 2), np.int64)}, "int64"),
                       ({**meta, "extra_leaf": np.empty(1)}, "no leaf")):
        with pytest.raises(ValueError, match=match):
            st.restore(bad)
    leaf = sorted((tmp_path / "step_00000001").glob("leaf_*.npy"))[0]
    raw = bytearray(leaf.read_bytes())
    raw[-4] ^= 0xFF
    leaf.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="checksum"):
        st.restore(meta)
    with pytest.raises(FileNotFoundError):
        CheckpointStore(str(tmp_path / "empty")).restore(meta)


# -- scheduler: bucketing and bit-identity ----------------------------------------------

def test_scheduler_bit_identical_to_sequential():
    """K same-shaped requests run as one bucket == K minimize calls."""
    reqs = [_req(seed=s) for s in (0, 3, 0)]
    seq = [_sequential(r) for r in reqs]
    sched = _sched()
    ids = [sched.submit(r) for r in reqs]
    sched.flush()
    for jid, want in zip(ids, seq):
        got = sched.result(jid)
        assert got.status == "done"
        _assert_same(got.result, want)
    assert sched.n_dispatches == 1 and sched.stats()["jobs_run"] == 3


def test_mixed_buckets_budget_and_ids():
    reqs = [_req(seed=0), _req(seed=1), _req(seed=0, dim=6),
            _req(seed=0, algo="pso"), _req(seed=2, max_evals=2000)]
    sched = _sched()
    ids = [sched.submit(r) for r in reqs]
    assert len(sched.pending_buckets()) == 4
    assert sched.flush() == 5 and sched.n_dispatches == 4
    for jid, r in zip(ids, reqs):
        got = sched.result(jid).result
        assert got.n_evals == _sequential(r).n_evals <= r.max_evals
    sched.submit(_req(seed=0), job_id="job9")
    assert sched.submit(_req(seed=1)) not in ids + ["job9"]
    with pytest.raises(ValueError, match="duplicate"):
        sched.submit(_req(seed=2), job_id="job9")


def test_caches_are_lru_capped():
    sched = _sched(max_cached_buckets=2)
    for d in (3, 4, 5):
        sched._optimizer(_req(dim=d))
        sched._function(_req(fn="shifted_rosenbrock", dim=d))
    assert len(sched._optimizers) == 2 and len(sched._functions) == 2
    assert _req(dim=5).shape_class() in sched._optimizers
    assert _req(dim=3).shape_class() not in sched._optimizers
    opt = sched._optimizer(_req(dim=5))
    assert opt.device.type == "cpu" and opt.exec_cfg.backend == "torch"
    assert sched._optimizer(_req(dim=5, backend="pallas")).exec_cfg.backend == "cuda"


def test_faults_are_isolated_per_bucket():
    """A bad objective, a bad backend, a sharded request the host cannot
    place and a portfolio or async request the engine rejects end in
    ``error`` naming what failed; a portfolio and an async bucket run; the
    other buckets finish, and the scheduler answers the next request. (A
    placeable sharded request runs: tests/test_torch_mesh.py.)"""
    sched = _sched()
    bad = {"fn": sched.submit(_req(fn="no_such_function")),
           "portfolio": sched.submit(_req(portfolio=("de", "pso"),
                                          params=(("sa", (("T0", 1.0),)),))),
           "async": sched.submit(_req(sync_policy="async", migration="starvation")),
           "devices": sched.submit(_req(devices=4096)),
           "backend": sched.submit(_req(backend="tpu"))}
    ok = [sched.submit(_req()), sched.submit(_req(portfolio=("de", "pso"))),
          sched.submit(_req(sync_policy="async"))]
    sched.flush()
    errors = {k: sched.poll(v).error for k, v in bad.items()}
    assert all(sched.poll(v).status == "error" for v in bad.values())
    assert "KeyError" in errors["fn"]
    assert "not in the portfolio" in errors["portfolio"]
    assert "async" in errors["async"] and "starvation" in errors["async"]
    assert "devices" in errors["devices"] and "multiple" in errors["devices"]
    assert "backend" in errors["backend"]
    assert all(sched.poll(j).status == "done" for j in ok)
    assert sched.result(sched.submit(_req(seed=7))).status == "done"


def test_result_forces_flush_and_poll_does_not():
    sched = _sched()
    jid = sched.submit(_req())
    assert sched.poll(jid).status == "queued"
    resp = sched.result(jid)
    assert resp.status == "done" and resp.result is not None


# -- scheduler: the worker pool ----------------------------------------------------------

def test_poll_streams_progress_and_matches_blocking_run():
    """Pollers see round, best_val and evals advance while the bucket runs,
    and the pool's result is bit-identical to the blocking scheduler's."""
    sched = _sched(workers=1)
    jid = sched.submit(_long_req())
    sched.flush()
    seen = []

    def progressed():
        r = sched.poll(jid)
        if r.status == "running" and r.round is not None:
            seen.append((r.round, r.best_val, r.evals_done, r.n_rounds))
        return r.status == "done"

    _wait_for(progressed, "the streamed run to finish")
    resp = sched.result(jid, timeout=WAIT)
    assert seen, "never observed streamed progress while running"
    rounds = [s[0] for s in seen]
    assert rounds == sorted(rounds) and all(0 < s[0] <= s[3] for s in seen)
    vals = [s[1] for s in seen]
    assert all(b <= a for a, b in zip(vals, vals[1:]))
    _assert_same(resp.result, _uninterrupted(_long_req()))
    sched.close()


def test_cancel_running_and_queued_jobs():
    sched = _sched(workers=1)
    jid = sched.submit(_long_req())
    sched.flush()

    def at_round():
        r = sched.poll(jid)
        assert r.status != "done", "job finished before it could be cancelled"
        return r.status == "running" and (r.round or 0) >= 1

    _wait_for(at_round, "round 1")
    assert sched.cancel(jid)["status"] in ("cancelling", "cancelled")
    resp = sched.result(jid, timeout=WAIT)
    assert resp.status == "cancelled" and resp.result is not None
    assert 0 < resp.result.n_gens < _long_req().max_evals // 32
    assert len(resp.result.history) == resp.round
    assert resp.result.n_evals == 32 + 32 * resp.round
    queued = sched.submit(_req())
    assert sched.cancel(queued) == {"id": queued, "status": "cancelled"}
    assert sched.poll(queued).result is None and sched.pending_buckets() == []
    assert sched.cancel(jid) == {"id": jid, "error": "already-finished",
                                 "status": "cancelled"}
    with pytest.raises(tcore.UnknownJob):
        sched.cancel("ghost")
    sched.close()


def test_priority_lane_orders_bucket_execution():
    """While the one worker is held on a blocker, a high-priority bucket
    queued after a low-priority one runs first."""
    started, release, order = threading.Event(), threading.Event(), []

    def hook(key, r):
        order.append(key)
        if key == blocker.shape_class() and r == 1:
            started.set()
            release.wait(WAIT)

    sched = _sched(workers=1, fault_hook=hook)
    blocker = _long_req(seed=0)
    sched.submit(blocker)
    sched.flush()
    assert started.wait(WAIT)
    lo = sched.submit(_req(seed=1, dim=5), priority=0)
    hi = sched.submit(_req(seed=1, dim=6), priority=9)
    sched.flush()
    release.set()
    assert sched.result(lo, timeout=WAIT).status == "done"
    assert sched.result(hi, timeout=WAIT).status == "done"
    keys = [k for k in order if k in (_req(dim=5).shape_class(), _req(dim=6).shape_class())]
    assert keys[0] == _req(dim=6).shape_class()
    sched.close()


def test_backpressure_sheds_load_with_retry_after():
    started, release = threading.Event(), threading.Event()

    def hook(key, r):
        started.set()
        release.wait(WAIT)

    sched = _sched(workers=1, max_pending=2, fault_hook=hook)
    svc = tserve.OptimizationService(scheduler=sched)
    blocker = sched.submit(_long_req())
    sched.flush()
    assert started.wait(WAIT)
    sched.submit(_req(seed=1))
    sched.submit(_req(seed=2))
    with pytest.raises(tcore.SchedulerOverloaded) as ei:
        sched.submit(_req(seed=3))
    assert ei.value.retry_after_ms > 0
    reply = svc.handle({"op": "submit", "request": {"fn": "sphere", "dim": 4, "seed": 4}})
    assert reply["error"] == "overloaded" and reply["retry_after_ms"] > 0
    assert sched.stats()["shed"] == 2
    release.set()
    assert sched.drain(timeout=WAIT)
    assert sched.result(blocker).status == "done"
    sched.close()


# -- scheduler: kill and resume ------------------------------------------------------------

def _abandon_at(round_no):
    fired = threading.Event()

    def hook(key, r):
        if r == round_no:
            fired.set()
            raise tcore.AbandonRun(f"injected kill at round {r}")

    return hook, fired


def _killed_run(tmp_path, req):
    """Run ``req`` on a worker that abandons it at round 6 with snapshots
    every 2 rounds, as a SIGKILLed process leaves it; returns its id."""
    hook, fired = _abandon_at(6)
    sched = _sched(workers=1, checkpoint_dir=str(tmp_path), checkpoint_every=2,
                   fault_hook=hook)
    jid = sched.submit(req)
    sched.flush()
    assert fired.wait(WAIT), "fault hook never fired"
    _wait_for(lambda: not sched._ready and sched.poll(jid).status == "running",
              "the worker to let go")
    time.sleep(0.05)
    sched.close()
    return jid


def test_kill_and_resume_is_bit_identical(tmp_path):
    req = _long_req(seed=5, algo="pso")
    ref = _uninterrupted(req)
    jid = _killed_run(tmp_path, req)
    assert len([d for d in os.listdir(tmp_path) if d.startswith("run_")]) == 1
    sched2 = _sched()                              # a fresh process, blocking
    summary = sched2.resume(str(tmp_path))
    assert summary["failed"] == [] and summary["resumed"][0]["jobs"] == [jid]
    assert summary["resumed"][0]["round"] == 6
    got = sched2.result(jid)
    assert got.status == "done"
    _assert_same(got.result, ref)
    assert [d for d in os.listdir(tmp_path) if d.startswith("run_")] == []
    assert sched2.stats()["resumed"] == 1


def test_corrupted_checkpoint_is_rejected_cleanly(tmp_path):
    jid = _killed_run(tmp_path, _long_req(seed=5))
    step_dir = sorted(next(tmp_path.glob("run_*")).glob("step_*"))[-1]
    leaf = sorted(step_dir.glob("leaf_*.npy"))[0]
    raw = bytearray(leaf.read_bytes())
    raw[-4] ^= 0xFF
    leaf.write_bytes(bytes(raw))
    sched2 = _sched()
    summary = sched2.resume(str(tmp_path))
    assert summary["resumed"] == [] and "checksum" in summary["failed"][0]["error"]
    resp = sched2.poll(jid)
    assert resp.status == "error" and "checkpoint" in resp.error
    assert sched2.stats()["resume_failed"] == 1
    assert sched2.result(sched2.submit(_req())).status == "done"


# -- the service ---------------------------------------------------------------------------

def test_service_batching_status_and_errors():
    svc = tserve.OptimizationService(max_batch=2, flush_ms=1e6, device="cpu")
    sub = {"fn": "sphere", "dim": 4, "pop": 16, "n_islands": 2, "max_evals": 1500}
    r1 = svc.handle({"op": "submit", "request": {**sub, "seed": 0}})
    svc.handle({"op": "submit", "request": {"fn": "rastrigin", "dim": 5, "pop": 16,
                                            "max_evals": 900, "sync_policy": "async"}})
    out = svc.handle({"op": "status"})
    assert out["queue_depth"] == 0 and len(out["buckets"]) == 2
    assert sorted(v["sync_policy"] for v in out["buckets"].values()) == ["async", "barrier"]
    assert r1["status"] == "queued"
    r2 = svc.handle({"op": "submit", "request": {**sub, "seed": 1}})
    assert r2["status"] == "done"                        # size-based flush
    assert svc.handle({"op": "poll", "id": r1["id"]})["status"] == "done"
    assert svc.tick(now=time.monotonic() + 1e4) == 1     # the deadline flush
    assert svc.next_deadline() is None
    counts = {k.split("|")[0]: v["counts"] for k, v in svc.handle({"op": "status"})["buckets"].items()}
    assert counts == {"sphere": {"done": 2}, "rastrigin": {"done": 1}}
    out = svc.handle({"op": "result", "id": r1["id"]})
    assert out["status"] == "done" and len(out["arg"]) == 4
    json.dumps(out)
    assert svc.handle({"op": "result", "id": r1["id"]}) == {"error": "unknown-id", "id": r1["id"]}
    assert "error" in svc.handle({"op": "nope"})
    for payload in ("42", "[1, 2]", '"x"', "{bad"):
        reply, quit_ = tserve._handle_line(svc, payload)
        assert "error" in reply and not quit_
    stats = svc.handle({"op": "stats"})
    # the one-island async bucket runs the barrier path: a dispatch of its own
    assert stats["dispatches"] == 2 and stats["max_batch"] == 2


JSONL_SCRIPT = [
    {"op": "submit", "request": {"fn": "rastrigin", "dim": 4, "pop": 16, "n_islands": 2,
                                 "sync_every": 5, "max_evals": 1500, "seed": 0}},
    {"op": "submit", "id": "mine", "priority": 3,
     "request": {"fn": "rastrigin", "dim": 4, "pop": 16, "n_islands": 2,
                 "sync_every": 5, "max_evals": 1500, "seed": 1}},
    {"op": "submit", "request": {"fn": "rosenbrock", "algo": "pso", "dim": 6, "pop": 12,
                                 "max_evals": 1200, "seed": 2,
                                 "warm": [[0.5] * 6, [1.5] * 6]}},
    {"op": "submit", "request": {"fn": "levy", "dim": 5, "pop": 16, "max_evals": 3000,
                                 "polish": "avd", "polish_every": 2, "polish_topk": 2,
                                 "polish_steps": 1, "seed": 3}},
    {"op": "submit", "request": {"fn": "sphere", "bogus": 1}},
    {"op": "submit", "request": {"fn": "no_such_function"}},
    {"op": "poll", "id": "job0"},
    {"op": "status"},
    {"op": "flush"},
    {"op": "poll", "id": "job0"},
    {"op": "result", "id": "job0"},
    {"op": "result", "id": "job0"},
    {"op": "result", "id": "mine"},
    {"op": "result", "id": "job2"},
    {"op": "result", "id": "job3"},
    {"op": "result", "id": "job4"},
    {"op": "cancel", "id": "mine"},
    {"op": "nope"},
    {"op": "stats"},
    {"op": "quit"},
]
FLOAT_KEYS = ("value", "best_val")


def test_jsonl_script_same_replies_as_jax():
    """The same script through the reference's service and the port's: the
    replies agree key for key; floats within rtol 1e-4; ``arg`` in shape."""
    jsvc, tsvc = jserve.OptimizationService(), tserve.OptimizationService(device="cpu")
    for msg in JSONL_SCRIPT:
        line = json.dumps(msg)
        j, jq = jserve._handle_line(jsvc, line)
        t, tq = tserve._handle_line(tsvc, line)
        assert jq == tq and list(t) == list(j), (msg, t, j)
        for k, v in j.items():
            if k in FLOAT_KEYS:
                np.testing.assert_allclose(t[k], v, rtol=RTOL, err_msg=f"{msg} {k}")
            elif k == "arg":
                assert len(t[k]) == len(v)
            else:
                assert t[k] == v, (msg, k, t[k], v)


def test_stdin_loop_drains_ops_arriving_in_one_write():
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.opt_serve", "--device", "cpu"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=SRC))
    try:
        out, err = proc.communicate(
            '{"op": "stats"}\n{"op": "stats"}\n{"op": "quit"}\n', timeout=WAIT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate(timeout=WAIT)
        pytest.fail("serve_stdin stalled on ops delivered in one write")
    replies = [json.loads(line) for line in out.splitlines() if line]
    assert len(replies) == 3 and replies[-1] == {"bye": True}
    assert "device cpu" in err


def _start_server(extra_args):
    """``opt_serve --tcp 0 --device cpu`` in a subprocess: (proc, port)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.opt_serve", "--tcp", "0",
         "--device", "cpu", *extra_args],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=SRC))
    lines = []
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        line = proc.stderr.readline()
        if not line:
            break
        lines.append(line)
        if "listening on" in line:
            assert line.rstrip().endswith("device cpu")
            return proc, int(line.split("listening on ")[1].split()[0].rsplit(":", 1)[1])
    proc.kill()
    proc.wait(timeout=WAIT)
    raise RuntimeError(f"server never came up: {''.join(lines)}")


class _Client:
    def __init__(self, port):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=WAIT)
        self.f = self.sock.makefile("rw")

    def call(self, msg):
        self.f.write(json.dumps(msg) + "\n")
        self.f.flush()
        return json.loads(self.f.readline())

    def close(self):
        self.sock.close()


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=WAIT)
    proc.stderr.close()


def test_sigkill_tcp_server_resume_bit_identical(tmp_path):
    """SIGKILL the serving process mid-run, restart it with --resume-dir:
    the job finishes bit-identically to an uninterrupted run."""
    req = dict(fn="rastrigin", algo="de", dim=6, pop=16, n_islands=2,
               sync_every=1, max_evals=32 + 32 * 400, seed=13, migration="ring")
    ref = _uninterrupted(tapi.OptRequest(**req))
    ckpt = str(tmp_path / "ckpt")
    proc, port = _start_server(["--workers", "1", "--flush-ms", "10",
                                "--checkpoint-dir", ckpt, "--checkpoint-every", "2"])
    try:
        cl = _Client(port)
        jid = cl.call({"op": "submit", "request": req})["id"]

        def progressed():
            p = cl.call({"op": "poll", "id": jid})
            assert p.get("status") != "done", "job finished before the kill"
            return p.get("round", 0) >= 10

        _wait_for(progressed, "ten rounds")
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=WAIT)
        cl.close()
    finally:
        _stop(proc)
    assert any(d.startswith("run_") for d in os.listdir(ckpt))
    proc2, port2 = _start_server(["--workers", "1", "--resume-dir", ckpt])
    try:
        cl2 = _Client(port2)
        out = cl2.call({"op": "result", "id": jid})
        assert out["status"] == "done" and out["value"] == float(ref.value)
        assert out["arg"] == [float(v) for v in np.asarray(ref.arg).ravel()]
        assert (out["n_evals"], out["n_gens"]) == (ref.n_evals, ref.n_gens)
        assert cl2.call({"op": "result", "id": jid})["error"] == "unknown-id"
        assert cl2.call({"op": "stats"})["resumed"] == 1
        assert cl2.call({"op": "quit"}) == {"bye": True}
        cl2.close()
    finally:
        _stop(proc2)
