"""The port's distributed island layer (``repro_torch.core.mesh``) against
the JAX package's, on gloo ranks on the CPU.

* The primitives: the sharded ring, starvation and mailbox post at 2 and 4
  ranks, on job-stacked arrays made from a seed, equal bit for bit the
  reference's host-side forms and its ``ppermute``/all-gather forms under
  ``shard_map``.
* The population-sharded evaluator, ``distributed_map_reduce``, a
  population-sharded run and ``minimize_many`` over a mesh; one island-mesh
  DE run against the reference's sharded engine (bound: rtol 1e-4, as
  ``test_torch_de_engine.py``, never tighter than the reference's own
  fused/unfused gap of 1.36e-5 relative).
* The service with ``devices: 2`` requests, the launcher's failure path
  (a rank that raises ends the run inside its deadline), and ``MeshConfig``.

The reference's sharded forms need more than one JAX device, which the
suite's process does not have (``conftest.py`` does not force them), so they
run once, in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (the flag
``tests/test_distributed.py`` and ``benchmarks/distributed.py`` use). The
port's ranks run in one spawn per rank count. Every spawn and subprocess has
its own deadline.
"""
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_cases as cases  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import migration as jmig  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import mesh  # noqa: E402
from repro_torch.core.api import OptimizeResult, OptRequest  # noqa: E402
from repro_torch.functions import get  # noqa: E402

RTOL = 1e-4
DEADLINE = 180.0     # seconds any one spawn or subprocess may take
SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
J, I, P, D, S, K = 2, 8, 6, 5, 3, 2     # jobs, islands, pop, dim, mailbox slots, k


def _arrays(seed=0):
    """Job-stacked engine arrays with ties, +inf (dead) slots and one
    starving island per job, and a mailbox state."""
    rng = np.random.default_rng(seed)
    pop = rng.standard_normal((J, I, P, D)).astype(np.float32)
    fit = np.round(rng.uniform(0, 4, (J, I, P)), 1).astype(np.float32)  # ties
    alive = rng.uniform(size=(J, I, P)) < 0.9
    alive[:, 5, 1:] = False                 # island 5 starves
    fit[~alive] = np.inf
    return {
        "pop": pop, "fit": fit, "alive": alive,
        "post": rng.uniform(size=(J, I)) < 0.7,
        "box_mbox_pop": rng.standard_normal((J, I, S, K, D)).astype(np.float32),
        "box_mbox_fit": rng.uniform(0, 4, (J, I, S, K)).astype(np.float32),
        "box_mbox_tag": rng.integers(-1, 6, (J, I, S)).astype(np.int32),
        "box_mbox_head": rng.integers(0, S, (J, I)).astype(np.int32),
        "box_round_ctr": rng.integers(0, 6, (J, I)).astype(np.int32),
        "box_stale_seen": rng.integers(-1, 3, (J, I)).astype(np.int32),
    }


ARRAYS = _arrays()
EVAL_POP = np.random.default_rng(1).uniform(-3, 3, (10, 6)).astype(np.float32)
XS = np.random.default_rng(2).uniform(-2, 2, (8, 5)).astype(np.float32)
KEYS = np.stack([prng.PRNGKey(s).numpy() for s in (0, 3, 11)])

# The reference's sharded forms, on the same arrays, in a process with 4
# host devices: meshes of the first 2 and of all 4.
JAX_SHARDED = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
jax.config.update("jax_threefry_partitionable", True)
from repro import core as jcore
from repro.core import migration as jmig
from repro.core.executor import ExecutorConfig, distributed_map_reduce, make_batch_evaluator
from repro.core.mesh import MeshConfig, shard_map
from repro.functions import get

a = dict(np.load(sys.argv[1]))
out = {}
for n in (2, 4):
    m = Mesh(np.asarray(jax.devices()[:n]), ("i",))
    sh = lambda fn, k: jax.jit(shard_map(fn, m, in_specs=(P("i"),) * k, out_specs=P("i")))
    forms = {
        "ring1": sh(lambda p, f, al, b, g: jmig.ring(p, f, 1, axis="i", n_shards=n), 5),
        "ring2": sh(lambda p, f, al, b, g: jmig.ring(p, f, 2, axis="i", n_shards=n), 5),
        "starvation": sh(lambda p, f, al, b, g: jmig.starvation(
            p, f, 2, al, axis="i", n_shards=n), 5),
        "starvation_isfinite": sh(lambda p, f, al, b, g: jmig.starvation(
            p, f, 2, None, axis="i", n_shards=n), 5),
        "mailbox_post": sh(lambda p, f, al, b, g: jmig.mailbox_post(
            b, p, f, 2, g, axis="i", n_shards=n), 5),
    }
    for j in range(a["pop"].shape[0]):
        args = [jnp.asarray(a[k][j]) for k in ("pop", "fit", "alive")]
        args += [{k[4:]: jnp.asarray(a[k][j]) for k in a if k.startswith("box_")},
                 jnp.asarray(a["post"][j])]
        for name, fn in forms.items():
            r = fn(*args)
            if name == "mailbox_post":
                for k, v in r.items():
                    out[f"{n}/{name}/{j}/{k}"] = v
            else:
                out[f"{n}/{name}/{j}/pop"], out[f"{n}/{name}/{j}/fit"] = r
    ev = make_batch_evaluator(get("rastrigin", 6), ExecutorConfig(mesh_axis="i"), m)
    out[f"{n}/eval"] = ev(jnp.asarray(a["eval_pop"]))
    for op in ("sum", "min", "max"):
        out[f"{n}/map_reduce/{op}"] = distributed_map_reduce(
            m, "i", lambda x: x * x, op, jnp.asarray(a["xs"]))
cfg = jcore.IslandConfig(n_islands=4, pop=16, dim=6, sync_every=5, migration="ring",
                         max_evals=2000)
r = jcore.IslandOptimizer(jcore.ALGORITHMS["de"], cfg, mesh_cfg=MeshConfig(devices=4)
                          ).minimize(get("rastrigin", 6), jax.random.PRNGKey(7))
out["engine/value"], out["engine/history"] = np.float32(r.value), np.asarray(r.history)
out["engine/n_evals"] = np.int64(r.n_evals)
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


JAX4 = {"PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
SERVICE_REQ = dict(fn="rastrigin", algo="de", dim=6, pop=16, n_islands=4, sync_every=5,
                   max_evals=1500, migration="ring")
JSONL = [
    {"op": "submit", "request": {**SERVICE_REQ, "devices": 2, "seed": 1}},
    {"op": "submit", "request": {**SERVICE_REQ, "seed": 1}},
    {"op": "result", "id": "job0"},
    {"op": "result", "id": "job1"},
    {"op": "quit"},
]


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    """The subprocesses, started together so they run while the port's
    ranks do: the reference's sharded forms, and the JSONL script through
    each package's opt_serve. Each is awaited with its own deadline."""
    d = tmp_path_factory.mktemp("mesh")
    np.savez(d / "in.npz", eval_pop=EVAL_POP, xs=XS, **ARRAYS)
    (d / "script.jsonl").write_text("".join(json.dumps(m) + "\n" for m in JSONL))
    cmds = {
        "jax_sharded": ([sys.executable, "-c", JAX_SHARDED, str(d / "in.npz"),
                         str(d / "out.npz")], JAX4),
        "jax_serve": ([sys.executable, "-m", "repro.launch.opt_serve", "--workers", "0"],
                      JAX4),
        "port_serve": ([sys.executable, "-m", "repro_torch.launch.opt_serve", "--device",
                        "cpu", "--workers", "0"], {"PYTHONPATH": SRC}),
    }
    procs = {}
    for name, (cmd, env) in cmds.items():
        with open(d / "script.jsonl") as stdin, open(d / f"{name}.out", "w") as out, \
                open(d / f"{name}.err", "w") as err:
            procs[name] = subprocess.Popen(cmd, stdin=stdin, stdout=out, stderr=err,
                                           env=dict(os.environ, **env))

    def finish(name):
        """The subprocess's stdout once it has ended (killed past the deadline)."""
        try:
            rc = procs[name].wait(timeout=DEADLINE)
        except subprocess.TimeoutExpired:
            procs[name].kill()
            pytest.fail(f"{name} did not finish in {DEADLINE} s")
        assert rc == 0, (d / f"{name}.err").read_text()[-3000:]
        return (d / f"{name}.out").read_text()

    yield d, finish
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait(timeout=DEADLINE)


@pytest.fixture(scope="module")
def jax_sharded(background):
    d, finish = background
    finish("jax_sharded")
    return dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def port_primitives(request, background):
    n = request.param
    return n, mesh.spawn(n, cases.primitives, ARRAYS, n, timeout=DEADLINE)


@pytest.fixture(scope="module")
def port_runs():
    """Two ranks for the population and job splits and the map/reduce,
    four for the island mesh compared with the reference."""
    two = mesh.spawn(2, cases.mesh_runs, 2, "rastrigin", 6, EVAL_POP, XS, KEYS,
                     timeout=DEADLINE)
    four = mesh.spawn(4, cases.mesh_runs, 4, "rastrigin", 6, EVAL_POP, XS, KEYS,
                      timeout=DEADLINE)
    return {2: two, 4: four}


# -- the primitives ---------------------------------------------------------------

@functools.cache
def _host_forms(j):
    """The reference's unsharded forms on job ``j``."""
    a = {k: jnp.asarray(v[j]) for k, v in ARRAYS.items()}
    box = {k[4:]: v for k, v in a.items() if k.startswith("box_")}
    return {
        "ring1": jmig.ring(a["pop"], a["fit"], 1),
        "ring2": jmig.ring(a["pop"], a["fit"], 2),
        "starvation": jmig.starvation(a["pop"], a["fit"], 2, a["alive"]),
        "starvation_isfinite": jmig.starvation(a["pop"], a["fit"], 2, None),
        "mailbox_post": jmig.mailbox_post(box, a["pop"], a["fit"], 2, a["post"]),
    }


@pytest.mark.parametrize("name", ["ring1", "ring2", "starvation", "starvation_isfinite",
                                  "mailbox_post"])
def test_sharded_primitive_matches_jax(port_primitives, jax_sharded, name):
    """Port ranks == reference host form == reference shard_map form, bits."""
    n, got = port_primitives
    for j in range(J):
        host = _host_forms(j)[name]
        if name == "mailbox_post":
            for k, v in host.items():
                np.testing.assert_array_equal(got[name][k][j], np.asarray(v), err_msg=k)
                np.testing.assert_array_equal(
                    got[name][k][j], jax_sharded[f"{n}/{name}/{j}/{k}"], err_msg=k)
            continue
        for i, leaf in enumerate(("pop", "fit")):
            np.testing.assert_array_equal(got[name][i][j], np.asarray(host[i]))
            np.testing.assert_array_equal(got[name][i][j], jax_sharded[f"{n}/{name}/{j}/{leaf}"])


def test_starvation_arrays_exercise_the_policy():
    """The seeded arrays make starvation move migrants and the ring adopt
    (so bit-identity above is not identity)."""
    host = _host_forms(0)
    assert not np.array_equal(np.asarray(host["starvation"][1]), ARRAYS["fit"][0])
    assert not np.array_equal(np.asarray(host["ring2"][1]), ARRAYS["fit"][0])


# -- evaluator, map/reduce, engines ------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_population_sharded_evaluator_matches_jax(port_runs, jax_sharded, n):
    """Rows padded to a multiple of the ranks, each rank its block; the
    gathered fitness equals the unsplit port evaluator bit for bit, and the
    reference's sharded evaluator to float32 rounding."""
    f = get("rastrigin", 6)
    whole = tcore.make_batch_evaluator(f)(torch.as_tensor(EVAL_POP)).numpy()
    np.testing.assert_array_equal(port_runs[n]["eval"], whole)
    np.testing.assert_allclose(port_runs[n]["eval"], jax_sharded[f"{n}/eval"], rtol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_distributed_map_reduce_matches_jax(port_runs, jax_sharded, n):
    """min and max exact; sum within float32 rounding of the reduction
    order: |err| <= rows * 2^-24 * sum|x|."""
    sq = XS * XS
    for op in ("min", "max"):
        np.testing.assert_array_equal(port_runs[n]["map_reduce"][op],
                                      jax_sharded[f"{n}/map_reduce/{op}"])
        np.testing.assert_array_equal(port_runs[n]["map_reduce"][op],
                                      getattr(sq, op)(axis=0))
    bound = XS.shape[0] * 2.0 ** -24 * np.abs(sq).sum(0)
    for want in (jax_sharded[f"{n}/map_reduce/sum"], sq.astype(np.float64).sum(0)):
        assert (np.abs(port_runs[n]["map_reduce"]["sum"] - want) <= bound).all()


def _same(a, b):
    a, b = OptimizeResult(*a), b if isinstance(b, OptimizeResult) else OptimizeResult(*b)
    assert a.value == b.value and a.n_evals == b.n_evals and a.n_gens == b.n_gens
    np.testing.assert_array_equal(np.asarray(a.arg), np.asarray(b.arg))
    np.testing.assert_array_equal(np.asarray(a.history), np.asarray(b.history))


@pytest.mark.parametrize("n", [2, 4])
def test_population_sharded_run_bit_identical(port_runs, n):
    cfg = tcore.IslandConfig(n_islands=1, pop=16, dim=6, sync_every=5, max_evals=1200)
    want = tcore.IslandOptimizer(tcore.ALGORITHMS["de"], cfg, device="cpu").minimize(
        get("rastrigin", 6), prng.PRNGKey(7))
    _same(port_runs[n]["pop_sharded"], want)


@pytest.mark.parametrize("n", [2, 4])
def test_minimize_many_jobs_over_mesh_bit_identical(port_runs, n):
    """3 jobs over n ranks: padded with copies of the first job, gathered
    in job order, each equal to the unsharded bucket's."""
    cfg = tcore.IslandConfig(n_islands=2, pop=16, dim=6, sync_every=5, max_evals=1200)
    want = tcore.IslandOptimizer(tcore.ALGORITHMS["de"], cfg, device="cpu").minimize_many(
        get("rastrigin", 6), KEYS)
    assert len(port_runs[n]["jobs"]) == len(want)
    for a, b in zip(port_runs[n]["jobs"], want):
        _same(a, b)


def test_island_mesh_engine_matches_jax_sharded_engine(port_runs, jax_sharded):
    got = OptimizeResult(*port_runs[4]["island_mesh"])
    assert got.n_evals == int(jax_sharded["engine/n_evals"])
    np.testing.assert_allclose(got.value, jax_sharded["engine/value"], rtol=RTOL)
    np.testing.assert_allclose(got.history, jax_sharded["engine/history"], rtol=RTOL)


# -- the service ----------------------------------------------------------------

def test_sharded_request_done_and_unplaceable_isolated(monkeypatch):
    """A devices: 2 request ends done with the devices: 1 value, bit for
    bit; a request for more ranks than the host places ends in error in
    its own bucket while the others finish. The scheduler's spawn gets
    this file's deadline."""
    monkeypatch.setattr(mesh, "SPAWN_TIMEOUT", DEADLINE)
    sched = tcore.ShapeBucketScheduler(device="cpu")
    two = sched.submit(OptRequest(seed=4, devices=2, **SERVICE_REQ))
    one = sched.submit(OptRequest(seed=4, **SERVICE_REQ))
    many = mesh.GLOO_MAX_RANKS * 2
    bad = sched.submit(OptRequest(seed=4, **{**SERVICE_REQ, "n_islands": many, "devices": many}))
    t0 = time.monotonic()
    sched.flush()
    assert time.monotonic() - t0 < DEADLINE
    r2, r1, rb = sched.poll(two), sched.poll(one), sched.poll(bad)
    assert r2.status == r1.status == "done" and rb.status == "error"
    assert "devices" in rb.error and "visible" in rb.error
    _same(dataclasses.astuple(r2.result), r1.result)
    assert len({OptRequest(devices=d, **SERVICE_REQ).shape_class() for d in (1, 2)}) == 2


def test_jsonl_devices_2_same_replies_as_jax(background):
    """One script with a devices: 2 request through both packages'
    opt_serve over stdin (the reference under 4 host devices): the same
    keys, ids, statuses and accounting, values within rtol 1e-4."""
    _, finish = background
    jout, tout = finish("jax_serve"), finish("port_serve")
    jrep = [json.loads(x) for x in jout.splitlines() if x.strip()]
    trep = [json.loads(x) for x in tout.splitlines() if x.strip()]
    assert len(trep) == len(jrep) == len(JSONL)
    for t, j in zip(trep, jrep):
        assert list(t) == list(j), (t, j)
        for k, v in j.items():
            if k == "value":
                np.testing.assert_allclose(t[k], v, rtol=RTOL)
            elif k != "arg":
                assert t[k] == v, (k, t[k], v)
    assert trep[2]["status"] == "done" and trep[2]["value"] == trep[3]["value"]


# -- the launcher and the config --------------------------------------------------

@pytest.mark.parametrize("wait", [True, False], ids=["peer_in_collective", "peer_done"])
def test_failing_rank_raises_within_deadline(wait):
    """Rank 1 raises while rank 0 waits in a collective it never completes
    (or has finished): the spawn raises rank 1's own error, long before the
    group's timeout, and leaves no rank running."""
    t0 = time.monotonic()
    with pytest.raises(KeyError, match="rank 1 fails on purpose"):
        mesh.spawn(2, cases.failing, wait, timeout=DEADLINE)
    assert time.monotonic() - t0 < DEADLINE / 3


def test_spawn_deadline_raises():
    with pytest.raises(TimeoutError, match="did not finish"):
        mesh.spawn(1, time.sleep, 60, timeout=2)


def test_meshconfig_validation():
    with pytest.raises(ValueError, match="devices"):
        mesh.MeshConfig(devices=0).build("cpu")
    with pytest.raises(ValueError, match="visible"):
        mesh.MeshConfig(devices=100_000).build("cpu")
    with pytest.raises(ValueError, match="visible"):
        mesh.MeshConfig(devices=100_000).build()        # more ranks than GPUs: gloo
    with pytest.raises(ValueError, match="visible"):
        mesh.MeshConfig(devices=100_000, backend="nccl").build()   # one rank per GPU
    with pytest.raises(ValueError, match="nccl"):
        mesh.MeshConfig(devices=1, backend="nccl").build("cpu")
    with pytest.raises(ValueError, match="backend"):
        mesh.MeshConfig(devices=1, backend="mpi").build("cpu")
    with pytest.raises(ValueError, match="multiple"):
        mesh.MeshConfig(devices=3).local_islands(4)
    assert mesh.MeshConfig(devices=2).local_islands(8) == 4
    assert mesh.ring_perm(3) == [(0, 1), (1, 2), (2, 0)]
    assert mesh.MeshConfig(devices=2).build("cpu") == mesh.Mesh(2, mesh.ISLAND_AXIS, "gloo")
    assert mesh.default_backend("cpu") == "gloo" and mesh.default_backend("cpu", 4) == "gloo"
    assert mesh.default_backend(None) == "nccl"         # one rank on the engine's GPU
    gpus = torch.cuda.device_count()
    assert mesh.default_backend("cuda", 2) == ("nccl" if gpus >= 2 else "gloo")
    assert mesh.default_backend("cuda", max(2, gpus + 1)) == "gloo"
    assert mesh.host_device_count("gloo") == mesh.GLOO_MAX_RANKS


def test_one_rank_collectives_are_identities():
    g = mesh.Group(0, 1, "gloo")
    x = torch.arange(6.0).reshape(2, 3)
    for group in (g, None):                 # a 1-rank mesh outside a group; unsharded
        assert mesh.ring_shift(x, group) is x and mesh.all_gather_rows(x, group) is x
        assert mesh.all_reduce_min(x, group) is x
    assert torch.equal(mesh.local_rows(x, 1, 1), x[1:2])
    assert mesh.MeshConfig(devices=1).build("cpu").local_group() == g


def test_one_rank_group_issues_its_collectives():
    """Inside a joined 1-rank group the engine's all-gathers and
    all-reduces go to the backend (as a 1-rank nccl group does on the
    card), the ring's hop to oneself does not, and the runs stay
    bit-identical to the unsharded engine."""
    names = ["de", "many", "share_polish"]
    got, issued = mesh.spawn(1, cases.run_all_counting, names, timeout=120)
    assert issued.get("all_gather", 0) > 0 and issued.get("all_reduce", 0) > 0
    assert "batch_isend_irecv" not in issued
    for name in names:
        want = cases.run(name, None)
        for a, b in zip(got[name]["results"], want["results"], strict=True):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)


def test_objectives_pickle_by_recipe():
    import pickle
    for name in ("shifted_rosenbrock", "rastrigin"):
        f = get(name, 6)
        g = pickle.loads(pickle.dumps(f))
        if f.shift is not None:
            assert torch.equal(g.shift, f.shift)
        x = torch.as_tensor(EVAL_POP)
        assert g.name == f.name and g.bias == f.bias and (g.lo, g.hi) == (f.lo, f.hi)
        assert torch.equal(g.fn(x), f.fn(x))


def test_map_reduce_spawns_from_one_process():
    """Called outside a group, distributed_map_reduce spawns its ranks and
    returns their value on the caller's device."""
    from repro_torch.core import executor
    m = mesh.MeshConfig(devices=2).build("cpu")
    got = executor.distributed_map_reduce(m, m.axis, cases.square, "max", torch.as_tensor(XS))
    np.testing.assert_array_equal(got.numpy(), (XS * XS).max(0))
    with pytest.raises(ValueError, match="evenly"):
        executor.distributed_map_reduce(m, m.axis, cases.square, "max", torch.zeros(3, 2))
