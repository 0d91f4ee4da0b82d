"""The port's island engine over a mesh of ranks against its unsharded
engine: the determinism contract, bit for bit, at 1, 2 and 4 ranks.

Every case of ``_torch_mesh_cases.CASES`` (DE, GA with starvation, PSO;
the incumbent shared with asd polish; ``minimize_many``; homogeneous and
mixed portfolios, one of them through ``minimize_many``; async at
staleness 0, a straggler schedule replayed, an async bucket; a warm start)
runs unsharded here and over an island mesh: in place for 1 rank, and in
one spawn of gloo ranks for 2 and for 4 (every case in the spawn, so the
file pays two spawns). ``value``, ``arg``, ``n_evals``, ``n_gens``,
``history``, the async staleness record and the recorded schedule must be
equal. Then the engine's refusals, which match the reference's
(``tests/test_distributed.py``).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_cases as cases  # noqa: E402

from repro_torch import core as tcore  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import mesh  # noqa: E402
from repro_torch.core.mesh import MeshConfig  # noqa: E402
from repro_torch.functions import get  # noqa: E402

DEADLINE = 240.0     # seconds one spawn of every case may take
NAMES = list(cases.CASES)


@pytest.fixture(scope="module")
def unsharded():
    return {n: cases.run(n, None) for n in NAMES}


@pytest.fixture(scope="module", params=[1, 2, 4], ids=["1rank", "2ranks", "4ranks"])
def sharded(request):
    n = request.param
    if n == 1:
        return n, cases.run_all(NAMES, 1)
    return n, mesh.spawn(n, cases.run_all, NAMES, n, timeout=DEADLINE)


@pytest.mark.parametrize("name", NAMES)
def test_mesh_run_bit_identical_to_unsharded(sharded, unsharded, name):
    n, got = sharded
    got, want = got[name], unsharded[name]
    assert len(got["results"]) == len(want["results"])
    for a, b in zip(got["results"], want["results"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f"{n} ranks")
    assert got["stale"] == want["stale"]
    if want["schedule"] is not None:
        for x, y in zip(got["schedule"], want["schedule"]):
            np.testing.assert_array_equal(x, y)


def test_straggler_case_is_stale():
    """The straggler case adopts stale migrants (so its bit-identity covers
    the mailbox's staleness bound, not only the barrier cadence)."""
    assert 0 < cases.run("straggler", None)["stale"] <= 4


# -- refusals (the reference's, tests/test_distributed.py) ---------------------------

def _opt(cfg=None, **kw):
    c = tcore.IslandConfig(**{**cases.BASE, **(cfg or {})})
    return tcore.IslandOptimizer(tcore.ALGORITHMS["de"], c, device="cpu", **kw)


@pytest.mark.parametrize("make,match", [
    (lambda: _opt(dict(n_islands=1, migration="none"), mesh_cfg=MeshConfig(devices=1)),
     "n_islands > 1"),
    (lambda: _opt(mesh_cfg=MeshConfig(devices=3)), "multiple"),
    (lambda: _opt(mesh=MeshConfig(devices=1).build("cpu"), mesh_cfg=MeshConfig(devices=1)),
     "mutually exclusive"),
    (lambda: _opt(dict(n_islands=64), mesh_cfg=MeshConfig(devices=64)), "visible"),
    (lambda: _opt(mesh_cfg=MeshConfig(devices=2, backend="nccl")), "nccl"),
], ids=["one_island", "not_divisible", "mesh_and_mesh_cfg", "unplaceable", "nccl_on_cpu"])
def test_rejects_bad_sharding_configs(make, match):
    with pytest.raises(ValueError, match=match):
        make()


def test_round_callback_refused_over_a_mesh():
    opt = _opt(mesh_cfg=MeshConfig(devices=1), round_callback=lambda r, a, v: None)
    with pytest.raises(ValueError, match="round_callback"):
        opt.minimize(get("sphere", 6), prng.PRNGKey(0))
    with pytest.raises(ValueError, match="round_callback"):
        opt.minimize_many(get("sphere", 6), torch.stack([prng.PRNGKey(0)]))


@pytest.mark.parametrize("kw", [dict(mesh_cfg=MeshConfig(devices=2)),
                                dict(mesh=MeshConfig(devices=2).build("cpu"))],
                         ids=["mesh_cfg", "mesh"])
def test_bucket_stepper_refused_over_a_mesh(kw):
    with pytest.raises(ValueError, match="unsharded"):
        _opt(**kw).bucket_stepper(get("sphere", 6))


def test_mesh_of_other_size_refused_inside_a_group():
    """Inside a group, a mesh must match the world size: ranks are not
    spawned from a rank."""
    m = mesh.Mesh(2, mesh.ISLAND_AXIS, "gloo")
    assert m.local_group() is None                  # no group: the caller spawns
    assert mesh.spawn(2, _local_group_of, m, timeout=DEADLINE) == mesh.Group(
        0, 2, "gloo", joined=True)
    with pytest.raises(ValueError, match="world size 2"):
        mesh.spawn(2, _local_group_of, mesh.Mesh(4, mesh.ISLAND_AXIS, "gloo"),
                   timeout=DEADLINE)


def _local_group_of(m):
    return m.local_group()


def test_launch_distributed_reports_rates_and_same_results(capsys):
    """``python -m repro_torch.launch.distributed`` at 1 and 2 gloo ranks
    on the CPU: a rate per rank count, the same result at both."""
    from repro_torch.launch import distributed
    distributed.main(["--device", "cpu", "--devices", "1,2", "--pop", "16", "--dim", "6",
                      "--islands", "4", "--rounds", "2", "--repeats", "1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rows = out["rows"]
    assert [r["devices"] for r in rows] == [1, 2]
    assert [r["route"] for r in rows] == ["none", "gloo"]
    assert all(r["same_as_first"] and r["rounds_per_s"] > 0 for r in rows)


def test_jobs_over_a_joined_one_rank_gloo_group_bit_identical():
    """``minimize_many`` over a 1-rank ``mesh=`` inside a joined gloo
    group (its all-gather issued) equals the unsharded run."""
    want = cases.jobs_over_mesh(None, "cpu")
    got = mesh.spawn(1, cases.jobs_over_mesh, "gloo", "cpu", timeout=DEADLINE)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _same_astuple(a, b)


@pytest.mark.gpu
def test_jobs_over_a_joined_one_rank_nccl_group_bit_identical():
    """The jobs' rows are gathered on the rank's GPU: a group built on
    nccl refuses host tensors. Three jobs over a 1-rank nccl ``mesh=``,
    inside a joined group as ``chip_smoke.py`` phase 18 A builds one, equal
    the unsharded ``minimize_many`` on the card bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    want = cases.jobs_over_mesh(None, "cuda")
    got = mesh.spawn(1, cases.jobs_over_mesh, "nccl", "cuda", backend="nccl",
                     timeout=DEADLINE)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _same_astuple(a, b)


def _same_astuple(a, b):
    """Two ``dataclasses.astuple`` results equal field for field, arrays
    bit for bit."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y
