"""The port's federation coordinator over port workers on the CPU.

``repro_torch.launch.federate`` spawns ``repro_torch.launch.opt_serve``
subprocesses (``--device cpu``) over TCP-JSONL and runs two legs, routing
each worker's best ring-wise as the next leg's warm immigrants. Every job
seed and routing hop is a function of the configuration, so a run that
loses a worker to SIGKILL mid-leg (revived from its checkpoint store with
``--resume-dir``) must end with exactly the uninterrupted run's incumbent,
as ``tests/test_federation.py`` holds the reference to.
"""
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.launch.federate import (FederationConfig,  # noqa: E402
                                         FederationCoordinator, WorkerDied,
                                         WorkerSpec, federate)

TIMEOUT = 120.0   # seconds for any one result the coordinator waits on


def _cfg(root, name):
    return FederationConfig(
        fn="rastrigin", dim=4, legs=2, evals_per_leg=1200, seed=5, pop=16,
        n_islands=2, sync_every=5, checkpoint_root=str(root / name),
        workers=(WorkerSpec(algo="de"), WorkerSpec(algo="pso")),
        result_timeout=TIMEOUT, device="cpu")


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    return federate(_cfg(tmp_path_factory.mktemp("fed"), "ref"))


def test_federation_runs_and_routes(uninterrupted):
    res = uninterrupted
    assert res.revived == 0 and res.resubmitted == 0
    assert res.devices == ["cpu", "cpu"]
    assert len(res.legs) == 2 and all(len(leg) == 2 for leg in res.legs)
    assert np.isfinite(res.value) and len(res.arg) == 4
    assert len({r["value"] for r in res.legs[0]}) == 2
    assert res.value == min(r["value"] for leg in res.legs for r in leg)


def test_federation_survives_sigkilled_worker(uninterrupted, tmp_path):
    """SIGKILL worker 1 after leg 1's submits land (its job carries the
    routed warm row): the revived worker finishes the federation with the
    uninterrupted run's values, leg by leg."""
    coord = FederationCoordinator(_cfg(tmp_path, "kill"))

    def fault(leg):
        if leg == 1:
            coord.workers[1].kill()

    coord.fault_hook = fault
    coord.start()
    try:
        res = coord.run()
    finally:
        coord.close()
    assert res.revived >= 1 and res.devices == ["cpu", "cpu"]
    assert res.value == uninterrupted.value and res.arg == uninterrupted.arg
    assert [[r["value"] for r in leg] for leg in res.legs] == [
        [r["value"] for r in leg] for leg in uninterrupted.legs]


def test_start_stops_every_worker_when_one_never_listens(tmp_path, monkeypatch):
    """The workers start side by side; a worker that exits before its
    banner fails ``start``, which first stops the worker already up."""
    coord = FederationCoordinator(_cfg(tmp_path, "dead"))
    dead = coord.workers[1]

    def exits_at_once(resume=False):
        dead.proc = subprocess.Popen([sys.executable, "-c", "pass"],
                                     stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)

    monkeypatch.setattr(dead, "launch", exits_at_once)
    with pytest.raises(WorkerDied):
        coord.start()
    assert coord.workers[0].port is not None
    assert all(w.proc.poll() is not None for w in coord.workers)
