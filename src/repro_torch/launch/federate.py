"""Cross-host federation coordinator — the paper's §IV pdbtexec network of
cooperating JVMs, rebuilt over ``opt_serve`` workers (counterpart of
``repro.launch.federate``).

popt4jlib scales past one machine by running optimizer processes on separate
hosts that exchange candidate solutions by message passing. The reproduction's
analogue keeps each host exactly what it already is — an ``opt_serve`` JSONL
worker with its own scheduler, devices and checkpoint store — and adds this
thin coordinator, which:

* spawns (or connects to) N workers, each a ``repro_torch.launch.opt_serve``
  process serving TCP-JSONL, with per-worker checkpoint directories and
  optionally heterogeneous backends (``WorkerSpec.backend``) and per-worker
  algorithms — the Java network's mixed-solver deployments;
* runs the optimization as ``legs``: every leg submits one fixed-seed job per
  worker (seeds derived deterministically from ``seed``/leg/worker), blocks
  on the results, then routes each worker's best candidate **ring-wise** to
  its successor as the next leg's ``OptRequest.warm`` immigrants — the
  cross-host migration hop, at leg granularity;
* tolerates worker death/rejoin through the checkpoint manifests: a
  worker that dies mid-leg (SIGKILL included) is respawned with
  ``--resume-dir`` pointing at its own checkpoint store, which restores the
  interrupted bucket under its **original job ids** and finishes it
  bit-identically; jobs the checkpoints never captured (killed pre-snapshot,
  or finished-and-evicted) are resubmitted under the same id with the same
  request, which recomputes the identical fixed-seed answer.

Because every job seed and every warm-routing decision is a pure function of
``FederationConfig``, the federation's final incumbent is deterministic: a
run that loses a worker mid-leg finishes with the same best value as an
uninterrupted run (``tests/test_torch_federation.py`` SIGKILLs a worker to
prove it).

The port's coordinator spawns ``repro_torch.launch.opt_serve`` workers and
passes ``--device`` to them (default: each worker on the card); each
worker's banner on stderr names its device, which the result reports. With
``--backends`` left at ``xla`` the workers evaluate with the objective's
torch form, ``pallas`` with the ``bench_eval`` kernel.

    PYTHONPATH=src python -m repro_torch.launch.federate --device cpu \
        --n-workers 2 --legs 3 --fn rastrigin --dim 8 \
        --evals-per-leg 4000 --checkpoint-root /tmp/fed --demo-kill 1:1
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, IO

_LISTEN_RE = re.compile(r"listening on ([\w\.\-]+):(\d+)(?: device (\S+))?")
# The directory holding the repro_torch package, put on each worker's path.
_SRC = str(Path(__file__).resolve().parents[2])


class WorkerDied(RuntimeError):
    """A worker's socket failed mid-conversation (crash, SIGKILL, network)."""


class JsonlClient:
    """One JSONL-over-TCP conversation with an ``opt_serve`` worker.

    Newline-framed request/reply in lockstep, mirroring the Java
    ``PDBTExecSingleCltWrkInitSrv`` client. Any socket-level failure is
    normalized to :class:`WorkerDied`, which the coordinator treats as the
    revive trigger."""

    def __init__(self, host: str, port: int, timeout: float = 300.0) -> None:
        self.host, self.port = host, port
        try:
            self._sock = socket.create_connection((host, port), timeout=10.0)
        except OSError as e:
            raise WorkerDied(f"connect {host}:{port}: {e}") from e
        self._sock.settimeout(timeout)
        self._rfile = self._sock.makefile("rb")

    def request(self, msg: dict[str, Any]) -> dict[str, Any]:
        """Send one op, block for its reply line."""
        try:
            self._sock.sendall((json.dumps(msg) + "\n").encode())
            line = self._rfile.readline()
        except OSError as e:
            raise WorkerDied(f"{self.host}:{self.port}: {e}") from e
        if not line:
            raise WorkerDied(f"{self.host}:{self.port}: connection closed")
        return json.loads(line)

    def close(self) -> None:
        """Drop the connection (idempotent; socket errors are swallowed)."""
        try:
            self._rfile.close()
            self._sock.close()
        except OSError:
            pass


@dataclasses.dataclass
class WorkerSpec:
    """Per-worker deployment knobs — the heterogeneous-host axis. ``backend``
    feeds ``OptRequest.backend`` (xla | pallas evaluator per host) and
    ``algo`` the per-host policy, so a federation can mix solver kinds the
    way popt4jlib mixed DGA/DPSO servers."""

    backend: str = "xla"
    algo: str = "de"


@dataclasses.dataclass
class FederationConfig:
    """The whole federation as data: every job seed and routing decision is
    derived from these fields, which is what makes the final incumbent
    reproducible across worker deaths."""

    fn: str = "rastrigin"
    dim: int = 8
    workers: tuple[WorkerSpec, ...] = (WorkerSpec(), WorkerSpec())
    legs: int = 3                  # coordinator rounds (warm-routing hops)
    evals_per_leg: int = 4000
    seed: int = 0
    pop: int = 32
    n_islands: int = 2
    sync_every: int = 5
    checkpoint_root: str = "fed_ckpt"
    result_timeout: float = 300.0  # blocking-result deadline per job
    device: str | None = None      # workers' --device (None: the GPU)

    def job_seed(self, leg: int, worker: int) -> int:
        """Deterministic per-(leg, worker) seed — never reused across legs,
        so no leg replays another's trajectory."""
        return self.seed * 1_000_003 + leg * 1_009 + worker

    def job_id(self, leg: int, worker: int) -> str:
        """Stable id a revived worker resumes (or recomputes) the job under."""
        return f"fed-l{leg}-w{worker}"

    def request_dict(self, leg: int, worker: int,
                     warm: list[list[float]]) -> dict[str, Any]:
        """The JSONL ``submit`` request for one (leg, worker) job: the
        worker's backend/algo, the deterministic seed, and the warm
        immigrants routed to it from the previous leg."""
        spec = self.workers[worker]
        return {
            "fn": self.fn, "algo": spec.algo, "dim": self.dim,
            "pop": self.pop, "n_islands": self.n_islands,
            "sync_every": self.sync_every, "max_evals": self.evals_per_leg,
            "backend": spec.backend, "seed": self.job_seed(leg, worker),
            "warm": warm,
        }


@dataclasses.dataclass
class FederationResult:
    """Outcome of a federated run: the global incumbent plus the per-leg
    per-worker table and the fault-tolerance counters."""

    value: float
    arg: list[float]
    legs: list[list[dict[str, Any]]]   # legs[leg][worker] -> result reply
    revived: int                        # worker respawns (death mid-leg)
    resubmitted: int                    # jobs recomputed (no checkpoint row)
    devices: list[str]                  # each worker's device, from its banner


class _Worker:
    """A spawned ``opt_serve`` subprocess + its JSONL client + the checkpoint
    directory its revives resume from."""

    def __init__(self, index: int, ckpt_dir: str, device: str | None = None,
                 timeout: float = 300.0) -> None:
        self.index = index
        self.ckpt_dir = ckpt_dir
        self.device = device
        self.timeout = timeout
        self.proc: subprocess.Popen | None = None
        self.client: JsonlClient | None = None
        self.port: int | None = None
        self.banner_device: str | None = None   # the device its banner names

    def spawn(self, resume: bool = False) -> None:
        """Start (or restart) the worker process on an ephemeral port and
        wait for its banner.

        ``resume=True`` adds ``--resume-dir`` so the scheduler restores every
        interrupted bucket run from this worker's own checkpoint store before
        serving — the death/rejoin half of the federation contract."""
        self.launch(resume)
        self.await_listening()

    def launch(self, resume: bool = False) -> None:
        """Start the worker process; :meth:`await_listening` connects."""
        cmd = [sys.executable, "-m", "repro_torch.launch.opt_serve",
               "--tcp", "0", "--workers", "1", "--flush-ms", "10",
               "--checkpoint-dir", self.ckpt_dir, "--checkpoint-every", "1"]
        if self.device is not None:
            cmd += ["--device", self.device]
        if resume:
            cmd += ["--resume-dir", self.ckpt_dir]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_SRC, env.get("PYTHONPATH")) if p)
        self.proc = subprocess.Popen(
            cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, env=env)

    def await_listening(self) -> None:
        """Read the launched worker's banner and connect to its port."""
        self.port, self.banner_device = _wait_listening(self.proc.stderr)
        self.client = JsonlClient("127.0.0.1", self.port, timeout=self.timeout)

    def kill(self) -> None:
        """SIGKILL — the fault-injection hook tests and the demo use."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.send_signal(signal.SIGKILL)
            self.proc.wait()

    def shutdown(self) -> None:
        if self.client is not None:
            try:
                self.client.request({"op": "quit"})
            except WorkerDied:
                pass
            self.client.close()
        if self.proc is not None:
            # quit has drained the worker, but a TCP server keeps serving
            # other connections: stop the process rather than wait on it.
            if self.proc.poll() is None:
                self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        if self.proc is not None and self.proc.stderr is not None:
            self.proc.stderr.close()


def _wait_listening(stderr: IO[bytes], timeout: float = 120.0) -> tuple[int, str | None]:
    """Parse the worker's ephemeral port and device from its ``listening
    on`` banner (the resume summary line, when present, precedes it)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = stderr.readline()
        if not line:
            raise WorkerDied("worker exited before listening")
        m = _LISTEN_RE.search(line.decode("utf-8", "replace"))
        if m:
            return int(m.group(2)), m.group(3)
    raise WorkerDied("worker never reported a listening port")


class FederationCoordinator:
    """Drives a :class:`FederationConfig` to completion over local worker
    subprocesses, reviving any worker whose socket dies mid-leg."""

    def __init__(self, cfg: FederationConfig) -> None:
        self.cfg = cfg
        self.workers = [
            _Worker(i, os.path.join(cfg.checkpoint_root, f"worker{i}"), cfg.device,
                    cfg.result_timeout)
            for i in range(len(cfg.workers))]
        self.n_revived = 0
        self.n_resubmitted = 0
        # test/demo fault hook: called as fault_hook(leg) after the leg's
        # submits land but before results are collected
        self.fault_hook = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Spawn every worker process, then wait for their TCP banners: the
        workers start up side by side. If one never listens, every worker
        is stopped before the error propagates."""
        try:
            for w in self.workers:
                os.makedirs(w.ckpt_dir, exist_ok=True)
                w.launch()
            for w in self.workers:
                w.await_listening()
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        """Quit every worker (drains in-flight buckets) and reap it."""
        for w in self.workers:
            w.shutdown()

    # -- fault tolerance ---------------------------------------------------

    def _revive(self, w: _Worker) -> None:
        """Respawn a dead worker with ``--resume-dir``: interrupted bucket
        runs come back under their original job ids (checkpoint manifests)
        and finish bit-identically."""
        self.n_revived += 1
        if w.client is not None:
            w.client.close()
        if w.proc is not None:
            if w.proc.poll() is None:
                w.proc.kill()
                w.proc.wait()
            w.proc.stderr.close()
        w.spawn(resume=True)

    def _collect(self, w: _Worker, leg: int,
                 req: dict[str, Any]) -> dict[str, Any]:
        """Blocking result fetch with revive-on-death. Three outcomes per
        attempt: a final reply (done); ``unknown-id`` (the job never reached
        a checkpoint, or finished and was evicted by the crash) — resubmit
        the same request under the same id and recompute the identical
        fixed-seed answer; a dead socket — revive from checkpoints and
        retry."""
        jid = self.cfg.job_id(leg, w.index)
        for _ in range(4):                 # spawn->die loops are bounded
            try:
                reply = w.client.request(
                    {"op": "result", "id": jid})
                if reply.get("error") == "unknown-id":
                    self.n_resubmitted += 1
                    w.client.request(
                        {"op": "submit", "id": jid, "request": req})
                    reply = w.client.request({"op": "result", "id": jid})
                if reply.get("status") == "done":
                    return reply
                raise WorkerDied(f"job {jid} ended {reply!r}")
            except WorkerDied:
                self._revive(w)
        raise WorkerDied(f"worker {w.index} kept dying on job {jid}")

    # -- the run -----------------------------------------------------------

    def run(self) -> FederationResult:
        """Execute every leg: submit one job per worker, collect, route each
        worker's best candidate to its ring successor as the next leg's warm
        immigrants. Returns the deterministic global incumbent."""
        cfg = self.cfg
        n = len(self.workers)
        warm: list[list[list[float]]] = [[] for _ in range(n)]
        legs: list[list[dict[str, Any]]] = []
        best_val, best_arg = float("inf"), None
        for leg in range(cfg.legs):
            reqs = [cfg.request_dict(leg, i, warm[i]) for i in range(n)]
            for w, req in zip(self.workers, reqs):
                try:
                    w.client.request({"op": "submit",
                                      "id": cfg.job_id(leg, w.index),
                                      "request": req})
                except WorkerDied:
                    self._revive(w)   # resubmitted via unknown-id in _collect
            if self.fault_hook is not None:
                self.fault_hook(leg)
            rows = [self._collect(w, leg, req)
                    for w, req in zip(self.workers, reqs)]
            legs.append(rows)
            for r in rows:
                if r["value"] < best_val:
                    best_val, best_arg = r["value"], r["arg"]
            # ring routing: worker i's best seeds worker (i+1)'s next leg
            warm = [[rows[(i - 1) % n]["arg"]] for i in range(n)]
        return FederationResult(value=best_val, arg=best_arg, legs=legs,
                                revived=self.n_revived,
                                resubmitted=self.n_resubmitted,
                                devices=[w.banner_device for w in self.workers])


def federate(cfg: FederationConfig) -> FederationResult:
    """Run one federation start-to-finish (spawn, legs, shutdown) — the
    programmatic entry point ``tests/test_torch_federation.py`` drives."""
    coord = FederationCoordinator(cfg)
    coord.start()
    try:
        return coord.run()
    finally:
        coord.close()


def main(argv: list[str] | None = None) -> None:
    """CLI entry point — the docs walkthrough and the CI federation smoke."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-workers", type=int, default=2)
    ap.add_argument("--legs", type=int, default=3)
    ap.add_argument("--fn", default="rastrigin")
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--evals-per-leg", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pop", type=int, default=32)
    ap.add_argument("--n-islands", type=int, default=2)
    ap.add_argument("--backends", default="xla",
                    help="comma list cycled over workers (heterogeneous "
                         "hosts), e.g. xla,pallas")
    ap.add_argument("--algos", default="de",
                    help="comma list cycled over workers, e.g. de,pso")
    ap.add_argument("--checkpoint-root", default="fed_ckpt")
    ap.add_argument("--device", default=None,
                    help="the workers' --device (default: the GPU)")
    ap.add_argument("--demo-kill", default=None, metavar="LEG:WORKER",
                    help="SIGKILL worker W after leg L's submits land — the "
                         "kill/resume demo; the run still finishes with the "
                         "uninterrupted incumbent")
    args = ap.parse_args(argv)

    backends = args.backends.split(",")
    algos = args.algos.split(",")
    cfg = FederationConfig(
        fn=args.fn, dim=args.dim, legs=args.legs,
        evals_per_leg=args.evals_per_leg, seed=args.seed, pop=args.pop,
        n_islands=args.n_islands, checkpoint_root=args.checkpoint_root,
        device=args.device,
        workers=tuple(WorkerSpec(backend=backends[i % len(backends)],
                                 algo=algos[i % len(algos)])
                      for i in range(args.n_workers)))
    coord = FederationCoordinator(cfg)
    if args.demo_kill:
        kleg, kworker = (int(x) for x in args.demo_kill.split(":"))

        def fault(leg: int) -> None:
            if leg == kleg:
                print(f"[federate] SIGKILL worker {kworker} at leg {leg}",
                      file=sys.stderr, flush=True)
                coord.workers[kworker].kill()

        coord.fault_hook = fault
    coord.start()
    try:
        res = coord.run()
    finally:
        coord.close()
    print(json.dumps({"value": res.value, "arg": res.arg,
                      "legs": len(res.legs), "revived": res.revived,
                      "resubmitted": res.resubmitted, "devices": res.devices}))


if __name__ == "__main__":
    main()
