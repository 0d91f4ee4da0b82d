"""Shape-bucketed multi-job scheduler — popt4jlib ``PDBatchTaskExecutorSrv``
over the island engine (counterpart of ``repro.core.scheduler``).

The Java server accepts batches of independent ``TaskObject``s from many
clients and farms them to a worker network. Here the "worker network" is the
card: concurrent :class:`~repro_torch.core.api.OptRequest`s are bucketed by
shape-class (``OptRequest.shape_class()`` — everything but the seed), and
each bucket runs as one jobs-axis run whose state folds the jobs into the
island dimension (``IslandOptimizer.bucket_stepper``): J same-shaped jobs
cost one kernel launch per generation instead of J. The optimizer of each
shape-class (and its evaluator, through the executor's cache) is reused
across flushes.

Service hardening, as in the reference:

  * ``workers > 0`` runs bucket flushes on a bounded worker-thread pool with
    **priority lanes** (highest submitted priority in a bucket wins) instead
    of blocking the caller;
  * every bucket runs host-stepped, a round at a time, so each run
    **streams per-round progress** into its jobs' :class:`OptResponse`\\ s
    (one ``(J,)`` device-to-host read per round), honours **cooperative
    cancellation** at round boundaries (partial result returned), and
    **snapshots its engine state** through ``checkpoint/store.py`` on a
    cadence;
  * ``resume(dir)`` restores interrupted bucket runs after a crash/SIGKILL
    and finishes them **bit-identically** to an uninterrupted run (same
    round-key streams, restored state);
  * ``max_pending`` bounds the host-side queue — submissions over capacity
    are **load-shed** with :class:`SchedulerOverloaded` carrying a
    ``retry_after_ms`` hint.

Portfolio and sharded (``devices > 1``) buckets take the reference's
resident path: the optimizer refuses them a stepper (``bucket_stepper``
raises ``ValueError``), so the bucket runs as one ``minimize_many`` with no
streaming, no mid-run cancel and no mid-run checkpoint, and a warm-started
one as one ``minimize`` per job. A sharded request gets its own
``MeshConfig(devices)``, whose route ``core.mesh.default_backend`` picks
(nccl with a GPU per rank, gloo otherwise), so its bucket runs on spawned
ranks; one the host cannot place ends in ``error`` inside its own bucket.
Async buckets run stepped, on the all-ones schedule, and their checkpoints
carry the mailbox leaves.

Worker threads launch kernels on the current stream of the scheduler's
device.
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
import itertools
import json
import os
import shutil
import threading
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.core.api import OptimizeResult, OptRequest, OptResponse
from repro_torch.core.executor import ExecutorConfig
from repro_torch.core.islands import IslandConfig, IslandOptimizer
from repro_torch.core.mesh import MeshConfig
from repro_torch.functions import get as get_function

BucketKey = tuple

FINAL_STATUSES = ("done", "error", "cancelled")

# Request backends (the reference's names, and the port's own) -> the port's
# executor backend: the bench_eval kernel, or the objective's torch form.
EXEC_BACKEND = {"pallas": "cuda", "xla": "torch", "cuda": "cuda", "torch": "torch"}


class SchedulerOverloaded(RuntimeError):
    """Load-shed signal: the scheduler's bounded pending queue is full. The
    service maps it to ``{"error": "overloaded", "retry_after_ms": ...}``."""

    def __init__(self, retry_after_ms: int) -> None:
        super().__init__(f"pending queue full; retry in {retry_after_ms} ms")
        self.retry_after_ms = retry_after_ms


class UnknownJob(KeyError):
    """Lookup of a job id the scheduler does not hold (never submitted, or
    evicted by a fetch-once ``result``) — the service answers
    ``{"error": "unknown-id"}``."""


class AbandonRun(Exception):
    """Raised from a ``fault_hook`` to make a worker abandon its bucket
    mid-run *without* finalizing jobs or cleaning up checkpoints — a killed
    process, in process, so tests can exercise ``resume``."""


@dataclasses.dataclass
class _Job:
    request: OptRequest
    response: OptResponse
    submitted_at: float  # host monotonic clock; drives deadline-based flush
    priority: int = 0              # higher runs first (service priority lanes)
    cancel_requested: bool = False # cooperative: honored at round boundaries
    preemptible: bool = False      # True while a host-stepped run owns the job
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)

    def finished(self) -> bool:
        return self.response.status in FINAL_STATUSES


@dataclasses.dataclass
class _RunItem:
    """One dispatched bucket run: the job rows (in key order; ``None`` rows
    are jobs that finished before a resumed run was interrupted) plus an
    optional restored-state payload for resumed runs."""

    key: BucketKey
    rows: list
    resume: dict | None = None     # {"state", "start", "hist"}
    store_dir: str | None = None   # resumed runs keep their original dir


class ShapeBucketScheduler:
    """Accepts many concurrent OptRequests, runs each shape-class as one
    jobs-axis bucket on ``device`` (``None``: the card).

    Host-side lifecycle: ``submit`` queues a job into its bucket;
    ``flush``/``flush_bucket`` executes pending buckets (inline when
    ``workers == 0``, on the priority worker pool otherwise); ``poll``
    reports status + streamed progress without blocking; ``result`` forces
    the job's bucket to run and returns its :class:`OptResponse` envelope;
    ``cancel`` preempts cooperatively at the next round boundary;
    ``resume`` restores interrupted runs from a checkpoint directory.
    """

    def __init__(self, device: str | torch.device | None = None,
                 exec_cfg: ExecutorConfig = ExecutorConfig(),
                 max_cached_buckets: int = 64,
                 workers: int = 0,
                 max_pending: int = 0,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 8,
                 fault_hook: Callable[[BucketKey, int], None] | None = None) -> None:
        self.device = resolve_device(device)
        self.exec_cfg = exec_cfg
        # shape-classes are client-controlled, so the optimizer and function
        # caches are LRU-capped — a traffic mix wider than the cap rebuilds
        # instead of growing host/device memory without bound
        self.max_cached_buckets = max_cached_buckets
        self.workers = workers
        self.max_pending = max_pending       # 0 = unbounded (no load-shed)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = max(1, checkpoint_every)
        self.fault_hook = fault_hook         # tests/benchmarks inject faults here
        self._pending: dict[BucketKey, list[_Job]] = {}
        self._jobs: dict[str, _Job] = {}
        self._optimizers: dict[BucketKey, IslandOptimizer] = {}
        self._functions: dict[tuple[str, int], Any] = {}
        self._ids = itertools.count()
        self.n_dispatches = 0   # bucket runs issued (perf accounting)
        self.n_jobs_run = 0
        self.n_shed = 0         # submissions load-shed by backpressure
        self.n_cancelled = 0
        self.n_resumed = 0      # jobs restored from checkpoints
        self.n_resume_failed = 0
        # Worker pool: a priority heap of _RunItems drained by daemon threads.
        self._mu = threading.RLock()
        self._cv = threading.Condition(self._mu)
        self._ready: list[tuple[int, int, _RunItem]] = []  # (-prio, seq, item)
        self._seq = itertools.count()
        self._shutdown = False
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"sched-worker-{i}")
            for i in range(workers)]
        for t in self._threads:
            t.start()

    # -- submission --------------------------------------------------------

    def submit(self, req: OptRequest, job_id: str | None = None,
               priority: int = 0) -> str:
        """Queue a job into its shape-class bucket; returns its job id.

        ``priority`` feeds the worker pool's lanes: when workers pick the
        next bucket, the one holding the highest-priority job wins (FIFO
        within a lane). Raises :class:`SchedulerOverloaded` when
        ``max_pending`` is set and the queue is full (load-shed)."""
        with self._mu:
            if self.max_pending and self._n_waiting() >= self.max_pending:
                self.n_shed += 1
                backlog = self._n_waiting() // max(1, self.workers or 1)
                raise SchedulerOverloaded(min(5000, 50 * (1 + backlog)))
            if job_id is None:
                job_id = f"job{next(self._ids)}"
                while job_id in self._jobs:  # skip ids a client claimed itself
                    job_id = f"job{next(self._ids)}"
            elif job_id in self._jobs:
                raise ValueError(f"duplicate job id {job_id!r}")
            job = _Job(req, OptResponse(job_id), time.monotonic(),
                       priority=priority)
            self._jobs[job_id] = job
            self._pending.setdefault(req.shape_class(), []).append(job)
            return job_id

    def _n_waiting(self) -> int:
        """Jobs queued but not yet running (pending buckets + ready heap) —
        the quantity ``max_pending`` bounds. Callers hold ``_mu``."""
        n = sum(len(v) for v in self._pending.values())
        for _, _, item in self._ready:
            n += sum(1 for j in item.rows if j is not None and not j.finished())
        return n

    # -- bucket plumbing ---------------------------------------------------

    def _lru_get(self, cache: dict, key):
        """Hit moves the entry to the MRU end (dicts keep insertion order)."""
        val = cache.pop(key, None)
        if val is not None:
            cache[key] = val
        return val

    def _lru_put(self, cache: dict, key, val) -> None:
        cache[key] = val
        while len(cache) > self.max_cached_buckets:
            cache.pop(next(iter(cache)))

    def _function(self, req: OptRequest):
        with self._mu:
            fk = (req.fn, req.dim)
            f = self._lru_get(self._functions, fk)
            if f is None:
                f = get_function(req.fn, req.dim)
                self._lru_put(self._functions, fk, f)
            return f

    def _optimizer(self, req: OptRequest) -> IslandOptimizer:
        with self._mu:
            key = req.shape_class()
            opt = self._lru_get(self._optimizers, key)
            if opt is None:
                from repro_torch.core import ALGORITHMS  # late: core/__init__ imports us
                if req.backend not in EXEC_BACKEND:
                    raise ValueError(f"unknown backend {req.backend!r}; expected "
                                     f"one of {sorted(EXEC_BACKEND)}")
                cfg = IslandConfig(
                    n_islands=req.n_islands, pop=req.pop, dim=req.dim,
                    sync_every=req.sync_every, migration=req.migration,
                    n_migrants=req.n_migrants, share_incumbent=req.share_incumbent,
                    max_evals=req.max_evals, polish=req.polish,
                    polish_every=req.polish_every, polish_topk=req.polish_topk,
                    polish_steps=req.polish_steps, portfolio=req.portfolio,
                    sync_policy=req.sync_policy,
                    max_staleness=req.max_staleness,
                )
                # Portfolio requests run heterogeneous per-island policies:
                # `algo` is ignored and `params` maps policy name -> kwargs
                # (build_portfolio thaws the frozen pair-tuples).
                maker = None if req.portfolio else ALGORITHMS[req.algo]
                # Sharded requests get their own island mesh; its placement
                # check raises inside flush_bucket's fault isolation when the
                # host cannot place the ranks, so one impossible request
                # cannot take the service down.
                mesh_cfg = (MeshConfig(devices=req.devices)
                            if req.devices > 1 else None)
                opt = IslandOptimizer(
                    maker, cfg, params=dict(req.params),
                    exec_cfg=dataclasses.replace(
                        self.exec_cfg, backend=EXEC_BACKEND[req.backend]),
                    device=self.device, mesh_cfg=mesh_cfg)
                self._lru_put(self._optimizers, key, opt)
            return opt

    def pending_buckets(self) -> list[tuple[BucketKey, int, float]]:
        """(key, n_jobs, oldest_submit_time) per non-empty bucket."""
        with self._mu:
            return [(k, len(js), js[0].submitted_at)  # FIFO: first is oldest
                    for k, js in self._pending.items()]

    def pending_count(self, key: BucketKey) -> int:
        """Queued jobs in one bucket — O(1), for the service's size trigger."""
        with self._mu:
            return len(self._pending.get(key, ()))

    # -- execution ---------------------------------------------------------

    def flush_bucket(self, key: BucketKey) -> list[str]:
        """Dispatch every pending job in one bucket as a single jobs-axis run.

        With ``workers == 0`` the run executes inline (the blocking baseline);
        otherwise it is enqueued on the priority worker pool and this returns
        immediately with the dispatched job ids."""
        with self._mu:
            jobs = self._pending.pop(key, [])
            if not jobs:
                return []
            item = _RunItem(key, jobs)
            if self.workers:
                prio = max(j.priority for j in jobs)
                heapq.heappush(self._ready, (-prio, next(self._seq), item))
                self._cv.notify()
                return [j.response.job_id for j in jobs]
        self._run_bucket(item)
        return [j.response.job_id for j in jobs]

    def flush(self) -> int:
        """Dispatch all pending buckets; returns the number of jobs moved."""
        n = 0
        for key, _, _ in self.pending_buckets():
            n += len(self.flush_bucket(key))
        return n

    def drain(self, timeout: float | None = None) -> bool:
        """Flush everything and wait for all known jobs to reach a final
        status; True if fully drained within ``timeout``."""
        self.flush()
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._mu:
            jobs = list(self._jobs.values())
        for j in jobs:
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                return False
            if not j.finished() and not j.done.wait(left):
                return False
        return True

    def close(self) -> None:
        """Stop the worker pool (idle workers exit; running buckets finish)."""
        with self._mu:
            self._shutdown = True
            self._cv.notify_all()

    def _worker(self) -> None:
        while True:
            with self._mu:
                while not self._ready and not self._shutdown:
                    self._cv.wait()
                if self._shutdown and not self._ready:
                    return
                _, _, item = heapq.heappop(self._ready)
            try:
                self._run_bucket(item)
            except AbandonRun:
                pass     # fault injection: leave jobs/checkpoints untouched
            except Exception:  # noqa: BLE001 — a worker must never die silently
                traceback.print_exc()

    # -- the bucket run ----------------------------------------------------

    def _finalize(self, job: _Job, status: str,
                  result: OptimizeResult | None = None,
                  error: str | None = None) -> None:
        resp = job.response
        resp.result, resp.error = result, error
        if result is not None:
            resp.best_val = result.value
            resp.evals_done = result.n_evals
        resp.status = status        # status last: readers see a complete record
        job.preemptible = False
        if status == "cancelled":
            self.n_cancelled += 1
        job.done.set()

    def _run_bucket(self, item: _RunItem) -> None:
        """Execute one dispatched bucket (worker-thread or inline body)."""
        rows = item.rows
        with self._mu:
            # cancellations that arrived while queued: finalize without running
            for j in list(rows):
                if j is not None and j.cancel_requested and not j.finished():
                    self._finalize(j, "cancelled")
            live = [j for j in rows
                    if j is not None and not j.finished()]
            if not live:
                return
            for j in live:
                j.response.status = "running"
        req0 = live[0].request
        try:
            opt = self._optimizer(req0)
            f = self._function(req0)
            try:
                stepper = opt.bucket_stepper(f)
            except ValueError:      # portfolio or sharded: no host stepping
                stepper = None
            if stepper is None:
                self._run_resident(item, opt, f)
            else:
                self._run_stepped(item, stepper)
        except AbandonRun:
            raise
        except Exception as e:  # noqa: BLE001 — job-level fault isolation
            msg = f"{type(e).__name__}: {e}"
            traceback.print_exc()
            with self._mu:
                for j in rows:
                    if j is not None and not j.finished():
                        self._finalize(j, "error", error=msg)

    def _keys(self, reqs: list) -> torch.Tensor:
        """``(J, 2)`` job keys; ``None`` rows (jobs a resumed run finished
        before it stopped) take seed 0 and are never reported."""
        return torch.stack([prng.PRNGKey(r.seed if r is not None else 0)
                            for r in reqs]).to(self.device)

    def _run_resident(self, item: _RunItem, opt: IslandOptimizer, f) -> None:
        """The reference's path for buckets without a stepper (portfolio
        islands, sharded requests): one ``minimize_many`` — no streaming,
        no mid-run preemption or checkpoint. A warm-started bucket runs one
        ``minimize`` per job instead: warm is value-keyed into the
        shape-class, so every row shares the same batch."""
        jobs = [j for j in item.rows if j is not None and not j.finished()]
        keys = self._keys([j.request for j in jobs])
        warm = jobs[0].request.warm
        if warm:
            results = [opt.minimize(f, k, warm=np.asarray(warm, np.float32))
                       for k in keys]
        else:
            results = opt.minimize_many(f, keys)
        with self._mu:
            self.n_dispatches += 1
            self.n_jobs_run += len(jobs)
            for j, res in zip(jobs, results):
                self._finalize(j, "done", result=res)

    def _run_store(self, item: _RunItem) -> CheckpointStore | None:
        """Per-run checkpoint store under ``checkpoint_dir`` — the directory
        name is a digest of the (id, request) rows, so a restarted server
        finds exactly the runs it was killed holding."""
        if item.store_dir is not None:     # resumed: keep the original dir so
            return CheckpointStore(item.store_dir, keep=2)  # no stale run leaks
        if self.checkpoint_dir is None:
            return None
        spec = [(j.response.job_id if j is not None else None,
                 dataclasses.asdict(j.request) if j is not None else None)
                for j in item.rows]
        digest = hashlib.sha256(
            json.dumps(spec, sort_keys=True, default=str).encode()).hexdigest()
        return CheckpointStore(
            os.path.join(self.checkpoint_dir, f"run_{digest[:12]}"), keep=2)

    def _run_stepped(self, item: _RunItem, stepper) -> None:
        """Host-stepped bucket run: stream progress, honor cancellation at
        round boundaries, checkpoint on the cadence. The trajectory is
        bit-identical to ``minimize_many`` on the same keys."""
        rows = item.rows
        keys = self._keys([j.request if j is not None else None for j in rows])
        n_rounds, sync_every = stepper.n_rounds, stepper.cfg.sync_every
        if item.resume is None:
            state, round_keys = stepper.init(keys)
            start, hist = 0, []
            # Federation warm-start (OptRequest.warm, value-keyed into the
            # shape-class so the whole bucket shares one batch): adopt the
            # immigrants before round 0. Checkpoints snapshot post-injection
            # state, so resumed runs never re-inject.
            req0 = next(j.request for j in rows if j is not None)
            if req0.warm:
                state = stepper.inject(state, np.asarray(req0.warm, np.float32))
        else:
            state = item.resume["state"]
            start = item.resume["start"]
            hist = list(item.resume["hist"])
            round_keys = stepper.round_keys(keys)
        store = self._run_store(item)
        live = {i for i, j in enumerate(rows)
                if j is not None and not j.finished()}

        with self._mu:
            self.n_dispatches += 1
            self.n_jobs_run += len(live)
        for i in live:
            rows[i].preemptible = True
            rows[i].response.n_rounds = n_rounds

        def partial_row(i: int, r_done: int, args, vals) -> OptimizeResult:
            h = (np.stack(hist, axis=1)[i] if hist
                 else np.zeros((0,), np.float32))
            return OptimizeResult(
                arg=args[i], value=float(vals[i]),
                n_evals=stepper.evals_done(r_done),
                n_gens=r_done * sync_every, history=h)

        def host_best() -> tuple[np.ndarray, np.ndarray]:
            args, bvals = stepper.best(state)
            host = torch.cat([args, bvals[:, None]], 1).cpu().numpy()
            return host[:, :-1], host[:, -1]

        for r in range(start, n_rounds):
            state, vals = stepper.step(state, round_keys, r)
            vals_np = vals.cpu().numpy()    # the round's one device-to-host read
            hist.append(vals_np)
            r_done = r + 1
            for i in live:
                resp = rows[i].response
                resp.round = r_done
                resp.best_val = float(vals_np[i])
                resp.evals_done = stepper.evals_done(r_done)
            # cooperative preemption: cancelled jobs leave with the incumbent
            # they hold at this round boundary (partial result)
            cancels = [i for i in live if rows[i].cancel_requested]
            if cancels:
                args, bvals = host_best()
                with self._mu:
                    for i in cancels:
                        self._finalize(rows[i], "cancelled",
                                       result=partial_row(i, r_done, args, bvals))
                        live.discard(i)
            if not live:
                break
            if (store is not None and r_done % self.checkpoint_every == 0
                    and r_done < n_rounds):
                self._save_checkpoint(store, item, state, hist, r_done)
            if self.fault_hook is not None:
                self.fault_hook(item.key, r_done)

        if live:
            args, bvals = host_best()
            hist_arr = np.stack(hist, axis=1)
            with self._mu:
                for i in live:
                    res = OptimizeResult(
                        arg=args[i], value=float(bvals[i]),
                        n_evals=stepper.evals_done(n_rounds),
                        n_gens=n_rounds * sync_every, history=hist_arr[i])
                    self._finalize(rows[i], "done", result=res)
        if store is not None:       # run is over: its snapshots are garbage
            store.wait()
            shutil.rmtree(store.root, ignore_errors=True)

    def _save_checkpoint(self, store: CheckpointStore, item: _RunItem,
                         state, hist: list, r_done: int) -> None:
        """Snapshot the run: engine state + history as the payload, round
        counter + per-row (id, request, priority, liveness) as the manifest
        extra ``resume`` rebuilds the run from."""
        tree = {"state": state,
                "history": np.stack(hist, axis=1).astype(np.float32)}
        extra = {"round": r_done, "jobs": [
            None if j is None or j.finished() else {
                "id": j.response.job_id, "priority": j.priority,
                "request": dataclasses.asdict(j.request)}
            for j in item.rows]}
        store.save(r_done, tree, extra=extra, blocking=False)

    # -- crash recovery ----------------------------------------------------

    def resume(self, root: str) -> dict[str, Any]:
        """Restore every interrupted bucket run under ``root`` and requeue it
        (inline when ``workers == 0``). Jobs come back under their original
        ids and finish **bit-identically** to an uninterrupted run — the
        restored state plus the re-derived round-key streams replay exactly
        the rounds the killed server never ran. A checkpoint that fails
        validation is rejected cleanly: its jobs are registered in ``error``
        status (``n_resume_failed`` counts them) and the server keeps
        serving. Returns a summary dict."""
        summary: dict[str, Any] = {"resumed": [], "failed": []}
        if not os.path.isdir(root):
            return summary
        for name in sorted(os.listdir(root)):
            run_dir = os.path.join(root, name)
            if not os.path.isdir(run_dir):
                continue
            store = CheckpointStore(run_dir, keep=2)
            if not store.list_steps():
                continue
            try:
                item = self._restore_run(store)
            except Exception as e:  # noqa: BLE001 — reject cleanly, keep serving
                self.n_resume_failed += 1
                summary["failed"].append({"dir": name, "error": str(e)})
                self._mark_resume_failed(store, name, e)
                continue
            ids = [j.response.job_id for j in item.rows if j is not None]
            self.n_resumed += len(ids)
            summary["resumed"].append({"dir": name, "jobs": ids,
                                       "round": item.resume["start"]})
            if self.workers:
                with self._mu:
                    prio = max((j.priority for j in item.rows
                                if j is not None), default=0)
                    heapq.heappush(self._ready, (-prio, next(self._seq), item))
                    self._cv.notify()
            else:
                self._run_bucket(item)
        return summary

    def _restore_run(self, store: CheckpointStore) -> _RunItem:
        """Rebuild one interrupted run: requests from the manifest, state
        shapes and dtypes from the stepper's template, leaves checked by
        the store."""
        step = store.latest_step()
        manifest = store.read_manifest(step)
        extra = manifest["extra"]
        specs = extra["jobs"]
        reqs = [None if s is None else OptRequest.from_dict(s["request"])
                for s in specs]
        req0 = next(r for r in reqs if r is not None)
        stepper = self._optimizer(req0).bucket_stepper(self._function(req0))
        like = {"state": stepper.state_shape(self._keys(reqs)),
                "history": np.empty((len(reqs), extra["round"]), np.float32)}
        _, tree, _ = store.restore(like, step=step, device=self.device)
        hist_arr = tree["history"].cpu().numpy()
        rows: list = []
        with self._mu:
            for spec, req in zip(specs, reqs):
                if spec is None:
                    rows.append(None)
                    continue
                if spec["id"] in self._jobs:
                    raise ValueError(f"job id {spec['id']!r} already registered")
                job = _Job(req, OptResponse(spec["id"]), time.monotonic(),
                           priority=spec.get("priority", 0))
                self._jobs[spec["id"]] = job
                rows.append(job)
        return _RunItem(
            key=req0.shape_class(), rows=rows, store_dir=store.root,
            resume={"state": tree["state"], "start": extra["round"],
                    "hist": [hist_arr[:, i] for i in range(hist_arr.shape[1])]})

    def _mark_resume_failed(self, store: CheckpointStore, name: str,
                            err: Exception) -> None:
        """Register a rejected checkpoint's jobs (when the manifest is still
        readable) in ``error`` status so clients get a structured answer."""
        try:
            manifest = store.read_manifest(store.latest_step())
        except Exception:  # noqa: BLE001 — manifest unreadable: nothing to mark
            return
        with self._mu:
            for spec in manifest.get("extra", {}).get("jobs", []):
                if spec is None or spec["id"] in self._jobs:
                    continue
                job = _Job(OptRequest.from_dict(spec["request"]),
                           OptResponse(spec["id"]), time.monotonic())
                self._jobs[spec["id"]] = job
                self._finalize(job, "error",
                               error=f"checkpoint restore failed: {err}")

    # -- retrieval ---------------------------------------------------------

    def poll(self, job_id: str) -> OptResponse:
        """Non-blocking status + streamed-progress lookup; never triggers a
        bucket run. Raises :class:`UnknownJob` for unknown/evicted ids."""
        try:
            return self._jobs[job_id].response
        except KeyError:
            raise UnknownJob(job_id) from None

    def result(self, job_id: str, evict: bool = False,
               timeout: float | None = None) -> OptResponse:
        """Blocking fetch: dispatch the job's bucket if it has not run yet,
        then wait for a final status (pool mode waits on the job's event; the
        inline mode has already run it).

        ``evict=True`` drops the finished job's record (the Java server's
        fetch-once result semantics) — long-lived services use it so the job
        table does not grow without bound.
        """
        with self._mu:
            try:
                job = self._jobs[job_id]
            except KeyError:
                raise UnknownJob(job_id) from None
        if job.response.status == "queued":
            self.flush_bucket(job.request.shape_class())
        if self.workers:
            job.done.wait(timeout)
        with self._mu:
            if evict and job.finished():
                self._jobs.pop(job_id, None)
        return job.response

    def cancel(self, job_id: str) -> dict[str, Any]:
        """Cancel a job: queued jobs are withdrawn immediately; running jobs
        are preempted cooperatively at the next round boundary and return a
        *partial* result. Returns a structured reply dict; raises
        :class:`UnknownJob` for unknown/evicted ids. A finished job yields
        ``{"error": ...}`` instead of a traceback."""
        with self._mu:
            try:
                job = self._jobs[job_id]
            except KeyError:
                raise UnknownJob(job_id) from None
            status = job.response.status
            if status in FINAL_STATUSES:
                return {"id": job_id, "error": "already-finished",
                        "status": status}
            if status == "queued":
                job.cancel_requested = True
                bucket = self._pending.get(job.request.shape_class())
                if bucket is not None and job in bucket:
                    bucket.remove(job)     # withdrawn before dispatch
                    if not bucket:
                        del self._pending[job.request.shape_class()]
                    self._finalize(job, "cancelled")
                    return {"id": job_id, "status": "cancelled"}
                return {"id": job_id, "status": "cancelling"}
            if not job.preemptible:
                return {"id": job_id, "error": "not-cancellable",
                        "status": status}
            job.cancel_requested = True
            return {"id": job_id, "status": "cancelling"}

    # -- introspection -----------------------------------------------------

    def bucket_status(self) -> dict[str, dict[str, Any]]:
        """Per-bucket lifecycle counts + engine sync policy over the jobs the
        scheduler holds — the service's ``status`` op. Buckets are labeled
        ``fn|algo|dim=D|#hash`` (hash over the full shape-class); each entry
        is ``{"counts": {status: n}, "sync_policy": "barrier"|"async"}``."""
        out: dict[str, dict[str, Any]] = {}
        with self._mu:
            for job in self._jobs.values():
                req = job.request
                key = req.shape_class()
                h = hashlib.sha256(repr(key).encode()).hexdigest()[:8]
                algo = "portfolio" if req.portfolio else req.algo
                label = f"{req.fn}|{algo}|dim={req.dim}|#{h}"
                entry = out.setdefault(
                    label, {"counts": {}, "sync_policy": req.sync_policy})
                st = job.response.status
                entry["counts"][st] = entry["counts"].get(st, 0) + 1
        return out

    def queue_depth(self) -> int:
        """Dispatched buckets waiting in the worker-pool priority queue —
        backlog the pool has accepted but not yet started."""
        with self._mu:
            return len(self._ready)

    def stats(self) -> dict[str, int]:
        """Queue/dispatch/hardening counters for the service's ``stats`` op."""
        with self._mu:
            return {
                "submitted": len(self._jobs),
                "pending": sum(len(v) for v in self._pending.values()),
                "buckets_pending": len(self._pending),
                "dispatches": self.n_dispatches,
                "jobs_run": self.n_jobs_run,
                "workers": self.workers,
                "shed": self.n_shed,
                "cancelled": self.n_cancelled,
                "resumed": self.n_resumed,
                "resume_failed": self.n_resume_failed,
            }
