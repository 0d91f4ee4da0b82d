"""Multi-job optimization service — the popt4jlib ``PDBTExecSingleCltWrkInitSrv``
client/server loop over the shape-bucketed scheduler (counterpart of
``repro.launch.opt_serve``: the same ops, replies and flags, plus
``--device``; worker-pool flushes, streaming progress, cancellation,
backpressure and checkpoint/resume).

The service runs its buckets on the card unless ``--device cpu`` is given
(the plain PyTorch path); its startup line on stderr names the device.

One JSON object per line (JSONL), over stdin/stdout (default) or TCP
(``--tcp PORT``). The ops mirror the Java server's client protocol
(submit work / poll / fetch results / shutdown):

    {"op": "submit", "request": {"fn": "rastrigin", "algo": "de", "dim": 8,
                                 "max_evals": 4000, "seed": 1}}
        -> {"id": "job0", "status": "queued"}
    {"op": "submit", "priority": 5, "request": {...}}
        -> priority lane: the worker pool runs higher-priority buckets first
    {"op": "poll", "id": "job0"}      -> {"id": "job0", "status": "running",
                                          "round": 12, "n_rounds": 40,
                                          "best_val": ..., "evals_done": ...}
    {"op": "result", "id": "job0"}    -> {"id": "job0", "status": "done",
                                          "value": ..., "arg": [...], "n_evals": ...}
    {"op": "cancel", "id": "job0"}    -> cooperative preemption at the next
                                         round boundary; partial result kept
    {"op": "status"}                  -> per-bucket {"counts": {...},
                                         "sync_policy": ...} + worker-pool
                                         "queue_depth" (accepted, unstarted)
    {"op": "flush"}                   -> {"flushed": N}
    {"op": "stats"}                   -> scheduler + queue counters
    {"op": "quit"}                    -> {"bye": true}

Unknown or already-evicted job ids yield a structured
``{"error": "unknown-id", "id": ...}`` reply; when ``--max-pending`` is set,
submissions over capacity are load-shed with
``{"error": "overloaded", "retry_after_ms": ...}``.

With ``--workers N`` (the production shape) bucket flushes run on a bounded
worker-thread pool with priority lanes, so a slow bucket never blocks the
request loop — submit/poll/cancel/status stay responsive while long jobs
stream per-round progress. ``--checkpoint-dir`` snapshots every running
bucket's engine state each ``--checkpoint-every`` rounds through
``checkpoint/store.py``; after a crash or SIGKILL, restarting with
``--resume-dir`` restores the interrupted runs under their original job ids
and finishes them bit-identically to an uninterrupted fixed-seed run. With
``--workers 0`` the service keeps the blocking behavior — one global op
lock, flushes inline.

Hybrid memetic jobs are plain requests with polish fields — they bucket
separately from plain jobs because polish parameters join the shape-class:

    {"op": "submit", "request": {"fn": "rosenbrock", "dim": 12, "max_evals": 20000,
                                 "polish": "asd", "polish_every": 3,
                                 "polish_topk": 2, "polish_steps": 2, "seed": 0}}

Request backends keep the reference's names: ``"pallas"`` runs the
``bench_eval`` kernel and ``"xla"`` the objective's torch form (``"cuda"``
and ``"torch"`` are accepted too). Portfolio requests (``"portfolio":
["de", "pso", "sa"]``, per-policy ``params``) run as one resident bucket
without streaming; async requests (``"sync_policy": "async"``) run stepped.
Sharded (``"devices": N`` > 1) requests run as resident buckets on N
spawned ranks (``core/mesh.py``: nccl with a GPU per rank, gloo on the CPU
or with several ranks on one card); a request the host cannot place ends
in ``error`` inside its own bucket.

Batching policy (host-side queue): a bucket is dispatched when it reaches
``--max-batch`` queued jobs, when its oldest job ages past the ``--flush-ms``
deadline, or when a client forces it via ``result``/``flush``. Everything the
deadline window packs into one bucket runs as a single jobs-axis
run.

    PYTHONPATH=src python -m repro_torch.launch.opt_serve --device cpu --flush-ms 50 <<'EOF'
    {"op": "submit", "request": {"fn": "sphere", "dim": 4, "max_evals": 2000, "seed": 0}}
    {"op": "result", "id": "job0"}
    EOF
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import select
import socketserver
import sys
import threading
import time
from typing import Any

from repro_torch.core.api import OptRequest
from repro_torch.core.scheduler import (SchedulerOverloaded,
                                        ShapeBucketScheduler, UnknownJob)


class OptimizationService:
    """Host-side queue + deadline-based flush around ShapeBucketScheduler.

    Thread-safe: TCP mode serves concurrent clients against one scheduler
    (the Java server's single-client-at-a-time restriction is lifted — jobs
    from different connections share buckets). With ``workers > 0`` the
    scheduler runs bucket flushes on its priority worker pool and ops are
    lock-free at this layer; with ``workers == 0`` a single op lock
    serializes everything and flushes run inline (the blocking behavior).
    A service built without a scheduler makes one on ``device`` (``None``:
    the card).
    """

    def __init__(self, scheduler: ShapeBucketScheduler | None = None,
                 max_batch: int = 32, flush_ms: float = 50.0,
                 workers: int = 0, max_pending: int = 0,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 8,
                 device: str | None = None) -> None:
        self.scheduler = scheduler or ShapeBucketScheduler(
            device=device, workers=workers, max_pending=max_pending,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every)
        self.max_batch = max_batch
        self.flush_ms = flush_ms
        self._lock = threading.Lock()

    def _oplock(self):
        """The global op lock in blocking mode; a no-op with a worker pool
        (the scheduler is internally thread-safe and ops return quickly)."""
        if self.scheduler.workers:
            return contextlib.nullcontext()
        return self._lock

    # -- protocol ----------------------------------------------------------

    def handle(self, msg: dict[str, Any]) -> dict[str, Any]:
        """Execute one protocol op; always returns a JSON-able reply."""
        try:
            # poll is a dict lookup + attribute reads (GIL-atomic): answer
            # without any lock so status/progress stay responsive while a
            # bucket dispatch (compile + run) is in flight elsewhere.
            if msg.get("op") == "poll":
                resp = self.scheduler.poll(msg["id"])
                return {"id": msg["id"], "status": resp.status,
                        **resp.progress_dict()}
            if msg.get("op") == "result":
                # fetch-once: the record is evicted so a long-lived server's
                # job table stays bounded; a second result/poll for the id
                # yields the structured unknown-id error. In pool mode this
                # waits on the job's completion event WITHOUT any service
                # lock, so other clients keep being served meanwhile; in
                # blocking mode the lock serializes the inline flush.
                with self._oplock():
                    resp = self.scheduler.result(msg["id"], evict=True)
                return resp.to_dict()
            with self._oplock():
                return self._dispatch(msg)
        except UnknownJob:
            return {"error": "unknown-id", "id": msg.get("id")}
        except SchedulerOverloaded as e:
            return {"error": "overloaded",
                    "retry_after_ms": e.retry_after_ms}
        except Exception as e:  # noqa: BLE001 — protocol errors go to the client
            return {"error": f"{type(e).__name__}: {e}"}

    def _dispatch(self, msg: dict[str, Any]) -> dict[str, Any]:
        op = msg.get("op")
        sched = self.scheduler
        if op == "submit":
            req = OptRequest.from_dict(msg["request"])
            job_id = sched.submit(req, msg.get("id"),
                                  priority=int(msg.get("priority", 0)))
            resp = {"id": job_id, "status": "queued"}
            key = req.shape_class()
            if sched.pending_count(key) >= self.max_batch:
                sched.flush_bucket(key)
                resp["status"] = sched.poll(job_id).status
            return resp
        if op == "cancel":
            return sched.cancel(msg["id"])
        if op == "status":
            return {"buckets": sched.bucket_status(),
                    "queue_depth": sched.queue_depth()}
        if op == "flush":
            return {"flushed": sched.flush()}
        if op == "stats":
            return dict(sched.stats(), max_batch=self.max_batch,
                        flush_ms=self.flush_ms)
        if op == "quit":
            if sched.workers:
                sched.drain()       # finish in-flight work before goodbye
            else:
                sched.flush()
            return {"bye": True}
        raise ValueError(f"unknown op {op!r}")

    # -- deadline flush ----------------------------------------------------

    def tick(self, now: float | None = None) -> int:
        """Dispatch buckets whose oldest job aged past the deadline."""
        now = time.monotonic() if now is None else now
        n = 0
        with self._oplock():
            for key, _, oldest in self.scheduler.pending_buckets():
                if (now - oldest) * 1e3 >= self.flush_ms:
                    n += len(self.scheduler.flush_bucket(key))
        return n

    def next_deadline(self) -> float | None:
        """Monotonic time of the earliest pending flush, or None if idle."""
        buckets = self.scheduler.pending_buckets()
        if not buckets:
            return None
        return min(oldest for _, _, oldest in buckets) + self.flush_ms / 1e3


def _handle_line(service: OptimizationService, line: str) -> tuple[dict, bool]:
    """(reply, is_quit) for one JSONL request line."""
    try:
        msg = json.loads(line)
    except json.JSONDecodeError as e:
        return {"error": f"bad json: {e}"}, False
    if not isinstance(msg, dict):          # e.g. a bare `42` — valid JSON,
        return {"error": "request must be a JSON object"}, False  # not an op
    return service.handle(msg), msg.get("op") == "quit"


def serve_stdin(service: OptimizationService) -> None:
    """stdin-JSONL loop: select() on the raw fd with the flush deadline as
    timeout, so queued buckets dispatch even while the client is silent.
    Reads unbuffered (os.read + explicit line buffer) — buffered readline
    would swallow ops that arrive several-per-write and leave them pending
    while select() sees a quiet fd."""
    out, fd = sys.stdout, sys.stdin.fileno()
    buf = b""
    while True:
        while b"\n" in buf:               # drain buffered ops before select
            raw, buf = buf.split(b"\n", 1)
            line = raw.decode("utf-8", "replace").strip()
            if not line:
                continue
            reply, quit_ = _handle_line(service, line)
            print(json.dumps(reply), file=out, flush=True)
            if quit_:
                return
        deadline = service.next_deadline()
        timeout = None if deadline is None else max(0.0, deadline - time.monotonic())
        ready, _, _ = select.select([fd], [], [], timeout)
        if not ready:
            service.tick()
            continue
        chunk = os.read(fd, 1 << 16)
        if not chunk:                     # EOF: run what's left, then exit
            service.handle({"op": "flush"})
            if service.scheduler.workers:
                service.scheduler.drain()
            return
        buf += chunk


class _LineHandler(socketserver.StreamRequestHandler):
    def handle(self) -> None:  # one JSONL session per connection
        service: OptimizationService = self.server.service  # type: ignore[attr-defined]
        for raw in self.rfile:
            line = raw.decode("utf-8", "replace").strip()
            if not line:
                continue
            reply, quit_ = _handle_line(service, line)
            self.wfile.write((json.dumps(reply) + "\n").encode())
            self.wfile.flush()
            if quit_:
                return


def serve_tcp(service: OptimizationService, host: str, port: int) -> None:
    """TCP-JSONL server: threaded clients + a daemon ticking the deadline."""

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    def ticker() -> None:
        while True:
            time.sleep(max(service.flush_ms / 2e3, 1e-3))
            service.tick()

    threading.Thread(target=ticker, daemon=True).start()
    with Server((host, port), _LineHandler) as srv:
        srv.service = service  # type: ignore[attr-defined]
        print(f"[opt_serve] listening on {host}:{srv.server_address[1]} "
              f"device {service.scheduler.device}", file=sys.stderr, flush=True)
        srv.serve_forever()


def main() -> None:
    """CLI entry point: parse flags, resume interrupted runs when asked, then
    serve JSONL over stdin or TCP."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-batch", type=int, default=32,
                    help="flush a bucket as soon as it holds this many jobs")
    ap.add_argument("--flush-ms", type=float, default=50.0,
                    help="deadline: max queueing delay before a bucket runs")
    ap.add_argument("--tcp", type=int, default=None, metavar="PORT",
                    help="serve TCP-JSONL on this port instead of stdin")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--workers", type=int, default=2,
                    help="bucket-flush worker threads; 0 = legacy blocking "
                         "mode (flushes inline under one global op lock)")
    ap.add_argument("--max-pending", type=int, default=0,
                    help="backpressure: load-shed submissions once this many "
                         "jobs are queued (0 = unbounded)")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="snapshot running buckets' engine state under DIR")
    ap.add_argument("--checkpoint-every", type=int, default=8,
                    help="sync rounds between bucket state snapshots")
    ap.add_argument("--resume-dir", default=None, metavar="DIR",
                    help="restore interrupted runs from DIR at startup "
                         "(also becomes the checkpoint dir unless one is set)")
    ap.add_argument("--device", default=None,
                    help="device the buckets run on (default: the GPU; cpu "
                         "runs the plain PyTorch path)")
    args = ap.parse_args()

    ckpt = args.checkpoint_dir or args.resume_dir
    service = OptimizationService(
        max_batch=args.max_batch, flush_ms=args.flush_ms,
        workers=args.workers, max_pending=args.max_pending,
        checkpoint_dir=ckpt, checkpoint_every=args.checkpoint_every,
        device=args.device)
    if args.resume_dir is not None:
        summary = service.scheduler.resume(args.resume_dir)
        print(f"[opt_serve] resume: {json.dumps(summary)}",
              file=sys.stderr, flush=True)
    if args.tcp is not None:
        serve_tcp(service, args.host, args.tcp)
    else:
        print(f"[opt_serve] serving stdin, device {service.scheduler.device}",
              file=sys.stderr, flush=True)
        serve_stdin(service)


if __name__ == "__main__":
    main()
