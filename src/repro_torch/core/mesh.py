"""Island-engine mesh — the paper's distributed message-passing layer as SPMD
over ``torch.distributed``: one process (rank) per shard (counterpart of
``repro.core.mesh``).

popt4jlib scales past one machine by running island populations in separate
processes that exchange migrants over sockets. The JAX package lays the
islands over a 1-D device mesh and runs its round scan under ``shard_map``;
PyTorch's own idiom for more than one device is one process per shard. So a
:class:`MeshConfig` here means ``devices`` ranks, each running the unsharded
engine on its own block of ``n_islands / devices`` islands, and the places
where the JAX body names its mesh axis become collectives on the process
group:

  ``lax.ppermute`` of :func:`ring_perm`   -> :func:`ring_shift` (send/recv)
  ``lax.all_gather(tiled=True)``          -> :func:`all_gather_rows`
  ``lax.pmin`` / ``psum`` / ``pmax``      -> :func:`all_reduce`
  ``lax.dynamic_slice`` at axis_index     -> :func:`local_rows`

The reference's ``island_specs`` (the ``shard_map`` in/out specs) has no
counterpart: there are no specs to give, because every rank derives the
global per-island tables itself and takes its rows with :func:`local_rows`.

Two routes:

  * ``nccl`` — one rank per GPU (rank r on ``cuda:r``); tensors move
    device to device;
  * ``gloo`` — ranks on the CPU, or every rank on one card. gloo's CUDA
    support differs by operation (send/recv in particular), so the
    collectives here stage the exchanged CUDA tensors through host memory
    explicitly on this route.

A caller may name the route (``MeshConfig.backend``); otherwise
:func:`default_backend` picks it by one rule, ``nccl`` when every rank can
have a GPU of its own and ``gloo`` else, and the built :class:`Mesh`
names the route it took.

Every collective takes a :class:`Group`, or ``None`` for the unsharded
engine, for which it is the identity; so is a 1-rank mesh run outside a
process group. Inside a joined group of one rank the all-gather and the
all-reduce are issued (so a 1-rank nccl group runs NCCL's collectives);
the ring's hop to oneself is the identity, since ``torch.distributed``
refuses a send to one's own rank.

:func:`spawn` starts the ranks for a single-process caller (``spawn`` start
method, ``file://`` rendezvous in a fresh temporary directory, a deadline;
the first rank to fail ends them all and its error is raised). A caller
already inside an initialised group whose world size is ``devices`` (for
example under ``torchrun``) runs SPMD in place instead.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

Tensor = torch.Tensor

ISLAND_AXIS = "islands"
BACKENDS = ("nccl", "gloo")
# The gloo route's host ceiling: processes beyond this on one host only
# time-slice its cores (and, on one card, its one GPU).
GLOO_MAX_RANKS = 16
# Seconds a spawned run (and every collective in it) may take when the
# caller gives no timeout; read at each spawn.
SPAWN_TIMEOUT = 900.0


def default_backend(device: str | torch.device | None, devices: int = 1) -> str:
    """The route of ``devices`` ranks for an engine on ``device`` (``None``
    means CUDA, as every entry point of the port reads it): ``nccl`` when
    each rank can have a GPU of its own (one rank on the engine's GPU, or
    no more ranks than visible GPUs), ``gloo`` otherwise (the CPU, or every
    rank on one card)."""
    if torch.device(device or "cuda").type != "cuda":
        return "gloo"
    return "nccl" if devices <= max(1, host_device_count("nccl")) else "gloo"


def host_device_count(backend: str = "nccl") -> int:
    """The ceiling for ``MeshConfig.devices`` on this host: the visible GPUs
    for ``nccl`` (one rank each), :data:`GLOO_MAX_RANKS` for ``gloo``."""
    if backend == "nccl":
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    return GLOO_MAX_RANKS


@dataclasses.dataclass(frozen=True)
class Group:
    """One rank's view of a mesh it runs in: its rank, the world size, the
    route, and whether the process is in an initialised process group of
    ``size`` ranks (``joined``). A 1-rank mesh outside one is the
    degenerate mesh, whose collectives are identities."""

    rank: int
    size: int
    backend: str
    joined: bool = False

    @property
    def staged(self) -> bool:
        """Whether CUDA tensors cross through host memory (the gloo route)."""
        return self.backend == "gloo"


def rank_device(device: str | torch.device, group: Group) -> torch.device:
    """The device a rank runs on: its own GPU (``cuda:rank``) on the nccl
    route, the caller's ``device`` on gloo (the CPU, or every rank on one
    card)."""
    if group.backend == "nccl":
        return torch.device("cuda", group.rank)
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A placed mesh (what :meth:`MeshConfig.build` returns): ``devices``
    ranks on the ``backend`` route."""

    devices: int
    axis: str
    backend: str

    def local_group(self) -> Group | None:
        """This process's :class:`Group` when it can run the mesh in place —
        inside an initialised group of world size ``devices``, or alone for
        a 1-rank mesh — else ``None`` (the caller spawns). Raises inside a
        group of another size: ranks cannot be re-spawned from a rank."""
        if dist.is_available() and dist.is_initialized():
            world = dist.get_world_size()
            if world == self.devices:
                return Group(dist.get_rank(), world, self.backend, joined=True)
            if self.devices > 1:
                raise ValueError(
                    f"a mesh of {self.devices} devices cannot run inside a "
                    f"process group of world size {world}; launch "
                    f"{self.devices} ranks")
        if self.devices == 1:
            return Group(0, 1, self.backend)
        return None


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Layout of the island axis over ranks: how many ranks (``devices``)
    the leading island axis of every engine-state leaf is split across, the
    axis name (kept for parity with the reference), and the route
    (``backend``: ``"nccl"`` | ``"gloo"``; ``None`` picks by
    :func:`default_backend`). ``devices=1`` is a valid degenerate mesh, bit-identical to the
    unsharded engine."""

    devices: int = 1
    axis: str = ISLAND_AXIS
    backend: str | None = None

    def build(self, device: str | torch.device | None = None) -> Mesh:
        """Check that the ranks can be placed for an engine on ``device``
        and return the :class:`Mesh`. Raises ``ValueError`` for
        ``devices < 1``, an unknown backend, ``nccl`` off CUDA, more
        ``nccl`` ranks than visible GPUs, or more ``gloo`` ranks than
        :data:`GLOO_MAX_RANKS`."""
        if self.devices < 1:
            raise ValueError(f"devices must be >= 1, got {self.devices}")
        backend = self.backend or default_backend(device, self.devices)
        if backend not in BACKENDS:
            raise ValueError(f"unknown mesh backend {backend!r}; expected one of {BACKENDS}")
        if backend == "nccl" and torch.device(device or "cuda").type != "cuda":
            raise ValueError("the nccl route runs on CUDA devices only; use gloo on the CPU")
        avail = host_device_count(backend)
        if self.devices > avail:
            where = ("GPUs (one nccl rank each)" if backend == "nccl"
                     else f"gloo ranks (the host ceiling, GLOO_MAX_RANKS)")
            raise ValueError(
                f"MeshConfig wants {self.devices} devices but only {avail} "
                f"{where} are visible")
        return Mesh(self.devices, self.axis, backend)

    def local_islands(self, n_islands: int) -> int:
        """Islands each rank owns; validates that the axis divides evenly."""
        if n_islands < 1 or n_islands % self.devices:
            raise ValueError(
                f"n_islands={n_islands} must be a positive multiple of "
                f"devices={self.devices} (equal-size shards)")
        return n_islands // self.devices


def ring_perm(n_shards: int) -> list[tuple[int, int]]:
    """The migration ring as (source, destination) pairs: shard d sends to
    d+1 (mod n), so island ``i``'s migrants reach island ``i+1`` when the
    boundary island crosses shards."""
    return [(d, (d + 1) % n_shards) for d in range(n_shards)]


# -- collectives ---------------------------------------------------------------

def _out(x: Tensor, group: Group) -> Tensor:
    """``x`` as the collective sends it: contiguous, through host memory on
    the gloo route, bool as uint8."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    if group.staged and x.is_cuda:
        x = x.cpu()
    return x.contiguous()


def _back(y: Tensor, like: Tensor) -> Tensor:
    return y.to(device=like.device, dtype=like.dtype)


def local_rows(x: Tensor, rank: int, n_local: int, dim: int = 0) -> Tensor:
    """Rank ``rank``'s ``n_local``-row block of a per-island table along
    ``dim`` (a view) — how a rank takes its islands' keys, schedule rows and
    policy indices out of the global tables every rank derives."""
    return x.narrow(dim, rank * n_local, n_local)


def _issued(group: Group | None) -> bool:
    """Whether a collective over ``group`` goes to the process group (else
    it is the identity: unsharded, or a 1-rank mesh outside a group)."""
    return group is not None and group.joined


def ring_shift(x: Tensor, group: Group | None) -> Tensor:
    """Rank r's ``x`` arrives at rank r+1 (mod size): returns what rank r-1
    sent. One send and one receive per rank, issued together; the identity
    on one rank."""
    if not _issued(group) or group.size == 1:
        return x
    send = _out(x, group)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, (group.rank + 1) % group.size),
           dist.P2POp(dist.irecv, recv, (group.rank - 1) % group.size)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _back(recv, x)


def all_gather_rows(x: Tensor, group: Group | None, dim: int = 0) -> Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (the
    reference's ``all_gather(tiled=True)``, along any dimension)."""
    if not _issued(group):
        return x
    send = _out(x, group)
    parts = [torch.empty_like(send) for _ in range(group.size)]
    dist.all_gather(parts, send)
    return _back(torch.cat(parts, dim), x)


_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def all_reduce(x: Tensor, op: str, group: Group | None) -> Tensor:
    """Elementwise ``op`` (``sum`` | ``min`` | ``max``) of every rank's
    ``x``; ``x`` itself is left untouched."""
    if op not in _OPS:
        raise ValueError(f"unknown reduce op {op!r}; expected one of {sorted(_OPS)}")
    if not _issued(group):
        return x
    buf = _out(x, group).clone()
    dist.all_reduce(buf, op=_OPS[op])
    return _back(buf, x)


def all_reduce_min(x: Tensor, group: Group | None) -> Tensor:
    """Elementwise minimum over ranks (the reference's ``pmin``): exact."""
    return all_reduce(x, "min", group)


# -- launcher ------------------------------------------------------------------

def _rank_main(rank: int, size: int, backend: str, init: str, timeout: float,
               call: bytes, results) -> None:
    """A spawned rank: join the group, run the pickled ``(fn, args)``, post
    ``(rank, ok, payload)`` — rank 0's pickled result, or the error and its
    traceback. Both directions travel as plain pickles (tensors by value),
    never as shared-memory handles a rank that has exited could not
    serve."""
    try:
        fn, args = pickle.loads(call)
        if backend == "nccl":
            torch.cuda.set_device(rank)
        else:
            # The ranks share the host's cores.
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
        dist.init_process_group(backend, init_method=init, world_size=size, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout))
        out = fn(*args)
        results.put((rank, True, pickle.dumps(out) if rank == 0 else None))
    except Exception as e:  # noqa: BLE001 — reported to the parent, which raises it
        tb = traceback.format_exc()
        try:
            pickle.dumps(e)
        except Exception:  # noqa: BLE001 — an error that does not pickle
            e = RuntimeError(f"{type(e).__name__}: {e}")
        results.put((rank, False, (e, tb)))
        return
    dist.destroy_process_group()


def spawn(devices: int, fn: Callable, *args: Any, backend: str = "gloo",
          timeout: float | None = None) -> Any:
    """Run ``fn(*args)`` on ``devices`` fresh ranks under an initialised
    process group and return rank 0's result.

    ``fn`` and ``args`` are pickled to the ranks, so ``fn`` must be
    importable (a module-level function) and the result picklable. The
    ranks meet over a ``file://`` store in a new temporary directory (no
    ports), and ``timeout`` bounds both the group's collectives and the
    whole run. When a rank raises, every rank is killed and that rank's
    exception is raised here, with its traceback as a note; a rank that
    dies without a word, or a run past ``timeout``, raises
    ``RuntimeError`` / ``TimeoutError`` the same way. ``timeout`` defaults
    to :data:`SPAWN_TIMEOUT`."""
    timeout = SPAWN_TIMEOUT if timeout is None else timeout
    if devices < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="popt-mesh-")
    init = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    call = pickle.dumps((fn, args))
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, devices, backend, init, timeout, call, results))
             for r in range(devices)]
    deadline = time.monotonic() + timeout
    done: dict[int, bytes] = {}
    try:
        for p in procs:
            p.start()
        while len(done) < devices:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"mesh.spawn: {devices} ranks did not finish in {timeout} s")
            try:
                msg = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                msg = _orphan_message(procs, done, results)
                if msg is None:
                    continue
            rank, ok, payload = msg
            if not ok:
                exc, tb = payload
                exc.add_note(f"raised on rank {rank} of {devices} ({backend}):\n{tb}")
                raise exc
            done[rank] = payload
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return pickle.loads(done[0])


def _orphan_message(procs, done: dict, results):
    """For a rank that exited without a result: its last message if it
    arrives within 2 s, else ``RuntimeError``; ``None`` while every
    unfinished rank still runs."""
    for r, p in enumerate(procs):
        if r in done or p.exitcode is None:
            continue
        try:
            return results.get(timeout=2.0)
        except queue.Empty:
            raise RuntimeError(f"mesh.spawn: rank {r} exited with code "
                               f"{p.exitcode} without a result") from None
    return None
