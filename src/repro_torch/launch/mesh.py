"""Device meshes for the model stack (counterpart of ``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
an initialised process group, one rank a device, with named dimensions:

  single pod: (16, 16) = 256 ranks, ``("data", "model")``;
  multi-pod:  (2, 16, 16) = 512 ranks, ``("pod", "data", "model")``: the
              ``pod`` dimension carries data parallelism across pods.

:func:`make_host_mesh` builds a small ``("data", "model")`` mesh over the
joined group (tests, one card). Its device is CUDA unless the caller asks
for the CPU, as with every entry point of the port. With every rank on one
card the group's route is gloo (NCCL refuses two ranks on one GPU); gloo
runs few collectives on CUDA tensors, so each mesh dimension then gets a
group of the ``gloo_staged`` backend (:class:`StagedGloo`), which runs gloo
on host copies of the tensors, as ``core.mesh`` stages its own collectives.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch import resolve_device


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh over an initialised world of 256 (or, with
    ``multi_pod``, 512) ranks; raises ``RuntimeError`` naming the world size
    it needs otherwise."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def data_axes(mesh) -> tuple[str, ...]:
    """The axes that carry batch parallelism."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A ``(data, model)`` mesh over the first ``data * model`` ranks of the
    joined group (the reference's mesh over the first devices); a rank past
    them holds no shard of it."""
    return _mesh((data, model), ("data", "model"), device)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device=None):
    """A mesh of any shape and axis names, e.g. ``(2, 1, 1)`` over
    ``("pod", "data", "model")``."""
    return _mesh(tuple(shape), tuple(axes), device)


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], device):
    from torch.distributed.device_mesh import DeviceMesh
    dev = resolve_device(device)
    n = math.prod(shape)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"a {shape} mesh needs an initialised process group of "
                           f"at least {n} ranks; none is initialised")
    world = dist.get_world_size()
    if world < n or (n >= 256 and world != n):
        raise RuntimeError(f"a {shape} mesh needs a world of {n} ranks; this one has {world}")
    if dev.type == "cuda":
        # Every rank on the card of its group's route: nccl's own (cuda:rank),
        # gloo's one card (cuda:0). Set before the mesh, which otherwise
        # picks rank % device_count.
        torch.cuda.set_device(dev.index if dev.index is not None else
                              (dist.get_rank() if _cuda_backend() == "nccl" else 0))
    ranks = torch.arange(n).reshape(shape)
    if dev.type == "cuda" and _cuda_backend() == "gloo":
        return DeviceMesh.from_group(_staged_groups(ranks), "cuda", mesh=ranks,
                                     mesh_dim_names=axes)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=axes)


def _cuda_backend() -> str:
    """The default group's backend for CUDA tensors."""
    return str(dist.get_backend()).split(",")[-1].split(":")[-1]


def _staged_groups(ranks: torch.Tensor) -> list:
    """One ``gloo_staged`` group per mesh dimension holding this rank (every
    rank creates every group, in one order, as ``new_group`` requires)."""
    register_staged()
    me = dist.get_rank()
    mine = []
    for d in range(ranks.dim()):
        rows = ranks.movedim(d, -1).reshape(-1, ranks.shape[d])
        own = None
        for row in rows.tolist():
            g = dist.new_group(row, backend=STAGED)
            if me in row:
                own = g
        mine.append(own)
    return mine


# -- gloo on host copies ---------------------------------------------------------

STAGED = "gloo_staged"


def _done(result):
    from torch._C._distributed_c10d import _create_work_from_future
    fut = torch.futures.Future()
    fut.set_result(result)
    return _create_work_from_future(fut)


class StagedGloo(dist.ProcessGroup):
    """A process group that runs each collective as gloo on host copies of
    its tensors and copies the result back: what DTensor issues (all-reduce,
    all-gather into a tensor, reduce-scatter, all-to-all, broadcast) on
    CUDA tensors of ranks that share one card. The host copies of CUDA
    tensors are page-locked (PyTorch's host allocator keeps the blocks, so
    a step's buffers are reused). Each call completes before it returns."""

    def __init__(self, store, rank: int, size: int, timeout):
        super().__init__(rank, size)
        self._gloo = dist.ProcessGroupGloo(store, rank, size, timeout)
        self._name = ""

    def getBackendName(self) -> str:
        return STAGED

    @property
    def group_name(self) -> str:
        return self._name

    def _set_group_name(self, name: str) -> None:
        self._name = name

    @staticmethod
    def _buffer(shape, dtype, pinned: bool) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=pinned)

    @classmethod
    def _host(cls, t: torch.Tensor) -> torch.Tensor:
        h = cls._buffer(t.shape, t.dtype, t.is_cuda)
        h.copy_(t.detach())
        return h

    def _gathered(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` flattened, in rank order, in one host buffer."""
        h = self._host(t)
        out = self._buffer((self.size() * h.numel(),), h.dtype, t.is_cuda)
        self._gloo._allgather_base(out, h.reshape(-1)).wait()
        return out

    def _allreduce_host(self, h: torch.Tensor, op) -> None:
        o = dist.AllreduceOptions()
        o.reduceOp = op
        self._gloo.allreduce([h], o).wait()

    def allreduce(self, tensors, opts=None):
        op = opts.reduceOp if opts is not None else dist.ReduceOp.SUM
        for t in tensors:
            h = self._host(t)
            self._allreduce_host(h, op)
            t.copy_(h)
        return _done(tensors)

    def allreduce_coalesced(self, tensors, opts=None):
        return self.allreduce(tensors, opts)

    def broadcast(self, tensors, opts):
        hs = [self._host(t) for t in tensors]
        self._gloo.broadcast(hs, opts).wait()
        for t, h in zip(tensors, hs):
            t.copy_(h)
        return _done(tensors)

    def barrier(self, opts=None):
        self._gloo.barrier().wait()
        return _done(None)

    def allgather(self, outputs, inputs, opts=None):
        for outs, t in zip(outputs, inputs):
            for o, p in zip(outs, self._gathered(t).chunk(self.size())):
                o.copy_(p.reshape(o.shape))
        return _done(outputs)

    def all_gather_single(self, output, input, opts=None):
        output.copy_(self._gathered(input).reshape(output.shape))
        return _done([output])

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self.all_gather_single(o, i, opts)
        return _done(outputs)

    def reduce_scatter_single(self, output, input, opts=None):
        # an all-reduce of the whole input, of which each rank keeps its chunk
        h = self._host(input)
        self._allreduce_host(h, opts.reduceOp if opts is not None else dist.ReduceOp.SUM)
        output.copy_(h.reshape(self.size(), *output.shape)[self.rank()])
        return _done([output])

    def reduce_scatter(self, outputs, input_lists, opts=None):
        for o, ins in zip(outputs, input_lists):
            self.reduce_scatter_single(o, torch.stack(ins), opts)
        return _done(outputs)

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self.reduce_scatter_single(o, i, opts)
        return _done(outputs)

    def all_to_all_single(self, output, input, output_split_sizes, input_split_sizes,
                          opts=None):
        # equal splits: every rank's input gathered, each keeps its chunk of each
        if output_split_sizes or input_split_sizes:
            raise NotImplementedError("gloo_staged all_to_all takes equal splits only")
        n, r = self.size(), self.rank()
        parts = self._gathered(input).reshape(n, *input.shape)
        output.copy_(torch.cat([p.chunk(n)[r] for p in parts]).reshape(output.shape))
        return _done([output])

    # the C++ names of the tensor forms
    _allgather_base = all_gather_single
    _reduce_scatter_base = reduce_scatter_single
    alltoall_base = all_to_all_single


def _create_staged(store, rank, size, timeout):
    return StagedGloo(store, rank, size, timeout)


def register_staged() -> None:
    """Register the ``gloo_staged`` backend (once a process)."""
    if STAGED.upper() not in dist.Backend._plugins:
        dist.Backend.register_backend(STAGED, _create_staged, devices=["cuda", "cpu"])
