"""Roofline terms on the card: the H100's rates, the ``Roofline`` record,
and the count of a traced step that takes the place of HLO.

Counterpart of ``repro.parallel.roofline``:

  compute term    = FLOPs / PEAK_FLOPS_BF16           (per device)
  memory term     = HBM bytes / HBM_BW                (per device)
  collective term = collective bytes / LINK_BW        (per device)

The reference reads a compiled XLA program: ``hlo_costs`` walks the
post-SPMD HLO (dots' FLOPs, every instruction's operand and output bytes,
loops by trip count), ``collective_bytes`` sums the result bytes of its
collectives and ``memory_analysis()`` gives the peak. PyTorch compiles no
program, so :func:`count` runs the step eagerly on ``meta`` tensors (plain
or DTensors over a mesh, the fake process group standing in for the
ranks) under a ``TorchDispatchMode`` that sees every operator one device
runs:

  FLOPs       ``torch.utils.flop_counter``'s formulas for the products (the
              same 2 M N K a dot as ``hlo_costs``), plus the model kernels'
              own counts (``kernels.meta``: flash 4 hd and its gradient 10
              hd a kept pair a row, ssd the chunked form, its gradient
              8 BH S N P). Only operators on plain local tensors count:
              DTensor runs each operator on its shards, which come back
              through the mode, and its sharding propagation runs the
              global operator under a ``FakeTensorMode``, which does not.
  HBM bytes   every operator reads its tensor operands and writes its
              outputs once (views and allocations move nothing): eager's
              analogue of ``hlo_costs``' per-instruction rule. Eager runs
              no fusion, so this is an upper bound of a fused step's.
  collectives the output bytes of each collective the mesh runs (the
              functional collectives of DTensor's redistributions, and the
              process group's own), by kind: :class:`CollectiveStats`.
  peak bytes  the high-water mark of the bytes of live tensor storages,
              the arguments included: the counterpart of
              ``memory_analysis()``'s argument + output + temp - alias.

A Python loop runs each layer, so nothing needs a trip count. The time
terms take the card's bf16 tensor-core peak, its HBM rate and
:data:`LINK_BW`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM (80 GB HBM3) at its 700 W power limit: HBM bandwidth, and
# the peak rates of the CUDA cores in float32 and the tensor cores in
# bfloat16 (dense), bytes and operations a second.
HBM_BW = 3.35e12
PEAK_FLOPS_F32 = 67e12
PEAK_FLOPS_BF16 = 989e12
# The collective rate a device, bytes a second, in place of the TPU's ICI
# link: 400 Gb/s, one InfiniBand NDR port (ConnectX-7) a GPU, as an HGX/DGX
# H100 node of eight GPUs has (NVIDIA DGX H100 datasheet). A 16 x 16 mesh
# spans 32 such nodes: each ``model`` group of 16 ranks spans two nodes and
# each ``data`` group takes one GPU of 16 nodes, so a ring over either axis
# crosses the network, and runs at its slowest hop, the GPU's own port.
# NVLink 4 (450 GB/s a direction a GPU) joins only the eight GPUs of a node.
# A one-card machine cannot measure either link.
LINK_BW = 50e9
# The shortest time of a kernel launched back to back on that card, seconds
# (an empty kernel, timed by tools/eval_row_timings.py).
LAUNCH_FLOOR_S = 2.21e-6


@dataclasses.dataclass
class Roofline:
    flops: float               # per device
    hbm_bytes: float           # per device
    coll_bytes: float          # per device
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    peak_bytes: float          # per-device high-water mark (a block's shared memory
                               # in ``kernels.autotune``'s records)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Card:
    """The card a geometry is chosen for: its name, compute capability and
    streaming multiprocessors. :func:`card_of` reads them from a device."""

    name: str
    capability: tuple[int, int]
    sms: int


@functools.cache
def card_of(device: torch.device) -> Card:
    """The :class:`Card` of CUDA ``device``, from its device properties."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"no card behind {device}: the tuner reads a CUDA device")
    props = torch.cuda.get_device_properties(device)
    return Card(props.name, (props.major, props.minor), props.multi_processor_count)


def roofline(flops: float, hbm_bytes: float, peak_bytes: float = 0.0, *,
             peak_flops: float = PEAK_FLOPS_F32) -> Roofline:
    """The record of a kernel that does ``flops`` at ``peak_flops`` and
    moves ``hbm_bytes`` at :data:`HBM_BW`; no collectives."""
    t_c = flops / peak_flops
    t_m = hbm_bytes / HBM_BW
    return Roofline(flops=flops, hbm_bytes=hbm_bytes, coll_bytes=0.0, t_compute=t_c,
                    t_memory=t_m, t_collective=0.0,
                    bottleneck="compute" if t_c >= t_m else "memory",
                    peak_bytes=float(peak_bytes))


# ---------------------------------------------------------------------------
# the count of a traced step
# ---------------------------------------------------------------------------

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# Collective operators (``namespace.name``) by kind: the functional
# collectives DTensor calls, and the process group's own operators.
_COLLECTIVE_OPS = {
    **{f"_c10d_functional.{n}": "all-gather" for n in (
        "all_gather_into_tensor", "all_gather_into_tensor_out",
        "all_gather_into_tensor_coalesced")},
    **{f"_c10d_functional.{n}": "all-reduce" for n in (
        "all_reduce", "all_reduce_", "all_reduce_coalesced", "all_reduce_coalesced_")},
    **{f"_c10d_functional.{n}": "reduce-scatter" for n in (
        "reduce_scatter_tensor", "reduce_scatter_tensor_coalesced")},
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.broadcast": "collective-permute",
    "_c10d_functional.broadcast_": "collective-permute",
    "c10d.allreduce_": "all-reduce", "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.allgather_": "all-gather", "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter", "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all", "c10d.alltoall_base_": "all-to-all",
    "c10d.broadcast_": "collective-permute", "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
}
# Operators that move no bytes: allocations, and the functional
# collectives' bookkeeping.
_NO_TRAFFIC = frozenset((
    "aten.empty", "aten.empty_like", "aten.empty_strided", "aten.new_empty",
    "aten.new_empty_strided", "aten.lift_fresh", "_c10d_functional.wait_tensor",
    "_c10d_functional._wrap_tensor_autograd"))


@dataclasses.dataclass
class CollectiveStats:
    total_bytes: int
    by_kind: dict[str, int]
    n_ops: int


def _op_name(func) -> str:
    return f"{func.namespace}.{func._opname}"


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in torch.utils._pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _plain(t: torch.Tensor) -> bool:
    return type(t) in (torch.Tensor, torch.nn.Parameter)


class Count(TorchDispatchMode):
    """A step's work on one device, counted while the mode is active (see
    the module docstring): ``flops``, ``hbm_bytes``, collectives by kind
    (:meth:`collectives`), ``peak_bytes``, and ``kernels``, the model
    kernels' calls and work by name (their meta routes)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.by_kind = {k: 0 for k in COLLECTIVES}
        self.n_coll = 0
        self.kernels: dict[str, dict[str, float]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: set[int] = set()

    # -- live storages --------------------------------------------------------

    def hold(self, tree) -> None:
        """Count the storages of ``tree``'s tensors (a DTensor's local
        shard) as live until they are freed."""
        from torch.distributed.tensor import DTensor
        for t in _tensors(tree):
            self._track(t.to_local() if isinstance(t, DTensor) else t)

    def _track(self, t: torch.Tensor) -> None:
        if not _plain(t):
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        self._live.add(key)
        n = st.nbytes()
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        if key in self._live:
            self._live.discard(key)
            self.live_bytes -= n

    # -- the counts -----------------------------------------------------------

    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        """A model kernel's meta route (``kernels.meta.tally``)."""
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self.hbm_bytes += nbytes

    def collectives(self) -> CollectiveStats:
        return CollectiveStats(total_bytes=sum(self.by_kind.values()),
                               by_kind=dict(self.by_kind), n_ops=self.n_coll)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # DTensor runs the operator on its local shards, which come
            # back through this mode
            return NotImplemented
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not outs or not all(_plain(t) for t in ins + outs):
            # a query of metadata, or DTensor's sharding propagation on
            # fake tensors of the global shapes
            return out
        name = _op_name(func)
        kind = _COLLECTIVE_OPS.get(name)
        if kind is not None:
            b = sum(_nbytes(t) for t in outs)
            self.by_kind[kind] = self.by_kind.get(kind, 0) + b
            self.n_coll += 1
        flop_fn = _flop_registry().get(func._overloadpacket)
        if flop_fn is not None:
            self.flops += float(flop_fn(*args, **kwargs, out_val=out))
        if not func.is_view and name not in _NO_TRAFFIC:
            self.hbm_bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        return out

    def __enter__(self):
        # late: the kernels import ``kernels.autotune``, which imports this module
        from repro_torch.kernels import meta
        meta.TALLIES.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import meta
        meta.TALLIES.remove(self)
        return super().__exit__(*exc)

    def roofline(self) -> Roofline:
        """The record of the work counted so far."""
        coll = float(sum(self.by_kind.values()))
        tc = self.flops / PEAK_FLOPS_BF16
        tm = self.hbm_bytes / HBM_BW
        tx = coll / LINK_BW
        terms = {"compute": tc, "memory": tm, "collective": tx}
        return Roofline(flops=self.flops, hbm_bytes=self.hbm_bytes, coll_bytes=coll,
                        t_compute=tc, t_memory=tm, t_collective=tx,
                        bottleneck=max(terms, key=terms.get),
                        peak_bytes=float(self.peak_bytes))


@functools.cache
def _flop_registry() -> dict:
    from torch.utils.flop_counter import flop_registry
    return flop_registry


@contextlib.contextmanager
def count(*held):
    """``with count(params, state) as c:`` counts what runs in the body on
    one device (:class:`Count`); the storages of ``held`` are live from
    the start."""
    c = Count()
    c.hold(held)
    with c:
        yield c


def trace(fn, *args, **kwargs):
    """(``fn(*args, **kwargs)``, its :class:`Count`), the arguments' storages
    live from the start. Give ``fn`` meta tensors: nothing is computed."""
    with count(args, kwargs) as c:
        out = fn(*args, **kwargs)
    return out, c


def analyze(fn, *args, **kwargs) -> Roofline:
    """The :class:`Roofline` of one call of ``fn`` on these arguments, per
    device (:func:`trace`)."""
    return trace(fn, *args, **kwargs)[1].roofline()
