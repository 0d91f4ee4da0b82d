"""Activation/weight layout hooks (counterpart of ``repro.parallel.ctx``).

Model code stays mesh-agnostic; a caller installs layouts
(``parallel.sharding.Layout``) here by name, and the model's hook sites
redistribute a DTensor to the installed layout:

  ``layer_weights``          each layer's weight slice (a tree of layouts,
                             :func:`constrain_layer_weights`);
  ``attn_seq_q``, ``attn_seq_kv``   attention's expanded q and k/v;
  ``moe_eb``, ``moe_hidden``        the MoE dispatch buffers and expert
                             hidden states.

With no rules installed, or on a plain tensor, every hook returns its
argument itself, so the single-device path does not change.

:func:`like` makes the model's plain constants (positions, masks,
accumulators, the Adam step's scalars) replicated DTensors on an operand's
mesh when that operand is a DTensor: an op that mixes a plain tensor with
a DTensor raises.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any

import torch

_RULES: dict[str, Any] = {}


@contextlib.contextmanager
def sharding_rules(**rules):
    """Install ``rules`` (name -> layout or tree of layouts) for the body."""
    old = dict(_RULES)
    _RULES.update(rules)
    try:
        yield
    finally:
        _RULES.clear()
        _RULES.update(old)


def _is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def redistribute(x: Any, layout) -> Any:
    """``x`` in ``layout`` when both are given and ``x`` is a DTensor."""
    if layout is None or not _is_dtensor(x):
        return x
    return _placed(x, layout.mesh, layout.placements)


def _placed(x, mesh, placements):
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(mesh, placements)


def constrain_layer_weights(lp: Any) -> Any:
    """Each leaf of a layer's weight slice in its installed layout (the
    ``layer_weights`` rule, a tree like ``lp``)."""
    sh = _RULES.get("layer_weights")
    if sh is None:
        return lp

    def walk(x, s):
        if isinstance(x, dict):
            return {k: walk(v, s[k]) for k, v in x.items()}
        return redistribute(x, s)

    return walk(lp, sh)


def constrain(x: Any, key: str) -> Any:
    """``x`` in the layout installed under ``key``, if any and if it splits
    ``x`` evenly: DTensor refuses to view an unevenly split tensor (the MoE
    buffers' 16 token groups over the 32 ranks of the multi-pod data axes),
    where XLA pads the shards, so such a layout is left out."""
    layout = _RULES.get(key)
    if layout is None or not _is_dtensor(x) or not _even(x, layout):
        return x
    return redistribute(x, layout)


def _even(x: Any, layout) -> bool:
    """Whether ``layout`` splits each dim of ``x`` into equal parts."""
    parts = [1] * x.dim()
    for i, p in enumerate(layout.placements):
        if p.is_shard():
            parts[p.dim % x.dim()] *= layout.mesh.size(i)
    return all(n % k == 0 for n, k in zip(x.shape, parts))


def split(x: Any, dim: int) -> bool:
    """Whether ``x`` is a DTensor sharded on ``dim`` over a mesh dimension
    of more than one rank."""
    if not _is_dtensor(x):
        return False
    dim %= x.dim()
    return any(p.is_shard() and p.dim % x.dim() == dim and x.device_mesh.size(i) > 1
               for i, p in enumerate(x.placements))


def shards(x: Any, dim: int) -> int:
    """Into how many parts ``x`` is split on ``dim``: the product of the
    sizes of the mesh dimensions on which it is ``Shard(dim)``; 1 for a
    plain tensor."""
    if not _is_dtensor(x):
        return 1
    dim %= x.dim()
    return math.prod(x.device_mesh.size(i) for i, p in enumerate(x.placements)
                     if p.is_shard() and p.dim % x.dim() == dim)


def unsplit(x: Any, dim: int) -> Any:
    """``x`` whole on ``dim`` (replicated over the mesh dimensions that
    split it), its other placements kept; anything else as it is."""
    if shards(x, dim) == 1:
        return x
    from torch.distributed.tensor import Replicate
    dim %= x.dim()
    return _placed(x, x.device_mesh, [Replicate() if p.is_shard() and p.dim % x.dim() == dim
                                      else p for p in x.placements])


def replicated(x: Any) -> Any:
    """A DTensor replicated over its whole mesh (a scalar loss before its
    backward, a metric); anything else as it is."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return _placed(x, x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def placed_like(x: Any, ref: Any) -> Any:
    """``x`` in ``ref``'s placements when both are DTensors (a gradient in
    its parameter's layout); else ``x``."""
    if not (_is_dtensor(x) and _is_dtensor(ref)):
        return x
    return _placed(x, ref.device_mesh, ref.placements)


def like(t: torch.Tensor, ref: Any) -> Any:
    """``t``, a plain tensor every rank computes alike, as a replicated
    DTensor on ``ref``'s mesh when ``ref`` is a DTensor; else ``t``."""
    if not _is_dtensor(ref) or _is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def on_local_shards(fn, args: list[tuple[Any, int | None, int | None]],
                    out: tuple[int | None, int | None] | list[tuple[int | None, int | None]],
                    *rest: Any, groups: int | None = None) -> Any:
    """``fn(*locals, *rest)`` on each rank's shards, for a kernel that
    works on whole (batch, head) rows. ``args`` are ``(tensor, batch_dim,
    head_dim)`` (``None`` where the tensor has no such dim); the first is
    the reference. With plain tensors this is ``fn(*tensors, *rest)``.

    Over each mesh dimension on which the reference is ``Shard`` on its
    batch or head dim (and the dim divides), every argument is sharded on
    its own batch or head dim, or replicated where it has none; over any
    other mesh dimension everything is replicated. So a rank launches the
    kernel on its own batch rows and heads, and the result (``out``'s
    dims) is laid out the same way. The gradient of an argument replicated
    over a sharded mesh dimension (SSD's B and C over the heads) is each
    rank's part of a sum: ``Partial`` there.

    ``out`` is a list of dims when ``fn`` returns a tuple (one DTensor
    each). ``groups`` is the number of token groups the batch dim holds
    (MoE's, which a rank must hold whole): then only the data axes
    (``pod``, ``data``) keep the batch split, and only where together they
    divide ``groups``; otherwise ``fn`` runs on the replicated tensors,
    every rank alike."""
    ref = args[0][0]
    if not _is_dtensor(ref):
        return fn(*(a for a, _, _ in args), *rest)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = ref.device_mesh
    b0, h0 = args[0][1], args[0][2]
    kinds = []
    for d, p in enumerate(ref.placements):
        kind = None
        for name, dim in (("batch", b0), ("head", h0)):
            if dim is not None and p.is_shard(dim) and ref.shape[dim] % mesh.size(d) == 0:
                kind = name
        if groups is not None and mesh.mesh_dim_names[d] not in ("pod", "data"):
            kind = None
        kinds.append(kind)
    if groups is not None and groups % math.prod(
            mesh.size(d) for d, k in enumerate(kinds) if k == "batch"):
        kinds = [None] * len(kinds)

    def placements(bd, hd):
        return [Shard(bd) if k == "batch" and bd is not None
                else Shard(hd) if k == "head" and hd is not None else Replicate()
                for k in kinds]

    def grads(bd, hd):
        return [Partial() if (k == "batch" and bd is None) or (k == "head" and hd is None)
                else p for k, p in zip(kinds, placements(bd, hd))]

    loc = [_placed(a, mesh, placements(bd, hd)).to_local(grad_placements=grads(bd, hd))
           for a, bd, hd in args]
    res = fn(*loc, *rest)
    if isinstance(out, list):
        return tuple(DTensor.from_local(r, mesh, placements(*o), run_check=False)
                     for r, o in zip(res, out))
    return DTensor.from_local(res, mesh, placements(*out), run_check=False)
