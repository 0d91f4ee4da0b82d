"""Sharding rules: partition-spec trees for params, optimizer state, batches
and decode caches, for both production meshes, and their placement as
DTensors on a ``torch.distributed`` device mesh.

Counterpart of ``repro.parallel.sharding``. The spec functions are pure
functions of a ``ModelConfig`` and the mesh's axis names and return the
reference's trees leaf for leaf (:class:`P` in place of jax's
``PartitionSpec``). Strategy:

  tp        Megatron 1-D tensor parallelism over the ``model`` axis:
            attention heads / FFN hidden / vocab are model-sharded; weights
            replicated over (pod, data); batch over (pod, data).
  tp+fsdp   same compute sharding, but master weights and Adam moments are
            additionally sharded over the data axes (ZeRO-3 storage); the
            train step gathers the compute copies once a step
            (``launch.steps._cast_params``) and autograd reduce-scatters
            their gradients.
  dp+zero1  data parallelism over every axis; masters and moments sharded
            on each weight's largest dim divisible by the chip count.

Edge rules (against the fixed 16-wide model axis, whatever the run's mesh):
  * KV-head projections are model-sharded only when n_kv_heads % 16 == 0,
    else replicated (GQA archs with kv=8).
  * Archs with n_heads % 16 != 0 (musicgen: 24H) replicate attention
    weights.
  * MoE experts shard over ``model`` when num_experts % 16 == 0 (llama4);
    otherwise the per-expert hidden dim does.
  * Decode KV caches shard the *sequence* dim over ``model``.

So on a small mesh a batch of 8 is replicated, not sharded: the rules
divide by the production mesh's 16 or 32, as the reference's do.

:func:`to_shardings` turns a spec tree into a tree of :class:`Layout`
(a DTensor placement per mesh dimension) and :func:`place` lays plain
tensors out by it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.config import ModelConfig

PyTree = Any
TP = 16  # fixed model-axis width of the production meshes


class P(tuple):
    """A partition spec: for each tensor dimension ``None`` (not sharded),
    a mesh axis name, or a tuple of names (sharded over all of them, the
    first major). ``tuple(P(...))`` equals ``tuple(PartitionSpec(...))``
    of the reference, which also stores a one-name tuple as the name."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple) and len(p) == 1 else p
                                     for p in parts))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def tree_map(fn, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest``:
    through dicts and tuples (a named tuple, ``AdamState``, keeps its
    type); a :class:`P`, ``None``, a tensor or a :class:`Layout` is a
    leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and not isinstance(tree, P):
        parts = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return fn(tree, *rest)


def _dax(mesh_axes: tuple[str, ...]) -> tuple[str, ...] | str:
    return ("pod", "data") if "pod" in mesh_axes else "data"


def _div(n: int, by: int) -> bool:
    return n % by == 0


def _all_axes(mesh_axes: tuple[str, ...]) -> tuple[str, ...]:
    return tuple(mesh_axes)  # ("pod","data","model") or ("data","model")


def param_shapes(cfg: ModelConfig) -> PyTree:
    """``init_params(cfg)``'s tree with ``meta`` tensors: every shape and
    dtype, no value drawn (the reference's ``jax.eval_shape``)."""
    from repro_torch import prng
    from repro_torch.models.transformer import init_params
    return init_params(prng.PRNGKey(0, "meta"), cfg)


def _dp_zero1_specs(cfg: ModelConfig, mesh_axes: tuple[str, ...]) -> PyTree:
    """sharding_mode="dp+zero1": pure data parallelism over EVERY mesh axis;
    master params + Adam moments sharded over all chips on each weight's
    largest dim divisible by the chip count (else by the data axes' count),
    replicated where none divides."""
    allax = _all_axes(mesh_axes)
    n = math.prod({"pod": 2}.get(a, 16) for a in allax)

    def biggest_dim_spec(arr) -> P:
        dims = list(arr.shape)
        order = sorted(range(len(dims)), key=lambda i: -dims[i])
        for i in order:
            if dims[i] % n == 0:
                return P(*[allax if j == i else None for j in range(len(dims))])
        for i in order:  # fall back to data axes only
            nd = n // 16
            if nd > 1 and dims[i] % nd == 0:
                dx = tuple(a for a in allax if a != "model")
                return P(*[dx if j == i else None for j in range(len(dims))])
        return P(*([None] * len(dims)))

    return tree_map(biggest_dim_spec, param_shapes(cfg))


def param_specs(cfg: ModelConfig, mesh_axes: tuple[str, ...]) -> PyTree:
    """Partition-spec tree matching ``init_params(cfg)``'s structure."""
    if cfg.sharding_mode == "dp+zero1":
        return _dp_zero1_specs(cfg, mesh_axes)
    dax = _dax(mesh_axes)
    fsdp = cfg.sharding_mode == "tp+fsdp"
    fs = dax if fsdp else None
    heads_ok = _div(cfg.n_heads, TP)
    kv_ok = _div(cfg.n_kv_heads, TP)
    experts_ok = cfg.num_experts > 0 and _div(cfg.num_experts, TP)

    def attn_spec(f):
        if not heads_ok:                   # musicgen: replicate attn weights
            return {"wq": P(f, None), "wk": P(f, None),
                    "wv": P(f, None), "wo": P(None, f)}
        return {
            "wq": P(f, "model"),
            "wk": P(f, "model") if kv_ok else P(f, None),
            "wv": P(f, "model") if kv_ok else P(f, None),
            "wo": P("model", f),
        }

    def mlp_spec(f):
        return {"w_gate": P(f, "model"), "w_up": P(f, "model"),
                "w_down": P("model", f)}

    def moe_spec(f):
        if experts_ok:
            # experts over model, expert hidden over the data axes
            s = {"router": P(None, None),
                 "w_gate": P("model", None, f),
                 "w_up": P("model", None, f),
                 "w_down": P("model", f, None)}
        else:                              # qwen2-moe (60e): hidden over model
            s = {"router": P(None, None),
                 "w_gate": P(None, f, "model"),
                 "w_up": P(None, f, "model"),
                 "w_down": P(None, "model", f)}
        if cfg.shared_expert_d_ff:
            s["shared"] = mlp_spec(f)
        return s

    def ssm_spec(f):
        return {
            "w_z": P(f, "model"), "w_x": P(f, "model"),
            "w_B": P(f, None), "w_C": P(f, None), "w_dt": P(f, "model"),
            "conv_x": P(None, "model"), "conv_B": P(None, None),
            "conv_C": P(None, None),
            "conv_bias_x": P("model"), "conv_bias_B": P(None),
            "conv_bias_C": P(None),
            "A_log": P("model"), "D": P("model"), "dt_bias": P("model"),
            "norm_scale": P("model"),
            "w_out": P("model", f),
        }

    def attn_layer(f):
        d = {"ln1": P(None), "ln2": P(None), "attn": attn_spec(f),
             ("moe" if cfg.num_experts else "mlp"):
                 (moe_spec(f) if cfg.num_experts else mlp_spec(f))}
        if cfg.post_norm:
            d["ln1_post"] = P(None)
            d["ln2_post"] = P(None)
        return d

    def stack(tree):   # layer-stacked params carry a leading L axis
        return tree_map(lambda s: P(None, *s), tree)

    specs: dict = {"final_norm": P(None)}
    if cfg.frontend != "audio_stub":
        specs["embed"] = P("model", fs)
    if not cfg.tie_embeddings or cfg.frontend == "audio_stub":
        specs["lm_head"] = P(fs, "model")
    if cfg.frontend != "none":
        specs["frontend"] = {"proj": P(None, None)}
    if cfg.block_pattern == "attn":
        specs["layers"] = stack(attn_layer(fs))
    else:
        specs["layers"] = stack({"ln": P(None), "ssm": ssm_spec(fs)})
        if cfg.block_pattern == "ssm+shared_attn":
            specs["shared_attn"] = attn_layer(fs)
    return specs


def compute_specs(cfg: ModelConfig, mesh_axes: tuple[str, ...]) -> PyTree | None:
    """Compute-time weight layouts: under tp+fsdp the TP-only specs (one
    all-gather over the data axes a step; routed experts keep their 2D
    layout), under dp+zero1 every weight replicated; None for pure tp
    (compute == storage)."""
    if cfg.sharding_mode == "dp+zero1":
        storage = _dp_zero1_specs(cfg, mesh_axes)
        return tree_map(lambda s: P(*([None] * len(s))), storage)
    if cfg.sharding_mode != "tp+fsdp":
        return None
    tp_cfg = dataclasses.replace(cfg, sharding_mode="tp")
    specs = param_specs(tp_cfg, mesh_axes)
    if cfg.num_experts and _div(cfg.num_experts, TP):
        moe2d = param_specs(cfg, mesh_axes)["layers"]["moe"]
        for kname in ("w_gate", "w_up", "w_down"):
            specs["layers"]["moe"][kname] = moe2d[kname]
    return specs


def opt_state_specs(cfg: ModelConfig, mesh_axes: tuple[str, ...]) -> PyTree:
    """AdamState(step, mu, nu): moments shard like params."""
    from repro_torch.optim.adam import AdamState
    ps = param_specs(cfg, mesh_axes)
    return AdamState(step=P(), mu=ps, nu=tree_map(lambda s: s, ps))


def batch_specs(cfg: ModelConfig, mesh_axes: tuple[str, ...],
                global_batch: int) -> tuple[PyTree, Any]:
    """(spec of each batch entry, the batch dim's axes or None)."""
    if cfg.sharding_mode == "dp+zero1":
        allax = _all_axes(mesh_axes)
        n = 512 if "pod" in mesh_axes else 256
        bax = allax if _div(global_batch, n) else (
            _dax(mesh_axes) if _div(global_batch, n // 16) else None)
    else:
        ndev = 32 if "pod" in mesh_axes else 16
        bax = _dax(mesh_axes) if _div(global_batch, ndev) else None
    out: dict = {}
    if cfg.frontend == "audio_stub":
        out["embeds"] = P(bax, None, None)
    elif cfg.frontend == "vlm_stub":
        out["embeds"] = P(bax, None, None)
        out["tokens"] = P(bax, None)
    else:
        out["tokens"] = P(bax, None)
    return out, bax


def decode_state_specs(cfg: ModelConfig, mesh_axes: tuple[str, ...],
                       global_batch: int) -> PyTree:
    """Decode caches: batch over the batch axes, KV caches' sequence over
    ``model``. Serving runs unsharded; the planning tools read this."""
    _, bax = batch_specs(cfg, mesh_axes, global_batch)
    specs: dict = {"pos": P()}
    if cfg.block_pattern == "attn":
        specs["k"] = P(None, bax, "model", None, None)   # sequence-sharded cache
        specs["v"] = P(None, bax, "model", None, None)
    else:
        specs["conv"] = P(None, bax, None, "model")
        specs["ssd"] = P(None, bax, "model", None, None)
        if cfg.block_pattern == "ssm+shared_attn":
            specs["k"] = P(None, bax, "model", None, None)
            specs["v"] = P(None, bax, "model", None, None)
    return specs


# ---------------------------------------------------------------------------
# placement on a device mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Layout:
    """A spec placed on a mesh: one DTensor placement per mesh dimension."""

    mesh: Any            # torch.distributed.device_mesh.DeviceMesh
    placements: tuple


def placements_of(mesh, spec: P) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on each
    mesh dimension the spec names at tensor dim ``i``, else ``Replicate()``.
    A tuple of names shards one tensor dim over several mesh dims, the
    first major, as DTensor orders them (by mesh dim), so the names must
    come in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for i, part in enumerate(spec):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: axes {axes} not in the mesh's order {names}")
        for d in dims:
            out[d] = Shard(i)
    return tuple(out)


def to_shardings(mesh, spec_tree: PyTree) -> PyTree:
    """The spec tree as a tree of :class:`Layout` on ``mesh`` (``None``
    leaves stay ``None``)."""
    return tree_map(lambda s: None if s is None else Layout(mesh, placements_of(mesh, s)),
                    spec_tree)


def place(tree: PyTree, layouts: PyTree) -> PyTree:
    """Each plain tensor of ``tree`` as a DTensor with its :class:`Layout`
    (a ``None`` layout leaves the leaf as it is). Every rank holds the same
    full tensor (the same init from ``PRNGKey(0)``, the same restored
    checkpoint, the same batch), so each keeps its own shard with no
    transfer: ``distribute_tensor(..., src_data_rank=None)``."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(t, lay):
        if lay is None:
            return t
        if isinstance(t, DTensor):
            return t.redistribute(lay.mesh, lay.placements)
        return distribute_tensor(t, lay.mesh, lay.placements, src_data_rank=None)

    return tree_map(one, tree, layouts)


def gather(tree: PyTree) -> PyTree:
    """Each DTensor of ``tree`` as the full plain tensor, on every rank: a
    collective."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)
