"""Sharded training cases the sharding tests run on gloo ranks.

Imported by ``test_torch_sharded_train.py``,
``test_torch_sharded_train_archs.py`` (with its own table of cases) and
``test_torch_compress.py`` and by the ranks they spawn, so it imports
torch and the port only (a rank never loads JAX). Each step case is a
reduced config, a mesh shape and a sharding mode; :func:`run_all` runs
every case on every rank of one spawn and returns rank 0's results as
numpy: the step's metrics, the params and moments after one Adam update (gathered whole),
each rank's local shard shapes and bytes, and on request the collectives
the step issued; then the launcher's resume drills. :func:`pod_mean` is
``compressed_pod_mean`` on a (2, 1, 1) pod mesh.
"""
import contextlib
import dataclasses
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import prng
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import get_config
from repro_torch.data import SyntheticStream, to_device
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import steps, train as ltrain
from repro_torch.models import layers
from repro_torch.models.transformer import init_params, tree_map
from repro_torch.optim import adam
from repro_torch.parallel import compress, sharding

ACFG = dict(lr=1e-3, warmup_steps=2, total_steps=10, weight_decay=0.01)
# heads divide the model axis (heads_ok), kv heads stay replicated
WIDE = dict(n_heads=16, d_model=128, n_kv_heads=2)


def config(arch: str, mode: str | None = None, **over):
    """The reduced config of ``arch`` (attention archs at :data:`WIDE`) in
    sharding mode ``mode`` (its own when None)."""
    base = get_config(arch)
    cfg = base.reduced(**({**WIDE, **over} if base.block_pattern == "attn" else over))
    return cfg if mode is None else dataclasses.replace(cfg, sharding_mode=mode)


# name -> (arch, sharding mode, mesh (data, model), config overrides)
STEP_CASES = {
    **{f"llama_{m}_{d}x{k}": ("llama3.2-1b", m, (d, k), {})
       for m in ("tp", "tp+fsdp", "dp+zero1") for d, k in ((1, 2), (2, 1))},
    "llama_tp_2x1_batch16": ("llama3.2-1b", "tp", (2, 1), {"global_batch": 16}),
    "mamba2_tp_1x2": ("mamba2-370m", "tp", (1, 2), {}),
    "granite_tp+fsdp_2x1": ("granite-3-8b", "tp+fsdp", (2, 1), {}),
    "llama_tp_1x1": ("llama3.2-1b", "tp", (1, 1), {}),
}


def case_config(name: str, table: dict = STEP_CASES):
    arch, mode, _, over = table[name]
    return config(arch, mode, **over)


_INITS: dict = {}


def initial_params(cfg, device: str = "cpu"):
    """``init_params(PRNGKey(0))`` of ``cfg``, drawn once a process for
    configs that differ only in their sharding mode."""
    key = (dataclasses.replace(cfg, sharding_mode="tp"), device)
    if key not in _INITS:
        _INITS[key] = init_params(prng.PRNGKey(0, device), cfg)
    return _INITS[key]


def first_batch(cfg) -> dict:
    """The stream's first batch (numpy)."""
    return next(SyntheticStream(cfg))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def leaves(tree, pre=""):
    """(path, leaf) of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{pre}/{k}")
    else:
        yield pre, tree


def _flat_np(tree) -> dict:
    return {k: _np(v) for k, v in leaves(sharding.gather(tree))}


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    return sum((v.to_local() if isinstance(v, DTensor) else v).nbytes
               for _, v in leaves(tree))


class CollectiveTally(TorchDispatchMode):
    """Every collective DTensor issues while entered (the backward's too):
    (op, input shape) -> calls."""

    def __init__(self):
        super().__init__()
        self.calls: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith("_c10d_functional.") and not name.startswith(
                ("_c10d_functional.wait_tensor", "_c10d_functional._wrap")):
            key = (name.split(".")[1], tuple(args[0].shape))
            self.calls[key] = self.calls.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _dispatches(groups: list | None):
    """While entered, the number of token groups each ``moe_dispatch`` call
    is given is appended to ``groups`` (a rank's own groups when the
    dispatch is group-local); nothing when ``groups`` is None."""
    if groups is None:
        yield
        return
    inner = layers.moe_dispatch

    def counting(params, xt, cfg, cap):
        groups.append(int(xt.shape[0]))
        return inner(params, xt, cfg, cap)

    layers.moe_dispatch = counting
    try:
        yield
    finally:
        layers.moe_dispatch = inner


def step_case(name: str, device: str = "cpu", table: dict = STEP_CASES,
              tally: bool = False) -> dict | None:
    """One ``make_train_step`` step of case ``name`` of ``table`` on its
    mesh, from ``init_params(PRNGKey(0))`` and the stream's first batch,
    with ``tally`` the collectives it issued (:class:`CollectiveTally`);
    ``None`` on a rank outside the mesh."""
    arch, mode, shape, _ = table[name]
    cfg = case_config(name, table)
    mesh = lmesh.make_host_mesh(*shape, device=device)
    if mesh.get_coordinate() is None:
        return None
    p_sh, o_sh, c_sh, b_sh = ltrain.layouts(cfg, mesh)
    params = sharding.place(initial_params(cfg, device), p_sh)
    opt = sharding.place(adam.init(params), o_sh)
    batch = sharding.place(to_device(first_batch(cfg), device), b_sh)
    acfg = adam.AdamConfig(**ACFG)
    seen = CollectiveTally() if tally else None
    groups: list = []
    with seen or contextlib.nullcontext(), _dispatches(groups if tally else None):
        new_p, new_o, metrics = steps.make_train_step(cfg, acfg, c_sh)(params, opt, batch)
    shapes = {k: tuple(v.to_local().shape) for k, v in leaves(params)}
    want = {k: tuple(v.shape) for k, v in leaves(params)}
    info = (shapes, _local_bytes(params), _local_bytes(new_o.mu) + _local_bytes(new_o.nu))
    every = [info]
    if mesh.size() > 1:             # every rank of the world is in the mesh
        every = [None] * mesh.size()
        dist.all_gather_object(every, info)
    return {
        "metrics": {k: float(sharding.gather(v)) for k, v in metrics.items()},
        "params": _flat_np(new_p),
        "mu": _flat_np(new_o.mu), "nu": _flat_np(new_o.nu),
        "step": int(sharding.gather(new_o.step)),
        "specs": {k: tuple(s) for k, s in leaves(sharding.param_specs(
            cfg, tuple(mesh.mesh_dim_names)))},
        "global_shapes": want,
        "local_shapes": [e[0] for e in every if e is not None],
        "param_bytes": [e[1] for e in every if e is not None],
        "moment_bytes": [e[2] for e in every if e is not None],
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "collectives": seen.calls if seen else None,
        "dispatch_groups": sorted(set(groups)),
        "compute_specs": {k: tuple(s) for k, s in leaves(sharding.compute_specs(
            cfg, tuple(mesh.mesh_dim_names)) or {})},
    }


# The global-norm clip of the donation cases: below every reduced config's
# first gradient norm, so the clip scales the step.
DONATE_CLIP = 0.1


def donate_bits(name: str, device: str = "cpu", table: dict = STEP_CASES) -> dict | None:
    """Case ``name`` of ``table`` (its mesh ``None``: unsharded) stepped
    from the same params, state and batch by ``make_train_step`` pure and
    with ``donate``, the clip at :data:`DONATE_CLIP`; then the donated step
    on params with a NaN embedding. Returns the first step's grad norm,
    whether the two steps' loss, params, moments and step count are equal
    bit for bit (gathered whole), whether the donated step returned the
    tensors it was given, and whether the NaN step left them untouched;
    ``None`` on a rank outside the mesh."""
    arch, mode, shape, _ = table[name]
    cfg = case_config(name, table)
    acfg = adam.AdamConfig(**{**ACFG, "grad_clip": DONATE_CLIP})
    batch = to_device(first_batch(cfg), device)
    lay = (None,) * 4
    if shape is not None:
        mesh = lmesh.make_host_mesh(*shape, device=device)
        if mesh.get_coordinate() is None:
            return None
        lay = ltrain.layouts(cfg, mesh)
        batch = sharding.place(batch, lay[3])

    def fresh(nan=False):
        params = tree_map(torch.clone, initial_params(cfg, device))
        if nan:
            params["embed"] = torch.full_like(params["embed"], float("nan"))
        if lay[0] is not None:
            params = sharding.place(params, lay[0])
        opt = adam.init(params)
        return params, (opt if lay[1] is None else sharding.place(opt, lay[1]))

    def bits(tree):
        return {k: v.tobytes() for k, v in _flat_np(tree).items()}

    pure_p, pure_o, pure_m = steps.make_train_step(cfg, acfg, lay[2])(*fresh(), batch)
    donated = steps.make_train_step(cfg, acfg, lay[2], donate=True)
    params, opt = fresh()
    new_p, new_o, new_m = donated(params, opt, batch)
    same = (float(sharding.gather(pure_m["loss"])) == float(sharding.gather(new_m["loss"]))
            and all(bits(a) == bits(b) for a, b in ((pure_p, new_p), (pure_o.mu, new_o.mu),
                                                     (pure_o.nu, new_o.nu)))
            and int(sharding.gather(pure_o.step)) == int(sharding.gather(new_o.step)) == 1)
    in_place = all(a is b for a, b in zip(
        [v for _, v in leaves(params)] + [v for _, v in leaves(opt.mu)],
        [v for _, v in leaves(new_p)] + [v for _, v in leaves(new_o.mu)]))
    params, opt = fresh(nan=True)
    before = bits(params), bits(opt.mu), bits(opt.nu)
    new_p, new_o, new_m = donated(params, opt, batch)
    kept = (before == (bits(new_p), bits(new_o.mu), bits(new_o.nu))
            and int(sharding.gather(new_o.step)) == 0)
    return {"grad_norm": float(sharding.gather(pure_m["grad_norm"])), "same": same,
            "in_place": in_place, "nan_kept": kept}


def donate_all(names: list, device: str = "cpu", table: dict = STEP_CASES) -> dict:
    """:func:`donate_bits` of each case of ``table`` in ``names``, on every
    rank."""
    torch.set_num_threads(1)        # the ranks share the host's cores
    return {name: donate_bits(name, device, table) for name in names}


TRAIN_ARCH = ("llama3.2-1b", "tp", {})


def _train(root: str, steps_: int, mesh, device="cpu"):
    arch, mode, over = TRAIN_ARCH
    cfg = config(arch, mode, **over)
    p, o, losses = ltrain.train(cfg, steps=steps_, ckpt_dir=root, ckpt_every=2,
                                adam_cfg=adam.AdamConfig(**ACFG), log_every=100,
                                device=device, mesh=mesh)
    return _flat_np(p), _flat_np(o.mu), losses


def resume_drills(root: str, device: str = "cpu") -> dict:
    """The launcher on (1, 2): 4 steps in one call, checkpointed every 2;
    its step-2 checkpoint (alone in a copy of its directory) resumed to 4
    by fresh calls on the same mesh, on (2, 1) and on no mesh; the step-2
    leaves restored onto (2, 1)."""
    rank = dist.get_rank()
    m12 = lmesh.make_host_mesh(1, 2, device=device)
    m21 = lmesh.make_host_mesh(2, 1, device=device)
    dirs = {k: os.path.join(root, k) for k in ("whole", "same", "other", "none")}
    out: dict = {}
    out["whole"] = _train(dirs["whole"], 4, m12)
    if rank == 0:
        for k in ("same", "other", "none"):
            os.makedirs(dirs[k])
            shutil.copytree(os.path.join(dirs["whole"], "step_00000002"),
                            os.path.join(dirs[k], "step_00000002"))
        step2 = os.path.join(dirs["whole"], "step_00000002")
        man = CheckpointStore(dirs["whole"]).read_manifest(2)
        out["saved"] = {e["name"]: np.load(os.path.join(step2, e["file"]))
                        for e in man["leaves"]}
        out["manifest"] = [(e["name"], e["shape"], e["dtype"]) for e in man["leaves"]]
    dist.barrier()
    # the step-2 leaves restored onto the other mesh, gathered back
    arch, mode, over = TRAIN_ARCH
    cfg = config(arch, mode, **over)
    p_sh, o_sh, _, _ = ltrain.layouts(cfg, m21)
    like = ltrain.snapshot(init_params(prng.PRNGKey(0, "meta"), cfg),
                           adam.init(init_params(prng.PRNGKey(0, "meta"), cfg)))
    _, tree, _ = CheckpointStore(dirs["other"]).restore(
        like, step=2, device=device, shardings=ltrain.snapshot(p_sh, o_sh))
    out["restored_other"] = {k: _np(v) for k, v in leaves(sharding.gather(tree))}
    out["restored_local_shape"] = tuple(tree["params"]["embed"].to_local().shape)
    out["same"] = _train(dirs["same"], 4, m12)
    out["other"] = _train(dirs["other"], 4, m21)
    if rank == 0:
        out["none"] = _train(dirs["none"], 4, None)
    dist.barrier()
    return out


# MoE dispatches (``models.layers.route``) over a (2, 1) mesh with the
# batch rows split over data, each against the unsharded call: name ->
# (arch, config overrides, batch, seq). G = 4 puts 2 groups on a rank
# (capacity drops forced); G = 3 is no multiple of the 2 ranks and G = 1
# one group, both on the replicated route; an all-tie router.
DISPATCH_CASES = {
    "group_local": ("qwen2-moe-a2.7b", {"moe_groups": 4, "capacity_factor": 0.5}, 4, 8),
    "group_local_ties": ("llama4-scout-17b-a16e", {"num_experts": 16, "moe_groups": 2}, 2, 8),
    "replicated_g3": ("qwen2-moe-a2.7b", {"moe_groups": 3}, 2, 12),
    "replicated_g1": ("qwen2-moe-a2.7b", {}, 2, 12),
}


def dispatch_bits(device: str = "cpu") -> dict:
    """Each of :data:`DISPATCH_CASES`: (the groups this rank's dispatch
    took, whether the buffers, slots, gates and per-group aux gathered
    whole equal the unsharded call's bit for bit, how many pairs the
    capacity dropped)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = lmesh.make_host_mesh(2, 1, device=device)
    out = {}
    for name, (arch, over, B, S) in DISPATCH_CASES.items():
        cfg = config(arch, None, **over)
        lp = tree_map(lambda v: v[0], initial_params(cfg, device)["layers"]["moe"])
        if name.endswith("ties"):
            lp = {**lp, "router": torch.zeros_like(lp["router"])}
        gen = torch.Generator().manual_seed(B * S)
        x = torch.randn((B, S, cfg.d_model), generator=gen).to(device)
        want = layers.route(lp, x, cfg)
        groups: list = []
        with _dispatches(groups):
            got = layers.route({"router": distribute_tensor(
                lp["router"], mesh, [Replicate(), Replicate()], src_data_rank=None)},
                distribute_tensor(x, mesh, [Shard(0), Replicate()], src_data_rank=None), cfg)
        G, cap = layers._groups(cfg, B * S)
        same = all(g.full_tensor().cpu().numpy().tobytes() == w.cpu().numpy().tobytes()
                   for g, w in zip(got, want))
        out[name] = (groups, same, int((want[1] == cfg.num_experts * cap).sum()))
    return out


def run_all(names: list, root: str | None, device: str = "cpu",
            table: dict = STEP_CASES, tally: bool = False, dispatch: bool = False) -> dict:
    """Every step case of ``table`` in ``names`` (``tally``: with its
    collectives), with ``dispatch`` :func:`dispatch_bits` and, given a
    ``root``, the resume drills, on every rank."""
    torch.set_num_threads(1)        # the ranks share the host's cores
    out = {"steps": {}}
    if dispatch:
        out["dispatch"] = dispatch_bits(device)
    for name in names:
        r = step_case(name, device, table, tally)
        if r is not None:
            out["steps"][name] = r
        dist.barrier()
    if root is not None:
        out["drills"] = resume_drills(root, device)
    return out


def pod_mean(grads_by_rank: list, seed: int, device: str = "cpu") -> dict:
    """``compressed_pod_mean`` of this rank's gradient tree (numpy leaves)
    over the pod dimension of a (2, 1, 1) mesh."""
    mesh = lmesh.make_mesh((2, 1, 1), ("pod", "data", "model"), device=device)
    mine = tree_map(lambda a: torch.from_numpy(a).to(device), grads_by_rank[dist.get_rank()])
    got = compress.compressed_pod_mean(mine, prng.PRNGKey(seed, device),
                                       group=mesh.get_group("pod"))
    return {k: _np(v) for k, v in leaves(got)}
