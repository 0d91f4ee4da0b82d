"""Sharded training cases the sharding tests run on gloo ranks.

Imported by ``test_torch_sharded_train.py`` and ``test_torch_compress.py``
and by the ranks they spawn, so it imports torch and the port only (a rank
never loads JAX). Each step case is a reduced config, a mesh shape and a
sharding mode; :func:`run_all` runs every case on every rank of one spawn
and returns rank 0's results as numpy: the step's metrics, the params and moments after one Adam update (gathered whole),
each rank's local shard shapes and bytes; then the launcher's resume
drills. :func:`pod_mean` is ``compressed_pod_mean`` on a (2, 1, 1) pod
mesh.
"""
import dataclasses
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import prng
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import get_config
from repro_torch.data import SyntheticStream, to_device
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import steps, train as ltrain
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


def case_config(name: str):
    arch, mode, _, over = STEP_CASES[name]
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


def step_case(name: str, device: str = "cpu") -> dict | None:
    """One ``make_train_step`` step of case ``name`` on its mesh, from
    ``init_params(PRNGKey(0))`` and the stream's first batch; ``None`` on a
    rank outside the mesh."""
    arch, mode, shape, _ = STEP_CASES[name]
    cfg = case_config(name)
    mesh = lmesh.make_host_mesh(*shape, device=device)
    if mesh.get_coordinate() is None:
        return None
    p_sh, o_sh, c_sh, b_sh = ltrain.layouts(cfg, mesh)
    params = sharding.place(initial_params(cfg, device), p_sh)
    opt = sharding.place(adam.init(params), o_sh)
    batch = sharding.place(to_device(first_batch(cfg), device), b_sh)
    acfg = adam.AdamConfig(**ACFG)
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
    }


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


def run_all(names: list, root: str, device: str = "cpu") -> dict:
    """Every step case in ``names`` and the resume drills, on every rank."""
    torch.set_num_threads(1)        # the ranks share the host's cores
    out = {"steps": {}}
    for name in names:
        r = step_case(name, device)
        if r is not None:
            out["steps"][name] = r
        dist.barrier()
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
