"""Training launcher: mesh -> sharded init (or elastic restore) -> train
step -> synthetic stream -> async checkpoints -> fault handling.

Counterpart of ``repro.launch.train``: on one device (the card unless the
caller passes ``device="cpu"``) when ``mesh`` is None, else on a device
mesh (``launch.mesh.make_host_mesh``), every rank of the joined group
calling ``train`` alike. Over a mesh the ``parallel.sharding`` rules lay
out the params, the optimizer state, the compute copies and each batch as
DTensors; each rank draws the same init from ``PRNGKey(0)`` and keeps its
shards; a restore re-shards the checkpoint onto the current mesh, whatever
mesh wrote it; rank 0 alone prints and writes checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --reduced --device cpu --steps 20

Fault tolerance, as the reference's:
  * a checkpoint of (params, opt_state) every ``ckpt_every`` steps, the
    data cursor in its ``extra``, written on a thread (``blocking=False``)
    while the next steps run;
  * a step that outlasts ``step_timeout_s`` is reported (on a pod the
    controller would re-mesh; here it is logged);
  * the data cursor lives in the checkpoint, so a restart resumes the
    token stream exactly;
  * a non-finite loss skips the step and runs the same params on the next
    batch; a second failure in a row restores the last checkpoint.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time

import torch.distributed as dist

from repro_torch import prng, resolve_device
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import get_config
from repro_torch.data import SyntheticStream, to_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import init_params, param_count
from repro_torch.optim import adam
from repro_torch.parallel import sharding


def snapshot(params, opt_state: adam.AdamState) -> dict:
    """(params, opt_state) as one nested dict, the form the checkpoint
    store writes (of tensors, or of their layouts)."""
    return {"params": params,
            "opt": {"step": opt_state.step, "mu": opt_state.mu, "nu": opt_state.nu}}


def _restore(store: CheckpointStore, params, opt_state, device, shardings=None):
    """The latest checkpoint: (step, params, opt_state, extra), laid out by
    ``shardings`` (a :func:`snapshot` of layouts) when given."""
    step, tree, extra = store.restore(snapshot(params, opt_state), device=device,
                                      shardings=shardings)
    o = tree["opt"]
    return step, tree["params"], adam.AdamState(step=o["step"], mu=o["mu"], nu=o["nu"]), extra


def _latest(store: CheckpointStore, mesh) -> int | None:
    """The latest committed step, the same on every rank of ``mesh``: rank
    0's writes are committed first."""
    if mesh is not None:
        store.wait()
        dist.barrier()
    return store.latest_step()


def layouts(cfg, mesh) -> tuple:
    """(params, optimizer state, compute copies or None, batch) layouts of
    ``cfg`` on ``mesh`` by the ``parallel.sharding`` rules; the batch's
    ``labels`` lie as its ``tokens``."""
    axes = tuple(mesh.mesh_dim_names)
    p_sh = sharding.to_shardings(mesh, sharding.param_specs(cfg, axes))
    o_sh = sharding.to_shardings(mesh, sharding.opt_state_specs(cfg, axes))
    c_spec = sharding.compute_specs(cfg, axes)
    c_sh = sharding.to_shardings(mesh, c_spec) if c_spec is not None else None
    b_spec, bax = sharding.batch_specs(cfg, axes, cfg.global_batch)
    b_sh = sharding.to_shardings(mesh, {**b_spec, "labels": sharding.P(bax, None)})
    return p_sh, o_sh, c_sh, b_sh


def train(cfg, steps: int = 50, ckpt_dir: str | None = None, ckpt_every: int = 20,
          step_timeout_s: float = 3600.0, adam_cfg: adam.AdamConfig | None = None,
          log_every: int = 10, resume: bool = True, device=None, mesh=None):
    """Train ``cfg`` for ``steps`` steps from ``init_params(PRNGKey(0))``
    (or from the latest checkpoint under ``ckpt_dir`` when ``resume``),
    on ``device`` or, with ``mesh``, sharded over it (``device`` then
    defaults to the mesh's device type). Returns (params, opt_state, losses
    of the steps this call ran); over a mesh params and state are
    DTensors."""
    dev = resolve_device(device if mesh is None else (device or mesh.device_type))
    lead = mesh is None or mesh.get_rank() == 0
    acfg = adam_cfg or adam.AdamConfig(lr=1e-3, warmup_steps=10, total_steps=steps)
    params = init_params(prng.PRNGKey(0, dev), cfg)
    n_params = param_count(params)
    p_sh = o_sh = c_sh = b_sh = None
    if mesh is not None:
        p_sh, o_sh, c_sh, b_sh = layouts(cfg, mesh)
        params = sharding.place(params, p_sh)
    opt_state = adam.init(params)
    if mesh is not None:
        opt_state = sharding.place(opt_state, o_sh)
    stream = SyntheticStream(cfg)
    store = CheckpointStore(ckpt_dir, writer=lead) if ckpt_dir else None
    shardings = None if mesh is None else snapshot(p_sh, o_sh)
    start_step = 0

    if store and resume and _latest(store, mesh) is not None:
        start_step, params, opt_state, extra = _restore(store, params, opt_state, dev,
                                                        shardings)
        stream.load_state_dict(extra["data"])
        if lead:
            print(f"[train] restored step {start_step} "
                  f"(data cursor {stream.step})", flush=True)

    step_fn = make_train_step(cfg, acfg, c_sh, donate=True)
    if lead:
        where = f"device {dev}" if mesh is None else \
            f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} on {dev}"
        print(f"[train] {cfg.name}: {n_params:,} params, {where}", flush=True)

    losses = []
    nan_retries = 0
    step = start_step
    while step < steps:
        batch = to_device(next(stream), dev)
        if mesh is not None:
            batch = sharding.place(batch, b_sh)
        t0 = time.time()
        params2, opt2, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])     # waits for the step
        dt = time.time() - t0
        if dt > step_timeout_s and lead:
            print(f"[train] WARNING step {step} took {dt:.1f}s "
                  f"(> {step_timeout_s}s deadline)", flush=True)
        if not math.isfinite(loss):
            nan_retries += 1
            if lead:
                print(f"[train] non-finite loss at step {step} "
                      f"(retry {nan_retries})", flush=True)
            if nan_retries >= 2 and store and _latest(store, mesh) is not None:
                step, params, opt_state, extra = _restore(store, params, opt_state, dev,
                                                          shardings)
                stream.load_state_dict(extra["data"])
                nan_retries = 0
            continue  # paper policy: resubmit once before escalating
        nan_retries = 0
        params, opt_state = params2, opt2
        losses.append(loss)
        step += 1
        if lead and (step % log_every == 0 or step == steps):
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"({dt*1e3:.0f} ms/step)", flush=True)
        if store and step % ckpt_every == 0:
            store.save(step, snapshot(params, opt_state),
                       extra={"data": stream.state_dict()}, blocking=False)
    if store:
        store.wait()
        store.save(steps, snapshot(params, opt_state),
                   extra={"data": stream.state_dict()}, blocking=True)
        if mesh is not None:
            dist.barrier()  # every rank sees the checkpoint committed
    return params, opt_state, losses


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke) config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; cpu runs the plain path)")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    over = {}
    if args.seq_len:
        over["seq_len"] = args.seq_len
    if args.global_batch:
        over["global_batch"] = args.global_batch
    if over:
        cfg = dataclasses.replace(cfg, **over)
    train(cfg, steps=args.steps, ckpt_dir=args.ckpt_dir, device=args.device,
          adam_cfg=adam.AdamConfig(lr=args.lr, warmup_steps=10,
                                   total_steps=args.steps))


if __name__ == "__main__":
    main()
