"""Training launcher: init (or restore) -> train step -> synthetic stream ->
async checkpoints -> fault handling.

Counterpart of ``repro.launch.train`` on one device: the card unless the
caller passes ``device="cpu"``. The reference's ``mesh`` argument (sharded
init, elastic re-sharding on restore) has no counterpart here: sharding
over several cards (``parallel/*``, ``launch/mesh.py``) is queue item g of
ROADMAP.md's §A.2.

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

from repro_torch import prng, resolve_device
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import get_config
from repro_torch.data import SyntheticStream, to_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import init_params, param_count
from repro_torch.optim import adam


def _snapshot(params, opt_state: adam.AdamState) -> dict:
    """(params, opt_state) as one nested dict of tensors, the form the
    checkpoint store writes."""
    return {"params": params,
            "opt": {"step": opt_state.step, "mu": opt_state.mu, "nu": opt_state.nu}}


def _restore(store: CheckpointStore, params, opt_state, device):
    """The latest checkpoint: (step, params, opt_state, extra)."""
    step, tree, extra = store.restore(_snapshot(params, opt_state), device=device)
    o = tree["opt"]
    return step, tree["params"], adam.AdamState(step=o["step"], mu=o["mu"], nu=o["nu"]), extra


def train(cfg, steps: int = 50, ckpt_dir: str | None = None, ckpt_every: int = 20,
          step_timeout_s: float = 3600.0, adam_cfg: adam.AdamConfig | None = None,
          log_every: int = 10, resume: bool = True, device=None):
    """Train ``cfg`` for ``steps`` steps from ``init_params(PRNGKey(0))``
    (or from the latest checkpoint under ``ckpt_dir`` when ``resume``).
    Returns (params, opt_state, losses of the steps this call ran)."""
    dev = resolve_device(device)
    acfg = adam_cfg or adam.AdamConfig(lr=1e-3, warmup_steps=10, total_steps=steps)
    params = init_params(prng.PRNGKey(0, dev), cfg)
    opt_state = adam.init(params)
    stream = SyntheticStream(cfg)
    store = CheckpointStore(ckpt_dir) if ckpt_dir else None
    start_step = 0

    if store and resume and store.latest_step() is not None:
        start_step, params, opt_state, extra = _restore(store, params, opt_state, dev)
        stream.load_state_dict(extra["data"])
        print(f"[train] restored step {start_step} "
              f"(data cursor {stream.step})", flush=True)

    step_fn = make_train_step(cfg, acfg)
    print(f"[train] {cfg.name}: {param_count(params):,} params, device {dev}", flush=True)

    losses = []
    nan_retries = 0
    step = start_step
    while step < steps:
        batch = to_device(next(stream), dev)
        t0 = time.time()
        params2, opt2, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])     # waits for the step
        dt = time.time() - t0
        if dt > step_timeout_s:
            print(f"[train] WARNING step {step} took {dt:.1f}s "
                  f"(> {step_timeout_s}s deadline)", flush=True)
        if not math.isfinite(loss):
            nan_retries += 1
            print(f"[train] non-finite loss at step {step} "
                  f"(retry {nan_retries})", flush=True)
            if nan_retries >= 2 and store and store.latest_step() is not None:
                step, params, opt_state, extra = _restore(store, params, opt_state, dev)
                stream.load_state_dict(extra["data"])
                nan_retries = 0
            continue  # paper policy: resubmit once before escalating
        nan_retries = 0
        params, opt_state = params2, opt2
        losses.append(loss)
        step += 1
        if step % log_every == 0 or step == steps:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"({dt*1e3:.0f} ms/step)", flush=True)
        if store and step % ckpt_every == 0:
            store.save(step, _snapshot(params, opt_state),
                       extra={"data": stream.state_dict()}, blocking=False)
    if store:
        store.wait()
        store.save(steps, _snapshot(params, opt_state),
                   extra={"data": stream.state_dict()}, blocking=True)
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
