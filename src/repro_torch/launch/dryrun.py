"""Multi-pod dry-run: trace one step of every (arch x shape x mesh) cell on a
fake mesh of 256 or 512 ranks, in one process, on ``meta`` tensors.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each cell
for 512 host devices that XLA fakes. Here the fake process group of
``torch.testing._internal.distributed.fake_pg`` stands in for the ranks
(every collective returns at once), the production mesh is built on it,
and the step runs eagerly on ``meta`` DTensors laid out by the port's spec
trees, with the reference's ``moe_eb``, ``moe_hidden`` and ``attn_seq_*``
layouts installed. On the multi-pod mesh the port's rules shard over
``pod`` only together with ``data`` (``("pod", "data")``, pod major), so
DTensor runs on the (32, 16) mesh of the same 512 ranks with that pair as
one dimension: on three dimensions DTensor's redistribution planner
searches a graph of placements (a 2-layer cell took 402 s), and the pair's
one collective over 32 ranks is what XLA runs for it. For each cell
this shows:
  * the sharding config is coherent (DTensor places every leaf and
    propagates through the whole step, and every kernel takes its shards),
  * the analytic per-device memory (``parallel.memmodel``) beside the
    traced high-water mark,
  * the roofline terms of one device (``parallel.roofline.count``).

What it cannot report, against the reference:
  * no partitioner: DTensor propagates each operator's layout on its own,
    and where no rule fits it redistributes; XLA's SPMD partitioner plans
    the whole program;
  * no compile time (``t_trace_s`` is the eager trace's host time);
  * no fused traffic: every operator's operands and outputs count, so the
    HBM bytes are an upper bound of a fused step's;
  * no collective overlap: the collective term adds every byte at the
    link's rate, as if nothing overlapped;
  * no measured link rate: ``LINK_BW`` is a datasheet constant.

A train step is traced donated (``make_train_step(donate=True)``: the
state updated in place), as the reference's jit donates it; a decode step
writes its caches in place, and is traced at the cache's last position,
where it reads all of it, as the reference's traced step does at any.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                      # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod ...
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, cell_supported, input_specs
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.steps import make_decode_step, make_prefill_step, make_train_step
from repro_torch.optim import adam
from repro_torch.parallel import ctx
from repro_torch.parallel import roofline as rl
from repro_torch.parallel.memmodel import analytic_memory
from repro_torch.parallel.sharding import (P, Layout, batch_specs, compute_specs,
                                           decode_state_specs, opt_state_specs,
                                           param_shapes, param_specs, place,
                                           placements_of, to_shardings, tree_map)

HBM_BYTES = 80e9   # an H100's memory, the analytic fit's limit


def _parse_overrides(sets: list[str] | None) -> dict:
    out = {}
    for kv in sets or []:
        k, v = kv.split("=", 1)
        try:
            out[k] = int(v)
        except ValueError:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = {"true": True, "false": False}.get(v.lower(), v)
    return out


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks in this process, as rank 0, for
    the body; destroyed after. Refuses to run inside another group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run stands up its own fake process group; "
                           "one is already initialised in this process")
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def _flat(spec: P) -> P:
    """``spec`` on the flattened multi-pod mesh: ``("pod", "data")`` as
    ``"data"`` (the 32 ranks of both), ``("pod", "data", "model")`` as
    ``("data", "model")``."""
    def part(p):
        names = p if isinstance(p, tuple) else (p,)
        if "pod" not in names:
            return p
        if names[:2] != ("pod", "data"):
            raise ValueError(f"spec {spec}: pod shards only with data, pod major")
        rest = names[1:]
        return rest if len(rest) > 1 else rest[0]
    return P(*(None if p is None else part(p) for p in spec))


def _layouts(mesh, spec_tree, flat: bool):
    return to_shardings(mesh, tree_map(lambda s: None if s is None else _flat(s), spec_tree)
                        if flat else spec_tree)


def _rules(mesh, cfg, kind: str, global_batch: int, multi_pod: bool) -> dict:
    """The reference's dry-run layouts: the MoE dispatch buffers and
    expert hidden states, and sequence-parallel attention where the heads
    do not divide the model axis."""
    def lay(*spec):
        return Layout(mesh, placements_of(mesh, _flat(P(*spec))))

    rules = {}
    dax = ("pod", "data") if multi_pod else "data"
    if cfg.num_experts and cfg.sharding_mode != "dp+zero1":
        ep = "model" if cfg.num_experts % 16 == 0 else None
        f_ax = None if ep else "model"
        rules = {"moe_eb": lay(dax, ep, None, None),
                 "moe_hidden": lay(dax, ep, None, f_ax)}
    if cfg.n_heads % 16 and cfg.sharding_mode != "dp+zero1" and kind != "decode":
        bx = dax if global_batch % (32 if multi_pod else 16) == 0 else None
        rules["attn_seq_q"] = lay(bx, "model", None, None)
        rules["attn_seq_kv"] = lay(bx, "model", None, None)
    return rules


def lower_cell(arch: str, shape: str, multi_pod: bool,
               overrides: dict | None = None) -> dict:
    """Trace one step of the cell on its production mesh and return the
    reference's record (``t_trace_s``, ``peak_bytes_traced``,
    ``analytic_bytes`` and ``fits_80GB_analytic`` in place of the keys
    that read a compiled XLA program)."""
    cfg = get_config(arch)
    sp = SHAPES[shape]
    cfg = dataclasses.replace(cfg, seq_len=sp.seq_len, global_batch=sp.global_batch,
                              **(overrides or {}))
    n_chips = 512 if multi_pod else 256
    with fake_world(n_chips):
        axes = tuple(make_production_mesh(multi_pod=multi_pod, device="cpu").mesh_dim_names)
        # DTensor's mesh: the production mesh, (pod, data) flattened
        mesh = make_mesh((32, 16), ("data", "model"), device="cpu") if multi_pod else \
            make_production_mesh(device="cpu")
        kind, specs = input_specs(cfg, shape)

        def layouts(tree):
            return _layouts(mesh, tree, multi_pod)

        params_shape = param_shapes(cfg)
        c_spec = compute_specs(cfg, axes)        # None for pure-tp archs
        c_sh = layouts(c_spec) if c_spec is not None else None
        p_sh = layouts(param_specs(cfg, axes))
        b_spec, bax = batch_specs(cfg, axes, sp.global_batch)
        rules = _rules(mesh, cfg, kind, sp.global_batch, multi_pod)

        if kind == "train":
            params = place(params_shape, p_sh)
            opt = place(adam.init(params_shape), layouts(opt_state_specs(cfg, axes)))
            batch_sh = layouts({**b_spec, "labels": P(bax, None)})
            batch = place(specs["batch"], batch_sh)
            step = make_train_step(cfg, compute_shardings=c_sh, donate=True)
            args = (params, opt, batch)
        elif kind == "prefill":
            # serving holds params in the TP compute layout (no FSDP storage)
            params = place(params_shape, c_sh if c_sh is not None else p_sh)
            step = make_prefill_step(cfg)
            args = (params, place(specs["batch"], layouts(b_spec)))
        else:  # decode
            params = place(params_shape, c_sh if c_sh is not None else p_sh)
            s_spec = decode_state_specs(cfg, axes, sp.global_batch)
            state = {k: v for k, v in specs["state"].items() if k != "pos"}
            state = place(state, layouts({k: s_spec[k] for k in state}))
            state["pos"] = sp.seq_len - 1
            # decode batches differ from train batches (single token / frame)
            db_sh = layouts(tree_map(
                lambda x: P(bax, *([None] * (x.dim() - 1))), specs["batch"]))
            step = make_decode_step(cfg)
            args = (params, state, place(specs["batch"], db_sh))
        t0 = time.time()
        with ctx.sharding_rules(**rules):
            out, count = rl.trace(step, *args)
        t_trace = time.time() - t0

        roof = count.roofline()
        arg_bytes = _local_bytes(args)
        out_bytes = _local_bytes(out)
        alias = _local_bytes(out, within=_storages(args))
        analytic = analytic_memory(
            cfg, kind, axes, sp.global_batch, sp.seq_len, params_shape,
            param_specs(cfg, axes), c_spec,
            state_shape=specs.get("state"),
            state_specs=(decode_state_specs(cfg, axes, sp.global_batch)
                         if kind == "decode" else None))
    return {
        "arch": arch, "shape": shape,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": kind, "status": "ok",
        "t_trace_s": round(t_trace, 1),
        "per_device": roof.to_dict(),
        "collectives": count.collectives().by_kind,
        "kernels": count.kernels,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": roof.peak_bytes - arg_bytes - out_bytes + alias,
            "alias_bytes": alias,
            # the high-water mark of live storages in the eager trace: no
            # fusion, so an upper bound of a fused step's
            "peak_bytes_traced": roof.peak_bytes,
            "analytic_bytes": analytic,
            "fits_80GB_analytic": bool(analytic["total"] < HBM_BYTES),
        },
        "n_chips": n_chips,
    }


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _storages(tree) -> set[int]:
    return {_local(t).untyped_storage()._cdata for t in rl._tensors(tree)}


def _local_bytes(tree, within: set[int] | None = None) -> int:
    """Bytes of the distinct storages of ``tree``'s tensors on this device
    (only those in ``within`` when it is given)."""
    seen: dict[int, int] = {}
    for t in rl._tensors(tree):
        st = _local(t).untyped_storage()
        if within is None or st._cdata in within:
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--set", action="append", default=None, metavar="K=V",
                    help="config overrides for hillclimbing, e.g. "
                         "--set sharding_mode=dp+zero1 --set ssm_chunk=128")
    ap.add_argument("--tag", default="", help="suffix for the output json")
    args = ap.parse_args()
    overrides = _parse_overrides(getattr(args, "set"))

    os.makedirs(args.out, exist_ok=True)
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = []
    for arch in archs:
        cfg = get_config(arch)
        for shape in shapes:
            ok, why = cell_supported(cfg, shape)
            for mp in meshes:
                tag = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}{args.tag}"
                path = os.path.join(args.out, tag + ".json")
                if not ok:
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "status": "skip", "reason": why}
                else:
                    try:
                        rec = lower_cell(arch, shape, mp, overrides=overrides)
                    except Exception as e:  # a failure here is a bug in the system
                        rec = {"arch": arch, "shape": shape,
                               "mesh": "2x16x16" if mp else "16x16",
                               "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                               "trace": traceback.format_exc()[-2000:]}
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                results.append(rec)
                line = f"{tag:60s} {rec['status']}"
                if rec["status"] == "ok":
                    r = rec["per_device"]
                    line += (f"  peak={rec['memory']['peak_bytes_traced']/2**30:6.2f}GiB"
                             f"  h100~{rec['memory']['analytic_bytes']['total']/2**30:6.2f}GiB"
                             f"  tc={r['t_compute']*1e3:8.3f}ms"
                             f"  tm={r['t_memory']*1e3:8.3f}ms"
                             f"  tx={r['t_collective']*1e3:8.3f}ms"
                             f"  bottleneck={r['bottleneck']}"
                             f"  (trace {rec['t_trace_s']}s)")
                elif rec["status"] == "FAIL":
                    line += "  " + rec["error"][:140]
                print(line, flush=True)

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"\n== dry-run: {n_ok} ok / {n_skip} skip / {n_fail} FAIL ==")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
