"""The roofline table of the dry-run's records (``launch.dryrun``).

Counterpart of ``tools/make_roofline_table.py``: one row a cell with its
three time terms, the bottleneck, the model's FLOPs (6 N D a train token,
2 N D a served one, N the active parameters) over the counted FLOPs, the
compute term's share of the largest term and the analytic GiB a device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline_table [--dir build/dryrun]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.models.config import ModelConfig


def active_params(cfg: ModelConfig) -> float:
    """Active parameter count (MoE: top-k + shared experts only)."""
    D, hd = cfg.d_model, cfg.hd
    attn = 2 * D * cfg.n_heads * hd + 2 * D * cfg.n_kv_heads * hd
    if cfg.num_experts:
        ff = 3 * D * cfg.expert_ff * cfg.top_k
        if cfg.shared_expert_d_ff:
            ff += 3 * D * cfg.shared_expert_d_ff
    else:
        ff = 3 * D * cfg.d_ff
    if cfg.block_pattern == "attn":
        per_layer = attn + ff
        total = cfg.n_layers * per_layer
    else:
        di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        ssm = 2 * D * di + 2 * D * n + D * h + di * D
        total = cfg.n_layers * ssm
        if cfg.block_pattern == "ssm+shared_attn":
            total += (cfg.n_layers // cfg.shared_attn_every) * (attn + ff)
    total += cfg.padded_vocab * D * (1 if cfg.tie_embeddings else 2)
    return total


def model_flops(cfg: ModelConfig, shape: str, n_chips: int) -> float:
    sp = SHAPES[shape]
    n = active_params(cfg)
    if sp.kind == "train":
        tokens = sp.global_batch * sp.seq_len
        return 6.0 * n * tokens / n_chips
    if sp.kind == "prefill":
        tokens = sp.global_batch * sp.seq_len
        return 2.0 * n * tokens / n_chips
    return 2.0 * n * sp.global_batch / n_chips  # decode: 1 token/seq


def row(r: dict) -> str:
    cfg = get_config(r["arch"])
    p = r["per_device"]
    mf = model_flops(cfg, r["shape"], r["n_chips"])
    useful = mf / p["flops"] if p["flops"] else 0.0
    dom = max(p["t_compute"], p["t_memory"], p["t_collective"])
    frac = p["t_compute"] / dom if dom > 0 else 0.0
    amem = r["memory"]["analytic_bytes"]["total"] / 2 ** 30
    return (f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {p['t_compute']*1e3:.2f} | {p['t_memory']*1e3:.2f} "
            f"| {p['t_collective']*1e3:.2f} | {p['bottleneck']} "
            f"| {useful:.2f} | {frac:.2f} | {amem:.2f} |")


def main(argv: list[str] | None = None, out=None) -> None:
    out = out or sys.stdout
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun", help="the dry-run's --out")
    args = ap.parse_args(argv)
    header = ("| arch | shape | mesh | tc (ms) | tm (ms) | tx (ms) "
              "| bottleneck | MODEL/counted flops | roofline frac "
              "| analytic GiB/device |\n"
              "|---|---|---|---|---|---|---|---|---|---|")
    rows, skips, fails = [], [], []
    for path in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if r.get("status") == "ok":
            rows.append((r["arch"], r["shape"], r["mesh"], row(r)))
        elif r.get("status") == "skip":
            skips.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                         f"| SKIP: {r['reason'][:60]} |")
        else:
            fails.append(f"{r['arch']}/{r['shape']}/{r['mesh']}: "
                         f"{r.get('error', '?')[:100]}")
    arch_order = {a: i for i, a in enumerate(ARCHS)}
    shape_order = {s: i for i, s in enumerate(SHAPES)}
    rows.sort(key=lambda t: (arch_order.get(t[0], 99),
                             shape_order.get(t[1], 9), t[2]))
    print(header, file=out)
    for _, _, _, line in rows:
        print(line, file=out)
    print(f"\nskipped cells ({len(skips)}):", file=out)
    for s in skips:
        print(s, file=out)
    if fails:
        print(f"\nFAILED cells ({len(fails)}):", file=out)
        for f_ in fails:
            print(f_, file=out)


if __name__ == "__main__":
    main()
