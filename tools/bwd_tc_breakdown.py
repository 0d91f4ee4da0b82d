#!/usr/bin/env python3
"""Where the two tensor-core backward kernels spend their time, on one GPU.

At phase 23's shapes of ``chip_smoke.py`` (bf16): ``flash_attention_bwd``
at llama3.2-1b's training shape (BH 256, S = T = 512, hd 64, causal) and
``ssd_scan_bwd`` at mamba2-370m's (BH 256 = 8 x 32 heads, S 512, P 64, N
128). For each it prints the device time of every CUDA kernel the wrapper
launches (``torch.profiler``, summed over ``--reps`` calls), the wrapper's
time by CUDA events, and for the SSD scan the time of the tensor-core
kernel at each head grouping its launch takes (``--groups``; the wrapper's
own choice is ``head_groups``). With ``--variants`` it also builds copies
of ``csrc/flash_attention_bwd_tc.cu`` and ``csrc/ssd_scan_bwd_tc.cu`` with
one part taken out and times each kernel of every copy beside an unchanged
copy built and run the same way, ``as_is`` (the cut copies compute wrong
outputs; only their times mean anything):

  fl_no_elem      flash: no masks, P or dS (the products take S and dP as
                  they are)
  fl_no_first     flash: the S and dP products removed
  fl_no_second    flash: the dV, dK and dQ products removed
  fl_no_prefetch  flash: no tile copied after a block's first
  fl_ring2, 4     flash: a ring of two or four stages (right outputs)

  st_no_store     the states kernel stages and writes no state
  st_no_update    the states kernel's products removed
  st_no_prefetch  the states kernel copies no chunk after its first ones
  ch_no_prods     the chunk kernel's Lc^T dY, dC and dB products removed
  ch_no_q         the chunk kernel's one-warp scan of Q_t removed
  ch_no_prefetch  the chunk kernel copies no head after its first

Run from the root of a checkout on a Hopper GPU:

    python3 tools/bwd_tc_breakdown.py [--reps 20] [--groups 1,2,4,8,16,32] [--variants]

Prints one JSON line: the card, its power limit, and the readings.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def event_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls, after
    a warm-up and behind a spin kernel (so the host's enqueue is hidden)."""
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def by_kernel(torch, fn, reps: int) -> dict[str, float]:
    """Device microseconds per call of each kernel ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            m = re.search(r"(\w+(<[^()]*>)?)\(", e.name)
            name = m.group(1) if m else e.name[:60]
            out[name] = out.get(name, 0.0) + e.device_time / reps
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def edit(text: str, old: str, new: str) -> str:
    assert text.count(old) == 1, old
    return text.replace(old, new)


def flash_variants(src: str) -> dict[str, str]:
    """Copies of the flash backward source with one part taken out."""
    first = ("    wgmma_fence();\n#pragma unroll\n    for (int kk = 0; kk < HDP / 16; ++kk)\n"
             "      wgmma_ss_m64n64k16(s,")
    return {
        "as_is": src,
        "fl_no_elem": edit(src, "    for (int j = 0; j < 8; ++j) {\n      // dK/dV blocks",
                           "    for (int j = 0; j < 0; ++j) {\n      // dK/dV blocks"),
        "fl_no_first": edit(src, first, "    wgmma_fence();\n#pragma unroll\n"
                            "    for (int kk = 0; kk < 0; ++kk)\n      wgmma_ss_m64n64k16(s,"),
        "fl_no_second": edit(edit(edit(src,
            "      for (int kk = 0; kk < 4; ++kk)   // dV += P^T dO",
            "      for (int kk = 0; kk < 0; ++kk)   // dV += P^T dO"),
            "      for (int kk = 0; kk < 4; ++kk)   // dK += dS^T Q",
            "      for (int kk = 0; kk < 0; ++kk)   // dK += dS^T Q"),
            "      for (int kk = 0; kk < 4; ++kk)   // dQ += dS K",
            "      for (int kk = 0; kk < 0; ++kk)   // dQ += dS K"),
        "fl_no_prefetch": edit(src, "    if (it + ST - 1 < end) stage_streamed",
                               "    if (false) stage_streamed"),
        **{f"fl_ring{n}": edit(src, "constexpr int kStages = HDP <= 64 ? 3 : 2;",
                               f"constexpr int kStages = {n};") for n in (2, 4)},
    }


def variants(src: str) -> dict[str, str]:
    """Copies of the SSD backward source with one part taken out."""
    pre = "      if (j + kStStages - 1 < nW) {"
    step5 = "    if (w == 0) {\n      float av[2], bv[2], vv[2], dtv[2];"
    return {
        "as_is": src,
        "st_no_store": edit(edit(src, "  auto store = [&]() {\n",
                                 "  auto store = [&]() {\n    return;\n"),
                            "  auto copy_out = [&](bf16* base, int k) {\n",
                            "  auto copy_out = [&](bf16* base, int k) {\n    return;\n"),
        "st_no_update": edit(src, "  auto update = [&](const uint8_t* stg, float et) {\n",
                             "  auto update = [&](const uint8_t* stg, float et) {\n    return;\n"),
        "st_no_prefetch": edit(src, pre, "      if (false) {"),
        "ch_no_prods": edit(edit(src, "#pragma unroll\n      for (int kk = 0; kk < 4; ++kk) {\n"
                                      "        if (kk < mi) continue;   // Lc_ij",
                                 "#pragma unroll\n      for (int kk = 0; kk < 0; ++kk) {\n"
                                 "        if (kk < mi) continue;   // Lc_ij"),
                            "    if (nact) {\n      float p1", "    if (false) {\n      float p1"),
        "ch_no_q": edit(src, step5, "    if (false) {\n      float av[2], bv[2], vv[2], dtv[2];"),
        "ch_no_prefetch": edit(src, "    if (hi + 1 < HPB) {\n      stage_head",
                               "    if (false) {\n      stage_head"),
    }


def build_variants(_build, lib: str, make) -> dict[str, object]:
    """Each copy ``make`` gives of library ``lib``'s source, built and
    loaded: its C entry."""
    src = (_build.CSRC / f"{lib}.cu").read_text()
    entry, argtypes = _build.SIGNATURES[lib]
    fns = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name, text in make(src).items():
            cu, so = Path(tmp) / f"{name}.cu", Path(tmp) / f"lib{name}.so"
            cu.write_text(text)
            procs[name] = (so, subprocess.Popen(
                [_build.cuda_tool("nvcc"), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                 "-o", str(so), str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        for name, (so, proc) in procs.items():
            out = proc.communicate()[0].decode()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{out[-3000:]}")
            fn = getattr(ctypes.CDLL(str(so)), entry)
            fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
            fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--groups", default="1,2,4,8,16,32")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bwd_tc_breakdown: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import ssd_scan_bwd as sb
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    gen = torch.Generator(device=dev).manual_seed(11)
    bf16 = torch.bfloat16
    out = {"card": smi.strip()}

    BH, S, hd = 256, 512, 64
    q, k, v, do = (torch.randn((BH, S, hd), generator=gen, device=dev).to(bf16)
                   for _ in range(4))
    o, lse = fa.forward_with_lse(q, k, v, causal=True)
    flash = lambda: fb.flash_attention_bwd(q, k, v, o, do, lse, causal=True)  # noqa: E731
    out["flash_attention_bwd"] = {"shape": [BH, S, hd], "ms": event_ms(torch, flash, args.reps),
                                  "kernels_us": by_kernel(torch, flash, args.reps)}
    if args.variants:
        D = torch.empty((BH, S), dtype=torch.float32, device=dev)
        grads = [torch.empty_like(t) for t in (q, k, v)]
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (q, k, v, o, do, lse, D, *grads)]
        out["flash_attention_bwd"]["variants_us"] = {
            name: by_kernel(torch, lambda fn=fn: fn(*ptrs, BH, S, S, hd, fa.scale_of(hd), 1, 0,
                                                     0.0, stream), args.reps)
            for name, fn in build_variants(_build, "flash_attention_bwd_tc",
                                           flash_variants).items()}
    del q, k, v, do, o, lse

    BH, S, P, N, H = 256, 512, 64, 128, 32
    R = BH // H
    x, dy = (torch.randn((BH, S, P), generator=gen, device=dev).to(bf16) for _ in range(2))
    Bm, Cm = (torch.randn((R, S, N), generator=gen, device=dev).to(bf16) for _ in range(2))
    dt = torch.nn.functional.softplus(torch.randn((BH, S), generator=gen, device=dev))
    A = -torch.exp(torch.randn(BH, generator=gen, device=dev))
    ssd = lambda: sb.ssd_scan_bwd(x, dt, A, Bm, Cm, dy)  # noqa: E731
    nC = -(-S // ss.TC_CHUNK)
    res = {"shape": [BH, S, P], "N": N, "heads": H, "groups": sb.head_groups(R, nC, H),
           "ms": event_ms(torch, ssd, args.reps), "kernels_us": by_kernel(torch, ssd, args.reps)}
    outs = [torch.empty_like(t) for t in (x, dt, A, Bm, Cm)]
    states = torch.empty((2, BH, nC - 1, N, P), dtype=bf16, device=dev)
    dA_part = torch.empty((BH, nC), dtype=torch.float32, device=dev)
    sweep = {}
    for G in (int(g) for g in args.groups.split(",")):
        if H % G:
            continue
        part = torch.empty((2, R, G, S, N), dtype=torch.float32, device=dev)

        def grouped():
            _build.launch("ssd_scan_bwd_tc", dev, x, dt, A, Bm, Cm, dy, *outs[:3], *outs[3:],
                          states[0], states[1], dA_part, part, BH, S, P, N, H, H // G)
        sweep[G] = event_ms(torch, grouped, args.reps)
    res["ms_by_groups"] = sweep
    if args.variants:
        G = sb.head_groups(R, nC, H)
        part = torch.empty((2, R, G, S, N), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        res["variants_us"] = {}
        for name, fn in build_variants(_build, "ssd_scan_bwd_tc", variants).items():
            ptrs = [t.data_ptr() for t in (x, dt, A, Bm, Cm, dy, *outs, states[0], states[1],
                                           dA_part, part)]
            call = (lambda fn=fn: fn(*ptrs, BH, S, P, N, H, H // G, stream))  # noqa: E731
            res["variants_us"][name] = by_kernel(torch, call, args.reps)
    out["ssd_scan_bwd"] = res
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
