#!/usr/bin/env python3
"""Where the tensor-core flash_attention kernel spends its time, on one GPU.

Builds copies of ``src/repro_torch/kernels/csrc/flash_attention_tc.cu`` with
parts of the key-tile loop taken out, and times each beside the kernel
itself, in turns (forward, then backward), at llama3.2-1b's serve prefill
(BH 128, S = T = 2048, hd 64, bf16, causal):

  no_softmax   the online softmax removed (S is packed to bf16 as P as it is)
  no_copies    no softmax and no K/V copies inside the loop (every tile
               reads the first one)
  bare         as no_copies, without the loop's wait and block barrier
  no_qk        the Q K^T product removed
  no_pv        the P V product removed

The copies compute wrong outputs; only their times mean anything. Run from
the root of a checkout on a Hopper GPU:

    python3 tools/flash_tc_breakdown.py

Prints one JSON line: the card, and the milliseconds of each variant in
both turns.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def cut(src: str, start: str, end: str) -> str:
    """``src`` without the text from ``start`` up to (not including) ``end``."""
    a = src.index(start)
    return src[:a] + src[src.index(end, a):]


def variants(src: str) -> dict[str, str]:
    softmax = ("      // Scores of rows r0", "      // P as the A operand")
    copies = ("    if (kt + 2 < bhi) {\n      const int nx", "    if (kt >= kt_begin")
    wait = "    if (kt + 1 < bhi) cp_async_wait<1>();\n    else cp_async_wait<0>();\n" \
           "    fence_proxy_async();\n    __syncthreads();\n"
    no_softmax = cut(src, *softmax)
    no_copies = cut(no_softmax, *copies)
    assert wait in no_copies
    return {
        "no_softmax": no_softmax,
        "no_copies": no_copies,
        "bare": no_copies.replace(wait, "", 1),
        "no_qk": cut(src, "      wgmma_fence();\n#pragma unroll\n      for (int kk = 0; kk < HDP / 16",
                     "      wgmma_commit();"),
        "no_pv": cut(src, "#pragma unroll\n      for (int kk = 0; kk < 4; ++kk)\n        wgmma_rs_tb",
                     "      wgmma_commit();"),
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_tc_breakdown: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import time_ms
    from repro_torch.kernels import _build, flash_attention as fa

    src = (_build.CSRC / "flash_attention_tc.cu").read_text()
    argtypes = list(_build.SIGNATURES["flash_attention_tc"][1])
    fns = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name, text in variants(src).items():
            cu, lib = Path(tmp) / f"{name}.cu", Path(tmp) / f"lib{name}.so"
            cu.write_text(text)
            procs[name] = (lib, subprocess.Popen(
                [_build.cuda_tool("nvcc"), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                 "-o", str(lib), str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        for name, (lib, proc) in procs.items():
            out = proc.communicate()[0].decode()
            if proc.returncode != 0:
                print(f"nvcc failed on {name}:\n{out[-3000:]}", file=sys.stderr)
                return 1
            fn = ctypes.CDLL(str(lib)).flash_attention_tc_launch
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[name] = fn

    BH, S, hd = 128, 2048, 64
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn((BH, S, hd), generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    calls = {"kernel": lambda: fa.flash_attention(q, k, v, causal=True)}
    for name, fn in fns.items():
        calls[name] = (lambda fn=fn: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                        None, BH, S, S, hd, fa.scale_of(hd), 1, 0, 0.0, stream))
    ms = {name: [] for name in calls}
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            ms[name].append(time_ms(calls[name], reps=20))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "shape": [BH, S, S, hd], "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
