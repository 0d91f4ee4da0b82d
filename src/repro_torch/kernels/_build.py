"""Build the CUDA kernels with nvcc at first use and bind them with ctypes.

Each ``csrc/*.cu`` file becomes one shared library with a plain C interface,
compiled for Hopper (``sm_90a``) into ``build/kernels/<hash>/`` at the root
of the checkout; the hash covers every source and the flags, so an edited
kernel is rebuilt and an unchanged one is reused. All sources are compiled
together (one nvcc process each) the first time any kernel is asked for.
Nothing is built at import; a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of each library's launch entry: (name, argtypes); restype int.
SIGNATURES = {
    "bench_eval": ("bench_eval_launch", (_P, _P, _P, _I, _I, _I, _F, _P)),
    "de_step": ("de_step_launch",
                (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                 _F, _F, _F, _F, _F, _P)),
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None and Path("/usr/local/cuda/bin/nvcc").exists():
        exe = "/usr/local/cuda/bin/nvcc"
    if exe is None:
        raise RuntimeError(
            "nvcc was not found on PATH or under /usr/local/cuda/bin; the "
            "CUDA kernels cannot be built")
    return exe


def build_dir() -> Path:
    """``build/kernels/<hash of sources and flags>``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _build_all(out: Path) -> None:
    """Compile every ``csrc/*.cu`` into ``out`` in parallel; each library is
    written under a temporary name and renamed, so a reader never sees a
    partial file. The ptxas report goes to ``<name>.log``."""
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        lib = out / f"lib{src.stem}.so"
        if lib.exists():
            continue
        tmp = out / f".lib{src.stem}.{os.getpid()}.so"
        log = open(out / f"{src.stem}.log", "w")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT)
        jobs.append((src, tmp, lib, log, proc))
    failed = []
    for src, tmp, lib, log, proc in jobs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{src.name} (rc {rc}):\n"
                          + (out / f"{src.stem}.log").read_text()[-4000:])
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed to build " + "\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (``bench_eval`` or ``de_step``),
    building all of them on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        out = build_dir()
        path = out / f"lib{name}.so"
        if not path.exists():
            _build_all(out)
        lib = ctypes.CDLL(str(path))
        fn_name, argtypes = SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
        return lib


def ptxas_report(name: str) -> str:
    """The compiler's register/shared-memory report for library ``name``
    (empty if it was not built in this checkout)."""
    log = build_dir() / f"{name}.log"
    return log.read_text() if log.exists() else ""


def check(err: int, name: str) -> None:
    """Raise if a launch entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
