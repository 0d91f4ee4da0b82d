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

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the five population kernels' entries, whose float32 and
# bfloat16 storage builds (``<name>.cu``, ``<name>_bf16.cu``) take the same
# arguments.
_POPULATION = {
    "bench_eval": (_P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _P),
    "de_step": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                _F, _F, _F, _F, _F, _I, _I, _I, _I, _I, _P),
    "eval_select": (*(_P,) * 8, _I, _I, _I, _F, _I, _I, _I, _I, _I, _P),
    "pso_step": (*(_P,) * 13, _I, _I, _I, _I, *(_F,) * 7, _I, _P),
    "ga_step": (*(_P,) * 12, _I, _I, _I, *(_F,) * 6, _I, _I, _I, _I, _I, _P),
}
# C signature of each library's launch entry: (name, argtypes); restype int.
SIGNATURES = {
    **{f"{k}{sfx}": (f"{k}{sfx}_launch", argtypes)
       for k, argtypes in _POPULATION.items() for sfx in ("", "_bf16")},
    "flash_attention": ("flash_attention_launch",
                        (*(_P,) * 5, _I, _I, _I, _I, _I, _F, _I, _I, _F, _P)),
    "ssd_scan": ("ssd_scan_launch", (*(_P,) * 6, *(_I,) * 6, _P)),
    "flash_attention_tc": ("flash_attention_tc_launch",
                           (*(_P,) * 5, _I, _I, _I, _I, _F, _I, _I, _F, _P)),
    "ssd_scan_tc": ("ssd_scan_tc_launch", (*(_P,) * 7, *(_I,) * 5, _P)),
    "flash_attention_bwd": ("flash_attention_bwd_launch",
                            (*(_P,) * 10, *(_I,) * 5, _F, _I, _I, _F, _P)),
    "ssd_scan_bwd": ("ssd_scan_bwd_launch", (*(_P,) * 13, *(_I,) * 6, _P)),
    "flash_attention_bwd_tc": ("flash_attention_bwd_tc_launch",
                               (*(_P,) * 10, *(_I,) * 4, _F, _I, _I, _F, _P)),
    "ssd_scan_bwd_tc": ("ssd_scan_bwd_tc_launch", (*(_P,) * 15, *(_I,) * 6, _P)),
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def cuda_tool(name: str) -> str:
    """Path of the CUDA toolkit program ``name`` (``nvcc``, ``cuobjdump``):
    on PATH or under /usr/local/cuda/bin; RuntimeError if neither has it."""
    exe = shutil.which(name)
    if exe is None and Path(f"/usr/local/cuda/bin/{name}").exists():
        exe = f"/usr/local/cuda/bin/{name}"
    if exe is None:
        raise RuntimeError(f"{name} was not found on PATH or under /usr/local/cuda/bin")
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
    nvcc = cuda_tool("nvcc")
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
    """The loaded kernel library ``name`` (a key of :data:`SIGNATURES`),
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


def library_path(name: str) -> Path:
    """The built shared library of kernel library ``name`` (built on first
    use)."""
    library(name)
    return build_dir() / f"lib{name}.so"


def ptxas_report(name: str) -> str:
    """The compiler's register/shared-memory report for library ``name``
    (empty if it was not built in this checkout)."""
    log = build_dir() / f"{name}.log"
    return log.read_text() if log.exists() else ""


def on_card(name: str, x: torch.Tensor, dims: tuple[int, ...] = (2, 3)) -> bool:
    """Whether wrapper ``name`` launches its kernel on ``x``: False for a
    CPU tensor (the wrapper runs its plain version), True for a CUDA tensor
    with a dimension count in ``dims``; ValueError for anything else."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    if x.dim() not in dims:
        raise ValueError(f"{name}: input must have {' or '.join(map(str, dims))} "
                         f"dimensions, got {tuple(x.shape)}")
    return True


def check_inputs(device, *specs, dtype: torch.dtype | tuple = torch.float32) -> None:
    """Raise unless each ``(name, tensor, shape)`` is a contiguous tensor of
    that shape on ``device`` whose type is ``dtype`` (or one of them); a
    ``None`` tensor is skipped."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    for name, t, shape in specs:
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def index_input(name: str, t: torch.Tensor, shape: tuple, device) -> torch.Tensor:
    """``t`` as a contiguous int64 tensor, checked for ``shape`` and ``device``."""
    out = t.to(torch.int64).contiguous()
    if out.device != device or tuple(out.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)} on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return out


def launch(name: str, device, *args) -> None:
    """Call library ``name``'s launch entry with ``args`` on ``device``'s
    current stream: tensors go by data pointer, ``None`` as a null pointer,
    numbers as the C signature says. Raises if the entry returns a CUDA
    error."""
    fn = getattr(library(name), SIGNATURES[name][0])
    err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
             torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
