"""Carry engine state and objectives across from numpy data.

The two packages share a state layout (``pop``, ``fit``, ``best_arg``,
``best_val``), except that this port always keeps the island axis: a JAX
single-island state, which has none, gains one on the way in. With these a
test starts both engines from one state.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.functions.benchmarks import (FUNCTIONS, Function,
                                              make_shifted_rosenbrock, on_device)

STATE_KEYS = ("pop", "fit", "best_arg", "best_val")
_RANK = {"pop": 3, "fit": 2, "best_arg": 2, "best_val": 1}  # island-stacked


def state_from_numpy(d: dict[str, Any], device: str | torch.device) -> dict:
    """Engine state from numpy arrays (either package's layout) on ``device``."""
    out = {}
    for k in STATE_KEYS:
        a = np.asarray(d[k], dtype=np.float32)
        if a.ndim == _RANK[k] - 1:
            a = a[None]
        if a.ndim != _RANK[k]:
            raise ValueError(f"state[{k!r}] has shape {a.shape}")
        out[k] = torch.from_numpy(a.copy()).to(device)
    return out


def state_to_numpy(state: dict) -> dict[str, np.ndarray]:
    """Island-stacked numpy copies of the engine state."""
    return {k: state[k].detach().cpu().numpy() for k in STATE_KEYS}


def function_from_numpy(name: str, shift: np.ndarray | None = None,
                        bias: float = 0.0) -> Function:
    """An objective from its name and optional shift and bias (e.g. the JAX
    package's ``Function.shift`` and ``.bias``): ``f(x - shift) + bias``,
    and the CEC'2008 form for ``shifted_rosenbrock``."""
    o = None if shift is None else torch.from_numpy(
        np.asarray(shift, np.float32).copy())
    if name == "shifted_rosenbrock":
        if o is None:
            raise ValueError("shifted_rosenbrock needs its shift vector")
        return make_shifted_rosenbrock(o.shape[0], bias=float(bias), shift=o)
    base = FUNCTIONS[name]
    if o is None and bias == 0.0:
        return base

    copies: dict = {}

    def fn(x: torch.Tensor) -> torch.Tensor:
        z = x if o is None else x - on_device(o, x.device, copies)
        return base.fn(z) + bias

    return Function(name, fn, base.lo, base.hi, f_star=base.f_star + bias,
                    smooth=base.smooth, shift=o, bias=float(bias),
                    _shift_copies=copies)
