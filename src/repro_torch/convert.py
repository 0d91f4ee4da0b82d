"""Carry engine state and objectives across from numpy data.

The two packages share a state layout (``pop``, ``fit``, ``best_arg``,
``best_val``, and each policy's own keys: PSO's ``vel``, ``pbest``,
``pbest_f``; GA's ``age``, ``age_limit``, ``alive``; SA's step ``t``; EA's
``sigma``; FA's ``alpha``; a portfolio's unified ``alive``, ``aux_vec``,
``aux_ind``, ``aux_scl``; the async mailbox's ``mbox_*``, ``round_ctr``,
``stale_seen``), except that this port always keeps the island axis: a JAX single-island
state, which has none, gains one on the way in. A job-stacked state (the
jobs axis, ``(J, [I,] ...)`` in JAX) folds into the port's one leading
axis, ``(J·I, ...)`` (:func:`state_from_numpy`), and back
(:func:`state_to_jax`). With these a test starts both engines from one
state.

For the model stack, :func:`params_from_numpy`,
:func:`decode_state_from_numpy` and :func:`opt_state_from_numpy` carry a
JAX parameter pytree, decode state or Adam state (after
``jax.tree.map(np.asarray, ...)``) across leaf by leaf, dtype for dtype, so
both packages run on identical weights and moments.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.functions.benchmarks import (FUNCTIONS, Function,
                                              make_shifted_rosenbrock, on_device)
from repro_torch.optim.adam import AdamState

STATE_KEYS = ("pop", "fit", "best_arg", "best_val")
# Rank of each state key with the island axis.
_RANK = {"pop": 3, "fit": 2, "best_arg": 2, "best_val": 1, "vel": 3,
         "pbest": 3, "pbest_f": 2, "age": 2, "age_limit": 2, "alive": 2,
         "t": 1, "sigma": 1, "alpha": 1, "aux_vec": 4, "aux_ind": 3, "aux_scl": 2,
         "mbox_pop": 4, "mbox_fit": 3, "mbox_tag": 2, "mbox_head": 1,
         "round_ctr": 1, "stale_seen": 1}
# Keys that are not float32: the liveness mask and the mailbox's counters.
_DTYPE = {"alive": bool, "mbox_tag": np.int32, "mbox_head": np.int32,
          "round_ctr": np.int32, "stale_seen": np.int32}


def state_from_numpy(d: dict[str, Any], device: str | torch.device) -> dict:
    """Engine state from numpy arrays (either package's layout) on
    ``device``: every key of ``d`` the engines know, ``alive`` as bool,
    the mailbox's tags, heads and counters as int32 and the rest as
    float32. The JAX layout's leading axes, ``[J,] [I,] ...``
    (jobs of a ``minimize_many`` or ``BucketStepper`` state, islands), fold
    into the port's one, job-major; a state with neither gains it."""
    out = {}
    for k, v in d.items():
        if k not in _RANK:
            raise ValueError(f"unknown state key {k!r}")
        a = np.asarray(v, dtype=_DTYPE.get(k, np.float32))
        rest = _RANK[k] - 1
        if not rest <= a.ndim <= rest + 2:
            raise ValueError(f"state[{k!r}] has shape {a.shape}")
        a = a.reshape(-1, *a.shape[a.ndim - rest:])
        out[k] = torch.from_numpy(a.copy()).to(device)
    return out


def state_to_numpy(state: dict) -> dict[str, np.ndarray]:
    """Island-stacked numpy copies of the engine state."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


def state_to_jax(state: dict, n_islands: int, jobs: bool = False) -> dict[str, np.ndarray]:
    """The port's engine state -> numpy arrays in the JAX layout ``[J,]
    [I,] ...``: the job axis when ``jobs``, the island axis when
    ``n_islands > 1`` (the inverse of :func:`state_from_numpy`)."""
    lead = ((-1,) if jobs else ()) + ((n_islands,) if n_islands > 1 else ())
    out = {}
    for k, v in state.items():
        a = v.detach().cpu().numpy()
        if not lead and a.shape[0] != 1:
            raise ValueError(f"state[{k!r}] holds {a.shape[0]} islands, expected 1")
        out[k] = a.reshape(lead + a.shape[1:])
    return out


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


def _tensor(a: Any, device: str | torch.device) -> torch.Tensor:
    """A numpy array (bfloat16 included) as a tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def params_from_numpy(tree: Any, device: str | torch.device) -> Any:
    """Nested dicts of numpy arrays -> the same dicts of tensors on
    ``device``, each leaf keeping its dtype and shape."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def decode_state_from_numpy(d: dict[str, Any], device: str | torch.device) -> dict:
    """A decode state's numpy arrays -> the port's state: caches as tensors
    on ``device``, ``pos`` as a host integer."""
    return {k: int(np.asarray(v)) if k == "pos" else _tensor(v, device)
            for k, v in d.items()}


def opt_state_from_numpy(state: Any, device: str | torch.device):
    """The reference's ``AdamState`` (``step``, ``mu``, ``nu``; numpy leaves)
    -> ``repro_torch.optim.adam.AdamState`` on ``device``."""
    return AdamState(step=_tensor(state.step, device),
                     mu=params_from_numpy(state.mu, device),
                     nu=params_from_numpy(state.nu, device))
