"""The test process's side of the sharded-training tests of
``test_torch_sharded_train_archs.py`` and ``test_torch_sharded_train_moe.py``:
one spawn of 2 gloo ranks running a table of cases through
``_torch_sharding_cases.run_all`` (each rank's collectives and the token
groups each MoE dispatch took recorded) while this process takes the
unsharded references: the reference's ``repro.launch.steps.make_train_step``
(jitted) and the port's, from the same ``init_params(PRNGKey(0))`` weights
(carried to JAX as numpy) and the stream's first batch.

The reference's steps are compiled with LLVM at its lowest optimisation
level (:data:`XLA_OPTIONS`): the same HLO, compiled in about a third of
the time (zamba2's step 7.3 s against 2.8 on an 8-core CPU host).
"""
import concurrent.futures

import numpy as np
import torch

import jax
import jax.numpy as jnp
from test_torch_sharded_train import _check_step, _flat, _local_shape

import _torch_sharding_cases as cases
from repro.configs import get_config as jget
from repro.launch import steps as jsteps
from repro.optim import adam as jadam
from repro_torch import prng
from repro_torch.configs import get_config
from repro_torch.core import mesh as cmesh
from repro_torch.data import to_device
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.optim import adam as tadam

DEADLINE = 600.0
XLA_OPTIONS = {"xla_backend_optimization_level": 0}
# The global batch at which ``batch_specs`` splits the batch over ``data``
# (a multiple of the production mesh's 16).
BATCH = {"global_batch": 16}
check_step = _check_step
local_shape = _local_shape


def ref_key(table: dict, name: str):
    """Cases that share their unsharded reference (it does not depend on
    the sharding mode or the mesh)."""
    arch, _, _, over = table[name]
    return arch, tuple(sorted(over.items()))


def _jax_cfg(arch, over):
    """The reference's reduced config with the port's overrides
    (``cases.config``'s widths for the attention archs)."""
    wide = cases.WIDE if get_config(arch).block_pattern == "attn" else {}
    return jget(arch).reduced(**{**wide, **over})


def _reference(key, with_jax: bool):
    """(JAX, port) unsharded one-step results of one reference key (the
    port's alone without ``with_jax``), and the smallest gap between a
    token's K-th and (K+1)-th router probabilities in the port's step
    (None without MoE)."""
    arch, over = key[0], dict(key[1])
    acfg = cases.ACFG
    tc = cases.config(arch, None, **over)
    tp = TT.init_params(prng.PRNGKey(0), tc)
    nb = cases.first_batch(tc)
    out = {}
    if with_jax:
        jp = jax.tree.map(jnp.asarray, TT.tree_map(lambda t: t.numpy(), tp))
        args = (jp, jadam.init(jp), {k: jnp.asarray(v) for k, v in nb.items()})
        step = jax.jit(jsteps.make_train_step(_jax_cfg(arch, over), jadam.AdamConfig(**acfg)))
        jnew, jopt, jm = step.lower(*args).compile(compiler_options=XLA_OPTIONS)(*args)
        out["jax"] = {"metrics": {k: float(v) for k, v in jm.items()},
                      "params": dict(_flat(jax.tree.map(np.asarray, jnew))),
                      "mu": dict(_flat(jax.tree.map(np.asarray, jopt.mu))),
                      "nu": dict(_flat(jax.tree.map(np.asarray, jopt.nu)))}
    gaps = []

    def hook(probs, eidx):
        top = torch.sort(probs.detach(), -1, descending=True).values
        gaps.append(float((top[..., tc.top_k - 1] - top[..., tc.top_k]).min()))
        return eidx

    TL.ROUTING_HOOK = hook if tc.num_experts else None
    try:
        tnew, topt, tm = tsteps.make_train_step(tc, tadam.AdamConfig(**acfg))(
            tp, tadam.init(tp), to_device(nb, "cpu"))
    finally:
        TL.ROUTING_HOOK = None
    out["port"] = {"metrics": {k: float(v) for k, v in tm.items()},
                   "params": {k: v.detach().numpy() for k, v in cases.leaves(tnew)},
                   "mu": {k: v.numpy() for k, v in cases.leaves(topt.mu)},
                   "nu": {k: v.numpy() for k, v in cases.leaves(topt.nu)}}
    out["gap"] = min(gaps) if gaps else None
    return out


def run_cases(table: dict, port_only: list, dispatch: bool = False) -> tuple[dict, dict]:
    """(rank 0's results: the steps by case, with ``dispatch``
    ``_torch_sharding_cases.dispatch_bits``; references by
    :func:`ref_key`): the spawn running every case of ``table`` and the
    references at once, the references in a thread of this process; the
    cases in ``port_only`` (1-rank meshes, held to the port's bits) take no
    JAX reference."""
    names = list(table)
    jax_keys = {ref_key(table, n) for n in names if n not in port_only}

    def references():
        return {key: _reference(key, key in jax_keys)
                for key in dict.fromkeys(ref_key(table, n) for n in names)}

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        refs = pool.submit(references)
        ranks = cmesh.spawn(2, cases.run_all, names, None, "cpu", table, True, dispatch,
                            timeout=DEADLINE)
        return ranks, refs.result()


def check_local_shapes(got: dict) -> None:
    """Each rank holds the shards its spec gives."""
    mesh = got["mesh"]
    assert len(got["local_shapes"]) == mesh["data"] * mesh["model"]
    for shapes in got["local_shapes"]:
        for leaf, shape in got["global_shapes"].items():
            assert shapes[leaf] == _local_shape(shape, got["specs"][leaf], mesh), leaf


def check_bits(got: dict, want: dict) -> None:
    """The loss, params and moments bit for bit."""
    assert got["metrics"]["loss"] == want["metrics"]["loss"]
    for part in ("params", "mu", "nu"):
        for leaf, w in want[part].items():
            assert got[part][leaf].tobytes() == w.tobytes(), (part, leaf)
