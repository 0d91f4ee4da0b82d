"""Sharded training over 2 gloo ranks on the CPU against the unsharded
step, the JAX package's and the port's.

One module-scoped spawn runs every case of ``tests/_torch_sharding_cases.py``
(``STEP_CASES``: a reduced llama3.2-1b at 16 heads, so the heads divide the
model axis, at (1, 2) and (2, 1) in each sharding mode, at (2, 1) with the
batch sharded over ``data``, a 1-rank (1, 1) mesh; a reduced mamba2-370m at
(1, 2); a reduced granite-3-8b under tp+fsdp at (2, 1)), then the
launcher's resume drills. Meanwhile this process takes the references: the
reference's unsharded ``repro.launch.steps.make_train_step`` (jitted) and
the port's, from the same ``init_params(PRNGKey(0))`` weights (carried to
JAX as numpy) and the stream's first batch.

Bounds (PERF.md §2, float32 training): the loss within 1e-5 relative; the
first moment, the clipped gradient times 1 - b1, within 1e-4 of each
leaf's largest, the second within 2e-4; the params after one Adam update
within 1e-3 lr where the gradient is clear of 0, else 2 lr.
"""
import concurrent.futures
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_sharding_cases as cases  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import mesh as cmesh  # noqa: E402
from repro_torch.data import to_device  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402

LOSS_TOL = 1e-5
MU_TOL, NU_TOL = 1e-4, 2e-4
DEADLINE = 600.0
NAMES = list(cases.STEP_CASES)


def _ref_key(name):
    """Cases that share their unsharded reference (it does not depend on
    the sharding mode or the mesh)."""
    arch, _, _, over = cases.STEP_CASES[name]
    return arch, tuple(sorted(over.items()))


def _jax_cfg(tc):
    """The reference's reduced config with the port's overrides."""
    fields = ("n_heads", "d_model", "n_kv_heads", "global_batch", "ce_chunks")
    return jget(tc.name).reduced(**{k: getattr(tc, k) for k in fields})


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{pre}/{k}")
    else:
        yield pre, np.asarray(tree, dtype=np.float64) if not isinstance(tree, torch.Tensor) \
            else tree.detach().double().numpy()


def _references():
    """(JAX, port) unsharded one-step results per reference key."""
    acfg = cases.ACFG
    out = {}
    for key in dict.fromkeys(_ref_key(n) for n in NAMES):
        arch, over = key[0], dict(key[1])
        tc = cases.config(arch, None, **over)
        tp = TT.init_params(prng.PRNGKey(0), tc)
        nb = cases.first_batch(tc)
        jp = jax.tree.map(jnp.asarray, TT.tree_map(lambda t: t.numpy(), tp))
        jnew, jopt, jm = jax.jit(jsteps.make_train_step(_jax_cfg(tc), jadam.AdamConfig(**acfg)))(
            jp, jadam.init(jp), {k: jnp.asarray(v) for k, v in nb.items()})
        tnew, topt, tm = tsteps.make_train_step(tc, tadam.AdamConfig(**acfg))(
            tp, tadam.init(tp), to_device(nb, "cpu"))
        out[key] = {
            "jax": {"metrics": {k: float(v) for k, v in jm.items()},
                    "params": dict(_flat(jax.tree.map(np.asarray, jnew))),
                    "mu": dict(_flat(jax.tree.map(np.asarray, jopt.mu))),
                    "nu": dict(_flat(jax.tree.map(np.asarray, jopt.nu)))},
            "port": {"metrics": {k: float(v) for k, v in tm.items()},
                     "params": {k: v.detach().numpy() for k, v in cases.leaves(tnew)},
                     "mu": {k: v.numpy() for k, v in cases.leaves(topt.mu)},
                     "nu": {k: v.numpy() for k, v in cases.leaves(topt.nu)}},
        }
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(rank 0's results, references): the spawn and the references at
    once, the references in a thread of this process."""
    root = tmp_path_factory.mktemp("sharded_train")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        refs = pool.submit(_references)
        ranks = cmesh.spawn(2, cases.run_all, NAMES, str(root), timeout=DEADLINE)
        return ranks, refs.result()


@functools.lru_cache(maxsize=None)
def _lr0():
    return float(tadam.schedule(torch.zeros((), dtype=torch.int32),
                                tadam.AdamConfig(**cases.ACFG)))


def _rel_leaf(got, want):
    w = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - w))) / max(float(np.max(np.abs(w))), 1e-30)


def _check_step(got, want):
    for k in ("loss", "ce", "grad_norm"):
        assert abs(got["metrics"][k] - want["metrics"][k]) <= LOSS_TOL * abs(want["metrics"][k]), k
    for part, tol in (("mu", MU_TOL), ("nu", NU_TOL)):
        for name, w in want[part].items():
            if np.any(w):
                assert _rel_leaf(got[part][name], w) < tol, (part, name)
            else:
                assert not np.any(got[part][name]), (part, name)
    lr0 = _lr0()
    for name, w in want["params"].items():
        g = np.abs(np.asarray(want["mu"][name], np.float64))
        clear = g > 1e-4 * max(float(g.max()), 1e-30)
        d = np.abs(np.asarray(got["params"][name], np.float64) - np.asarray(w, np.float64))
        assert float(d[clear].max(initial=0.0)) <= 1e-3 * lr0, name
        assert float(d.max(initial=0.0)) <= 2 * lr0 * (1 + 1e-3), name


@pytest.mark.parametrize("name", NAMES)
def test_sharded_step_matches_the_reference(run, name):
    """The sharded step against the reference's unsharded jitted step."""
    ranks, refs = run
    got = ranks["steps"][name]
    assert got["step"] == 1
    _check_step(got, refs[_ref_key(name)]["jax"])


@pytest.mark.parametrize("name", NAMES)
def test_sharded_step_matches_the_ports_unsharded_step(run, name):
    ranks, refs = run
    _check_step(ranks["steps"][name], refs[_ref_key(name)]["port"])


def _local_shape(shape, spec, mesh):
    out = list(shape)
    for i, part in enumerate(spec):
        for ax in (() if part is None else part if isinstance(part, tuple) else (part,)):
            out[i] //= mesh[ax]
    return tuple(out)


@pytest.mark.parametrize("name", NAMES)
def test_each_rank_holds_the_shards_its_spec_gives(run, name):
    ranks, _ = run
    got = ranks["steps"][name]
    mesh = got["mesh"]
    assert len(got["local_shapes"]) == mesh["data"] * mesh["model"]
    for shapes in got["local_shapes"]:
        for leaf, shape in got["global_shapes"].items():
            assert shapes[leaf] == _local_shape(shape, got["specs"][leaf], mesh), leaf


def test_tp_fsdp_halves_each_ranks_masters_and_moments(run):
    """Under tp+fsdp at data = 2 each rank keeps half of every matrix; the
    replicated vectors (norm scales) are the rest."""
    ranks, _ = run
    got = ranks["steps"]["llama_tp+fsdp_2x1"]
    full = sum(int(np.prod(s)) * 4 for s in got["global_shapes"].values())
    vectors = sum(int(np.prod(s)) * 4 for k, s in got["global_shapes"].items()
                  if len(s) - (k.startswith("/layers/")) <= 1)
    for p, m in zip(got["param_bytes"], got["moment_bytes"]):
        assert p == (full - vectors) // 2 + vectors
        assert m == 2 * p
    g = ranks["steps"]["granite_tp+fsdp_2x1"]
    assert all(p < 0.51 * sum(int(np.prod(s)) * 4 for s in g["global_shapes"].values())
               for p in g["param_bytes"])


def test_one_rank_mesh_gives_the_unsharded_bits(run):
    ranks, refs = run
    got = ranks["steps"]["llama_tp_1x1"]
    want = refs[_ref_key("llama_tp_1x1")]["port"]
    assert got["metrics"]["loss"] == want["metrics"]["loss"]
    for part in ("params", "mu", "nu"):
        for name, w in want[part].items():
            assert got[part][name].tobytes() == w.tobytes(), (part, name)


def _same_bits(a, b):
    return all(a[k].tobytes() == b[k].tobytes() for k in a) and set(a) == set(b)


def test_same_mesh_resume_is_bit_identical(run):
    """4 steps in one call against a fresh call resumed from its step-2
    checkpoint to 4, both on (1, 2)."""
    d = run[0]["drills"]
    (p_whole, mu_whole, l_whole), (p_same, mu_same, l_same) = d["whole"], d["same"]
    assert l_same == l_whole[2:]
    assert _same_bits(p_same, p_whole) and _same_bits(mu_same, mu_whole)


def test_elastic_restore_returns_the_saved_leaves(run):
    """The (1, 2) run's step-2 checkpoint restored onto (2, 1): every leaf
    gathered back is the saved leaf's bits, and each rank holds its shard."""
    d = run[0]["drills"]
    by_path = {"/" + n[2:-2].replace("']['", "/"): v for n, v in d["saved"].items()}
    assert set(d["restored_other"]) == set(by_path)
    for name, v in d["restored_other"].items():
        assert v.tobytes() == by_path[name].tobytes(), name
    # saved vocab-sharded over model = 2, restored whole on (2, 1) under tp
    assert d["restored_local_shape"] == by_path["/params/embed"].shape


def test_resume_on_another_mesh_and_on_no_mesh_stays_within_the_bound(run):
    d = run[0]["drills"]
    l_whole = d["whole"][2]
    for k in ("other", "none"):
        losses = d[k][2]
        assert len(losses) == 2, k
        for a, b in zip(losses, l_whole[2:]):
            assert abs(a - b) <= LOSS_TOL * abs(b), (k, a, b)


def test_sharded_checkpoint_manifest_is_the_unsharded_one(run):
    """The names, shapes and dtypes a sharded run writes are what an
    unsharded run writes: the leaves are saved whole."""
    d = run[0]["drills"]
    cfg = cases.config(*cases.TRAIN_ARCH[:2])
    p = TT.init_params(prng.PRNGKey(0, "meta"), cfg)
    want = {f"['params']{''.join(f'[{k!r}]' for k in n.strip('/').split('/'))}":
            (list(t.shape), str(t.dtype).replace("torch.", "")) for n, t in cases.leaves(p)}
    got = {n: (s, dt) for n, s, dt in d["manifest"]}
    for n, v in want.items():
        assert got[n] == v, n
    assert len(got) == 3 * len(want) + 1     # params, mu, nu and the step
