"""The port's training path against the JAX package's: the synthetic stream,
``loss_fn`` with its gradient, remat, and one ``make_train_step``.

Both packages run the reduced configs of all ten archs in float32 on the
same weights (the JAX parameter pytree carried across with
``convert.params_from_numpy``) and the same batches (the JAX stream's). On
the CPU the port's attention and SSD scan run the plain versions of its
kernels, which autograd differentiates; the JAX model differentiates its
XLA paths. The loss is held to 1e-5 of its value and every gradient leaf
to 1e-4 of that leaf's largest |value| (the same functions summed in
another order, through a few layers).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402

LOSS_TOL = 1e-5     # relative
GRAD_TOL = 1e-4     # of each leaf's largest |value|
ARCH_LIST = sorted(ARCHS)


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


def _cfgs(arch, **over):
    return jget(arch).reduced(**over), get_config(arch).reduced(**over)


def _leaves(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{pre}/{k}")
    else:
        yield pre, tree


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _leaf_err(got, want):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.max(np.abs(g - w))) / max(float(np.max(np.abs(w))), 1e-30)


def _setup(arch, **over):
    """(JAX cfg, port cfg, JAX params, port params, JAX batch, port batch):
    the port's init_params(PRNGKey(0)) (within a few ulps of the
    reference's; tests/test_torch_models.py), the same values in both
    packages, and the JAX stream's first batch."""
    jc, tc = _cfgs(arch, **over)
    tp = TT.init_params(prng.PRNGKey(0), tc)
    jp = jax.tree.map(jnp.asarray, TT.tree_map(lambda t: t.numpy(), tp))
    nb = next(jdata.SyntheticStream(jc))
    return (jc, tc, jp, tp, {k: jnp.asarray(v) for k, v in nb.items()},
            tdata.to_device(nb, "cpu"))


def _port_value_and_grad(tp, tc, batch):
    leaves = dict(_leaves(tp))
    for t in leaves.values():
        t.requires_grad_(True)
    loss, metrics = TT.loss_fn(tp, tc, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss, metrics, dict(zip(leaves, grads))


@pytest.mark.parametrize("arch", ARCH_LIST)
def test_stream_batches_equal_jax(arch):
    """The port's stream is the reference's, bit for bit (LM, VLM with its
    -100 labels under the patches, audio frames), and so is its cursor."""
    jc, tc = _cfgs(arch)
    js, ts = jdata.SyntheticStream(jc), tdata.SyntheticStream(tc)
    for _ in range(3):
        jb, tb = next(js), next(ts)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype and np.array_equal(jb[k], tb[k]), k
    assert ts.state_dict() == js.state_dict()
    if tc.frontend == "vlm_stub":
        assert (tb["labels"][:, :tc.frontend_len] == -100).all()
    moved = tdata.to_device(tb, "cpu")
    assert all(np.array_equal(moved[k].numpy(), tb[k]) for k in tb)


def test_stream_cursor_restores_and_checks_its_seed():
    cfg = get_config("llama3.2-1b").reduced()
    a = tdata.SyntheticStream(cfg)
    next(a), next(a)
    b = tdata.SyntheticStream(cfg)
    b.load_state_dict(a.state_dict())
    assert all(np.array_equal(x, y) for x, y in zip(next(a).values(), next(b).values()))
    other = tdata.SyntheticStream(cfg, tdata.DataConfig(seed=3))
    with pytest.raises(ValueError, match="seed"):
        other.load_state_dict(a.state_dict())


@pytest.mark.parametrize("arch", ARCH_LIST)
def test_loss_and_every_grad_leaf_match_jax(arch):
    jc, tc, jp, tp, jb, tb = _setup(arch)
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p: JT.loss_fn(p, jc, jb),
                                              has_aux=True))(jp)
    tp = TT.tree_map(lambda t: t.clone(), tp)
    loss, metrics, grads = _port_value_and_grad(tp, tc, tb)
    assert abs(float(loss.detach()) - float(jl)) <= LOSS_TOL * abs(float(jl))
    assert abs(float(metrics["aux"]) - float(jm["aux"])) <= LOSS_TOL * abs(float(jl))
    want = dict(_leaves(jax.tree.map(np.asarray, jg)))
    assert sorted(want) == sorted(grads)
    for name, w in want.items():
        g = grads[name]
        if not np.any(w):
            assert g is None or not bool(g.abs().max() > 0), name
            continue
        assert _leaf_err(g, w) < GRAD_TOL, name


@pytest.mark.parametrize("arch", ARCH_LIST)
def test_remat_grads_equal_plain(arch):
    """remat=True (each layer group and each CE chunk recomputed in the
    backward) gives the gradient of remat=False, bit for bit on the CPU;
    zamba2's groups include its shared-attention applications."""
    over = {"n_layers": 5} if get_config(arch).block_pattern == "ssm+shared_attn" else {}
    _, tc, _, tp, _, tb = _setup(arch, **over)
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tc, remat=remat)
        params = TT.tree_map(lambda t: t.detach().clone(), tp)
        out[remat] = _port_value_and_grad(params, cfg, tb)
    assert torch.equal(out[True][0], out[False][0])
    for name, g in out[False][2].items():
        h = out[True][2][name]
        assert (g is None and h is None) or torch.equal(g, h), name


def test_remat_spans_follow_the_reference_groups():
    llama = get_config("llama3.2-1b")
    assert TT.remat_spans(llama) == [(i, i + 2) for i in range(0, 16, 2)]
    assert TT.remat_spans(dataclasses.replace(llama, n_layers=5)) == [
        (i, i + 1) for i in range(5)]
    zamba = get_config("zamba2-7b")     # 13 groups of 6 and a tail of 3 layers
    spans = TT.remat_spans(zamba)
    assert spans[:13] == [(6 * g, 6 * g + 6) for g in range(13)]
    assert spans[13:] == [(78, 79), (79, 80), (80, 81)]


def test_make_train_step_matches_jax():
    """One step from the same params and moments: the loss, the gradient
    norm, the moments (mu within 1e-4 of each leaf's largest |mu|, nu within
    2e-4, as the square of a gradient within 1e-4) and the params. Adam's
    first step moves each element by lr * g / (|g| + eps), so an element
    whose gradient is a rounding away from 0 may move by up to 2 lr the
    other way; elsewhere the params agree within 1e-3 lr."""
    jc, tc, jp, tp, jb, tb = _setup("llama3.2-1b")
    acfg = dict(lr=1e-3, warmup_steps=2, total_steps=10, weight_decay=0.01)
    jo = jadam.init(jp)
    jnew, jopt, jm = jax.jit(jsteps.make_train_step(jc, jadam.AdamConfig(**acfg)))(jp, jo, jb)
    topt = convert.opt_state_from_numpy(jax.tree.map(np.asarray, jo), "cpu")
    tnew, tnopt, tm = tsteps.make_train_step(tc, tadam.AdamConfig(**acfg))(tp, topt, tb)
    for k in ("loss", "ce", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= LOSS_TOL * abs(float(jm[k])), k
    assert int(tnopt.step) == int(jopt.step) == 1
    lr0 = float(tadam.schedule(torch.zeros((), dtype=torch.int32), tadam.AdamConfig(**acfg)))
    jg = dict(_leaves(jax.tree.map(np.asarray, jopt.mu)))
    for tree_t, tree_j, tol in ((tnopt.mu, jopt.mu, 1e-4), (tnopt.nu, jopt.nu, 2e-4)):
        want = dict(_leaves(jax.tree.map(np.asarray, tree_j)))
        for name, t in _leaves(tree_t):
            if np.any(want[name]):
                assert _leaf_err(t, want[name]) < tol, name
            else:
                assert not bool(t.abs().max() > 0), name
    want = dict(_leaves(jax.tree.map(np.asarray, jnew)))
    for name, t in _leaves(tnew):
        g = np.abs(jg[name])
        clear = g > 1e-4 * max(float(g.max()), 1e-30)
        d = np.abs(_np(t) - want[name].astype(np.float64))
        assert float(d[clear].max(initial=0.0)) <= 1e-3 * lr0, name
        assert float(d.max(initial=0.0)) <= 2 * lr0 * (1 + 1e-3), name
