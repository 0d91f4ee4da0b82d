"""The planning tools of the port: the count of a traced step
(``parallel.roofline``), the model kernels' meta routes (``kernels.meta``),
the dry-run (``launch.dryrun``) and its table (``launch.roofline_table``).

The count is held to the reference's ``rl.analyze`` on one product, to a
crafted set of collectives on a fake process group (the counterpart of the
reference's loop-aware HLO parser test), to a sharded product counted once
on its local shard, and to a closed form of a dense train step. The meta
routes are held to the kernels' work formulas, and their CPU routes to the
plain versions bit for bit. Every arch's ``train_4k`` cell is traced on
the 16 x 16 fake mesh at 2 layers (zamba2 at 6: its shared attention
follows every sixth layer), with one prefill, one decode, one long-context
and one multi-pod cell.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.parallel import roofline as jrl  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.kernels import (flash_attention as fa, flash_attention_bwd as fab,  # noqa: E402
                                 meta, ssd_scan as ss, ssd_scan_bwd as ssb)
from repro_torch.launch import dryrun, roofline_table  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models.transformer import remat_spans  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.parallel import roofline as rl  # noqa: E402
from repro_torch.parallel.sharding import param_shapes  # noqa: E402


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _mesh(shape, names):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=names)


# ---------------------------------------------------------------------------
# the count
# ---------------------------------------------------------------------------

def test_one_product_counts_the_reference_flops():
    x = jnp.ones((256, 256), jnp.float32)
    want = jrl.analyze(jax.jit(lambda a: a @ a).lower(x).compile())
    r = rl.analyze(lambda a: a @ a, _meta(256, 256, dtype=torch.float32))
    assert isinstance(r, rl.Roofline)
    assert r.flops == want.flops == 2 * 256 ** 3
    assert r.t_compute == r.flops / rl.PEAK_FLOPS_BF16 and r.t_memory > 0
    # a, a read and the product written, float32
    assert r.hbm_bytes == 3 * 256 * 256 * 4
    assert r.bottleneck == "memory" and r.coll_bytes == 0
    assert set(r.to_dict()) >= {"flops", "hbm_bytes", "bottleneck", "peak_bytes"}


def test_collectives_by_kind_on_a_fake_mesh():
    """12 all-reduces of 128 float32 and one all-gather of 16 to 256: the
    result bytes of each, 12*128*4 + 256*4, as the reference's parser
    counts a 12-trip loop's all-reduce and one all-gather."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    with dryrun.fake_world(16):
        mesh = _mesh((16,), ("data",))

        def step(x):
            for _ in range(12):
                x = fc.all_reduce(x, "sum", (mesh, 0))
            out = _meta(256, dtype=torch.float32)
            dist.all_gather_into_tensor(out, _meta(16, dtype=torch.float32),
                                        group=mesh.get_group(0))
            return x, out

        _, c = rl.trace(step, _meta(128, dtype=torch.float32))
    st = c.collectives()
    assert st.total_bytes == 12 * 128 * 4 + 256 * 4
    assert st.by_kind == {"all-gather": 256 * 4, "all-reduce": 12 * 128 * 4,
                          "reduce-scatter": 0, "all-to-all": 0, "collective-permute": 0}
    assert st.n_ops == 13
    r = c.roofline()
    assert r.coll_bytes == st.total_bytes and r.t_collective == st.total_bytes / rl.LINK_BW


def test_sharded_product_counted_once_on_the_local_shard():
    """DTensor's sharding propagation runs the global product on fake
    tensors; only the rank's own product counts."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with dryrun.fake_world(256):
        mesh = _mesh((16, 16), ("data", "model"))
        a = DTensor.from_local(_meta(256, 4096), mesh, [Shard(0), Replicate()],
                               run_check=False)
        b = DTensor.from_local(_meta(4096, 256), mesh, [Replicate(), Shard(1)],
                               run_check=False)
        out, c = rl.trace(lambda x, y: x @ y, a, b)
        assert tuple(out.to_local().shape) == (256, 256)
    assert c.flops == 2 * 256 * 4096 * 256
    assert c.hbm_bytes == 2 * (2 * 256 * 4096 + 256 * 256)
    assert c.peak_bytes == 2 * (2 * 256 * 4096 + 256 * 256)


def test_peak_follows_live_storages():
    def step(x):
        y = x * 2            # 4 KiB more
        z = y + 1            # 4 KiB more
        del y                # freed
        return z.sum()
    _, c = rl.trace(step, _meta(1024, dtype=torch.float32))
    assert c.peak_bytes == 3 * 4096
    assert c.live_bytes <= 4096 + 4


def test_dense_train_step_flops_closed_form():
    """llama3.2-1b at 2 layers, 8 x 512 tokens, unsharded on meta, donated:
    every product of the config, forward, remat's recompute and backward
    (two products each), the head likewise (its CE chunks are checkpoints
    too), and flash's own count (two forwards and a backward a layer).
    Remat's recompute stops at the last tensor the backward saves
    (``torch.utils.checkpoint``'s early stop), so each span's last product,
    the down projection, is not run again. Exact: every term is an integer
    below 2**53."""
    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=2)
    B, S = 8, 512
    params = param_shapes(cfg)
    batch = {"tokens": _meta(B, S, dtype=torch.int32), "labels": _meta(B, S, dtype=torch.int32)}
    _, c = rl.trace(make_train_step(cfg, donate=True), params, adam.init(params), batch)
    D, H, KV, hd, F, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff,
                          cfg.padded_vocab)
    T = B * S
    layer = 2 * D * H * hd + 2 * 2 * D * KV * hd + 2 * H * hd * D + 3 * 2 * D * F
    kept = S * (S + 1) // 2
    flash = B * H * hd * kept * (2 * 4 + 10)
    want = (4 * T * cfg.n_layers * layer + 4 * T * 2 * D * V + cfg.n_layers * flash
            - len(remat_spans(cfg)) * 2 * T * D * F)
    assert cfg.remat and cfg.tie_embeddings
    assert c.flops == want
    assert c.kernels["flash_attention"]["calls"] == 2 * cfg.n_layers
    assert c.kernels["flash_attention_bwd"]["calls"] == cfg.n_layers


# ---------------------------------------------------------------------------
# the model kernels' meta routes
# ---------------------------------------------------------------------------

def _brute_pairs(S, T, causal, window):
    i, j = np.arange(S)[:, None], np.arange(T)[None, :]
    ok = np.ones((S, T), bool)
    if causal:
        ok &= j <= i
    if window > 0:
        ok &= (i - j) < window
    return int(ok.sum())


@pytest.mark.parametrize("S,T,causal,window", [
    (64, 64, True, 0), (64, 64, True, 16), (48, 64, True, 0), (64, 48, True, 7),
    (64, 64, False, 0), (32, 64, False, 5), (1, 64, True, 0), (64, 1, True, 3)])
def test_kept_pairs(S, T, causal, window):
    assert meta.kept_pairs(S, T, causal, window) == _brute_pairs(S, T, causal, window)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 50.0)])
def test_flash_meta_route_counts_forward_and_backward(dtype, window, softcap):
    BH, S, hd = 6, 64, 32
    launches = (fa.LAUNCHES, fab.LAUNCHES)
    q, k, v = (_meta(BH, S, hd, dtype=dtype).requires_grad_(True) for _ in range(3))
    with rl.count() as c:
        out = fa.flash_attention(q, k, v, causal=True, window=window, softcap=softcap)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), _meta(BH, S, hd, dtype=dtype))
    assert out.shape == q.shape and out.dtype == dtype and out.device.type == "meta"
    assert all(g.shape == q.shape and g.dtype == dtype for g in (dq, dk, dv))
    size = torch.empty((), dtype=dtype).element_size()
    kept = _brute_pairs(S, S, True, window)
    assert c.kernels["flash_attention"] == {
        "calls": 1, "flops": 4.0 * BH * kept * hd,
        "bytes": float(size * 4 * BH * S * hd + 4 * BH * S)}
    assert c.kernels["flash_attention_bwd"] == {
        "calls": 1, "flops": 10.0 * BH * kept * hd,
        "bytes": float(size * 8 * BH * S * hd + 4 * BH * S)}
    # no gradient asked: no log-sum-exp written
    with rl.count() as c2:
        fa.flash_attention(q.detach(), k.detach(), v.detach(), window=window)
    assert c2.kernels["flash_attention"]["bytes"] == size * 4 * BH * S * hd
    assert (fa.LAUNCHES, fab.LAUNCHES) == launches


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_meta_route_counts_forward_and_backward(dtype):
    R, H, S, P, N = 2, 4, 128, 64, 64
    BH = R * H
    launches = (ss.LAUNCHES, ssb.LAUNCHES)
    xh = _meta(BH, S, P, dtype=dtype).requires_grad_(True)
    dt = _meta(BH, S, dtype=torch.float32).requires_grad_(True)
    A = _meta(BH, dtype=torch.float32).requires_grad_(True)
    Bm, Cm = (_meta(R, S, N, dtype=dtype).requires_grad_(True) for _ in range(2))
    with rl.count() as c:
        y = ss.ssd_scan(xh, dt, A, Bm, Cm, chunk=64)
        grads = torch.autograd.grad(y, (xh, dt, A, Bm, Cm), _meta(BH, S, P, dtype=dtype))
    assert y.shape == xh.shape and y.dtype == dtype
    assert [g.shape for g in grads] == [t.shape for t in (xh, dt, A, Bm, Cm)]
    size = torch.empty((), dtype=dtype).element_size()
    Q, nc = ss.TC_CHUNK, S // ss.TC_CHUNK
    assert c.kernels["ssd_scan"] == {
        "calls": 1,
        "flops": float(nc * Q * (Q + 1) * (R * N + BH * P) + BH * nc * 4 * Q * N * P),
        "bytes": float(size * (2 * BH * S * P + 2 * R * S * N) + 4 * BH * S + 4 * BH)}
    assert c.kernels["ssd_scan_bwd"] == {
        "calls": 1, "flops": 8.0 * BH * S * N * P,
        "bytes": float(size * (3 * BH * S * P + 4 * R * S * N) + 4 * (2 * BH * S + 2 * BH))}
    assert (ss.LAUNCHES, ssb.LAUNCHES) == launches


def test_meta_route_checks_inputs_as_the_card_does():
    with pytest.raises(ValueError, match="state size"):
        ss.ssd_scan(_meta(4, 64, 16), _meta(4, 64, dtype=torch.float32),
                    _meta(4, dtype=torch.float32), _meta(4, 64, 24), _meta(4, 64, 24), chunk=64)
    with pytest.raises(ValueError, match="head dims up to"):
        ss.ssd_scan(_meta(4, 64, 128).requires_grad_(True), _meta(4, 64, dtype=torch.float32),
                    _meta(4, dtype=torch.float32), _meta(4, 64, 16), _meta(4, 64, 16), chunk=64)
    with pytest.raises(ValueError, match="dimensions"):
        fa.flash_attention(_meta(2, 4, 8, 16), _meta(2, 4, 8, 16), _meta(2, 4, 8, 16))


def test_cpu_routes_stay_the_plain_versions():
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(4, 32, 16, generator=g) for _ in range(4))
    kw = dict(causal=True, window=8, softcap=30.0)
    assert torch.equal(fa.flash_attention(q, k, v, **kw), fa.flash_attention_ref(q, k, v, **kw))
    got = fab.flash_attention_bwd(q, k, v, None, do, None, **kw)
    for a, b in zip(got, fab.flash_attention_bwd_ref(q, k, v, do, **kw)):
        assert torch.equal(a, b)
    xh, dy = torch.randn(4, 32, 8, generator=g), torch.randn(4, 32, 8, generator=g)
    dt = torch.rand(4, 32, generator=g) * 0.1
    A = -torch.rand(4, generator=g)
    Bm, Cm = torch.randn(2, 32, 16, generator=g), torch.randn(2, 32, 16, generator=g)
    assert torch.equal(ss.ssd_scan(xh, dt, A, Bm, Cm, chunk=16), ss.ssd_ref(xh, dt, A, Bm, Cm))
    for a, b in zip(ssb.ssd_scan_bwd(xh, dt, A, Bm, Cm, dy),
                    ssb.ssd_scan_bwd_ref(xh, dt, A, Bm, Cm, dy)):
        assert torch.equal(a, b)


def test_meta_route_takes_each_ranks_shards():
    """Attention on DTensors split over batch (data) and heads (model):
    the kernel runs on the rank's own (batch, head) rows; under the
    sequence-parallel rule (q over model on the sequence) it runs on the
    rank's batch rows and every head."""
    from repro_torch.models import layers as L
    from repro_torch.parallel import ctx
    from repro_torch.parallel.sharding import P, Layout, placements_of
    from torch.distributed.tensor import DTensor
    B, S, H, hd = 32, 64, 32, 16
    kept = S * (S + 1) // 2
    with dryrun.fake_world(256):
        mesh = _mesh((16, 16), ("data", "model"))

        def dt(spec, local):
            return DTensor.from_local(_meta(*local), mesh, placements_of(mesh, P(*spec)),
                                      run_check=False)

        q, k, v = (dt(("data", None, "model", None), (2, S, 2, hd)) for _ in range(3))
        with rl.count() as c:
            out = L._attend_flash(q, k, v, 0, 0.0)
        assert tuple(out.to_local().shape) == (2, S, 2, hd)
        assert c.kernels["flash_attention"]["flops"] == 4.0 * (2 * 2) * kept * hd
        seq = Layout(mesh, placements_of(mesh, P("data", "model", None, None)))
        with ctx.sharding_rules(attn_seq_q=seq), rl.count() as c:
            q2 = ctx.constrain(q, "attn_seq_q")
            L._attend_flash(q2, k, v, 0, 0.0)
        assert c.kernels["flash_attention"]["flops"] == 4.0 * (2 * H) * kept * hd


# ---------------------------------------------------------------------------
# the dry-run
# ---------------------------------------------------------------------------

def _check_record(rec, arch, shape, mesh, kind):
    assert rec["status"] == "ok"
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["kind"]) == (arch, shape, mesh, kind)
    assert rec["n_chips"] == (512 if mesh == "2x16x16" else 256)
    p = rec["per_device"]
    assert set(p) == {"flops", "hbm_bytes", "coll_bytes", "t_compute", "t_memory",
                      "t_collective", "bottleneck", "peak_bytes"}
    assert p["flops"] > 0 and p["hbm_bytes"] > 0 and p["peak_bytes"] > 0
    assert p["bottleneck"] in ("compute", "memory", "collective")
    assert p["coll_bytes"] == sum(rec["collectives"].values())
    m = rec["memory"]
    assert m["peak_bytes_traced"] == p["peak_bytes"]
    assert m["argument_bytes"] + m["output_bytes"] + m["temp_bytes"] - m["alias_bytes"] \
        == pytest.approx(m["peak_bytes_traced"])
    assert m["analytic_bytes"]["total"] == pytest.approx(
        sum(v for k, v in m["analytic_bytes"].items() if k != "total"))
    assert m["fits_80GB_analytic"] == (m["analytic_bytes"]["total"] < 80e9)
    json.dumps(rec)


def _depth(arch):
    cfg = get_config(arch)
    return cfg.shared_attn_every if cfg.block_pattern == "ssm+shared_attn" else 2


@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_4k_every_arch(arch):
    """Every arch's train step on 16 x 16 at 2 layers (gemma2: one local,
    one global layer), zamba2 at 6 (one shared-attention application), as
    the reference's ``--set n_layers=`` allows."""
    cfg = get_config(arch)
    rec = dryrun.lower_cell(arch, "train_4k", False, {"n_layers": _depth(arch)})
    _check_record(rec, arch, "train_4k", "16x16", "train")
    if cfg.block_pattern != "ssm":
        assert rec["kernels"]["flash_attention_bwd"]["calls"] >= 1
    if cfg.block_pattern != "attn":
        assert rec["kernels"]["ssd_scan_bwd"]["calls"] == _depth(arch)


@pytest.mark.parametrize("arch,shape,multi_pod,kind", [
    ("musicgen-medium", "prefill_32k", False, "prefill"),
    ("llama3.2-1b", "decode_32k", False, "decode"),
    ("mamba2-370m", "long_500k", False, "decode"),
    ("llama4-scout-17b-a16e", "prefill_32k", True, "prefill")])
def test_other_cells(arch, shape, multi_pod, kind):
    """A prefill, a decode at the cache's last position, a long-context
    decode, and a multi-pod cell whose MoE buffers' rule (16 token groups
    over the 32 ranks of pod x data) does not divide and is left out."""
    rec = dryrun.lower_cell(arch, shape, multi_pod, {"n_layers": 2})
    _check_record(rec, arch, shape, "2x16x16" if multi_pod else "16x16", kind)


def test_rule_that_does_not_divide_is_left_out():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.parallel import ctx
    from repro_torch.parallel.sharding import Layout
    with dryrun.fake_world(512):
        mesh = _mesh((32, 16), ("data", "model"))
        x = DTensor.from_local(_meta(16, 8), mesh, [Replicate(), Replicate()], run_check=False)
        y = DTensor.from_local(_meta(64, 8), mesh, [Replicate(), Replicate()], run_check=False)
        split = Layout(mesh, (Shard(0), Replicate()))
        with ctx.sharding_rules(moe_eb=split):
            assert ctx.constrain(x, "moe_eb") is x
            assert tuple(ctx.constrain(y, "moe_eb").placements) == (Shard(0), Replicate())


def test_flat_multi_pod_specs():
    from repro_torch.parallel.sharding import P
    assert dryrun._flat(P(("pod", "data"), None, "model")) == P("data", None, "model")
    assert dryrun._flat(P(None, ("pod", "data", "model"))) == P(None, ("data", "model"))
    assert dryrun._flat(P("model", None)) == P("model", None)
    with pytest.raises(ValueError):
        dryrun._flat(P("pod", None))


def test_parse_overrides_as_the_reference():
    """The reference's parser (``repro.launch.dryrun``, not imported here:
    it sets XLA's host device count at import): int, then float, then a
    boolean word, else the string."""
    sets = ["n_layers=2", "capacity_factor=1.5", "remat=false", "sharding_mode=dp+zero1",
            "x=True"]
    assert dryrun._parse_overrides(sets) == {
        "n_layers": 2, "capacity_factor": 1.5, "remat": False,
        "sharding_mode": "dp+zero1", "x": True}
    assert dryrun._parse_overrides(None) == {}


def test_cli_writes_records_and_the_table(tmp_path, monkeypatch, capsys):
    """The CLI in a process of its own (``-X importtime`` lists every module
    it imports: neither jax nor the reference package among them), then a
    skipped cell in this process, then the table of both."""
    out = tmp_path / "dry"
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-370m", "--shape", "long_500k", "--out", str(out), "--set", "n_layers=2"],
        capture_output=True, text=True, check=True, env={**os.environ, "PYTHONPATH": "src"})
    assert "== dry-run: 1 ok / 0 skip / 0 FAIL ==" in proc.stdout
    imported = {ln.rsplit("|", 1)[-1].strip() for ln in proc.stderr.splitlines()
                if ln.startswith("import time:")}
    assert "repro_torch.parallel.roofline" in imported
    assert not [m for m in imported if m.split(".")[0] in ("jax", "repro")]
    rec = json.loads((out / "mamba2-370m__long_500k__16x16.json").read_text())
    _check_record(rec, "mamba2-370m", "long_500k", "16x16", "decode")
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "llama3.2-1b", "--shape",
                                      "long_500k", "--out", str(out), "--tag", "_t"])
    dryrun.main()
    assert "== dry-run: 0 ok / 1 skip / 0 FAIL ==" in capsys.readouterr().out
    skip = json.loads((out / "llama3.2-1b__long_500k__16x16_t.json").read_text())
    assert skip["status"] == "skip" and "sub-quadratic" in skip["reason"]
    roofline_table.main(["--dir", str(out)])
    table = capsys.readouterr().out
    assert table.count("| mamba2-370m |") == 1 and "skipped cells (1)" in table
    assert "MODEL/counted flops" in table
