"""The port's kernel-configuration layer (``kernels.autotune``): the model
with the H100's constants, the candidates a block admits, the per-shape-
class cache, the threaded ``KernelConfig`` and the measured sweep.

Counterparts of ``tests/test_autotune.py``'s tests. The tuner chooses for a
card: these tests give it the H100's SM count by hand
(``roofline.Card``), as ``roofline.card_of`` reads it from a device on the
card. The ``gpu`` tests launch the real kernels.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import core as tcore  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import de as tde  # noqa: E402
from repro_torch.core import executor as texec  # noqa: E402
from repro_torch.core import ga as tga  # noqa: E402
from repro_torch.core import pso as tpso  # noqa: E402
from repro_torch.core import sa as tsa  # noqa: E402
from repro_torch.functions import benchmarks as tbm  # noqa: E402
from repro_torch.kernels import autotune as at  # noqa: E402
from repro_torch.kernels import bench_eval as be  # noqa: E402
from repro_torch.kernels import pso_step as ps  # noqa: E402
from repro_torch.kernels.autotune import KernelConfig  # noqa: E402
from repro_torch.parallel import memmodel  # noqa: E402
from repro_torch.parallel import roofline as rl  # noqa: E402

H100 = rl.Card("NVIDIA H100 80GB HBM3", (9, 0), 132)
KINDS = tuple(at.KIND_PROFILES)
ROW_KINDS = tuple(k for k in KINDS if k != "pso_step")
# Table I's rows and its chunk, 8 islands, the polish batch, GA's waves,
# odd sizes, scalar slots and rows past the staging cap.
SHAPES = [(800, 1000), (100, 1000), (6400, 1000), (8000, 1000), (200, 1000), (8, 1000),
          (37, 50), (5, 1), (100, 1001), (16, 4100)]


@pytest.fixture(autouse=True)
def _fresh_cache():
    at.clear_cache()
    yield
    at.clear_cache()


def _geo(vec=True, W=4, R=1, dtype="float32"):
    return KernelConfig(vec=vec, warps_per_row=W, rows_per_block=R, dtype=dtype)


# --- the model ---------------------------------------------------------------

def test_profiles_and_weights_are_the_references():
    jat = pytest.importorskip("repro.kernels.autotune")
    assert {k: dataclasses.asdict(v) for k, v in at.KIND_PROFILES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jat.KIND_PROFILES.items()}
    assert at.EVAL_FLOPS == jat.EVAL_FLOPS


def test_card_constants():
    assert (rl.HBM_BW, rl.PEAK_FLOPS_F32, rl.PEAK_FLOPS_BF16) == (3.35e12, 67e12, 989e12)
    assert rl.LAUNCH_FLOOR_S == 2.21e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predict_roofline_terms_consistent(dtype):
    p = at.predict("de_step", 128, 1000, _geo(dtype=dtype), tag="rastrigin", card=H100)
    r = p.roofline
    assert isinstance(r, rl.Roofline)
    prof, isz = at.KIND_PROFILES["de_step"], 2 if dtype == "bfloat16" else 4
    assert r.flops == 128 * 1000 * (at.EVAL_FLOPS["rastrigin"] + prof.var_flops)
    assert r.hbm_bytes == ((prof.vec_in + prof.vec_out) * 128 * 1000 * isz
                           + prof.row * 128 * 4 + prof.bcast * 1000 * isz)
    assert r.t_compute == pytest.approx(r.flops / rl.PEAK_FLOPS_F32)
    assert r.t_memory == pytest.approx(r.hbm_bytes / rl.HBM_BW)
    assert r.bottleneck in ("compute", "memory")
    assert p.t_total >= rl.LAUNCH_FLOOR_S + max(r.t_compute, r.t_memory)
    assert r.peak_bytes == p.footprint.smem_bytes == be.SMEM_BYTES
    assert set(r.to_dict()) >= {"flops", "hbm_bytes", "bottleneck", "peak_bytes"}


def test_bf16_halves_the_population_bytes():
    f32 = at.predict("bench_eval", 800, 1000, _geo(), "sphere", card=H100).roofline
    bf16 = at.predict("bench_eval", 800, 1000, _geo(dtype="bfloat16"), "sphere",
                      card=H100).roofline
    assert bf16.hbm_bytes == 800 * 1000 * 2 + 800 * 4 + 1000 * 2
    assert f32.hbm_bytes == 800 * 1000 * 4 + 800 * 4 + 1000 * 4
    assert bf16.flops == f32.flops


def test_waves_over_the_sms():
    """Blocks beyond what the SMs hold at once take another wave."""
    one = at.predict("bench_eval", 132, 1000, _geo(R=1), card=H100)
    many = at.predict("bench_eval", 132 * 64, 1000, _geo(R=1), card=H100)
    assert one.waves == 1 and one.blocks == 132
    # Blocks of 128 threads an SM, by warps and by registers (REG_BASE and
    # 32 slot registers: the row and the shift, 4 slots of 4 lanes).
    per_sm = min(at.MAX_WARPS_PER_SM // 4, at.REGISTERS_PER_SM // (128 * (at.REG_BASE + 32)))
    assert many.waves == -(-132 * 64 // (132 * per_sm)) > 1
    small = at.predict("pso_step", 10, 1000, KernelConfig(threads=256), card=H100)
    assert small.blocks == 10 and small.rounds == 2 * 4


# --- the footprint and the candidates ------------------------------------------

def test_block_footprint_limits():
    fp = memmodel.block_footprint("de_step", vec=True, warps_per_row=4, rows_per_block=2,
                                  slots_per_thread=2)
    assert fp.feasible and fp.warps == 8 and fp.smem_bytes == be.SMEM_BYTES
    assert fp.slots == memmodel.ROW_ARRAYS["de_step"] * 2 and fp.regs == fp.slots * 4
    for kw in (dict(warps_per_row=16), dict(warps_per_row=3), dict(warps_per_row=4,
               rows_per_block=4), dict(slots_per_thread=3)):
        assert not memmodel.block_footprint("ga_step", **kw).feasible, kw
    assert memmodel.block_footprint("bench_eval", slots_per_thread=2).slots == 2 * be.MAX_SLOTS
    assert memmodel.block_footprint("pso_step", threads=96).feasible
    for t in (0, 48, 512):
        assert not memmodel.block_footprint("pso_step", threads=t).feasible
    with pytest.raises(KeyError):
        memmodel.block_footprint("warp_drive")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("P,D", SHAPES)
def test_candidates_feasible_and_include_the_heuristic(kind, P, D):
    cands = at.candidates(kind, P, D)
    assert cands and len(set(cands)) == len(cands)
    for c in cands:
        assert at.predict(kind, P, D, c, card=H100).feasible
    if kind == "pso_step":
        assert KernelConfig(threads=ps.MAX_THREADS) in cands
        return
    for align in (16, 4):
        g = be.launch_geometry(P, D, align, H100.sms)
        pick = _geo(g.vec, g.warps_per_row, g.rows_per_block)
        assert pick in at.candidates(kind, P, D, aligned=align == 16)
    assert any(c.vec for c in cands) == (D % 4 == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_order_fields_do_not_depend_on_rows(kind, dtype):
    """A row's sum has one order at every row count (a bucket, a shard and
    a standalone run give the same bits): the fields that fix it are
    ``order_fields``' for D at every row count from 1 to 8,000; the pick at
    each row count is the model's best among the candidates that share
    them."""
    order = {at.choose(kind, P, 1000, "shifted_rosenbrock", dtype=dtype, card=H100)
             for P in (1, 8, 100, 200, 800, 1600, 6400, 8000)}
    assert {tuple(getattr(c, f) for f in at.ORDER_FIELDS[kind]) for c in order} == \
        {at.order_fields(kind, 1000)}
    cfg = next(iter(order))
    fields = at.ORDER_FIELDS[kind]
    same = [p for p in at.ranked(kind, 800, 1000, "shifted_rosenbrock", card=H100, dtype=dtype)
            if all(getattr(p.config, f) == getattr(cfg, f) for f in fields)]
    assert at.choose(kind, 800, 1000, "shifted_rosenbrock", dtype=dtype,
                     card=H100) == same[0].config


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_default_pick_at_the_main_path_shapes_is_launch_geometrys(kind, dtype):
    """At D = 1000 the tuner's pick is the geometry launch_geometry gave
    (pso_step: 256 threads a block) at every row count the main path
    launches: the chunked path's 100, GA's 200-row wave, Table I's 800,
    8 islands of it and the polish batches."""
    for P in (1, 8, 100, 200, 800, 1600, 4000, 6400, 8000):
        cfg = at.choose(kind, P, 1000, "shifted_rosenbrock", dtype=dtype, card=H100)
        if kind == "pso_step":
            assert cfg.threads == ps.MAX_THREADS
            continue
        g = be.launch_geometry(P, 1000, 16, H100.sms, at.STORAGE[dtype].itemsize)
        assert (cfg.vec, cfg.warps_per_row, cfg.rows_per_block) == \
            (g.vec, g.warps_per_row, g.rows_per_block), P


@pytest.mark.parametrize("D", [1, 50, 100, 128, 129, 200, 512, 513, 1000, 1001, 4100])
def test_order_fields_from_d_alone(D):
    for kind in ROW_KINDS:
        for aligned in (True, False):
            vec = aligned and D % 4 == 0
            assert at.order_fields(kind, D, aligned) == (vec, be.row_warps(D, vec))
            g = be.launch_geometry(8, D, 16 if aligned else 4, H100.sms)
            assert (g.vec, g.warps_per_row) == at.order_fields(kind, D, aligned)
    (t,) = at.order_fields("pso_step", D)
    assert t in at.PSO_THREADS and (t * at.PSO_LANES >= D or t == ps.MAX_THREADS)
    assert t == at.PSO_THREADS[0] or (t // 2) * at.PSO_LANES < D


def test_unaligned_pointers_get_scalar_slots_only():
    assert not any(c.vec for c in at.candidates("de_step", 800, 1000, aligned=False))
    assert at.choose("de_step", 800, 1000, card=H100, aligned=False).vec is False


def test_geometry_matches_launch_geometry():
    for P, D in SHAPES:
        g = be.launch_geometry(P, D, 16, H100.sms)
        assert be.geometry(P, D, g.vec, g.warps_per_row, g.rows_per_block) == g
    assert be.launch_geometry(800, 1000, 8, H100.sms, itemsize=2).vec
    assert not be.launch_geometry(800, 1000, 8, H100.sms).vec


# --- the cache ---------------------------------------------------------------

def test_choose_deterministic_and_cached():
    c1 = at.choose("de_step", 128, 1000, "rastrigin", card=H100)
    s1 = at.cache_stats()
    c2 = at.choose("de_step", 128, 1000, "rastrigin", card=H100)
    s2 = at.cache_stats()
    assert c1 == c2 and isinstance(c1, KernelConfig)
    assert None not in (c1.vec, c1.warps_per_row, c1.rows_per_block)
    assert s1["misses"] == 1 and s2 == {**s1, "hits": s1["hits"] + 1}
    assert c1 in at.candidates("de_step", 128, 1000)
    at.choose("de_step", 256, 1000, "rastrigin", card=H100)
    at.choose("de_step", 128, 1000, "rastrigin", card=H100, dtype="bfloat16")
    at.choose("de_step", 128, 1000, "rastrigin", card=dataclasses.replace(H100, sms=114))
    assert at.cache_stats()["misses"] == 4


def test_choose_raises_before_any_launch():
    with pytest.raises(KeyError, match="unknown kernel kind"):
        at.choose("warp_drive", 8, 8, card=H100)
    with pytest.raises(ValueError, match="weierstrass"):
        at.choose("bench_eval", 8, 8, "weierstrass", card=H100)
    with pytest.raises(ValueError, match="storage dtype"):
        at.choose("bench_eval", 8, 8, card=H100, dtype="float16")
    with pytest.raises(ValueError, match="give a CUDA device or a Card"):
        at.choose("bench_eval", 8, 8, device="cpu")
    assert at.cache_stats() == {"hits": 0, "misses": 0, "measured": 0}


def test_measure_on_the_cpu_raises():
    with pytest.raises(ValueError, match="nothing to time"):
        at.choose("bench_eval", 16, 32, card=H100, device="cpu", measure=True)
    with pytest.raises(ValueError, match="nothing to time"):
        at.resolve(None, "de_step", 16, 32, card=H100, measure=True)


def test_choose_for_keys_on_cache_token():
    f = tbm.make_shifted_rosenbrock(16, seed=3)
    c1 = at.choose_for(f, "de_step", 64, 16, card=H100)
    assert at.cache_stats()["misses"] == 1
    c2 = at.choose_for(f, "de_step", 64, 16, card=H100)
    assert c1 == c2 and at.cache_stats()["hits"] == 1
    clone = dataclasses.replace(f, shift=f.shift + 1.0)
    n_keys = len(at._FN_CACHE)
    at.choose_for(clone, "de_step", 64, 16, card=H100)
    assert len(at._FN_CACHE) == n_keys + 1


def test_choose_for_unregistered_function_raises():
    with pytest.raises(KeyError, match="weierstrass"):
        at.choose_for(tbm.FUNCTIONS["weierstrass"], "de_step", 8, 8, card=H100)


# --- resolve and merge -----------------------------------------------------------

def test_resolve_explicit_fields_win():
    full = _geo(True, 2, 2, "bfloat16")
    assert at.resolve(full, "bench_eval", 37, 100, card=H100) == full
    assert at.cache_stats()["misses"] == 0          # nothing tuned
    part = at.resolve(KernelConfig(warps_per_row=1), "bench_eval", 37, 100, card=H100)
    assert part.warps_per_row == 1 and part.rows_per_block is not None
    assert part.vec is not None and part.threads is None
    pso = at.resolve(KernelConfig(threads=64, warps_per_row=8), "pso_step", 8, 100,
                     card=H100)
    assert pso == KernelConfig(threads=64)
    assert at.resolve(None, "pso_step", 800, 1000, card=H100).threads in at.PSO_THREADS


def test_resolve_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="does not fit a block"):
        at.resolve(_geo(W=8, R=2), "ga_step", 37, 100, card=H100)
    with pytest.raises(ValueError, match="4-lane slots"):
        at.resolve(_geo(), "eval_select", 37, 101, card=H100)
    with pytest.raises(ValueError, match="4-lane slots"):
        at.resolve(_geo(), "eval_select", 37, 100, card=H100, aligned=False)
    with pytest.raises(ValueError, match="does not fit a block"):
        at.resolve(KernelConfig(threads=48), "pso_step", 37, 100, card=H100)
    with pytest.raises(KeyError, match="unknown kernel kind"):
        at.resolve(None, "warp_drive", 8, 8, card=H100)


def test_merge_overlay_precedence():
    base = _geo(True, 2, 1)
    m = at.merge(base, warps_per_row=8)
    assert m.warps_per_row == 8 and m.rows_per_block == 1 and m.vec
    assert at.merge(None, threads=128) == KernelConfig(threads=128)
    assert at.merge(KernelConfig(dtype="bfloat16"), vec=False) == \
        KernelConfig(vec=False, dtype="bfloat16")


def test_kernel_config_storage_types():
    assert KernelConfig().itemsize() == 4 and KernelConfig(dtype="bfloat16").itemsize() == 2
    with pytest.raises(ValueError, match="float16"):
        KernelConfig(dtype="float16")
    assert at.library("de_step", "bfloat16") == "de_step_bf16"
    assert at.library("de_step", "float32") == "de_step"


# --- the threaded config -----------------------------------------------------------

def _spy(monkeypatch, module, name, seen):
    real = getattr(module, name)

    def spy(*a, **kw):
        seen.append((name, kw.get("kernel_cfg")))
        return real(*a, **kw)

    monkeypatch.setattr(module, name, spy)


def test_config_on_executor_reaches_all_five_kernels(monkeypatch):
    """A KernelConfig set only on ExecutorConfig.kernel reaches the cuda
    evaluation backend (bench_eval, retry included) and the fused kernels of
    DE, PSO, GA and SA, through IslandOptimizer and through a portfolio."""
    seen = []
    for mod, name in ((texec, "_bench_eval"), (tde, "_de_step_kernel"),
                      (tpso, "_pso_step_kernel"), (tga, "_ga_step_kernel"),
                      (tsa, "_eval_select_kernel")):
        _spy(monkeypatch, mod, name, seen)
    cfg = KernelConfig(warps_per_row=2, dtype="bfloat16")
    exec_cfg = tcore.ExecutorConfig(backend="cuda", kernel=cfg)
    f = tbm.FUNCTIONS["rastrigin"]
    icfg = dict(pop=8, dim=12, sync_every=2, max_evals=8 * 2 * 4)
    for algo in ("de", "pso", "ga", "sa"):
        tcore.IslandOptimizer(tcore.ALGORITHMS[algo], tcore.IslandConfig(n_islands=2, **icfg),
                              params={"fused": True}, exec_cfg=exec_cfg,
                              device="cpu").minimize(f, prng.PRNGKey(0))
    params = {p: {"fused": True} for p in ("de", "pso", "sa", "ga")}
    tcore.IslandOptimizer(None, tcore.IslandConfig(n_islands=4,
                                                   portfolio=("de", "pso", "sa", "ga"), **icfg),
                          params=params, exec_cfg=exec_cfg,
                          device="cpu").minimize(f, prng.PRNGKey(0))
    assert params == {p: {"fused": True} for p in ("de", "pso", "sa", "ga")}
    names = {n for n, _ in seen}
    assert names == {"_bench_eval", "_de_step_kernel", "_pso_step_kernel",
                     "_ga_step_kernel", "_eval_select_kernel"}
    assert all(c is cfg for _, c in seen)


def test_explicit_policy_params_win(monkeypatch):
    seen = []
    _spy(monkeypatch, tde, "_de_step_kernel", seen)
    mine = KernelConfig(rows_per_block=1)
    tcore.IslandOptimizer(tcore.ALGORITHMS["de"], tcore.IslandConfig(pop=8, dim=12,
                                                                    max_evals=40),
                          params={"fused": True, "kernel_cfg": mine},
                          exec_cfg=tcore.ExecutorConfig(kernel=KernelConfig(dtype="bfloat16")),
                          device="cpu").minimize(tbm.FUNCTIONS["sphere"], prng.PRNGKey(1))
    assert seen and all(c is mine for _, c in seen)


def test_accepts_kernel_cfg():
    from repro_torch.core.islands import _accepts_kernel_cfg
    for algo in ("de", "pso", "ga", "sa"):
        assert _accepts_kernel_cfg(tcore.ALGORITHMS[algo])
    for algo in ("ea", "fa", "bh", "mc"):
        assert not _accepts_kernel_cfg(tcore.ALGORITHMS[algo])
    assert not _accepts_kernel_cfg(print)


def test_package_exports():
    import repro_torch.kernels as k
    assert k.KernelConfig is KernelConfig and k.autotune is at
    assert k.get_spec("sphere") == k.KernelSpec("sphere", "sphere")
    assert callable(k.ops.bench_eval) and callable(k.ops.ssd_scan)
    assert k.ops.de_step is k.de_step.de_step      # the name is the module


# --- on the card -------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    if torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_measured_sweep_times_the_real_kernel(cuda_dev, kind):
    card = rl.card_of(cuda_dev)
    n = be.LAUNCHES
    cfg = at.choose(kind, 96, 200, "sphere", device=cuda_dev, measure=True)
    assert at.cache_stats()["measured"] == 1
    assert cfg in at.candidates(kind, 96, 200)
    stats = at.cache_stats()
    assert at.choose(kind, 96, 200, "sphere", device=cuda_dev, measure=True) == cfg
    assert at.cache_stats() == {**stats, "hits": stats["hits"] + 1}
    # The measured order fields hold at another row count too.
    other = at.choose(kind, 960, 200, "sphere", device=cuda_dev, measure=True)
    assert all(getattr(other, f) == getattr(cfg, f) for f in at.ORDER_FIELDS[kind])
    if kind == "bench_eval":
        assert be.LAUNCHES > n


@pytest.mark.gpu
def test_measured_sweep_raises_on_a_failing_candidate(cuda_dev, monkeypatch):
    """A candidate the kernel refuses raises instead of being skipped. The
    bad candidate shares the order fields at D = 128 (the sweep times only
    those) and asks for more warps than a block holds."""
    vec, W = at.order_fields("bench_eval", 128)
    bad = at.Prediction(KernelConfig(vec=vec, warps_per_row=W,
                                     rows_per_block=2 * be.MAX_BLOCK_WARPS // W),
                        None, None, 0, 0, 0, 0.0)
    good = next(p for p in at.ranked("bench_eval", 64, 128, card=rl.card_of(cuda_dev))
                if (p.config.vec, p.config.warps_per_row) == (vec, W))
    monkeypatch.setattr(at, "ranked", lambda *a, **k: [good, bad])
    with pytest.raises(ValueError, match="does not fit a block"):
        at.choose("bench_eval", 64, 128, device=cuda_dev, measure=True)


@pytest.mark.gpu
def test_default_build_is_the_models_pick(cuda_dev):
    """With no field set the wrappers launch the model's pick, and a second
    build of the shape class is a cache hit."""
    pop = torch.rand(800, 1000, device=cuda_dev)
    be.bench_eval(pop, "sphere")
    want = at.choose("bench_eval", 800, 1000, "sphere", device=cuda_dev)
    g = be.tuned_geometry("bench_eval", None, 800, 1000, "sphere", pop)
    assert (g.vec, g.warps_per_row, g.rows_per_block) == \
        (want.vec, want.warps_per_row, want.rows_per_block)
    hits = at.cache_stats()["hits"]
    be.bench_eval(pop, "sphere")
    assert at.cache_stats()["hits"] == hits + 1
