"""Sharded training of zamba2, the frontends and gemma2 over 2 gloo ranks on
the CPU against the unsharded step, the JAX package's and the port's
(``tests/_torch_sharded_refs.py``: one spawn for every case while this
process takes the references; the MoE archs are in
``test_torch_sharded_train_moe.py``, so that ``--dist loadfile`` gives
each half a worker). The bounds are ``test_torch_sharded_train.py``'s
(float32: loss 1e-5 relative; first moment 1e-4 and second 2e-4 of the
leaf's largest; params within 1e-3 lr where the gradient is clear of 0).

The cases, at ``global_batch`` 16 so that on (2, 1) the batch is split
over ``data`` (``batch_specs`` splits it only at a multiple of 16):

* zamba2-7b (tp+fsdp, 16 attention heads, 3 Mamba2 layers and one
  application of the shared block) on (1, 2) and (2, 1): the shared
  attention block split, the SSM heads over ``model``;
* internvl2-2b (tp) on (1, 2) and (2, 1): the patch ``embeds`` replicated,
  then split over ``data``;
* musicgen-medium (tp+fsdp) at 12 heads, which do not divide the model
  axis's 16 as its own 24 do not: attention replicated, on (1, 2) and
  (2, 1);
* gemma2-9b (tp+fsdp, batch 2) on (1, 2): softcaps, a local and a global
  layer, tied and scaled embeddings, post-norms.
"""
import pytest

torch = pytest.importorskip("torch")

import _torch_sharded_refs as R  # noqa: E402
import _torch_sharding_cases as cases  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402

# name -> (arch, sharding mode, mesh (data, model), config overrides)
CASES = {
    "zamba2_1x2": ("zamba2-7b", "tp+fsdp", (1, 2), {"n_heads": 16, **R.BATCH}),
    "zamba2_2x1": ("zamba2-7b", "tp+fsdp", (2, 1), {"n_heads": 16, **R.BATCH}),
    "internvl2_1x2": ("internvl2-2b", "tp", (1, 2), R.BATCH),
    "internvl2_2x1": ("internvl2-2b", "tp", (2, 1), R.BATCH),
    "musicgen_1x2": ("musicgen-medium", "tp+fsdp", (1, 2), {"n_heads": 12, **R.BATCH}),
    "musicgen_2x1": ("musicgen-medium", "tp+fsdp", (2, 1), {"n_heads": 12, **R.BATCH}),
    "gemma2_1x2": ("gemma2-9b", "tp+fsdp", (1, 2), {}),
}
NAMES = list(CASES)


@pytest.fixture(scope="module")
def run():
    ranks, refs = R.run_cases(CASES, [])
    return ranks["steps"], refs


@pytest.mark.parametrize("name", NAMES)
def test_sharded_step_matches_the_reference(run, name):
    """The sharded step against the reference's unsharded jitted step."""
    got, refs = run
    assert got[name]["step"] == 1
    R.check_step(got[name], refs[R.ref_key(CASES, name)]["jax"])


@pytest.mark.parametrize("name", NAMES)
def test_sharded_step_matches_the_ports_unsharded_step(run, name):
    got, refs = run
    R.check_step(got[name], refs[R.ref_key(CASES, name)]["port"])


@pytest.mark.parametrize("name", NAMES)
def test_each_rank_holds_the_shards_its_spec_gives(run, name):
    R.check_local_shapes(run[0][name])


@pytest.mark.parametrize("name", ["musicgen_1x2", "musicgen_2x1"])
def test_musicgen_keeps_its_attention_replicated(run, name):
    """The musicgen cases are held at heads that do not divide the model
    axis, as its own 24 do not, so its attention weights stay whole on
    each rank (``heads_ok`` false)."""
    cfg = cases.case_config(name, CASES)
    assert cfg.n_heads % 16 and get_config("musicgen-medium").n_heads % 16
    specs = run[0][name]["specs"]
    for w in ("wq", "wk", "wv", "wo"):
        assert "model" not in specs[f"/layers/attn/{w}"], w


def test_zamba2_splits_its_shared_attention_and_ssm_heads(run):
    specs = run[0]["zamba2_1x2"]["specs"]
    assert specs["/shared_attn/attn/wq"][-1] == "model"
    assert specs["/layers/ssm/w_x"][-1] == "model"
