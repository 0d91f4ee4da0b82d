"""The trainer's step, ``launch.steps.make_train_step(donate=True)``,
against the pure step (``donate=False``) from the same params, state and
batch, bit for bit: the loss, the params, both moments and the step count.
The donated step writes its params and moments in place
(``optim.adam.update_``) and returns the tensors it was given; the pure
one is ``update_`` on copies. A non-finite loss leaves the donated state
untouched, which is what ``launch.train.train``'s retry needs.

The cases are reduced configs with the global-norm clip at
``_torch_sharding_cases.DONATE_CLIP``, below each first gradient norm, so
the clip scales the step: llama3.2-1b (dense), qwen2-moe-a2.7b (MoE, 2
token groups) and mamba2-370m (SSM) unsharded; llama3.2-1b under dp+zero1
on a (2, 1) mesh (params replicated, moments split over ``data``) and
under tp+fsdp on (1, 2), over 2 gloo ranks.
"""
import pytest

torch = pytest.importorskip("torch")

import _torch_sharding_cases as cases  # noqa: E402
from repro_torch.core import mesh as cmesh  # noqa: E402

# name -> (arch, sharding mode, mesh (data, model) or None, config overrides)
CASES = {
    "llama": ("llama3.2-1b", None, None, {}),
    "qwen2moe": ("qwen2-moe-a2.7b", None, None, {"moe_groups": 2}),
    "mamba2": ("mamba2-370m", None, None, {}),
    "llama_dp+zero1_2x1": ("llama3.2-1b", "dp+zero1", (2, 1), {}),
    "llama_tp+fsdp_1x2": ("llama3.2-1b", "tp+fsdp", (1, 2), {}),
}
UNSHARDED = [n for n, case in CASES.items() if case[2] is None]
SHARDED = [n for n in CASES if n not in UNSHARDED]


@pytest.fixture(scope="module")
def sharded():
    return cmesh.spawn(2, cases.donate_all, SHARDED, "cpu", CASES, timeout=300)


@pytest.fixture(scope="module")
def unsharded():
    return {}


@pytest.fixture
def got(request, sharded, unsharded):
    name = request.param
    if name in sharded:
        return sharded[name]
    if name not in unsharded:
        unsharded[name] = cases.donate_bits(name, "cpu", CASES)
    return unsharded[name]


@pytest.mark.parametrize("got", list(CASES), indirect=True)
def test_donated_step_gives_the_pure_steps_bits(got):
    assert got["grad_norm"] > cases.DONATE_CLIP     # the clip scales the step
    assert got["same"]


@pytest.mark.parametrize("got", list(CASES), indirect=True)
def test_donated_step_updates_in_place(got):
    assert got["in_place"]


@pytest.mark.parametrize("got", list(CASES), indirect=True)
def test_donated_step_keeps_its_state_on_a_nonfinite_loss(got):
    assert got["nan_kept"]
