"""Sharded training of the MoE archs over 2 gloo ranks on the CPU against
the unsharded step, the JAX package's and the port's
(``tests/_torch_sharded_refs.py``: one spawn for every case while this
process takes the references). The bounds are
``test_torch_sharded_train.py``'s (float32: loss 1e-5 relative; first
moment 1e-4 and second 2e-4 of the leaf's largest; params within 1e-3 lr
where the gradient is clear of 0).

The cases, at 2 layers, ``moe_groups`` 2 and an expert hidden dim of 24
(which keeps the expert weights' shapes apart from every activation's in
the collective tally), at ``global_batch`` 16 so that on (2, 1) the batch
is split over ``data`` (``batch_specs`` splits it only at a multiple of
16):

* qwen2-moe-a2.7b (tp+fsdp; 4 experts, top-2): on (1, 2) the expert
  hidden dim over ``model`` and the dispatch on the replicated tokens; on
  (2, 1) each rank dispatching its own group, the weights' fsdp storage
  gathered for compute; under dp+zero1 on (2, 1); on a 1-rank mesh at
  batch 2, bit for bit the port's unsharded step; on a 1-rank mesh at
  batch 16, held to the bounds only: there the embedding's updated params
  and first moments part from the unsharded step's in the last bit (9
  elements of the table; the loss and every other leaf equal), the
  gradients of its rows summed in another order under DTensor
  (``ROADMAP.md``'s watch item);
* llama4-scout-17b-a16e (tp+fsdp; 16 experts so that they split over
  ``model``, top-1): on (1, 2) the experts over ``model``; on (2, 1) the
  expert hidden dim over ``data`` (the 2D layout ``compute_specs`` keeps)
  with group-local dispatch.

Routing. The reference routes on its own router probabilities and the
port on its own, with no replay: a (token, k) pair can part the two only
where its K-th and (K+1)-th probabilities nearly tie. The port's
unsharded step records every MoE call's smallest gap between them
(``ROUTING_HOOK``): 2.9e-4 for qwen2-moe and 5.8e-5 for llama4-scout at
batch 16 (5.2e-3 for qwen2-moe's 1-rank case), against router products
that differ in the last float32 bits (about 1e-7);
:func:`test_router_gaps_clear_float32_rounding` holds every gap above
:data:`GAP_FLOOR`.
"""
import pytest

torch = pytest.importorskip("torch")

import _torch_sharded_refs as R  # noqa: E402
import _torch_sharding_cases as cases  # noqa: E402

QWEN, LLAMA4 = "qwen2-moe-a2.7b", "llama4-scout-17b-a16e"
MOE_OVER = {"moe_groups": 2, "moe_d_ff": 24}
QWEN_OVER = {**MOE_OVER, **R.BATCH}
LLAMA4_OVER = {"num_experts": 16, **MOE_OVER, **R.BATCH}
# name -> (arch, sharding mode, mesh (data, model), config overrides)
CASES = {
    "qwen2moe_1x2": (QWEN, "tp+fsdp", (1, 2), QWEN_OVER),
    "qwen2moe_2x1": (QWEN, "tp+fsdp", (2, 1), QWEN_OVER),
    "qwen2moe_zero1_2x1": (QWEN, "dp+zero1", (2, 1), QWEN_OVER),
    "llama4_1x2": (LLAMA4, "tp+fsdp", (1, 2), LLAMA4_OVER),
    "llama4_2x1": (LLAMA4, "tp+fsdp", (2, 1), LLAMA4_OVER),
    "qwen2moe_1x1": (QWEN, "tp+fsdp", (1, 1), MOE_OVER),
    "qwen2moe_1x1_batch16": (QWEN, "tp+fsdp", (1, 1), QWEN_OVER),
}
ONE_RANK = ["qwen2moe_1x1"]
SHARDED = [n for n in CASES if n not in ONE_RANK]
# Smallest gap allowed between a token's K-th and (K+1)-th router
# probabilities: 100 times the float32 rounding of the router's product.
GAP_FLOOR = 1e-5


@pytest.fixture(scope="module")
def spawned():
    return R.run_cases(CASES, ONE_RANK, dispatch=True)


@pytest.fixture(scope="module")
def run(spawned):
    ranks, refs = spawned
    return ranks["steps"], refs


@pytest.mark.parametrize("name", SHARDED)
def test_sharded_step_matches_the_reference(run, name):
    """The sharded step against the reference's unsharded jitted step."""
    got, refs = run
    assert got[name]["step"] == 1
    R.check_step(got[name], refs[R.ref_key(CASES, name)]["jax"])


@pytest.mark.parametrize("name", SHARDED)
def test_sharded_step_matches_the_ports_unsharded_step(run, name):
    got, refs = run
    R.check_step(got[name], refs[R.ref_key(CASES, name)]["port"])


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_the_shards_its_spec_gives(run, name):
    R.check_local_shapes(run[0][name])


@pytest.mark.parametrize("name", ONE_RANK)
def test_one_rank_mesh_gives_the_unsharded_bits(run, name):
    got, refs = run
    R.check_bits(got[name], refs[R.ref_key(CASES, name)]["port"])


@pytest.mark.parametrize("name", list(CASES))
def test_moe_dispatch_is_group_local_where_the_batch_is_split(run, name):
    """A rank of a (2, 1) mesh, whose batch rows are split over ``data``,
    dispatches its own one of the 2 groups; elsewhere (the batch not
    split) every rank dispatches both."""
    got = run[0][name]
    assert got["dispatch_groups"] == ([1] if got["mesh"]["data"] == 2 else [2])


@pytest.mark.parametrize("name", list(CASES))
def test_no_rank_gathers_the_routed_experts(run, name):
    """No all-gather of the step takes a layer's routed expert weights (or
    their gradients) at their compute layout's local shape: the expert
    products run on the weights where they lie. (Under tp+fsdp the
    compute copies of the stacked leaves are gathered from their storage
    once a step, by design; those are 4-D.)"""
    got = run[0][name]
    mesh = got["mesh"]
    local = set()
    for w in ("w_gate", "w_up", "w_down"):
        leaf = f"/layers/moe/{w}"
        spec = got["compute_specs"].get(leaf, got["specs"][leaf])
        local.add(R.local_shape(got["global_shapes"][leaf][1:], spec[1:], mesh))
    gathered = {shape for (op, shape) in got["collectives"] if op.startswith("all_gather")}
    assert not local & gathered, (local, gathered)
    if CASES[name][0] == LLAMA4 and mesh["model"] == 2:
        assert got["compute_specs"]["/layers/moe/w_gate"][1] == "model"


@pytest.mark.parametrize("name", list(cases.DISPATCH_CASES))
def test_dispatch_over_a_mesh_gives_the_unsharded_bits(spawned, name):
    """``route`` on a DTensor over (2, 1) with the batch rows split over
    ``data`` (``cases.DISPATCH_CASES``): where G divides by the 2 ranks a
    rank dispatches its own G / 2 groups, elsewhere all G; gathered back,
    the buffers, slots, gates and per-group aux are the unsharded call's
    bits, drops and ties included."""
    groups, same, dropped = spawned[0]["dispatch"][name]
    arch, over, B, S = cases.DISPATCH_CASES[name]
    G = over.get("moe_groups", 1)
    assert groups == [G // 2 if G % 2 == 0 else G]
    assert same
    if name == "group_local" or name.endswith("ties"):
        assert dropped > 0


def test_router_gaps_clear_float32_rounding(run):
    for key, ref in run[1].items():
        assert ref["gap"] > GAP_FLOOR, (key, ref["gap"])
