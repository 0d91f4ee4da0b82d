"""The port's trainer (``launch.train.train``) against the JAX package's,
and its fault handling: the resume drill, the non-finite-loss policy, the
``launch.lm_train`` drill and the CLI.

``train`` draws its weights from ``init_params(PRNGKey(0))`` in each
package (within a few ulps of each other, ``tests/test_torch_prng.py``) and
reads the same synthetic stream; six steps of reduced llama3.2-1b give
losses within 1e-5 of the reference's (float32; the step's sums run in
another order). The resume drill and the restore after two non-finite
losses must give the uninterrupted run's params and moments bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.launch import lm_train  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim import adam  # noqa: E402

LOSS_TOL = 1e-5     # relative


def _same_state(a, b):
    """Equal (params, AdamState) pairs, leaf for leaf and bit for bit."""
    pa, oa = a
    pb, ob = b
    leaves = adam.tree_leaves
    assert torch.equal(oa.step, ob.step)
    for x, y in zip(leaves(pa) + leaves(oa.mu) + leaves(oa.nu),
                    leaves(pb) + leaves(ob.mu) + leaves(ob.nu)):
        assert torch.equal(x, y)


def test_train_matches_jax_train():
    with jax.threefry_partitionable(True):
        _, _, want = jtrain.train(jget("llama3.2-1b").reduced(), steps=6, log_every=100)
    _, _, got = ttrain.train(get_config("llama3.2-1b").reduced(), steps=6, log_every=100,
                             device="cpu")
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=0)


ACFG = adam.AdamConfig(lr=1e-3, warmup_steps=2, total_steps=6)


def test_resume_drill_is_bit_for_bit(tmp_path, capsys):
    """4 steps checkpointed every 2 (async writes), then a fresh call
    resuming to 6 from the last checkpoint and its data cursor: the same
    params and moments as 6 steps in one call."""
    cfg, ck = get_config("llama3.2-1b").reduced(), str(tmp_path / "ck")
    p, o, first = ttrain.train(cfg, steps=4, ckpt_dir=ck, ckpt_every=2, adam_cfg=ACFG,
                               device="cpu", resume=False)
    p, o, rest = ttrain.train(cfg, steps=6, ckpt_dir=ck, ckpt_every=2, adam_cfg=ACFG,
                              device="cpu")
    assert "[train] restored step 4 (data cursor 4)" in capsys.readouterr().out
    p6, o6, whole = ttrain.train(cfg, steps=6, adam_cfg=ACFG, device="cpu")
    assert first + rest == whole
    _same_state((p, o), (p6, o6))


class _Flaky(tdata.SyntheticStream):
    """A stream whose batches at the indices in ``bad`` are non-finite the
    first time they are drawn (a transient fault upstream): the audio
    arch's frame embeddings are NaN there."""

    bad: tuple = ()

    def _batch_np(self, step):
        out = super()._batch_np(step)
        if step in self.bad and step not in self.seen:
            self.seen.add(step)
            out["embeds"] = np.full_like(out["embeds"], np.nan)
        return out


@pytest.fixture
def flaky(monkeypatch):
    def make(bad):
        cls = type("Flaky", (_Flaky,), {"bad": tuple(bad), "seen": set()})
        monkeypatch.setattr(ttrain, "SyntheticStream", cls)
    return make


def test_one_non_finite_loss_skips_the_step(flaky, capsys):
    cfg = get_config("musicgen-medium").reduced()
    flaky([2])
    _, _, losses = ttrain.train(cfg, steps=4, adam_cfg=ACFG, device="cpu")
    out = capsys.readouterr().out
    assert "[train] non-finite loss at step 2 (retry 1)" in out
    assert len(losses) == 4 and np.all(np.isfinite(losses))


def test_two_non_finite_losses_restore_the_last_checkpoint(flaky, tmp_path, capsys):
    """Two non-finite batches in a row restore the last checkpoint and its
    cursor; with the fault gone the run ends where an undisturbed run
    does, bit for bit."""
    cfg = get_config("musicgen-medium").reduced()
    clean = ttrain.train(cfg, steps=6, adam_cfg=ACFG, device="cpu")
    flaky([4, 5])
    p, o, _ = ttrain.train(cfg, steps=6, ckpt_dir=str(tmp_path / "ck"), ckpt_every=2,
                           adam_cfg=ACFG, device="cpu")
    out = capsys.readouterr().out
    assert "(retry 1)" in out and "(retry 2)" in out
    _same_state((p, o), clean[:2])


def test_lm_train_drill(tmp_path):
    """examples/lm_train.py's drill at 4 steps on the CPU: half, then
    resumed from the checkpoint of step 2 to step 4."""
    first, second = lm_train.drill(4, str(tmp_path / "ck"), device="cpu")
    assert len(first) == len(second) == 2 and np.all(np.isfinite(first + second))
    assert lm_train.mini_config().n_layers == 4


def test_train_cli(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["train", "--arch", "llama3.2-1b", "--reduced",
                                     "--device", "cpu", "--steps", "2", "--seq-len", "16"])
    ttrain.main()
    out = capsys.readouterr().out
    assert "[train] llama3.2-1b" in out and "device cpu" in out
    assert "[train] step     2 loss" in out
