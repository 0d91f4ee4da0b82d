"""Directory-backed checkpoints of nested dicts of tensors (counterpart of
``repro.checkpoint.store``).

The manifest format is the reference's: each leaf is written as a ``.npy``
file inside ``step_NNNNNNNN/`` and named by its path of dict keys in
``jax.tree_util.keystr`` form (``['state']['pop']``, keys sorted); a JSON
manifest carries the step, the leaf table (name, file, shape, dtype), a
checksum and a caller's ``extra`` dict.

  * writes go to a temp dir and are committed by an atomic rename; only the
    last ``keep`` steps are kept;
  * ``save(blocking=False)`` copies the leaves to the host at once and
    writes the files on a thread, so the next round overlaps the IO (the
    paper's PDAsynch* executors);
  * ``restore`` checks every leaf's shape and dtype against a template and
    the checksum over the leaf bytes before it hands anything back;
  * DTensor leaves (``launch.train`` over a mesh) are gathered whole on
    every rank for ``save`` and only a ``writer`` store writes them, so the
    files and the manifest are the unsharded state's; ``restore`` lays the
    leaves out on the current mesh (``shardings``), whatever mesh wrote
    them.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

Tree = Any


def _flatten(tree: Tree, path: str = "") -> list[tuple[str, Any]]:
    """``(name, leaf)`` pairs of a nested dict, keys sorted, names in
    ``keystr`` form."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{path}[{k!r}]")
        return out
    return [(path, tree)]


def _unflatten(names: list[str], leaves: list[Any], like: Tree, path: str = "") -> Tree:
    """``like``'s nesting with each leaf replaced by ``leaves[names.index(path)]``."""
    if isinstance(like, dict):
        return {k: _unflatten(names, leaves, v, f"{path}[{k!r}]") for k, v in like.items()}
    return leaves[names.index(path)]


def _host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        from torch.distributed.tensor import DTensor
        if isinstance(x, DTensor):
            x = x.full_tensor()     # a collective: every rank of the mesh saves
        # a copy even of a host tensor: the trainer updates its state in
        # place while the writer thread runs
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


def _dtype_name(x: Any) -> str:
    """numpy's name for a leaf's dtype (``float32``, ``bool``, ...)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.dtype(x.dtype))


class CheckpointStore:
    """Snapshots of nested dicts of tensors under ``root``: atomic commits,
    async writes, ``keep``-based garbage collection, and a checksum and
    shape/dtype check on restore. Used per dispatched service bucket
    (``core.scheduler``). A store with ``writer=False`` (a rank other than
    0 of a mesh) takes part in ``save``'s gathers and writes nothing."""

    def __init__(self, root: str, keep: int = 3, writer: bool = True):
        self.root = root
        self.keep = keep
        self.writer = writer
        os.makedirs(root, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- write --------------------------------------------------------------

    def save(self, step: int, state: Tree, extra: dict | None = None,
             blocking: bool = True) -> None:
        """Serialize ``state`` at ``step``. With blocking=False the host copy
        is taken now and the files are written on a thread."""
        flat = _flatten(state)
        host = [(name, _host(x)) for name, x in flat]
        if not self.writer:
            return

        def _write():
            tmp = os.path.join(self.root, f".tmp_step_{step:08d}")
            final = os.path.join(self.root, f"step_{step:08d}")
            os.makedirs(tmp, exist_ok=True)
            digest = hashlib.sha256()
            entries = []
            for i, (name, arr) in enumerate(host):
                fn = f"leaf_{i:05d}.npy"
                np.save(os.path.join(tmp, fn), arr)
                digest.update(arr.tobytes()[:4096])
                entries.append({"name": name, "file": fn,
                                "shape": list(arr.shape), "dtype": str(arr.dtype)})
            manifest = {"step": step, "leaves": entries,
                        "checksum": digest.hexdigest(), "extra": extra or {}}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)       # atomic commit
            self._gc()

        if blocking:
            _write()
        else:
            self.wait()
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Block until the writer thread has committed; no-op when idle."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        for s in self.list_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- read ---------------------------------------------------------------

    def list_steps(self) -> list[int]:
        """Steps with a committed (manifest-carrying) checkpoint, ascending."""
        return sorted(int(d[5:]) for d in os.listdir(self.root)
                      if d.startswith("step_")
                      and os.path.exists(os.path.join(self.root, d, "manifest.json")))

    def latest_step(self) -> int | None:
        """Most recent committed step, or None when the store is empty."""
        steps = self.list_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: int | None) -> tuple[int, str]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return step, os.path.join(self.root, f"step_{step:08d}")

    def read_manifest(self, step: int | None = None) -> dict:
        """The committed manifest of ``step`` (default: latest), without
        reading any leaf."""
        _, d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f)

    def restore(self, like: Tree, step: int | None = None,
                device: str | torch.device = "cpu",
                shardings: Tree | None = None) -> tuple[int, Tree, dict]:
        """``(step, tree, extra)``: the checkpoint in ``like``'s nesting as
        tensors on ``device``. Every leaf of ``like`` (anything with
        ``shape`` and ``dtype``, e.g. a ``meta`` tensor or a DTensor) must
        match the saved leaf's shape and dtype, and the leaf bytes the
        checksum. With ``shardings`` (a tree like ``like`` of
        ``parallel.sharding.Layout``) each leaf comes back as a DTensor in
        its layout, each rank keeping its own shards."""
        step, d = self._step_dir(step)
        manifest = self.read_manifest(step)
        by_name = {e["name"]: e for e in manifest["leaves"]}
        digest = hashlib.sha256()
        names, leaves = [], []
        for name, leaf in _flatten(like):
            e = by_name.get(name)
            if e is None:
                raise ValueError(f"checkpoint step {step} has no leaf {name}")
            arr = np.load(os.path.join(d, e["file"]))
            if list(arr.shape) != list(leaf.shape) or str(arr.dtype) != _dtype_name(leaf):
                raise ValueError(
                    f"checkpoint leaf {name}: {arr.dtype}{list(arr.shape)}, expected "
                    f"{_dtype_name(leaf)}{list(leaf.shape)}")
            digest.update(arr.tobytes()[:4096])
            names.append(name)
            leaves.append(torch.from_numpy(arr).to(device))
        if digest.hexdigest() != manifest["checksum"]:
            raise IOError(f"checkpoint step {step} failed checksum validation")
        tree = _unflatten(names, leaves, like)
        if shardings is not None:
            from repro_torch.parallel.sharding import place
            tree = place(tree, shardings)
        return step, tree, manifest["extra"]
