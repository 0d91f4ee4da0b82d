"""Deterministic synthetic token pipeline with a restorable cursor.

Counterpart of ``repro.data.pipeline``, a copy of its numpy code: an
infinite, seeded stream of (tokens, labels) batches with the modality stubs
of the VLM and audio archs, bit for bit the reference's batches. The cursor
(step index) is part of the checkpoint, so a restart resumes the exact
stream position; batches are made per global index.

Synthetic distribution: a tiny deterministic Markov-ish mixture (not
uniform) so training losses actually decrease.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class DataConfig:
    seed: int = 17
    n_species: int = 32          # mixture components


class SyntheticStream:
    def __init__(self, cfg: ModelConfig, dcfg: DataConfig = DataConfig(),
                 start_step: int = 0):
        self.cfg = cfg
        self.dcfg = dcfg
        self.step = start_step

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.dcfg.seed}

    def load_state_dict(self, st: dict) -> None:
        """Move the cursor to a checkpoint's; ValueError if the checkpoint
        was written by a stream of another seed."""
        if int(st["seed"]) != self.dcfg.seed:
            raise ValueError("data seed changed across restart: "
                             f"{st['seed']} in the checkpoint, {self.dcfg.seed} here")
        self.step = int(st["step"])

    def _batch_np(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab
        rng = np.random.default_rng(self.dcfg.seed * 1_000_003 + step)
        # per-sequence species with its own ngram bias -> learnable structure
        species = rng.integers(0, self.dcfg.n_species, size=(B, 1))
        base = rng.integers(0, V, size=(B, S), dtype=np.int64)
        drift = (np.arange(S)[None, :] * (species + 1)) % V
        tokens = (base // 4 + drift) % V
        out: dict[str, np.ndarray] = {}
        if cfg.frontend == "audio_stub":
            emb_rng = np.random.default_rng(step + 7)
            out["embeds"] = emb_rng.standard_normal(
                (B, S, cfg.frontend_dim), dtype=np.float32)
            out["labels"] = np.concatenate(
                [tokens[:, 1:], tokens[:, :1]], axis=1).astype(np.int32)
        elif cfg.frontend == "vlm_stub":
            emb_rng = np.random.default_rng(step + 7)
            out["embeds"] = emb_rng.standard_normal(
                (B, cfg.frontend_len, cfg.frontend_dim), dtype=np.float32)
            out["tokens"] = tokens[:, :S - cfg.frontend_len].astype(np.int32)
            labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
            labels[:, :cfg.frontend_len] = -100       # image prefix unsupervised
            out["labels"] = labels.astype(np.int32)
        else:
            out["tokens"] = tokens.astype(np.int32)
            out["labels"] = np.concatenate(
                [tokens[:, 1:], tokens[:, :1]], axis=1).astype(np.int32)
        return out

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        b = self._batch_np(self.step)
        self.step += 1
        return b


def to_device(batch: dict[str, np.ndarray], device: str | torch.device) -> dict:
    """A host batch as tensors on ``device`` (token ids and labels int64, so
    they index directly; embeddings float32). The port's trainer runs on one
    device, so it has no counterpart of the reference's ``shard_batch``,
    which places each array with the step's input shardings over a mesh."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.long() if t.dtype == torch.int32 else t).to(device)
    return out
