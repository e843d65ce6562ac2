"""Deterministic, resumable synthetic data pipeline: the port's copy of
``repro.data.pipeline`` (numpy only; its batches are bitwise the
reference's).

Fault-tolerance contract: the stream is a pure function of (seed, step,
host), so a restart at step k reproduces the exact remaining stream on any
host layout — no data-loader state to checkpoint beyond the step counter.
This is the property elastic restarts rely on (repro_torch.train.checkpoint).

The generator synthesizes packed LM documents: zipf-ish token ids with EOS
boundaries, plus frame embeddings for the enc-dec (audio-frontend stub).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig

EOS = 0


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 128


class SyntheticLM:
    """Host-sharded deterministic token stream."""

    def __init__(self, cfg: DataConfig, *, host_id: int = 0,
                 num_hosts: int = 1):
        assert cfg.global_batch % num_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.host_batch = cfg.global_batch // num_hosts

    def _rng(self, step: int, row: int) -> np.random.Generator:
        # counter-based: independent of visitation order
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, row]))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        B, S, V = self.host_batch, self.cfg.seq_len, self.cfg.vocab_size
        tokens = np.empty((B, S + 1), np.int32)
        for r in range(B):
            grow = self.host_id * self.host_batch + r
            rng = self._rng(step, grow)
            # packed documents with EOS separators
            pos = 0
            while pos < S + 1:
                dlen = int(rng.geometric(1.0 / self.cfg.mean_doc_len))
                dlen = min(max(dlen, 2), S + 1 - pos)
                # zipf-ish ids in [1, V)
                z = rng.zipf(1.3, size=dlen - 1)
                tokens[r, pos: pos + dlen - 1] = np.clip(z, 1, V - 1)
                pos += dlen - 1
                if pos < S + 1:
                    tokens[r, pos] = EOS
                    pos += 1
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:].copy()}

    def batch_with_frames(self, step: int, d_model: int) -> Dict[str, np.ndarray]:
        out = self.batch(step)
        B, S = out["tokens"].shape
        rng = self._rng(step, 1 << 20)
        out["frames"] = rng.standard_normal((B, S, d_model)).astype(np.float32)
        return out


def make_pipeline(model_cfg: ModelConfig, seq_len: int, global_batch: int,
                  seed: int = 0, host_id: int = 0,
                  num_hosts: int = 1) -> SyntheticLM:
    return SyntheticLM(
        DataConfig(model_cfg.vocab_size, seq_len, global_batch, seed),
        host_id=host_id, num_hosts=num_hosts)
