"""Deterministic synthetic LM token pipeline: port of ``repro/data/pipeline.py``
(pure numpy there and here; the reference imports ``jax`` without using it).

Batches are a pure function of (seed, step) — after a crash/restart the
pipeline replays or skips to any step bit-exactly.  On a real cluster each
data-parallel host would slice its shard of the global batch by its rank;
the host-level API is the same.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    extra: int = 1        # +1 token so train batches carry labels

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step & 0x7FFFFFFF]))
        tokens = rng.integers(
            0, self.vocab_size,
            size=(self.global_batch, self.seq_len + self.extra),
            dtype=np.int32)
        return {"tokens": tokens}


@dataclasses.dataclass(frozen=True)
class FrontendPipeline(TokenPipeline):
    """Adds stubbed modality inputs (vlm patches / audio frames)."""
    frontend_key: str = ""
    frontend_shape: tuple = ()
    dtype: str = "bfloat16"

    def batch(self, step: int) -> dict:
        out = super().batch(step)
        if self.frontend_key:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed + 1, step & 0x7FFFFFFF]))
            arr = rng.normal(size=(self.global_batch, *self.frontend_shape))
            out[self.frontend_key] = arr.astype(np.float32)
        return out
