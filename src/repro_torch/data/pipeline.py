"""Deterministic, shardable, resumable synthetic data stream.

A copy of ``repro.data.pipeline`` (numpy only, so the port keeps its own):
batch content is a pure function of ``(seed, step, shard)``, so a run
resumed from a checkpointed step reproduces the stream exactly, with no
batch skipped or repeated, whatever the shard layout.  ``batch_at`` gives
the reference's arrays, bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "lm"          # lm | embeds (stub frontends)
    d_model: int = 0          # for kind="embeds"


class SyntheticStream:
    """Zipf-distributed token LM stream (or gaussian embedding stream)."""

    def __init__(self, cfg: DataConfig, shard_index: int = 0,
                 shard_count: int = 1):
        if cfg.global_batch % shard_count:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split into {shard_count} shards")
        self.cfg = cfg
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.local_batch = cfg.global_batch // shard_count

    def batch_at(self, step: int) -> dict:
        """This shard's batch of ``step``: ``{"tokens", "labels"}`` int32
        ``(local_batch, seq_len)`` for ``lm``; ``{"embeds" f32, "labels"
        zeros}`` for ``embeds``.  A pure function of the step."""
        cfg = self.cfg
        # fold the step into the base and the global row into each row's
        # key, so any shard layout gives the same rows
        rows = []
        base = np.random.default_rng(
            (cfg.seed, step)).integers(0, 2**31 - 1)
        for r in range(self.local_batch):
            gid = self.shard_index * self.local_batch + r
            rng = np.random.default_rng((base, gid))
            if cfg.kind == "lm":
                # Zipf-ish: a heavy head, as in natural text
                u = rng.random(cfg.seq_len + 1)
                tok = np.minimum(
                    (cfg.vocab_size * u ** 3).astype(np.int64),
                    cfg.vocab_size - 1)
                rows.append(tok)
            else:
                rows.append(rng.standard_normal(
                    (cfg.seq_len + 1, cfg.d_model)).astype(np.float32))
        arr = np.stack(rows)
        if cfg.kind == "lm":
            return {"tokens": arr[:, :-1].astype(np.int32),
                    "labels": arr[:, 1:].astype(np.int32)}
        return {"embeds": arr[:, :-1],
                "labels": np.zeros((self.local_batch, cfg.seq_len), np.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
