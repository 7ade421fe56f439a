"""Deterministic, sharded, restartable token pipeline.

The port's own numpy copy of the JAX package's ``data/pipeline.py``: the same
seed, step and shard give the same batch, bit for bit.

  * deterministic — batch(step, shard) is a pure function of (seed, step,
                    shard): any host can recompute any batch; restart at
                    step k reproduces exactly the stream a continuous run
                    would have seen (checkpointable by step index alone).
  * sharded       — each data-parallel host materializes only its slice.
  * skip-ahead    — straggler mitigation: a host that fell behind jumps the
                    cursor (sacrifices examples, preserves alignment).
  * file-backed   — optional memmap token file; synthetic Zipf tokens
                    otherwise (self-contained benchmarks).
  * prefetch      — background thread keeps `depth` batches ready.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    token_file: Optional[str] = None       # memmap int32 tokens
    num_codebooks: int = 0                 # audio: (B, K, S) batches
    num_image_tokens: int = 0              # vlm: also emit pixel embeds
    d_model: int = 0


class TokenPipeline:
    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        self.step = 0
        self._tokens = None
        if cfg.token_file:
            self._tokens = np.memmap(cfg.token_file, dtype=np.int32, mode="r")

    # ------------------------------------------------------------------
    def state(self) -> dict:
        return {"step": self.step, "shard": self.shard}

    def restore(self, state: dict):
        self.step = int(state["step"])

    def skip_ahead(self, n: int = 1):
        """Straggler mitigation: drop n steps of this shard's data."""
        self.step += n

    # ------------------------------------------------------------------
    def _synthetic(self, step: int) -> np.ndarray:
        cfg = self.cfg
        K = max(1, cfg.num_codebooks)
        rng = np.random.Generator(np.random.Philox(
            key=cfg.seed, counter=[step, self.shard, 0, 0]))
        # Zipf-ish marginal over the vocab (realistic softmax pressure)
        z = rng.zipf(1.3, size=(self.local_batch, K, cfg.seq_len + 1))
        return (z % cfg.vocab_size).astype(np.int32)

    def _from_file(self, step: int) -> np.ndarray:
        cfg = self.cfg
        K = max(1, cfg.num_codebooks)
        need = self.local_batch * K * (cfg.seq_len + 1)
        start = ((step * self.num_shards + self.shard) * need) % \
            max(1, len(self._tokens) - need)
        chunk = np.asarray(self._tokens[start:start + need])
        return chunk.reshape(self.local_batch, K, cfg.seq_len + 1) \
            % self.cfg.vocab_size

    def batch_at(self, step: int) -> dict:
        toks = (self._from_file(step) if self._tokens is not None
                else self._synthetic(step))
        cfg = self.cfg
        if cfg.num_codebooks:
            batch = {"tokens": toks[:, :, :-1], "labels": toks[:, :, 1:]}
        else:
            batch = {"tokens": toks[:, 0, :-1], "labels": toks[:, 0, 1:]}
        if cfg.num_image_tokens:
            rng = np.random.Generator(np.random.Philox(
                key=cfg.seed + 1, counter=[step, self.shard, 0, 0]))
            batch["pixel_embeds"] = rng.standard_normal(
                (self.local_batch, cfg.num_image_tokens, cfg.d_model),
                dtype=np.float32)
            # image positions don't contribute to the LM loss
            batch["labels"][:, : cfg.num_image_tokens] = -1
        return batch

    def __next__(self) -> dict:
        b = self.batch_at(self.step)
        self.step += 1
        return b

    def __iter__(self) -> Iterator[dict]:
        return self


class Prefetcher:
    """Background-thread prefetch queue over any batch iterator."""

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self.it = it
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        try:
            for b in self.it:
                if self._stop.is_set():
                    return
                self.q.put(b)
        finally:
            self.q.put(None)

    def __next__(self):
        b = self.q.get()
        if b is None:
            raise StopIteration
        return b

    def __iter__(self):
        return self

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
