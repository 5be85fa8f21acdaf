"""Deterministic, resumable, sharded token pipeline: the port's own copy of
``repro/data/pipeline.py``.  It is pure numpy in both packages, so a batch is
byte-identical to the reference's for any ``(seed, step, shard, n_shards)``.

Production posture without a corpus dependency: batches are synthesized from
a counter-based PRNG keyed by ``(seed, step, shard)``, which gives the three
properties a 1000-node trainer actually needs from its input layer:

* **determinism / restart-exactness** — batch(step) is a pure function; a job
  restarted from a checkpoint at step k sees byte-identical data from step k,
  no iterator state to persist beyond the step counter (tested).
* **shard disjointness** — shard i of `n_shards` derives from a distinct key;
  elastic re-sharding (n_shards changes) stays deterministic per (step, i).
* **zero coordination** — any host can synthesize any shard: a restarted or
  migrated host never replays or skips (the straggler/restart story).

A background prefetch thread keeps `prefetch` batches ahead (double
buffering), mirroring a real corpus reader.  Swap `_synthesize` for a real
tokenized shard reader and the contract is unchanged.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_shards: int = 1
    shard: int = 0
    seed: int = 0
    with_labels: bool = True
    prefetch: int = 2

    @property
    def shard_batch(self) -> int:
        assert self.global_batch % self.n_shards == 0
        return self.global_batch // self.n_shards


def _synthesize(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    """Markov-ish synthetic tokens (not uniform noise, so loss can fall)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.shard, cfg.n_shards]))
    B, S, V = cfg.shard_batch, cfg.seq_len, cfg.vocab
    base = rng.integers(0, V, (B, 1), dtype=np.int32)
    drift = rng.integers(-8, 9, (B, S), dtype=np.int32).cumsum(axis=1)
    toks = (base + np.abs(drift)) % V
    out = {"tokens": toks.astype(np.int32)}
    if cfg.with_labels:
        nxt = np.roll(toks, -1, axis=1)
        nxt[:, -1] = -1  # ignore last position
        out["labels"] = nxt.astype(np.int32)
    return out


class ShardedTokenPipeline:
    """Iterator with explicit step state (checkpointable as a single int)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=max(cfg.prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        s = self.step
        while not self._stop.is_set():
            batch = _synthesize(self.cfg, s)
            while not self._stop.is_set():
                try:
                    self._q.put((s, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        s, batch = self._q.get()
        # guard against a stale prefetch after restore(); resync if needed
        while s != self.step:
            s, batch = self._q.get()
        self.step += 1
        return batch

    def peek_step(self) -> int:
        return self.step

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict) -> "ShardedTokenPipeline":
        self.close()
        return ShardedTokenPipeline(self.cfg, start_step=int(state["step"]))

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Random access (the restart-exactness contract)."""
        return _synthesize(self.cfg, step)

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=1.0)
