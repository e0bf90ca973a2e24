"""Deterministic sharded synthetic data pipeline — the port's own numpy
copy of ``repro/data/pipeline.py`` (no torch: batches are numpy arrays,
bit-equal to the reference's, which the training loop moves to the
device).

Every batch is a pure function of (seed, step, shard) — restarts and elastic
re-sharding replay identical data with no coordination (the property the
checkpoint/restart tests rely on).  A background-thread prefetcher overlaps
host batch synthesis with device steps.  Real-text mode packs a byte corpus
into fixed-length sequences with the same determinism.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    num_shards: int = 1
    shard_id: int = 0
    corpus: Optional[str] = None      # path to a text file (byte-level)


def _rng_for(seed: int, step: int, shard: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=seed,
                                                counter=[0, 0, step, shard]))


def synth_batch(cfg: ModelConfig, shape: ShapeConfig, dc: DataConfig,
                step: int) -> Dict[str, np.ndarray]:
    """Zipf-ish token stream (heavy-tailed like natural text)."""
    rng = _rng_for(dc.seed, step, dc.shard_id)
    b = shape.global_batch // dc.num_shards
    s = shape.seq_len
    # heavy-tailed ids; reserve 0 as padding
    u = rng.random((b, s + 1))
    toks = (np.power(u, 3.0) * (cfg.vocab_size - 2)).astype(np.int32) + 1
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal(
            (b, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return batch


class CorpusDataset:
    """Byte-level packing of a real text corpus, deterministically sharded."""

    def __init__(self, path: str, cfg: ModelConfig):
        with open(path, "rb") as f:
            data = np.frombuffer(f.read(), dtype=np.uint8)
        self.data = (data.astype(np.int32) % (cfg.vocab_size - 2)) + 1
        self.cfg = cfg

    def batch(self, shape: ShapeConfig, dc: DataConfig, step: int
              ) -> Dict[str, np.ndarray]:
        rng = _rng_for(dc.seed, step, dc.shard_id)
        b = shape.global_batch // dc.num_shards
        s = shape.seq_len
        starts = rng.integers(0, max(len(self.data) - s - 1, 1), size=b)
        toks = np.stack([self.data[st:st + s + 1] for st in starts])
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
        if self.cfg.is_encdec:
            batch["frames"] = rng.standard_normal(
                (b, self.cfg.enc_frames, self.cfg.d_model)).astype(np.float32)
        return batch


class Prefetcher:
    """Background-thread prefetch of host batches."""

    def __init__(self, make_batch, start_step: int = 0, depth: int = 2):
        self._make = make_batch
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put(self._make(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __next__(self):
        return self._q.get()

    def close(self) -> None:
        self._stop.set()


def make_iterator(cfg: ModelConfig, shape: ShapeConfig, dc: DataConfig,
                  start_step: int = 0) -> Prefetcher:
    ds = CorpusDataset(dc.corpus, cfg) if dc.corpus else None

    def make(step: int):
        if ds is not None:
            return ds.batch(shape, dc, step)
        return synth_batch(cfg, shape, dc, step)

    return Prefetcher(make, start_step)
