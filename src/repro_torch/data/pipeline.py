"""Deterministic, host-sharded synthetic data pipeline with prefetch
(``repro/data/pipeline.py``).

Every batch is a pure function of (seed, host_id, step): restarts replay
the exact token stream, and each host of a multi-host job draws a
disjoint shard of the global batch.  The draws are the reference's numpy
draws, so the tokens equal its bit for bit; they arrive as int32 CPU
tensors, which the trainer moves to its device.  A background thread
keeps ``prefetch`` batches ahead of the trainer."""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.num_hosts:
            raise ValueError(f"a global batch of {self.global_batch} does not split "
                             f"over {self.num_hosts} hosts")
        return self.global_batch // self.num_hosts


def batch_at(cfg: DataConfig, step: int) -> dict:
    """Pure function of (cfg.seed, cfg.host_id, step) -> training batch
    (``tokens``, ``targets`` int32 ``[host_batch, seq_len]``).  Tokens
    follow a Zipf-ish distribution so losses are non-degenerate."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, cfg.host_id, step]))
    z = rng.zipf(1.3, size=(cfg.host_batch, cfg.seq_len + 1))
    tokens = (z % (cfg.vocab_size - 1)).astype(np.int32) + 1
    return {
        "tokens": torch.from_numpy(np.ascontiguousarray(tokens[:, :-1])),
        "targets": torch.from_numpy(np.ascontiguousarray(tokens[:, 1:])),
    }


class PrefetchIterator:
    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 prefetch: int = 2):
        self.cfg = cfg
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._next_to_produce = start_step
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self) -> None:
        while not self._stop.is_set():
            try:
                b = batch_at(self.cfg, self._next_to_produce)
            except Exception as e:       # raised again in the consumer
                self._q.put((self._next_to_produce, e))
                return
            self._q.put((self._next_to_produce, b))
            self._next_to_produce += 1

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        step, b = self._q.get()
        if isinstance(b, Exception):
            raise b
        self.step = step
        return b

    def close(self) -> None:
        """Stop the producer: drain the queue until the thread has seen the
        stop flag and ended."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.01)
            except queue.Empty:
                pass


def pack_sequences(docs: list[np.ndarray], seq_len: int,
                   pad_id: int = 0) -> np.ndarray:
    """Greedy sequence packing: concatenate documents into rows of exactly
    seq_len tokens (no padding waste except the final row)."""
    flat = np.concatenate(docs) if docs else np.zeros(0, np.int32)
    n_rows = max(int(np.ceil(len(flat) / seq_len)), 1)
    out = np.full((n_rows, seq_len), pad_id, dtype=np.int32)
    for r in range(n_rows):
        row = flat[r * seq_len:(r + 1) * seq_len]
        out[r, : len(row)] = row
    return out
