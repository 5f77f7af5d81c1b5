"""Data pipeline: deterministic synthetic LM corpus + file-backed byte
corpus, host-sharded batching with background prefetch.

The synthetic corpus is a first-order Markov chain over a Zipf vocabulary:
it has real learnable structure (bigram statistics), so a small LM trained
on it reaches a perplexity well below uniform, and PTQ degradation is
measurable against it.

Everything here is numpy, drawn in the JAX package's order of draws, so a
seed gives the same tokens in both packages. Batches are numpy int32
arrays; the caller moves them to its device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Iterator

import numpy as np

__all__ = ["DataConfig", "SyntheticCorpus", "ByteCorpus", "batch_iterator",
           "Prefetcher"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    batch_size: int          # per-host batch
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1


class SyntheticCorpus:
    """Markov-Zipf synthetic token stream (deterministic per seed)."""

    def __init__(self, vocab: int, seed: int = 0, branching: int = 32):
        self.vocab = vocab
        rng = np.random.default_rng(seed)
        # each token transitions to `branching` preferred successors
        self.succ = rng.integers(0, vocab, size=(vocab, branching))
        probs = 1.0 / np.arange(1, branching + 1)
        self.succ_p = probs / probs.sum()
        base = 1.0 / np.arange(1, vocab + 1) ** 1.1
        self.base_p = base / base.sum()

    def sample(self, rng: np.random.Generator, length: int) -> np.ndarray:
        out = np.empty(length, np.int32)
        tok = int(rng.choice(self.vocab, p=self.base_p))
        for i in range(length):
            out[i] = tok
            if rng.random() < 0.85:
                tok = int(self.succ[tok, rng.choice(len(self.succ_p),
                                                    p=self.succ_p)])
            else:
                tok = int(rng.choice(self.vocab, p=self.base_p))
        return out


class ByteCorpus:
    """File-backed byte-level corpus (vocab 256)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.data = np.frombuffer(f.read(), dtype=np.uint8)
        if len(self.data) < 2:
            raise ValueError("corpus too small")

    @property
    def vocab(self) -> int:
        return 256

    def sample(self, rng: np.random.Generator, length: int) -> np.ndarray:
        start = int(rng.integers(0, max(1, len(self.data) - length - 1)))
        chunk = self.data[start:start + length]
        if len(chunk) < length:
            chunk = np.pad(chunk, (0, length - len(chunk)))
        return chunk.astype(np.int32)


def batch_iterator(corpus, cfg: DataConfig) -> Iterator[dict]:
    """Yields {"tokens": [B, S], "labels": [B, S]} int32 batches.

    Host-sharded: host i draws from a disjoint seed stream, so a multi-host
    launch partitions the data without coordination.
    """
    rng = np.random.default_rng(cfg.seed * cfg.num_hosts + cfg.host_id + 1)
    while True:
        seqs = np.stack([corpus.sample(rng, cfg.seq_len + 1)
                         for _ in range(cfg.batch_size)])
        yield {"tokens": seqs[:, :-1].astype(np.int32),
               "labels": seqs[:, 1:].astype(np.int32)}


class Prefetcher:
    """Background-thread prefetch (builds the next batches while the device
    runs the step). The draws are Python loops that hold the interpreter
    lock, so the thread competes with the thread that launches the step's
    kernels: whether it helps is a measurement, not a given."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.it = it
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.thread = threading.Thread(target=self._fill, daemon=True)
        self._stop = False
        self.thread.start()

    def _fill(self):
        try:
            for item in self.it:
                if self._stop:
                    return
                self.q.put(item)
        finally:
            self.q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self, timeout: float = 60.0):
        """Stop the thread: it ends after the draw in hand. The queue is
        drained meanwhile, so a thread blocked on a full queue gets out."""
        self._stop = True
        deadline = time.monotonic() + timeout
        while self.thread.is_alive():
            if time.monotonic() > deadline:
                raise TimeoutError("the prefetch thread did not stop")
            try:
                self.q.get(timeout=0.05)
            except queue.Empty:
                pass
        self.thread.join()
