"""Synthetic token data pipeline (offline container: no corpus downloads).

Generates a learnable deterministic language — a mixture of k-gram Markov
chains — so smoke training shows a real, monotonically decreasing loss,
plus the modality-stub inputs (patch/frame embeddings) the VLM and audio
families require.  Batches are produced with a double-buffered iterator.
"""
from __future__ import annotations

import threading
from queue import Queue
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


class MarkovCorpus:
    """Order-2 Markov chain over a reduced alphabet, embedded into the
    model's vocab — highly predictable, so NLL should drop fast."""

    def __init__(self, vocab_size: int, alphabet: int = 64, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.alphabet = min(alphabet, vocab_size)
        self.vocab_size = vocab_size
        # sparse transitions: each (a,b) context allows 4 next symbols
        self.next_syms = rng.integers(
            0, self.alphabet, (self.alphabet, self.alphabet, 4))
        self.probs = rng.dirichlet(np.ones(4) * 0.4,
                                   (self.alphabet, self.alphabet))
        self.embed_map = rng.permutation(vocab_size)[:self.alphabet]

    def sample(self, rng, batch: int, seq: int) -> np.ndarray:
        out = np.zeros((batch, seq), np.int64)
        a = rng.integers(0, self.alphabet, batch)
        b = rng.integers(0, self.alphabet, batch)
        for t in range(seq):
            u = rng.random(batch)
            cum = np.cumsum(self.probs[a, b], axis=-1)
            idx = (u[:, None] < cum).argmax(-1)
            c = self.next_syms[a, b, idx]
            out[:, t] = c
            a, b = b, c
        return self.embed_map[out]


def data_iterator(cfg: ModelConfig, batch: int, seq_len: int, *,
                  seed: int = 0, prefetch: int = 2
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """Double-buffered batch iterator matching the model's input spec."""
    corpus = MarkovCorpus(cfg.vocab_size, seed=seed)
    rng = np.random.default_rng(seed + 1)
    s_text = seq_len - (cfg.n_patches or 0)

    def make() -> Dict[str, np.ndarray]:
        b: Dict[str, np.ndarray] = {
            "tokens": corpus.sample(rng, batch, s_text).astype(np.int32)}
        if cfg.n_patches:
            b["patches"] = rng.standard_normal(
                (batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
        if cfg.family == "encdec":
            b["frames"] = rng.standard_normal(
                (batch, cfg.enc_seq, cfg.d_model)).astype(np.float32) * 0.1
        return b

    q: "Queue[Optional[Dict]]" = Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        while not stop.is_set():
            q.put(make())

    th = threading.Thread(target=producer, daemon=True)
    th.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
