"""Deterministic host-sharded data pipeline with double-buffered prefetch.

Synthetic-but-learnable LM token streams: a seeded Markov-ish mixture of
n-gram templates over the vocab, so a few hundred training steps show a
clearly decreasing loss (used by examples/train_lm.py and the smoke tests).
Every batch is a pure function of (seed, step, host_id) — restart-safe and
identical across elastically re-sized runs that keep the global batch fixed.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 17
    global_batch: int = 8
    seq_len: int = 128
    n_templates: int = 64
    template_len: int = 16
    host_id: int = 0
    n_hosts: int = 1


class TokenStream:
    """Deterministic learnable token sequences."""

    def __init__(self, cfg: DataConfig, vocab_size: int):
        self.cfg = cfg
        self.vocab = vocab_size
        rng = np.random.default_rng(cfg.seed)
        self.templates = rng.integers(
            0, vocab_size, size=(cfg.n_templates, cfg.template_len))

    def batch(self, step: int) -> np.ndarray:
        """Global batch for a step; hosts slice their rows."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        reps = cfg.seq_len // cfg.template_len + 1
        ids = rng.integers(0, cfg.n_templates,
                           size=(cfg.global_batch, reps))
        toks = self.templates[ids].reshape(cfg.global_batch, -1)
        # sprinkle noise tokens so the task is not trivially memorizable
        noise = rng.random(toks.shape) < 0.02
        toks = np.where(noise, rng.integers(0, self.vocab, toks.shape), toks)
        return toks[:, :cfg.seq_len].astype(np.int32)

    def host_batch(self, step: int) -> Dict[str, np.ndarray]:
        toks = self.batch(step)
        per = self.cfg.global_batch // self.cfg.n_hosts
        lo = self.cfg.host_id * per
        return {"tokens": toks[lo:lo + per]}


class MaskedFrameStream:
    """HuBERT-style stream: frame embeddings + masked-prediction labels."""

    def __init__(self, cfg: DataConfig, d_model: int, vocab_size: int):
        self.cfg = cfg
        self.d = d_model
        self.vocab = vocab_size
        rng = np.random.default_rng(cfg.seed)
        # codebook: labels are recoverable from embeddings (learnable task)
        self.codebook = rng.normal(size=(vocab_size, d_model)).astype(
            np.float32)

    def host_batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step, 1))
        per = cfg.global_batch // cfg.n_hosts
        labels = rng.integers(0, self.vocab, size=(per, cfg.seq_len))
        emb = self.codebook[labels] + \
            0.1 * rng.normal(size=(per, cfg.seq_len, self.d))
        mask = rng.random((per, cfg.seq_len)) < 0.3
        return {"embeddings": emb.astype(np.float32),
                "labels": labels.astype(np.int32), "mask": mask}


def make_stream(cfg: ArchConfig, data_cfg: DataConfig):
    if cfg.embedding_inputs:
        return MaskedFrameStream(data_cfg, cfg.d_model, cfg.vocab_size)
    return TokenStream(data_cfg, cfg.vocab_size)


class Prefetcher:
    """Double-buffered background prefetch of host batches."""

    def __init__(self, stream, start_step: int = 0, depth: int = 2):
        self.stream = stream
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.stream.host_batch(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
