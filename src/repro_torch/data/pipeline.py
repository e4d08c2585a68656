"""Deterministic synthetic LM data with a controllable heavy tail (port of
``repro/data/pipeline.py``; the numpy code is the same, so a seed and a step
give the same batch in both packages).

Token frequencies follow p(t) ∝ 1/(t+1)^alpha with a bigram structure so the
model has something learnable. Batch content is a pure function of
(seed, step), so restarts resume mid-stream.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    alpha: float = 1.2           # Zipf tail exponent (larger = lighter tail)
    n_states: int = 512          # Markov bigram states for learnable structure
    seed: int = 0


class ZipfLM:
    """Stateless batch generator: ``batch(step)`` is deterministic."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        base = 1.0 / ranks ** cfg.alpha
        base /= base.sum()
        self.base = base
        # per-state preferred continuation: mixture of the Zipf base and a
        # state-specific boost so P(next | state) is learnable
        k = min(cfg.n_states, v)
        self.state_boost = rng.integers(0, v, size=(k, 8))
        self.n_states = k

    def _tokens(self, rng: np.random.Generator, n: int) -> np.ndarray:
        cfg = self.cfg
        out = np.empty(n, dtype=np.int32)
        state = int(rng.integers(0, self.n_states))
        base_draw = rng.choice(cfg.vocab_size, size=n, p=self.base)
        mix = rng.random(n) < 0.5
        for i in range(n):
            if mix[i]:
                out[i] = self.state_boost[state, int(rng.integers(0, 8))]
            else:
                out[i] = base_draw[i]
            state = out[i] % self.n_states
        return out

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """The batch at ``step`` (the JAX package's single-host stream:
        ``host_id`` 0 of 1)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step, 0))
        toks = self._tokens(rng, cfg.global_batch * (cfg.seq_len + 1)).reshape(cfg.global_batch, cfg.seq_len + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(np.int32)}


# ---------------------------------------------------------------------------
# Tiny real-text corpus for the two-layer linear-model experiment (§4.1):
# word tokenization over an embedded sample so the token distribution has a
# natural heavy tail.
# ---------------------------------------------------------------------------

_SAMPLE = (
    "the quick brown fox jumps over the lazy dog . the dog sleeps . "
    "a model of language must learn the long tail of rare words . "
    "optimization of deep networks with adaptive methods is the standard . "
    "the second moments of the gradients concentrate along certain dimensions . "
    "rare tokens receive rare gradient updates and so their moments evolve slowly . "
    "frequent tokens receive frequent updates and their moments grow quickly . "
    "this difference in time scale is why the token dimension resists compression . "
    "signal to noise ratios quantify when a mean can stand in for the many . "
) * 64


def byte_corpus(vocab_size: int, seq_len: int, *, seed: int = 0) -> Tuple[np.ndarray, int]:
    """Frequency-truncated word tokenizer: maps the sample text onto
    ``vocab_size`` ids, every word outside the ``vocab_size - 1`` most
    frequent going to the last id. Returns (token stream, effective vocab)."""
    words = _SAMPLE.split()
    uniq, counts = np.unique(words, return_counts=True)
    order = np.argsort(-counts)
    vocab = {w: i for i, w in enumerate(uniq[order][: vocab_size - 1])}
    ids = np.array([vocab.get(w, vocab_size - 1) for w in words], dtype=np.int32)
    return ids, vocab_size


def linear_model_batches(vocab_size: int, seq_len: int, batch: int, *, seed: int = 0) -> ZipfLM:
    """Batches for the §4.1 two-layer model: the Zipf stream (alpha 1.1) at
    the requested vocabulary size, progressively truncating the tail like
    the paper's BPE vocabulary sweep."""
    return ZipfLM(DataConfig(vocab_size=vocab_size, seq_len=seq_len, global_batch=batch, alpha=1.1, seed=seed))
