"""Token-stream data for word2vec and the sketch apps.

Counterpart of ``flink_parameter_server_tpu/data/text.py``, which is numpy
only; the port keeps its own copy so that it imports nothing of the JAX
package.  Both packages make the same batches from the same seed.  A
synthetic Zipf corpus with planted co-occurrence structure (topic blocks)
keeps the skewed unigram distribution that stresses the scatter-add path.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def synthetic_corpus(
    vocab_size: int = 5000,
    length: int = 200_000,
    *,
    num_topics: int = 10,
    zipf_a: float = 1.3,
    topic_stickiness: float = 0.98,
    seed: int = 0,
) -> np.ndarray:
    """Token stream with Zipf marginals and topical co-occurrence: words
    are partitioned into topics; the stream is a sticky Markov chain over
    topics, drawing Zipf-ranked words within the current topic."""
    rng = np.random.default_rng(seed)
    words_per_topic = vocab_size // num_topics
    topic = 0
    # per-topic Zipf ranks
    ranks = (rng.zipf(zipf_a, length) - 1) % words_per_topic
    switches = rng.random(length) > topic_stickiness
    topics = np.empty(length, np.int32)
    for i in range(length):
        if switches[i]:
            topic = rng.integers(0, num_topics)
        topics[i] = topic
    tokens = (topics * words_per_topic + ranks).astype(np.int32)
    return tokens


def unigram_table(tokens: np.ndarray, vocab_size: int, power: float = 0.75):
    counts = np.bincount(tokens, minlength=vocab_size).astype(np.float64)
    probs = counts**power
    probs /= probs.sum()
    return probs


def skipgram_batches(
    tokens: np.ndarray,
    vocab_size: int,
    *,
    batch_size: int = 1024,
    window: int = 4,
    num_negatives: int = 5,
    epochs: int = 1,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """(center, context, negatives) microbatches with unigram^0.75
    negative sampling — the host-side pair generator feeding the SGNS
    step."""
    rng = np.random.default_rng(seed)
    probs = unigram_table(tokens, vocab_size)
    n = len(tokens)
    for _ in range(epochs):
        centers, contexts = [], []
        # dynamic window like word2vec: uniform in [1, window]
        for i in rng.permutation(n):
            w = rng.integers(1, window + 1)
            j = i + rng.integers(-w, w + 1)
            if j == i or j < 0 or j >= n:
                continue
            centers.append(tokens[i])
            contexts.append(tokens[j])
            if len(centers) == batch_size:
                yield _pair_batch(centers, contexts, batch_size, rng,
                                  vocab_size, num_negatives, probs)
                centers, contexts = [], []
        if centers:  # pad+mask the epoch's tail (framework convention)
            yield _pair_batch(centers, contexts, batch_size, rng,
                              vocab_size, num_negatives, probs)


def _pair_batch(centers, contexts, batch_size, rng, vocab_size,
                num_negatives, probs) -> Dict[str, np.ndarray]:
    n = len(centers)
    pad = batch_size - n
    return {
        "center": np.array(centers + [0] * pad, np.int32),
        "context": np.array(contexts + [0] * pad, np.int32),
        "negatives": rng.choice(
            vocab_size, (batch_size, num_negatives), p=probs
        ).astype(np.int32),
        "mask": np.arange(batch_size) < n,
    }


def cooccurrence_pairs(
    tokens: np.ndarray,
    *,
    window: int = 2,
    batch_size: int = 2048,
) -> Iterator[Dict[str, np.ndarray]]:
    """Sliding-window unordered co-occurrence pairs for the bloom sketch."""
    a_buf, b_buf = [], []
    n = len(tokens)

    def emit(a_buf, b_buf):
        pad = batch_size - len(a_buf)
        return {
            "word_a": np.array(a_buf + [0] * pad, np.int32),
            "word_b": np.array(b_buf + [0] * pad, np.int32),
            "mask": np.arange(batch_size) < len(a_buf),
        }

    for i in range(n - 1):
        for j in range(i + 1, min(i + 1 + window, n)):
            a_buf.append(tokens[i])
            b_buf.append(tokens[j])
            if len(a_buf) == batch_size:
                yield emit(a_buf, b_buf)
                a_buf, b_buf = [], []
    if a_buf:  # pad+mask the tail instead of dropping it
        yield emit(a_buf, b_buf)


__all__ = [
    "synthetic_corpus",
    "unigram_table",
    "skipgram_batches",
    "cooccurrence_pairs",
]
