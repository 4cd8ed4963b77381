"""Rating-stream datasets for the MF example and benchmarks.

A numpy-only copy of ``flink_parameter_server_tpu/data/movielens.py``: the port
imports nothing of the JAX package, whose ``__init__`` imports JAX.

The reference's canonical demo trains on MovieLens streams (SURVEY.md §6,
BASELINE.json configs).  This environment has no network egress, so we
provide (a) a loader for on-disk MovieLens-format files if present and (b)
a synthetic low-rank generator with MovieLens-like marginals (Zipfian item
popularity, user activity skew) — the skew is what stresses the sharded
scatter-add path, so the synthetic set preserves it.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def synthetic_ratings(
    num_users: int = 1000,
    num_items: int = 1200,
    num_ratings: int = 50_000,
    *,
    rank: int = 8,
    noise: float = 0.05,
    zipf_a: float = 1.2,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Low-rank ground-truth ratings with Zipf-skewed item popularity.

    Returns columns ``user``, ``item``, ``rating`` (float32 in ~[-1, 1])
    suitable for :func:`..data.streams.microbatches`.
    """
    rng = np.random.default_rng(seed)
    P = rng.normal(0, 1.0 / np.sqrt(rank), (num_users, rank)).astype(np.float32)
    Q = rng.normal(0, 1.0 / np.sqrt(rank), (num_items, rank)).astype(np.float32)
    users = rng.integers(0, num_users, num_ratings).astype(np.int32)
    # Zipf over item ranks, clipped to catalogue size.
    items = (rng.zipf(zipf_a, num_ratings) - 1) % num_items
    items = items.astype(np.int32)
    ratings = np.einsum("ij,ij->i", P[users], Q[items]).astype(np.float32)
    ratings += rng.normal(0, noise, num_ratings).astype(np.float32)
    return {"user": users, "item": items, "rating": ratings}


def load_movielens(
    path: str, *, max_ratings: Optional[int] = None, normalize: bool = True
) -> Dict[str, np.ndarray]:
    """Parse MovieLens ``ratings`` files (``u.data`` tab-separated 100K
    format or ``ratings.csv``/``ratings.dat`` 1M/20M formats) into columns.

    Ids are compacted to dense ranges; ratings optionally centred to
    ~[-1, 1] (mean-centred, /2) the way streaming-MF setups normalise."""
    if path.endswith(".csv"):
        raw = np.genfromtxt(
            path, delimiter=",", skip_header=1, usecols=(0, 1, 2), dtype=np.float64
        )
    elif "::" in open(path, "r").readline():
        raw = np.genfromtxt(path, delimiter="::", usecols=(0, 1, 2), dtype=np.float64)
    else:
        raw = np.genfromtxt(path, delimiter="\t", usecols=(0, 1, 2), dtype=np.float64)
    if max_ratings is not None:
        raw = raw[:max_ratings]
    users_raw = raw[:, 0].astype(np.int64)
    items_raw = raw[:, 1].astype(np.int64)
    ratings = raw[:, 2].astype(np.float32)
    _, users = np.unique(users_raw, return_inverse=True)
    _, items = np.unique(items_raw, return_inverse=True)
    if normalize:
        ratings = (ratings - ratings.mean()) / 2.0
    return {
        "user": users.astype(np.int32),
        "item": items.astype(np.int32),
        "rating": ratings,
    }


__all__ = ["synthetic_ratings", "load_movielens"]
