"""Streaming sketches on the PS: count-min, Bloom co-occurrence and
tug-of-war (AMS), with time-aware decay.

Counterpart of ``flink_parameter_server_tpu/models/sketches.py`` (the
reference system's PS-backed sketches, SURVEY.md §2 #10).  A sketch is a
parameter store, a flat counter table, and an update is a push: hash the
microbatch's items with the uint32 family of :mod:`..ops.hashing` and
scatter-add the counts (with ``scatter_impl="pallas"``, one K1 launch a
step).  Queries are pulls and a min or median.  The counters are float32
holding whole numbers, so every arm of the push sums them exactly while
a counter stays below 2**24.

The logics compute on the device of the batch they are given
(``transform_batched`` puts it on the store's); ``make_store`` takes the
store's ``device`` (default ``"cuda"``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.batched import BatchedWorkerLogic, PushRequest
from ..core.store import ShardedParamStore
from ..ops.hashing import bucket_hash, hash_params, pair_key, sign_hash
from ..ops.topk import _pad_topk, top_k
from ..utils.initializers import zeros


@dataclasses.dataclass(frozen=True)
class CountMinConfig:
    width: int = 4096
    depth: int = 4
    seed: int = 0

    @property
    def capacity(self) -> int:
        return self.width * self.depth


def _counts(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    counts = batch.get("count")
    if counts is None:
        return torch.ones(batch["key"].shape, dtype=torch.float32, device=batch["key"].device)
    return counts.to(torch.float32)


def _lane_mask(batch: Dict[str, torch.Tensor], shape) -> torch.Tensor:
    mask = batch.get("mask")
    return None if mask is None else mask.unsqueeze(1).expand(shape)


class CountMinSketch(BatchedWorkerLogic):
    """Count-min over a keyed stream.  Batch: ``key`` (B,) int ids,
    optional ``count`` (B,), ``mask`` (B,).  The store is the flat
    (depth·width,) counter table; row d of the sketch holds ids
    ``[d·width, (d+1)·width)``."""

    def __init__(self, config: CountMinConfig):
        self.config = config
        self._a, self._b = hash_params(config.depth, config.seed)
        self._row_offset = np.arange(config.depth, dtype=np.int64) * config.width

    def cells(self, keys: torch.Tensor) -> torch.Tensor:
        """(B, depth) int32 flat cell ids of each key."""
        buckets = bucket_hash(keys, self._a, self._b, self.config.width)
        offset = torch.as_tensor(self._row_offset, dtype=torch.int32, device=buckets.device)
        return buckets + offset

    def init_state(self, rng=None):
        return ()

    def keys(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.cells(batch["key"])

    def step(self, state, batch: Dict[str, torch.Tensor], pulled: torch.Tensor):
        deltas = _counts(batch).unsqueeze(1).expand(pulled.shape)
        # the estimate BEFORE this batch's increment (streaming pre-count)
        out = {"estimate": pulled.min(dim=1).values}
        return state, PushRequest(self.keys(batch), deltas, _lane_mask(batch, deltas.shape)), out

    def make_store(self, *, mesh=None, **store_opts) -> ShardedParamStore:
        """``store_opts`` (``scatter_impl``, ``layout``, ``device``) pass
        through to :meth:`ShardedParamStore.create`; ``mesh`` row-blocks
        the counters over its ``ps`` axis (integer sums: exact)."""
        return ShardedParamStore.create(
            self.config.capacity, (), init_fn=zeros(()), mesh=mesh, **store_opts
        )

    def query(self, store: ShardedParamStore, keys: torch.Tensor) -> torch.Tensor:
        """Point estimate: the min over the depth rows' cells."""
        return store.pull(self.cells(keys)).min(dim=1).values

    def top_k(
        self, store: ShardedParamStore, candidate_ids: torch.Tensor, k: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Heavy hitters among ``candidate_ids``: (estimates, ids) of the
        k largest estimated counts, ties lowest position first as
        ``lax.top_k`` breaks them; padded with -inf / -1 to a static (k,)."""
        est = self.query(store, candidate_ids)
        top_est, pos = top_k(est, min(k, candidate_ids.shape[0]))
        ids = candidate_ids[pos]
        top_est, ids = _pad_topk(top_est.unsqueeze(0), ids.unsqueeze(0), k)
        return top_est[0], ids[0]


class BloomCooccurrence(CountMinSketch):
    """Co-occurrence counts of unordered word pairs.  Batch: ``word_a`` /
    ``word_b`` (B,).  Pair ids come from a mixing pairing function, then
    are count-min counted; :meth:`similarity` gives the normalised
    co-occurrence score used for streaming word similarity."""

    PAIR_SPACE = 1 << 30

    def keys(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.cells(pair_key(batch["word_a"], batch["word_b"], self.PAIR_SPACE))

    def step(self, state, batch: Dict[str, torch.Tensor], pulled: torch.Tensor):
        b2 = dict(batch)
        b2["key"] = pair_key(batch["word_a"], batch["word_b"], self.PAIR_SPACE)
        return super().step(state, b2, pulled)

    def query_pair(self, store: ShardedParamStore, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.query(store, pair_key(a, b, self.PAIR_SPACE))

    def similarity(
        self,
        pair_store: ShardedParamStore,
        word_store: ShardedParamStore,
        word_sketch: CountMinSketch,
        a: torch.Tensor,
        b: torch.Tensor,
        eps: float = 1e-6,
    ) -> torch.Tensor:
        """Cosine-style similarity c(a,b) / sqrt(c(a) c(b))."""
        cab = self.query_pair(pair_store, a, b)
        ca = word_sketch.query(word_store, a)
        cb = word_sketch.query(word_store, b)
        return cab / torch.sqrt(torch.clamp_min(ca * cb, eps))


@dataclasses.dataclass(frozen=True)
class TugOfWarConfig:
    """AMS F2 sketch: ``groups × per_group`` ±1 counters; the estimate is
    the median over groups of the mean of squared counters."""

    groups: int = 8
    per_group: int = 16
    seed: int = 1

    @property
    def num_estimators(self) -> int:
        return self.groups * self.per_group


class TugOfWarSketch(BatchedWorkerLogic):
    """Second-moment (F2) sketch over a keyed stream.  Every item updates
    every estimator (a dense small push): z_j += s_j(key) · count."""

    def __init__(self, config: TugOfWarConfig):
        self.config = config
        self._a, self._b = hash_params(config.num_estimators, config.seed)

    def init_state(self, rng=None):
        return ()

    def keys(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        key = batch["key"]
        est = torch.arange(self.config.num_estimators, dtype=torch.int32, device=key.device)
        return est.unsqueeze(0).expand(key.shape[0], -1)

    def step(self, state, batch: Dict[str, torch.Tensor], pulled: torch.Tensor):
        signs = sign_hash(batch["key"], self._a, self._b)  # (B, E)
        deltas = signs * _counts(batch).unsqueeze(1)
        return state, PushRequest(self.keys(batch), deltas, _lane_mask(batch, deltas.shape)), {}

    def make_store(self, *, mesh=None, **store_opts) -> ShardedParamStore:
        return ShardedParamStore.create(
            self.config.num_estimators, (), init_fn=zeros(()), mesh=mesh, **store_opts
        )

    def estimate_f2(self, store: ShardedParamStore) -> torch.Tensor:
        """Median-of-means estimate of Σ f_x².  The median of an even
        count is the mean of the middle pair, as ``jnp.median`` takes it
        (``torch.median`` would return the lower one)."""
        z = store.values().reshape(self.config.groups, self.config.per_group)
        means, _ = torch.sort((z * z).mean(dim=1))
        g = means.shape[0]
        if g % 2:
            return means[g // 2]
        return (means[g // 2 - 1] + means[g // 2]) / 2


def decay(store: ShardedParamStore, gamma: float) -> ShardedParamStore:
    """Time-aware variant: every counter times ``gamma``, once per time
    window.  Returns a new store whose table is a new tensor, so the
    caller's store, which a step may update in place, is not aliased."""
    return ShardedParamStore(store.spec, store.table * gamma)


__all__ = [
    "CountMinConfig",
    "CountMinSketch",
    "BloomCooccurrence",
    "TugOfWarConfig",
    "TugOfWarSketch",
    "decay",
]
