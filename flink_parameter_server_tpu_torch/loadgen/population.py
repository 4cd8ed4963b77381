"""A synthetic user population — who arrives, from where, wanting what.

A copy of ``flink_parameter_server_tpu/loadgen/population.py``, which imports
no JAX: the port imports nothing of the JAX package, whose ``__init__``
imports JAX.  Modules it names that the port does not have yet are the
reference's.

The "millions of users" claim is a statement about *traffic shape*,
not just volume: real request streams are Zipf-skewed (a celebrity
head on a uniform tail — the distribution the hotcache tier and the
count-min sketches are built for), and they mix read and write traffic
unevenly by region (a serving-heavy consumer region next to a
training-heavy ingest region).  This module samples that shape
deterministically:

  * **key popularity** — item ranks follow a truncated Zipf(``s``)
    law; rank → id through a seeded permutation so the hot head is not
    trivially ``[0..k)``;
  * **regions** — each :class:`Region` carries a traffic ``weight``
    and a ``serve_frac`` (the read share of its traffic); a sampled
    request is a serving lookup or a training push according to its
    region's mix;
  * **users** — Zipf-ranked too (heavy users exist), routed stably so
    one user's pushes land on one logical writer.

Requests come out of :meth:`UserPopulation.sample` one at a time from
a caller-owned ``numpy`` Generator — the soak runner hands each
generator thread its own seeded stream, so the composed experiment is
reproducible from ``(population seed, per-thread seeds)`` alone.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Region:
    """One traffic region: relative ``weight`` of all arrivals, and
    the fraction of its traffic that is serving reads (the rest is
    training pushes)."""

    name: str
    weight: float = 1.0
    serve_frac: float = 0.9

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"region {self.name}: weight must be > 0")
        if not 0.0 <= self.serve_frac <= 1.0:
            raise ValueError(
                f"region {self.name}: serve_frac in [0, 1]"
            )


DEFAULT_REGIONS: Tuple[Region, ...] = (
    Region("us", weight=0.5, serve_frac=0.95),
    Region("eu", weight=0.3, serve_frac=0.9),
    Region("ingest", weight=0.2, serve_frac=0.4),
)


@dataclasses.dataclass(frozen=True)
class Request:
    """One sampled request: a serving lookup (``kind="serve"``) over
    ``ids`` or a training push (``kind="train"``) of deltas to
    ``ids``."""

    kind: str            # "serve" | "train"
    region: str
    user: int
    ids: np.ndarray      # item ids touched (int64)


def _zipf_pmf(n: int, s: float) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-float(s))
    return w / w.sum()


class UserPopulation:
    """Seeded Zipf population with regional train/serve mixes."""

    def __init__(
        self,
        num_users: int,
        num_items: int,
        *,
        zipf_s: float = 1.1,
        batch_ids: int = 4,
        regions: Optional[Sequence[Region]] = None,
        seed: int = 0,
    ):
        if num_users < 1 or num_items < 1:
            raise ValueError("need num_users >= 1 and num_items >= 1")
        if batch_ids < 1:
            raise ValueError(f"batch_ids={batch_ids}: must be >= 1")
        if zipf_s <= 0:
            raise ValueError(f"zipf_s={zipf_s}: must be > 0")
        self.num_users = int(num_users)
        self.num_items = int(num_items)
        self.batch_ids = int(batch_ids)
        self.zipf_s = float(zipf_s)
        self.regions: Tuple[Region, ...] = tuple(
            regions if regions is not None else DEFAULT_REGIONS
        )
        w = np.asarray([r.weight for r in self.regions], np.float64)
        self._region_p = w / w.sum()
        rng = np.random.default_rng(seed)
        # rank -> id permutations: the hot head is a seeded secret, not
        # the first k ids (a cache keyed on "small ids are hot" would
        # pass a dishonest version of this test)
        self._item_by_rank = rng.permutation(self.num_items).astype(
            np.int64
        )
        self._user_by_rank = rng.permutation(self.num_users).astype(
            np.int64
        )
        self._item_pmf = _zipf_pmf(self.num_items, self.zipf_s)
        self._user_pmf = _zipf_pmf(self.num_users, self.zipf_s)

    # -- introspection -------------------------------------------------------
    def hot_items(self, top_n: int) -> np.ndarray:
        """The ``top_n`` most popular item ids (by construction) — what
        a static lease policy or a cache-size budget keys on."""
        return self._item_by_rank[: max(0, int(top_n))].copy()

    def head_share(self, top_n: int) -> float:
        """Probability mass carried by the ``top_n`` hottest items —
        the skew figure a storm headline quotes ("1% of keys take
        90%")."""
        return float(self._item_pmf[: max(0, int(top_n))].sum())

    # -- sampling ------------------------------------------------------------
    def sample(self, rng: np.random.Generator) -> Request:
        """One request from the caller's stream: region → kind by the
        region's mix → Zipf user + Zipf item batch."""
        ridx = int(rng.choice(len(self.regions), p=self._region_p))
        region = self.regions[ridx]
        kind = "serve" if rng.random() < region.serve_frac else "train"
        user = int(
            self._user_by_rank[
                int(rng.choice(self.num_users, p=self._user_pmf))
            ]
        )
        ranks = rng.choice(
            self.num_items, size=self.batch_ids, p=self._item_pmf
        )
        return Request(
            kind=kind, region=region.name, user=user,
            ids=self._item_by_rank[ranks].astype(np.int64),
        )

    def request_stream(
        self, n: int, *, seed: int = 0
    ) -> List[Request]:
        """``n`` requests from a fresh seeded stream (test helper; the
        soak runner samples lazily per generator thread instead)."""
        rng = np.random.default_rng(seed)
        return [self.sample(rng) for _ in range(int(n))]


__all__ = [
    "DEFAULT_REGIONS",
    "Region",
    "Request",
    "UserPopulation",
]
