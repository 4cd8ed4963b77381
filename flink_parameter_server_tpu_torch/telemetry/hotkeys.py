"""Hot-key traffic analytics — who is actually being pulled/pushed?

Counterpart of ``flink_parameter_server_tpu/telemetry/hotkeys.py``.  A
bounded-memory sketch pair over pull/push key streams:

  * **count-min** (Cormode–Muthukrishnan): ``depth × width`` counters,
    per-row hashes from :func:`~..ops.hashing.fmix32_np`; the estimate
    for any key overestimates its true count by at most
    ``ε·N = (e/width)·N`` with probability ``1 − e^−depth``;
  * **space-saving** (Metwally et al.): exact top-K candidate
    tracking in ``K`` counters; every key whose true count exceeds
    ``N/K`` is guaranteed present, and each reported count carries its
    per-key overestimation bound ``err``.

The sketches are host-side numpy, as the reference's are: the ids reach
a shard as host arrays, and :meth:`HotKeySketch.observe` only buffers
them (one vectorised unique/bincount pass per ~16k ids).  Per-shard
sketches register with the process-wide :class:`HotKeyAggregator`;
merging is exact for count-min (same seeds/shape → table addition) and
standard-approximate for space-saving (missing-side minima fold into
``err``).  The one device step is the aggregator's final cross-shard
top-K: :meth:`HotKeyAggregator.top_k` ranks the merged candidates' counts
with :func:`~..ops.topk.dense_topk` on the aggregator's ``device`` (the
card unless the caller asks for the CPU; no card raises).
:meth:`HotKeyAggregator.candidates` is the device-free Python ranking of
the same candidate set.
"""
from __future__ import annotations

import heapq
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.hashing import fmix32_np
from ..ops.topk import dense_topk
from ..utils.device import DeviceLike, resolve_device


class CountMinSketch:
    """Conservative frequency estimates in ``depth × width`` int64
    counters.  ``add`` is vectorized (one ``np.add.at`` per row);
    ``merge`` requires identical (width, depth, seed)."""

    def __init__(self, width: int = 2048, depth: int = 4, seed: int = 0):
        if width < 8 or depth < 1:
            raise ValueError(
                f"width={width}, depth={depth}: need width >= 8, depth >= 1"
            )
        self.width = int(width)
        self.depth = int(depth)
        self.seed = int(seed)
        self.table = np.zeros((self.depth, self.width), np.int64)
        self.total = 0
        # per-row salts: fmix32(id * odd + salt) decorrelates the rows
        rng = np.random.default_rng(self.seed)
        self._salts = rng.integers(1, 2**31, size=self.depth, dtype=np.int64)
        self._salts32 = self._salts.astype(np.uint32)

    @property
    def epsilon(self) -> float:
        """Overestimation factor: ``estimate − true ≤ ε·N`` w.p.
        ``1 − e^−depth``."""
        return math.e / self.width

    def _rows(self, ids: np.ndarray) -> np.ndarray:
        # all depth rows in one vectorized uint32 mix (wraparound IS
        # the & 0xFFFFFFFF; staying in uint32 avoids int64 temporaries
        # on the per-request hot path)
        ids32 = np.asarray(ids).reshape(-1).astype(np.uint32)
        with np.errstate(over="ignore"):
            h = (
                ids32[None, :] * np.uint32(0x9E3779B1)
                + self._salts32[:, None]
            )
        return np.asarray(fmix32_np(h), np.int64) % self.width

    def add(self, ids, counts=None) -> None:
        ids = np.asarray(ids).reshape(-1)
        if ids.size == 0:
            return
        # one bincount over flattened (row, slot) indices: much cheaper
        # than per-row np.add.at on the per-request hot path (and the
        # unweighted integer path when counts are implicit ones)
        slots = self._rows(ids)
        flat = (
            slots + (np.arange(self.depth, dtype=np.int64)[:, None]
                     * self.width)
        ).reshape(-1)
        size = self.depth * self.width
        if counts is None:
            delta = np.bincount(flat, minlength=size).astype(np.int64)
            total = ids.size
        else:
            counts = np.asarray(counts, np.int64).reshape(-1)
            w = np.broadcast_to(
                counts, (self.depth, ids.size)
            ).reshape(-1)
            delta = np.bincount(flat, weights=w, minlength=size).astype(
                np.int64
            )
            total = int(counts.sum())
        self.table += delta.reshape(self.depth, self.width)
        self.total += total

    def estimate(self, ids) -> np.ndarray:
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size == 0:
            return np.zeros(0, np.int64)
        slots = self._rows(ids)
        ests = self.table[np.arange(self.depth)[:, None], slots]
        return ests.min(axis=0)

    def merge(self, other: "CountMinSketch") -> None:
        if (self.width, self.depth, self.seed) != (
            other.width, other.depth, other.seed
        ):
            raise ValueError(
                "count-min merge needs identical (width, depth, seed)"
            )
        self.table += other.table
        self.total += other.total

    def halve(self) -> None:
        """Windowed decay: halve every counter (and the stream total).
        Halving preserves the overestimation guarantee relative to the
        halved stream — the exponential-decay trick that keeps the
        estimates tracking CURRENT traffic instead of all-time
        traffic."""
        self.table >>= 1
        self.total //= 2


class SpaceSavingTopK:
    """Metwally space-saving: at most ``capacity`` tracked keys; every
    key with true count > N/capacity is guaranteed tracked, and each
    tracked key's count overestimates truth by at most its ``err``."""

    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError(f"capacity={capacity}: must be >= 1")
        self.capacity = int(capacity)
        self._counts: Dict[int, int] = {}
        self._errs: Dict[int, int] = {}
        self.total = 0
        # sorted key cache for vectorized membership tests (rebuilt
        # whenever the tracked set changes)
        self._key_cache: Optional[np.ndarray] = None

    def update(
        self, ids, counts=None, *, assume_unique: bool = False
    ) -> None:
        """Batch update.  Tracked keys accumulate exactly; untracked
        keys compete for slots in ONE merge step per batch — the
        incoming batch is treated as an exact sketch and space-saving-
        merged in (each admitted newcomer inherits the pre-batch
        minimum as count floor and error, the same invariant as
        per-item insertion, vectorized so the per-request cost is
        O(uniq + k) instead of O(uniq · k)).  ``assume_unique`` skips
        the dedupe when the caller already collapsed the batch (the
        sketch flush path)."""
        ids = np.asarray(ids).reshape(-1)
        if ids.size == 0:
            return
        if assume_unique:
            uniq = ids
            c = (
                np.ones(ids.size, np.int64) if counts is None
                else np.asarray(counts, np.int64).reshape(-1)
            )
        elif counts is None:
            uniq, c = np.unique(ids, return_counts=True)
        else:
            counts = np.asarray(counts, np.int64).reshape(-1)
            uniq, inv = np.unique(ids, return_inverse=True)
            c = np.zeros(uniq.size, np.int64)
            np.add.at(c, inv, counts)
        self.total += int(c.sum())
        cs, errs = self._counts, self._errs
        # vectorized membership against the sorted key cache: the
        # absent set on a Zipf tail can be thousands of keys per
        # flush, and a python `in` loop over them dominated profiles
        if self._key_cache is None:
            self._key_cache = np.fromiter(
                sorted(cs.keys()), np.int64, len(cs)
            )
        cache = self._key_cache
        if cache.size:
            pos = np.searchsorted(cache, uniq)
            present = (pos < cache.size) & (
                cache[np.minimum(pos, cache.size - 1)] == uniq
            )
        else:
            present = np.zeros(uniq.size, bool)
        for key, n in zip(uniq[present].tolist(), c[present].tolist()):
            cs[key] += n  # at most `capacity` iterations
        absent_k, absent_c = uniq[~present], c[~present]
        if absent_k.size == 0:
            return
        # only the top `capacity` newcomers can possibly survive the
        # trim — cap the dict churn before touching python objects
        if absent_k.size > self.capacity:
            top = np.argpartition(-absent_c, self.capacity - 1)[
                : self.capacity
            ]
            absent_k, absent_c = absent_k[top], absent_c[top]
        free = self.capacity - len(cs)
        if absent_k.size <= free:
            for key, n in zip(absent_k.tolist(), absent_c.tolist()):
                cs[key] = n
                errs[key] = 0
            self._key_cache = None
            return
        # strongest newcomers first: free slots go to the largest
        # batch counts, and the displacement floors below ratchet in
        # the same order per-item insertion would visit them
        order = np.argsort(-absent_c, kind="stable")
        absent_k, absent_c = absent_k[order], absent_c[order]
        if free > 0:
            for key, n in zip(
                absent_k[:free].tolist(), absent_c[:free].tolist()
            ):
                cs[key] = n
                errs[key] = 0
            absent_k, absent_c = absent_k[free:], absent_c[free:]
        # at capacity: sequential space-saving over a min-heap of the
        # live counts — each admitted newcomer displaces the CURRENT
        # minimum, entering at (displaced count + n) with err capped
        # at the displaced key's count, i.e. the bound on how often
        # the newcomer could have occurred unseen in that slot.  Giving
        # every newcomer the same pre-batch floor and trimming the union
        # by raw count could evict incumbents counted above the rolling
        # minimum (over-admission); with the ratcheting heap floor a
        # batch admits exactly what per-item insertion admits, and
        # errors ratchet with it.
        heap = [(c, k) for k, c in cs.items()]
        heapq.heapify(heap)
        for key, n in zip(absent_k.tolist(), absent_c.tolist()):
            floor, victim = heap[0]
            heapq.heapreplace(heap, (floor + n, key))
            del cs[victim]
            errs.pop(victim, None)
            cs[key] = floor + n
            errs[key] = floor
        self._key_cache = None

    def halve(self) -> None:
        """Windowed decay (the fossilization fix): halve every tracked
        count and error, dropping keys that decay to zero.  Without
        this, a long-running stream's top-K freezes on early-epoch
        keys — a key that was hot in hour 1 keeps a count no current
        key can catch, so lease grants (hotcache/policy.py) would chase
        stale celebrities forever.  Periodic halving turns the counts
        into an exponentially-decayed window: a key must KEEP being hot
        to stay on top."""
        counts = {k: c >> 1 for k, c in self._counts.items() if c >> 1}
        self._counts = counts
        self._errs = {
            k: self._errs.get(k, 0) >> 1 for k in counts
        }
        self.total //= 2
        self._key_cache = None

    @property
    def min_tracked(self) -> int:
        """The smallest tracked count (0 while under capacity) — the
        ceiling on any UNtracked key's true count."""
        if len(self._counts) < self.capacity:
            return 0
        return min(self._counts.values())

    def items(self) -> List[Tuple[int, int, int]]:
        """``(key, count, err)`` tuples, unordered."""
        return [
            (k, c, self._errs.get(k, 0)) for k, c in self._counts.items()
        ]

    def top_k(self, n: Optional[int] = None) -> List[Tuple[int, int, int]]:
        out = sorted(self.items(), key=lambda t: (-t[1], t[0]))
        return out if n is None else out[:n]

    def merge(self, other: "SpaceSavingTopK") -> None:
        """Standard approximate merge: shared keys add counts and
        errors; keys missing on one side absorb that side's
        ``min_tracked`` into both count and error (the key may have
        occurred up to that often unseen); trim back to capacity."""
        self_min, other_min = self.min_tracked, other.min_tracked
        merged: Dict[int, int] = {}
        errs: Dict[int, int] = {}
        for k, c in self._counts.items():
            oc = other._counts.get(k)
            if oc is None:
                merged[k] = c + other_min
                errs[k] = self._errs.get(k, 0) + other_min
            else:
                merged[k] = c + oc
                errs[k] = self._errs.get(k, 0) + other._errs.get(k, 0)
        for k, c in other._counts.items():
            if k in merged:
                continue
            merged[k] = c + self_min
            errs[k] = other._errs.get(k, 0) + self_min
        keep = sorted(merged, key=lambda k: (-merged[k], k))[: self.capacity]
        self._counts = {k: merged[k] for k in keep}
        self._errs = {k: errs[k] for k in keep}
        self._key_cache = None
        self.total += other.total


class HotKeySketch:
    """The pair wired into the traffic path: count-min for any-key
    estimates, space-saving for the top-K candidate set.  ``top_k``
    reports the space-saving candidates with the TIGHTER of the two
    counts (both overestimate; the min keeps both bounds).

    Hot-path discipline: ``observe`` only APPENDS the id batch to a
    small buffer (one lock, one list append); the unique/bincount/
    dict work runs once per ~``buffer_ids`` (default 16k) observed
    ids, amortizing the vectorized pass across many requests.  Every
    read (``top_k``/``estimate``/``merge``/``total``) flushes first,
    so readers never see a stale window."""

    def __init__(
        self,
        k: int = 64,
        *,
        width: int = 2048,
        depth: int = 3,
        seed: int = 0,
        buffer_ids: int = 16384,
        decay_window: Optional[int] = None,
    ):
        self.cms = CountMinSketch(width, depth, seed)
        self.topk = SpaceSavingTopK(k)
        self._lock = threading.Lock()
        self._buffer_ids = max(1, int(buffer_ids))
        self._pending: List[np.ndarray] = []
        self._pending_n = 0
        # windowed decay: every `decay_window` observed ids both
        # sketches are halved, so top-K and estimates track CURRENT
        # popularity (a mid-stream popularity shift overtakes the old
        # regime within ~one window).  None = all-time counts, the
        # pre-decay behaviour.
        if decay_window is not None and decay_window < 1:
            raise ValueError(
                f"decay_window={decay_window}: must be >= 1 or None"
            )
        self.decay_window = decay_window
        self._since_decay = 0
        self.decays = 0

    def _flush_locked(self) -> None:
        if not self._pending:
            return
        ids = (
            self._pending[0] if len(self._pending) == 1
            else np.concatenate(self._pending)
        )
        self._pending = []
        self._pending_n = 0
        uniq, c = np.unique(ids, return_counts=True)
        self.cms.add(uniq, c)
        self.topk.update(uniq, c, assume_unique=True)
        self._maybe_decay_locked(int(ids.size))

    def _maybe_decay_locked(self, observed: int) -> None:
        if self.decay_window is None:
            return
        self._since_decay += observed
        while self._since_decay >= self.decay_window:
            self._since_decay -= self.decay_window
            self.cms.halve()
            self.topk.halve()
            self.decays += 1

    def decay(self) -> None:
        """Explicitly halve both sketches (flushing first) — the
        manual form of ``decay_window``."""
        with self._lock:
            self._flush_locked()
            self.cms.halve()
            self.topk.halve()
            self.decays += 1

    @property
    def total(self) -> int:
        with self._lock:
            self._flush_locked()
            return self.topk.total

    def observe(self, ids, counts=None) -> None:
        """One observed key batch (pull ids, push ids, serving lookup
        ids) — any shape, flattened.  With explicit ``counts`` the
        batch is folded immediately (migration/merge paths); the
        common counts-free path is buffered (see class docstring)."""
        ids = np.asarray(ids).reshape(-1)
        if ids.size == 0:
            return
        if counts is not None:
            counts = np.asarray(counts, np.int64).reshape(-1)
            with self._lock:
                self._flush_locked()
                self.cms.add(ids, counts)
                self.topk.update(ids, counts)
                self._maybe_decay_locked(int(counts.sum()))
            return
        with self._lock:
            self._pending.append(ids)
            self._pending_n += ids.size
            if self._pending_n >= self._buffer_ids:
                self._flush_locked()

    def estimate(self, ids) -> np.ndarray:
        with self._lock:
            self._flush_locked()
            return self.cms.estimate(ids)

    def error_bound(self) -> int:
        """Absolute count-min overestimation bound ``ceil(ε·N)`` at the
        current stream length."""
        with self._lock:
            self._flush_locked()
            return int(math.ceil(self.cms.epsilon * self.cms.total))

    def top_k(self, n: Optional[int] = None) -> List[Dict[str, int]]:
        with self._lock:
            self._flush_locked()
            items = self.topk.top_k(n)
            if not items:
                return []
            keys = np.asarray([k for k, _, _ in items], np.int64)
            cms_est = self.cms.estimate(keys)
        return [
            {"key": int(k), "count": int(min(c, e)), "err": int(err)}
            for (k, c, err), e in zip(items, cms_est)
        ]

    def merge(self, other: "HotKeySketch") -> None:
        with self._lock, other._lock:
            self._flush_locked()
            other._flush_locked()
            self.cms.merge(other.cms)
            self.topk.merge(other.topk)


class HotKeyAggregator:
    """Process-wide registry of per-shard (and serving) sketches —
    the merged view ``/metrics`` and ``run_report`` expose.

    Registration is by label (``shard-0``, ``serving``); re-registering
    a label replaces the sketch (a replaced shard starts a fresh
    window).  ``top_k`` merges every registered sketch into a scratch
    copy and picks the final K with :func:`~..ops.topk.dense_topk`
    (counts as 1-d scores — the cross-shard partial-top-K merge) on
    ``device``, which is resolved when ``top_k`` runs: ``None`` means
    the card, and asking for it without one raises."""

    def __init__(self, device: DeviceLike = None):
        self.device = device
        self._lock = threading.Lock()
        self._sketches: Dict[str, HotKeySketch] = {}

    def register(self, label: str, sketch: HotKeySketch) -> HotKeySketch:
        with self._lock:
            self._sketches[str(label)] = sketch
        return sketch

    def unregister(self, label: str) -> None:
        with self._lock:
            self._sketches.pop(str(label), None)

    def labels(self) -> List[str]:
        with self._lock:
            return sorted(self._sketches)

    def clear(self) -> None:
        with self._lock:
            self._sketches.clear()

    def _merged(self) -> Optional[HotKeySketch]:
        with self._lock:
            sketches = list(self._sketches.values())
        if not sketches:
            return None
        first = sketches[0]
        merged = HotKeySketch(
            first.topk.capacity, width=first.cms.width,
            depth=first.cms.depth, seed=first.cms.seed,
        )
        for s in sketches:
            merged.merge(s)
        return merged

    def candidates(self, n: int = 16) -> List[Dict[str, int]]:
        """The merged top-``n`` WITHOUT the ops/topk final selection —
        pure numpy/python, so a latency-sensitive caller (the hotcache
        lease policy's refresh thread) never dispatches a device op while
        holding the GIL next to a serving hot path.  Same candidate
        set and count bounds as :meth:`top_k`; only the final ranking
        kernel differs (a python sort)."""
        merged = self._merged()
        if merged is None:
            return []
        return merged.top_k(n)

    def top_k(self, n: int = 16) -> List[Dict[str, int]]:
        dev = resolve_device(self.device)
        merged = self._merged()
        if merged is None:
            return []
        candidates = merged.top_k(None)
        if not candidates:
            return []
        # final selection over the merged candidate set via ops/topk —
        # counts as (rows, 1) scores against the unit query
        scores = torch.tensor(
            [[float(c["count"])] for c in candidates],
            dtype=torch.float32, device=dev,
        )
        _top_scores, top_idx = dense_topk(
            scores, torch.ones((1, 1), dtype=torch.float32, device=dev),
            min(n, len(candidates)),
        )
        order = [i for i in top_idx[0].tolist() if i >= 0]
        return [candidates[i] for i in order]

    def total(self) -> int:
        with self._lock:
            return sum(s.total for s in self._sketches.values())

    def error_bound(self) -> int:
        merged = self._merged()
        return 0 if merged is None else merged.error_bound()

    def exposition(self, n: int = 16, prefix: str = "fps_") -> List[str]:
        """Prometheus-text lines for the merged top-K — appended to the
        ``/metrics`` body by the exporter (ROADMAP Queue 1 #7b2)."""
        top = self.top_k(n)
        if not top:
            return []
        lines = [f"# TYPE {prefix}hot_key_traffic gauge"]
        for rank, item in enumerate(top):
            lines.append(
                f'{prefix}hot_key_traffic{{key="{item["key"]}",'
                f'rank="{rank}"}} {item["count"]}'
            )
        lines.append(f"# TYPE {prefix}hot_key_error_bound gauge")
        lines.append(f"{prefix}hot_key_error_bound {self.error_bound()}")
        return lines

    def snapshot(self, n: int = 16) -> Dict[str, object]:
        """The ``run_report`` shape: merged top-K + provenance."""
        return {
            "top": self.top_k(n),
            "total_observed": self.total(),
            "cms_error_bound": self.error_bound(),
            "sketches": self.labels(),
        }


# -- the process-wide default -------------------------------------------------
_DEFAULT_LOCK = threading.Lock()
_DEFAULT: Optional[HotKeyAggregator] = None


def get_aggregator() -> HotKeyAggregator:
    """The process-wide aggregator (created on first use) — what the
    exporter and report read."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = HotKeyAggregator()
        return _DEFAULT


def set_aggregator(agg: Optional[HotKeyAggregator]) -> None:
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = agg


__all__ = [
    "CountMinSketch",
    "HotKeyAggregator",
    "HotKeySketch",
    "SpaceSavingTopK",
    "get_aggregator",
    "set_aggregator",
]
