"""The two-tier store behind ``ParamShard(store_backend="tiered")``.

Counterpart of ``flink_parameter_server_tpu/tierstore/store.py``.  The
contract, the admission and eviction policy and every counter are the
reference's; what moved is the hot tier.  The reference keeps it as a host
numpy array; here it is a ``(hot_rows, row_elems)`` float32 tensor on
``device`` (the card unless the caller asks for the CPU), so a slice larger
than the card's share serves a Zipf mix from a bounded set of rows on the
card while the cold slab stays in host memory.  The bookkeeping stays on
the host, as the wire's ids do: the id->slot and slot->id maps, the dirty
bits, the free list, both admission sketches and the eviction ranking.
The card sees one copy per batch in each direction, never one per row:

  * ``gather`` computes the slots on the host, runs one ``index_select``
    on the device and copies the result to the host once, then serves the
    misses from the fetched cold rows, in the reference's order;
  * ``_admit`` writes the fetched cold rows into their slots with one
    host-to-device copy;
  * ``push`` copies the deltas to the device once and adds them through
    ``ops/rows.accumulate_rows_``, one occurrence at a time: a call adds
    the k-th occurrence of every id, so its ids are unique and each
    duplicate lands on the sum before it in arrival order — ``np.add.at``'s
    order, on the card as on the CPU (the card's accumulate sums a run of
    equal ids in an order of its own).  Deduplicated pushes — what a
    shard receives from the client — take one call.  Rows the hot tier
    cannot take are written through on the host (``np.add.at`` into the
    fetched rows, then the slab), as in the reference;
  * ``_evict`` demotes its dirty victims with one device-to-host copy per
    scan.

``device="cpu"`` is the reference's layout, and on the same call sequence
``gather``, ``values()`` and ``stats()``'s counters equal the reference's.

Contract (docs/tierstore.md): a row's current value is

  1. the HOT tier copy if the row is resident,
  2. else the slab (cold tier) copy if one exists,
  3. else ``row_init(local_id)`` — the deterministic per-id init.

Rule 3 is the recomputability rule that makes the whole design work:
an absent row is not a fault, so the cold tier only ever holds rows
whose value DIFFERS from init (mutated rows), and dropping a clean
hot row is free.  Durability still belongs to the WAL + checkpoint
planes — a shard restart builds a fresh empty store and WAL replay
repopulates the mutated set (touching the cold tier as it goes).

Admission is promote-on-access: a missed row becomes resident (it was
just paid for).  Eviction is where the hot-key sketches earn their
keep — when the free list runs dry a batch demotion scan (off the
per-request hot path, amortized) ranks unpinned residents by
(SpaceSaving membership, CountMin estimate) and demotes the coldest
down to the low-water mark; dirty victims are written to the slab,
clean victims are simply dropped.  Windowed decay halves both
sketches every ``decay_window`` observed ids so a popularity shift
demotes yesterday's celebrities.  Pinned rows (frozen for migration,
under lease — whatever ``pinned_fn`` reports) are never evicted.

Capacity is a target, not a wall: a batch larger than the hot tier
still gets correct service — rows that cannot be admitted are served
(and, when pushed, written) straight through to the slab and counted
as ``spills``.  The ``check_tier_residency`` invariant holds resident ≤
capacity at every sample.

Single-owner under the shard lock — no internal locking.  fp32 only: the
tiers must stay bitwise-comparable with the dense backends.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..ops.rows import accumulate_rows_
from ..telemetry.hotkeys import CountMinSketch, SpaceSavingTopK
from ..utils.device import DeviceLike, resolve_device
from .slab import ColdSlab

_SEED_CHUNK = 1 << 16


class TieredStore:
    """Hot-on-``device`` / cold-mmap row store over a local id space."""

    def __init__(
        self,
        n_rows: int,
        value_shape: Sequence[int] = (),
        *,
        row_init: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        hot_rows: int = 65536,
        slab_dir: Optional[str] = None,
        decay_window: int = 0,
        topk_capacity: int = 0,
        pinned_fn: Optional[Callable[[], np.ndarray]] = None,
        low_water: float = 0.9,
        name_hint: str = "shard",
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.n_rows = int(n_rows)
        self.value_shape = tuple(int(s) for s in value_shape)
        self.row_elems = int(np.prod(self.value_shape, dtype=np.int64)) or 1
        self._row_init = row_init
        self.hot_rows = max(1, int(hot_rows))
        self._low_water = max(
            1, min(self.hot_rows, int(self.hot_rows * float(low_water)))
        )
        # hot tier: dense slots on the device; both directions of the
        # id<->slot map on the host (the id->slot index is a flat int32
        # array over the id space, 4 B/row — see slab.py)
        self._hot = torch.zeros(
            (self.hot_rows, self.row_elems), dtype=torch.float32,
            device=self.device,
        )
        self._slot_of = np.full(self.n_rows, -1, np.int32)
        self._id_at = np.full(self.hot_rows, -1, np.int64)
        self._dirty = np.zeros(self.hot_rows, bool)
        self._free = np.arange(self.hot_rows - 1, -1, -1, np.int32)
        self._free_top = self.hot_rows
        self.slab = ColdSlab(
            self.n_rows, self.row_elems, dir=slab_dir, name_hint=name_hint
        )
        # admission/eviction analytics: raw CountMin + SpaceSaving from
        # telemetry/hotkeys.py with their own windowed decay (the tier
        # must track CURRENT popularity, not all-time)
        self.cms = CountMinSketch(
            width=max(2048, 2 * self.hot_rows // 4), depth=4, seed=7
        )
        self.topk = SpaceSavingTopK(
            capacity=int(topk_capacity) or max(8, min(1024, self.hot_rows))
        )
        self.decay_window = (
            int(decay_window) if decay_window else 8 * self.hot_rows
        )
        self._seen = 0
        # a gather/push only APPENDS its id batch; the sketch folding
        # runs once per ~buffer ids (a full hot tier's worth), so it is
        # a rare, batched event rather than a per-batch tax on the
        # median pull.  Eviction and capacity-pressure admission flush
        # first, so ranking always reads the current window.
        self._obs_pending: list = []
        self._obs_n = 0
        self._obs_buffer = max(1 << 16, self.hot_rows)
        self._pinned_fn = pinned_fn
        # instruments (read by gauges / the `tiers` path)
        self.hits = 0
        self.misses = 0
        self.promotes = 0
        self.demotes = 0
        self.demote_writes = 0
        self.spills = 0
        self.evict_scans = 0
        self.last_scan_s = 0.0
        self.cum_scan_s = 0.0
        self.decays = 0
        self.pinned_last = 0

    # -- device transfers ----------------------------------------------------
    def _dev(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        """One host-to-device copy of a host array (a read-only one —
        a frame decoded zero-copy — is copied first, since a tensor
        cannot wrap it)."""
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:
            a = a.copy()
        return torch.from_numpy(a).to(self.device, dtype)

    def _hot_rows_host(self, slots: np.ndarray) -> np.ndarray:
        """Hot rows at ``slots`` as a fresh host array: one
        ``index_select`` on the device and one device-to-host copy."""
        idx = self._dev(np.asarray(slots, np.int64))
        return self._hot.index_select(0, idx).to("cpu", copy=True).numpy()

    # -- bookkeeping -------------------------------------------------------
    @property
    def resident(self) -> int:
        return self.hot_rows - self._free_top

    def _observe(self, ids: np.ndarray) -> None:
        self._obs_pending.append(ids)
        self._obs_n += ids.size
        if self._obs_n >= self._obs_buffer:
            self._flush_observed()

    def _flush_observed(self) -> None:
        """Fold the buffered id batches into both sketches (and run
        windowed decay).  Estimates are stale by at most one buffer
        between flushes — fine for an admission heuristic."""
        if not self._obs_pending:
            return
        ids = (
            self._obs_pending[0] if len(self._obs_pending) == 1
            else np.concatenate(self._obs_pending)
        )
        self._obs_pending = []
        self._obs_n = 0
        uniq, counts = np.unique(ids, return_counts=True)
        self.cms.add(uniq, counts)
        self.topk.update(uniq, counts, assume_unique=True)
        self._seen += ids.size
        if self._seen >= self.decay_window:
            self.cms.halve()
            self.topk.halve()
            self._seen = 0
            self.decays += 1

    def _pinned_slots(self) -> np.ndarray:
        """Hot slots of currently pinned rows (bool mask over slots)."""
        mask = np.zeros(self.hot_rows, bool)
        if self._pinned_fn is None:
            self.pinned_last = 0
            return mask
        pinned = np.asarray(self._pinned_fn(), np.int64).reshape(-1)
        if pinned.size:
            pinned = pinned[(pinned >= 0) & (pinned < self.n_rows)]
            slots = self._slot_of[pinned]
            slots = slots[slots >= 0]
            mask[slots] = True
        self.pinned_last = int(mask.sum())
        return mask

    def _evict(
        self, want: int, protect: Optional[np.ndarray] = None
    ) -> int:
        """Batch demotion: demote up to ``want`` residents, coldest
        first — non-top-K members before members, CountMin estimate
        ascending within each class; pinned rows are skipped, as are
        ``protect`` ids (the batch currently being served).  Dirty
        victims are copied off the device in ONE transfer and written to
        the slab; clean victims are dropped.  Returns slots freed."""
        self._flush_observed()
        t0 = time.perf_counter()
        occupied = self._id_at >= 0
        cand = occupied & ~self._pinned_slots()
        if protect is not None and protect.size:
            pslots = self._slot_of[protect]
            cand[pslots[pslots >= 0]] = False
        cand_slots = np.nonzero(cand)[0]
        freed = 0
        if cand_slots.size:
            cand_ids = self._id_at[cand_slots]
            tracked = np.fromiter(
                sorted(k for k, _, _ in self.topk.items()),
                np.int64,
            )
            if tracked.size:
                at = np.searchsorted(tracked, cand_ids)
                at[at == tracked.size] = 0
                member = tracked[at] == cand_ids
            else:
                member = np.zeros(cand_ids.size, bool)
            est = self.cms.estimate(cand_ids)
            # rank by (member, estimate) with a single int64 key and an
            # O(n) partial select
            key = est.astype(np.int64)
            key += member.astype(np.int64) * (int(key.max()) + 1)
            take = min(want, cand_slots.size)
            if take < cand_slots.size:
                order = np.argpartition(key, take - 1)[:take]
            else:
                order = np.arange(cand_slots.size)
            victims = cand_slots[order]
            dirty = self._dirty[victims]
            if dirty.any():
                dslots = victims[dirty]
                self.slab.write(
                    self._id_at[dslots], self._hot_rows_host(dslots)
                )
                self.demote_writes += int(dirty.sum())
            self._slot_of[self._id_at[victims]] = -1
            self._id_at[victims] = -1
            self._dirty[victims] = False
            self._free[self._free_top: self._free_top + victims.size] = (
                victims.astype(np.int32)
            )
            self._free_top += victims.size
            freed = int(victims.size)
            self.demotes += freed
        self.evict_scans += 1
        self.last_scan_s = time.perf_counter() - t0
        self.cum_scan_s += self.last_scan_s
        return freed

    def _admit(
        self,
        ids: np.ndarray,
        rows: np.ndarray,
        *,
        dirty: bool,
        protect: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Make unique ``ids`` resident with host values ``rows`` (one
        host-to-device copy); returns a bool mask of the ids actually
        admitted (the rest spilled — capacity exhausted by pinned rows
        or an oversized batch)."""
        k = ids.size
        if k > self._free_top:
            # demote down to the low-water mark in one scan so the
            # next few admissions stay off the eviction path
            want = max(k - self._free_top, self.resident - self._low_water)
            self._evict(int(want), protect=protect)
        take = min(k, self._free_top)
        admitted = np.zeros(k, bool)
        if take:
            if take < k:
                # capacity pressure: admit the hottest of the batch
                # (CountMin estimate), spill the rest
                self._flush_observed()
                order = np.argsort(
                    -self.cms.estimate(ids), kind="stable"
                )
                sel = order[:take]
            else:
                sel = np.arange(k)
            admitted[sel] = True
            slots = self._free[self._free_top - take: self._free_top]
            self._free_top -= take
            aid = ids[sel]
            self._hot[self._dev(slots, torch.int64)] = self._dev(rows[sel])
            self._id_at[slots] = aid
            self._slot_of[aid] = slots
            self._dirty[slots] = dirty
            self.promotes += take
        return admitted

    def _fetch_cold(self, ids: np.ndarray) -> np.ndarray:
        """Host values for unique non-resident ``ids``: slab copy if the
        row was ever demoted dirty, else the deterministic init."""
        rows = np.empty((ids.size, self.row_elems), np.float32)
        cached = self.slab.contains(ids)
        if cached.any():
            rows[cached] = self.slab.read(ids[cached])
        cold = ~cached
        if cold.any():
            cold_ids = ids[cold]
            if self._row_init is None:
                rows[cold] = 0.0
            else:
                rows[cold] = np.asarray(
                    self._row_init(cold_ids), np.float32
                ).reshape(cold_ids.size, self.row_elems)
        return rows

    # -- store surface (ParamShard-facing) ---------------------------------
    def gather(self, local_ids) -> np.ndarray:
        """Rows for ``local_ids`` (repeats allowed) as a host
        ``(n, *value_shape)`` fp32 array — the pull/lease read path."""
        ids = np.asarray(local_ids, np.int64).reshape(-1)
        slots = self._slot_of[ids]
        hit = slots >= 0
        n_hit = int(hit.sum())
        self.hits += n_hit
        # one full gather on the device (miss lanes read slot 0 as a
        # throwaway and are overwritten below), one copy to the host
        out = self._hot_rows_host(np.maximum(slots, 0))
        if n_hit < ids.size:
            miss = ~hit
            miss_ids = np.unique(ids[miss])
            self.misses += ids.size - n_hit  # per reference, like hits
            rows = self._fetch_cold(miss_ids)
            admitted = self._admit(
                miss_ids, rows, dirty=False, protect=ids
            )
            if not admitted.all():
                self.spills += int((~admitted).sum())
            # serve from the fetched rows directly (admitted or not)
            pos = np.searchsorted(miss_ids, ids[miss])
            out[miss] = rows[pos]
        self._observe(ids)
        return out.reshape(ids.shape + self.value_shape)

    def push(self, local_ids, deltas) -> "TieredStore":
        """Scatter-add host ``deltas`` (repeats accumulate in index
        order); padding lanes (id −1) and out-of-range ids are dropped,
        matching the dense backends' sentinel routing."""
        ids = np.asarray(local_ids, np.int64).reshape(-1)
        d = np.asarray(deltas, np.float32).reshape(
            ids.size, self.row_elems
        )
        ok = (ids >= 0) & (ids < self.n_rows)
        if not ok.all():
            ids, d = ids[ok], d[ok]
        if ids.size == 0:
            return self
        slots = self._slot_of[ids]
        miss = slots < 0
        self.hits += int((~miss).sum())
        if miss.any():
            miss_ids = np.unique(ids[miss])
            self.misses += int(miss.sum())  # per reference, like hits
            rows = self._fetch_cold(miss_ids)
            admitted = self._admit(
                miss_ids, rows, dirty=True, protect=ids
            )
            if not admitted.all():
                # write-through for rows the hot tier cannot take: fold
                # their deltas into the fetched host values and spill
                # straight to the slab — correctness does not depend on
                # capacity
                cold_ids = miss_ids[~admitted]
                cold_rows = rows[~admitted]
                sel = np.isin(ids, cold_ids)
                pos = np.searchsorted(cold_ids, ids[sel])
                np.add.at(cold_rows, pos, d[sel])
                self.slab.write(cold_ids, cold_rows)
                self.spills += int(cold_ids.size)
                ids, d = ids[~sel], d[~sel]
            slots = self._slot_of[ids]
        if ids.size:
            self._add_in_order(slots.astype(np.int64), d)
            self._dirty[slots] = True
            self._observe(ids)
        return self

    def _add_in_order(self, slots: np.ndarray, d: np.ndarray) -> None:
        """``np.add.at(hot, slots, d)`` on the device: lanes reordered by
        (occurrence rank of their slot, arrival), copied to the device
        once, then one ``accumulate_rows_`` per rank — unique slots in
        each call, so every add is a plain one, in arrival order."""
        order = np.argsort(slots, kind="stable")
        ss = slots[order]
        start = np.ones(ss.size, bool)
        start[1:] = ss[1:] != ss[:-1]
        run0 = np.maximum.accumulate(np.where(start, np.arange(ss.size), 0))
        rank = np.empty(ss.size, np.int64)
        rank[order] = np.arange(ss.size) - run0
        by_rank = np.argsort(rank, kind="stable")
        bounds = np.searchsorted(rank[by_rank], np.arange(int(rank.max()) + 2))
        slots_t = self._dev(slots[by_rank])
        d_t = self._dev(d[by_rank])
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            accumulate_rows_(self._hot, slots_t[lo:hi], d_t[lo:hi])

    def assign(self, local_ids, values) -> None:
        """Overwrite rows (the migration ``load`` path).  Resident rows
        update in place on the device (and become dirty); cold rows
        write straight to the slab — bulk loads must not thrash the hot
        tier."""
        ids = np.asarray(local_ids, np.int64).reshape(-1)
        rows = np.asarray(values, np.float32).reshape(
            ids.size, self.row_elems
        )
        slots = self._slot_of[ids]
        res = slots >= 0
        if res.any():
            self._hot[self._dev(slots[res], torch.int64)] = self._dev(
                rows[res]
            )
            self._dirty[slots[res]] = True
        cold = ~res
        if cold.any():
            self.slab.write(ids[cold], rows[cold])

    def values(self) -> np.ndarray:
        """Dense host materialisation of the whole local slice — init
        overlaid with slab then hot.  O(n_rows): the checkpoint /
        ``verify_against_log`` / epoch-install path, NOT a per-request
        surface."""
        out = np.empty((self.n_rows, self.row_elems), np.float32)
        if self._row_init is None:
            out[:] = 0.0
        else:
            for lo in range(0, self.n_rows, _SEED_CHUNK):
                hi = min(lo + _SEED_CHUNK, self.n_rows)
                chunk = np.arange(lo, hi, dtype=np.int64)
                out[lo:hi] = np.asarray(
                    self._row_init(chunk), np.float32
                ).reshape(hi - lo, self.row_elems)
        cached = np.nonzero(self.slab._slot_of >= 0)[0].astype(np.int64)
        for lo in range(0, cached.size, _SEED_CHUNK):
            ids = cached[lo: lo + _SEED_CHUNK]
            out[ids] = self.slab.read(ids)
        occ = np.nonzero(self._id_at >= 0)[0]
        if occ.size:
            out[self._id_at[occ]] = self._hot_rows_host(occ)
        return out.reshape((self.n_rows,) + self.value_shape)

    def seed_dense(self, values: np.ndarray) -> None:
        """Seed from a dense host table (snapshot restore / epoch
        install): only rows that DIFFER from the deterministic init are
        written to the slab — rows equal to init stay absent
        (recomputable), so a mostly-init snapshot keeps the slab
        bounded."""
        rows = np.asarray(values, np.float32).reshape(
            self.n_rows, self.row_elems
        )
        for lo in range(0, self.n_rows, _SEED_CHUNK):
            hi = min(lo + _SEED_CHUNK, self.n_rows)
            chunk = np.arange(lo, hi, dtype=np.int64)
            if self._row_init is None:
                iv = np.zeros((hi - lo, self.row_elems), np.float32)
            else:
                iv = np.asarray(
                    self._row_init(chunk), np.float32
                ).reshape(hi - lo, self.row_elems)
            diff = np.nonzero((rows[lo:hi] != iv).any(axis=1))[0]
            if diff.size:
                self.slab.write(chunk[diff], rows[lo:hi][diff])

    # -- lifecycle / introspection -----------------------------------------
    def stats(self) -> dict:
        self._flush_observed()  # decay/sketch state current at scrape
        return {
            "resident_rows": int(self.resident),
            "hot_capacity_rows": int(self.hot_rows),
            "pinned_rows": int(self.pinned_last),
            "slab_rows": int(self.slab.rows),
            "slab_bytes": int(self.slab.nbytes),
            "hits": int(self.hits),
            "misses": int(self.misses),
            "promotes": int(self.promotes),
            "demotes": int(self.demotes),
            "demote_writes": int(self.demote_writes),
            "spills": int(self.spills),
            "evict_scans": int(self.evict_scans),
            "last_evict_scan_s": float(self.last_scan_s),
            "cum_evict_scan_s": float(self.cum_scan_s),
            "decays": int(self.decays),
        }

    def close(self) -> None:
        self.slab.close()


__all__ = ["TieredStore"]
