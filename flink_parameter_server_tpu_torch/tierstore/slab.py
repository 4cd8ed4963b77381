"""The cold tier: an mmap'd slab file of fixed-width fp32 rows.

A copy of ``flink_parameter_server_tpu/tierstore/slab.py``.  The cold
tier is host memory by design: it is the part of the slice that does not
fit on the card.

A slab is a CACHE, not a log: rows land here only when a mutated row
is demoted from the hot tier (or assigned while cold), and a row that
was never written simply is not present — the caller recomputes it
from the deterministic init.  Losing the file therefore loses nothing
durable (WAL + checkpoint own durability), which is why the slab is
created unlinked-on-close in scratch space rather than alongside the
WAL.

Layout: ``slots × row_elems`` float32, grown by doubling via
``ftruncate`` + re-mmap.  The id→slot index is a plain int32 array
over the local id space (4 bytes/row — at the 2^24-row Criteo scale
that is 64 MiB, a fixed cost the recorded RSS bound budgets for; a
python dict of millions of resident entries would cost an order of
magnitude more and dominate lookup profiles).  Writes go through a
transient ``np.frombuffer`` view that is dropped before any resize so
``mmap`` never sees an exported buffer.
"""
from __future__ import annotations

import mmap
import os
import tempfile
from typing import Optional, Tuple

import numpy as np


class ColdSlab:
    """mmap-backed fixed-width row cache over a local id space of
    ``n_rows``.  Single-owner (the shard lock serializes callers) —
    no internal locking."""

    def __init__(
        self,
        n_rows: int,
        row_elems: int,
        *,
        dir: Optional[str] = None,
        initial_slots: int = 1024,
        name_hint: str = "slab",
    ):
        if n_rows < 1 or row_elems < 1:
            raise ValueError(
                f"n_rows={n_rows}, row_elems={row_elems}: need >= 1"
            )
        self.n_rows = int(n_rows)
        self.row_elems = int(row_elems)
        self.row_nbytes = self.row_elems * 4  # fp32
        # id -> slot (−1 = not cached).  int32 caps the slab at 2^31
        # slots, far beyond the mutated-row working sets this tier
        # exists for.
        self._slot_of = np.full(self.n_rows, -1, np.int32)
        self._free: list = []
        self._next_slot = 0
        self._slots = max(8, int(initial_slots))
        fd, self._path = tempfile.mkstemp(
            prefix=f"fps-tier-{name_hint}-", suffix=".slab", dir=dir
        )
        self._fd = fd
        os.ftruncate(fd, self._slots * self.row_nbytes)
        self._mm: Optional[mmap.mmap] = mmap.mmap(
            fd, self._slots * self.row_nbytes
        )
        self.rows_written = 0  # cumulative write calls' row count

    # -- introspection -----------------------------------------------------
    @property
    def path(self) -> str:
        return self._path

    @property
    def rows(self) -> int:
        """Rows currently cached."""
        return self._next_slot - len(self._free)

    @property
    def nbytes(self) -> int:
        """Slab file size (allocated, not just occupied)."""
        return self._slots * self.row_nbytes

    def contains(self, local_ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(local_ids, np.int64).reshape(-1)
        return self._slot_of[ids] >= 0

    # -- data path ---------------------------------------------------------
    def _view(self) -> np.ndarray:
        # transient — callers must not retain it past the statement
        # (resize closes the mmap, which would raise BufferError on a
        # live export)
        return np.frombuffer(self._mm, np.float32).reshape(
            self._slots, self.row_elems
        )

    def _grow(self, need_slots: int) -> None:
        slots = self._slots
        while slots < need_slots:
            slots *= 2
        self._mm.close()
        os.ftruncate(self._fd, slots * self.row_nbytes)
        self._mm = mmap.mmap(self._fd, slots * self.row_nbytes)
        self._slots = slots

    def _alloc(self, n: int) -> np.ndarray:
        out = np.empty(n, np.int64)
        take = min(n, len(self._free))
        for i in range(take):
            out[i] = self._free.pop()
        fresh = n - take
        if fresh:
            if self._next_slot + fresh > self._slots:
                self._grow(self._next_slot + fresh)
            out[take:] = np.arange(
                self._next_slot, self._next_slot + fresh, dtype=np.int64
            )
            self._next_slot += fresh
        return out

    def write(self, local_ids: np.ndarray, rows: np.ndarray) -> None:
        """Upsert ``rows`` (``(n, row_elems)`` fp32) for unique
        ``local_ids``; ids already cached overwrite in place."""
        ids = np.asarray(local_ids, np.int64).reshape(-1)
        if ids.size == 0:
            return
        rows = np.ascontiguousarray(rows, np.float32).reshape(
            ids.size, self.row_elems
        )
        slots = self._slot_of[ids].astype(np.int64)
        fresh = slots < 0
        if fresh.any():
            new_slots = self._alloc(int(fresh.sum()))
            slots[fresh] = new_slots
            self._slot_of[ids[fresh]] = new_slots.astype(np.int32)
        self._view()[slots] = rows
        self.rows_written += ids.size

    def read(self, local_ids: np.ndarray) -> np.ndarray:
        """Rows for unique ``local_ids`` — every id must be cached
        (check :meth:`contains` first)."""
        ids = np.asarray(local_ids, np.int64).reshape(-1)
        slots = self._slot_of[ids].astype(np.int64)
        if ids.size and slots.min() < 0:
            missing = ids[slots < 0]
            raise KeyError(
                f"slab read of {missing.size} uncached rows "
                f"(e.g. local id {int(missing[0])})"
            )
        return self._view()[slots].copy()

    def drop(self, local_ids: np.ndarray) -> int:
        """Forget cached rows (slots return to the free list);
        uncached ids are ignored.  Returns rows dropped."""
        ids = np.asarray(local_ids, np.int64).reshape(-1)
        slots = self._slot_of[ids]
        held = slots >= 0
        if not held.any():
            return 0
        self._free.extend(slots[held].tolist())
        self._slot_of[ids[held]] = -1
        return int(held.sum())

    def close(self) -> None:
        if self._mm is None:
            return
        self._mm.close()
        self._mm = None
        os.close(self._fd)
        try:
            os.unlink(self._path)
        except OSError:
            pass


__all__ = ["ColdSlab"]
