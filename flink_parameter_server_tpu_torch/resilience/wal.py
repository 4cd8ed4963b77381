"""Bounded write-ahead update log — the crash window between checkpoints.

A copy of ``flink_parameter_server_tpu/resilience/wal.py``, which imports
no JAX: the port imports nothing of the JAX package, whose ``__init__``
imports JAX.  Modules it names that the port does not have yet are the
reference's.

In the port the driver logs each batch as its source yielded it (host
numpy arrays), never a CUDA tensor, so reading the log back needs no card;
the cluster shards and the mesh store journal host arrays too.  The keyed
``replay_range`` serves the elastic migration tail, and the record framing
(``encode_frame*`` / ``decode_frame*``) is the replica chains' stream
unit (``replication/shipper.py``).

Reference parity gap being closed (SURVEY.md §5, PAPER.md): the
reference's Flink iteration had no usable checkpointing — a lost worker
lost the job.  The checkpoints (``training/checkpoint``)
shrink the loss to one checkpoint interval; this WAL closes the rest of
the window:

  * every microbatch consumed from the source is appended HERE, on the
    ingest edge, *before* the step applies it (write-ahead);
  * recovery = restore the latest durable checkpoint + :meth:`replay`
    the WAL tail through the training step — bitwise-identical to the
    uninterrupted run (the step is deterministic given the batch), not
    "roughly caught up";
  * each checkpoint save :meth:`truncate_through`\\ s the log, so the WAL
    stays bounded by the checkpoint cadence, not by job length.

Format (one directory, append-only segment files ``wal-<seq>.seg``)::

    segment   := SEG_MAGIC("FPSW") version(u32) record*
    record    := REC_MAGIC("FWR1") seq(u64) start_step(i64) n_steps(u32)
                 payload_len(u64) crc32(u32) payload
    payload   := pickled tree of host (numpy) arrays — the microbatch

A torn tail (crash mid-append) is expected, not fatal: replay stops at
the first record whose frame is short or whose CRC fails, and the next
append overwrites nothing — new records go to a fresh segment.  Appends
are idempotent by step number (a replayed run re-offering step ``s``
with ``s <= last_step_logged`` is skipped), which is what lets the
recovery path feed logged batches back through the *same* driver loop
without double-logging them.

Thread safety: ``append`` runs on the ingest/prefetch thread while
``truncate_through`` runs on the training thread (the driver's
checkpoint callback) — one lock covers both.
"""
from __future__ import annotations

import base64
import dataclasses
import io
import os
import pickle
import struct
import threading
import warnings
import zlib
from typing import Any, Iterator, List, Optional

SEG_MAGIC = b"FPSW"
SEG_VERSION = 1
REC_MAGIC = b"FWR1"
# seq(u64) start_step(i64) n_steps(u32) payload_len(u64) crc32(u32)
_REC_HDR = struct.Struct("<QqIQI")


@dataclasses.dataclass(frozen=True)
class WALRecord:
    """One logged dispatch-group: the microbatch(es) covering training
    steps ``start_step+1 .. end_step`` (step indices are *completed-step*
    counters, matching ``StreamingDriver.step_idx``)."""

    seq: int
    start_step: int
    n_steps: int
    payload: Any

    @property
    def end_step(self) -> int:
        return self.start_step + self.n_steps


def encode_frame_bytes(
    start_step: int, n_steps: int, payload: Any
) -> bytes:
    """One WAL record in the exact on-disk framing (``REC_MAGIC`` +
    header + CRC32 + pickled payload) as RAW bytes — the replication
    stream's unit over the binary transport (utils/frames.py ``repl``
    payload): the same CRC that guards a segment against a torn tail
    guards a shipped record against wire corruption, with no base64
    round trip in between."""
    blob = pickle.dumps(payload, protocol=4)
    return (
        REC_MAGIC
        + _REC_HDR.pack(0, int(start_step), int(n_steps), len(blob),
                        zlib.crc32(blob))
        + blob
    )


def decode_frame_bytes(raw: bytes) -> WALRecord:
    """Inverse of :func:`encode_frame_bytes`; raises ``ValueError`` on
    a bad magic, short frame, or CRC mismatch (a corrupt shipped
    record must be rejected at the wire, never applied)."""
    hdr_len = len(REC_MAGIC) + _REC_HDR.size
    if len(raw) < hdr_len or raw[: len(REC_MAGIC)] != REC_MAGIC:
        raise ValueError("repl frame: bad record magic")
    seq, start, n_steps, plen, crc = _REC_HDR.unpack(
        raw[len(REC_MAGIC): hdr_len]
    )
    blob = raw[hdr_len:]
    if len(blob) != plen or zlib.crc32(blob) != crc:
        raise ValueError(
            f"repl frame: CRC mismatch ({len(blob)} of {plen} payload "
            f"bytes)"
        )
    return WALRecord(seq, start, n_steps, pickle.loads(blob))


def encode_frame(start_step: int, n_steps: int, payload: Any) -> str:
    """:func:`encode_frame_bytes`, base64'd — the line-protocol
    (``repl <b64-frame>``) rendering of the same record."""
    return base64.b64encode(
        encode_frame_bytes(start_step, n_steps, payload)
    ).decode("ascii")


def decode_frame(token: str) -> WALRecord:
    """Inverse of :func:`encode_frame`; raises ``ValueError`` on bad
    base64 or any :func:`decode_frame_bytes` failure."""
    try:
        raw = base64.b64decode(token.encode("ascii"), validate=True)
    except Exception as e:
        raise ValueError(f"repl frame is not valid base64: {e}") from None
    return decode_frame_bytes(raw)


def from_newest_snapshot(records: List[WALRecord]) -> List[WALRecord]:
    """``records`` from the newest ``snapshot`` record on (all of them
    without one).  A snapshot (a shard's whole owned slice, written at each
    epoch flip) supersedes everything before it, and records before it may
    hold ids the shard no longer owns after a resize: a shard's replay, the
    shipper's resync, a promotion's salvage and its audit all start here."""
    start = 0
    for i, rec in enumerate(records):
        p = rec.payload
        if isinstance(p, dict) and p.get("kind") == "snapshot":
            start = i
    return records[start:]


class UpdateWAL:
    """Append/replay/truncate over a directory of bounded segments.

    ``segment_bytes`` rotates to a fresh segment once the current one
    grows past the threshold (truncation granularity — a segment is
    dropped only when *every* record in it is covered by a checkpoint).
    ``fsync_every`` is the durability cadence in records (1 = fsync each
    append — the default; crash loses at most the in-flight record;
    0 = never fsync, OS page cache decides).  ``max_bytes`` is a soft
    bound: exceeding it means checkpoints are not keeping up — the WAL
    warns (once per excursion) and keeps appending, because dropping
    un-checkpointed records would silently reopen the data-loss window
    this log exists to close.
    """

    def __init__(
        self,
        directory: str,
        *,
        segment_bytes: int = 16 << 20,
        fsync_every: int = 1,
        max_bytes: Optional[int] = None,
    ):
        if segment_bytes < 1:
            raise ValueError(f"segment_bytes={segment_bytes}: must be >= 1")
        if fsync_every < 0:
            raise ValueError(f"fsync_every={fsync_every}: must be >= 0")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.segment_bytes = int(segment_bytes)
        self.fsync_every = int(fsync_every)
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._fh: Optional[io.BufferedWriter] = None
        self._fh_bytes = 0
        # counters (observability: the driver's metrics consumers read
        # these; tests assert on them)
        self.records_appended = 0
        self.records_skipped = 0
        self.segments_rotated = 0
        self.bytes_written = 0
        self.torn_records_dropped = 0
        self._over_budget_warned = False
        self._unsynced = 0
        # Recover in-memory cursors from whatever is on disk (the resume
        # path: a fresh process opening an existing WAL dir).
        existing = self._scan_disk(load_payload=False)
        self._next_seq = (existing[-1].seq + 1) if existing else 0
        self._last_end = existing[-1].end_step if existing else -(1 << 62)

    # -- disk layout -------------------------------------------------------
    def _segment_paths(self) -> List[str]:
        names = [
            n
            for n in os.listdir(self.directory)
            if n.startswith("wal-") and n.endswith(".seg")
        ]
        return [os.path.join(self.directory, n) for n in sorted(names)]

    # fpsanalyze: allow[S001] _open_segment only runs under self._lock (append holds it); the lock is the caller's
    def _open_segment(self) -> None:
        path = os.path.join(
            self.directory, f"wal-{self._next_seq:016d}.seg"
        )
        fh = open(path, "ab")
        if fh.tell() == 0:
            fh.write(SEG_MAGIC + struct.pack("<I", SEG_VERSION))
        self._fh = fh
        self._fh_bytes = fh.tell()

    @staticmethod
    def _read_segment(
        path: str, load_payload: bool = True
    ) -> Iterator[WALRecord]:
        """Yield intact records; stop silently at a torn tail (the crash
        frame).  A corrupt record mid-segment also stops the segment —
        everything after an unparseable frame is unaddressable anyway.
        ``load_payload=False`` still CRC-verifies every frame but skips
        the unpickle (range scans: truncation, cursor recovery)."""
        with open(path, "rb") as fh:
            head = fh.read(len(SEG_MAGIC) + 4)
            if len(head) < len(SEG_MAGIC) + 4 or head[:4] != SEG_MAGIC:
                return
            while True:
                magic = fh.read(len(REC_MAGIC))
                if len(magic) < len(REC_MAGIC) or magic != REC_MAGIC:
                    return
                hdr = fh.read(_REC_HDR.size)
                if len(hdr) < _REC_HDR.size:
                    return
                seq, start, n_steps, plen, crc = _REC_HDR.unpack(hdr)
                payload = fh.read(plen)
                if len(payload) < plen or zlib.crc32(payload) != crc:
                    return
                yield WALRecord(
                    seq, start, n_steps,
                    pickle.loads(payload) if load_payload else None,
                )

    def _scan_disk(self, load_payload: bool = True) -> List[WALRecord]:
        records: List[WALRecord] = []
        for path in self._segment_paths():
            records.extend(self._read_segment(path, load_payload))
        return records

    # -- append side (ingest thread) ---------------------------------------
    def append(self, start_step: int, n_steps: int, payload: Any) -> bool:
        """Log one dispatch-group covering steps ``start_step+1 ..
        start_step+n_steps``.  Returns False (and writes nothing) when
        those steps are already logged — the idempotence that makes WAL
        replay through the normal driver loop safe."""
        if n_steps < 1:
            raise ValueError(f"n_steps={n_steps}: must be >= 1")
        blob = pickle.dumps(payload, protocol=4)
        # fpsanalyze: allow[B001] the WAL lock IS the durability serialization point — fsync/flush must be ordered with appends under it
        with self._lock:
            end = start_step + n_steps
            if end <= self._last_end:
                self.records_skipped += 1
                return False
            if self._fh is None or self._fh_bytes >= self.segment_bytes:
                if self._fh is not None:
                    self._fh.flush()
                    os.fsync(self._fh.fileno())
                    self._fh.close()
                    self.segments_rotated += 1
                self._open_segment()
            frame = (
                REC_MAGIC
                + _REC_HDR.pack(
                    self._next_seq, start_step, n_steps, len(blob),
                    zlib.crc32(blob),
                )
                + blob
            )
            self._fh.write(frame)
            self._fh_bytes += len(frame)
            self.bytes_written += len(frame)
            self._unsynced += 1
            if self.fsync_every and self._unsynced >= self.fsync_every:
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self._unsynced = 0
            self._next_seq += 1
            self._last_end = end
            self.records_appended += 1
            if self.max_bytes is not None:
                total = self._total_bytes_locked()
                if total > self.max_bytes and not self._over_budget_warned:
                    self._over_budget_warned = True
                    warnings.warn(
                        f"WAL at {total} bytes exceeds max_bytes="
                        f"{self.max_bytes}: checkpoints are not keeping "
                        f"up (raise checkpoint_every's cadence or the "
                        f"budget); appends continue — dropping "
                        f"un-checkpointed records would reopen the loss "
                        f"window",
                        RuntimeWarning,
                    )
                elif total <= self.max_bytes:
                    self._over_budget_warned = False
            return True

    def sync(self) -> None:
        """Force the pending appends durable (explicit-save sibling)."""
        # fpsanalyze: allow[B001] the WAL lock IS the durability serialization point — fsync/flush must be ordered with appends under it
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self._unsynced = 0

    # -- replay / truncate -------------------------------------------------
    @property
    def last_step_logged(self) -> Optional[int]:
        """End step of the newest logged record (None when empty)."""
        with self._lock:
            return None if self._last_end < -(1 << 61) else self._last_end

    def replay(self, after_step: int = -(1 << 62)) -> List[WALRecord]:
        """All intact records with ``end_step > after_step``, in order —
        the tail to feed back through the training step after restoring
        the checkpoint taken at ``after_step``."""
        # fpsanalyze: allow[B001] the WAL lock IS the durability serialization point — fsync/flush must be ordered with appends under it
        with self._lock:
            if self._fh is not None:  # replay must see the full tail
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self._unsynced = 0
            records = self._scan_disk()
        return [r for r in records if r.end_step > after_step]

    def replay_range(
        self,
        after_step: int = -(1 << 62),
        ids=None,
    ) -> List[WALRecord]:
        """Keyed range-replay: the records of :meth:`replay` with each
        payload FILTERED down to the global ids in ``ids`` (``None`` =
        no filtering).  This is the migration tail: a shard WAL logs
        ``{"ids": ..., "deltas": ...}`` (and load records log
        ``{"ids": ..., "values": ...}``); handing a moving key range to
        a new owner replays exactly the rows in that range, in log
        order, and nothing else.  Records whose payload carries no id
        in the range are dropped; records without an ``ids`` payload
        key pass through untouched (this WAL is schema-agnostic —
        only keyed payloads can be keyed-filtered)."""
        records = self.replay(after_step)
        if ids is None:
            return records
        import numpy as np

        wanted = np.unique(np.asarray(ids, np.int64))
        out: List[WALRecord] = []
        for rec in records:
            payload = rec.payload
            if not isinstance(payload, dict) or "ids" not in payload:
                out.append(rec)
                continue
            rec_ids = np.asarray(payload["ids"], np.int64)
            keep = np.isin(rec_ids, wanted)
            if not keep.any():
                continue
            filtered = dict(payload)
            for key, value in payload.items():
                arr = np.asarray(value) if not np.isscalar(value) else None
                if (
                    arr is not None
                    and arr.ndim >= 1
                    and arr.shape[0] == rec_ids.shape[0]
                ):
                    filtered[key] = arr[keep]
            out.append(
                WALRecord(rec.seq, rec.start_step, rec.n_steps, filtered)
            )
        return out

    def truncate_through(self, step: int) -> int:
        """Drop segments whose every record is covered by the durable
        checkpoint at ``step`` (called on each checkpoint save).  Only
        whole segments go — a segment straddling the checkpoint stays,
        its covered records cheaply skipped at replay by ``after_step``.
        Returns the number of segments removed."""
        removed = 0
        # fpsanalyze: allow[B001] the WAL lock IS the durability serialization point — fsync/flush must be ordered with appends under it
        with self._lock:
            current = self._fh.name if self._fh is not None else None
            if self._fh is not None:
                # the live segment is inspected FROM DISK below; with a
                # lazy fsync cadence the buffered tail (e.g. a just-
                # appended epoch snapshot) would be invisible and the
                # segment wrongly judged fully-covered and removed
                self._fh.flush()
            for path in self._segment_paths():
                if path == current:
                    continue
                records = list(self._read_segment(path, load_payload=False))
                if records and records[-1].end_step > step:
                    continue
                os.remove(path)
                removed += 1
            # the live segment is droppable too once fully covered —
            # close + remove + a fresh one opens on the next append
            if current is not None:
                records = list(
                    self._read_segment(current, load_payload=False)
                )
                if not records or records[-1].end_step <= step:
                    self._fh.close()
                    os.remove(current)
                    self._fh = None
                    self._fh_bytes = 0
                    removed += 1
        return removed

    def drop_after(self, step: int) -> int:
        """Discard every record with ``end_step > step`` — the poisoned
        tail after a :class:`~..training.driver.TrainingDiverged` (the
        records since the last good checkpoint *caused* the divergence;
        replaying them would re-diverge deterministically).  Returns the
        number of records dropped."""
        dropped = 0
        # fpsanalyze: allow[B001] the WAL lock IS the durability serialization point — fsync/flush must be ordered with appends under it
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()
                self._fh = None
                self._fh_bytes = 0
            for path in self._segment_paths():
                records = list(self._read_segment(path))
                keep = [r for r in records if r.end_step <= step]
                dropped += len(records) - len(keep)
                if len(keep) == len(records):
                    continue
                os.remove(path)
                if keep:
                    # rewrite the straddling segment with the good prefix
                    with open(path, "wb") as fh:
                        fh.write(SEG_MAGIC + struct.pack("<I", SEG_VERSION))
                        for r in keep:
                            blob = pickle.dumps(r.payload, protocol=4)
                            fh.write(
                                REC_MAGIC
                                + _REC_HDR.pack(
                                    r.seq, r.start_step, r.n_steps,
                                    len(blob), zlib.crc32(blob),
                                )
                                + blob
                            )
                        fh.flush()
                        os.fsync(fh.fileno())
            self._last_end = -(1 << 62)
            for r in self._scan_disk(load_payload=False):
                self._last_end = max(self._last_end, r.end_step)
            if self._last_end < -(1 << 61) and step > -(1 << 61):
                # empty log: future appends restart strictly after `step`
                self._last_end = step
        return dropped

    def _total_bytes_locked(self) -> int:
        total = 0
        for path in self._segment_paths():
            try:
                total += os.path.getsize(path)
            except OSError:
                pass
        return total

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return self._total_bytes_locked()

    def close(self) -> None:
        # fpsanalyze: allow[B001] the WAL lock IS the durability serialization point — fsync/flush must be ordered with appends under it
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "UpdateWAL":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = [
    "from_newest_snapshot",
    "UpdateWAL",
    "WALRecord",
    "decode_frame",
    "decode_frame_bytes",
    "encode_frame",
    "encode_frame_bytes",
]
