"""SPSC shared-memory ring: the byte substrate under the shm channel.

A copy of ``flink_parameter_server_tpu/shmem/ring.py``, which imports
no JAX: the port imports nothing of the JAX package, whose ``__init__``
imports JAX.  The layout below is the reference's byte for byte: a
ring either package writes reads back through the other's ``ShmRing``.

One :class:`ShmRing` is ONE direction of one (client, shard-proc)
pair — a ``multiprocessing.shared_memory`` segment holding a fixed
header region and a power-of-two data region.  Exactly one producer
and exactly one consumer ever touch a ring (the SPSC contract), which
is what lets every synchronization primitive here be a plain byte in
shared memory instead of a lock:

  * **monotonic head/tail** — the producer owns ``head`` (bytes ever
    written), the consumer owns ``tail`` (bytes ever released);
    ``head - tail`` is the live depth and never wraps even though the
    data region does.  Each index is PUBLISHED through a single-byte
    seqlock (odd while the 8-byte value is mid-write, equal-and-even
    around a consistent snapshot), so the opposite side can never act
    on a torn 8-byte read: single-byte stores are atomic everywhere,
    and the store ordering this layout leans on is x86-TSO (documented
    assumption; a weaker machine degrades to seqlock retries, never to
    accepting a torn value).
  * **torn-write-safe commit** — a record below the published ``head``
    is complete by construction (the header+payload bytes are written
    BEFORE the seqlocked head advance — the commit word).  Belt and
    braces, each record header also carries ``seq = position & 0xFFFF``
    which the consumer validates, so a scribbled or replayed region
    surfaces as :class:`RingCorruption` instead of a silently wrong
    frame.
  * **wraparound framing** — records are always CONTIGUOUS in the data
    region (the zero-copy contract: a consumer hands out ONE
    ``memoryview`` slice per record, never a gather).  A record that
    would straddle the physical end is preceded by a ``K_WRAP`` marker
    that skips to the boundary; a gap smaller than a record header is
    skipped implicitly by both sides under the same rule.

The payload bytes carry the SAME versioned frame layout as
``utils/frames.py`` (``K_FRAME``) or a raw text line (``K_LINE``) —
the ring is a transport, not a codec, which is why negotiation,
NetMeter accounting, trace tokens, epoch fencing and lease piggybacks
all ride through unchanged (docs/shmem.md).

Borrow protocol: :meth:`consume` returns a memoryview INTO the ring
and does NOT advance the published tail; the caller releases with
:meth:`release` once the frame is parsed (the cluster client defers
this to the next batch — true zero-copy pulls).  A full ring therefore
blocks the producer while anything is borrowed — which is exactly the
guard that makes overwriting a borrowed view impossible.

The CLIENT side of a channel owns both segments' lifecycles (create →
``unlink``); an attaching side immediately unregisters from the
stdlib ``resource_tracker`` (Python 3.10 registers on attach too —
bpo-39959 — and a double-tracked segment dies with a spurious "leaked
shared_memory objects" warning, which the leak check watches for).
"""
from __future__ import annotations

import os
import secrets
import select
import struct
import threading
import time
import weakref
from multiprocessing import resource_tracker, shared_memory
from typing import Callable, Optional, Tuple

MAGIC = b"FPSR"
VERSION = 1

# -- record kinds ------------------------------------------------------------
K_LINE = 1   # utf-8 text line (control verbs: stats, flush, conns, ...)
K_FRAME = 2  # one utils/frames.py binary frame, byte for byte
K_WRAP = 3   # skip-to-boundary marker (never delivered to callers)

# header region layout (64 bytes, fixed):
#   0:4    magic          b"FPSR"
#   4:5    version        u8
#   8:24   head index     seqlock'd u64 (seq u8 @8, value u64 @16)
#   24:40  tail index     seqlock'd u64 (seq u8 @24, value u64 @32)
#   40:48  heartbeat      u64, incremented by the segment CREATOR's
#                         beat thread; torn reads are harmless (any
#                         change means alive)
#   48:49  closed flag    u8 (either side; a closed ring wakes waiters)
#   49:50  parked flag    u8 (consumer parked past its spin budget —
#                         the doorbell's parked-reader accounting)
#   56:64  capacity       u64
HDR_SIZE = 64
_OFF_HEAD = 8
_OFF_TAIL = 24
_OFF_HEARTBEAT = 40
_OFF_CLOSED = 48
_OFF_PARKED = 49
_OFF_CAP = 56

# record header: u32 payload len | u8 kind | u8 reserved | u16 seq
_REC = struct.Struct("<IBBH")
REC_SIZE = _REC.size  # 8

_U64 = struct.Struct("<Q")


class RingCorruption(RuntimeError):
    """A record header failed validation — the ring's belt-and-braces
    integrity check tripped (bad kind, bad seq tag, impossible
    length).  Not retryable: the channel tears down and the caller
    falls back to TCP."""


class RingClosed(ConnectionError):
    """The peer marked the ring closed (orderly teardown) — the shm
    analogue of a TCP FIN."""


class RingTimeout(TimeoutError):
    """A bounded produce/consume wait expired — the shm analogue of a
    socket timeout (a SLOW peer, not a dead one)."""


def _now() -> float:
    return time.monotonic()


class _Bell:
    """Process-local wakeup channel for one ring: a pipe byte.

    Measured on the target kernel, a pipe-byte handoff between two
    threads round-trips in ~5 µs — 5x faster than ``threading.Event``
    (whose cond-var machinery costs ~28 µs) and 2x faster than a raw
    lock handoff, because the kernel's pipe wake path hands the CPU
    straight to the blocked reader.  Level-triggered like an Event:
    the byte stays readable until :meth:`clear` drains it, so the
    clear-check-wait pattern loses no wakeups."""

    __slots__ = ("rfd", "wfd", "shared", "__weakref__")

    def __init__(self):
        self.rfd, self.wfd = os.pipe()
        os.set_blocking(self.rfd, False)
        os.set_blocking(self.wfd, False)
        self.shared = False

    def set(self) -> None:
        try:
            os.write(self.wfd, b"\0")
        except (BlockingIOError, InterruptedError):
            pass  # a full pipe already holds pending wakeups
        except OSError:
            pass  # torn down under us

    def clear(self) -> None:
        try:
            while os.read(self.rfd, 4096):
                pass
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            pass

    def wait(self, timeout: float) -> bool:
        try:
            r, _, _ = select.select([self.rfd], [], [], timeout)
        except (OSError, ValueError):
            return False
        if r:
            self.clear()
            return True
        return False

    def __del__(self):
        for fd in (self.rfd, self.wfd):
            try:
                os.close(fd)
            except OSError:
                pass


# Process-local doorbells, keyed by segment name.  When BOTH ends of
# a ring live in one process (thread-backed shards, an in-process
# transport A/B) they resolve to the SAME bell, so a publish wakes the
# waiter at pipe speed instead of the waiter's timed-sleep quantum —
# that quantum (~50-100us of timer slack per hop) is most of the
# wakeup floor this transport exists to remove.  A cross-process peer
# holds its own, never-rung bell, and ``wait(timeout)`` degrades to
# exactly the timed park it replaces.  WeakValueDictionary: rings
# hold the strong refs, so a name's entry (and its fds) dies with the
# last ring.
_BELLS: "weakref.WeakValueDictionary[str, _Bell]" = (
    weakref.WeakValueDictionary()
)
_BELLS_LOCK = threading.Lock()


def _bell_for(name: str) -> _Bell:
    with _BELLS_LOCK:
        bell = _BELLS.get(name)
        if bell is None:
            bell = _Bell()
            _BELLS[name] = bell
        else:
            # flips True the moment a SECOND ring object for this
            # segment appears in-process — from then on both ends know
            # every publish rings this very bell, and waiters can park
            # long on it instead of timed-poll (see Doorbell)
            bell.shared = True
        return bell


class ShmRing:
    """One direction of a shm channel (see module docstring).

    ``capacity`` is the data-region size in bytes; a single record
    (header + payload) may claim at most ``capacity // 2`` so the
    worst-case wrap (a ``K_WRAP`` marker skipping almost ``need``
    bytes to the boundary, then the record itself) still fits an
    otherwise EMPTY ring — a looser bound would admit records whose
    wrap-adjusted footprint exceeds the ring and can never be
    satisfied, deadlocking the producer (:attr:`max_record` is the
    payload-byte ceiling callers size against)."""

    def __init__(
        self,
        shm: shared_memory.SharedMemory,
        *,
        owner: bool,
        spin: int = 100,
        sleep_min_s: float = 50e-6,
        sleep_max_s: float = 1e-3,
    ):
        self._shm = shm
        self._owner = owner
        self.name = shm.name
        self.buf = shm.buf
        if bytes(self.buf[0:4]) != MAGIC:
            raise RingCorruption(
                f"segment {shm.name}: bad magic {bytes(self.buf[0:4])!r}"
            )
        if self.buf[4] != VERSION:
            raise RingCorruption(
                f"segment {shm.name}: ring version {self.buf[4]} != "
                f"{VERSION}"
            )
        self.capacity = _U64.unpack_from(self.buf, _OFF_CAP)[0]
        # local (unpublished) cursors: the producer's write position
        # and the consumer's parse position.  Fresh attaches adopt the
        # published values — both are still zero at negotiation time.
        self._wpos = self._read_idx(_OFF_HEAD)
        self._rpos = self._read_idx(_OFF_TAIL)
        # same-process wakeup channel (no-op signal for remote peers)
        self.bell = _bell_for(self.name)
        # doorbell pacing knobs (shared with doorbell.Doorbell)
        self._spin = int(spin)
        self._sleep_min = float(sleep_min_s)
        self._sleep_max = float(sleep_max_s)

    # -- construction ------------------------------------------------------
    @classmethod
    def create(
        cls, capacity: int = 1 << 20, name: Optional[str] = None
    ) -> "ShmRing":
        capacity = int(capacity)
        if capacity < 4 * REC_SIZE:
            raise ValueError(f"capacity={capacity}: too small for a ring")
        if name is None:
            name = f"fps-ring-{secrets.token_hex(6)}"
        shm = shared_memory.SharedMemory(
            name=name, create=True, size=HDR_SIZE + capacity
        )
        buf = shm.buf
        buf[0:4] = MAGIC
        buf[4] = VERSION
        for off in (_OFF_HEAD, _OFF_TAIL):
            buf[off] = 0
            _U64.pack_into(buf, off + 8, 0)
        _U64.pack_into(buf, _OFF_HEARTBEAT, 0)
        buf[_OFF_CLOSED] = 0
        buf[_OFF_PARKED] = 0
        _U64.pack_into(buf, _OFF_CAP, capacity)
        return cls(shm, owner=True)

    @classmethod
    def attach(cls, name: str) -> "ShmRing":
        shm = shared_memory.SharedMemory(name=name, create=False)
        try:
            # Python 3.10 registers ATTACHED segments with the resource
            # tracker too (bpo-39959); the creator is the sole owner
            # here, so an attach must untrack itself or the tracker
            # warns about (and double-unlinks) a segment it never owned
            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:  # noqa: BLE001 — tracking is best-effort
            pass
        return cls(shm, owner=False)

    # -- seqlocked u64 indices ---------------------------------------------
    def _read_idx(self, off: int) -> int:
        """Seqlock read: never returns a torn 8-byte value — an odd or
        moved sequence byte retries (the torn-commit recovery path the
        seeded test drives)."""
        buf = self.buf
        while True:
            s1 = buf[off]
            if s1 & 1:
                time.sleep(0)  # writer mid-publish: yield and retry
                continue
            value = _U64.unpack_from(buf, off + 8)[0]
            if buf[off] == s1:
                return value

    def _write_idx(self, off: int, value: int) -> None:
        """Seqlock publish: odd while the 8-byte value is in flight.
        Only ever called by the side that OWNS the index (SPSC)."""
        buf = self.buf
        s = buf[off]
        buf[off] = (s + 1) & 0xFF  # odd: publication in progress
        _U64.pack_into(buf, off + 8, value)
        buf[off] = (s + 2) & 0xFF  # even again: snapshot consistent

    # -- header flags ------------------------------------------------------
    def mark_closed(self) -> None:
        try:
            self.buf[_OFF_CLOSED] = 1
        except (TypeError, ValueError):  # buffer already released
            pass
        self.bell.set()

    @property
    def closed(self) -> bool:
        return self.buf[_OFF_CLOSED] != 0

    def set_parked(self, parked: bool) -> None:
        self.buf[_OFF_PARKED] = 1 if parked else 0

    @property
    def parked(self) -> bool:
        return self.buf[_OFF_PARKED] != 0

    def beat(self) -> None:
        """Bump the liveness heartbeat (creator side's beat thread).
        Torn cross-process reads are fine: staleness detection only
        asks whether the value CHANGED."""
        v = _U64.unpack_from(self.buf, _OFF_HEARTBEAT)[0]
        _U64.pack_into(self.buf, _OFF_HEARTBEAT, (v + 1) & 0xFFFF_FFFF)

    def heartbeat(self) -> int:
        return _U64.unpack_from(self.buf, _OFF_HEARTBEAT)[0]

    @property
    def max_record(self) -> int:
        """Largest payload :meth:`produce` accepts.  A record (header
        + payload) may claim at most half the data region: when it
        straddles the physical end, the wrap marker burns up to
        ``need - 1`` bytes of skip on top of the record itself, so
        only ``need <= capacity // 2`` guarantees the wrap-adjusted
        footprint fits an empty ring (anything looser can deadlock —
        the room() wait would never be satisfiable)."""
        return self.capacity // 2 - REC_SIZE

    # -- observability -----------------------------------------------------
    def depth(self) -> int:
        """Live bytes between the published indices — the ring depth
        gauge (docs/shmem.md)."""
        try:
            return max(
                0, self._read_idx(_OFF_HEAD) - self._read_idx(_OFF_TAIL)
            )
        except (TypeError, ValueError):
            return 0  # torn down mid-scrape

    # -- producer ----------------------------------------------------------
    def produce(
        self,
        kind: int,
        payload,
        *,
        timeout: Optional[float] = None,
        should_abort: Optional[Callable[[], bool]] = None,
        waiter: Optional[Callable[..., bool]] = None,
    ) -> None:
        """Append one record, blocking while the ring lacks room (the
        full-ring backpressure path — a borrowing consumer holds the
        producer off by construction).  ``should_abort`` is polled in
        the wait loop (liveness checks: dead peer, server stop);
        ``waiter`` overrides the built-in pacing (doorbell)."""
        payload = memoryview(payload)
        need = REC_SIZE + payload.nbytes
        cap = self.capacity
        # the wrap bound, not the raw one: a record straddling the
        # physical end pays a skip of up to need-1 bytes on top of
        # itself, so need > cap//2 has alignments at which it can
        # NEVER fit — rejected up front instead of waiting forever
        if need > cap // 2:
            raise ValueError(
                f"record of {payload.nbytes} bytes cannot fit a "
                f"{cap}-byte ring (max payload {self.max_record}: a "
                f"record may claim at most half the ring so its "
                f"worst-case wrap still fits)"
            )

        def room() -> Optional[Tuple[int, int]]:
            """(bytes consumed incl. skip/wrap, payload offset) when
            the record fits now, else None."""
            tail = self._read_idx(_OFF_TAIL)
            free = cap - (self._wpos - tail)
            off = self._wpos % cap
            to_end = cap - off
            if to_end < REC_SIZE:
                total = to_end + need       # implicit skip, no marker
            elif need > to_end:
                total = to_end + need       # K_WRAP marker + record
            else:
                total = need                # contiguous as-is
            if total > cap:
                # unreachable given the need <= cap//2 guard above —
                # belt and braces against a future bound change: an
                # unsatisfiable wait must raise, never hang
                raise ValueError(
                    f"record footprint {total} exceeds the {cap}-byte "
                    f"ring at offset {off}"
                )
            return total if free >= total else None

        self._wait(
            lambda: room() is not None or self.closed,
            timeout=timeout, should_abort=should_abort, waiter=waiter,
            what="ring full",
        )
        if self.closed:
            raise RingClosed(f"ring {self.name} closed")
        off = self._wpos % cap
        to_end = cap - off
        pos = self._wpos
        if to_end < REC_SIZE:
            pos += to_end  # implicit skip: both sides share this rule
        elif need > to_end:
            _REC.pack_into(
                self.buf, HDR_SIZE + off,
                to_end - REC_SIZE, K_WRAP, 0, pos & 0xFFFF,
            )
            pos += to_end
        dst = HDR_SIZE + (pos % cap)
        _REC.pack_into(
            self.buf, dst, payload.nbytes, kind, 0, pos & 0xFFFF
        )
        self.buf[dst + REC_SIZE: dst + REC_SIZE + payload.nbytes] = payload
        # the commit word: everything above is invisible until this
        # seqlocked head advance publishes it
        self._wpos = pos + need
        self._write_idx(_OFF_HEAD, self._wpos)
        # ring the bell only for a PARKED peer: waiters raise the
        # parked byte before blocking (Doorbell and _wait both), and
        # Event.set is ~3-5us of lock traffic the hot no-waiter path
        # should not pay per record
        if self.buf[_OFF_PARKED]:
            self.bell.set()

    # -- consumer ----------------------------------------------------------
    def consume(
        self,
        *,
        timeout: Optional[float] = None,
        should_abort: Optional[Callable[[], bool]] = None,
        waiter: Optional[Callable[..., bool]] = None,
    ) -> Tuple[int, memoryview]:
        """Next record as ``(kind, memoryview-into-the-ring)``.  The
        view stays valid until :meth:`release`; the published tail
        does NOT move here (the borrow protocol)."""
        cap = self.capacity
        while True:
            head = self._read_idx(_OFF_HEAD)
            if head - self._rpos < REC_SIZE:
                self._wait(
                    lambda: (
                        self._read_idx(_OFF_HEAD) - self._rpos
                        >= REC_SIZE or self.closed
                    ),
                    timeout=timeout, should_abort=should_abort,
                    waiter=waiter, what="ring empty",
                )
                if (self._read_idx(_OFF_HEAD) - self._rpos < REC_SIZE
                        and self.closed):
                    raise RingClosed(f"ring {self.name} closed")
                continue
            off = self._rpos % cap
            to_end = cap - off
            if to_end < REC_SIZE:
                self._rpos += to_end  # the shared implicit-skip rule
                continue
            length, kind, _rsv, seq = _REC.unpack_from(
                self.buf, HDR_SIZE + off
            )
            if seq != self._rpos & 0xFFFF or kind not in (
                K_LINE, K_FRAME, K_WRAP
            ) or REC_SIZE + length > cap:
                raise RingCorruption(
                    f"ring {self.name}: bad record at {self._rpos} "
                    f"(len={length} kind={kind} seq={seq:#x} "
                    f"want={self._rpos & 0xFFFF:#x})"
                )
            if kind == K_WRAP:
                self._rpos += REC_SIZE + length
                continue
            start = HDR_SIZE + off + REC_SIZE
            view = self.buf[start: start + length]
            self._rpos += REC_SIZE + length
            return kind, view

    def release(self) -> None:
        """Publish the parse position as the new tail — every borrowed
        view before it is dead to the caller and its bytes are the
        producer's again.  Callers drop their views FIRST."""
        self._write_idx(_OFF_TAIL, self._rpos)
        if self.buf[_OFF_PARKED]:  # wake only a parked producer
            self.bell.set()

    def borrowed(self) -> int:
        """Bytes consumed but not yet released — the live borrow span
        (0 = nothing outstanding)."""
        return self._rpos - self._read_idx(_OFF_TAIL)

    # -- waiting -----------------------------------------------------------
    def _wait(
        self,
        ready: Callable[[], bool],
        *,
        timeout: Optional[float],
        should_abort: Optional[Callable[[], bool]],
        waiter: Optional[Callable[..., bool]],
        what: str,
    ) -> None:
        if ready():
            return
        if waiter is not None:
            if not waiter(
                ready, timeout=timeout, should_abort=should_abort
            ):
                raise RingTimeout(f"{what} for {timeout}s ({self.name})")
            return
        # built-in fallback pacing (channels attach a Doorbell for the
        # instrumented version): spin-with-yield, then escalate
        deadline = None if timeout is None else _now() + timeout
        sleep = self._sleep_min
        spins = 0
        bell = self.bell
        # raise the parked byte for the whole wait: publishes only
        # ring the bell for a parked peer (produce/release elide the
        # Event traffic otherwise)
        try:
            self.set_parked(True)
        except (TypeError, ValueError):
            pass
        try:
            while True:
                if ready():
                    return
                if should_abort is not None and should_abort():
                    raise RingClosed(f"ring {self.name}: peer gone")
                if deadline is not None and _now() >= deadline:
                    raise RingTimeout(
                        f"{what} for {timeout}s ({self.name})"
                    )
                if bell.shared:
                    # both ends in-process: every publish sets this
                    # very Event, so park LONG — a short timeout would
                    # wake us just to steal the GIL from the peer
                    # mid-work.  clear-check-wait: a publish between
                    # the clear and the wait re-sets the event, so no
                    # wakeup is lost
                    bell.clear()
                    if ready():
                        return
                    bell.wait(0.005)
                elif spins < self._spin:
                    spins += 1
                    time.sleep(0)  # yield the GIL, stay hot
                else:
                    bell.clear()
                    if ready():
                        return
                    bell.wait(sleep)  # remote: degrades to a sleep
                    sleep = min(sleep * 2, self._sleep_max)
        finally:
            try:
                self.set_parked(False)
            except (TypeError, ValueError):
                pass

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Detach this side's mapping.  Exported views (a caller still
        holding a borrowed frame) make the mmap unreleasable — skipped
        rather than raised, the fd still closes with the process."""
        self.mark_closed()
        self.buf = None
        try:
            self._shm.close()
        except BufferError:
            # borrowed views pin the mmap (stdlib close() raises after
            # releasing _buf but before the fd) — finish the teardown
            # by hand: close the fd now, drop the mmap ref so the
            # mapping dies with the LAST view instead of __del__
            # re-raising at gc time
            shm = self._shm
            shm._mmap = None
            if getattr(shm, "_fd", -1) >= 0:
                os.close(shm._fd)
                shm._fd = -1

    def unlink(self) -> None:
        """Destroy the segment (CREATOR only, exactly once)."""
        if self._owner:
            try:
                # a SAME-process attacher's untrack (attach()) removed
                # the creator's registration too (one tracker set per
                # process, keyed by name) — re-registering is a set-add
                # no-op when it survived and rebalances when it didn't,
                # so unlink's internal unregister never double-pops
                resource_tracker.register(self._shm._name, "shared_memory")
            except Exception:  # noqa: BLE001 — tracking is best-effort
                pass
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass


__all__ = [
    "HDR_SIZE",
    "K_FRAME",
    "K_LINE",
    "K_WRAP",
    "REC_SIZE",
    "RingClosed",
    "RingCorruption",
    "RingTimeout",
    "ShmRing",
]
