"""Client side of the shm transport: ``ShmShardConnection``.

A copy of ``flink_parameter_server_tpu/shmem/channel.py``, which imports
no JAX: the port imports nothing of the JAX package, whose ``__init__``
imports JAX.  It subclasses the port's ``cluster/client.ShardConnection``.
A zero-copy frame's rows are a WRITABLE view of shared memory: every
caller that keeps pulled rows past the batch copies them first (the
cluster client scatters them into a fresh array; the hot cache copies
each leased row).

The channel is a drop-in :class:`~..cluster.client.ShardConnection`
whose data plane rides two :class:`~.ring.ShmRing` segments instead
of the TCP socket — same ``request_many`` surface, same windowed
pipelining, same positional response association, same mixed
str-line/bytes-frame self-describing requests.  Everything ABOVE the
wire (``utils/frames.py`` layout, epoch fencing, lease ``inv=``
piggybacks, trace tokens, q8/bf16 enc negotiation) carries over
byte for byte because the ring records ARE the TCP bytes, minus the
kernel.

Negotiation (docs/cluster.md): the client dials TCP as usual, CREATES
both segments (it owns their lifecycle, create → ``unlink``), and
sends a text ``hello shm v=1 c2s=<seg> s2c=<seg>``.  A shm-capable
co-located server attaches and answers ``ok proto=shm v=1 enc=...``;
anything else — an old server's ``err bad-request``, a proxy in the
path, an attach failure — tears the segments down, counts
``shmem_fallbacks_total``, and falls back to the ordinary binary
handshake on the SAME TCP connection (then lines).
The TCP socket stays open as the liveness anchor: its EOF means the
server is gone even when the rings look healthy.

Zero-copy pulls: a ``K_FRAME`` response decodes via
``frames.decode_split`` straight over the ring's memoryview — row
payloads ``np.frombuffer`` out of shared memory with no wire copy at
all.  The borrow protocol pays for it: views stay valid until
:meth:`release` (called automatically at the next ``request_many``),
and while anything is borrowed the server pump physically cannot
overwrite it — a full ring blocks the producer (ring.py).  A batch
whose responses OUTGROW the ring (``DEFAULT_CAPACITY`` 4 MiB; the
cluster client's chunked builders stay well under) does not wedge
that producer: past a high-water mark — or the moment a response
wait stalls with borrows outstanding — the channel SPILLS, copying
every frame handed out so far off the ring and releasing, so the
pump regains the whole ring mid-batch (``shmem_borrow_spills_total``;
spilled frames lose zero-copy, never correctness).

Oversize requests — legal over TCP (the 64 MiB ``max_line_bytes``
bound) but bigger than a ring record may be (``ring.max_record``,
half the capacity) — DETOUR over the TCP anchor: the channel drains
its in-flight ring responses first, then runs that one request
synchronously through the ordinary socket path (the server's
dispatcher still serves the anchor), so ordering holds and the
channel stays on shm for everything that fits
(``shmem_fallbacks_total{reason="oversize"}``).

Liveness, both directions: a beat thread bumps the c2s heartbeat
~every 50 ms (the server's borrow-reclaim lease, pump.py); the abort
probe peeks the TCP anchor (throttled, ``MSG_PEEK|MSG_DONTWAIT``) so
a dead server surfaces as :class:`~..utils.net.PeerHalfClosed` from a
ring wait instead of a hang.
"""
from __future__ import annotations

import os
import select
import socket
import threading
import time
from typing import List, Optional, Sequence, Tuple

from ..cluster.client import ShardConnection
from ..utils import frames as binf
from ..utils.net import PeerHalfClosed, _safe_verb, count_half_closed
from .doorbell import Doorbell
from .metrics import count_fallback, track_ring
from .ring import (
    K_FRAME,
    K_LINE,
    RingClosed,
    RingCorruption,
    RingTimeout,
    ShmRing,
)

DEFAULT_CAPACITY = 4 << 20  # per direction; one batch's responses
# must fit (the borrow protocol releases between batches, not within)

HELLO_VERSION = 1

_LOOPBACK = ("127.0.0.1", "localhost", "::1")


def available() -> bool:
    """Whether this host can carry shm channels at all: POSIX shared
    memory backed by a writable /dev/shm (the tests' skip guard —
    shm arms and tests stand down cleanly without it)."""
    global _AVAILABLE
    if _AVAILABLE is None:
        _AVAILABLE = (
            os.name == "posix"
            and os.path.isdir("/dev/shm")
            and os.access("/dev/shm", os.W_OK)
        )
    return _AVAILABLE


_AVAILABLE: Optional[bool] = None


def shm_usable(host: str) -> bool:
    """Whether a dial to ``host`` may attempt the shm hello: shared
    memory only reaches co-located peers, so anything but loopback is
    a ``not-local`` fallback before a segment is ever created."""
    return available() and host in _LOOPBACK


def hello_shm_line(c2s: str, s2c: str) -> str:
    return f"hello shm v={HELLO_VERSION} c2s={c2s} s2c={s2c}"


class ShmShardConnection(ShardConnection):
    """One shm channel to one co-located shard (see module docstring).

    Falls back AUTOMATICALLY: after construction :attr:`proto` is
    ``"shm"`` (rings live), ``"bin"`` or ``"line"`` (TCP fallback,
    counted in ``shmem_fallbacks_total``) — callers branch exactly as
    they do for the binary handshake.  :attr:`wire` mirrors the
    server-side ConnStats column: ``"shm"`` or ``"tcp"``.
    """

    def __init__(
        self,
        host: str,
        port: int,
        *,
        window: int = 8,
        timeout: float = 30.0,
        connect_timeout: Optional[float] = None,
        capacity: int = DEFAULT_CAPACITY,
        registry=None,
    ):
        super().__init__(
            host, port, window=window, timeout=timeout,
            connect_timeout=connect_timeout, negotiate=False,
        )
        self._timeout_s = float(timeout)
        self._registry = registry
        self.wire = "tcp"
        self.borrows = 0
        self.spills = 0
        self._c_borrows = None
        self._c_spills = None
        # zero-copy frames handed out of the response ring THIS batch
        # — the set a mid-batch spill must materialize before it may
        # release the ring under them
        self._borrows_open: List = []
        self._max_payload = 0
        self._spill_hiwater = 0
        self._c2s: Optional[ShmRing] = None
        self._s2c: Optional[ShmRing] = None
        self._bell_out: Optional[Doorbell] = None
        self._bell_in: Optional[Doorbell] = None
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self._peer_dead = False
        self._last_probe = 0.0
        try:
            c2s = ShmRing.create(capacity)
        except Exception:  # noqa: BLE001 — no shm on this host
            count_fallback("attach-failed", registry=registry)
            self._negotiate()
            return
        try:
            s2c = ShmRing.create(capacity)
        except Exception:  # noqa: BLE001
            c2s.close()
            c2s.unlink()
            count_fallback("attach-failed", registry=registry)
            self._negotiate()
            return
        try:
            resp = super().request_many(
                [hello_shm_line(c2s.name, s2c.name)]
            )[0]
        except Exception:
            for r in (c2s, s2c):
                r.close()
                r.unlink()
            raise
        if not (isinstance(resp, str) and resp.startswith("ok proto=shm")):
            # the downgrade path: an old server answered err
            # bad-request, a proxy refused to splice — segments die,
            # the SAME TCP connection renegotiates binary
            for r in (c2s, s2c):
                r.close()
                r.unlink()
            count_fallback("hello-refused", registry=registry)
            self._negotiate()
            return
        self._c2s, self._s2c = c2s, s2c
        self._max_payload = c2s.max_record
        # spill past half the response ring: keeps the pump's worst
        # remaining produce well inside the free half even before the
        # stall path kicks in
        self._spill_hiwater = s2c.capacity // 2
        self.proto = "shm"
        self.wire = "shm"
        self.encs = binf.hello_encs(resp)
        track_ring("client", "c2s", c2s, registry=registry)
        track_ring("client", "s2c", s2c, registry=registry)
        self._bell_out = Doorbell("client", ring=c2s, registry=registry)
        self._bell_in = Doorbell("client", ring=s2c, registry=registry)
        if registry is not False:
            try:
                from ..telemetry.registry import get_registry

                reg = registry if registry is not None else get_registry()
                self._c_borrows = reg.counter(
                    "shmem_borrows_total", component="shmem", role="client"
                )
                self._c_spills = reg.counter(
                    "shmem_borrow_spills_total", component="shmem",
                    role="client",
                )
            except Exception:  # accounting never fails the transport
                pass
        self._hb_thread = threading.Thread(
            target=self._beat_loop, daemon=True,
            name=f"shm-beat-{host}:{port}",
        )
        self._hb_thread.start()

    # -- liveness ----------------------------------------------------------
    def _beat_loop(self) -> None:
        """The borrow-reclaim lease: the server pump holds the channel
        open only while this keeps moving (pump.py)."""
        ring = self._c2s
        while not self._hb_stop.wait(0.05):
            try:
                ring.beat()
            except (TypeError, ValueError):
                return  # ring torn down under us

    def _abort(self) -> bool:
        """Ring-wait abort predicate: the TCP anchor's EOF is the
        server's death certificate.  Peeks at most every 10 ms so the
        hot path stays syscall-free."""
        if self._peer_dead:
            return True
        if self._s2c is not None and self._s2c.closed:
            self._peer_dead = True
            return True
        now = time.monotonic()
        if now - self._last_probe < 0.01:
            return False
        self._last_probe = now
        try:
            # zero-timeout readability check first: a timeout-mode
            # socket's recv would WAIT for readability, which is the
            # opposite of a probe
            readable, _, _ = select.select([self._sock], [], [], 0)
            if not readable:
                return False  # nothing pending = anchor alive
            if self._sock.recv(1, socket.MSG_PEEK) == b"":
                self._peer_dead = True  # orderly FIN
        except (OSError, ValueError):
            self._peer_dead = True  # anchor socket torn down
        return self._peer_dead

    def _dead(self, what: str) -> PeerHalfClosed:
        count_half_closed("client")
        return PeerHalfClosed(
            f"shard {self.host}:{self.port} closed mid-{what} (shm)"
        )

    # -- the request surface ----------------------------------------------
    def release(self) -> None:
        """Publish the response ring's tail: every view handed out by
        earlier batches is dead to the caller and its bytes are the
        server's again.  ``request_many`` calls this at batch start —
        the borrow window IS the gap between batches."""
        self._borrows_open.clear()
        if self._s2c is not None:
            try:
                self._s2c.release()
            except (TypeError, ValueError):
                pass

    def _spill_borrows(self) -> None:
        """Materialize every zero-copy frame handed out this batch —
        copy its payload off the ring — then release, handing the
        whole ring back to the pump MID-batch.  The escape hatch that
        lets a batch's responses outgrow the ring: spilled frames pay
        one copy (exactly what TCP pays per byte anyway), callers
        see identical Frames."""
        for f in self._borrows_open:
            f.payload = memoryview(bytes(f.payload))
            if f.ids is not None and not f.ids.flags["OWNDATA"]:
                f.ids = f.ids.copy()
        self._borrows_open.clear()
        try:
            self._s2c.release()
        except (TypeError, ValueError):
            return
        self.spills += 1
        if self._c_spills is not None:
            self._c_spills.inc()

    def request_many(self, lines: Sequence) -> List:
        if self.proto != "shm":
            return super().request_many(lines)  # TCP fallback chain
        self.release()
        out: List = []
        pending = 0
        pending_meta: List[Tuple[str, str]] = []  # (framing, verb)
        sent = 0
        total = len(lines)
        while sent < total or pending:
            while pending < self.window and sent < total:
                req = lines[sent]
                if isinstance(req, (bytes, bytearray, memoryview)):
                    payload = bytes(req)
                    verb = binf.peek_verb_name(payload)
                    kind, wire_len = K_FRAME, len(payload)
                else:
                    payload = req.encode("utf-8")
                    verb = _safe_verb(req)
                    # +1 mirrors the TCP newline so net_bytes_total
                    # compares across wires
                    kind, wire_len = K_LINE, len(payload) + 1
                if len(payload) > self._max_payload:
                    # legal over TCP, too big for a ring record: the
                    # TCP-anchor detour (module docstring).  Drain the
                    # ring pipeline first so ordering holds, then run
                    # this one request synchronously over the socket
                    # (the parent path meters it itself).
                    if pending:
                        break
                    count_fallback("oversize", registry=self._registry)
                    out.append(super().request_many([req])[0])
                    sent += 1
                    continue
                if pending and not self._produce(
                    kind, payload, timeout=0.05
                ):
                    # request ring stalled with responses owed: the
                    # pump may be write-blocked behind them (the
                    # classic pipelining deadlock a kernel socket
                    # buffer absorbs) — drain one response, which
                    # spills-and-releases as needed, then retry this
                    # same request
                    break
                if not pending:
                    self._produce(kind, payload)
                self._meter.count("out", verb, wire_len)
                pending_meta.append(("bin" if kind == K_FRAME else "line",
                                     verb))
                pending += 1
                sent += 1
                self.inflight = pending
                self.requests_sent += 1
            if pending:
                _framing, verb = pending_meta.pop(0)
                out.append(self._consume_one(verb))
                pending -= 1
                self.inflight = pending
        return out

    def _produce(
        self, kind: int, payload: bytes,
        *, timeout: Optional[float] = None,
    ) -> bool:
        """Append one request record.  With the default (full-budget)
        timeout a stall raises ``socket.timeout``; with an explicit
        short ``timeout`` a stall returns False instead, so the send
        loop can drain a response and retry (the pipelining-deadlock
        valve)."""
        try:
            self._c2s.produce(
                kind, payload,
                timeout=self._timeout_s if timeout is None else timeout,
                should_abort=self._abort, waiter=self._bell_out.wait,
            )
            return True
        except RingClosed:
            raise self._dead("request") from None
        except RingTimeout:
            if self._peer_dead:
                raise self._dead("request") from None
            if timeout is not None:
                return False
            raise socket.timeout(
                f"shm ring to {self.host}:{self.port} full for "
                f"{self._timeout_s}s"
            ) from None

    def _consume_one(self, verb: str):
        deadline = time.monotonic() + self._timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                if self._peer_dead:
                    raise self._dead("response")
                raise socket.timeout(
                    f"no shm response from {self.host}:{self.port} in "
                    f"{self._timeout_s}s"
                )
            # while our own borrows hold ring bytes, wait SHORT: a
            # stalled response may mean the pump is write-blocked on
            # the very bytes we are sitting on — spill-and-release
            # un-wedges it (the incremental half of the borrow
            # protocol); with nothing borrowed, wait the full budget
            spillable = self._s2c.borrowed() > 0
            try:
                kind, view = self._s2c.consume(
                    timeout=min(0.05, remaining) if spillable
                    else remaining,
                    should_abort=self._abort, waiter=self._bell_in.wait,
                )
                break
            except RingClosed:
                raise self._dead("response") from None
            except RingTimeout:
                if self._peer_dead:
                    raise self._dead("response") from None
                if spillable:
                    self._spill_borrows()
                continue
            except RingCorruption:
                # not retryable: a scribbled ring cannot be trusted
                # for any in-flight response — surface as a dead peer
                # so the elastic retry path re-dials (landing on TCP
                # if shm is what's broken)
                self._peer_dead = True
                raise self._dead("response (ring corruption)") from None
        if kind == K_LINE:
            text = bytes(view).decode("utf-8", "replace").rstrip("\n")
            self._meter.count("in", _safe_verb(text), len(view) + 1)
            return text
        # zero-copy: the frame's row payload is a view INTO the ring,
        # borrowed until the next batch's release() — np.frombuffer
        # reads shared memory directly, no wire copy anywhere
        hdr = bytes(view[: binf.HEADER_SIZE])
        frame = binf.decode_split(
            hdr, view[binf.HEADER_SIZE:], kind="response"
        )
        self.borrows += 1
        if self._c_borrows is not None:
            self._c_borrows.inc()
        self._meter.count("in", frame.verb_name, len(view))
        view = None
        self._borrows_open.append(frame)
        if self._s2c.borrowed() > self._spill_hiwater:
            # proactive spill at the high-water mark: a batch whose
            # responses outgrow the ring hands bytes back BEFORE the
            # pump ever write-blocks on our borrows
            self._spill_borrows()
        return frame

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=1.0)
        # mark_closed wakes the pump out of any ring wait BEFORE the
        # TCP FIN lands, so teardown is one pass, not a lease timeout
        for r in (self._c2s, self._s2c):
            if r is not None:
                r.close()
        super().close()
        for r in (self._c2s, self._s2c):
            if r is not None:
                r.unlink()  # creator-owned: exactly one unlink, here


__all__ = [
    "DEFAULT_CAPACITY",
    "ShmShardConnection",
    "available",
    "hello_shm_line",
    "shm_usable",
]
