"""Server side of a shm channel: the pump thread.

A copy of ``flink_parameter_server_tpu/shmem/pump.py``, which imports
no JAX: the port imports nothing of the JAX package, whose ``__init__``
imports JAX.  It runs over the port's ``utils/net.LineServer``; the
request copy-out below (``bytes(view)``) means a card shard's push, its
WAL append and its replication sink never hold ring memory.

A successful ``hello shm v=1 c2s=<seg> s2c=<seg>`` hands
:class:`~..utils.net.LineServer` two segment names the CLIENT created;
the pump attaches both, then serves the request ring through the SAME
override points TCP traffic uses — ``respond`` for ``K_LINE`` records,
``respond_frame`` for ``K_FRAME`` — so every verb, error string,
epoch fence, lease piggyback and overload shed behaves identically
over either wire.  Responses go back down the s2c ring; the TCP
connection that carried the hello stays open as the liveness anchor
(its EOF, either way, tears the channel down).

Accounting mirrors ``LineServer._serve_one`` byte for byte: the
per-connection :class:`~..utils.net.ConnStats` ledger (with
``wire="shm"`` — the ``psctl conns`` rollout column) and the server
NetMeter both count every record, so ``net_bytes_total`` stays honest
across a mixed tcp/shm fleet.

**Reader-crash-while-borrowing**: the client advances the response
ring's tail only when it RELEASES its zero-copy views, so a client
that died holding borrows leaves the s2c ring permanently full and
the pump blocked in ``produce``.  The client's heartbeat (beaten into
the c2s header ~every 50 ms) is the lease: once it goes stale past
``server.SHM_RECLAIM_S`` while the pump is write-blocked, the pump
reclaims — counts ``shmem_borrow_reclaims_total``, detaches both
rings and drops the TCP anchor.  A merely SLOW client keeps beating
and is never reclaimed; ring-full against a live peer is ordinary
backpressure.
"""
from __future__ import annotations

import logging
import threading
import time

from ..utils import frames as binf
from ..utils.net import _safe_verb
from .doorbell import Doorbell
from .metrics import count_reclaim, count_teardown, track_ring
from .ring import (
    K_FRAME,
    K_LINE,
    RingClosed,
    RingCorruption,
    RingTimeout,
    ShmRing,
)

logger = logging.getLogger(__name__)


class ShmServerPump:
    """One channel's server half (see module docstring).  Constructed
    by ``LineServer._maybe_shm_hello``; raising from ``__init__`` is
    the negotiation-failure path (the client falls back to TCP)."""

    def __init__(self, server, st, c2s_name: str, s2c_name: str):
        self.server = server
        self.st = st
        self._stop_evt = threading.Event()
        self._reclaimed = False
        self.c2s = ShmRing.attach(c2s_name)
        try:
            self.s2c = ShmRing.attach(s2c_name)
        except Exception:
            self.c2s.close()
            raise
        reg = getattr(server.meter, "_registry", None)
        self._registry = reg
        track_ring("server", "c2s", self.c2s, registry=reg)
        track_ring("server", "s2c", self.s2c, registry=reg)
        self._bell_in = Doorbell("server", ring=self.c2s, registry=reg)
        self._bell_out = Doorbell("server", ring=self.s2c, registry=reg)
        # heartbeat staleness tracking: (last value, local time it
        # last CHANGED) — cross-process clocks never compare, value
        # changes on the local clock do
        self._hb = (self.c2s.heartbeat(), time.monotonic())
        self.thread: threading.Thread = None  # type: ignore[assignment]

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ShmServerPump":
        t = threading.Thread(
            target=self._run, daemon=True,
            name=f"{self.server.name}-shm-pump",
        )
        with self.server._conns_lock:
            self.server._handlers.append(t)  # joined by stop(), like
            # any dispatcher thread — scale-in cycles must not leak it
        self.thread = t
        t.start()
        return self

    def stop(self) -> None:
        """Wake and fold the pump (idempotent; never joins — callers
        may BE the pump thread via ``_close_state``)."""
        self._stop_evt.set()
        for r in (self.c2s, self.s2c):
            try:
                r.mark_closed()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass

    # -- liveness ----------------------------------------------------------
    def _reclaim_s(self) -> float:
        return float(getattr(self.server, "SHM_RECLAIM_S", 5.0))

    def _stale(self) -> bool:
        try:
            hb = self.c2s.heartbeat()
        except (TypeError, ValueError):
            return True
        now = time.monotonic()
        if hb != self._hb[0]:
            self._hb = (hb, now)
        return now - self._hb[1] > self._reclaim_s()

    def _should_stop(self) -> bool:
        return (
            self._stop_evt.is_set()
            or self.server._stop.is_set()
            or self.st.closed
        )

    def _write_abort(self) -> bool:
        """Abort predicate for response-ring produce: stop flags, or
        the borrow lease expiring on a stale-heartbeat client."""
        if self._should_stop():
            return True
        if self._stale():
            self._reclaimed = True  # blocked on a dead borrower
            return True
        return False

    # -- the pump ----------------------------------------------------------
    def _run(self) -> None:
        stats = self.st.stats
        meter = self.server.meter
        try:
            while not self._should_stop():
                try:
                    kind, view = self.c2s.consume(
                        timeout=0.25, should_abort=self._should_stop,
                        waiter=self._bell_in.wait,
                    )
                except RingTimeout:
                    if self._stale():
                        return  # dead client, nothing in flight
                    continue
                except (RingClosed, RingCorruption):
                    return
                # server-side copy-out, then release: inbound frames
                # are small relative to responses, and holding borrows
                # across respond() would let a slow shard lock stall
                # the client's push ring (the zero-copy contract is
                # the CLIENT pull path's — docs/shmem.md)
                data = bytes(view)
                view = None
                self.c2s.release()
                if kind == K_LINE:
                    line = data.decode("utf-8", "replace").strip()
                    if not line:
                        continue
                    verb = _safe_verb(line)
                    stats.last_verb = verb
                    stats.bytes_in += len(data) + 1
                    stats.frames_in += 1
                    meter.count("in", verb, len(data) + 1)
                    resp = self.server.respond(line)
                    if resp is None:
                        continue
                    payload = resp.encode("utf-8")
                    out_kind, wire_len = K_LINE, len(payload) + 1
                else:
                    verb = binf.peek_verb_name(data)
                    stats.last_verb = verb
                    try:
                        _v, enc, _f, _t = binf.peek_header(data)
                        stats.enc = binf.ENC_NAMES.get(enc, "?")
                    except binf.FrameError:
                        pass
                    stats.bytes_in += len(data)
                    stats.frames_in += 1
                    meter.count("in", verb, len(data))
                    payload = self.server.respond_frame(data)
                    if payload is None:
                        continue
                    out_kind, wire_len = K_FRAME, len(payload)
                if len(payload) > self.s2c.max_record:
                    # a response legal over TCP (64 MiB max_line_bytes)
                    # but bigger than a ring record may be: answer a
                    # CLEAR protocol error instead of letting produce
                    # raise (which would silently fold the channel) —
                    # the client surfaces it as err bad-request
                    payload = (
                        f"err bad-request: {len(payload)}-byte response "
                        f"exceeds shm ring record limit "
                        f"({self.s2c.max_record}); re-chunk the request "
                        f"or use wire_proto=auto"
                    ).encode("utf-8")
                    out_kind, wire_len = K_LINE, len(payload) + 1
                # ledger BEFORE the hand-off, same as _serve_one
                stats.bytes_out += wire_len
                stats.frames_out += 1
                meter.count("out", verb, wire_len)
                try:
                    self.s2c.produce(
                        out_kind, payload,
                        timeout=None, should_abort=self._write_abort,
                        waiter=self._bell_out.wait,
                    )
                except (RingClosed, RingTimeout):
                    if self._reclaimed:
                        count_reclaim(registry=self._registry)
                    return
        except Exception:  # noqa: BLE001 — a poisoned record must not
            # leak the channel (respond() itself never raises) — but a
            # silent fold makes a programming error look like a dead
            # peer: count and log the reason before folding
            count_teardown("error", registry=self._registry)
            logger.warning(
                "%s: shm pump folding channel after unexpected error",
                self.server.name, exc_info=True,
            )
        finally:
            for r in (self.c2s, self.s2c):
                try:
                    r.close()
                except Exception:  # noqa: BLE001
                    pass
            # drop the TCP anchor so a live client observes teardown
            # (idempotent: _close_state no-ops on an already-closed
            # connection, which is how the normal-close path re-enters)
            try:
                self.server._close_state(self.st)
            except Exception:  # noqa: BLE001
                pass


__all__ = ["ShmServerPump"]
