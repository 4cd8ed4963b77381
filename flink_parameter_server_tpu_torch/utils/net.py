"""Shared TCP server skeleton: selectors event loop + framed dispatch.

A copy of ``flink_parameter_server_tpu/utils/net.py``, which imports
no JAX: the port imports nothing of the JAX package, whose ``__init__``
imports JAX.  Modules it names that the port does not have yet are the
reference's.

Three front ends in this repo speak request/response TCP — the serving
plane (``serving/server.py``), the telemetry scrape endpoint
(``telemetry/exporter.py``), and the cluster parameter-server shards
(``cluster/shard.py``) — over :class:`LineServer`, the socket skeleton
factored once.  Subclasses pick an override point:

  * ``respond(line) -> str`` — the line protocol: one response line per
    request line, in order, per connection;
  * ``respond_frame(frame_bytes) -> bytes`` — the BINARY protocol
    (utils/frames.py): one response frame per request frame, same
    ordering contract.  A connection opts in by sending the text
    ``hello bin v=1`` handshake first (the server's ``respond`` answers
    it; ``ok proto=bin`` flips the connection) — after that, every
    inbound frame is self-describing by its two non-ASCII magic bytes,
    so text lines and binary frames can share one connection (the
    mixed-fleet rollout path, docs/cluster.md "Binary framing");
  * ``handle_connection(conn)`` — full control of one accepted socket
    (the telemetry endpoint's one-shot HTTP answer, the chaos proxy's
    byte relay).  Subclasses overriding this keep the legacy
    thread-per-connection accept loop.

I/O model (ROADMAP item 1): servers dispatching via ``respond``/
``respond_frame`` run ONE selectors-based event loop thread that owns
accept and every IDLE socket — per-connection read buffers, frame
reassembly (newline or length-prefixed binary).  The first complete
request hands the socket to a per-connection dispatcher thread (lazily
started, FIFO — the ordering contract), which serves the queue and
then keeps ``recv``-ing the socket DIRECTLY while traffic keeps
arriving (``LINGER_S``): an active connection is one thread and two
kernel wakeups per round — the measured loopback floor — while a
connection idle past the linger parks back in the selector and costs
a table entry, not a blocked thread.  A slow ``respond`` (shard lock,
scatter) never stalls OTHER connections, and backpressure is the
ownership rule itself: while the dispatcher owns the socket nobody
reads ahead of it, so the TCP window pushes back on the peer exactly
as the old blocked-in-``recv`` handler did.

Lifecycle: ``start()`` is idempotent, ``stop()`` closes the listener
and every tracked connection and joins the I/O thread AND the
dispatcher threads (with a timeout) — repeated start/stop cycles in
one process (the elastic scale-in/out path) must not leak a thread per
connection ever accepted; the context manager form pairs them.
``port=0`` binds an ephemeral port — read it back from ``.port``.

Wire accounting (the latency-budget profiler's byte ledger,
docs/observability.md): every frame through the dispatch loop — and
every frame the :func:`request_lines` client helper moves — is counted
into the metrics registry as ``net_bytes_total`` / ``net_frames_total``
with ``{direction=in|out, verb=<verb>, role=server|client}`` labels
(``fps_``-prefixed on ``/metrics``); binary frames attribute their
header's verb id.  Per-connection totals (bytes/frames each way, peer,
age, negotiated protocol + payload encoding) are kept too and served
by :meth:`LineServer.conn_table` — the ``psctl conns`` surface, which
is how an operator sees a mixed line/binary fleet mid-rollout.
"""
from __future__ import annotations

import collections
import selectors
import socket
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

from . import frames as binframes


class PeerHalfClosed(ConnectionError):
    """The peer closed its write side mid-conversation (an empty read)
    — a DEAD peer, categorically different from a SLOW one (which
    surfaces as ``socket.timeout``).  Before this type existed both
    collapsed into the same failure path and a client could not tell
    "reconnect now, the peer is gone" from "wait, the peer is
    thinking".  Retryable: drop the connection and replay.  Every
    raise is counted into ``net_half_closed_total{role=}``
    (``fps_``-prefixed on ``/metrics``)."""


_HALF_CLOSED_COUNTERS: Dict[str, tuple] = {}
_HALF_CLOSED_LOCK = threading.Lock()


def count_half_closed(role: str, registry=None) -> None:
    """Bump the half-close counter for one endpoint role; accounting
    must never fail the I/O path (a missing telemetry plane is a
    no-op, same discipline as :class:`NetMeter`).  The handle cache is
    keyed by registry identity so a test-isolation registry swap does
    not count into the old plane."""
    try:
        from ..telemetry.registry import get_registry

        reg = registry if registry is not None else get_registry()
        with _HALF_CLOSED_LOCK:
            cached = _HALF_CLOSED_COUNTERS.get(role)
            if cached is None or cached[0] is not reg:
                cached = (reg, reg.counter(
                    "net_half_closed_total", component="net", role=role
                ))
                _HALF_CLOSED_COUNTERS[role] = cached
        cached[1].inc()
    except Exception:
        pass


def _safe_verb(line: str) -> str:
    """First token of a request line, sanitised for use as a label
    value (bounded cardinality: lowercase word chars, ≤16 chars,
    anything else → "other")."""
    tok = line.split(None, 1)[0] if line.strip() else "empty"
    tok = tok.lower()
    if len(tok) <= 16 and tok.replace("_", "").isalnum():
        return tok
    return "other"


class NetMeter:
    """(direction, verb) byte/frame counters on the metrics registry.

    One meter per role (``server`` for :class:`LineServer` fronts,
    ``client`` for :func:`request_lines` and the cluster client's
    connections) so the two endpoints of an in-process topology never
    collapse into one series.  Instrument handles are cached per key;
    a missing telemetry plane (or ``registry=False``) disables the
    meter rather than failing the I/O path.
    """

    def __init__(self, role: str = "server", registry=None):
        self.role = role
        self._registry = registry
        self._enabled = registry is not False
        self._counters: Dict[tuple, tuple] = {}
        self._bound_to = None  # registry the cache was built against
        self._lock = threading.Lock()

    def count(
        self, direction: str, verb: str, nbytes: int, frames: int = 1
    ) -> None:
        if not self._enabled:
            return
        try:
            from ..telemetry.registry import get_registry

            reg = (
                self._registry if self._registry is not None
                else get_registry()
            )
        except Exception:  # accounting must never fail a request
            self._enabled = False
            return
        if reg is not self._bound_to:
            # default registry swapped (test isolation): drop handles
            # pinned to the old one instead of counting into the void
            with self._lock:
                if reg is not self._bound_to:
                    self._counters = {}
                    self._bound_to = reg
        key = (direction, verb)
        pair = self._counters.get(key)  # dict reads are GIL-atomic
        if pair is None:
            try:
                with self._lock:
                    pair = self._counters.get(key)
                    if pair is None:
                        labels = {
                            "direction": direction, "verb": verb,
                            "role": self.role,
                        }
                        pair = (
                            reg.counter(
                                "net_bytes_total", component="net",
                                **labels,
                            ),
                            reg.counter(
                                "net_frames_total", component="net",
                                **labels,
                            ),
                        )
                        self._counters[key] = pair
            except Exception:  # accounting must never fail a request
                self._enabled = False
                return
        pair[0].inc(nbytes)
        pair[1].inc(frames)


# the client-role meter request_lines (and ShardConnection) share
_CLIENT_METER_LOCK = threading.Lock()
_CLIENT_METER: Optional[NetMeter] = None


def client_meter() -> NetMeter:
    global _CLIENT_METER
    with _CLIENT_METER_LOCK:
        if _CLIENT_METER is None:
            _CLIENT_METER = NetMeter(role="client")
        return _CLIENT_METER


class ConnStats:
    """Per-connection wire ledger (updated only by the connection's
    own dispatcher/handler thread; read by
    :meth:`LineServer.conn_table`).  ``proto`` is the negotiated
    framing (``line`` until a successful binary hello), ``enc`` the
    last payload encoding seen on a binary frame, ``wire`` the
    substrate under it (``tcp``, or ``shm`` after a shared-memory
    hello handed the data plane to a ring pair) — the columns that
    make a mixed-version fleet visible in ``psctl conns``."""

    __slots__ = (
        "peer", "connected_at", "bytes_in", "bytes_out",
        "frames_in", "frames_out", "last_verb", "proto", "enc", "wire",
    )

    def __init__(self, peer: str):
        self.peer = peer
        self.connected_at = time.time()
        self.bytes_in = 0
        self.bytes_out = 0
        self.frames_in = 0
        self.frames_out = 0
        self.last_verb = ""
        self.proto = "line"
        self.enc = ""
        self.wire = "tcp"

    def as_dict(self) -> dict:
        return {
            "peer": self.peer,
            "age_s": round(time.time() - self.connected_at, 3),
            "bytes_in": self.bytes_in,
            "bytes_out": self.bytes_out,
            "frames_in": self.frames_in,
            "frames_out": self.frames_out,
            "last_verb": self.last_verb,
            "proto": self.proto,
            "enc": self.enc,
            "wire": self.wire,
        }


class _ConnState:
    """One connection's event-loop state: the socket, its read buffer,
    the FIFO of complete-but-unserved requests, and the dispatcher
    coordination.  Queue/flags are guarded by ``cond``'s lock (shared
    io-thread/dispatcher state); the buffer is touched only by the io
    thread, the socket writes only by the dispatcher."""

    __slots__ = (
        "sock", "stats", "buf", "queue", "cond", "eof", "closed",
        "owned", "dispatcher_started", "overflow", "shm",
    )

    def __init__(self, sock: socket.socket, stats: ConnStats):
        self.sock = sock
        self.stats = stats
        self.buf = bytearray()
        self.queue: Deque[Tuple[str, bytes]] = collections.deque()
        self.cond = threading.Condition()
        self.eof = False
        self.closed = False
        # True while the DISPATCHER owns the socket's read side (the
        # active-connection fast path — see LineServer._linger_read);
        # the io thread reads only while this is False
        self.owned = False
        self.dispatcher_started = False
        self.overflow: Optional[str] = None  # "line" | "bin" | None
        # the shm pump once a shared-memory hello handed this
        # connection's data plane to a ring pair (the TCP socket stays
        # as the liveness anchor); stopped by _close_state
        self.shm = None


class LineServer:
    """Reusable TCP server: a selectors event loop feeding per-
    connection dispatcher threads (``respond``/``respond_frame``
    servers), or the legacy thread-per-connection accept loop for
    subclasses overriding :meth:`handle_connection`.
    """

    # how long an ACTIVE connection's dispatcher keeps reading its own
    # socket before parking it back in the selector: request/response
    # traffic inside this window is served entirely on one thread (two
    # kernel wakeups per round — the measured loopback floor), while a
    # connection idle past it costs a selector entry instead of a
    # blocked thread.  See _linger_read.
    LINGER_S = 0.5

    # borrow-reclaim lease for shm channels: a pump blocked writing
    # into a full response ring reclaims once the client heartbeat has
    # been silent this long (reader-crash-while-borrowing — a LIVE
    # client keeps beating and is never reclaimed).  See shmem/pump.py.
    SHM_RECLAIM_S = 5.0

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        name: str = "line-server",
        backlog: int = 16,
        max_line_bytes: int = 1 << 20,
        registry=None,
    ):
        self.name = name
        self.max_line_bytes = int(max_line_bytes)
        # wire accounting: process-wide counters + per-connection table
        # (registry=False switches the counters off; the table stays)
        self.meter = NetMeter(role="server", registry=registry)
        self._conn_stats: Dict[socket.socket, ConnStats] = {}
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(backlog)
        self.host, self.port = self._sock.getsockname()[:2]
        self._accept_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._conns: List[socket.socket] = []
        self._states: Dict[socket.socket, _ConnState] = {}
        self._handlers: List[threading.Thread] = []
        self._conns_lock = threading.Lock()
        # connections a dispatcher drained below the backpressure
        # threshold — the io loop re-registers them each tick
        self._resume: Deque[_ConnState] = collections.deque()
        self.connections_accepted = 0  # lifetime count (observability)
        # opt-in per subclass (ShardServer flips it): a server that
        # never opts in answers the shm hello with the same err
        # bad-request an old server would — the downgrade path
        self.shm_enabled = False

    def live_connections(self) -> int:
        """Currently-open connections (the lifetime count is
        :attr:`connections_accepted`) — the churn observability the
        span-tracer leak regression test reads alongside
        ``SpanTracer.stack_count()``."""
        with self._conns_lock:
            return len(self._conns)

    def conn_table(self) -> List[dict]:
        """Live per-connection wire ledger — peer, age, bytes/frames
        each way, last verb, negotiated proto/enc — the ``psctl
        conns`` answer."""
        with self._conns_lock:
            stats = list(self._conn_stats.values())
        return [s.as_dict() for s in stats]

    def _stats_for(self, conn: socket.socket) -> ConnStats:
        st = self._conn_stats.get(conn)
        if st is None:  # handler started before accept registered it
            st = ConnStats("?")
            with self._conns_lock:
                st = self._conn_stats.setdefault(conn, st)
        return st

    # -- lifecycle ---------------------------------------------------------
    def _uses_event_loop(self) -> bool:
        """Default servers (``respond``/``respond_frame``) run the
        selectors loop; subclasses overriding ``handle_connection``
        keep the legacy thread-per-connection accept loop."""
        return (
            type(self).handle_connection is LineServer.handle_connection
        )

    def start(self) -> "LineServer":
        if self._accept_thread is None or not self._accept_thread.is_alive():
            self._stop.clear()
            target = (
                self._io_loop if self._uses_event_loop()
                else self._accept_loop
            )
            self._accept_thread = threading.Thread(
                target=target, name=f"{self.name}-io", daemon=True,
            )
            self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            # close() alone does NOT wake a thread blocked in accept()
            # on Linux — the fd vanishes but the wait continues, and
            # every stop then eats the full accept-join timeout below
            # (measured: a flat 5 s per server teardown across the
            # suite).  shutdown() makes the blocked accept return
            # immediately (EINVAL), same trick as the per-connection
            # sockets.
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
            states = list(self._states.values())
            handlers = list(self._handlers)
            self._handlers = []
        for c in conns:
            try:
                # a handler blocked in recv() does not notice close()
                # alone on all platforms; shutdown() interrupts it
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        for st in states:
            with st.cond:
                st.cond.notify_all()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
            self._accept_thread = None
        # join the dispatcher/handler threads: a scale-in/out cycle
        # that stops servers repeatedly in ONE process must not leak a
        # thread (and its socket buffers) per connection ever accepted
        for t in handlers:
            if t is not threading.current_thread():
                t.join(timeout=5)
        # final sweep: a connection accepted concurrently with the
        # snapshot above may have registered afterwards — its handler
        # exits on the stop flag; close its socket, join it, prune
        with self._conns_lock:
            for c in self._conns:
                try:
                    c.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    c.close()
                except OSError:
                    pass
            self._conns.clear()
            for st in self._states.values():
                with st.cond:
                    st.cond.notify_all()
            late = list(self._handlers)
        for t in late:
            if t is not threading.current_thread():
                t.join(timeout=5)
        with self._conns_lock:
            self._handlers = [
                t for t in self._handlers if t.is_alive()
            ]

    @property
    def running(self) -> bool:
        return (
            self._accept_thread is not None
            and self._accept_thread.is_alive()
        )

    def __enter__(self) -> "LineServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- shared accept bookkeeping -----------------------------------------
    def _setup_accepted(
        self, conn: socket.socket, addr
    ) -> Optional[ConnStats]:
        try:
            # request/response protocols: answer frames must not sit
            # in Nagle's buffer waiting for a delayed ACK (measured
            # ~40 ms/frame stalls on loopback without this)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        stats = ConnStats(f"{addr[0]}:{addr[1]}")
        with self._conns_lock:
            self._conns.append(conn)
            self._conn_stats.setdefault(conn, stats)
            self.connections_accepted += 1
            # prune finished threads so the tracking list stays
            # bounded by LIVE connections, not total ever accepted
            self._handlers = [
                t for t in self._handlers if t.is_alive()
            ]
        return stats

    def _forget_conn(self, conn: socket.socket) -> None:
        with self._conns_lock:
            try:
                self._conns.remove(conn)
            except ValueError:
                pass
            self._conn_stats.pop(conn, None)
            self._states.pop(conn, None)

    # -- the selectors event loop ------------------------------------------
    def _io_loop(self) -> None:
        sel = selectors.DefaultSelector()
        try:
            sel.register(self._sock, selectors.EVENT_READ, None)
        except (OSError, ValueError):
            sel.close()
            return
        try:
            while not self._stop.is_set():
                while True:
                    try:
                        st = self._resume.popleft()
                    except IndexError:
                        break
                    self._register(sel, st)
                try:
                    events = sel.select(timeout=0.05)
                except OSError:
                    return
                for key, _mask in events:
                    st = key.data
                    if st is None:
                        self._io_accept(sel)
                    else:
                        self._io_read(sel, st)
        finally:
            try:
                sel.close()
            except OSError:
                pass

    def _register(self, sel, st: _ConnState) -> None:
        with st.cond:
            if st.closed or st.owned:
                return
        try:
            sel.register(st.sock, selectors.EVENT_READ, st)
        except KeyError:
            # a stale map entry from a closed fd that was reused:
            # evict it, then register the live connection
            try:
                sel.unregister(st.sock)
            except (KeyError, ValueError, OSError):
                pass
            try:
                sel.register(st.sock, selectors.EVENT_READ, st)
            except (ValueError, OSError):
                pass
        except (ValueError, OSError):
            pass

    def _io_accept(self, sel) -> None:
        try:
            conn, addr = self._sock.accept()
        except OSError:
            return
        stats = self._setup_accepted(conn, addr)
        st = _ConnState(conn, stats)
        with self._conns_lock:
            self._states[conn] = st
        self._register(sel, st)

    def _io_read(self, sel, st: _ConnState) -> None:
        try:
            data = st.sock.recv(1 << 16)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            data = b""
        if not data:
            try:
                sel.unregister(st.sock)
            except (KeyError, ValueError, OSError):
                pass
            started = st.dispatcher_started
            with st.cond:
                st.eof = True
                st.cond.notify_all()
            if not started:
                self._close_state(st)
            return
        st.buf += data
        if self._extract_requests(st):
            # hand the socket's read side to the dispatcher (the
            # active-connection fast path): it serves the queue, then
            # keeps recv'ing directly — one thread, two kernel wakeups
            # per round — until the connection idles past LINGER_S and
            # parks back here.  While owned, this loop never touches
            # the socket, which is also the backpressure: a slow
            # dispatcher simply stops reading and TCP pushes back.
            with st.cond:
                st.owned = True
            try:
                sel.unregister(st.sock)
            except (KeyError, ValueError, OSError):
                pass

    def _extract_requests(self, st: _ConnState) -> int:
        """Split the connection buffer into complete requests —
        newline lines or length-prefixed binary frames, each
        self-describing by its leading bytes — and enqueue them for
        the dispatcher.  Returns how many items were enqueued."""
        items: List[Tuple[str, bytes]] = []
        overflow: Optional[str] = None
        buf = st.buf
        while True:
            if binframes.peek_is_binary(buf):
                total = binframes.frame_length(buf)
                if total is None:
                    break
                if total > self.max_line_bytes:
                    overflow = "bin"
                    break
                if len(buf) < total:
                    break
                items.append(("bin", bytes(buf[:total])))
                del buf[:total]
            else:
                i = buf.find(b"\n")
                if i < 0:
                    if len(buf) > self.max_line_bytes:
                        overflow = "line"
                    break
                raw = bytes(buf[:i])
                del buf[: i + 1]
                items.append(("line", raw))
        if not items and overflow is None:
            return 0
        with st.cond:
            st.queue.extend(items)
            if overflow is not None:
                st.overflow = overflow
                st.queue.append(("overflow", b""))
            st.cond.notify_all()
        self._ensure_dispatcher(st)
        return len(items) + (0 if overflow is None else 1)

    def _ensure_dispatcher(self, st: _ConnState) -> None:
        if st.dispatcher_started:
            return
        st.dispatcher_started = True
        with self._conns_lock:
            t = threading.Thread(
                target=self._dispatch_loop, args=(st,), daemon=True,
                name=f"{self.name}-conn-{self.connections_accepted}",
            )
            self._handlers.append(t)
        t.start()

    def _dispatch_loop(self, st: _ConnState) -> None:
        try:
            while True:
                kind = data = None
                with st.cond:
                    while True:
                        if st.closed or self._stop.is_set():
                            return
                        if st.queue:
                            kind, data = st.queue.popleft()
                            break
                        if st.eof:
                            return  # everything served
                        if st.owned:
                            break  # queue drained: read the socket
                        st.cond.wait(0.1)
                if kind is None:
                    if not self._linger_read(st):
                        return
                    continue
                if not self._serve_one(st, kind, data):
                    return
        except OSError:
            pass
        except Exception:  # noqa: BLE001 — a poisoned frame must not
            pass  # leak the connection; respond() itself never raises
        finally:
            self._close_state(st)

    def _linger_read(self, st: _ConnState) -> bool:
        """The active-connection fast path: while this dispatcher owns
        the socket, it recv's directly — request/response traffic is
        then one thread and two kernel wakeups per round, the measured
        loopback floor, instead of bouncing through the io thread.  A
        connection idle past ``LINGER_S`` is handed back to the
        selector (the io thread re-registers it from ``_resume``), so
        an idle connection costs a table entry, not a thread.  Returns
        False when the connection is going down."""
        try:
            st.sock.settimeout(self.LINGER_S)
            data = st.sock.recv(1 << 16)
        except socket.timeout:
            try:
                st.sock.settimeout(None)
            except OSError:
                return False
            with st.cond:
                st.owned = False
            self._resume.append(st)
            return True
        except OSError:
            return False
        if not data:
            with st.cond:
                st.eof = True
            return True
        try:
            # back to fully blocking before any respond() sendall — a
            # response stalled on TCP backpressure (a held partition)
            # must BLOCK like the old handler did, not die at the
            # linger deadline
            st.sock.settimeout(None)
        except OSError:
            return False
        st.buf += data
        self._extract_requests(st)
        return True

    def _serve_one(self, st: _ConnState, kind: str, data: bytes) -> bool:
        """Serve one request on the dispatcher thread; returns False
        when the connection must close (overflow discipline)."""
        stats = st.stats
        if kind == "overflow":
            if st.overflow == "bin":
                payload = binframes.error_response(
                    0, binframes.STATUS_BAD_REQUEST, "frame too long"
                )
            else:
                payload = b"err bad-request: line too long\n"
            try:
                st.sock.sendall(payload)
            except OSError:
                pass
            return False
        if kind == "bin":
            verb = binframes.peek_verb_name(data)
            stats.last_verb = verb
            try:
                _v, enc, _f, _t = binframes.peek_header(data)
                stats.enc = binframes.ENC_NAMES.get(enc, "?")
            except binframes.FrameError:
                pass
            stats.bytes_in += len(data)
            stats.frames_in += 1
            self.meter.count("in", verb, len(data))
            resp = self.respond_frame(data)
            if resp is not None:
                # ledger BEFORE the write: a client that has read the
                # response must never observe a table that hasn't
                # counted it yet
                stats.bytes_out += len(resp)
                stats.frames_out += 1
                self.meter.count("out", verb, len(resp))
                st.sock.sendall(resp)
            return True
        line = data.decode("utf-8", "replace").strip()
        if not line:
            return True
        verb = _safe_verb(line)
        stats.last_verb = verb
        stats.bytes_in += len(data) + 1
        stats.frames_in += 1
        self.meter.count("in", verb, len(data) + 1)
        resp = None
        if verb == "hello":
            # the shm hello is a TRANSPORT negotiation, handled here
            # rather than in respond(): on success this connection's
            # data plane moves to a ring pair and the socket becomes
            # the liveness anchor.  None = not an shm hello (or shm
            # disabled) — falls through to respond(), whose unknown-
            # protocol err is the downgrade path old servers take.
            resp = self._maybe_shm_hello(st, line)
        if resp is None:
            resp = self.respond(line)
        if resp is not None:
            payload = resp.encode("utf-8") + b"\n"
            stats.bytes_out += len(payload)
            stats.frames_out += 1
            self.meter.count("out", verb, len(payload))
            st.sock.sendall(payload)
            if verb == "hello" and resp.startswith("ok proto=bin"):
                # negotiation accepted: record it (frames were already
                # acceptable — they are self-describing — but the
                # conn ledger shows the negotiated protocol)
                stats.proto = "bin"
        return True

    def _maybe_shm_hello(self, st: _ConnState, line: str) -> Optional[str]:
        """Negotiate ``hello shm v=1 c2s=<seg> s2c=<seg>``: attach the
        client-created segments and start the pump (shmem/pump.py).
        Returns the answer line, or ``None`` when the line is not an
        shm hello / shm is not enabled (caller falls through to
        ``respond()``).  Any failure answers ``err`` — the client
        tears its segments down and renegotiates binary on this same
        connection, so a refusal is never fatal."""
        toks = line.split()
        if len(toks) < 2 or toks[0].lower() != "hello" \
                or toks[1].lower() != "shm":
            return None
        if not self.shm_enabled:
            return None  # respond() answers err unknown-protocol
        opts = {}
        for tok in toks[2:]:
            if "=" in tok:
                k, _, v = tok.partition("=")
                opts[k.lower()] = v
        if opts.get("v") != "1":
            return f"err bad-request: shm version {opts.get('v')!r}"
        c2s, s2c = opts.get("c2s"), opts.get("s2c")
        if not c2s or not s2c:
            return "err bad-request: shm hello needs c2s= and s2c="
        try:
            from ..shmem.pump import ShmServerPump

            pump = ShmServerPump(self, st, c2s, s2c)
        except Exception as exc:  # noqa: BLE001 — refusal, not death
            return f"err bad-request: shm attach failed: {exc}"
        st.shm = pump
        st.stats.proto = "shm"
        st.stats.wire = "shm"
        pump.start()
        return "ok proto=shm v=1 enc=" + ",".join(binframes.WIRE_ENCS)

    def _close_state(self, st: _ConnState) -> None:
        with st.cond:
            if st.closed:
                return
            st.closed = True
            pump = st.shm
        if pump is not None:
            # wake the pump out of any ring wait; it observes
            # st.closed and folds (its own teardown re-enters here and
            # no-ops on the guard above)
            pump.stop()
        try:
            st.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            st.sock.close()
        except OSError:
            pass
        self._forget_conn(st.sock)

    # -- the legacy thread-per-connection path ------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return  # listener closed
            self._setup_accepted(conn, addr)
            with self._conns_lock:
                t = threading.Thread(
                    target=self._handle_and_close, args=(conn,),
                    daemon=True,
                    name=f"{self.name}-conn-{self.connections_accepted}",
                )
                self._handlers.append(t)
            t.start()

    def _handle_and_close(self, conn: socket.socket) -> None:
        try:
            self.handle_connection(conn)
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
            self._forget_conn(conn)

    # -- override points ---------------------------------------------------
    def handle_connection(self, conn: socket.socket) -> None:
        """Full-socket override point (telemetry exporter, chaos
        proxy).  Subclasses overriding this run under the legacy
        accept loop; the default implementation is the old blocking
        line loop, kept for completeness but unused by the event-loop
        path."""
        buf = b""
        stats = self._stats_for(conn)
        while not self._stop.is_set():
            chunk = conn.recv(1 << 16)
            if not chunk:
                return
            buf += chunk
            if len(buf) > self.max_line_bytes and b"\n" not in buf:
                conn.sendall(b"err bad-request: line too long\n")
                return
            *lines, buf = buf.split(b"\n")
            for raw in lines:
                line = raw.decode("utf-8", "replace").strip()
                if not line:
                    continue
                verb = _safe_verb(line)
                stats.last_verb = verb
                stats.bytes_in += len(raw) + 1
                stats.frames_in += 1
                self.meter.count("in", verb, len(raw) + 1)
                resp = self.respond(line)
                if resp is not None:
                    payload = resp.encode("utf-8") + b"\n"
                    stats.bytes_out += len(payload)
                    stats.frames_out += 1
                    self.meter.count("out", verb, len(payload))
                    conn.sendall(payload)

    def respond(self, line: str) -> Optional[str]:
        """One response line per request line (no trailing newline;
        ``None`` = answer nothing).  Required unless
        :meth:`handle_connection` is overridden."""
        raise NotImplementedError(
            f"{type(self).__name__} must implement respond() or override "
            f"handle_connection()"
        )

    def respond_frame(self, data: bytes) -> Optional[bytes]:
        """One encoded response frame per binary request frame
        (utils/frames.py).  The default declines: a server that never
        answered the binary hello should never see one of these — and
        if it does, the error frame tells the peer to downgrade."""
        try:
            verb, _enc, _flag, _total = binframes.peek_header(data)
        except binframes.FrameError:
            verb = 0
        return binframes.error_response(
            verb, binframes.STATUS_BAD_REQUEST,
            "binary frames not supported",
        )


def request_lines(
    host: str,
    port: int,
    lines,
    timeout: float = 30.0,
    connect_timeout: Optional[float] = None,
) -> List[str]:
    """Pipelined client helper: send every request line on ONE
    connection, then read exactly one response line per request (the
    line-protocol ordering contract).  Returns the response lines.
    Bytes/frames are counted into the client-role wire ledger
    (``net_bytes_total{role="client"}``), attributed per request verb
    — responses positionally, per the ordering contract.

    ``timeout`` is the per-read deadline once connected;
    ``connect_timeout`` (default: same as ``timeout``) bounds the dial
    separately — a liveness probe against a dead host must fail in its
    own budget, not the read's."""
    reqs = [ln.strip() for ln in lines]
    meter = client_meter()
    dial = timeout if connect_timeout is None else float(connect_timeout)
    with socket.create_connection((host, port), timeout=dial) as s:
        s.settimeout(timeout)
        for ln in reqs:
            meter.count("out", _safe_verb(ln), len(ln) + 1)
        s.sendall(("\n".join(reqs) + "\n").encode("utf-8"))
        buf = b""
        out: List[str] = []
        while len(out) < len(reqs):
            chunk = s.recv(1 << 16)
            if not chunk:
                # empty read = the peer half-closed: a DEAD peer, not a
                # slow one (a slow peer is socket.timeout, raised by
                # recv itself) — distinct type, counted
                count_half_closed("client")
                raise PeerHalfClosed(
                    f"peer closed after {len(out)}/{len(reqs)} responses"
                )
            buf += chunk
            *got, buf = buf.split(b"\n")
            for g in got:
                if len(out) < len(reqs):
                    meter.count(
                        "in", _safe_verb(reqs[len(out)]), len(g) + 1
                    )
                out.append(g.decode("utf-8", "replace"))
    return out[: len(reqs)]


__all__ = [
    "ConnStats",
    "LineServer",
    "NetMeter",
    "PeerHalfClosed",
    "client_meter",
    "count_half_closed",
    "request_lines",
]
