"""ChaosProxy — a seeded byte-level TCP fault-injection proxy.

Counterpart of ``flink_parameter_server_tpu/nemesis/proxy.py``, which
imports no JAX: a copy, since the port imports nothing of the JAX package
(whose ``__init__`` imports JAX).  It runs over the port's
``utils/net.LineServer`` and ``utils/frames`` and relays host bytes
only: a proxied link's rows are copied off the card by the shard, as
every wire's are.

Every front end in this repo speaks the newline-framed line protocol
over TCP (``utils/net.LineServer``), and every in-process fault we
could inject before this module lived ABOVE the socket: chaos hooks on
the training thread, a flaky producer, replication-stream drops.  The
network between a client and a shard — the layer the PS literature
says dominates production failures (stragglers and partial partitions,
arXiv:2308.15482) — was never exercised.  This proxy is that layer
made hostile on demand.

It fronts any backend ``(host, port)``: clients dial the proxy, the
proxy dials the backend, and two pump threads relay bytes per
connection, reassembling newline frames so faults can be injected at
frame *and* byte granularity.  Fault classes (docs/resilience.md
fault-model matrix):

  =============  ========================================================
  fault          wire effect
  =============  ========================================================
  partition      bytes in the affected direction(s) are HELD (the pump
                 stops reading, TCP backpressure builds) until healed —
                 one-way (``c2s`` requests blackholed, ``s2c`` responses
                 blackholed — the asymmetric split) or ``both``;
                 optionally self-healing after ``duration_s``
  delay          per-frame sleep of ``ms`` + seeded uniform jitter —
                 the slow-shard straggler
  drip           bandwidth cap: frames trickle out in small slices at
                 ``bytes_per_sec``
  dup            the next complete frame is forwarded TWICE (a broken
                 middlebox; TCP itself never delivers this)
  reorder        the next complete frame is held and forwarded AFTER
                 its successor (ditto — violates TCP ordering)
  truncate_rst   the next complete frame is cut mid-frame (``keep_frac``
                 of its bytes, never the whole frame) and BOTH legs are
                 aborted with RST — the peer-died-mid-payload case
  half_open      the next ``count`` accepted connections are never
                 bridged to the backend: the dial succeeds, every read
                 hangs until the client's own deadline
  =============  ========================================================

Determinism: jitter draws come from one seeded generator, one-shot
faults key on frame arrival order, and partitions/windows are armed by
scenario ops at training-round boundaries (``nemesis/scenarios.py``) —
a scenario's faults replay from its ``(seed, schedule)`` pair.

Injected faults are counted per class into
``nemesis_faults_injected_total{kind=}`` (``component=nemesis``) and
mirrored in :attr:`ChaosProxy.faults` for the artifact roll-up.

:class:`ProxiedServer` is the mesh's splice point: it wraps a running
``ShardServer`` so ``.host``/``.port`` advertise the PROXY while
lifecycle calls reach the real server — the elastic drivers publish
whatever ``(srv.host, srv.port)`` says, so a driver built from proxied
servers routes every client, migration, and heartbeat byte through the
mesh without any cluster-side changes.
"""
from __future__ import annotations

import socket
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ..utils import frames as binframes
from ..utils.net import LineServer

# struct linger {onoff=1, linger=0}: close() becomes RST, not FIN —
# the abrupt peer death (same idiom as resilience/chaos.py)
_LINGER_RST = b"\x01\x00\x00\x00\x00\x00\x00\x00"

DIRECTIONS = ("c2s", "s2c")
_ONE_SHOT_KINDS = ("dup", "reorder", "truncate_rst")


class _Aborted(Exception):
    """Internal: a truncate_rst fault tore this connection down."""


class _FaultEngine:
    """Per-proxy fault state shared by every connection's pumps.

    Partitions are direction gates (``threading.Event`` cleared =
    held); delay/drip are windowed per direction; one-shot faults queue
    per direction and fire on the next complete frame anywhere on the
    link (frame ordinals are link-wide, which is what makes a schedule
    deterministic across reconnects).
    """

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._rng = np.random.default_rng(seed)
        self._clear = {d: threading.Event() for d in DIRECTIONS}
        for ev in self._clear.values():
            ev.set()
        self._delay: Dict[str, Optional[tuple]] = {d: None for d in DIRECTIONS}
        self._drip: Dict[str, Optional[float]] = {d: None for d in DIRECTIONS}
        self._one_shot: Dict[str, List[dict]] = {d: [] for d in DIRECTIONS}
        self._half_open = 0
        self.frames = {d: 0 for d in DIRECTIONS}

    def _dirs(self, mode: str) -> tuple:
        if mode == "both":
            return DIRECTIONS
        if mode not in DIRECTIONS:
            raise ValueError(f"direction {mode!r}: 'c2s' | 's2c' | 'both'")
        return (mode,)

    # -- windowed faults ---------------------------------------------------
    def hold(self, mode: str) -> None:
        for d in self._dirs(mode):
            self._clear[d].clear()

    def release_all(self) -> None:
        for ev in self._clear.values():
            ev.set()

    def partitioned(self) -> bool:
        return any(not ev.is_set() for ev in self._clear.values())

    def wait_clear(self, direction: str, stop: threading.Event) -> None:
        ev = self._clear[direction]
        while not ev.is_set() and not stop.is_set():
            ev.wait(0.02)

    def set_delay(self, ms: float, jitter_ms: float, mode: str) -> None:
        for d in self._dirs(mode):
            self._delay[d] = (float(ms), float(jitter_ms))

    def clear_delay(self) -> None:
        for d in DIRECTIONS:
            self._delay[d] = None

    def set_drip(self, bytes_per_sec: float, mode: str) -> None:
        if bytes_per_sec <= 0:
            raise ValueError(f"bytes_per_sec={bytes_per_sec}: must be > 0")
        for d in self._dirs(mode):
            self._drip[d] = float(bytes_per_sec)

    def clear_drip(self) -> None:
        for d in DIRECTIONS:
            self._drip[d] = None

    def drip_rate(self, direction: str) -> Optional[float]:
        return self._drip[direction]

    def delay_s(self, direction: str) -> float:
        """The (seeded) sleep for one frame in ``direction`` — 0.0 when
        no delay window is active."""
        d = self._delay[direction]
        if d is None:
            return 0.0
        ms, jitter = d
        with self._lock:
            j = float(self._rng.uniform(0.0, jitter)) if jitter > 0 else 0.0
        return (ms + j) / 1e3

    # -- one-shot faults ---------------------------------------------------
    def inject_once(
        self, kind: str, direction: str, *, keep_frac: float = 0.35,
        count: int = 1, cut: str = "frame",
    ) -> None:
        """``cut`` aims a ``truncate_rst`` inside a specific region of
        a BINARY frame: ``"frame"`` (anywhere, ``keep_frac`` of the
        bytes — the line-protocol behaviour too), ``"header"``
        (strictly inside the 24-byte fixed header — the peer dies
        before the length prefix completes), ``"payload"`` (past the
        header, inside the TLV/id/row bytes — a torn payload under an
        intact header).  Line frames fall back to the frac cut."""
        if kind not in _ONE_SHOT_KINDS:
            raise ValueError(f"kind {kind!r}: one of {_ONE_SHOT_KINDS}")
        if direction not in DIRECTIONS:
            raise ValueError(f"direction {direction!r}: 'c2s' | 's2c'")
        if not 0.0 < keep_frac < 1.0:
            raise ValueError(f"keep_frac={keep_frac}: must be in (0, 1)")
        if cut not in ("frame", "header", "payload"):
            raise ValueError(
                f"cut={cut!r}: 'frame' | 'header' | 'payload'"
            )
        with self._lock:
            for _ in range(int(count)):
                self._one_shot[direction].append(
                    {"kind": kind, "keep_frac": float(keep_frac),
                     "cut": cut}
                )

    def take_one_shot(self, direction: str) -> Optional[dict]:
        with self._lock:
            self.frames[direction] += 1
            if self._one_shot[direction]:
                return self._one_shot[direction].pop(0)
        return None

    def arm_half_open(self, count: int) -> None:
        with self._lock:
            self._half_open += int(count)

    def take_half_open(self) -> bool:
        with self._lock:
            if self._half_open > 0:
                self._half_open -= 1
                return True
        return False


class ChaosProxy(LineServer):
    """The fault-injecting TCP relay in front of one backend.

    ``LineServer`` provides the accept loop, connection tracking and
    the shutdown-first stop discipline; :meth:`handle_connection` is
    overridden to bridge instead of respond.  One proxy = one link
    (one shard's front door); a mesh is a dict of them
    (``nemesis/runner.py``).
    """

    def __init__(
        self,
        backend_host: str,
        backend_port: int,
        *,
        host: str = "127.0.0.1",
        name: str = "nemesis-proxy",
        seed: int = 0,
        connect_timeout: float = 5.0,
        registry=None,
    ):
        # registry=False on the base: the relay must not double-count
        # the link's bytes into the server-role wire ledger (the real
        # backend already counts them)
        super().__init__(host, 0, name=name, registry=False)
        self.backend_host = backend_host
        self.backend_port = int(backend_port)
        self.seed = int(seed)
        self.connect_timeout = float(connect_timeout)
        self.engine = _FaultEngine(seed)
        self.faults: Dict[str, int] = {}
        self._faults_lock = threading.Lock()
        self._upstreams: List[socket.socket] = []
        self._up_lock = threading.Lock()
        self._heal_timers: List[threading.Timer] = []
        self._registry = registry
        self._fault_counters: Dict[str, object] = {}
        # shm hellos refused at the splice point (_relay_frame): each
        # one is a client downgraded to binary TCP through this link
        self.shm_downgrades = 0

    # -- fault accounting --------------------------------------------------
    def _count_fault(self, kind: str, n: int = 1) -> None:
        with self._faults_lock:
            self.faults[kind] = self.faults.get(kind, 0) + n
        if self._registry is False:
            return
        try:
            c = self._fault_counters.get(kind)
            if c is None:
                from ..telemetry.registry import get_registry

                reg = (
                    self._registry if self._registry is not None
                    else get_registry()
                )
                c = reg.counter(
                    "nemesis_faults_injected_total", component="nemesis",
                    kind=kind,
                )
                self._fault_counters[kind] = c
            c.inc(n)
        except Exception:  # accounting must never fail the relay
            self._registry = False

    # -- the imperative fault surface (scenario ops call these) ------------
    def partition(
        self, mode: str = "both", *, duration_s: Optional[float] = None
    ) -> None:
        """Hold bytes in the given direction(s) until :meth:`heal` (or
        after ``duration_s``, self-healing — the op thread is free to
        run cluster operations INSIDE the partition window)."""
        self.engine.hold(mode)
        self._count_fault(f"partition_{mode}")
        if duration_s is not None:
            t = threading.Timer(float(duration_s), self.heal)
            t.daemon = True
            self._heal_timers.append(t)
            t.start()

    def heal(self) -> None:
        self.engine.release_all()

    def set_delay(
        self, ms: float, jitter_ms: float = 0.0, mode: str = "both"
    ) -> None:
        self.engine.set_delay(ms, jitter_ms, mode)
        self._count_fault("delay")

    def clear_delay(self) -> None:
        self.engine.clear_delay()

    def set_drip(self, bytes_per_sec: float, mode: str = "both") -> None:
        self.engine.set_drip(bytes_per_sec, mode)
        self._count_fault("drip")

    def clear_drip(self) -> None:
        self.engine.clear_drip()

    def inject_once(
        self, kind: str, direction: str = "s2c", *,
        keep_frac: float = 0.35, count: int = 1, cut: str = "frame",
    ) -> None:
        self.engine.inject_once(
            kind, direction, keep_frac=keep_frac, count=count, cut=cut
        )

    def half_open(self, count: int = 1) -> None:
        self.engine.arm_half_open(count)

    # -- lifecycle ---------------------------------------------------------
    def stop(self) -> None:
        for t in self._heal_timers:
            t.cancel()
        self._heal_timers = []
        self.engine.release_all()  # unblock pumps held at a partition
        with self._up_lock:
            ups = list(self._upstreams)
            self._upstreams = []
        for s in ups:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        super().stop()

    # -- the relay ---------------------------------------------------------
    def handle_connection(self, conn: socket.socket) -> None:
        if self.engine.take_half_open():
            self._count_fault("half_open")
            # accepted but never bridged: swallow requests, answer
            # nothing — the client's read deadline is its only way out
            conn.settimeout(0.1)
            while not self._stop.is_set():
                try:
                    if not conn.recv(1 << 12):
                        return
                except socket.timeout:
                    continue
                except OSError:
                    return
            return
        try:
            up = socket.create_connection(
                (self.backend_host, self.backend_port),
                timeout=self.connect_timeout,
            )
        except OSError:
            return  # backend down: client sees the dead link
        try:
            up.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        with self._up_lock:
            self._upstreams.append(up)
        t = threading.Thread(
            target=self._pump_safe, args=(up, conn, "s2c"),
            name=f"{self.name}-s2c", daemon=True,
        )
        with self._conns_lock:
            self._handlers.append(t)  # joined by LineServer.stop()
        t.start()
        try:
            self._pump(conn, up, "c2s")
        finally:
            for s in (up, conn):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            try:
                up.close()
            except OSError:
                pass
            with self._up_lock:
                if up in self._upstreams:
                    self._upstreams.remove(up)
            t.join(timeout=5)

    def _pump_safe(self, src, dst, direction: str) -> None:
        try:
            self._pump(src, dst, direction)
        except OSError:
            pass

    @staticmethod
    def _split_frames(buf: bytes):
        """``(complete_frames, tail)`` — the link-level frame grammar
        both protocols share: a chunk opening with the binary magic is
        a length-prefixed frame (utils/frames.py; held until all its
        bytes arrive — binary frames have no newline to wait for, and
        may legitimately CONTAIN 0x0A bytes), anything else is a
        newline line.  Byte-for-byte preserving in order, so every
        fault class composes over either framing."""
        frames: List[bytes] = []
        while True:
            if binframes.peek_is_binary(buf):
                total = binframes.frame_length(buf)
                if total is None or len(buf) < total:
                    return frames, buf
                frames.append(buf[:total])
                buf = buf[total:]
            else:
                i = buf.find(b"\n")
                if i < 0:
                    return frames, buf
                frames.append(buf[: i + 1])
                buf = buf[i + 1:]

    def _pump(self, src, dst, direction: str) -> None:
        """Relay ``src → dst``, one complete frame at a time — newline
        lines or length-prefixed binary frames (partial tails are held
        until complete, so frame faults see whole frames; the tail is
        flushed raw on EOF)."""
        eng = self.engine
        buf = b""
        ctx: dict = {}
        try:
            while not self._stop.is_set():
                eng.wait_clear(direction, self._stop)
                if self._stop.is_set():
                    return
                try:
                    data = src.recv(1 << 16)
                except socket.timeout:
                    continue
                except OSError:
                    return
                if not data:
                    # peer half-closed: flush any partial tail, then
                    # propagate the FIN so the other side sees EOF too
                    if buf:
                        self._send(dst, buf, direction)
                    try:
                        dst.shutdown(socket.SHUT_WR)
                    except OSError:
                        pass
                    return
                buf += data
                frames, buf = self._split_frames(buf)
                for f in frames:
                    self._relay_frame(f, direction, ctx, src, dst)
        except _Aborted:
            return
        finally:
            stash = ctx.pop("stash", None)
            if stash is not None:
                # a reorder armed on the link's last frame: never drop
                # bytes on a clean path — flush the held frame
                try:
                    self._send(dst, stash, direction)
                except OSError:
                    pass

    def _relay_frame(
        self, frame: bytes, direction: str, ctx: dict, src, dst
    ) -> None:
        if (
            direction == "c2s"
            and not binframes.peek_is_binary(frame)
            and frame[:9].lower() == b"hello shm"
        ):
            # the shm splice point (docs/resilience.md): shared-memory
            # segments cannot be routed through a TCP relay, so a
            # proxied link REFUSES the shm hello here — the client's
            # standard downgrade path renegotiates binary on this same
            # connection and every fault class below then applies to
            # all of its traffic.  Letting the hello through would
            # negotiate a side channel the proxy never sees.
            self.shm_downgrades += 1
            try:
                src.sendall(
                    b"err bad-request: shm not routable through a "
                    b"proxied link\n"
                )
            except OSError:
                pass
            return
        eng = self.engine
        shot = eng.take_one_shot(direction)
        if shot is not None:
            kind = shot["kind"]
            if kind == "dup":
                self._count_fault("dup")
                self._send(dst, frame, direction)
                self._send(dst, frame, direction)
                return
            if kind == "reorder":
                self._count_fault("reorder")
                ctx["stash"] = frame
                return
            if kind == "truncate_rst":
                # cut strictly mid-frame (never 0, never the full
                # frame incl. newline), then abort both legs: the
                # peer sees a torn payload and a reset, exactly the
                # mid-b64 death the dedupe ledger must survive.  For
                # BINARY frames, cut="header"/"payload" aims the tear
                # inside the 24-byte fixed header or past it — the two
                # torn-read shapes a length-prefixed reader must
                # survive (mid-header: the length never arrives;
                # mid-payload: the length promised more than EOF
                # delivered).
                cut = shot.get("cut", "frame")
                is_bin = binframes.peek_is_binary(frame)
                hdr = binframes.HEADER_SIZE
                if is_bin and cut == "header" and len(frame) > 2:
                    hi = min(hdr, len(frame)) - 1
                    keep = max(1, min(hi, int(hdr * shot["keep_frac"])))
                elif is_bin and cut == "payload" and len(frame) > hdr + 1:
                    body = len(frame) - hdr
                    keep = hdr + max(
                        1, min(body - 1, int(body * shot["keep_frac"]))
                    )
                else:
                    keep = max(
                        1, int((len(frame) - 1) * shot["keep_frac"])
                    )
                self._count_fault("truncate_rst")
                try:
                    dst.sendall(frame[:keep])
                except OSError:
                    pass
                self._abort(src, dst)
                raise _Aborted()
        d = eng.delay_s(direction)
        if d > 0:
            self._count_fault("delay_frame")
            time.sleep(d)
        stash = ctx.pop("stash", None)
        self._send(dst, frame, direction)
        if stash is not None:
            self._send(dst, stash, direction)

    def _send(self, dst, payload: bytes, direction: str) -> None:
        eng = self.engine
        eng.wait_clear(direction, self._stop)
        if self._stop.is_set():
            raise _Aborted()
        rate = eng.drip_rate(direction)
        if rate is None:
            dst.sendall(payload)
            return
        self._count_fault("drip_frame")
        slice_bytes = 1 << 10
        for i in range(0, len(payload), slice_bytes):
            chunk = payload[i: i + slice_bytes]
            dst.sendall(chunk)
            time.sleep(len(chunk) / rate)
            if self._stop.is_set():
                raise _Aborted()

    @staticmethod
    def _abort(*socks) -> None:
        for s in socks:
            try:
                s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, _LINGER_RST)
            except OSError:
                pass
            try:
                # SHUT_RD first: a sibling pump blocked in recv() on
                # this fd holds a kernel reference, and close() alone
                # would DEFER the linger-0 RST until that recv returns
                # — i.e. forever (the peer would see a silent stall,
                # not a reset).  SHUT_RD wakes the reader without
                # sending a FIN, so the close below really aborts.
                s.shutdown(socket.SHUT_RD)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass


class ProxiedServer:
    """A ShardServer façade advertising its proxy's address.

    The elastic drivers publish shard addresses by reading
    ``(srv.host, srv.port)`` off whatever ``_build_shard`` returned —
    wrapping the server here is therefore the ONE splice that routes
    every consumer (worker clients, migration data plane, replication
    heartbeats, psctl) through the mesh.  Lifecycle calls fan out to
    both halves: ``stop()`` takes the proxy down WITH the server, so
    ``kill_shard`` kills the whole front door.  Everything else
    delegates to the real server.
    """

    def __init__(self, server, proxy: ChaosProxy):
        self._server = server
        self.proxy = proxy

    @property
    def host(self) -> str:
        return self.proxy.host

    @property
    def port(self) -> int:
        return self.proxy.port

    @property
    def running(self) -> bool:
        return self._server.running

    def stop(self) -> None:
        self.proxy.stop()
        self._server.stop()

    def __getattr__(self, name):
        return getattr(self._server, name)


__all__ = ["ChaosProxy", "ProxiedServer", "DIRECTIONS"]
