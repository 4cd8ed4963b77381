"""ClusterClient — the worker side of the multi-shard runtime.

A copy of ``flink_parameter_server_tpu/cluster/client.py``, which imports
no JAX: the port imports nothing of the JAX package, whose ``__init__``
imports JAX.  Modules it names that the port does not have yet are the
reference's.  Ported: the static client (a fixed list of shard addresses
under one partitioner), the elastic one (``membership`` routing with its
refresh-and-retry loop, the ``pid`` exactly-once token and ``hedge`` pull
races), replica-chain reads (``replicas=`` / ``read_replicas=`` and the
view's replica sets, with the fallback to the primary) and the hot-key
lease cache (``hotcache=``, ``lease_policy=``, ``lease_ttl=``; host numpy
rows, as the wire's are) and the adaptive runtime's push hedging
(``push_hedge=``, an ``adaptive/hedge.PushHedger``: a push races a
budgeted backup only when it carries a ``pid``, so the shard's exactly-once
window absorbs the losing leg) and the soak harness's ``retry_budget``
(a ``loadgen/overload.RetryBudget``).  ``wire_proto="shm"`` dials co-located shards
over a shared-memory ring pair (``shmem/channel.ShmShardConnection``).

Implements the :class:`~..core.api.ParameterServerClient` ABC against
real shard sockets, plus the batch surface the compiled path uses.
Three bandwidth levers from the reference's sender stack
(SURVEY.md §2 #6), rebuilt for the wire:

  * **request coalescing** — duplicate ids inside one microbatch
    collapse to one pull per id (:func:`~..ops.dedup.coalesce_ids`);
    a Zipf-hot item appearing 300× per batch costs one line, and the
    answer scatters back to every lane via the inverse map;
  * **delta aggregation** — duplicate-id push deltas are summed before
    the bytes move (:func:`~..ops.dedup.aggregate_deltas`) — exactly
    the store's intra-batch combine semantics, applied at the sender;
  * **pipelined pulls with an in-flight window** — each shard
    connection carries up to ``window`` outstanding request frames
    (responses come back in order, the line-protocol contract), so the
    client overlaps shard round trips instead of paying RTT per chunk.
    The live window usage is the ``inflight_pulls`` gauge
    (``component=cluster``) — the same observability the event API's
    pull limiter got (:func:`~..core.api.add_pull_limiter`).

Shards are contacted concurrently (persistent fan-out pool workers —
:class:`_FanoutPool`; nothing is spawned per batch): a pull's wall
time is the SLOWEST shard's round trip, not the sum.

Binary framing (``wire_proto="auto"``, the default — docs/cluster.md
"Binary framing"): each connection opens with the ``hello bin v=1``
handshake; against a binary-capable server the data plane then moves
raw ``<i8`` ids and raw fp32 (or opt-in bf16, ``wire_format="bf16"``)
rows in length-prefixed frames — no base64, no ``repr()`` — while an
old server's ``err bad-request`` leaves that connection on the line
protocol (``wire_proto="line"`` never negotiates: the compat
baseline).  ``pr=`` priority, ``sess=`` lease sessions, ``t=`` trace
tokens and ``inv=`` piggybacks ride the frames (header fields +
TLVs).  ``spawn_grace_s`` bounds a dial-retry window for REFUSED
connects — a just-spawned shard process (cluster/procs.py) racing its
own bind is liveness, not a failure.

Overload control (loadgen/overload.py, docs/loadgen.md): an attached
``retry_budget`` (token bucket) is spent one token per storm-class replay
round (a connection failure or an open breaker; epoch-flip replays spend
nothing) and refilled by successes — exhausted, the batch FAILS FAST with
``RetryBudgetExhausted`` instead of feeding a retry storm.  A
``breakers`` board keys one circuit breaker per shard: enough
transport/shed failures inside the window OPEN the circuit and this
client's frames to that shard fail fast with no wire traffic until a
half-open probe succeeds.  A shard's ``err overloaded`` shed answer
raises the typed ``OverloadedError`` immediately — shed traffic is
badput to count, never a replay.  ``priority=`` tags every frame
``pr=<n>`` so the shard edge sheds serving reads before training
pushes.

Replica-chain read routing (replication/, docs/elastic.md): when the
membership view carries ``replicas`` (or a static ``replicas=`` is
passed), pulls round-robin across ``[primary] + followers`` per shard.
A follower that declines (``err lagging`` past its staleness bound,
``err not-primary`` after a promotion) or cannot be reached FALLS BACK
to the primary — counted in ``replication_follower_fallbacks_total``,
never surfaced as an error.  Writes always go to the primary.  With a
hedger attached, a replica read that stalls races its budgeted backup
against the primary.

Pull RTT lands in a ``cluster_pull_rtt_seconds`` histogram per client
(p99 is the benchmark's tail-latency column).

Elastic routing (the reference's docs/elastic.md): handed a
``membership`` view (:class:`~..elastic.membership.MembershipService`),
the client derives its partitioner + shard addresses from the CURRENT
epoch, tags every pull/push frame with ``e=<epoch>``, and turns shard
rejections into retries instead of errors:

  * ``err stale-epoch`` — the map flipped under the frame: refresh the
    membership view (counted in ``elastic_epoch_refreshes_total``),
    re-route the frame's ids under the new map, replay;
  * ``err frozen`` — the frame touches a key range mid-migration:
    back off a few ms and replay (the flip that re-homes the range is
    imminent);
  * connection errors — a shard died or was replaced: drop the cached
    connection, refresh (the controller publishes the replacement's
    address under a new epoch), replay.  Pushes carry a per-batch
    ``pid`` token so a replay of a frame whose ack was lost is
    deduplicated shard-side — latency, never a double-apply.

A client without ``membership`` behaves exactly as before: static
addresses, no epoch tags, rejections raise.  ``hedge=`` accepts a
:class:`~..elastic.hedging.Hedger`: pull frames race a budgeted backup
connection against a slow shard — first answer wins (pulls are
idempotent; pushes race only through ``push_hedge=``, and only when they
carry a ``pid``).  Retry volume is visible on /metrics as ``client_retries_total{verb,reason}``.

Hot-key lease cache (``hotcache=``, docs/hotcache.md): with a
:class:`~..hotcache.cache.HotRowCache` and a lease policy attached,
every ``pull_batch`` is one cache **tick**; rows the cache holds
within its staleness bound are served locally (zero wire), cold
misses take the normal pull path (hedged, replica-routed), and HOT
misses are read via the ``lease`` verb — an atomic read + grant that
makes the shard queue piggybacked ``inv=`` invalidations when any
other writer touches the key.  The client strips ``inv=`` tokens from
every response, invalidates its own pushed ids at push time, clears
the cache on a membership refresh, and best-effort ``revoke``\\ s its
session at close.  Leases always route to the PRIMARY and are never
hedged (the grant is a side effect; a race could double-grant
harmlessly but would waste budget).  Against a pre-hotcache server the
first ``err bad-request`` flips the client to plain pulls for good —
the protocol-versioning downgrade path.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.api import ParameterServerClient
from ..loadgen.overload import OverloadedError, RetryBudgetExhausted
from ..ops.dedup import aggregate_deltas, coalesce_ids
from ..telemetry.distributed import TraceContext, new_trace
from ..telemetry.profiler import NULL_PROFILER, resolve_profiler
from ..telemetry.spans import gen_id
from ..utils import frames as binf
from ..utils.net import (
    PeerHalfClosed,
    _safe_verb,
    client_meter,
    count_half_closed,
)
from .partition import Partitioner
from .shard import format_rows, parse_rows

_NULL_CM = contextlib.nullcontext()
# the stale-epoch storm the flight recorder is told about: 25 replay
# rounds inside 5 s
_STORM_RETRIES, _STORM_WINDOW_S = 25, 5.0


class ShardConnection:
    """One pipelined connection to one shard — line protocol, binary
    frames (utils/frames.py), or both mixed.

    ``request_many`` keeps up to ``window`` requests outstanding; the
    shard answers in order, so responses re-associate positionally.
    Each request is self-describing: a ``str`` goes out as a text line
    (answered by a text line), ``bytes`` as a binary frame (answered
    by a binary frame decoded into a :class:`~..utils.frames.Frame`) —
    which is what lets the data plane go binary while control verbs
    (``stats``/``flush``) stay greppable text on the SAME connection.

    ``negotiate=True`` sends the ``hello bin v=1`` handshake at dial
    time; :attr:`proto` is then ``"bin"`` against a binary-capable
    server and ``"line"`` against an old one (which answered ``err
    bad-request`` — the downgrade path, docs/cluster.md).  Callers
    must not send binary frames on a ``"line"`` connection.

    Not thread-safe — each worker owns its connections (the driver
    builds one client per worker).
    """

    def __init__(
        self,
        host: str,
        port: int,
        *,
        window: int = 8,
        timeout: float = 30.0,
        connect_timeout: Optional[float] = None,
        negotiate: bool = False,
    ):
        # dial and read deadlines are separate levers (failover-grade
        # failure detection needs a tight dial even when reads may
        # legitimately wait); None inherits the read timeout, capped
        # at the old 10 s dial default
        if connect_timeout is None:
            connect_timeout = min(float(timeout), 10.0)
        if window < 1:
            raise ValueError(f"window={window}: must be >= 1")
        self.host, self.port = host, port
        self.window = int(window)
        self._sock = socket.create_connection(
            (host, port), timeout=connect_timeout
        )
        self._sock.settimeout(timeout)
        try:
            # pipelined request frames must leave NOW, not after Nagle
            # pairs them with a delayed ACK (~40 ms/frame otherwise)
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self._rfile = self._sock.makefile("rb")
        self.inflight = 0
        self.requests_sent = 0
        self.proto = "line"
        # quantized encodings the peer advertised on its hello answer
        # (frames.hello_encs): empty until negotiated; a bin server
        # without the enc= token is assumed bf16-only (PR-13 era) and
        # q8 frames downgrade to exact f32 on this connection
        self.encs: frozenset = frozenset()
        # client-role wire ledger (utils/net.py): bytes/frames per
        # verb, each direction — the other endpoint of the shard
        # servers' accounting
        self._meter = client_meter()
        if negotiate:
            self._negotiate()

    def _negotiate(self) -> None:
        """The per-connection binary handshake: one text round trip at
        dial time.  ``ok proto=bin`` upgrades; anything else (an old
        server's ``err bad-request``) leaves the connection on the
        line protocol — never an error."""
        resp = self.request_many([binf.HELLO_LINE])[0]
        if isinstance(resp, str) and resp.startswith("ok proto=bin"):
            self.proto = "bin"
            self.encs = binf.hello_encs(resp)

    def _read_exact(self, n: int, what: str) -> bytes:
        """Exactly ``n`` bytes off the buffered reader, or
        :class:`PeerHalfClosed` — a short read at EOF is the binary
        twin of the torn line frame (the peer died mid-frame)."""
        data = self._rfile.read(n)
        if data is None:
            data = b""
        if len(data) != n:
            count_half_closed("client")
            raise PeerHalfClosed(
                f"shard {self.host}:{self.port} closed mid-{what} "
                f"({len(data)}/{n} bytes)"
            )
        return data

    def _read_bin_response(self):
        hdr = self._read_exact(binf.HEADER_SIZE, "frame header")
        total = binf.frame_length(hdr)
        body = self._read_exact(total - binf.HEADER_SIZE, "frame body")
        # decode_split keeps header and body separate — joining them
        # would copy the whole row payload just to view into it
        frame = binf.decode_split(hdr, body, kind="response")
        self._meter.count("in", frame.verb_name, total)
        return frame

    def request_many(self, lines: Sequence) -> List:
        """Pipelined request/response: send up to ``window`` requests
        ahead of the reads, return one response per request —
        positionally, ``str`` for text lines, decoded
        :class:`~..utils.frames.Frame` for binary frames."""
        out: List = []
        pending = 0
        pending_meta: List[Tuple[str, str]] = []  # (framing, verb)
        it = iter(lines)
        sent = 0
        total = len(lines)
        while sent < total or pending:
            while pending < self.window and sent < total:
                req = next(it)
                if isinstance(req, (bytes, bytearray, memoryview)):
                    data = bytes(req)
                    verb = binf.peek_verb_name(data)
                    framing = "bin"
                else:
                    data = req.encode("utf-8") + b"\n"
                    verb = _safe_verb(req)
                    framing = "line"
                self._sock.sendall(data)
                self._meter.count("out", verb, len(data))
                pending_meta.append((framing, verb))
                pending += 1
                sent += 1
                self.inflight = pending
                self.requests_sent += 1
            framing, verb = pending_meta.pop(0)
            if framing == "bin":
                out.append(self._read_bin_response())
                pending -= 1
                self.inflight = pending
                continue
            raw = self._rfile.readline()
            if not raw or not raw.endswith(b"\n"):
                # empty read = peer half-close: the shard is GONE (died,
                # was replaced, RST mid-frame), not merely slow — a slow
                # shard surfaces as socket.timeout from the readline.
                # A NON-EMPTY read without its newline is the same event
                # one packet earlier: the peer died MID-FRAME and
                # readline returned the torn prefix at EOF — treating
                # that prefix as a response line would hand a truncated
                # payload to the parser (or worse, a truncated "ok ..."
                # to _check_ok).  Distinct type + counted, so the
                # operator can tell a dead peer from a slow one.
                count_half_closed("client")
                raise PeerHalfClosed(
                    f"shard {self.host}:{self.port} closed mid-pipeline "
                    f"({len(out)}/{total} responses"
                    + (", torn frame" if raw else "") + ")"
                )
            self._meter.count("in", verb, len(raw))
            out.append(raw.decode("utf-8", "replace").rstrip("\n"))
            pending -= 1
            self.inflight = pending
        return out

    def request(self, line: str) -> str:
        return self.request_many([line])[0]

    def close(self) -> None:
        try:
            # a reader blocked in readline() holds the buffer lock;
            # rfile.close() would wait on it — shutdown() first makes
            # the reader return EOF and release it
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._rfile.close()
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


def _frame_status(resp) -> Optional[int]:
    """The binary status code of a response, or None for text lines —
    the one switch every classifier below branches on, so each check
    reads identically over both framings."""
    return resp.flag if isinstance(resp, binf.Frame) else None


def _describe(resp) -> str:
    if isinstance(resp, binf.Frame):
        detail = resp.tlv_str(binf.T_ERR) or ""
        return f"err {resp.status_name}" + (f": {detail}" if detail else "")
    return resp


def _check_ok(resp, what: str):
    status = _frame_status(resp)
    if status is not None:
        if status != binf.STATUS_OK:
            raise RuntimeError(f"{what} failed: {_describe(resp)}")
        return resp
    if not resp.startswith("ok"):
        raise RuntimeError(f"{what} failed: {resp}")
    return resp


def _is_reject(resp) -> bool:
    """A shard answer the elastic client treats as retry-after-refresh
    rather than an error: the map flipped (stale-epoch) or the keys are
    mid-migration (frozen)."""
    status = _frame_status(resp)
    if status is not None:
        return status in (binf.STATUS_STALE_EPOCH, binf.STATUS_FROZEN)
    return resp.startswith("err stale-epoch") or resp.startswith(
        "err frozen"
    )


def _reject_reason(resp) -> str:
    status = _frame_status(resp)
    if status is not None:
        return (
            "frozen" if status == binf.STATUS_FROZEN else "stale-epoch"
        )
    return (
        "frozen" if resp.startswith("err frozen") else "stale-epoch"
    )


def _is_overloaded(resp) -> bool:
    """The shard's typed shed answer (loadgen/overload.py
    ``OverloadGuard``): the request was REJECTED under load pressure,
    deliberately and cheaply.  The client fails fast with
    :class:`~..loadgen.overload.OverloadedError` — retrying a shed
    would feed exactly the storm the shed exists to stop."""
    status = _frame_status(resp)
    if status is not None:
        return status == binf.STATUS_OVERLOADED
    return resp.startswith("err overloaded")


def _is_bad_request(resp) -> bool:
    status = _frame_status(resp)
    if status is not None:
        return status == binf.STATUS_BAD_REQUEST
    return resp.startswith("err bad-request")


def _is_follower_reject(resp) -> bool:
    """A replica-chain follower declining a read: lagging past the
    staleness bound, or no longer a follower at all.  The client falls
    back to the primary — NOT a membership refresh (the map is fine;
    this one replica is stale)."""
    status = _frame_status(resp)
    if status is not None:
        return status in (
            binf.STATUS_LAGGING, binf.STATUS_NOT_PRIMARY
        )
    return resp.startswith("err lagging") or resp.startswith(
        "err not-primary"
    )


class _Rejected(Exception):
    """Internal: carries the ids a shard rejected (stale-epoch/frozen)
    or could not be reached for, so the batch loop replays exactly
    those under a refreshed map.  ``reason`` labels the retry counter
    (stale-epoch | frozen | conn | breaker_open)."""

    def __init__(self, ids: np.ndarray, reason: str = "reject"):
        super().__init__(f"{len(ids)} ids rejected ({reason})")
        self.ids = ids
        self.reason = reason


class _LeaseUnsupported(Exception):
    """Internal: the shard answered a ``lease`` frame with
    ``err bad-request`` — a pre-hotcache server.  The client downgrades
    to plain pulls for the rest of its life (the versioning contract
    working in the other direction)."""


class _PoolWorker:
    """One persistent fan-out thread (see :class:`_FanoutPool`).
    Job hand-off state is guarded by ``_lock`` (the condition shares
    it)."""

    def __init__(self, name: str):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._job = None
        self._stopped = False
        self._thread = threading.Thread(
            target=self._loop, name=name, daemon=True
        )
        self._thread.start()

    def submit(self, fn, errors, errors_lock) -> threading.Event:
        done = threading.Event()
        with self._lock:
            self._job = (fn, errors, errors_lock, done)
            self._cond.notify()
        return done

    def _loop(self) -> None:
        while True:
            with self._lock:
                while self._job is None and not self._stopped:
                    self._cond.wait(0.2)
                if self._stopped:
                    return
                fn, errors, errors_lock, done = self._job
                self._job = None
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — re-raised by run()
                with errors_lock:
                    errors.append(e)
            finally:
                done.set()

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            self._cond.notify()
        self._thread.join(timeout=5)


class _FanoutPool:
    """Persistent threads for the client's per-shard fan-out.

    The batch surface used to SPAWN a fresh thread per contacted shard
    per ``pull_batch``/``push_batch`` call — ~100 µs of create/start
    per shard per round, paid thousands of times a second, plus a cold
    scheduler wakeup right on the latency path.  A client makes the
    same-shaped fan-out call every round of its life, so the threads
    are now long-lived: one fan-out runs ``len(jobs)-1`` jobs on pool
    workers and the LAST one inline on the calling thread (on a busy
    host that is one fewer handoff on the critical path).  Not
    thread-safe — owned by one client, which is itself single-caller
    by contract."""

    def __init__(self, name: str = "fps-fanout"):
        self._name = name
        self._workers: List[_PoolWorker] = []

    def run(self, jobs) -> None:
        if not jobs:
            return
        if len(jobs) == 1:
            jobs[0]()
            return
        errors: List[BaseException] = []
        lock = threading.Lock()
        while len(self._workers) < len(jobs) - 1:
            self._workers.append(_PoolWorker(
                f"{self._name}-{len(self._workers)}"
            ))
        waits = [
            w.submit(fn, errors, lock)
            for w, fn in zip(self._workers, jobs[:-1])
        ]
        try:
            jobs[-1]()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            with lock:
                errors.append(e)
        for done in waits:
            done.wait()
        if errors:
            raise errors[0]

    def close(self) -> None:
        """Join every worker — a closed client must leak no package
        threads."""
        for w in self._workers:
            w.stop()
        self._workers = []


class ClusterClient(ParameterServerClient):
    """Worker-side handle over every shard.

    Batch surface (the compiled path): :meth:`pull_batch` /
    :meth:`push_batch` — coalesced, pipelined, shard-parallel.
    Event surface (the ABC): :meth:`pull` buffers the id, :meth:`push`
    buffers the delta; :meth:`drain` flushes both coalesced and
    delivers pull answers to a callback — the combination-sender
    semantics per worker.
    """

    # replay-round backoff: decorrelated jitter between these bounds
    retry_sleep_s = 0.002
    retry_sleep_cap_s = 0.05

    def __init__(
        self,
        addresses: Optional[Sequence[Tuple[str, int]]] = None,
        partitioner: Optional[Partitioner] = None,
        value_shape: Sequence[int] = (),
        *,
        window: int = 8,
        chunk: int = 512,
        timeout: float = 30.0,
        connect_timeout: float = 5.0,
        wire_format: str = "b64",
        wire_proto: str = "auto",
        spawn_grace_s: float = 0.0,
        registry=None,
        worker: Optional[str] = None,
        membership=None,
        replicas=None,
        read_replicas: bool = True,
        hedge=None,
        push_hedge=None,
        hotcache=None,
        lease_policy=None,
        lease_ttl: int = 16,
        retry_timeout: float = 30.0,
        retry_budget=None,
        breakers=None,
        priority: Optional[int] = None,
        tracer=None,
        profiler=None,
    ):
        if membership is None:
            if addresses is None or partitioner is None:
                raise ValueError(
                    "static client needs addresses + partitioner "
                    "(or pass membership=)"
                )
            if len(addresses) != partitioner.num_shards:
                raise ValueError(
                    f"{len(addresses)} shard addresses for a "
                    f"{partitioner.num_shards}-shard partitioner"
                )
            self._epoch: Optional[int] = None
            self.partitioner = partitioner
            self._addresses = [tuple(a) for a in addresses]
            self._replicas = (
                [tuple(tuple(a) for a in r) for r in replicas]
                if replicas else []
            )
        else:
            view = membership.current()
            self._epoch = view.epoch
            self.partitioner = view.partitioner
            self._addresses = [tuple(a) for a in view.addresses]
            self._replicas = [tuple(r) for r in view.replicas]
        if chunk < 1:
            raise ValueError(f"chunk={chunk}: must be >= 1")
        if wire_format not in ("text", "b64", "bf16", "q8"):
            raise ValueError(
                f"wire_format={wire_format!r}: "
                f"'text' | 'b64' | 'bf16' | 'q8'"
            )
        if wire_proto not in ("auto", "line", "shm"):
            raise ValueError(
                f"wire_proto={wire_proto!r}: 'auto' | 'line' | 'shm'"
            )
        self.membership = membership
        self.hedge = hedge
        # write-side hedging is only safe when pushes carry a pid (the
        # (pid,id) dedupe window suppresses the losing leg's apply), so
        # _push_shard gates on pid presence, not just this handle
        self.push_hedge = push_hedge
        self.value_shape = tuple(int(s) for s in value_shape)
        self.chunk = int(chunk)
        # b64 (default): exact fp32 bytes, ~100x cheaper than per-float
        # text (shard.py module docstring); "text" for debuggability.
        # Over the binary framing, "text"/"b64" both become raw fp32
        # (exact); "bf16" halves row bytes (lossy, opt-in — falls back
        # to b64 on a line-proto connection, which has no bf16).
        self.wire_format = wire_format
        # "auto": negotiate binary framing per connection (one hello
        # round trip at dial time; an old server's err bad-request
        # downgrades that connection to the line protocol).  "line":
        # never negotiate — bit-for-bit the pre-binary client, the
        # compat baseline the cross-version tests pin.  "shm": attempt
        # the shared-memory hello against co-located shards (shmem/),
        # falling back per connection to binary TCP (then lines) for
        # non-local peers, old servers, or a proxied path — each
        # fallback counted in shmem_fallbacks_total.
        self._wire_proto = wire_proto
        # spawn grace (cluster/procs.py): a just-spawned shard process
        # may not have bound yet when its first dial arrives — retry
        # REFUSED dials inside this window instead of surfacing a
        # conn-class reject that burns retry budget
        self._spawn_grace_s = float(spawn_grace_s)
        self._window = int(window)
        self._timeout = float(timeout)
        self._connect_timeout = float(connect_timeout)
        # replica-chain read routing (replication/, docs/elastic.md):
        # pulls rotate across [primary] + followers; follower rejects
        # and connection errors fall back to the primary.  Writes
        # always go to the primary.
        self._read_replicas = bool(read_replicas)
        self._rr: Dict[int, int] = {}
        self.retry_timeout = float(retry_timeout)
        # overload control (loadgen/overload.py, docs/loadgen.md):
        # retry_budget = token bucket over replay rounds (exhausted →
        # RetryBudgetExhausted fails fast instead of feeding a retry
        # storm); breakers = per-shard circuit BreakerBoard (an open
        # shard's frames fail fast without touching the wire); priority
        # rides frames as pr=<n> so the shard-edge guard can shed
        # serving traffic before training pushes
        self.retry_budget = retry_budget
        self.breakers = breakers
        self._priority = None if priority is None else int(priority)
        # retry backoff state: decorrelated-jitter sleeps need the
        # previous draw, and each client needs its OWN stream — a herd
        # of workers replaying into a recovering shard must disperse,
        # not arrive in lockstep
        self._retry_rng = np.random.default_rng(
            (os.getpid() << 16) ^ (id(self) & 0xFFFF_FFFF)
            ^ (hash(worker) & 0xFFFF if worker is not None else 0)
        )
        self._last_retry_sleep: Optional[float] = None
        self._conns: Dict[Tuple[str, int], ShardConnection] = {}
        # persistent per-shard fan-out threads (no per-batch spawns)
        self._pool = _FanoutPool(
            f"fps-fanout-{worker}" if worker is not None else "fps-fanout"
        )
        self.outputs: List[object] = []
        self._pending_pulls: List[int] = []
        self._pending_pushes: List[Tuple[int, np.ndarray]] = []
        self.pulls_coalesced = 0  # duplicate lanes saved from the wire
        self.pushes_coalesced = 0
        self.rows_pushed = 0  # unique delta rows acked (the audit ledger)
        self.frames_retried = 0  # frames replayed after a reject/refresh
        # per-batch idempotence token base: unique per client instance
        self._pid_base = f"{os.getpid():x}.{id(self):x}"
        self._pid_counter = itertools.count()
        # hot-key lease cache (hotcache/, docs/hotcache.md): attached
        # here or later via attach_hotcache; None = no caching at all
        self.hotcache = None
        self.lease_policy = None
        self._lease_ttl = int(lease_ttl)
        self._lease_supported = True
        self._sess: Optional[str] = None
        self.leases_acquired = 0  # lease frames answered ok
        if hotcache is not None:
            self.attach_hotcache(
                hotcache, lease_policy, lease_ttl=lease_ttl
            )
        # distributed tracing (telemetry/distributed.py): with a tracer
        # attached, each pull/push batch becomes one trace, each shard
        # request a child span whose id rides the frame as t=<tr>:<sp>
        self._tracer = tracer
        # stale-epoch storms: retry rounds that keep failing to
        # converge on a servable map trip the flight recorder once
        if membership is not None:
            from ..telemetry.flightrec import StormDetector

            self._storm = StormDetector(_STORM_RETRIES, _STORM_WINDOW_S)
        else:
            self._storm = None
        # unified plane (component=cluster): the pull RTT histogram and
        # the live in-flight window gauge
        if registry is not False:
            from ..telemetry.registry import get_registry

            reg = registry if registry is not None else get_registry()
            labels = {"worker": worker} if worker is not None else {}
            # stash for the on-demand retry counters (_await_retry):
            # client_retries_total{verb,reason} label pairs are only
            # known at retry time
            self._reg = reg
            self._labels = dict(labels)
            self._h_rtt = reg.histogram(
                "cluster_pull_rtt_seconds", component="cluster", **labels
            )
            reg.gauge(
                "inflight_pulls", component="cluster", fn=self.inflight,
                **labels,
            )
            self._c_refresh = (
                reg.counter(
                    "elastic_epoch_refreshes_total", component="elastic",
                    **labels,
                )
                if membership is not None
                else None
            )
            self._c_storms = (
                reg.counter(
                    "elastic_stale_epoch_storms_total",
                    component="elastic", **labels,
                )
                if membership is not None
                else None
            )
            if membership is not None or replicas:
                self._c_replica_reads = reg.counter(
                    "replication_replica_reads_total",
                    component="replication", **labels,
                )
                self._c_fallbacks = reg.counter(
                    "replication_follower_fallbacks_total",
                    component="replication", **labels,
                )
            else:
                self._c_replica_reads = self._c_fallbacks = None
        else:
            self._reg = None
            self._labels = {}
            self._h_rtt = None
            self._c_refresh = None
            self._c_storms = None
            self._c_replica_reads = self._c_fallbacks = None
        # per-SHARD pull RTT (timeline plane, docs/observability.md):
        # the worker-labelled histogram above answers "is this worker
        # slow"; these lazily-registered per-shard twins answer "WHICH
        # shard is making it slow".  Lazy because the shard set is a
        # runtime variable under the elastic plane.
        self._h_shard_rtt: Dict[int, Any] = {}
        # latency-budget phases (telemetry/profiler.py): per-frame
        # client serialize / round trip / parse — the client side of
        # the budget.  registry=False implies profiling off too.
        self._profiler = (
            NULL_PROFILER if registry is False and profiler is None
            else resolve_profiler(profiler)
        )
        # quantized delta push path (compression/, docs/compression.md):
        # wire_format "q8"/"bf16" routes every push through an
        # error-feedback DeltaCompressor — the table ALWAYS receives
        # exactly the dequantized rows, over any framing (q8/bf16
        # frames on advertising peers, exact f32 on old ones), so
        # replays, re-routes and mixed fleets stay deterministic and
        # the exactly-once ledger balances.  BSP carve-out is the
        # DRIVER's job (bound-0 worker clients are built with "b64").
        self._compressor = None
        self._c_bytes_saved = None
        if wire_format in ("q8", "bf16"):
            from ..compression.quantizers import DeltaCompressor

            self._compressor = DeltaCompressor(wire_format)
            if self._reg is not None:
                self._c_bytes_saved = self._reg.counter(
                    "compression_bytes_saved_total",
                    component="compression", **self._labels,
                )
                self._reg.gauge(
                    "compression_residual_norm",
                    component="compression",
                    fn=self._compressor.residuals.norm, **self._labels,
                )

    # -- observability ------------------------------------------------------
    def inflight(self) -> int:
        """Outstanding pull/push frames across every shard connection —
        the live pipelining depth (<= window × shards)."""
        return sum(c.inflight for c in list(self._conns.values()))

    # -- hot-key lease cache (hotcache/, docs/hotcache.md) --------------------
    def attach_hotcache(
        self, cache, policy=None, *, lease_ttl: int = 16
    ) -> "ClusterClient":
        """Attach a :class:`~..hotcache.cache.HotRowCache` (+ lease
        policy deciding which keys are lease-worthy).  The BSP
        carve-out is the CALLER's job: a bound-0 worker client must
        never get a cache (``ClusterDriver`` enforces it — reads must
        see every previous-round write)."""
        self.hotcache = cache
        self.lease_policy = policy
        self._lease_ttl = int(lease_ttl)
        self._lease_supported = True
        # session token: what the shard keys this client's grants and
        # piggybacked invalidations on (unique per client instance)
        self._sess = f"c{self._pid_base}"
        return self

    def _apply_response_options(self, resp):
        """Apply piggybacked response options (``inv=`` invalidations)
        to the cache.  Text lines are stripped of their trailing
        tokens and returned bare; binary frames carry the same payload
        in a ``T_INV`` TLV and are returned as-is."""
        from ..hotcache.leases import parse_inv_token, split_response_options

        if isinstance(resp, binf.Frame):
            inv = resp.tlv_str(binf.T_INV)
            if inv is not None and self.hotcache is not None:
                self.hotcache.invalidate(parse_inv_token(inv))
            return resp
        body, opts = split_response_options(resp)
        inv = opts.get("inv")
        if inv is not None and self.hotcache is not None:
            self.hotcache.invalidate(parse_inv_token(inv))
        return body

    # -- connections / membership -------------------------------------------
    def _dial(self, addr: Tuple[str, int]) -> ShardConnection:
        """Dial one shard (negotiating the binary framing when
        ``wire_proto="auto"``, the shared-memory rings first when
        ``"shm"``).  A REFUSED dial inside the spawn grace
        window is retried with short sleeps: a shard process that was
        just spawned races its own ``bind`` against the first dial,
        and that race is liveness, not a failure."""
        deadline = (
            time.monotonic() + self._spawn_grace_s
            if self._spawn_grace_s > 0 else None
        )
        use_shm = False
        if self._wire_proto == "shm":
            # shared memory only reaches co-located peers; a remote
            # address is a not-local fallback before any segment exists
            from ..shmem.channel import shm_usable

            use_shm = shm_usable(addr[0])
            if not use_shm:
                from ..shmem.metrics import count_fallback

                count_fallback(
                    "not-local",
                    registry=self._reg if self._reg is not None else False,
                )
        while True:
            try:
                if use_shm:
                    from ..shmem.channel import ShmShardConnection

                    return ShmShardConnection(
                        addr[0], addr[1], window=self._window,
                        timeout=self._timeout,
                        connect_timeout=self._connect_timeout,
                        registry=(
                            self._reg if self._reg is not None else False
                        ),
                    )
                return ShardConnection(
                    addr[0], addr[1], window=self._window,
                    timeout=self._timeout,
                    connect_timeout=self._connect_timeout,
                    negotiate=self._wire_proto in ("auto", "shm"),
                )
            except ConnectionRefusedError:
                if deadline is None or time.monotonic() >= deadline:
                    raise
                time.sleep(0.02)

    def _conn_for_addr(self, addr: Tuple[str, int]) -> ShardConnection:
        conn = self._conns.get(addr)
        if conn is None:
            conn = self._dial(addr)
            self._conns[addr] = conn
        return conn

    def _conn_for(self, shard: int) -> ShardConnection:
        return self._conn_for_addr(self._addresses[shard])

    def _drop_addr(self, addr: Tuple[str, int]) -> None:
        conn = self._conns.pop(addr, None)
        if conn is not None:
            conn.close()

    def _drop_conn(self, shard: int) -> None:
        self._drop_addr(self._addresses[shard])

    def _refresh_membership(self) -> bool:
        """Re-read the membership view; adopt a newer epoch's map +
        addresses + replica sets (closing connections to addresses
        that left).  Returns True when a new epoch was adopted."""
        if self.membership is None:
            return False
        view = self.membership.current()
        if view.epoch == self._epoch:
            return False
        self._epoch = view.epoch
        self.partitioner = view.partitioner
        new_addrs = [tuple(a) for a in view.addresses]
        new_replicas = [tuple(r) for r in view.replicas]
        keep = set(new_addrs)
        for reps in new_replicas:
            keep.update(reps)
        for addr in list(self._conns):
            if addr not in keep:
                self._conns.pop(addr).close()
        self._addresses = new_addrs
        self._replicas = new_replicas
        if self.hotcache is not None:
            # a resharding may have re-homed any cached key: drop
            # everything (the shards queued inv=* too — this is the
            # client-side half of the same conservatism)
            self.hotcache.clear()
        if self._c_refresh is not None:
            self._c_refresh.inc()
        return True

    # -- replica-chain read routing ------------------------------------------
    def _read_target(self, shard: int) -> Tuple[Tuple[str, int], bool]:
        """Where the next read for ``shard`` goes: round-robin across
        the primary + its followers (``(addr, is_replica)``)."""
        primary = self._addresses[shard]
        reps = (
            self._replicas[shard]
            if self._read_replicas and shard < len(self._replicas)
            else ()
        )
        if not reps:
            return primary, False
        targets = [primary] + list(reps)
        i = self._rr.get(shard, 0)
        self._rr[shard] = i + 1
        addr = targets[i % len(targets)]
        return addr, addr != primary

    def _next_retry_sleep(self, attempt: int) -> float:
        """The next replay-round sleep: capped exponential with
        DECORRELATED jitter — ``uniform(base, min(cap, 3 × previous))``
        with the exponential ceiling as a floor on the range, capped at
        ``retry_sleep_cap_s``.  Per-client seeded draws decorrelate a herd
        of workers replaying into a recovering shard."""
        base, cap = self.retry_sleep_s, self.retry_sleep_cap_s
        ceiling = min(cap, base * (2 ** min(attempt, 16)))
        prev = self._last_retry_sleep if self._last_retry_sleep else base
        hi = min(cap, max(prev * 3.0, ceiling))
        sleep = float(self._retry_rng.uniform(base, max(base, hi)))
        sleep = min(cap, sleep)
        self._last_retry_sleep = sleep
        return sleep

    def _await_retry(
        self, deadline: float, attempt: int, what: str,
        reason: str = "reject",
    ) -> None:
        """Between replay rounds: refresh the view; if nothing changed,
        sleep briefly (the flip/replacement is in flight) — bounded by
        ``retry_timeout`` so a wedged cluster still surfaces.  Each
        round is counted (``client_retries_total{verb,reason}``) and
        spends one retry-budget token when a budget is attached; an
        exhausted budget FAILS FAST instead of feeding the storm."""
        if self.membership is None:
            raise RuntimeError(
                f"{what}: shard rejected the frame and no membership "
                f"view is attached (static client cannot re-route)"
            )
        if self._reg is not None:
            self._reg.counter(
                "client_retries_total", component="cluster",
                verb=what, reason=reason, **self._labels,
            ).inc()
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"{what}: retried past retry_timeout="
                f"{self.retry_timeout}s without converging on a "
                f"servable map"
            )
        # only STORM-CLASS retries spend budget: connection failures
        # and open breakers are the signals that amplify under
        # overload.  Epoch-flip replays (stale-epoch/frozen) are the
        # elastic control plane working as designed — rate-limiting
        # those would turn every resize into artificial sheds.
        if (
            self.retry_budget is not None
            and reason in ("conn", "breaker_open")
            and not self.retry_budget.try_spend()
        ):
            raise RetryBudgetExhausted(
                f"{what}: retry budget exhausted after {attempt} "
                f"replay rounds (reason: {reason}) — failing fast"
            )
        if self._storm is not None and self._storm.note():
            # many reject-driven retries inside the window: the flip is
            # NOT converging — blackbox it before a timeout loses the
            # evidence (one dump per storm, throttled recorder-side)
            if self._c_storms is not None:
                self._c_storms.inc()
            from ..telemetry.flightrec import get_recorder

            rec = get_recorder()
            if rec is not None:
                rec.note(
                    "stale_epoch_storm", epoch=self._epoch, what=what,
                    retries=self.frames_retried,
                )
                rec.dump("stale_epoch_storm")
        if not self._refresh_membership():
            time.sleep(self._next_retry_sleep(attempt))

    # -- the batch surface --------------------------------------------------
    def _trace_root(self, name: str):
        """``(ctx, span_cm)`` opening one distributed trace per logical
        batch call — ``(None, nullcontext)`` when tracing is off."""
        tr = self._tracer
        if tr is None or not tr.enabled:
            return None, _NULL_CM
        ctx = new_trace()
        return ctx, tr.span(
            name, "cluster", trace_id=ctx.trace_id, span_id=ctx.span_id
        )

    def pull_batch(
        self, ids, mask=None, *, dtype=np.float32
    ) -> np.ndarray:
        """Pull values for ``ids`` (any shape); returns
        ``ids.shape + value_shape`` float32.  Duplicate ids cost one
        wire request; per-shard traffic runs concurrently; rejected
        shards replay under a refreshed map (elastic mode)."""
        ids_arr = np.asarray(ids)
        unique, inverse = coalesce_ids(ids_arr, mask)
        self.pulls_coalesced += int(ids_arr.size - unique.size)
        width = int(np.prod(self.value_shape)) if self.value_shape else 1
        flat = np.empty((unique.size, width), dtype)
        todo = unique
        cache = self.hotcache
        if cache is not None:
            # one pull_batch = one cache tick (a worker round / a
            # serving request); entries within the staleness bound are
            # served with zero wire, the rest fall through below
            cache.tick()
            hits = cache.lookup(unique)
            if hits:
                hit_ids = np.fromiter(hits.keys(), np.int64, len(hits))
                hit_ids.sort()
                flat[np.searchsorted(unique, hit_ids)] = np.stack(
                    [hits[int(g)] for g in hit_ids]
                ).reshape(len(hit_ids), width).astype(dtype)
                todo = np.setdiff1d(unique, hit_ids, assume_unique=True)
        deadline = time.monotonic() + self.retry_timeout
        attempt = 0
        self._last_retry_sleep = None  # fresh backoff ladder per batch
        ctx, root_span = self._trace_root("pull_batch")
        with root_span:
            while todo.size:
                rejected: List[np.ndarray] = []
                reasons: List[str] = []
                rej_lock = threading.Lock()

                def do(s, sids):
                    try:
                        rows = self._pull_shard(s, sids, ctx)
                    except _Rejected as r:
                        with rej_lock:
                            rejected.append(r.ids)
                            reasons.append(r.reason)
                        return
                    flat[np.searchsorted(unique, sids)] = rows.reshape(
                        len(sids), width
                    )

                self._for_each_shard(self._split(todo), do)
                todo = (
                    np.concatenate(rejected) if rejected
                    else np.empty(0, np.int64)
                )
                if todo.size:
                    attempt += 1
                    self.frames_retried += 1
                    self._await_retry(
                        deadline, attempt, "pull", reason=reasons[0]
                    )
        out = flat.reshape(unique.shape + self.value_shape)
        if self.retry_budget is not None:
            self.retry_budget.on_success()
        return out[inverse]

    def push_batch(self, ids, deltas, mask=None) -> int:
        """Aggregate duplicate-id deltas, push each shard's share (in
        parallel, pipelined); returns unique ids pushed.  Under a
        membership view every frame carries this batch's ``pid`` token,
        so replays after a lost ack stay exactly-once shard-side."""
        ids_arr = np.asarray(ids)
        unique, summed = aggregate_deltas(ids_arr, np.asarray(deltas), mask)
        if unique.size == 0:
            return 0
        self.pushes_coalesced += int(
            (ids_arr.size if mask is None else int(np.asarray(mask).sum()))
            - unique.size
        )
        if self.hotcache is not None:
            # write-through invalidate: the client's own cached copies
            # are stale the moment this push applies (other sessions'
            # copies are the shard lease board's job)
            self.hotcache.invalidate(unique)
        # quantize ONCE per logical batch (error feedback applied here,
        # never in a retry path): the delivered rows are the
        # dequantized values, identical over every framing and every
        # replay — the q sections are sliced per shard below
        q_rows = q_scales = None
        if self._compressor is not None:
            summed, q_rows, q_scales = self._compressor.compress(
                unique, summed
            )
            summed = summed.astype(np.float32)
        # one pid per logical batch: (pid, id) identifies each row-push
        # uniquely (unique is deduped), stable across replays/re-routes
        pid = (
            f"{self._pid_base}.{next(self._pid_counter)}"
            if self.membership is not None
            else None
        )
        todo_ids, todo_rows = unique, summed
        deadline = time.monotonic() + self.retry_timeout
        attempt = 0
        self._last_retry_sleep = None  # fresh backoff ladder per batch
        ctx, root_span = self._trace_root("push_batch")
        with root_span:
            while todo_ids.size:
                rejected: List[np.ndarray] = []
                reasons: List[str] = []
                rej_lock = threading.Lock()

                def do(s, sids):
                    rows = todo_rows[np.searchsorted(todo_ids, sids)]
                    qr = qs = None
                    if q_rows is not None:
                        # unique is sorted and every retry set is a
                        # subset of it, so the q sections slice by the
                        # same positional lookup on any replay round
                        pos = np.searchsorted(unique, sids)
                        qr, qs = q_rows[pos], q_scales[pos]
                    try:
                        self._push_shard(
                            s, sids, rows, pid, ctx, q_rows=qr,
                            q_scales=qs,
                        )
                    except _Rejected as r:
                        with rej_lock:
                            rejected.append(r.ids)
                            reasons.append(r.reason)

                self._for_each_shard(self._split(todo_ids), do)
                done = todo_ids.size - sum(len(r) for r in rejected)
                self.rows_pushed += int(done)
                if rejected:
                    retry = np.sort(np.concatenate(rejected))
                    # keep the sorted-ids invariant: the per-shard row
                    # lookup above is a searchsorted against todo_ids
                    todo_rows = todo_rows[np.searchsorted(todo_ids, retry)]
                    todo_ids = retry
                    attempt += 1
                    self.frames_retried += 1
                    self._await_retry(
                        deadline, attempt, "push", reason=reasons[0]
                    )
                else:
                    todo_ids = np.empty(0, np.int64)
        if self.retry_budget is not None:
            self.retry_budget.on_success()
        return int(unique.size)

    def flush(self) -> List[str]:
        """FLUSH every shard (WAL fsync + ack) — the explicit durability
        barrier a bound-0 round ends with when durability matters."""
        return [
            _check_ok(self._conn_for(s).request("flush"), f"flush shard {s}")
            for s in range(self.partitioner.num_shards)
        ]

    def shard_stats(self) -> List[dict]:
        import json

        out = []
        for s in range(self.partitioner.num_shards):
            resp = _check_ok(
                self._conn_for(s).request("stats"), f"stats shard {s}"
            )
            out.append(json.loads(resp[3:]))
        return out

    # -- the event-API surface (ParameterServerClient) ----------------------
    def pull(self, param_id: int) -> None:
        """Buffer a pull; answers arrive at the next :meth:`drain` —
        the asynchronous contract of the ABC, with the microbatch as
        the combination buffer."""
        self._pending_pulls.append(int(param_id))

    def push(self, param_id: int, delta) -> None:
        self._pending_pushes.append((int(param_id), np.asarray(delta)))

    def output(self, w_out) -> None:
        self.outputs.append(w_out)

    def drain(self, on_pull_recv=None) -> int:
        """Flush buffered pushes (aggregated) and answer buffered pulls
        (coalesced); ``on_pull_recv(param_id, value, client)`` is
        invoked once per buffered pull, in buffering order.  Returns
        the number of answers delivered."""
        if self._pending_pushes:
            ids = np.asarray([i for i, _ in self._pending_pushes], np.int64)
            deltas = np.stack([d for _, d in self._pending_pushes])
            self._pending_pushes = []
            self.push_batch(ids, deltas)
        n = 0
        if self._pending_pulls:
            ids = np.asarray(self._pending_pulls, np.int64)
            self._pending_pulls = []
            values = self.pull_batch(ids)
            for i, pid in enumerate(ids):
                if on_pull_recv is not None:
                    on_pull_recv(int(pid), values[i], self)
                n += 1
        return n

    def close(self) -> None:
        if (
            self.hotcache is not None
            and self._sess is not None
            and self._lease_supported
        ):
            # best-effort lease release on live primary connections —
            # the shard board stops tracking this session; failures
            # are fine (the board evicts idle sessions on its own)
            primaries = set(self._addresses)
            for addr, conn in list(self._conns.items()):
                if addr not in primaries:
                    continue
                try:
                    conn.request(f"revoke all sess={self._sess}")
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass
        for c in list(self._conns.values()):
            c.close()
        self._conns = {}
        self._pool.close()
        if self.hedge is not None:
            self.hedge.close()
        if self.push_hedge is not None:
            self.push_hedge.close()

    # -- internals ----------------------------------------------------------
    def _split(self, unique_ids: np.ndarray) -> Dict[int, np.ndarray]:
        shards = self.partitioner.shard_of(unique_ids)
        return {
            int(s): unique_ids[shards == s] for s in np.unique(shards)
        }

    def _for_each_shard(self, by_shard: Dict[int, np.ndarray], fn) -> None:
        """Run ``fn(shard, ids)`` for every shard concurrently —
        persistent pool workers for all but one, the last inline on
        this thread (errors propagate to the caller; see
        :class:`_FanoutPool` for why nothing is spawned here)."""
        items = list(by_shard.items())
        if len(items) == 1:
            fn(*items[0])
            return
        self._pool.run([
            (lambda s=s, sids=sids: fn(s, sids)) for s, sids in items
        ])

    def _frame_suffix(self, pid: Optional[str] = None) -> str:
        suffix = ""
        if pid is not None:
            suffix += f" pid={pid}"
        if self._epoch is not None:
            suffix += f" e={self._epoch}"
        if self._priority is not None:
            # overload-plane priority tag (loadgen/overload.py): the
            # shard-edge guard sheds pr=2 (serving) traffic first and
            # never sheds pr=0
            suffix += f" pr={self._priority}"
        if self.hotcache is not None and self._sess is not None:
            # declares a lease-capable session: responses may carry
            # piggybacked inv= tokens (old servers parse-and-ignore)
            suffix += f" sess={self._sess}"
        return suffix

    def _frame_trace(self, shard: int, name: str, ctx):
        """Per-shard child span + the BARE trace token its id rides on
        (``<trace>:<span>`` — the line protocol prefixes ``t=``, the
        binary framing carries it as a ``T_TRACE`` TLV):
        ``(token_or_None, span_cm, span_id)`` — empties when
        untraced."""
        if ctx is None or self._tracer is None or not self._tracer.enabled:
            return None, _NULL_CM, None
        span_id = gen_id(4)
        tok = TraceContext(ctx.trace_id, span_id).token()
        cm = self._tracer.span(
            f"{name}.shard{shard}", "cluster",
            trace_id=ctx.trace_id, parent_id=ctx.span_id, span_id=span_id,
        )
        return tok, cm, span_id

    def _request_frames(
        self, shard: int, sids: np.ndarray, build, *,
        hedgeable: bool, hedger=None, trace=None,
    ) -> List:
        """Send one shard's frames, rendered by ``build(conn)`` for the
        connection's negotiated protocol (hedged when ``hedgeable`` and
        a hedger is attached: ``hedger``, else the pull ``hedge``).  A connection-level failure in elastic
        mode becomes a :class:`_Rejected` (drop the cached connection,
        let the batch loop refresh + replay) instead of an error — the
        client sees latency while the controller replaces the shard.
        With a breaker board attached, an OPEN shard's frames fail fast
        WITHOUT touching the wire (the half-open probe is the only
        traffic an open shard sees)."""
        board = self.breakers
        if board is not None and not board.allow(shard):
            if self.membership is None:
                raise RuntimeError(
                    f"shard {shard}: circuit open — frames fail fast "
                    f"until a half-open probe succeeds"
                )
            raise _Rejected(sids, "breaker_open")
        try:
            conn = self._conn_for(shard)
            reqs = build(conn)
            h = hedger if hedger is not None else self.hedge
            if hedgeable and h is not None:
                addr = self._addresses[shard]

                def on_backup_won(spare_conn):
                    # the still-draining primary must never be reused
                    # (one reader per line-protocol connection): the
                    # clean spare takes its slot
                    old = self._conns.pop(addr, None)
                    if old is not None:
                        old.close()
                    self._conns[addr] = spare_conn

                resps = h.request_many(
                    conn,
                    lambda: self._dial(addr),
                    reqs,
                    on_backup_won,
                    trace=trace,
                )
            else:
                resps = conn.request_many(reqs)
        except OSError:
            # transport failure feeds the breaker (a dead/wedged shard
            # opens its circuit after enough of these in the window)
            if board is not None:
                board.fail(shard)
            if self.membership is None:
                raise
            self._drop_conn(shard)
            raise _Rejected(sids, "conn") from None
        if board is not None:
            board.ok(shard)
        return resps

    def _read_frames(
        self, shard: int, sids: np.ndarray, build, *, trace=None,
    ) -> List:
        """Route one shard's READ frames: a replica when the rotation
        picks one, the primary otherwise — and always the primary as
        the fallback when the replica declines (lagging/not-primary)
        or cannot be reached.  Pulls are idempotent, so the fallback
        replays the whole frame set."""
        addr, is_replica = self._read_target(shard)
        if not is_replica:
            return self._request_frames(
                shard, sids, build, hedgeable=True, trace=trace
            )
        resps = None
        try:
            resps = self._replica_request(shard, addr, build, trace)
        except OSError:
            self._drop_addr(addr)
        if resps is not None and not any(
            _is_follower_reject(r) for r in resps
        ):
            if self._c_replica_reads is not None:
                self._c_replica_reads.inc(len(resps))
            return resps
        if self._c_fallbacks is not None:
            self._c_fallbacks.inc()
        return self._request_frames(
            shard, sids, build, hedgeable=True, trace=trace
        )

    def _replica_request(
        self, shard: int, addr: Tuple[str, int], build, trace
    ) -> List:
        """One replica's frames — hedged, when a hedger is attached,
        against the PRIMARY: a straggling replica races the shard's
        write owner and the first answer wins (the budgeted
        elastic/hedging.py race, re-aimed across the chain)."""
        conn = self._conn_for_addr(addr)
        reqs = build(conn)
        if self.hedge is None:
            return conn.request_many(reqs)
        primary = self._addresses[shard]

        def on_backup_won(spare_conn):
            # the spare dialed the primary; it takes the primary's
            # cache slot (the still-draining replica conn is dropped)
            old = self._conns.pop(primary, None)
            if old is not None:
                old.close()
            self._conns[primary] = spare_conn
            self._drop_addr(addr)

        return self.hedge.request_many(
            conn,
            lambda: self._dial(primary),
            reqs,
            on_backup_won,
            trace=trace,
        )

    def _check_shed(self, resp, shard: int, what: str) -> None:
        """A typed shed answer fails fast (count badput, never retry
        the storm); the breaker sees it as a failure signal."""
        if _is_overloaded(resp):
            if self.breakers is not None:
                self.breakers.fail(shard)
            raise OverloadedError(f"{what} shard {shard}: {_describe(resp)}")

    def _observe_shard_rtt(self, shard: int, per: float,
                           frames: int) -> None:
        """Per-shard twin of the ``cluster_pull_rtt_seconds``
        observation: same value, extra ``shard=`` label, registered on
        first traffic to that shard."""
        if self._reg is None:
            return
        h = self._h_shard_rtt.get(shard)
        if h is None:
            h = self._reg.histogram(
                "cluster_shard_rtt_seconds", component="cluster",
                shard=str(shard), **self._labels,
            )
            self._h_shard_rtt[shard] = h
        for _ in range(frames):
            h.observe(per)

    def _bin_enc(self) -> int:
        """Row encoding for binary READ frames (pull answers): exact
        fp32 unless the client opted into bf16 (half the row bytes,
        lossy).  ``q8`` is a PUSH-delta codec only — absolute values
        carry no residual to re-inject, so quantizing reads would be
        silent corruption (docs/compression.md)."""
        return (
            binf.ENC_BF16 if self.wire_format == "bf16"
            else binf.ENC_F32
        )

    def _bin_tlvs(self, tok: Optional[str], pid: Optional[str] = None):
        """The frame TLVs mirroring :meth:`_frame_suffix`'s trailing
        tokens (epoch and priority live in the fixed header)."""
        tlvs = []
        if tok is not None:
            tlvs.append((binf.T_TRACE, tok.encode()))
        if pid is not None:
            tlvs.append((binf.T_PID, pid.encode()))
        if self.hotcache is not None and self._sess is not None:
            tlvs.append((binf.T_SESS, self._sess.encode()))
        return tlvs

    def _parse_rows_any(self, resp, chunk, shard: int, what: str = "pull"):
        """One pull/lease response's rows, either framing,
        length-checked (a text lease answer's rows are parsed by the
        lease path itself)."""
        prof = self._profiler
        if isinstance(resp, binf.Frame):
            with prof.timer("pull", "client_parse"):
                vals = binf.rows_from_payload(
                    resp.payload, self.value_shape, resp.enc
                )
        else:
            _, _, body = resp.partition(" ")
            _, _, body = body.partition(" ")  # strip "n=<k>"
            with prof.timer("pull", "client_parse"):
                vals = parse_rows(body, self.value_shape)
        if len(vals) != len(chunk):
            raise RuntimeError(
                f"shard {shard} answered {len(vals)} rows for "
                f"{len(chunk)} ids ({what})"
            )
        return vals

    def _pull_shard(
        self, shard: int, ids: np.ndarray, ctx=None
    ) -> np.ndarray:
        """One shard's reads, hot/cold split.  Ids the lease policy
        marks HOT (all of which already missed the cache) are read via
        the ``lease`` verb — an atomic read + grant that fills the
        cache — and the rest via plain ``pull``; both frame kinds go
        out in ONE pipelined ``request_many`` on the primary, so the
        hot tier never adds a wire round trip over the plain path.
        Pure-cold batches keep the full hedged/replica-routed read
        path.  A reject in either half replays the whole shard set —
        pulls and leases are both idempotent reads."""
        cache, policy = self.hotcache, self.lease_policy
        if cache is None or policy is None or not self._lease_supported:
            return self._pull_shard_wire(shard, ids, ctx)
        hot = np.asarray(policy.is_hot(ids), bool)
        if not hot.any():
            return self._pull_shard_wire(shard, ids, ctx)
        out = np.empty(
            (len(ids),) + self.value_shape, np.float32
        )
        try:
            try:
                hot_rows, cold_rows = self._lease_pull_shard(
                    shard, ids[hot], ids[~hot], ctx
                )
            except _LeaseUnsupported:
                # pre-hotcache server: downgrade to plain pulls for the
                # rest of this client's life (never re-probed)
                self._lease_supported = False
                return self._pull_shard_wire(shard, ids, ctx)
        except _Rejected as r:
            raise _Rejected(ids, r.reason) from None
        out[hot] = hot_rows
        if cold_rows is not None:
            out[~hot] = cold_rows
        return out

    def _lease_pull_shard(
        self,
        shard: int,
        hot_ids: np.ndarray,
        cold_ids: np.ndarray,
        ctx=None,
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """``lease`` frames for ``hot_ids`` + ``pull`` frames for
        ``cold_ids``, pipelined in one request batch on the primary
        (one round trip); leased rows are installed in the cache at
        the current tick.  Returns ``(hot_rows, cold_rows-or-None)``;
        rejects surface as :class:`_Rejected` exactly like pulls."""
        prof = self._profiler
        hot_chunks = [
            hot_ids[i: i + self.chunk]
            for i in range(0, len(hot_ids), self.chunk)
        ]
        cold_chunks = [
            cold_ids[i: i + self.chunk]
            for i in range(0, len(cold_ids), self.chunk)
        ]
        tok, span_cm, _span_id = self._frame_trace(shard, "lease", ctx)
        all_ids = np.concatenate([hot_ids, cold_ids])
        hot_rows: List[np.ndarray] = []
        cold_rows: List[np.ndarray] = []
        rejected = False
        reject_reason = "reject"

        def build(conn) -> List:
            if conn.proto != "line":  # bin or shm: same frames
                enc = self._bin_enc()
                tlvs = self._bin_tlvs(tok)
                lease_tlvs = [
                    (binf.T_TTL, str(self._lease_ttl).encode())
                ] + tlvs
                return [
                    binf.encode_request(
                        binf.VERB_IDS["lease"], ids=c, enc=enc,
                        epoch=self._epoch, priority=self._priority,
                        tlvs=lease_tlvs,
                    )
                    for c in hot_chunks
                ] + [
                    binf.encode_request(
                        binf.VERB_IDS["pull"], ids=c, enc=enc,
                        epoch=self._epoch, priority=self._priority,
                        tlvs=tlvs,
                    )
                    for c in cold_chunks
                ]
            suffix = self._frame_suffix() + (
                " t=" + tok if tok is not None else ""
            )
            enc_tok = " text" if self.wire_format == "text" else " b64"
            return [
                "lease " + ",".join(str(int(i)) for i in c)
                + enc_tok + f" ttl={self._lease_ttl}" + suffix
                for c in hot_chunks
            ] + [
                "pull " + ",".join(str(int(i)) for i in c)
                + enc_tok + suffix
                for c in cold_chunks
            ]

        with span_cm:
            t0 = time.perf_counter()
            resps = self._request_frames(
                shard, all_ids, build, hedgeable=False
            )
            per = (time.perf_counter() - t0) / max(1, len(resps))
            for _ in resps:
                if self._h_rtt is not None:
                    self._h_rtt.observe(per)
                prof.observe("pull", "rtt", per)
            self._observe_shard_rtt(shard, per, len(resps))
            n_hot = len(hot_chunks)
            for i, (resp, c) in enumerate(zip(
                resps, hot_chunks + cold_chunks
            )):
                is_lease = i < n_hot
                what = "lease" if is_lease else "pull"
                resp = self._apply_response_options(resp)
                self._check_shed(resp, shard, what)
                if _is_reject(resp) and self.membership is not None:
                    rejected = True
                    reject_reason = _reject_reason(resp)
                    continue
                if is_lease and _is_bad_request(resp):
                    raise _LeaseUnsupported(_describe(resp))
                _check_ok(resp, f"{what} shard {shard}")
                if isinstance(resp, binf.Frame) or not is_lease:
                    vals = self._parse_rows_any(resp, c, shard, what)
                else:
                    # text lease answer: ok n=<k> seq=<q> ttl=<r> <body>
                    parts = resp.split(" ", 4)
                    if len(parts) < 5:
                        raise RuntimeError(
                            f"shard {shard} lease answer malformed: "
                            f"{resp!r}"
                        )
                    with prof.timer("pull", "client_parse"):
                        vals = parse_rows(parts[4], self.value_shape)
                    if len(vals) != len(c):
                        raise RuntimeError(
                            f"shard {shard} answered {len(vals)} rows "
                            f"for {len(c)} ids"
                        )
                if is_lease:
                    self.hotcache.fill(c, vals)
                    self.leases_acquired += len(c)
                    hot_rows.append(vals)
                else:
                    cold_rows.append(vals)
        if rejected:
            raise _Rejected(all_ids, reject_reason)
        hot_out = np.concatenate(hot_rows) if hot_rows else np.empty(
            (0,) + self.value_shape, np.float32
        )
        cold_out = (
            np.concatenate(cold_rows) if cold_rows else None
        )
        return hot_out, cold_out

    def _pull_shard_wire(
        self, shard: int, ids: np.ndarray, ctx=None
    ) -> np.ndarray:
        chunks = [
            ids[i: i + self.chunk] for i in range(0, len(ids), self.chunk)
        ]
        prof = self._profiler
        tok, span_cm, span_id = self._frame_trace(shard, "pull", ctx)
        trace = (
            (self._tracer, ctx.trace_id, span_id)
            if span_id is not None else None
        )
        rows = []
        rejected = False
        reject_reason = "reject"
        ser_cell = [0.0]

        def build(conn) -> List:
            """Requests for this connection's protocol — binary frames
            (raw i8 ids + fp32/bf16 rows, options as TLVs) on a
            negotiated connection, text lines otherwise."""
            t_ser = time.perf_counter()
            if conn.proto != "line":  # bin or shm: same frames
                enc = self._bin_enc()
                tlvs = self._bin_tlvs(tok)
                reqs = [
                    binf.encode_request(
                        binf.VERB_IDS["pull"], ids=c, enc=enc,
                        epoch=self._epoch, priority=self._priority,
                        tlvs=tlvs,
                    )
                    for c in chunks
                ]
            else:
                suffix = self._frame_suffix() + (
                    " t=" + tok if tok is not None else ""
                )
                reqs = [
                    "pull " + ",".join(str(int(i)) for i in c)
                    + (" text" if self.wire_format == "text" else " b64")
                    + suffix
                    for c in chunks
                ]
            ser_cell[0] = (
                (time.perf_counter() - t_ser) / max(1, len(reqs))
            )
            return reqs

        # the pull.shard<k> span covers the WHOLE per-shard round —
        # serialize, wire round trip, response parse — which makes it
        # the independent oracle the latency-budget phases (observed
        # separately below) must sum to
        with span_cm:
            t0 = time.perf_counter()
            resps = self._read_frames(shard, ids, build, trace=trace)
            # one observation per chunk frame: the pipelined per-frame
            # turnaround, amortised (total wall / frames); serialize
            # time was measured inside the builder, net of the dial
            per = (
                (time.perf_counter() - t0) / max(1, len(resps))
                - ser_cell[0]
            )
            for _ in resps:
                if self._h_rtt is not None:
                    self._h_rtt.observe(per)
                prof.observe("pull", "rtt", per)
                prof.observe("pull", "client_serialize", ser_cell[0])
            self._observe_shard_rtt(shard, per, len(resps))
            for resp, c in zip(resps, chunks):
                if self.hotcache is not None:
                    # piggybacked inv= tokens ride any response to a
                    # lease-capable session — strip and apply first
                    resp = self._apply_response_options(resp)
                self._check_shed(resp, shard, "pull")
                if _is_reject(resp) and self.membership is not None:
                    rejected = True
                    reject_reason = _reject_reason(resp)
                    continue
                _check_ok(resp, f"pull shard {shard}")
                rows.append(self._parse_rows_any(resp, c, shard))
        if rejected:
            # partial answers cannot scatter into the output without
            # per-chunk bookkeeping; pulls are idempotent, so replay
            # the shard's whole id set under the refreshed map
            raise _Rejected(ids, reject_reason)
        return np.concatenate(rows) if rows else np.empty(
            (0,) + self.value_shape, np.float32
        )

    def _push_shard(
        self,
        shard: int,
        ids: np.ndarray,
        deltas: np.ndarray,
        pid: Optional[str] = None,
        ctx=None,
        q_rows: Optional[np.ndarray] = None,
        q_scales: Optional[np.ndarray] = None,
    ) -> None:
        prof = self._profiler
        tok, span_cm, _span_id = self._frame_trace(shard, "push", ctx)
        chunks = [
            ids[i: i + self.chunk]
            for i in range(0, len(ids), self.chunk)
        ]
        ser_cell = [0.0]

        def build(conn) -> List:
            t_ser = time.perf_counter()
            if conn.proto != "line":  # bin or shm: same frames
                tlvs = self._bin_tlvs(tok, pid)
                if q_rows is not None and "q8" in conn.encs:
                    # the quantized push path: int8 rows + a T_SCALE
                    # TLV of the per-row f32 scales, per chunk.  The
                    # rows the shard will apply are bitwise the
                    # `deltas` (dq) rows — only the bytes differ.
                    reqs = []
                    saved = 0
                    for i in range(0, len(ids), self.chunk):
                        qc = np.ascontiguousarray(
                            q_rows[i: i + self.chunk]
                        )
                        sc = np.ascontiguousarray(
                            q_scales[i: i + self.chunk], "<f4"
                        )
                        reqs.append(binf.encode_request(
                            binf.VERB_IDS["push"],
                            ids=ids[i: i + self.chunk],
                            payload=qc.tobytes(),
                            enc=binf.ENC_Q8, epoch=self._epoch,
                            priority=self._priority,
                            tlvs=[(binf.T_SCALE, sc.tobytes())] + tlvs,
                        ))
                        saved += 3 * qc.size - sc.nbytes
                    if self._c_bytes_saved is not None and saved > 0:
                        self._c_bytes_saved.inc(saved)
                    ser_cell[0] = (
                        (time.perf_counter() - t_ser)
                        / max(1, len(reqs))
                    )
                    return reqs
                enc = (
                    binf.ENC_BF16 if self.wire_format == "bf16"
                    else binf.ENC_F32
                )
                reqs = [
                    binf.encode_request(
                        binf.VERB_IDS["push"],
                        ids=ids[i: i + self.chunk],
                        payload=binf.rows_to_payload(
                            deltas[i: i + self.chunk], enc
                        ),
                        enc=enc, epoch=self._epoch,
                        priority=self._priority, tlvs=tlvs,
                    )
                    for i in range(0, len(ids), self.chunk)
                ]
                if (
                    enc == binf.ENC_BF16
                    and self._c_bytes_saved is not None
                ):
                    # bf16 halves the row bytes vs f32
                    self._c_bytes_saved.inc(
                        2 * int(np.asarray(deltas).size)
                    )
            else:
                suffix = self._frame_suffix(pid) + (
                    " t=" + tok if tok is not None else ""
                )
                fmt = (
                    "text" if self.wire_format == "text" else "b64"
                )
                reqs = [
                    "push "
                    + ",".join(
                        str(int(x)) for x in ids[i: i + self.chunk]
                    )
                    + " "
                    + format_rows(deltas[i: i + self.chunk], fmt)
                    + suffix
                    for i in range(0, len(ids), self.chunk)
                ]
            ser_cell[0] = (
                (time.perf_counter() - t_ser) / max(1, len(reqs))
            )
            return reqs

        # like pull: the push.shard<k> span covers serialize + round
        # trip, the same window the push phases decompose
        with span_cm:
            t0 = time.perf_counter()
            # hedged only when the batch carries a pid: the shard's
            # (pid,id) dedupe window then absorbs the losing leg's
            # duplicate apply, the same way it absorbs ambiguous
            # retries — without a pid a raced push would double-apply
            resps = self._request_frames(
                shard, ids, build,
                hedgeable=(pid is not None and self.push_hedge is not None),
                hedger=self.push_hedge,
            )
            per = (
                (time.perf_counter() - t0) / max(1, len(resps))
                - ser_cell[0]
            )
            for _ in resps:
                prof.observe("push", "rtt", per)
                prof.observe("push", "client_serialize", ser_cell[0])
        rejected: List[np.ndarray] = []
        reject_reason = "reject"
        for resp, c_ids in zip(resps, chunks):
            if self.hotcache is not None:
                resp = self._apply_response_options(resp)
            self._check_shed(resp, shard, "push")
            if _is_reject(resp) and self.membership is not None:
                rejected.append(c_ids)
                reject_reason = _reject_reason(resp)
                continue
            _check_ok(resp, f"push shard {shard}")
        if rejected:
            raise _Rejected(np.concatenate(rejected), reject_reason)


__all__ = ["ClusterClient", "ShardConnection"]
