"""The serve front end: dispatch loop, in-process client, TCP server.

Counterpart of ``flink_parameter_server_tpu/serving/server.py``, which
imports no JAX itself; the port keeps its own copy, on the port's engine,
snapshots and telemetry.

Symmetry with the ingest edge (``data/socket.py``): the training side
reads newline-delimited records from a TCP socket; the serving side
answers newline-delimited queries over one.  Same host-side discipline
— sockets and parsing stay on the host, the device only ever sees the
batches the :class:`~.batcher.RequestBatcher` coalesces, padded to
bucket shapes.

Line protocol (one request per line, one response line per request, in
order, per connection)::

    topk <user_id> <k>[ <ex1,ex2,...>]      # top-k items for user,
                                            # optionally excluding ids
    pull <id1,id2,...>                      # raw embedding rows

    ok v=<version> step=<train_step> stale=<staleness> <payload>
    err <reason>                            # bad-request | overloaded |
                                            # deadline | no-snapshot |
                                            # internal

``topk`` payload: ``<item_id>:<score>`` space-separated (k entries;
lanes with no real candidate are ``-1:-inf``).  ``pull`` payload: one
``;``-separated row per id, each row ``,``-separated floats.

Concurrency model: each connection is handled synchronously (a client
pipelining N connections gets N-way admission concurrency); batching
across connections happens in the shared :class:`RequestBatcher`.
Overload answers ``err overloaded`` immediately — reject, never block.
"""
from __future__ import annotations

import dataclasses
import socket
import threading
from concurrent.futures import Future
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ..core.store import ShardedParamStore, StoreSpec
from ..utils.net import LineServer
from .batcher import (
    DeadlineExceeded,
    PendingRequest,
    QueueFull,
    RequestBatcher,
    pow2_bucket,
)
from .engine import LookupResult, NoSnapshotError, QueryEngine, TopKResult
from .metrics import ServingMetrics
from .snapshot import SnapshotManager

import time


@dataclasses.dataclass(frozen=True)
class _TopKQuery:
    user: int
    k: int
    exclude: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class _LookupQuery:
    ids: Tuple[int, ...]


class ServingService:
    """snapshots + engine + batcher + ONE dispatch thread.

    The dispatch thread drains the admission queue, pads each batch to
    a bucket shape, runs the query ops, and resolves the
    per-request futures.  Publishing happens on the TRAINING thread via
    :meth:`on_dispatch` (the driver's ``serve_with`` hook) — the service
    itself never touches live training buffers.
    """

    def __init__(
        self,
        engine: QueryEngine,
        batcher: Optional[RequestBatcher] = None,
        metrics: Optional[ServingMetrics] = None,
        registry=None,
        hotkeys=None,
        shedder=None,
    ):
        self.engine = engine
        self.snapshots = engine.snapshots
        # overload-plane admission (loadgen/overload.LoadShedder):
        # with a shedder attached, requests are shed in the submit
        # path once the queue passes the shedder's depth fraction —
        # BELOW the hard QueueFull line, so rejection is cheap and
        # early (counted reason="shed" vs the hard "queue_full")
        self.shedder = shedder
        # hot-key analytics (telemetry/hotkeys.py): with a sketch
        # attached, every served lookup's requested ids are observed —
        # the serving-side half of the Zipf-skew measurement (register
        # the sketch with the aggregator to fold it into /metrics)
        self.hotkeys = hotkeys
        self.batcher = batcher if batcher is not None else RequestBatcher()
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.metrics.queue_depth_fn = lambda: self.batcher.depth
        self.metrics.staleness_fn = self.snapshots.staleness
        # unified plane (telemetry/): admission counters, the latency
        # histogram, and live depth/fill/staleness probe gauges publish
        # under component=serving — bound AFTER the probes above so the
        # gauges are live from the first scrape.  Default: the
        # process-wide registry (one /metrics endpoint sees the whole
        # train-while-serve stack).
        from ..telemetry import get_registry

        if registry is not None:
            self.metrics.bind_registry(registry)
        elif self.metrics.registry is None:
            self.metrics.bind_registry(get_registry())
        self.dispatch_errors = 0  # batches failed wholesale (loop survived)
        self._health = None  # optional resilience/health.HealthMonitor
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def attach_health(self, monitor) -> "ServingService":
        """Beat ``serving_dispatch`` on ``monitor`` from the dispatch
        loop (resilience/health.py stall watchdog wiring)."""
        self._health = monitor
        return self

    @classmethod
    def for_spec(
        cls,
        spec: StoreSpec,
        *,
        publish_every: int = 1,
        user_vectors=None,
        max_batch: int = 64,
        max_delay_ms: float = 2.0,
        max_queue: int = 256,
        buckets: Optional[Sequence[int]] = None,
    ) -> "ServingService":
        """One-stop construction from a store spec (what
        ``StreamingDriver.serve_with`` calls)."""
        snaps = SnapshotManager(spec, publish_every=publish_every)
        engine = QueryEngine(snaps, user_vectors=user_vectors)
        batcher = RequestBatcher(
            max_batch=max_batch, max_delay_ms=max_delay_ms,
            max_queue=max_queue, buckets=buckets,
        )
        return cls(engine, batcher)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ServingService":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            # restart path: a previous stop() closed the admission
            # queue; a restarted trainer re-attaching serving (the
            # supervisor's resume, or an explicit stop/start cycle)
            # gets a live one again
            self.batcher.reopen()
            self._thread = threading.Thread(
                target=self._loop, name="serving-dispatch", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.batcher.close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- training-side hooks (called on the trainer thread) ----------------
    def on_train_start(self, store: ShardedParamStore, step: int, state=None):
        """Publish the pre-training table (serving is live from step 0)
        and start the dispatch thread."""
        self.snapshots.publish(store.table, step, aux=state)
        self.start()

    def on_dispatch(self, table, state, step: int, *, force: bool = False):
        """Per-dispatch publish offer (the ``publish_every`` cadence
        decides); ``force`` for the close-time final publish."""
        if force:
            self.snapshots.publish(table, step, aux=state)
        else:
            self.snapshots.maybe_publish(table, step, aux=state)

    def wait_for_snapshot(
        self, timeout: Optional[float] = None, *, min_version: int = 1
    ) -> bool:
        """Block until a snapshot with version >= ``min_version`` is
        published (warm-up gate for clients; version 1 is the
        pre-training table, version 2 the first mid-training publish —
        the first one carrying worker state)."""
        if not self.snapshots.wait_for_snapshot(timeout):
            return False
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            snap = self.snapshots.latest()
            if snap is not None and snap.version >= min_version:
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.005)

    # -- admission ---------------------------------------------------------
    def _admit_shed(self) -> None:
        """The shed gate (loadgen/overload.py): deliberate rejection
        below the hard capacity line once the queue is deep enough —
        raised as :class:`QueueFull` so every existing caller's
        backoff path applies unchanged, counted as its own cause."""
        if self.shedder is not None and not self.shedder.admit(
            self.batcher.depth, self.batcher.max_queue
        ):
            self.metrics.record_reject(reason="shed")
            raise QueueFull(
                "serving admission shed under overload pressure; "
                "retry with backoff or degrade"
            )

    def submit_topk(
        self, user: int, k: int = 10, exclude: Sequence[int] = ()
    ) -> Future:
        self._admit_shed()
        try:
            return self.batcher.submit(
                _TopKQuery(int(user), int(k), tuple(int(e) for e in exclude))
            )
        except QueueFull:
            self.metrics.record_reject(reason="queue_full")
            raise

    def submit_lookup(self, ids: Sequence[int]) -> Future:
        self._admit_shed()
        try:
            return self.batcher.submit(
                _LookupQuery(tuple(int(i) for i in ids))
            )
        except QueueFull:
            self.metrics.record_reject(reason="queue_full")
            raise

    def client(self) -> "ServingClient":
        return ServingClient(self)

    # -- the dispatch loop -------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self.batcher.next_batch(timeout=0.1)
            if self._health is not None:
                self._health.beat("serving_dispatch")
            if not batch:
                continue
            try:
                self._serve_batch(batch)
            except BaseException as e:
                # One poisoned batch must not kill the dispatch thread —
                # with it dead, every later query hangs to its timeout
                # while the trainer keeps publishing to nobody.  Fail
                # the batch's futures, count it, keep serving.
                # fpsanalyze: allow[S001] the ONE dispatch thread is the sole writer; readers are monitoring-only
                self.dispatch_errors += 1
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(e)

    def _serve_batch(self, batch: List[PendingRequest]) -> None:
        dl = self.batcher.deadline_s
        if dl is not None:
            # fail requests whose queue wait already blew the deadline
            # — serving them would return answers nobody is waiting
            # for while fresher requests queue behind them
            now = time.monotonic()
            expired = [p for p in batch if now - p.t_submit > dl]
            if expired:
                batch = [p for p in batch if now - p.t_submit <= dl]
                self.metrics.record_reject(len(expired), reason="deadline")
                for p in expired:
                    if not p.future.done():
                        p.future.set_exception(DeadlineExceeded(
                            f"queued {now - p.t_submit:.3f}s > deadline "
                            f"{dl:.3f}s"
                        ))
        topks = [p for p in batch if isinstance(p.payload, _TopKQuery)]
        lookups = [p for p in batch if isinstance(p.payload, _LookupQuery)]
        others = [
            p for p in batch if not isinstance(p.payload, (_TopKQuery,
                                                           _LookupQuery))
        ]
        for p in others:
            if not p.future.done():
                p.future.set_exception(
                    TypeError(f"unknown request payload {type(p.payload)}")
                )
        if topks:
            self._serve_topks(topks)
        if lookups:
            self._serve_lookups(lookups)

    def _serve_topks(self, pending: List[PendingRequest]) -> None:
        n = len(pending)
        bucket = self.batcher.bucket_for(n)
        k_max = max(p.payload.k for p in pending)
        e_max = max(len(p.payload.exclude) for p in pending)
        users = np.zeros(bucket, np.int32)
        for i, p in enumerate(pending):
            users[i] = p.payload.user
        exclude = None
        if e_max:
            e_pad = pow2_bucket(e_max, 1 << 20)
            exclude = np.full((bucket, e_pad), -1, np.int32)
            for i, p in enumerate(pending):
                ex = p.payload.exclude
                exclude[i, : len(ex)] = ex
        try:
            res = self.engine.top_k(users, k_max, exclude=exclude)
        except Exception as e:  # NoSnapshot / bad shapes: per-request error
            for p in pending:
                if not p.future.done():
                    p.future.set_exception(e)
            return
        now = time.monotonic()
        lats = []
        for i, p in enumerate(pending):
            k = p.payload.k
            answer = TopKResult(
                scores=res.scores[i, :k],
                item_ids=res.item_ids[i, :k],
                version=res.version,
                train_step=res.train_step,
                staleness=res.staleness,
            )
            lats.append(now - p.t_submit)
            if not p.future.done():
                p.future.set_result(answer)
        self.metrics.record_batch(n, bucket, lats)

    def _serve_lookups(self, pending: List[PendingRequest]) -> None:
        n = len(pending)
        bucket = self.batcher.bucket_for(n)
        w_max = max(len(p.payload.ids) for p in pending)
        w_pad = pow2_bucket(max(1, w_max), 1 << 20)
        ids = np.zeros((bucket, w_pad), np.int32)
        for i, p in enumerate(pending):
            ids[i, : len(p.payload.ids)] = p.payload.ids
        if self.hotkeys is not None:
            self.hotkeys.observe(np.concatenate([
                np.asarray(p.payload.ids, np.int64) for p in pending
            ]))
        try:
            res = self.engine.lookup(ids)
        except Exception as e:
            for p in pending:
                if not p.future.done():
                    p.future.set_exception(e)
            return
        now = time.monotonic()
        lats = []
        for i, p in enumerate(pending):
            w = len(p.payload.ids)
            answer = LookupResult(
                values=res.values[i, :w],
                version=res.version,
                train_step=res.train_step,
                staleness=res.staleness,
            )
            lats.append(now - p.t_submit)
            if not p.future.done():
                p.future.set_result(answer)
        self.metrics.record_batch(n, bucket, lats)


class ServingClient:
    """In-process client — the test/benchmark surface.

    Each call admits one request and blocks on its future; use
    :meth:`top_k_many` to keep many requests in flight (that is what
    exercises the coalescing path)."""

    def __init__(self, service: ServingService):
        self._service = service

    def top_k(
        self, user: int, k: int = 10, exclude: Sequence[int] = (),
        timeout: float = 30.0,
    ) -> TopKResult:
        return self._service.submit_topk(user, k, exclude).result(timeout)

    def lookup(self, ids: Sequence[int], timeout: float = 30.0) -> LookupResult:
        return self._service.submit_lookup(ids).result(timeout)

    def top_k_many(
        self, users: Sequence[int], k: int = 10, timeout: float = 60.0
    ) -> List[TopKResult]:
        futs = [self._service.submit_topk(u, k) for u in users]
        return [f.result(timeout) for f in futs]


# -- the TCP line protocol ---------------------------------------------------


def format_response(res) -> str:
    head = f"ok v={res.version} step={res.train_step} stale={res.staleness}"
    if isinstance(res, TopKResult):
        body = " ".join(
            f"{int(i)}:{float(s):.6g}"
            for i, s in zip(res.item_ids, res.scores)
        )
        return f"{head} {body}"
    vals = np.asarray(res.values, np.float64)
    # one ';'-row per id: scalar stores give (W,), vector stores (W, d)
    vals = vals.reshape(-1, 1) if vals.ndim <= 1 else vals.reshape(
        vals.shape[0], -1
    )
    body = ";".join(",".join(f"{v:.6g}" for v in row) for row in vals)
    return f"{head} {body}"


def parse_response(line: str) -> dict:
    """Parse one response line into a dict (client/test helper)."""
    parts = line.strip().split()
    if not parts:
        raise ValueError("empty response")
    if parts[0] == "err":
        return {"ok": False, "error": " ".join(parts[1:])}
    if parts[0] != "ok":
        raise ValueError(f"malformed response {line!r}")
    meta = {}
    i = 1
    while i < len(parts) and "=" in parts[i]:
        key, _, val = parts[i].partition("=")
        meta[key] = int(val)
        i += 1
    out = {
        "ok": True,
        "version": meta.get("v"),
        "train_step": meta.get("step"),
        "staleness": meta.get("stale"),
    }
    rest = parts[i:]
    if rest and ":" in rest[0]:
        items, scores = [], []
        for tok in rest:
            iid, _, sc = tok.partition(":")
            items.append(int(iid))
            scores.append(float(sc))
        out["item_ids"] = items
        out["scores"] = scores
    elif rest:
        out["values"] = [
            [float(v) for v in row.split(",") if v]
            for row in " ".join(rest).split(";")
        ]
    return out


class ServingServer(LineServer):
    """Line-protocol TCP front end over a :class:`ServingService`.

    ``port=0`` binds an ephemeral port (read it back from ``.port``).
    The socket plumbing (the selectors event loop, per-connection read
    buffers + dispatchers, the line reassembly + overflow guard,
    shutdown) lives in :class:`~..utils.net.LineServer`; this class is
    the protocol — :meth:`respond` answers one request line with one
    response line.  The serving plane deliberately stays on the line
    protocol: its answers are id lists and scores, not row payloads,
    so binary framing buys nothing here — a cluster-style ``hello``
    handshake lands in the unknown-command branch (``err
    bad-request``), which is exactly the downgrade answer a
    negotiating client expects (docs/cluster.md "Binary framing").
    """

    def __init__(
        self,
        service: ServingService,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        request_timeout: float = 30.0,
        max_line_bytes: int = 1 << 20,
        profiler=None,
    ):
        super().__init__(
            host, port, name="serving", max_line_bytes=max_line_bytes
        )
        self.service = service
        self.request_timeout = float(request_timeout)
        # latency-budget phases (telemetry/profiler.py): request parse
        # + admission, dispatch wait, response serialize — verb-scoped
        # as serving_<cmd> so the serve path has its own budget next to
        # the cluster pull/push one
        from ..telemetry.profiler import resolve_profiler

        self.profiler = resolve_profiler(profiler)

    def start(self) -> "ServingServer":
        self.service.start()
        super().start()
        return self

    # -- the protocol ------------------------------------------------------
    def respond(self, line: str) -> str:
        verb = "serving_" + (
            line.split(None, 1)[0].lower() if line.strip() else "empty"
        )
        prof = self.profiler
        try:
            with prof.timer(verb, "server_parse"):
                fut = self._admit(line)
        except QueueFull:
            return "err overloaded"
        except ValueError as e:
            return f"err bad-request: {e}"
        try:
            with prof.timer(verb, "server_queue_wait"):
                # admission → batched dispatch → future resolution: the
                # serve path's queue-wait analogue
                res = fut.result(self.request_timeout)
        except NoSnapshotError:
            return "err no-snapshot"
        except DeadlineExceeded:
            # the request outlived its queue-wait deadline: a typed
            # overload outcome the client can count as badput
            return "err deadline"
        except Exception as e:
            return f"err internal: {type(e).__name__}: {e}"
        with prof.timer(verb, "response_serialize"):
            return format_response(res)

    def _admit(self, line: str) -> Future:
        parts = line.split()
        cmd = parts[0].lower()
        if cmd == "topk":
            if len(parts) not in (3, 4):
                raise ValueError("usage: topk <user> <k> [ex1,ex2,...]")
            user, k = int(parts[1]), int(parts[2])
            if k < 1:
                raise ValueError("k must be >= 1")
            exclude: Tuple[int, ...] = ()
            if len(parts) == 4:
                exclude = tuple(
                    int(t) for t in parts[3].split(",") if t.strip()
                )
            return self.service.submit_topk(user, k, exclude)
        if cmd == "pull":
            if len(parts) != 2:
                raise ValueError("usage: pull <id1,id2,...>")
            ids = tuple(int(t) for t in parts[1].split(",") if t.strip())
            if not ids:
                raise ValueError("pull needs at least one id")
            return self.service.submit_lookup(ids)
        raise ValueError(f"unknown command {cmd!r} (topk|pull)")


def tcp_request(host: str, port: int, line: str, timeout: float = 30.0) -> dict:
    """One-shot TCP query (test/benchmark helper): send one request
    line, read one response line, parse it."""
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.sendall(line.strip().encode("utf-8") + b"\n")
        buf = b""
        while b"\n" not in buf:
            chunk = s.recv(1 << 16)
            if not chunk:
                break
            buf += chunk
    return parse_response(buf.split(b"\n")[0].decode("utf-8", "replace"))


__all__ = [
    "ServingService",
    "ServingClient",
    "ServingServer",
    "format_response",
    "parse_response",
    "tcp_request",
]
