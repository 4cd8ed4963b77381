"""WAL shipping — the primary half of a replica chain.

Counterpart of ``flink_parameter_server_tpu/replication/shipper.py``, the
reference's code with the port's imports.  Shipping is host work: records
are the WAL's host (numpy) payloads, framed, sent and acked over TCP; the
primary's slice stays on its device, and no kernel runs here.

The replication stream IS the write-ahead log (docs/elastic.md): every
record a primary appends (push deltas, migration ``load`` assignments,
epoch-flip snapshots) is framed exactly as on disk
(:func:`~..resilience.wal.encode_frame` — same magic, same CRC) and
shipped to each follower as one ``repl`` line; the follower's response
line is the ack — ``ok acked seg=<s> seq=<n>`` means the record is
durable in the FOLLOWER's own WAL (not necessarily applied yet;
followers apply asynchronously).

Two paths feed a shipper, and their interplay is what makes shipping
loss-free without ever blocking a write:

  * **fast path** — the primary's :meth:`~..cluster.shard.ParamShard.
    attach_repl_sink` hands each appended record to a :class:`ReplHub`,
    which enqueues it per follower (bounded, non-blocking — it runs
    under the shard lock);
  * **resync path** — on bootstrap, reconnect, or queue overflow the
    shipper re-reads the primary's log from its last acked sequence
    (:meth:`~..cluster.shard.ParamShard.repl_backlog` — starts no
    earlier than the newest snapshot barrier) and ships the tail in
    order.  The follower's WAL append is idempotent by end-sequence,
    so records that raced onto both paths are acked-and-skipped, never
    double-applied.

Per-follower observability (``component=replication``): the
``replication_lag`` gauge is ``primary head − acked seq`` — the exact
number of records a failover would have to recover from somewhere
other than this follower — plus shipped/error counters.

Chaos (``resilience/chaos.py``): a :meth:`FaultPlan.shipper_hook`
injects drop / delay / partition faults into the stream, and
``kill_primary`` fires the caller's kill callback *mid-ship* — the
failover storyline, seeded and fired-once.
"""
from __future__ import annotations

import collections
import threading
from typing import Callable, List, Optional, Tuple

from ..cluster.client import ShardConnection
from ..resilience.wal import encode_frame, encode_frame_bytes
from ..utils import frames as binf

# fast-path queue bound: past this the shipper falls back to a WAL
# resync instead of buffering without bound (the log already holds
# everything; the queue is only a disk-read saver)
_QUEUE_CAP = 4096


class _FollowerQueue:
    """One follower's bounded fast-path queue + wake condition."""

    def __init__(self):
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.items: collections.deque = collections.deque()
        self.overflowed = False

    def offer(self, start_step: int, n_steps: int, payload) -> None:
        with self.lock:
            if len(self.items) >= _QUEUE_CAP:
                # drop to the resync path: mark, clear (the WAL holds
                # the records; buffering more would just duplicate it)
                self.overflowed = True
                self.items.clear()
            else:
                self.items.append((start_step, n_steps, payload))
            self.cond.notify_all()


class ReplHub:
    """The primary-side fan-out a shard's ``_repl_offer`` feeds: one
    bounded queue per subscribed shipper.  ``offer`` is called under
    the shard lock — it only appends and notifies, no I/O."""

    def __init__(self):
        self._lock = threading.Lock()
        self._queues: List[_FollowerQueue] = []

    def subscribe(self) -> _FollowerQueue:
        q = _FollowerQueue()
        with self._lock:
            self._queues.append(q)
        return q

    def unsubscribe(self, q: _FollowerQueue) -> None:
        with self._lock:
            if q in self._queues:
                self._queues.remove(q)

    def offer(self, start_step: int, n_steps: int, payload) -> None:
        with self._lock:
            queues = list(self._queues)
        for q in queues:
            q.offer(start_step, n_steps, payload)


class WALShipper:
    """One (primary, follower) replication leg on its own thread.

    ``fault_hook(shipped_index)`` is the chaos injection point (see
    :meth:`~..resilience.chaos.FaultPlan.shipper_hook`): it may return
    ``"drop"`` (sever the connection — the resync path re-ships, no
    record is lost), ``"partition"`` (pause the stream so follower lag
    grows past the staleness bound), sleep inline for delays, or kill
    the primary mid-ship via its own callback.
    """

    def __init__(
        self,
        primary,
        follower_addr: Tuple[str, int],
        queue: _FollowerQueue,
        *,
        follower_idx: int = 0,
        registry=None,
        fault_hook: Optional[Callable[[int], Optional[str]]] = None,
        connect_timeout: float = 2.0,
        timeout: float = 5.0,
        idle_wait_s: float = 0.05,
        retry_backoff_s: float = 0.02,
        enc: str = "f32",
    ):
        if enc not in ("f32", "q8"):
            raise ValueError(f"enc={enc!r}: 'f32' | 'q8'")
        self.primary = primary
        self.follower_addr = tuple(follower_addr)
        self._queue = queue
        self.follower_idx = int(follower_idx)
        # quantized replication (compression/, docs/compression.md):
        # enc="q8" rewrites each shipped push record's deltas to
        # per-row-scaled int8 with a PER-LEG error-feedback residual —
        # the follower's log and table then track the primary within
        # one quantization granule per id instead of bitwise (the
        # documented trade for ~4× fewer delta bytes on the stream).
        # Loads/snapshots stay bitwise; default "f32" ships exact.
        self.enc = enc
        self._compressor = None
        self.repl_bytes_saved = 0
        if enc == "q8":
            from ..compression.quantizers import DeltaCompressor

            self._compressor = DeltaCompressor("q8")
        self._fault_hook = fault_hook
        self._connect_timeout = float(connect_timeout)
        self._timeout = float(timeout)
        self._idle_wait_s = float(idle_wait_s)
        self._retry_backoff_s = float(retry_backoff_s)
        self._lock = threading.Lock()
        # compress-once cache (q8 legs): end seq → compressed payload.
        # A record that races onto both the fast path and a resync (or
        # re-ships after a drop fault) must deliver the SAME dq bytes,
        # or the leg's residual ledger would double-count the delta.
        self._compressed: "collections.OrderedDict" = (
            collections.OrderedDict()
        )
        self.acked_seq = -1  # end_step durable at the follower
        self.records_shipped = 0
        self.ship_errors = 0
        self._shipped_idx = 0  # ordinal of shipped records (chaos key)
        self._conn: Optional[ShardConnection] = None
        self._need_resync = True
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if registry is not False:
            from ..telemetry.registry import get_registry

            reg = registry if registry is not None else get_registry()
            labels = {
                "shard": str(primary.shard_id),
                "follower": str(self.follower_idx),
            }
            reg.gauge(
                "replication_lag", component="replication",
                fn=self.lag, **labels,
            )
            self._c_shipped = reg.counter(
                "replication_records_shipped_total",
                component="replication", **labels,
            )
            self._c_errors = reg.counter(
                "replication_ship_errors_total",
                component="replication", **labels,
            )
            self._c_repl_saved = (
                reg.counter(
                    "compression_repl_bytes_saved_total",
                    component="compression", **labels,
                )
                if self._compressor is not None else None
            )
        else:
            self._c_shipped = self._c_errors = None
            self._c_repl_saved = None

    # -- observability -------------------------------------------------------
    def lag(self) -> int:
        """``primary head − acked seq``: records a failover could only
        recover from the primary's own (possibly lost) log."""
        with self._lock:
            acked = self.acked_seq
        try:
            head = self.primary.head_seq()
        except Exception:
            return 0
        return max(0, int(head) - max(0, acked))

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "WALShipper":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop,
                name=(
                    f"repl-ship-{self.primary.shard_id}"
                    f"-f{self.follower_idx}"
                ),
                daemon=True,
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._queue.lock:
            self._queue.cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self._close_conn()

    def __enter__(self) -> "WALShipper":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the loop ------------------------------------------------------------
    def _close_conn(self) -> None:
        conn = self._conn
        self._conn = None
        if conn is not None:
            conn.close()

    def _connect(self) -> ShardConnection:
        if self._conn is None:
            # negotiate the binary framing: a shipped record then rides
            # as RAW CRC-framed bytes (no base64 — the same ~33%
            # inflation the pull path shed), with the line protocol as
            # the automatic downgrade against an old follower
            self._conn = ShardConnection(
                self.follower_addr[0], self.follower_addr[1],
                window=8, timeout=self._timeout,
                connect_timeout=self._connect_timeout,
                negotiate=True,
            )
        return self._conn

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                if self._pop_resync():
                    self._resync()
                    continue
                item = self._pop_item()
                if item is None:
                    continue
                self._ship(*item)
            except OSError:
                self._note_error()
                self._stop.wait(self._retry_backoff_s)
            except Exception:  # a poisoned record must not kill the leg
                self._note_error()
                self._stop.wait(self._retry_backoff_s)

    def _note_error(self) -> None:
        self._close_conn()
        with self._lock:
            self.ship_errors += 1
            self._need_resync = True
        if self._c_errors is not None:
            self._c_errors.inc()

    def _pop_resync(self) -> bool:
        with self._lock:
            need = self._need_resync
        with self._queue.lock:
            if self._queue.overflowed:
                self._queue.overflowed = False
                need = True
        if need:
            with self._lock:
                self._need_resync = True
        return need

    def _pop_item(self):
        with self._queue.lock:
            while not self._queue.items:
                if self._stop.is_set():
                    return None
                self._queue.cond.wait(self._idle_wait_s)
                if not self._queue.items:
                    return None  # idle tick: re-check stop/resync flags
            return self._queue.items.popleft()

    def _compress_once(self, end: int, payload):
        """Quantize one push record's deltas exactly once per end seq
        (error feedback must never see the same record twice); re-ships
        return the cached dq bytes so a follower-side duplicate skip
        stays residual-neutral."""
        with self._lock:
            cached = self._compressed.get(end)
        if cached is not None:
            return cached
        from ..compression.quantizers import compress_record_payload

        out, f32_bytes, shipped_bytes = compress_record_payload(
            payload, self._compressor
        )
        with self._lock:
            self._compressed[end] = out
            while len(self._compressed) > 1024:
                self._compressed.popitem(last=False)
            if f32_bytes:
                self.repl_bytes_saved += f32_bytes - shipped_bytes
        if f32_bytes and self._c_repl_saved is not None:
            self._c_repl_saved.inc(f32_bytes - shipped_bytes)
        return out

    def _resync(self) -> None:
        """Re-ship the primary's log tail past the acked cursor — the
        loss-free bootstrap/reconnect path.  Records that also sit on
        the fast-path queue are deduplicated follower-side (WAL append
        idempotence by end seq)."""
        with self._lock:
            acked = self.acked_seq
        backlog = self.primary.repl_backlog(acked)
        for rec in backlog:
            if self._stop.is_set():
                return
            self._ship(rec.start_step, rec.n_steps, rec.payload)
        with self._lock:
            self._need_resync = False

    def _ship(self, start_step: int, n_steps: int, payload) -> None:
        end = int(start_step) + int(n_steps)
        with self._lock:
            if end <= self.acked_seq:
                return  # already durable at the follower
        idx = self._shipped_idx
        if self._fault_hook is not None:
            action = self._fault_hook(idx)
            if action == "drop":
                # sever the stream: the record ships again on resync —
                # delivery is delayed, never lost
                self._note_error()
                return
            # "partition" and delays sleep inside the hook; the stream
            # resumes where it left off
        if self._compressor is not None:
            payload = self._compress_once(end, payload)
        conn = self._connect()
        if conn.proto == "bin":
            req = binf.encode_request(
                binf.VERB_IDS["repl"],
                payload=encode_frame_bytes(start_step, n_steps, payload),
                enc=binf.ENC_RAW,
                tlvs=[(
                    binf.T_HEAD,
                    str(self.primary.head_seq()).encode(),
                )],
            )
            resp = conn.request_many([req])[0]
            if resp.flag != binf.STATUS_OK:
                raise OSError(
                    f"follower rejected repl frame: "
                    f"{resp.status_name} {resp.tlv_str(binf.T_ERR)}"
                )
            acked_seq = int(resp.aux)
        else:
            line = (
                "repl " + encode_frame(start_step, n_steps, payload)
                + f" head={self.primary.head_seq()}"
            )
            resp = conn.request(line)
            if not resp.startswith("ok acked"):
                raise OSError(f"follower rejected repl frame: {resp}")
            acked_seq = end
            for tok in resp.split():
                if tok.startswith("seq="):
                    acked_seq = int(tok[4:])
        with self._lock:
            self.acked_seq = max(self.acked_seq, acked_seq)
            self.records_shipped += 1
            self._shipped_idx = idx + 1
        if self._c_shipped is not None:
            self._c_shipped.inc()


__all__ = ["ReplHub", "WALShipper"]
