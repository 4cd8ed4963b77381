"""A parameter-server shard: one partition slice, served over TCP.

Counterpart of ``flink_parameter_server_tpu/cluster/shard.py``: the wire
protocol, the typed errors, the row encoders, the WAL and the supervisor
are the reference's code.  What changed is the slice: the default
``store_backend="torch"`` keeps it as the port's
:class:`~..core.store.ShardedParamStore` on ``device`` (the card unless
the caller asks for the CPU), pushes scatter into it in place through the
store's ``"xla"`` arm (``ops/rows.accumulate_rows_``: a stable sort and
one ordered sum per run on the card, so replay is bitwise), and the host
read mirror is an explicit copy off the device taken under the shard
lock.  ``store_backend="numpy"`` (what shard processes run) is the
reference's host store unchanged.  ``store_backend="tiered"`` is the
two-tier store (``tierstore/``): the hot tier a bounded tensor on
``device``, cold mutated rows in a host mmap slab, absent rows recomputed
from the deterministic init (on ``device``, as the dense slice is built);
pulls gather through the hot tier and never build the dense host mirror.

The verbs served are those :class:`~.driver.ClusterDriver`, the shard
processes, the elastic control plane (``elastic/``) and the replica
chains (``replication/``) send: pull, push, flush and stats; for live
resharding ``xfer`` / ``load``, epoch fencing, frozen ranges and the
exactly-once ``pid=`` window; for replica chains ``repl`` (one shipped
WAL record, applied by a follower) and ``replstate``, with the answers
``err not-primary`` (a write on a follower) and ``err lagging`` (a read
past a follower's staleness bound).  With the slice on the card, ``xfer``
copies its rows off the device under the same lock as the sequence number
it reports, and ``load``, ``install_epoch`` and a snapshot replay write the
slice tensor on the shard's device and drop the host mirror; a follower's
slice sits on its device like a primary's and applies each shipped record
through the same scatter.  With a hot-key sketch attached (``hotkeys=``,
``telemetry/hotkeys.py``) every pull and push observes its host id array
inside the lock, before any card work.  The hot-key lease board
(``hotcache/leases.py``) is the reference's: ``lease`` reads its rows and
grants under one lock acquisition, copying them off the card (a mirror
rebuild when a push dropped it) under the same lock that reads the
answered ``seq``; every write path (push, a migration load) notes its
host ids on the board, and an epoch flip or a restart queues drop-all.

This is the reference's PS subtask made a real process boundary: shard
``s`` owns exactly the rows ``partitioner.owned_ids(s)`` as a dense
local :class:`~..core.store.ShardedParamStore` slice, and answers
PULL / PUSH / FLUSH over the same newline-delimited TCP idiom as the
serving plane (``serving/server.py``) and the ingest edge
(``data/socket.py``) — the socket skeleton itself comes from
:class:`~..utils.net.LineServer`.

Two framings, one protocol (docs/cluster.md "Binary framing"): the
line protocol below is the bootstrap and compat surface, and a client
may negotiate the LENGTH-PREFIXED BINARY framing per connection with
a first ``hello bin v=1`` line — every verb, option token, and error
reason then maps one-for-one onto ``utils/frames.py`` frames (ids as
raw ``<i8``, rows as raw ``<f4``/bf16 received zero-copy, options as
TLVs, ``err <reason>`` as status bytes), dispatched by
:meth:`ShardServer.respond_frame`.

Wire protocol (one request line → one response line, in order, per
connection).  Every verb accepts trailing ``key=value`` options;
``t=<trace>:<span>`` carries the distributed-trace context
(telemetry/distributed.py; servers without a tracer parse and ignore
it)::

    pull <id1,id2,...> [text|b64] [e=<n>] [t=<tok>]  # ids + answer format
    push <id1,id2,...> <payload> [pid=<t>] [e=<n>] [t=<tok>]  # deltas
    lease <id1,id2,...> [text|b64] sess=<s> [ttl=<r>] [e=<n>]
                                             # atomic read + lease grant
                                             # (hotcache/, docs/hotcache.md)
    revoke <id1,id2,...|all> sess=<s>        # client releases its leases
    xfer <id1,id2,...> [t=<tok>]             # atomic (rows, seq) snapshot
    load <id1,id2,...> <payload>             # row ASSIGNMENT (migration)
    repl <b64-frame> [head=<n>]              # one shipped WAL record
    replstate                                # one-line JSON repl state
    flush                                    # fsync the WAL, ack counters
    stats                                    # one-line JSON shard stats

    ok n=<k> <payload>                    # pull answer
    ok applied=<k> seq=<n>                # push answer
    ok n=<k> seq=<q> ttl=<r> <payload>    # lease answer (rows as-of seq)
    ok revoked=<k>                        # revoke answer
    ok n=<k> seq=<s> <payload>            # xfer answer (always b64)
    ok loaded=<k> seq=<n>                 # load answer
    ok acked seg=<s> seq=<n>              # repl answer (the follower ack:
                                          # durable segment + end seq)
    ok pushes=<n> wal_records=<m>         # flush answer
    err <reason>      # bad-request | crashed | stale-epoch | frozen
                      # | lagging | not-primary | overloaded | internal

Epoch fencing (the elastic/ membership protocol): a shard pins the
partition-map epoch it serves.  A push whose frame epoch is OLDER than
the shard's is rejected with ``err stale-epoch`` — a map flip can
therefore never mix routings: the client refreshes its membership view
and replays the frame against the new map.  A frame from a NEWER epoch is
accepted when its ids route here under either map (the flip is
mid-flight), and answered ``err stale-epoch`` when they don't.  During a
key migration the moving range is FROZEN: pushes touching it get ``err
frozen`` (retry shortly — the flip is imminent); pulls and pushes of
non-moving keys never block.

Hot-key leases (hotcache/, docs/hotcache.md): a frame carrying
``sess=<token>`` declares a lease-capable client session.  ``lease``
answers rows AND registers the session's lease (atomically, as-of
the answered ``seq``); a later push by any OTHER session to a leased
key queues an invalidation that piggybacks on the session's next answer
as a trailing ``inv=<id1,id2,...>`` token (``inv=*`` = drop
everything).  Frames without ``sess=`` never get ``inv=``, so older
clients see nothing they cannot parse.  The lease board is in-memory and
best-effort by design: the client-side staleness bound is the contract.

Exactly-once pushes: a frame carrying ``pid=<token>`` is deduplicated per
``(pid, id)`` against a bounded window that survives crashes (the pairs
ride the WAL records and the install-epoch snapshot, and migration hands
the moving range's pairs to the new owner), so a client retry after a
lost ack — shard died AFTER applying, BEFORE answering — is acked without
double-applying.

Overload shedding (loadgen/overload.py, docs/loadgen.md): with an
``OverloadGuard`` attached to the server, frames may be answered
``err overloaded`` BEFORE parsing once the live request depth passes
the guard's thresholds — serving reads shed first, training pushes
never (by default).  Frames may carry a ``pr=<n>`` priority option (0
critical, 1 normal, 2 sheddable).

Row payloads come in two self-describing encodings, both EXACT (a
pulled row is bitwise the stored fp32 row — what lets a bound-0
cluster land allclose-tight against the single-process table):

  * text — ``;``-separated rows of ``,``-separated ``repr()`` floats
    (``repr`` round-trips the fp32 value exactly); the idiom of the
    serving plane and the one a human types into ``nc``;
  * ``b64:<base64>`` — little-endian fp32 row-major bytes, base64'd.
    ~100× cheaper to encode/decode than per-float text, which on a
    thread-backed single-host cluster is the difference between
    measuring the runtime and measuring ``repr()``.  The client's
    default.

Durability + supervised restart (the resilience wiring): every push is
appended to a per-shard :class:`~..resilience.wal.UpdateWAL` BEFORE it
is applied, keyed by the shard's monotone push sequence (idempotent on
replay).  A crash — real, or injected via :meth:`ParamShard.crash` —
loses the in-memory slice only: :class:`ShardServer` classifies the
failure, backs off per :class:`~..resilience.recovery.RestartPolicy`,
rebuilds the slice from its deterministic init, replays the WAL, and
re-serves the request that found the shard dead.  The recovered slice
is bitwise the pre-crash one (init is deterministic per id; replay
re-applies the exact logged deltas in order).

Per-shard telemetry (``component=cluster``, ``shard=<i>`` labels):
pull/push counters, a live in-flight request-depth gauge, and a
restarts counter — scrapeable mid-run through the shared
``/metrics`` endpoint.
"""
from __future__ import annotations

import base64
import json
import threading
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.transform import to_device, to_host
from ..utils import frames as binf
from ..utils.device import DeviceLike, resolve_device
from ..utils.net import LineServer
from .partition import Partitioner

_MAX_IDS_PER_REQUEST = 1 << 16  # frames stay line-sized; clients chunk


class ShardCrashed(RuntimeError):
    """The shard's in-memory slice is gone (chaos-injected or real);
    tagged so :func:`~..resilience.recovery.classify_failure` routes it
    down the DEVICE branch."""

    failure_class = "device"


class StaleEpoch(RuntimeError):
    """Frame epoch vs shard epoch disagree in a way that cannot be
    served (an old-epoch write, or ids this shard does not own under a
    mixed-flight flip).  Carries the shard's current epoch so the wire
    answer tells the client what to catch up to."""

    def __init__(self, shard_epoch: int, detail: str = ""):
        super().__init__(
            f"stale epoch (shard at {shard_epoch}){': ' + detail if detail else ''}"
        )
        self.shard_epoch = int(shard_epoch)


class FrozenKeys(RuntimeError):
    """The push touches a key range frozen for migration — retry
    shortly; the epoch flip that re-homes the range is imminent."""


class NotPrimary(RuntimeError):
    """A write landed on a replica-chain follower.  Followers absorb
    reads only; the client must route writes to the primary
    (``err not-primary`` on the wire)."""


class FollowerLagging(RuntimeError):
    """A follower's applied state trails the primary's head past the
    read-staleness bound, so serving this read would violate the SSP
    contract — the client falls back to the primary
    (``err lagging lag=<n>`` on the wire)."""

    def __init__(self, lag: int):
        super().__init__(
            f"follower is {lag} records behind the primary head "
            f"(past the staleness bound)"
        )
        self.lag = int(lag)


def format_rows(rows: np.ndarray, encoding: str = "text") -> str:
    """Encode fp32 rows for the wire (see module docstring): ``text``
    uses per-float ``repr`` (exact, human-readable), ``b64`` base64s
    the raw little-endian fp32 bytes (exact, ~100× cheaper)."""
    if encoding == "b64":
        arr = np.ascontiguousarray(np.asarray(rows, "<f4"))
        return "b64:" + base64.b64encode(arr.tobytes()).decode("ascii")
    if encoding != "text":
        raise ValueError(f"encoding={encoding!r}: 'text' | 'b64'")
    rows = np.asarray(rows, np.float64)
    rows = rows.reshape(rows.shape[0], -1) if rows.ndim > 1 else rows.reshape(-1, 1)
    return ";".join(",".join(repr(float(v)) for v in row) for row in rows)


def parse_rows(body: str, value_shape: Tuple[int, ...]) -> np.ndarray:
    """Inverse of :func:`format_rows` (either encoding, self-described
    by the ``b64:`` prefix): ``(n, *value_shape)`` float32."""
    width = 1
    for s in value_shape:
        width *= int(s)
    if body.startswith("b64:"):
        raw = base64.b64decode(body[4:].encode("ascii"))
        flat = np.frombuffer(raw, "<f4")
        if width == 0 or flat.size % width:
            raise ValueError(
                f"b64 payload of {flat.size} floats does not tile value "
                f"shape {value_shape}"
            )
        return flat.reshape((flat.size // width,) + tuple(value_shape)).copy()
    rows = [
        [float(v) for v in row.split(",") if v]
        for row in body.split(";")
        if row
    ]
    arr = np.asarray(rows, np.float32)
    if arr.ndim != 2 or arr.shape[1] != width:
        raise ValueError(
            f"rows of width {arr.shape[1] if arr.ndim == 2 else '?'} do not "
            f"match value shape {value_shape}"
        )
    return arr.reshape((arr.shape[0],) + tuple(value_shape))


def parse_ids(tok: str) -> np.ndarray:
    ids = np.asarray(
        [int(t) for t in tok.split(",") if t.strip()], np.int64
    )
    if ids.size == 0:
        raise ValueError("need at least one id")
    if ids.size > _MAX_IDS_PER_REQUEST:
        raise ValueError(
            f"{ids.size} ids in one request (max {_MAX_IDS_PER_REQUEST}); "
            f"chunk the batch"
        )
    return ids


class _NumpyStore:
    """A host stand-in for :class:`~..core.store.ShardedParamStore`
    with the surface :class:`ParamShard` touches (``from_values`` /
    ``values`` / ``push``) — the store backend shard WORKER PROCESSES
    run (cluster/procs.py): a spawned shard never touches the card and
    pays no per-push device dispatch for a µs scatter-add.
    Single-owner under the shard lock, so ``push`` mutates in place;
    padding lanes (id −1) and out-of-range ids are dropped, matching
    ``ShardedParamStore.push``'s sentinel routing."""

    __slots__ = ("_v",)

    def __init__(self, values: np.ndarray):
        v = np.asarray(values)
        if not v.flags.writeable:
            # a read-only view (e.g. over a broadcast init); push
            # mutates in place
            v = v.copy()
        self._v = v

    @classmethod
    def from_values(cls, values) -> "_NumpyStore":
        return cls(np.array(values, np.float32))

    def values(self) -> np.ndarray:
        return self._v

    def push(self, local_ids, deltas) -> "_NumpyStore":
        ids = np.asarray(local_ids, np.int64)
        ok = (ids >= 0) & (ids < len(self._v))
        if not ok.all():
            ids = ids[ok]
            deltas = np.asarray(deltas)[ok]
        np.add.at(self._v, ids, np.asarray(deltas, self._v.dtype))
        return self


class ParamShard:
    """One shard's state: the local store slice + per-shard WAL.

    Thread-safe: one lock serializes pulls/pushes/restarts (a shard is
    a single logical owner of its rows — the reference's per-subtask
    ``HashMap`` had the same serial discipline, enforced by Flink's
    operator model there and by this lock here).

    ``store_backend`` picks the slice's array runtime: ``"torch"``
    (the default — the port's store on ``device``, the card unless the
    caller asks for the CPU), ``"numpy"`` (plain host arrays; what
    shard worker PROCESSES run — see :class:`_NumpyStore`) or
    ``"tiered"`` (the hot tier a ``tier_hot_rows``-row tensor on
    ``device``, cold rows in an mmap slab, absent rows recomputed from
    the deterministic init — :mod:`~..tierstore`).  All apply identical
    fp32 scatter-adds over client-deduplicated ids, so the slices stay
    bitwise-comparable.  ``"jax"`` (the reference's name for the device
    backend) raises, naming ``"torch"``.
    """

    def __init__(
        self,
        shard_id: int,
        partitioner: Partitioner,
        value_shape: Sequence[int] = (),
        *,
        init_fn=None,
        dtype=None,
        wal_dir: Optional[str] = None,
        wal_fsync_every: int = 0,
        registry=None,
        hotkeys=None,
        profiler=None,
        store_backend: str = "torch",
        device: DeviceLike = None,
        tier_hot_rows: int = 65536,
        tier_slab_dir: Optional[str] = None,
        tier_decay_window: int = 0,
    ):
        if store_backend == "jax":
            raise ValueError(
                "store_backend='jax' is the reference's device backend; "
                "the port's is store_backend='torch' (the slice on "
                "device=, the card by default)"
            )
        if store_backend not in ("torch", "numpy", "tiered"):
            raise ValueError(
                f"store_backend={store_backend!r}: "
                f"'torch' | 'numpy' | 'tiered'"
            )
        if store_backend == "tiered" and dtype is not None:
            raise ValueError(
                "store_backend='tiered' is fp32-only (the tiers must "
                "stay bitwise-comparable with the dense backends)"
            )
        self._backend = store_backend
        self._tier_hot_rows = int(tier_hot_rows)
        self._tier_slab_dir = tier_slab_dir
        self._tier_decay_window = int(tier_decay_window)
        # the numpy backend never touches torch's devices (shard
        # processes must not initialise CUDA)
        self._device = (
            None if store_backend == "numpy" else resolve_device(device)
        )
        self.shard_id = int(shard_id)
        self.partitioner = partitioner
        self.value_shape = tuple(int(s) for s in value_shape)
        # replica-chain role (replication/): a primary absorbs writes
        # and may ship its WAL records to followers via an attached
        # sink; followers override the write surface (see
        # replication/follower.ReplicaShard)
        self.role = "primary"
        self._repl_sink = None
        self._init_fn = init_fn
        self._dtype = dtype
        self.owned = partitioner.owned_ids(self.shard_id)
        self._lock = threading.RLock()
        self._wal = None
        if wal_dir is not None:
            from ..resilience.wal import UpdateWAL

            # fsync cadence 0 by default: shard durability here is about
            # surviving a shard RESTART (process alive, slice lost), the
            # chaos mode tests exercise; page-cache durability suffices
            # and per-push fsyncs would dominate small-push latency
            self._wal = UpdateWAL(wal_dir, fsync_every=wal_fsync_every)
        # hot-key analytics (telemetry/hotkeys.py): with a sketch
        # attached, every pulled/pushed/leased id batch is observed —
        # the host int64 ids, before any card work, never a device tensor
        self.hotkeys = hotkeys
        # hot-key lease board (hotcache/leases.py): grants per client
        # session + the piggybacked invalidation queues.  In-memory and
        # best-effort — the client-side staleness bound is the safety
        # net (docs/hotcache.md)
        from ..hotcache.leases import LeaseBoard

        self.leases = LeaseBoard(shard=self.shard_id, registry=registry)
        # latency-budget phases (telemetry/profiler.py): lock wait =
        # server_queue_wait (concurrent connections serialize on this
        # shard's lock), WAL append, scatter/apply — the server side of
        # the per-round budget.  registry=False implies profiling off.
        from ..telemetry.profiler import NULL_PROFILER, resolve_profiler

        self._profiler = (
            NULL_PROFILER if registry is False and profiler is None
            else resolve_profiler(profiler)
        )
        self.pushes_applied = 0
        self.pulls_served = 0
        self.mirror_rebuilds = 0
        self.mirror_rebuild_s = 0.0
        self.restarts = 0
        self.rows_applied = 0  # delta rows actually applied (post-dedupe)
        self.loads_applied = 0  # rows assigned via load (migration)
        self._push_seq = 0
        # elastic state: the partition-map epoch this shard serves, the
        # key range frozen for an in-flight migration, rows staged for
        # keys this shard will own only after the NEXT epoch flip, and
        # the bounded exactly-once (pid, id) dedupe window
        self.epoch = 0
        self._frozen: Optional[np.ndarray] = None
        self._staged: dict = {}
        self._applied_pairs: dict = {}  # insertion-ordered set w/ cap
        self.pid_window = 1 << 16
        self.store = None
        # host-side read mirror of the slice, rebuilt lazily after each
        # push: pulls are then one numpy fancy-index instead of a
        # device gather + transfer per request; with the slice on the
        # card, the first pull after a push copies the whole slice off
        # the device
        self._host_mirror: Optional[np.ndarray] = None
        self._build()
        if self._wal is not None and self._wal.last_step_logged is not None:
            # fresh process over an existing WAL dir: the restart path
            self._replay()
        # unified plane: per-shard instruments under component=cluster.
        # The request-depth counter is bumped by EVERY connection's
        # handler thread; += on an attribute is not atomic, so it gets
        # its own tiny lock (fpsanalyze S001) — never nested with
        # self._lock, so no ordering edge
        self._active_requests = 0
        self._depth_lock = threading.Lock()
        if registry is not False:
            from ..telemetry.registry import get_registry

            reg = registry if registry is not None else get_registry()
            sid = str(self.shard_id)
            self._c_pulls = reg.counter(
                "cluster_pulls_total", component="cluster", shard=sid
            )
            self._c_pushes = reg.counter(
                "cluster_pushes_total", component="cluster", shard=sid
            )
            self._c_restarts = reg.counter(
                "cluster_shard_restarts_total", component="cluster",
                shard=sid,
            )
            reg.gauge(
                "cluster_shard_queue_depth", component="cluster", shard=sid,
                fn=lambda: self._active_requests,
            )
        else:
            self._c_pulls = self._c_pushes = self._c_restarts = None
        if self._backend == "tiered":
            from ..tierstore import metrics as tier_metrics

            tier_metrics.register_store(self._tier_label(), self.tier_stats)
            if registry is not False:
                tier_metrics.register_instruments(
                    reg, str(self.shard_id), self.tier_stats
                )

    # -- the tiered backend (tierstore/, docs/tierstore.md) ------------------
    def _tier_label(self) -> str:
        """The shard's name on the process-wide ``tiers`` snapshot
        registry; followers append their chain index."""
        fidx = getattr(self, "follower_idx", None)
        label = f"shard-{self.shard_id}"
        return label if fidx is None else f"{label}-f{fidx}"

    def _tier_row_init(self, local_ids: np.ndarray) -> np.ndarray:
        """Deterministic init for LOCAL rows as host float32 — row j is
        the global table's row ``owned[j]``, computed by ``init_fn`` on
        the shard's device exactly as :meth:`_build` computes a dense
        slice, so a recomputed cold miss is bitwise the row a dense
        backend would have materialised."""
        gids = np.asarray(self.owned)[np.asarray(local_ids, np.int64)]
        if self._init_fn is None:
            return np.zeros(gids.shape + self.value_shape, np.float32)
        ids = to_device(gids.astype(np.int32), self._device)
        return to_host(
            torch.as_tensor(self._init_fn(ids)).to(torch.float32)
        )

    def _tier_pinned_local(self) -> np.ndarray:
        """Local ids the tier must never evict: keys frozen for an
        in-flight migration plus every currently-leased key (a lease
        is an invalidation promise — the row is about to be read or
        written again).  Runs under the shard lock during eviction
        scans; the lease board's lock nests strictly under it."""
        gids = self.leases.leased_ids()
        if self._frozen is not None:
            gids = np.union1d(gids, self._frozen)
        if gids.size == 0:
            return gids
        gids = gids[self.partitioner.shard_of(gids) == self.shard_id]
        if gids.size == 0:
            return gids
        return self.partitioner.to_local(self.shard_id, gids)

    def _make_tier_store(self):
        from ..tierstore.store import TieredStore

        return TieredStore(
            len(self.owned),
            self.value_shape,
            row_init=self._tier_row_init,
            hot_rows=self._tier_hot_rows,
            slab_dir=self._tier_slab_dir,
            decay_window=self._tier_decay_window,
            pinned_fn=self._tier_pinned_local,
            name_hint=self._tier_label(),
            device=self._device,
        )

    def tier_stats(self):
        """The tier's instrument snapshot (``None`` on non-tiered
        backends or while crashed) — the ``component=tierstore`` gauge
        source and the TelemetryServer ``tiers`` path payload."""
        with self._lock:
            if self._backend != "tiered" or self.store is None:
                return None
            st = self.store.stats()
            st["shard"] = self.shard_id
            st["role"] = self.role
            return st

    # -- construction / recovery -------------------------------------------
    def _slice_to_host(self) -> np.ndarray:
        """The whole live slice as a fresh host array: an explicit
        copy off the device (callers hold the shard lock, so no push
        lands mid-copy).  The numpy backend hands out its own rows; the
        tiered store materialises init, slab and hot tier on the host."""
        if self._backend in ("numpy", "tiered"):
            return self.store.values()
        return to_host(self.store.values(), copy=True)

    def _store_from_values(self, values: np.ndarray):
        """A store of the configured backend over host ``values`` — the
        one seam every slice re-materialisation (snapshot replay, epoch
        install) goes through.  Under the torch backend the rows are
        copied onto the shard's device in the slice's dtype; the caller
        drops the host mirror.  A tiered store is seeded FRESH from the
        dense rows (only rows differing from init reach the slab) and the
        old slab file is retired."""
        if self._backend == "tiered":
            old = self.store
            st = self._make_tier_store()
            st.seed_dense(np.asarray(values, np.float32))
            if old is not None:
                old.close()
            return st
        if self._backend == "numpy":
            return _NumpyStore.from_values(np.asarray(values))
        from ..core.store import ShardedParamStore

        dtype = self._dtype if self._dtype is not None else torch.float32
        return ShardedParamStore.from_values(
            to_device(np.asarray(values), self._device, dtype),
            device=self._device,
        )

    # fpsanalyze: allow[S001] _build writes run under self._lock at every call site (__init__ construction, restart) — the lock is the caller's
    def _build(self) -> None:
        """(Re)materialise the local slice from the deterministic init:
        local row j = init(owned[j]) — observationally the global
        table's row ``owned[j]`` (same per-id init contract as
        :func:`~..core.store.create_table`).  Under the numpy backend
        ``init_fn`` receives (and must return) host arrays — shard
        worker processes never touch the card; under the torch
        backend it receives an int32 id tensor on ``device``.  The tiered
        backend builds NO dense slice: init is recomputable per id, so
        the store starts empty and rows appear as traffic (or WAL
        replay) touches them."""
        if self._backend == "tiered":
            if self.store is not None:
                self.store.close()
            self.store = self._make_tier_store()
            self._host_mirror = None
            return
        if self._backend == "numpy":
            ids = np.asarray(self.owned, np.int64)
            if self._init_fn is not None:
                values = np.asarray(self._init_fn(ids), np.float32)
            else:
                values = np.zeros(
                    ids.shape + self.value_shape, np.float32
                )
            self.store = _NumpyStore(values)
            self._host_mirror = None
            return
        from ..core.store import ShardedParamStore

        ids = to_device(np.asarray(self.owned, np.int32), self._device)
        if self._init_fn is not None:
            values = torch.as_tensor(self._init_fn(ids)).to(self._device)
        else:
            dtype = self._dtype if self._dtype is not None else torch.float32
            values = torch.zeros(
                tuple(ids.shape) + self.value_shape, dtype=dtype,
                device=self._device,
            )
        if self._dtype is not None:
            values = values.to(self._dtype)
        self.store = ShardedParamStore.from_values(values, device=self._device)
        self._host_mirror = None

    def _replay(self) -> int:
        """Re-apply every intact WAL record in sequence order; returns
        the number replayed.  Replay bypasses the WAL append (the
        records are already durable) but goes through the same
        scatter-add, so the rebuilt slice is bitwise the logged one.

        Records come in three kinds: ``push`` (delta rows — the
        default), ``load`` (row assignments from a migration), and
        ``snapshot`` (the full owned slice, written at each epoch
        flip).  A snapshot SUPERSEDES everything before it — replay
        starts at the newest one, which is also what makes replay safe
        across reshardings: pre-flip records may reference ids this
        shard no longer owns, and the snapshot barrier keeps them out
        of the replay window."""
        from ..compression.quantizers import record_deltas

        from ..resilience.wal import from_newest_snapshot

        n = 0
        for rec in from_newest_snapshot(self._wal.replay()):
            p = rec.payload
            kind = p.get("kind", "push")
            if kind == "snapshot":
                self._restore_snapshot(p)
            elif kind == "load":
                self._assign(
                    np.asarray(p["ids"], np.int64),
                    np.asarray(p["values"], np.float32),
                )
            else:
                ids = np.asarray(p["ids"], np.int64)
                self._apply(ids, record_deltas(p))
                if p.get("pid") is not None:
                    self._remember_pairs(p["pid"], ids)
            self._push_seq = rec.end_step
            n += 1
        return n

    def _restore_snapshot(self, payload: dict) -> None:
        """Rebuild the slice from an epoch-flip snapshot record: the
        logged ids must be exactly the partitioner's owned set for this
        shard (the shard was reconstructed with the post-flip map).  The
        rows go onto the shard's device as a new slice tensor."""
        ids = np.asarray(payload["ids"], np.int64)
        if not np.array_equal(ids, self.owned):
            raise RuntimeError(
                f"shard {self.shard_id}: WAL snapshot owns {len(ids)} "
                f"rows but the partitioner assigns {len(self.owned)} — "
                f"replaying with a different map than the one the "
                f"snapshot was taken under"
            )
        self.store = self._store_from_values(payload["values"])
        self._host_mirror = None
        for pair in payload.get("pairs", ()):
            self._applied_pairs[(pair[0], int(pair[1]))] = None
        self._trim_pairs()

    def _apply(self, global_ids: np.ndarray, deltas: np.ndarray) -> None:
        local = self.partitioner.to_local(self.shard_id, global_ids)
        if self._backend in ("numpy", "tiered"):
            # in place: no shape-specialised kernels, so no pow2
            # bucketing either — padding existed for XLA's compile
            # cache.  (The tiered push ensures residency first and adds
            # on its hot tier's device; rows the hot tier cannot take
            # write through to the slab.)
            self.store.push(local, deltas)
            self._host_mirror = None
            self.pushes_applied += 1
            return
        from ..core.store import push as store_push

        # In place through the store's configured arm (the shard owns
        # its slice, under the lock).  No pow2 padding: it existed for
        # XLA's compile cache, and eager torch compiles nothing per
        # shape; padding lanes (id −1) would reach the store's
        # out-of-range sentinel and change nothing
        # (tests/test_torch_cluster.py holds both bitwise equal).
        store_push(
            self.store.spec, self.store.table,
            to_device(np.asarray(local, np.int64), self._device),
            to_device(
                np.asarray(deltas), self._device, self.store.spec.dtype
            ),
        )
        self._host_mirror = None  # mirror is stale past this point
        self.pushes_applied += 1

    def _assign(self, global_ids: np.ndarray, values: np.ndarray) -> None:
        """Row ASSIGNMENT (the migration load path): owned ids are set
        bitwise in the local slice; ids this shard will own only after
        the next epoch flip are STAGED and folded in at
        :meth:`install_epoch` (scale-in hands a survivor rows it cannot
        address under the pre-flip map).  Under the torch backend the
        owned rows are written into the slice tensor on the device (no
        delta arithmetic touches them) and the host mirror is dropped."""
        ids = np.asarray(global_ids, np.int64)
        values = np.asarray(values, np.float32)
        mine = self.partitioner.shard_of(ids) == self.shard_id
        for gid, row in zip(ids[~mine], values[~mine]):
            self._staged[int(gid)] = np.array(row, np.float32)
        if not mine.any():
            return
        local = self.partitioner.to_local(self.shard_id, ids[mine])
        if self._backend == "tiered":
            # in-place tier write: resident rows update hot (and dirty),
            # cold rows go straight to the slab — a bulk migration load
            # must not thrash the hot tier or materialise the dense table
            self.store.assign(local, values[mine])
            return
        if self._backend == "numpy":
            table = self.store.values()
            table[local] = values[mine].astype(table.dtype)
        else:
            table = self.store.table
            table[to_device(local, self._device)] = to_device(
                values[mine], self._device, table.dtype
            )
        self._host_mirror = None

    def _remember_pairs(self, pid: str, ids: np.ndarray) -> None:
        for gid in ids:
            self._applied_pairs[(pid, int(gid))] = None
        self._trim_pairs()

    def _trim_pairs(self) -> None:
        while len(self._applied_pairs) > self.pid_window:
            self._applied_pairs.pop(next(iter(self._applied_pairs)))

    def _check_alive(self) -> None:
        if self.store is None:
            raise ShardCrashed(f"shard {self.shard_id} has no live slice")

    def _route(self, ids: np.ndarray, epoch: Optional[int]) -> np.ndarray:
        """``to_local`` with epoch-aware failure: a routing miss under a
        mismatched frame epoch is the mixed-flight flip, not a protocol
        bug — answer stale-epoch so the client refreshes and replays."""
        try:
            return self.partitioner.to_local(self.shard_id, ids)
        except KeyError:
            if epoch is not None and epoch != self.epoch:
                raise StaleEpoch(
                    self.epoch, "ids not owned under the frame's map"
                ) from None
            raise

    def _rows(self, local: np.ndarray) -> np.ndarray:
        """Read rows by LOCAL index — the pull-side table access.  Dense
        backends go through the lazily-rebuilt host mirror (one
        fancy-index per request; the rebuild after a push is one copy of
        the slice off the device, under the caller's shard lock); the
        tiered backend gathers through the hot tier (misses promote from
        slab/init) and NEVER builds the dense mirror — that allocation is
        exactly what the tier exists to avoid."""
        if self._backend == "tiered":
            return self.store.gather(local)
        if self._host_mirror is None:
            t0 = time.perf_counter()
            self._host_mirror = self._slice_to_host()
            self.mirror_rebuilds += 1
            self.mirror_rebuild_s += time.perf_counter() - t0
        return self._host_mirror[local]

    # -- the shard protocol ------------------------------------------------
    def pull(
        self, global_ids: np.ndarray, *, epoch: Optional[int] = None
    ) -> np.ndarray:
        prof = self._profiler
        t_wait = time.perf_counter()
        with self._lock:
            prof.observe(
                "pull", "server_queue_wait",
                time.perf_counter() - t_wait,
            )
            self._check_alive()
            ids = np.asarray(global_ids, np.int64)
            local = self._route(ids, epoch)
            if self.hotkeys is not None:
                self.hotkeys.observe(ids)
            with prof.timer("pull", "scatter_apply"):
                # the pull-side table access: host-mirror fancy-index
                # (see _rows)
                vals = self._rows(local)
            self.pulls_served += 1
            if self._c_pulls is not None:
                self._c_pulls.inc()
            return vals

    # -- hot-key leases (hotcache/, docs/hotcache.md) -------------------------
    def lease_rows(
        self,
        global_ids: np.ndarray,
        sess: str,
        *,
        epoch: Optional[int] = None,
        ttl: Optional[int] = None,
    ) -> Tuple[np.ndarray, int, int]:
        """ATOMIC read + lease grant (the ``lease`` verb): the returned
        ``(rows, seq, ttl)`` rows are exactly the state at push
        sequence ``seq``, and from this moment any OTHER session's
        write to these keys queues a piggybacked invalidation for
        ``sess``.  One lock acquisition covers read + grant, so a write
        can never slip between them unobserved; with the slice on the
        card, the rows are copied off it (a mirror rebuild when a push
        dropped the mirror) inside that same acquisition.  ``ttl`` is
        advisory (capped server-side); the client's staleness bound is
        the enforced contract."""
        if not sess:
            raise ValueError("lease needs a sess=<token> option")
        granted_ttl = min(int(ttl), 256) if ttl else 16
        if granted_ttl < 1:
            raise ValueError(f"ttl={ttl}: must be >= 1")
        prof = self._profiler
        t_wait = time.perf_counter()
        with self._lock:
            prof.observe(
                "pull", "server_queue_wait",
                time.perf_counter() - t_wait,
            )
            self._check_alive()
            ids = np.asarray(global_ids, np.int64)
            local = self._route(ids, epoch)
            if self.hotkeys is not None:
                self.hotkeys.observe(ids)
            with prof.timer("pull", "scatter_apply"):
                vals = self._rows(local).copy()
            self.pulls_served += 1
            self.leases.grant(sess, ids)
            if self._c_pulls is not None:
                self._c_pulls.inc()
            return vals, self._push_seq, granted_ttl

    def revoke_leases(self, sess: str, global_ids=None) -> int:
        """Client-requested release (the ``revoke`` verb); ``None`` ids
        releases the whole session (client shutdown)."""
        if not sess:
            raise ValueError("revoke needs a sess=<token> option")
        return self.leases.revoke(sess, global_ids)

    def push(
        self,
        global_ids: np.ndarray,
        deltas: np.ndarray,
        *,
        epoch: Optional[int] = None,
        pid: Optional[str] = None,
        sess: Optional[str] = None,
    ) -> int:
        """WRITE-AHEAD then apply; returns the shard's push sequence
        number after this push.  ``epoch`` fences against stale maps
        (old-epoch writes are rejected, never absorbed); ``pid`` makes
        the push idempotent per ``(pid, id)`` — the already-applied
        subset of a retried frame is acked without re-applying.
        ``sess`` names the writer's lease session so its own leases are
        not invalidation-queued (it invalidated locally at push time;
        every OTHER holder of a written key gets a piggybacked
        ``inv=``)."""
        prof = self._profiler
        t_wait = time.perf_counter()
        with self._lock:
            prof.observe(
                "push", "server_queue_wait",
                time.perf_counter() - t_wait,
            )
            self._check_alive()
            if epoch is not None and epoch < self.epoch:
                raise StaleEpoch(self.epoch, "old-epoch write rejected")
            ids = np.asarray(global_ids, np.int64)
            deltas = np.asarray(deltas, np.float32)
            if self._frozen is not None and np.isin(
                ids, self._frozen
            ).any():
                raise FrozenKeys(
                    f"shard {self.shard_id}: push touches a key range "
                    f"frozen for migration"
                )
            # route check first: a mis-routed id must fail the request
            # BEFORE it is logged (replaying a bad frame would re-raise
            # forever)
            self._route(ids, epoch)
            if self.hotkeys is not None:
                self.hotkeys.observe(ids)
            if pid is not None:
                fresh = np.asarray(
                    [(pid, int(g)) not in self._applied_pairs for g in ids]
                )
                if not fresh.any():
                    return self._push_seq  # full duplicate: ack only
                ids, deltas = ids[fresh], deltas[fresh]
            if self._wal is not None:
                payload = {"ids": ids, "deltas": deltas}
                if pid is not None:
                    payload["pid"] = pid
                with prof.timer("push", "wal_append"):
                    self._wal.append(self._push_seq, 1, payload)
                self._repl_offer(self._push_seq, 1, payload)
            self._push_seq += 1
            with prof.timer("push", "scatter_apply"):
                self._apply(ids, deltas)
            self.rows_applied += int(len(ids))
            # lease invalidation rides the write path: every other
            # session holding a lease on a written key gets an inv=
            # queued (board lock nests strictly under the shard lock;
            # the board takes the host ids, never a device tensor)
            self.leases.note_write(ids, writer=sess)
            if pid is not None:
                self._remember_pairs(pid, ids)
            if self._c_pushes is not None:
                self._c_pushes.inc()
            return self._push_seq

    def flush(self) -> dict:
        """Make the log durable (fsync) and ack the counters — the wire
        protocol's explicit durability point.

        The fsync runs OUTSIDE the shard lock (fpsanalyze B001 fix):
        the WAL serializes appends/syncs internally, so holding the
        shard lock across the disk wait only stalled every concurrent
        pull/push behind the platter.  Every push appended before this
        call's lock window is covered by the sync; a push that slips in
        after the release is made durable EARLY — never lost."""
        with self._lock:
            wal = self._wal
            pushes = self.pushes_applied
        wal_records = 0
        if wal is not None:
            wal.sync()
            wal_records = wal.records_appended
        return {"pushes": pushes, "wal_records": wal_records}

    def values(self) -> np.ndarray:
        """The local slice, rows ordered by :attr:`owned` (ascending
        global id) — the shard's contribution to a model dump."""
        with self._lock:
            self._check_alive()
            return np.asarray(self._slice_to_host())

    # -- elastic membership / migration -------------------------------------
    def snapshot_rows(
        self, global_ids: np.ndarray
    ) -> Tuple[np.ndarray, int]:
        """ATOMIC ``(rows, seq)`` read for migration: the returned rows
        reflect exactly the pushes with sequence ≤ ``seq`` — the WAL
        tail ``> seq`` is precisely what the new owner still needs
        (``xfer`` on the wire).  One lock acquisition covers both
        reads, and the copy off the card (a mirror rebuild when a push
        dropped it) finishes inside it; rows are a copy."""
        with self._lock:
            self._check_alive()
            local = self.partitioner.to_local(
                self.shard_id, np.asarray(global_ids, np.int64)
            )
            return self._rows(local).copy(), self._push_seq

    def assign_rows(
        self, global_ids: np.ndarray, values: np.ndarray
    ) -> int:
        """WAL-logged row ASSIGNMENT (the ``load`` verb): migrated rows
        land bitwise-equal — no delta arithmetic touches them — and the
        log record (kind=``load``) replays the assignment on a crash.
        Ids this shard only owns under the NEXT map are staged (see
        :meth:`_assign`); returns the shard's sequence number after."""
        with self._lock:
            self._check_alive()
            ids = np.asarray(global_ids, np.int64)
            values = np.asarray(values, np.float32)
            if len(ids) != len(values):
                raise ValueError(
                    f"{len(ids)} ids but {len(values)} value rows"
                )
            if self._wal is not None:
                payload = {"kind": "load", "ids": ids, "values": values}
                self._wal.append(self._push_seq, 1, payload)
                self._repl_offer(self._push_seq, 1, payload)
            self._push_seq += 1
            self._assign(ids, values)
            self.loads_applied += int(len(ids))
            # a migration load rewrites rows out-of-band of push: any
            # lease on them is now serving a superseded value
            self.leases.note_write(ids)
            return self._push_seq

    def freeze(self, global_ids) -> None:
        """Freeze a moving key range: pushes touching it raise
        :class:`FrozenKeys` until :meth:`install_epoch` (or
        :meth:`unfreeze`).  Pulls, and pushes of every other key, are
        untouched — non-moving keys never block."""
        with self._lock:
            ids = np.unique(np.asarray(global_ids, np.int64))
            self._frozen = (
                ids if self._frozen is None
                else np.union1d(self._frozen, ids)
            )

    def unfreeze(self) -> None:
        with self._lock:
            self._frozen = None

    def install_epoch(self, epoch: int, partitioner: Partitioner) -> None:
        """The flip: adopt the new partition map at ``epoch``.  The
        slice is compacted to the new owned set — rows kept bitwise,
        staged rows (scale-in inheritance) folded in — and rebuilt as a
        new tensor on the shard's device (the host mirror is dropped, so
        no pull serves a pre-flip row), the freeze lifts, and a
        ``snapshot`` barrier record makes the post-flip WAL
        self-contained (replay never crosses a resharding)."""
        with self._lock:
            self._check_alive()
            if int(epoch) <= self.epoch:
                raise ValueError(
                    f"install_epoch({epoch}): shard {self.shard_id} "
                    f"already at epoch {self.epoch} (epochs are monotone)"
                )
            new_owned = partitioner.owned_ids(self.shard_id)
            current = self._slice_to_host()
            pos = np.searchsorted(self.owned, new_owned)
            have = (pos < len(self.owned)) & (
                self.owned[np.minimum(pos, len(self.owned) - 1)]
                == new_owned
            ) if len(self.owned) else np.zeros(len(new_owned), bool)
            rows = np.empty(
                (len(new_owned),) + current.shape[1:], current.dtype
            )
            rows[have] = current[pos[have]]
            for j in np.nonzero(~have)[0]:
                gid = int(new_owned[j])
                if gid not in self._staged:
                    raise KeyError(
                        f"shard {self.shard_id}: epoch {epoch} assigns "
                        f"id {gid} here but no row was migrated in"
                    )
                rows[j] = self._staged[gid]
            self.partitioner = partitioner
            self.owned = new_owned
            self.store = self._store_from_values(rows)
            self._host_mirror = None
            self._staged = {}
            self._frozen = None
            self.epoch = int(epoch)
            # a resharding may re-home leased keys: queue drop-all for
            # every session (clients also clear on membership refresh)
            self.leases.drop_all()
            if self._wal is not None:
                barrier = self._push_seq
                payload = {
                    "kind": "snapshot",
                    "ids": new_owned,
                    "values": rows,
                    "pairs": list(self._applied_pairs),
                }
                self._wal.append(barrier, 1, payload)
                self._repl_offer(barrier, 1, payload)
                self._push_seq += 1
                # older segments are fully superseded by the barrier —
                # best-effort bound on the log (whole segments only)
                self._wal.truncate_through(barrier)

    def retire(self, epoch: int) -> None:
        """Drain-and-retire terminal state: the shard stops accepting
        writes (everything frozen, epoch bumped so old-epoch frames
        answer stale-epoch) but keeps serving reads until its server is
        stopped — in-flight old-map pulls drain instead of erroring."""
        with self._lock:
            self.epoch = int(epoch)
            self._frozen = np.asarray(self.owned, np.int64)

    def applied_pairs_for(self, global_ids) -> list:
        """The exactly-once ``(pid, id)`` pairs covering the given ids
        — migration hands these to the new owner so a retried push of a
        moved key stays deduplicated across the flip."""
        with self._lock:
            wanted = set(int(g) for g in np.asarray(global_ids).reshape(-1))
            return [
                pair for pair in self._applied_pairs if pair[1] in wanted
            ]

    def merge_applied_pairs(self, pairs) -> None:
        with self._lock:
            for pid, gid in pairs:
                self._applied_pairs[(pid, int(gid))] = None
            self._trim_pairs()

    def peek_rows(self, global_ids) -> np.ndarray:
        """Read rows for migration verification regardless of where
        they live: owned rows from the slice (through the host mirror),
        incoming rows from the staging area — the pre-flip view of what
        :meth:`install_epoch` will own."""
        with self._lock:
            self._check_alive()
            ids = np.asarray(global_ids, np.int64)
            mine = self.partitioner.shard_of(ids) == self.shard_id
            out = None
            if mine.any():
                local = self.partitioner.to_local(self.shard_id, ids[mine])
                rows = self._rows(local)
                out = np.empty((len(ids),) + rows.shape[1:], rows.dtype)
                out[mine] = rows
            else:
                out = np.empty((len(ids),) + self.value_shape, np.float32)
            for j in np.nonzero(~mine)[0]:
                gid = int(ids[j])
                if gid not in self._staged:
                    raise KeyError(
                        f"shard {self.shard_id}: id {gid} neither owned "
                        f"nor staged"
                    )
                out[j] = self._staged[gid]
            return out

    def wal_tail(self, after_seq: int, global_ids=None) -> list:
        """The shard's WAL records after ``after_seq`` (push-sequence
        space), keyed-filtered to ``global_ids`` — the migration tail
        (:meth:`~..resilience.wal.UpdateWAL.replay_range`).  Empty when
        the shard runs without a WAL."""
        if self._wal is None:
            return []
        return self._wal.replay_range(after_seq, global_ids)

    # -- replica chains (replication/) ---------------------------------------
    def attach_repl_sink(self, sink) -> None:
        """Attach the replication fan-out: every WAL record this shard
        appends from here on is also handed to ``sink.offer(start,
        n_steps, payload)`` — the primary half of the ``repl`` stream.
        The sink must be non-blocking (it is called under the shard
        lock); the :class:`~..replication.shipper.ReplHub` queues and
        lets shipper threads do the socket work."""
        with self._lock:
            self._repl_sink = sink

    def detach_repl_sink(self) -> None:
        with self._lock:
            self._repl_sink = None

    def _repl_offer(self, start_step: int, n_steps: int, payload) -> None:
        sink = self._repl_sink
        if sink is not None:
            try:
                sink.offer(start_step, n_steps, payload)
            except Exception:  # replication must never fail a write
                pass

    def head_seq(self) -> int:
        """The primary's current push-sequence head — what a follower's
        lag is measured against (rides ``repl`` frames as ``head=``)."""
        with self._lock:
            return self._push_seq

    def repl_backlog(self, after_seq: int) -> list:
        """The shippable WAL tail: records with ``end_step >
        after_seq``, starting no earlier than the newest snapshot
        barrier (a snapshot supersedes everything before it — shipping
        pre-barrier records to a follower built under the current map
        would reference ids it cannot route).  The shipper's resync
        path: bootstrap (``after_seq=-1``) and reconnect both land
        here."""
        if self._wal is None:
            return []
        from ..resilience.wal import from_newest_snapshot

        return [r for r in from_newest_snapshot(self._wal.replay()) if r.end_step > after_seq]

    def apply_repl(self, record, head=None) -> dict:
        """Receive one shipped WAL record (the ``repl`` verb).  Only a
        follower accepts the stream; the base (primary) shard rejects
        it as a routing error — see
        :class:`~..replication.follower.ReplicaShard`."""
        raise ValueError(
            f"shard {self.shard_id} is a {self.role}, not a replication "
            f"follower — repl frames route to followers only"
        )

    def repl_state(self) -> dict:
        """One-line replication state (the ``replstate`` verb): role +
        the sequence cursors a failover decision reads.  Followers
        override with their lag figures."""
        with self._lock:
            return {
                "shard": self.shard_id,
                "role": self.role,
                "seq": self._push_seq,
                "epoch": self.epoch,
            }

    # -- failure / recovery -------------------------------------------------
    def crash(self) -> None:
        """Chaos hook: drop the in-memory slice (the WAL survives — it
        is the durable part).  Every subsequent request raises
        :class:`ShardCrashed` until :meth:`restart`."""
        with self._lock:
            if self._backend == "tiered" and self.store is not None:
                # the slab is part of the slice (a cache, not a
                # durability plane) — a crash loses it with the hot
                # rows, and replay repopulates the mutated set
                self.store.close()
            self.store = None
            self._host_mirror = None

    def restart(self) -> int:
        """Rebuild init + replay the WAL; returns records replayed."""
        with self._lock:
            self._push_seq = 0
            self.pushes_applied = 0
            self._build()
            replayed = self._replay() if self._wal is not None else 0
            # the board did not see writes replayed from the WAL —
            # conservatively drop every remembered session's leases
            # (holders fall back to their local staleness bound)
            self.leases.drop_all()
            self.restarts += 1
            if self._c_restarts is not None:
                self._c_restarts.inc()
            return replayed

    def stats(self) -> dict:
        with self._lock:
            out = {
                "shard": self.shard_id,
                "rows": int(len(self.owned)),
                "pulls": self.pulls_served,
                "pushes": self.pushes_applied,
                "push_seq": self._push_seq,
                "restarts": self.restarts,
                "alive": self.store is not None,
                "epoch": self.epoch,
                "rows_applied": self.rows_applied,
                "loads_applied": self.loads_applied,
                "frozen": (
                    0 if self._frozen is None else int(len(self._frozen))
                ),
                "staged": len(self._staged),
                # the exactly-once dedupe window's current size (bounded
                # by pid_window)
                "dedupe_pairs": len(self._applied_pairs),
                # live depth figure the psctl stats view reads: WAL
                # records durably appended
                "wal_records": (
                    0 if self._wal is None else self._wal.records_appended
                ),
                # the host mirror's rebuilds (one device-to-host copy
                # of the slice each) and their summed wall seconds
                "backend": self._backend,
                "mirror_rebuilds": self.mirror_rebuilds,
                "mirror_rebuild_s": self.mirror_rebuild_s,
                # hot-key lease board depth (hotcache/, psctl hot)
                "lease_sessions": self.leases.sessions(),
                "leases_active": self.leases.active_leases(),
            }
            if self._backend == "tiered" and self.store is not None:
                out["tier"] = self.store.stats()
            return out

    def close(self) -> None:
        if self._backend == "tiered":
            from ..tierstore import metrics as tier_metrics

            tier_metrics.unregister_store(self._tier_label())
            with self._lock:
                if self.store is not None:
                    self.store.close()
                    self.store = None
        if self._wal is not None:
            self._wal.close()


class ShardServer(LineServer):
    """TCP front end + restart supervisor for one :class:`ParamShard`.

    The supervisor loop is the shard-side analogue of
    :class:`~..resilience.recovery.RecoveringDriver`: a request that
    finds the slice dead triggers backoff (capped exponential, jittered
    per :class:`~..resilience.recovery.RestartPolicy`) + rebuild-and-
    replay, then the request is served from the recovered slice — the
    CLIENT never sees the crash, only latency.  ``supervised=False``
    turns the same condition into an ``err crashed`` response (the
    client-visible failure mode).
    """

    def __init__(
        self,
        shard: ParamShard,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        supervised: bool = True,
        restart_policy=None,
        max_line_bytes: int = 64 << 20,
        tracer=None,
        profiler=None,
        overload=None,
        enable_shm: bool = True,
    ):
        super().__init__(
            host, port, name=f"shard-{shard.shard_id}",
            max_line_bytes=max_line_bytes,
        )
        # accept "hello shm v=1" (shmem/): co-located clients hand the
        # data plane to a shared-memory ring pair; False answers the
        # downgrade err and every client falls back to binary TCP
        self.shm_enabled = bool(enable_shm)
        self.shard = shard
        self.supervised = supervised
        # overload-plane admission (loadgen/overload.OverloadGuard):
        # with a guard attached, sheddable frames are answered
        # ``err overloaded`` BEFORE parse/lock/apply once the live
        # request depth passes the guard's thresholds — serving
        # reads shed first, training pushes never (by default).  None
        # = admit everything (the pre-overload behaviour).
        self.overload = overload
        # latency-budget phases (telemetry/profiler.py): whole-request
        # server wall (the "wire" residual's subtrahend), inbound parse
        # and response serialize — default to the shard's profiler so
        # client+server phases land in one budget
        from ..telemetry.profiler import resolve_profiler

        self.profiler = (
            shard._profiler if profiler is None
            else resolve_profiler(profiler)
        )
        # server-side spans (telemetry/distributed.py): each request is
        # wrapped in a span tagged with the inbound t=<trace>:<span>
        # context, so this process's ring can be merged into the
        # client's trace by the TraceCollector
        self.tracer = tracer
        if restart_policy is None:
            from ..resilience.recovery import RestartPolicy

            # tight backoff: a shard restart is rebuild+replay, not a
            # process respawn; tests and thread-backed clusters should
            # not serialize on seconds of sleep
            restart_policy = RestartPolicy(
                max_restarts=3, backoff_base_s=0.01, backoff_cap_s=0.5,
                seed=shard.shard_id,
            )
        self.policy = restart_policy
        self._rng = np.random.default_rng(self.policy.seed)

    # -- the protocol ------------------------------------------------------
    @staticmethod
    def _frame_priority(toks) -> Optional[int]:
        """The ``pr=<n>`` priority token from a frame's trailing
        options (scanned from the end, same discipline as
        :meth:`_inbound_trace`: payload tokens stop the scan).
        Malformed values yield None — priority must never be able to
        fail a request."""
        for t in reversed(toks[1:]):
            k, sep, v = t.partition("=")
            if not sep or not k.isalnum():
                break
            if k == "pr":
                try:
                    return int(v)
                except ValueError:
                    return None
        return None

    def respond(self, line: str) -> str:
        with self.shard._depth_lock:
            self.shard._active_requests += 1
            depth = self.shard._active_requests
        verb = line.split(None, 1)[0].lower() if line else ""
        t0 = time.perf_counter()
        try:
            guard = self.overload
            if guard is not None and not guard.admit(
                verb, self._frame_priority(line.split()), depth
            ):
                # typed shed (docs/loadgen.md): rejected before the
                # request pays parse/lock/apply — overload must make
                # rejection the CHEAPEST path through the server
                return "err overloaded"
            return self._respond_supervised(line)
        finally:
            with self.shard._depth_lock:
                self.shard._active_requests -= 1
            if verb in ("pull", "push"):
                # the whole-request server wall: what the client's RTT
                # minus this equals is the wire cost (profiler budget)
                self.profiler.observe(
                    verb, "server_total", time.perf_counter() - t0
                )

    def _respond_supervised(self, line: str) -> str:
        attempt = 0
        while True:
            try:
                return self._dispatch(line)
            except ShardCrashed:
                if not self.supervised:
                    return "err crashed"
                attempt += 1
                if attempt > self.policy.max_restarts:
                    return "err crashed: restart budget exhausted"
                time.sleep(self.policy.backoff_s(attempt, self._rng))
                self.shard.restart()
            except StaleEpoch as e:
                return f"err stale-epoch epoch={e.shard_epoch}"
            except FrozenKeys:
                return "err frozen"
            except FollowerLagging as e:
                return f"err lagging lag={e.lag}"
            except NotPrimary:
                return "err not-primary"
            except (ValueError, KeyError) as e:
                return f"err bad-request: {e}"
            except Exception as e:  # noqa: BLE001 — protocol boundary
                return f"err internal: {type(e).__name__}: {e}"

    @staticmethod
    def _parse_opts(toks) -> dict:
        """Trailing ``key=value`` option tokens (``e=<epoch>``,
        ``pid=<token>``, ``sess=<token>``, ``ttl=<rounds>``; ``t=`` and
        ``pr=`` are read elsewhere, and unknown keys parse and are
        ignored)."""
        opts = {}
        for t in toks:
            k, sep, v = t.partition("=")
            if not sep or not k:
                raise ValueError(f"bad option token {t!r} (key=value)")
            opts[k] = v
        epoch = opts.pop("e", None)
        if epoch is not None:
            try:
                opts["e"] = int(epoch)
            except ValueError:
                raise ValueError(f"e={epoch!r}: epoch must be an integer")
        return opts

    @staticmethod
    def _inbound_trace(toks):
        """The ``t=<trace>:<span>`` token from a frame's trailing
        options (scanned from the end; payload tokens — which may
        contain base64 ``=`` padding behind their ``b64:`` prefix —
        stop the scan).  Malformed tokens yield None, never an error:
        tracing must not be able to fail a request."""
        from ..telemetry.distributed import parse_token

        for t in reversed(toks[1:]):
            k, sep, v = t.partition("=")
            if not sep or not k.isalnum():
                break
            if k == "t":
                return parse_token(v)
        return None

    def _dispatch(self, line: str) -> str:
        tr = self.tracer
        if tr is None or not tr.enabled:
            return self._execute(line)
        toks = line.split()
        cmd = toks[0].lower() if toks else "empty"
        ctx = self._inbound_trace(toks)
        kwargs = (
            {"trace_id": ctx.trace_id, "parent_id": ctx.span_id}
            if ctx is not None else {}
        )
        with tr.span(f"shard.{cmd}", "cluster", **kwargs):
            return self._execute(line)

    def _with_inv(self, resp: str, opts: dict) -> str:
        """Piggyback pending lease invalidations for the frame's
        session as a trailing ``inv=`` token (docs/hotcache.md).  Only
        frames that declared ``sess=`` ever get one, so pre-hotcache
        clients never see a token they cannot parse."""
        sess = opts.get("sess")
        if sess is None:
            return resp
        inv = self.shard.leases.take_invalidations(sess)
        if inv:
            resp += f" inv={inv}"
        return resp

    def _execute(self, line: str) -> str:
        toks = line.split()
        cmd = toks[0].lower()
        if cmd == "hello":
            # binary-framing negotiation (docs/cluster.md "Binary
            # framing", utils/frames.py): "hello bin v=1" → "ok
            # proto=bin v=1", and the connection accepts binary frames
            # from then on (the net layer flips the conn ledger's
            # proto on this exact answer).
            if len(toks) >= 2 and toks[1].lower() == "bin":
                # the answer advertises the quantized-encoding
                # vocabulary (enc=bf16,q8 — docs/compression.md): old
                # clients check the "ok proto=bin" prefix only, new
                # clients downgrade unadvertised encodings to f32
                return binf.hello_ok_line()
            # "hello shm" lands here only when shm is DISABLED (the
            # enabled path is intercepted in LineServer._serve_one) —
            # the err answer is what drives the client's TCP fallback
            raise ValueError(
                f"unknown protocol {' '.join(toks[1:])!r} (try: bin)"
            )
        if cmd == "pull":
            if len(toks) < 2:
                raise ValueError("usage: pull <id1,id2,...> [text|b64]")
            rest = toks[2:]
            enc = "text"
            if rest and rest[0].lower() in ("text", "b64"):
                enc = rest[0].lower()
                rest = rest[1:]
            elif rest and "=" not in rest[0]:
                raise ValueError(f"pull format {rest[0]!r}: 'text' | 'b64'")
            opts = self._parse_opts(rest)
            with self.profiler.timer("pull", "server_parse"):
                ids = parse_ids(toks[1])
            vals = self.shard.pull(ids, epoch=opts.get("e"))
            with self.profiler.timer("pull", "response_serialize"):
                body = format_rows(vals, enc)
            return self._with_inv(f"ok n={len(ids)} {body}", opts)
        if cmd == "push":
            if len(toks) < 3:
                raise ValueError(
                    "usage: push <id1,id2,...> <row1;row2;...>"
                )
            with self.profiler.timer("push", "server_parse"):
                ids = parse_ids(toks[1])
                deltas = parse_rows(toks[2], self.shard.value_shape)
            if len(deltas) != len(ids):
                raise ValueError(
                    f"{len(ids)} ids but {len(deltas)} delta rows"
                )
            opts = self._parse_opts(toks[3:])
            seq = self.shard.push(
                ids, deltas, epoch=opts.get("e"), pid=opts.get("pid"),
                sess=opts.get("sess"),
            )
            return self._with_inv(f"ok applied={len(ids)} seq={seq}", opts)
        if cmd == "lease":
            # atomic read + lease grant (hotcache/, docs/hotcache.md):
            # answered rows are exactly the state at the answered seq
            if len(toks) < 2:
                raise ValueError(
                    "usage: lease <id1,id2,...> [text|b64] sess=<token> "
                    "[ttl=<rounds>] [e=<epoch>]"
                )
            rest = toks[2:]
            enc = "text"
            if rest and rest[0].lower() in ("text", "b64"):
                enc = rest[0].lower()
                rest = rest[1:]
            elif rest and "=" not in rest[0]:
                raise ValueError(
                    f"lease format {rest[0]!r}: 'text' | 'b64'"
                )
            opts = self._parse_opts(rest)
            ids = parse_ids(toks[1])
            ttl = opts.get("ttl")
            if ttl is not None:
                try:
                    ttl = int(ttl)
                except ValueError:
                    raise ValueError(
                        f"ttl={ttl!r}: must be an integer"
                    ) from None
            vals, seq, ttl = self.shard.lease_rows(
                ids, opts.get("sess"), epoch=opts.get("e"), ttl=ttl,
            )
            body = format_rows(vals, enc)
            return self._with_inv(
                f"ok n={len(ids)} seq={seq} ttl={ttl} {body}", opts
            )
        if cmd == "revoke":
            if len(toks) < 2:
                raise ValueError(
                    "usage: revoke <id1,id2,...|all> sess=<token>"
                )
            opts = self._parse_opts(toks[2:])
            ids = None if toks[1].lower() == "all" else parse_ids(toks[1])
            n = self.shard.revoke_leases(opts.get("sess"), ids)
            return f"ok revoked={n}"
        if cmd == "xfer":
            if len(toks) < 2:
                raise ValueError("usage: xfer <id1,id2,...> [t=<token>]")
            ids = parse_ids(toks[1])
            self._parse_opts(toks[2:])  # trace token etc.; validated only
            vals, seq = self.shard.snapshot_rows(ids)
            return f"ok n={len(ids)} seq={seq} {format_rows(vals, 'b64')}"
        if cmd == "load":
            if len(toks) < 3:
                raise ValueError("usage: load <id1,id2,...> <payload>")
            ids = parse_ids(toks[1])
            vals = parse_rows(toks[2], self.shard.value_shape)
            if len(vals) != len(ids):
                raise ValueError(
                    f"{len(ids)} ids but {len(vals)} value rows"
                )
            self._parse_opts(toks[3:])  # validate; load is controller-driven
            seq = self.shard.assign_rows(ids, vals)
            return f"ok loaded={len(ids)} seq={seq}"
        if cmd == "repl":
            # the replication stream (replication/shipper.py): one WAL
            # record, CRC-framed exactly as on disk, applied by a
            # follower; the response line IS the (segment, seq) ack
            if len(toks) < 2:
                raise ValueError("usage: repl <b64-frame> [head=<n>]")
            from ..resilience.wal import decode_frame

            opts = self._parse_opts(toks[2:])
            head = opts.get("head")
            if head is not None:
                try:
                    head = int(head)
                except ValueError:
                    raise ValueError(
                        f"head={head!r}: must be an integer"
                    ) from None
            rec = decode_frame(toks[1])
            ack = self.shard.apply_repl(rec, head=head)
            return (
                f"ok acked seg={ack['seg']} seq={ack['seq']} "
                f"applied={ack['applied']}"
            )
        if cmd == "replstate":
            return "ok " + json.dumps(self.shard.repl_state())
        if cmd == "flush":
            f = self.shard.flush()
            return f"ok pushes={f['pushes']} wal_records={f['wal_records']}"
        if cmd == "stats":
            return "ok " + json.dumps(self.shard.stats())
        if cmd == "conns":
            # psctl debug verb: the live per-connection wire ledger
            # (utils/net.py ConnStats) of THIS shard's front end
            return "ok " + json.dumps(self.conn_table())
        raise ValueError(
            f"unknown command {cmd!r} (pull|push|lease|revoke|xfer|load"
            f"|repl|replstate|flush|stats|conns)"
        )

    # -- the binary frame protocol (utils/frames.py) -------------------------
    def respond_frame(self, data: bytes) -> bytes:
        """One binary request frame → one encoded response frame —
        the binary twin of :meth:`respond`.  The overload guard admits
        or sheds on the HEADER alone (verb id + priority byte), before
        any TLV/id/payload work: under pressure, rejection stays the
        cheapest path through the server, now without even a text
        parse in front of it."""
        with self.shard._depth_lock:
            self.shard._active_requests += 1
            depth = self.shard._active_requests
        verb = "other"
        t0 = time.perf_counter()
        try:
            try:
                verb_id, _enc, prio, _total = binf.peek_header(data)
            except binf.FrameError as e:
                return binf.error_response(
                    0, binf.STATUS_BAD_REQUEST, str(e)
                )
            verb = binf.VERB_NAMES.get(verb_id, "other")
            guard = self.overload
            if guard is not None and not guard.admit(
                verb,
                None if prio == binf.NO_PRIORITY else int(prio),
                depth,
            ):
                return binf.error_response(
                    verb_id, binf.STATUS_OVERLOADED
                )
            return self._respond_frame_supervised(data, verb_id, verb)
        finally:
            with self.shard._depth_lock:
                self.shard._active_requests -= 1
            if verb in ("pull", "push"):
                self.profiler.observe(
                    verb, "server_total", time.perf_counter() - t0
                )

    def _respond_frame_supervised(
        self, data: bytes, verb_id: int, verb: str
    ) -> bytes:
        attempt = 0
        while True:
            try:
                req = binf.decode(data, kind="request")
                return self._dispatch_frame(req)
            except ShardCrashed:
                if not self.supervised:
                    return binf.error_response(
                        verb_id, binf.STATUS_CRASHED
                    )
                attempt += 1
                if attempt > self.policy.max_restarts:
                    return binf.error_response(
                        verb_id, binf.STATUS_CRASHED,
                        "restart budget exhausted",
                    )
                time.sleep(self.policy.backoff_s(attempt, self._rng))
                self.shard.restart()
            except StaleEpoch as e:
                return binf.error_response(
                    verb_id, binf.STATUS_STALE_EPOCH,
                    tlvs=[(binf.T_EPOCH, str(e.shard_epoch).encode())],
                )
            except FrozenKeys:
                return binf.error_response(verb_id, binf.STATUS_FROZEN)
            except FollowerLagging as e:
                return binf.error_response(
                    verb_id, binf.STATUS_LAGGING,
                    tlvs=[(binf.T_LAG, str(e.lag).encode())],
                )
            except NotPrimary:
                return binf.error_response(
                    verb_id, binf.STATUS_NOT_PRIMARY
                )
            except (binf.FrameError, ValueError, KeyError) as e:
                return binf.error_response(
                    verb_id, binf.STATUS_BAD_REQUEST, str(e)
                )
            except Exception as e:  # noqa: BLE001 — protocol boundary
                return binf.error_response(
                    verb_id, binf.STATUS_INTERNAL,
                    f"{type(e).__name__}: {e}",
                )

    def _dispatch_frame(self, req) -> bytes:
        tr = self.tracer
        if tr is None or not tr.enabled:
            return self._execute_frame(req)
        from ..telemetry.distributed import parse_token

        tok = req.tlv_str(binf.T_TRACE)
        ctx = parse_token(tok) if tok else None
        kwargs = (
            {"trace_id": ctx.trace_id, "parent_id": ctx.span_id}
            if ctx is not None else {}
        )
        with tr.span(f"shard.{req.verb_name}", "cluster", **kwargs):
            return self._execute_frame(req)

    @staticmethod
    def _frame_ids(req) -> np.ndarray:
        """The request's id section with the line protocol's bounds
        (at least one id, frames stay bounded) — ZERO-COPY ``<i8``
        over the receive buffer."""
        ids = req.ids
        if ids is None or ids.size == 0:
            raise ValueError("need at least one id")
        if ids.size > _MAX_IDS_PER_REQUEST:
            raise ValueError(
                f"{ids.size} ids in one request (max "
                f"{_MAX_IDS_PER_REQUEST}); chunk the batch"
            )
        return ids

    @staticmethod
    def _row_enc(req) -> int:
        """The row encoding the answer should use — the request's own
        (fp32 default; bf16 when the client asked for it)."""
        return (
            req.enc if req.enc in (binf.ENC_F32, binf.ENC_BF16)
            else binf.ENC_F32
        )

    def _inv_tlvs(self, sess: Optional[str]) -> list:
        """Piggybacked lease invalidations as a response TLV — only
        for frames that declared a session, exactly like the line
        protocol's trailing ``inv=`` token (docs/hotcache.md)."""
        if sess is None:
            return []
        inv = self.shard.leases.take_invalidations(sess)
        return [] if not inv else [(binf.T_INV, inv.encode())]

    def _execute_frame(self, req) -> bytes:
        """The binary dispatch: same verbs, same shard methods, no
        text — ids arrive as raw ``<i8``, rows as raw ``<f4``/bf16
        (zero-copy views; the upload to the slice's device copies
        them), and the answer's rows leave as raw bytes again."""
        shard = self.shard
        verb = req.verb
        epoch = None if req.aux == binf.NO_EPOCH else int(req.aux)
        sess = req.tlv_str(binf.T_SESS)
        if verb == binf.VERB_IDS["pull"]:
            with self.profiler.timer("pull", "server_parse"):
                ids = self._frame_ids(req)
            vals = shard.pull(ids, epoch=epoch)
            enc = self._row_enc(req)
            with self.profiler.timer("pull", "response_serialize"):
                resp = binf.encode_response(
                    verb, n=int(ids.size), enc=enc,
                    payload=binf.rows_to_payload(vals, enc),
                    tlvs=self._inv_tlvs(sess),
                )
            return resp
        if verb == binf.VERB_IDS["push"]:
            with self.profiler.timer("push", "server_parse"):
                ids = self._frame_ids(req)
                if req.enc == binf.ENC_Q8:
                    # per-row-scaled int8 deltas (the quantized push
                    # path, docs/compression.md): int8 payload + f32
                    # scales in the T_SCALE TLV, dequantized host-side
                    # — the applied rows are exactly the dq values the
                    # client computed its residual against
                    from ..compression.quantizers import q8_from_payload

                    deltas = q8_from_payload(
                        req.payload, req.tlvs.get(binf.T_SCALE),
                        shard.value_shape,
                    )
                else:
                    deltas = binf.rows_from_payload(
                        req.payload, shard.value_shape, req.enc
                    )
            if len(deltas) != len(ids):
                raise ValueError(
                    f"{len(ids)} ids but {len(deltas)} delta rows"
                )
            seq = shard.push(
                ids, deltas, epoch=epoch,
                pid=req.tlv_str(binf.T_PID), sess=sess,
            )
            with self.profiler.timer("push", "response_serialize"):
                resp = binf.encode_response(
                    verb, aux=seq, n=int(ids.size), enc=binf.ENC_RAW,
                    tlvs=self._inv_tlvs(sess),
                )
            return resp
        if verb == binf.VERB_IDS["lease"]:
            ids = self._frame_ids(req)
            vals, seq, ttl = shard.lease_rows(
                ids, sess, epoch=epoch, ttl=req.tlv_int(binf.T_TTL),
            )
            enc = self._row_enc(req)
            return binf.encode_response(
                verb, aux=seq, n=int(ids.size), enc=enc,
                payload=binf.rows_to_payload(vals, enc),
                tlvs=[(binf.T_TTL, str(ttl).encode())]
                + self._inv_tlvs(sess),
            )
        if verb == binf.VERB_IDS["revoke"]:
            ids = None if req.n == 0 else self._frame_ids(req)
            n = shard.revoke_leases(sess, ids)
            return binf.encode_response(verb, n=n, enc=binf.ENC_RAW)
        if verb == binf.VERB_IDS["xfer"]:
            ids = self._frame_ids(req)
            vals, seq = shard.snapshot_rows(ids)
            return binf.encode_response(
                verb, aux=seq, n=int(ids.size), enc=binf.ENC_F32,
                payload=binf.rows_to_payload(vals, binf.ENC_F32),
            )
        if verb == binf.VERB_IDS["load"]:
            ids = self._frame_ids(req)
            vals = binf.rows_from_payload(
                req.payload, shard.value_shape, req.enc
            )
            if len(vals) != len(ids):
                raise ValueError(
                    f"{len(ids)} ids but {len(vals)} value rows"
                )
            seq = shard.assign_rows(ids, vals)
            return binf.encode_response(
                verb, aux=seq, n=int(ids.size), enc=binf.ENC_RAW
            )
        if verb == binf.VERB_IDS["repl"]:
            # the replication stream: the payload IS the on-disk CRC
            # record — raw bytes, no base64 (replication/shipper.py)
            from ..resilience.wal import decode_frame_bytes

            rec = decode_frame_bytes(bytes(req.payload))
            ack = shard.apply_repl(rec, head=req.tlv_int(binf.T_HEAD))
            return binf.encode_response(
                verb, aux=int(ack["seq"]), n=int(ack["applied"]),
                enc=binf.ENC_RAW,
                tlvs=[(binf.T_SEG, str(ack["seg"]).encode())],
            )
        if verb == binf.VERB_IDS["replstate"]:
            return binf.encode_response(
                verb, enc=binf.ENC_RAW,
                payload=json.dumps(shard.repl_state()).encode(),
            )
        if verb == binf.VERB_IDS["flush"]:
            f = shard.flush()
            return binf.encode_response(
                verb, n=int(f["pushes"]), enc=binf.ENC_RAW,
                tlvs=[(binf.T_WALREC, str(f["wal_records"]).encode())],
            )
        if verb == binf.VERB_IDS["stats"]:
            return binf.encode_response(
                verb, enc=binf.ENC_RAW,
                payload=json.dumps(shard.stats()).encode(),
            )
        if verb == binf.VERB_IDS["conns"]:
            return binf.encode_response(
                verb, enc=binf.ENC_RAW,
                payload=json.dumps(self.conn_table()).encode(),
            )
        raise ValueError(f"unknown verb id {verb}")


__all__ = [
    "ParamShard",
    "ShardServer",
    "ShardCrashed",
    "StaleEpoch",
    "FrozenKeys",
    "NotPrimary",
    "FollowerLagging",
    "format_rows",
    "parse_rows",
    "parse_ids",
]
