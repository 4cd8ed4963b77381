"""ClusterDriver — N parameter-server shards × M workers, one job.

Counterpart of ``flink_parameter_server_tpu/cluster/driver.py``.  The
topology, the clock, the barrier and the wire are the reference's; the
worker step runs on ``device`` (the card unless the caller asks for the
CPU): each round's microbatch goes to the device through
:func:`~..core.transform.to_device`, the logic's ``step`` is called as
it is (PyTorch runs eagerly; nothing is compiled), and what crosses the
socket wire is copied to and from the host explicitly.  Under the mesh
backend the pulled rows are already on the device and the step's push
goes to the device table without a host round trip.  ``hot_cache=True``
gives each SSP / async worker client a hot-key lease cache (host rows,
as the wire's are; ``hotcache/``).  ``adaptive=True`` builds an
:class:`~..adaptive.bounds.AdaptiveClock` and honours ``work_router``
(``adaptive/``); ``store_backend="tiered"`` is the socket topology with
each shard's slice on the two-tier store, its hot tier on ``device``
(``tierstore/``).  ``wire_proto="shm"`` moves every co-located client
connection onto a shared-memory ring pair (``shmem/``; host bytes, as
every wire's are), falling back per connection to binary TCP.  The
elastic driver
(``elastic/controller.py``) subclasses this one and reuses
:meth:`ClusterDriver._build_shard` for its spin-ups and replacements.

The multi-process shape of the source paper, finally runnable: shard
processes own key-partitioned state (:class:`~.shard.ParamShard` behind
:class:`~.shard.ShardServer` TCP front ends), workers exchange
asynchronous pull/push traffic against them
(:class:`~.client.ClusterClient`), and a bounded-staleness clock
(:class:`~.clock.StalenessClock`) dials the consistency between BSP
(``staleness_bound=0``), SSP (``k``) and fully async (``None``).

Execution model (per round ``t``, per worker ``w``):

  1. ``clock.wait_for_turn(w)`` — the SSP gate;
  2. mask the global microbatch down to the rows ``w`` owns (rows are
     routed by a stable hash of the ``worker_key`` column, so an
     entity's updates always land on one worker — the reference's
     keyBy-user worker partitioning);
  3. pull the batch's param rows from the shards (coalesced,
     pipelined, shard-parallel);
  4. run the SAME :meth:`~..core.batched.BatchedWorkerLogic.step` the
     single-process driver runs, on the device — worker state (e.g. MF
     user factors) stays worker-local;
  5. push the masked deltas back (aggregated per id);
  6. ``clock.tick(w)``.

With ``staleness_bound=0`` an extra intra-round barrier separates the
pull and push phases, so every round-``t`` read sees exactly the
post-round-``t−1`` table — which is why a bound-0 cluster run lands
allclose-equal (fp32) to :class:`~..training.driver.StreamingDriver`
on the same stream (tests/test_cluster.py BSP parity).  With a bound
``k`` the fast workers run up to ``k`` rounds ahead and the staleness
gauge (``cluster_staleness_steps``) shows the spread live on
``/metrics``.

Everything is thread-backed and sleep-free on the happy path — the
whole topology runs inside one pytest-tier process — but every byte
still crosses a real TCP socket, so the wire protocol, coalescing and
pipelining are exercised for real.

``ClusterConfig(store_backend="mesh")`` swaps the socket topology for
the device-mesh store (meshstore/): the same round loop, the same clock
and barrier, the same workload contract — but pulls and pushes become a
device gather / scatter-add over one table tensor instead of TCP
frames.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.batched import BatchedWorkerLogic
from ..core.transform import to_device, to_host, tree_map
from ..ops.hashing import fmix32_np
from ..utils.device import DeviceLike, resolve_device
from .client import ClusterClient
from .clock import StalenessClock
from .partition import ConsistentHashPartitioner, Partitioner, RangePartitioner
from .shard import ParamShard, ShardServer


@dataclasses.dataclass
class ClusterConfig:
    """Topology + consistency knobs for a cluster run."""

    num_shards: int = 2
    num_workers: int = 1
    # which store fronts the table: "socket" = N ParamShard slices
    # (each a tensor on the driver's device) behind TCP servers (every
    # knob below applies); "mesh" = ONE table tensor on the device
    # (meshstore/), pull/push a device gather/scatter-add — the wire
    # knobs (window, chunk, wire_format, wire_proto, spawn_grace_s,
    # host, timeouts) are then inert, and num_shards becomes layout
    # arithmetic (the block-aligned range partition) rather than a
    # server count; "tiered" = the socket topology with each shard's
    # slice on the two-tier store (tierstore/) — the hot tier a bounded
    # tensor on the driver's device, cold mutated rows in a host mmap
    # slab, absent rows recomputed from the deterministic init, the
    # slice's footprint on the device bounded by tier_hot_rows instead
    # of the table size
    store_backend: str = "socket"
    # tiered-store knobs (read only when store_backend="tiered"):
    # hot-tier capacity per shard in rows; the slab scratch dir (None
    # = the platform tmpdir — the slab is a cache, never a durability
    # plane, so it does NOT belong beside the WAL); the sketch decay
    # window in observed ids (0 derives 8 × tier_hot_rows)
    tier_hot_rows: int = 65536
    tier_slab_dir: Optional[str] = None
    tier_decay_window: int = 0
    # 0 = BSP (parity with the single-process driver), k > 0 = SSP,
    # None = fully asynchronous (never block)
    staleness_bound: Optional[int] = 0
    partition: str = "range"  # "range" | "hash" (see cluster/partition.py)
    # which batch column routes rows to workers (entity affinity: one
    # entity's updates always land on one worker)
    worker_key: str = "user"
    # client knobs: pipelining window (outstanding frames per shard
    # connection), ids per frame, payload encoding (shard.py: "b64"
    # exact+fast, "text" exact+debuggable, "bf16" half-bytes +
    # error-feedback residuals, "q8" per-row-scaled int8 deltas +
    # residuals — compression/, docs/compression.md).  BSP carve-out:
    # bound-0 WORKER clients always get exact fp32 regardless (a
    # quantized write would break read-your-last-round bitwise parity;
    # enforced in _make_client, the same discipline as hot_cache).
    window: int = 8
    chunk: int = 512
    wire_format: str = "b64"
    # push semantics of the workload's deltas (docs/workloads.md):
    # "delta" = fp32 gradient-style deltas (the default — quantized
    # encodings apply when configured); "increment" = integer counter
    # increments (streaming sketches), where a quantized write would
    # break integer-exact counts, so q8/bf16 downgrade to exact fp32
    # in _make_client — the same enforcement point as the BSP
    # carve-out.  Integer increments are exact in fp32 up to 2^24.
    push_semantics: str = "delta"
    # the registered workload driving this topology (workloads/
    # registry.py); set by the workload runtime so per-workload rates
    # (workload_updates_total{workload=}) land on /metrics and the
    # psctl `workloads` table
    workload: Optional[str] = None
    # two-level aggregation tree (compression/aggregator.py): workers
    # rendezvous per round and a combiner issues ONE merged push per
    # shard (its own client, its own pid space — the exactly-once
    # ledger balances on the uplink).  Trades per-round lockstep on
    # the PUSH side for a num_workers× cut in push frames.
    push_aggregate: bool = False
    # transport framing (utils/frames.py, docs/cluster.md "Binary
    # framing"): "auto" negotiates the length-prefixed binary frame
    # per connection (one hello round trip; old servers answer err
    # bad-request and the connection stays on the line protocol);
    # "line" never negotiates — the pre-binary client, byte for byte;
    # "shm" additionally attempts the shared-memory ring transport
    # (shmem/, docs/shmem.md) against co-located shards, falling back
    # per connection to binary TCP (then lines) for non-local peers,
    # old servers, or a proxied path
    wire_proto: str = "auto"
    # shard worker PROCESSES (cluster/procs.py): each shard server in
    # its own spawned process — its own GIL — with the numpy store
    # backend (the workers' steps stay on the driver's device).  Base
    # ClusterDriver topologies only (the elastic / replication control
    # planes drive in-process shard handles).
    shard_procs: bool = False
    # deterministic picklable init for proc shards ({"kind": ...},
    # procs.resolve_init); ignored by the in-process path, which takes
    # init_fn callables directly
    proc_init: Optional[dict] = None
    # how long a client retries a REFUSED dial before treating it as a
    # conn-class failure: a freshly (re)spawned shard process races
    # its bind against the first dial (procs.py; the _await_retry
    # interaction fix — dial retries here never spend retry budget)
    spawn_grace_s: float = 3.0
    # per-shard WALs under <wal_dir>/shard-<i>; None = no durability
    wal_dir: Optional[str] = None
    supervised: bool = True  # ShardServer restart supervision
    host: str = "127.0.0.1"
    request_timeout: float = 30.0
    # dial deadline, separate from the read deadline above: failure
    # detection (elastic replacement, replica failover) must not sit
    # behind a 30 s connect to a dead address
    connect_timeout: float = 5.0
    # distributed tracing (telemetry/distributed.py): one SpanTracer
    # ring per shard server + one for the clients, pull/push frames
    # stamped with t=<trace>:<span> tokens; collect the rings with
    # driver.trace_rings() and merge via TraceCollector
    trace: bool = False
    # hot-key analytics (telemetry/hotkeys.py): one HotKeySketch of
    # hot_key_k candidates per in-process shard, registered with the
    # process-wide aggregator as shard-<id> (shard processes get none)
    hot_keys: bool = False
    hot_key_k: int = 32
    # hot-key lease cache (hotcache/, docs/hotcache.md): per-worker
    # client-edge caches whose lease grants the live sketches drive
    # (hot_cache=True implies hot_keys).  BSP carve-out: bound-0
    # worker clients NEVER get a cache — reads must see every
    # previous-round write, and the driver enforces it here rather
    # than trusting each call site.
    hot_cache: bool = False
    hot_cache_capacity: int = 1024
    # max cached-entry age in ticks (1 tick = 1 pull_batch = 1 worker
    # round); None derives it: the SSP staleness bound, or 8 for async
    hot_cache_bound: Optional[int] = None
    hot_cache_top_n: int = 32
    hot_cache_lease_ttl: int = 16
    # latency-budget profiler (telemetry/profiler.py): per-phase cost
    # attribution on every pull/push round (client serialize → wire →
    # queue wait → WAL → scatter → serialize → parse).  On by default —
    # measured within the ≤3% telemetry overhead bar; False switches
    # every phase timer to the shared no-op.
    profile: bool = True
    # straggler-adaptive runtime (adaptive/, docs/adaptive.md) — the
    # kill switch.  When True the driver builds an AdaptiveClock
    # (per-worker staleness allowances, widened for flagged stragglers
    # up to adaptive_bound_ceiling and never below staleness_bound)
    # and honors self.work_router in _worker_mask; elastic drivers
    # additionally attach a PushHedger to worker clients when
    # adaptive_push_hedge_after_s is set.  False = stock StalenessClock
    # and identity routing — byte-for-byte the non-adaptive driver.
    adaptive: bool = False
    # hard cap on any worker's widened allowance; None = 2*bound + 1
    # (one full extra SSP window), see adaptive/bounds.py
    adaptive_bound_ceiling: Optional[int] = None
    # push-hedge deferral (seconds); None = push hedging off.  Only
    # effective on membership-backed clients (pid-carrying pushes).
    adaptive_push_hedge_after_s: Optional[float] = None


@dataclasses.dataclass
class ClusterResult:
    """What a cluster run hands back (the TransformResult analogue)."""

    values: np.ndarray  # final global table, assembled from the shards
    worker_outputs: List[Any]
    worker_states: List[Any]
    rounds: int
    events: int
    wall_s: float
    clock: Dict[str, Any]
    shard_stats: List[dict]

    @property
    def updates_per_sec(self) -> float:
        return self.events / self.wall_s if self.wall_s > 0 else 0.0


class ClusterDriver:
    """Own the topology: build it, run a job through it, tear it down.

    ``logic`` is any :class:`~..core.batched.BatchedWorkerLogic` —
    the same object the single-process :class:`StreamingDriver` runs;
    ``capacity``/``value_shape``/``init_fn`` describe the global table
    exactly as :meth:`ShardedParamStore.create` would (deterministic
    per-id init is what makes shard slices equal the global table's
    rows).  ``device`` is where the shard slices, the mesh table and
    the workers' step inputs live: the card unless the caller passes
    ``device="cpu"`` (the logic carries its own ``device`` too, and the
    two must agree).
    """

    def __init__(
        self,
        logic: BatchedWorkerLogic,
        *,
        capacity: int,
        value_shape: Sequence[int] = (),
        init_fn=None,
        config: Optional[ClusterConfig] = None,
        partitioner: Optional[Partitioner] = None,
        rng=None,
        registry=None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.logic = logic
        self.capacity = int(capacity)
        self.value_shape = tuple(int(s) for s in value_shape)
        self.config = config if config is not None else ClusterConfig()
        cfg = self.config
        if cfg.store_backend not in ("socket", "mesh", "tiered"):
            raise ValueError(
                f"store_backend={cfg.store_backend!r}: "
                f"'socket' | 'mesh' | 'tiered'"
            )
        if cfg.store_backend == "tiered" and cfg.shard_procs:
            raise ValueError(
                "store_backend='tiered' with shard_procs=True: shard "
                "worker processes run the host numpy slice "
                "(cluster/procs.py); tiered shards are in-process"
            )
        if cfg.store_backend == "mesh":
            # the mesh backend slots under the BASE driver's contracts
            # only (the same discipline as shard_procs): the elastic /
            # replication control planes re-partition and promote
            # per-shard SERVERS, while a mesh resize is a device-count
            # change — re-laying-out one global array, a different
            # operation parked for the TPU window (docs/meshstore.md)
            if type(self) is not ClusterDriver:
                raise NotImplementedError(
                    f"store_backend='mesh' supports the base "
                    f"ClusterDriver only (got {type(self).__name__}: "
                    f"elastic/replication control planes operate on "
                    f"socket-fronted shard handles; a mesh resize is a "
                    f"device relayout, ROADMAP Queue 1 #9)"
                )
            if cfg.shard_procs:
                raise ValueError(
                    "store_backend='mesh' with shard_procs=True: the "
                    "mesh table lives on THIS process's device — "
                    "there is no shard process to spawn"
                )
            if cfg.hot_cache:
                raise ValueError(
                    "store_backend='mesh' with hot_cache=True: mesh "
                    "reads are device-fresh gathers with no wire to "
                    "save — a host-side row cache would only add a "
                    "staleness surface"
                )
            if cfg.partition != "range":
                raise ValueError(
                    f"store_backend='mesh' requires partition='range' "
                    f"(got {cfg.partition!r}): the mesh table is "
                    f"row-block sharded, and only contiguous ranges "
                    f"can align to it (meshstore/layout.py)"
                )
        if partitioner is not None:
            self.partitioner = partitioner
        elif cfg.partition == "range":
            self.partitioner = RangePartitioner(capacity, cfg.num_shards)
        elif cfg.partition == "hash":
            self.partitioner = ConsistentHashPartitioner(
                capacity, cfg.num_shards
            )
        else:
            raise ValueError(
                f"partition={cfg.partition!r}: 'range' | 'hash'"
            )
        self._init_fn = init_fn
        if (
            init_fn is None
            and self.config.proc_init is not None
            and not self.config.shard_procs
        ):
            # one init spec drives BOTH arms: proc children resolve it
            # numpy-side, the in-process path renders the same rows on
            # the device — the proc-vs-thread parity contract
            from .procs import as_torch_init

            self._init_fn = as_torch_init(
                self.config.proc_init, self.value_shape, self.device
            )
        self._rng = rng
        if registry is not False:
            from ..telemetry.registry import get_registry

            self.registry = registry if registry is not None else get_registry()
        else:
            self.registry = None
        self.shards: List[ParamShard] = []
        self.servers: List[ShardServer] = []
        self.mesh_store = None  # MeshParamStore when store_backend="mesh"
        self.clock: Optional[StalenessClock] = None
        # adaptive work re-routing (adaptive/rebalance.py): when set
        # (and cfg.adaptive), _worker_mask consults it instead of the
        # static hash route; None = identity (stock routing)
        self.work_router = None
        self._clients: List[ClusterClient] = []
        self._started = False
        self._step_fn = None
        # observability plumbing (both off by default — zero overhead)
        self.client_tracer = None
        self.shard_tracers: List = []
        self._hotkey_labels: List[str] = []
        self._hotcache_labels: List[str] = []
        # hot_cache lease grants are sketch-driven: without the
        # measurement there is nothing to lease
        if self.config.hot_cache:
            self.config.hot_keys = True

    # -- lifecycle ---------------------------------------------------------
    def _wal_dir_for(self, shard_id: int) -> Optional[str]:
        cfg = self.config
        return (
            None if cfg.wal_dir is None
            else f"{cfg.wal_dir}/shard-{shard_id}"
        )

    def _build_shard(
        self, shard_id: int, partitioner: Optional[Partitioner] = None
    ) -> Tuple[ParamShard, ShardServer]:
        """One shard + its TCP front end (the elastic driver reuses
        this for scale-out spin-up and dead-shard replacement)."""
        cfg = self.config
        if cfg.shard_procs:
            # shard worker processes (cluster/procs.py): the GIL
            # escape.  Only the base driver's static topology — the
            # elastic/replication control planes operate on in-process
            # shard handles (freeze/install_epoch/promote are
            # deliberately wire-less, docs/cluster.md).
            if type(self) is not ClusterDriver:
                raise NotImplementedError(
                    f"shard_procs=True supports the base ClusterDriver "
                    f"only (got {type(self).__name__}: the elastic "
                    f"control plane drives in-process shard handles)"
                )
            if self._init_fn is not None and cfg.proc_init is None:
                raise ValueError(
                    "shard_procs=True cannot pickle an arbitrary "
                    "init_fn into the child — describe the init with "
                    "ClusterConfig.proc_init (procs.resolve_init) "
                    "and build the matching in-process init with "
                    "procs.as_torch_init"
                )
            from .procs import (
                RemoteShardStub,
                ShardProcSpec,
                ShardProcess,
            )

            proc = ShardProcess(ShardProcSpec(
                shard_id=shard_id,
                partition=cfg.partition,
                capacity=self.capacity,
                num_shards=cfg.num_shards,
                value_shape=self.value_shape,
                wal_dir=self._wal_dir_for(shard_id),
                init=cfg.proc_init,
                supervised=cfg.supervised,
                host=cfg.host,
            )).wait_ready()
            return RemoteShardStub(proc), proc
        hotkeys = None
        if cfg.hot_keys:
            from ..telemetry.hotkeys import HotKeySketch, get_aggregator

            hotkeys = HotKeySketch(cfg.hot_key_k)
            label = f"shard-{shard_id}"
            # re-registering (shard replacement) starts a fresh window
            get_aggregator().register(label, hotkeys)
            if label not in self._hotkey_labels:
                self._hotkey_labels.append(label)
        tracer = None
        if cfg.trace:
            from ..telemetry.spans import SpanTracer

            tracer = SpanTracer(process=f"shard-{shard_id}")
            self.shard_tracers.append(tracer)
        shard = ParamShard(
            shard_id,
            partitioner if partitioner is not None else self.partitioner,
            self.value_shape,
            init_fn=self._init_fn,
            wal_dir=self._wal_dir_for(shard_id),
            registry=self.registry if self.registry is not None else False,
            hotkeys=hotkeys,
            profiler=None if cfg.profile else False,
            # the "tiered" cluster backend IS the socket topology with
            # tiered slices — elastic scale-out and replacement shards
            # built here inherit the tier automatically
            store_backend=(
                "tiered" if cfg.store_backend == "tiered" else "torch"
            ),
            device=self.device,
            tier_hot_rows=cfg.tier_hot_rows,
            tier_slab_dir=cfg.tier_slab_dir,
            tier_decay_window=cfg.tier_decay_window,
        )
        server = ShardServer(
            shard, cfg.host, 0, supervised=cfg.supervised, tracer=tracer
        ).start()
        return shard, server

    def _on_servers_started(self) -> None:
        """Hook between shard spin-up and client construction (the
        elastic driver creates its membership service here)."""

    def _make_clock(self) -> StalenessClock:
        """One construction point for the SSP clock so the adaptive
        kill switch swaps in per-worker allowances everywhere (start()
        both topologies + the fresh-clock-per-run() site)."""
        cfg = self.config
        if getattr(cfg, "adaptive", False):
            from ..adaptive.bounds import AdaptiveClock

            bound = cfg.staleness_bound
            ceiling = getattr(cfg, "adaptive_bound_ceiling", None)
            if ceiling is None and bound is not None:
                ceiling = 2 * bound + 1
            return AdaptiveClock(
                cfg.num_workers, bound, bound_ceiling=ceiling
            )
        return StalenessClock(cfg.num_workers, cfg.staleness_bound)

    def _start_mesh(self) -> None:
        """The mesh topology: no servers to bind — align the range
        partition to the device row-blocks (one block: the table lives
        on one device), materialise the ONE table, and hand every
        worker a :class:`~..meshstore.MeshClient` over it.  Durability
        (when configured) journals at ``<wal_dir>/mesh``, beside where
        the socket topology's ``shard-<i>`` directories would sit."""
        from ..meshstore import MeshParamStore

        cfg = self.config
        self.partitioner = self.partitioner.block_aligned(1)
        self.mesh_store = MeshParamStore(
            self.capacity,
            self.value_shape,
            init_fn=self._init_fn,
            partitioner=self.partitioner,
            wal_dir=(
                None if cfg.wal_dir is None else f"{cfg.wal_dir}/mesh"
            ),
            registry=self.registry if self.registry is not None else False,
            device=self.device,
        )
        if self.registry is not None:
            # a mesh run's table lives in device memory — expose the
            # device's bytes_in_use/peak probes (training/tracing.py)
            # on the same /metrics surface the meshstore_* gauges use,
            # so a memory blow-up is visible live, not post-OOM
            from ..training.tracing import register_device_memory_gauges

            register_device_memory_gauges(self.registry)

    def start(self) -> "ClusterDriver":
        if self._started:
            return self
        cfg = self.config
        if cfg.store_backend == "mesh":
            self._start_mesh()
            self._clients = [
                self._make_client(worker=str(w))
                for w in range(cfg.num_workers)
            ]
            self.clock = self._make_clock()
            if self.registry is not None:
                self.registry.gauge(
                    "cluster_staleness_steps", component="cluster",
                    fn=lambda: (
                        self.clock.staleness()
                        if self.clock is not None else None
                    ),
                )
            self._started = True
            return self
        if cfg.trace and self.client_tracer is None:
            from ..telemetry.spans import SpanTracer

            self.client_tracer = SpanTracer(process="client")
        for s in range(cfg.num_shards):
            shard, server = self._build_shard(s)
            self.shards.append(shard)
            self.servers.append(server)
        self._on_servers_started()
        self._clients = [
            self._make_client(worker=str(w))
            for w in range(cfg.num_workers)
        ]
        self.clock = self._make_clock()
        if self.registry is not None:
            self.registry.gauge(
                "cluster_staleness_steps", component="cluster",
                fn=lambda: (
                    self.clock.staleness() if self.clock is not None else None
                ),
            )
        self._started = True
        return self

    def _make_client(self, worker: Optional[str] = None) -> ClusterClient:
        cfg = self.config
        if cfg.store_backend == "mesh":
            # the BSP / increment carve-outs below guard WIRE encodings;
            # the mesh path has no wire — every read and write is exact
            # fp32 on device, so both carve-outs hold vacuously
            from ..meshstore import MeshClient

            return MeshClient(self.mesh_store, worker=worker)
        # BSP carve-out (docs/compression.md): a bound-0 worker's reads
        # must see every previous-round write bitwise, so quantized
        # delta encodings downgrade to exact fp32 here — parity is
        # pinned in tests/test_compression.py, the same enforcement
        # point as the hot-cache bypass below
        wire_format = cfg.wire_format
        if cfg.staleness_bound == 0 and wire_format in ("q8", "bf16"):
            wire_format = "b64"
        # increment-semantics carve-out (docs/workloads.md): sketch
        # pushes are integer bucket increments — quantizing them would
        # deliver within-a-granule counts instead of exact ones, so
        # the q8/bf16 paths are bypassed for every client of an
        # increment workload (integer-exactness is pinned in
        # tests/test_workloads.py)
        if cfg.push_semantics == "increment" and wire_format in (
            "q8", "bf16"
        ):
            wire_format = "b64"
        client = ClusterClient(
            [(srv.host, srv.port) for srv in self.servers],
            self.partitioner,
            self.value_shape,
            window=cfg.window,
            chunk=cfg.chunk,
            timeout=cfg.request_timeout,
            connect_timeout=cfg.connect_timeout,
            wire_format=wire_format,
            wire_proto=cfg.wire_proto,
            spawn_grace_s=(
                cfg.spawn_grace_s if cfg.shard_procs else 0.0
            ),
            registry=self.registry if self.registry is not None else False,
            worker=worker,
            tracer=self.client_tracer,
            profiler=None if cfg.profile else False,
        )
        self._attach_hot_cache(client, worker)
        return client

    def _attach_hot_cache(self, client, worker: Optional[str]) -> None:
        """Attach the hot-key lease cache to a worker client — UNLESS
        the clock is BSP (bound 0): a cached read of any age > 0 would
        miss previous-round writes and break the parity guarantee, so
        bound-0 clients always bypass (the carve-out table in
        docs/hotcache.md)."""
        cfg = self.config
        if not cfg.hot_cache or cfg.staleness_bound == 0:
            return
        from ..hotcache import (
            HotRowCache,
            LeasePolicy,
            register_cache,
        )
        from ..telemetry.hotkeys import get_aggregator

        bound = cfg.hot_cache_bound
        if bound is None:
            bound = (
                cfg.staleness_bound
                if cfg.staleness_bound is not None else 8
            )
        cache = HotRowCache(
            bound,
            capacity=cfg.hot_cache_capacity,
            registry=self.registry if self.registry is not None else False,
            worker=worker,
        )
        client.attach_hotcache(
            cache,
            LeasePolicy(get_aggregator(), top_n=cfg.hot_cache_top_n),
            lease_ttl=cfg.hot_cache_lease_ttl,
        )
        label = f"worker-{worker}" if worker is not None else "client"
        register_cache(label, cache)
        if label not in self._hotcache_labels:
            self._hotcache_labels.append(label)

    def trace_rings(self) -> List:
        """Every per-process span ring this topology records into
        (client first, then shards) — feed them to a
        :class:`~..telemetry.distributed.TraceCollector`."""
        rings = []
        if self.client_tracer is not None:
            rings.append(self.client_tracer)
        rings.extend(self.shard_tracers)
        return rings

    def stop(self) -> None:
        for c in self._clients:
            c.close()
        self._clients = []
        for srv in self.servers:
            srv.stop()
        for shard in self.shards:
            shard.close()
        self.servers = []
        self.shards = []
        if self.mesh_store is not None:
            self.mesh_store.close()
            self.mesh_store = None
        self._started = False
        if self._hotkey_labels:
            from ..telemetry.hotkeys import get_aggregator

            agg = get_aggregator()
            for label in self._hotkey_labels:
                agg.unregister(label)
            self._hotkey_labels = []
        if self._hotcache_labels:
            from ..hotcache import unregister_cache

            for label in self._hotcache_labels:
                unregister_cache(label)
            self._hotcache_labels = []

    def __enter__(self) -> "ClusterDriver":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the job ------------------------------------------------------------
    def _worker_mask(
        self, batch: dict, worker: int, round_idx: int = 0
    ) -> np.ndarray:
        cfg = self.config
        base = np.asarray(
            batch.get("mask", np.ones(self._batch_len(batch), bool))
        ).astype(bool)
        if cfg.num_workers == 1:
            return base
        if cfg.worker_key not in batch:
            raise ValueError(
                f"num_workers={cfg.num_workers} needs batch column "
                f"{cfg.worker_key!r} to route rows (set "
                f"ClusterConfig.worker_key)"
            )
        keys = np.asarray(batch[cfg.worker_key], np.int64)
        router = self.work_router
        if router is not None and getattr(cfg, "adaptive", False):
            # adaptive re-routing (adaptive/rebalance.py): ownership is
            # a pure function of (key, round) and every worker asks
            # about the same round, so exactly-once per row per round
            # is preserved even while groups migrate
            return base & router.owner_mask(keys, worker, round_idx)
        owner = fmix32_np(keys) % np.uint32(cfg.num_workers)
        return base & (owner == np.uint32(worker))

    @staticmethod
    def _batch_len(batch: dict) -> int:
        return len(next(iter(batch.values())))

    def run(
        self,
        batches,
        *,
        collect_outputs: bool = False,
        round_hook: Optional[Callable[[int, int], None]] = None,
        timeout: float = 300.0,
        deadline_s: Optional[float] = None,
    ) -> ClusterResult:
        """Train over ``batches`` (a finite iterable of microbatch
        dicts); every worker walks the full sequence with its ownership
        mask applied.  ``round_hook(worker, round)`` fires at each round
        start on the worker's thread — the straggler-injection point
        the SSP tests use.  ``deadline_s`` turns the run time-bounded:
        each worker stops at the first round boundary past the
        deadline (goodput benchmarking — under a fixed wall budget the
        work completed IS the metric, whereas on a fixed workload the
        wall clock is floored by the straggler in every arm).  Returns
        the assembled final table."""
        if not self._started:
            self.start()
        cfg = self.config
        batches = list(batches)
        if self._step_fn is None:
            self._step_fn = self.logic.step
        rng = self._rng
        if rng is None:
            rng = torch.Generator(device=self.device)
            rng.manual_seed(0)
        # mesh: rows and pushes stay on the device; socket: the wire
        # takes host arrays
        on_device = self.mesh_store is not None
        # fresh clock per run: the previous run's workers deactivated
        # themselves at stream end (frozen counters must not gate a new
        # job); the staleness gauge reads self.clock so it follows
        clock = self.clock = self._make_clock()
        # bound-0 intra-round barrier: reads of round t must not see
        # round-t writes (see module docstring)
        pull_barrier = (
            threading.Barrier(cfg.num_workers)
            if cfg.staleness_bound == 0 and cfg.num_workers > 1
            else None
        )
        # aggregation tree (compression/aggregator.py): one combiner
        # uplink per run, workers rendezvous per round and the shards
        # see ONE merged push — fresh per run (a broken barrier must
        # not leak into the next job)
        if deadline_s is not None and cfg.push_aggregate:
            raise ValueError(
                "deadline_s is incompatible with push_aggregate: a "
                "deadline-stopped worker would strand its siblings at "
                "the push rendezvous"
            )
        deadline_t = (
            time.perf_counter() + float(deadline_s)
            if deadline_s is not None else None
        )

        def past_deadline() -> bool:
            return (
                deadline_t is not None
                and time.perf_counter() >= deadline_t
            )

        push_agg = None
        if cfg.push_aggregate and cfg.num_workers > 1:
            from ..compression.aggregator import PushAggregator

            push_agg = PushAggregator(
                cfg.num_workers,
                self._make_client(worker="combiner"),
                registry=self.registry,
                timeout=timeout,
            )
        # exposed for post-run ledger audits (rows the uplink acked)
        self.last_push_aggregator = push_agg
        errors: List[BaseException] = []
        states: List[Any] = [None] * cfg.num_workers
        outputs: List[List[Any]] = [[] for _ in range(cfg.num_workers)]
        events = [0] * cfg.num_workers
        c_rounds = (
            self.registry.counter(
                "cluster_worker_rounds_total", component="cluster"
            )
            if self.registry is not None
            else None
        )
        # per-workload rate instrument (workloads/, docs/workloads.md):
        # the `workloads` telemetry path and psctl table read this
        c_updates = (
            self.registry.counter(
                "workload_updates_total", component="workloads",
                workload=cfg.workload,
            )
            if self.registry is not None and cfg.workload is not None
            else None
        )

        def worker_loop(w: int) -> None:
            client = self._clients[w]
            state = self.logic.init_state(rng)
            try:
                for t, batch in enumerate(batches):
                    if errors:
                        break
                    if past_deadline():
                        # round-boundary stop: this worker's completed
                        # rounds stay counted, the aborted barrier
                        # releases any bound-0 sibling mid-round
                        if pull_barrier is not None:
                            pull_barrier.abort()
                        break
                    if round_hook is not None:
                        round_hook(w, t)
                    if not clock.wait_for_turn(w, timeout=timeout):
                        raise TimeoutError(
                            f"worker {w} starved at round {t} "
                            f"(bound={cfg.staleness_bound})"
                        )
                    wb = dict(batch)
                    wb["mask"] = self._worker_mask(batch, w, t)
                    # the step's inputs, on the device
                    db = to_device(wb, self.device)
                    keys = self.logic.keys(db)
                    # the wire takes host ids (a device-to-host copy);
                    # the mesh gathers with the device ids
                    ids = keys if on_device else to_host(keys)
                    # multi-key workloads (PA's sparse (B, K) feature
                    # ids, a sketch's (B, depth) cells) pull several
                    # params per record: broadcast the per-record row
                    # mask over the trailing key lanes so coalescing
                    # sees one mask lane per key
                    kmask = np.asarray(wb["mask"])
                    shape = tuple(keys.shape)
                    if len(shape) > kmask.ndim:
                        kmask = np.broadcast_to(
                            kmask.reshape(
                                kmask.shape
                                + (1,) * (len(shape) - kmask.ndim)
                            ),
                            shape,
                        )
                    if kmask.any():
                        pulled = client.pull_batch(ids, mask=kmask)
                    else:
                        # a fully masked round owns no rows — e.g. a
                        # drained straggler after adaptive re-routing —
                        # and must cost no wire: coalesce_ids would otherwise
                        # pull one fill id.  Masked lanes are padding
                        # by the store contract, so zeros feed the step.
                        pulled = torch.zeros(
                            shape + tuple(self.value_shape),
                            dtype=torch.float32, device=self.device,
                        )
                    if pull_barrier is not None:
                        try:
                            pull_barrier.wait(timeout=timeout)
                        except threading.BrokenBarrierError:
                            if past_deadline():
                                break  # a sibling deadline-stopped
                            raise
                    # wire rows are host arrays (a host-to-device copy);
                    # mesh rows are already on the device (a no-op)
                    state, req, out = self._step_fn(
                        state, db, to_device(pulled, self.device)
                    )
                    if on_device and push_agg is None:
                        client.push_batch(req.ids, req.deltas, req.mask)
                    else:
                        req_mask = (
                            None if req.mask is None else to_host(req.mask)
                        )
                        ids_h, deltas_h = to_host(req.ids), to_host(req.deltas)
                        if push_agg is not None:
                            push_agg.push_batch(w, ids_h, deltas_h, req_mask)
                        else:
                            client.push_batch(ids_h, deltas_h, req_mask)
                    clock.tick(w)
                    events[w] += int(wb["mask"].sum())
                    if c_rounds is not None:
                        c_rounds.inc()
                    if c_updates is not None:
                        c_updates.inc(int(wb["mask"].sum()))
                    if collect_outputs:
                        outputs[w].append(tree_map(to_host, out))
                states[w] = state
            except BaseException as e:  # noqa: BLE001 — joined below
                errors.append(e)
                if pull_barrier is not None:
                    pull_barrier.abort()
                if push_agg is not None:
                    # siblings parked at the push rendezvous must get
                    # BrokenBarrierError, not a hang
                    push_agg.abort()
            finally:
                clock.deactivate(w)

        t0 = time.perf_counter()
        threads = [
            threading.Thread(
                target=worker_loop, args=(w,), name=f"cluster-worker-{w}",
                daemon=True,
            )
            for w in range(cfg.num_workers)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout)
        wall = time.perf_counter() - t0
        if push_agg is not None:
            push_agg.close()
        if errors:
            raise errors[0]
        return ClusterResult(
            values=self.final_values(),
            worker_outputs=(
                [o for outs in outputs for o in outs]
                if collect_outputs else []
            ),
            worker_states=states,
            rounds=len(batches),
            events=int(sum(events)),
            wall_s=wall,
            clock=clock.snapshot(),
            shard_stats=(
                [self.mesh_store.stats()]
                if self.mesh_store is not None
                else [s.stats() for s in self.shards]
            ),
        )

    def final_values(self) -> np.ndarray:
        """Assemble the global table from the shards (through the wire
        — the dump is itself a protocol exercise), rows in global-id
        order: the cluster analogue of
        :meth:`~..core.store.ShardedParamStore.values`."""
        client = self._clients[0] if self._clients else self._make_client()
        try:
            if client.hotcache is not None:
                # the dump is the table of record: drop any cached rows
                # so every id is read fresh from its shard (leases are
                # re-granted in passing, which is harmless)
                client.hotcache.clear()
            # to_host: the mesh client returns the device tensor
            return to_host(client.pull_batch(
                np.arange(self.capacity, dtype=np.int64)
            ))
        finally:
            if not self._clients:
                client.close()


__all__ = ["ClusterConfig", "ClusterDriver", "ClusterResult"]
