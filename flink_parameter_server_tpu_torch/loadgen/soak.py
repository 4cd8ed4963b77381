"""SoakRunner — minutes-long open-loop soaks over the full stack.

Counterpart of ``flink_parameter_server_tpu/loadgen/soak.py``.  The
device is an argument of :class:`SoakRunner`, :func:`run_soak` and
:func:`closed_loop_capacity`, never a field of :class:`SoakConfig` (whose
fields and defaults are the reference's): the workload's table, the
shards' slices and their followers live on the card unless the caller
passes ``device="cpu"``, and asking for the card without one raises
(``utils/device.resolve_device``).  Pushes land through the store's
``xla`` arm (``ops/rows.accumulate_rows_``), as the reference's do, so no
kernel of the port runs on this path.  The soak's scratch WAL directory
is removed at teardown.

This is the open-loop soak made runnable: a seeded user population
(:mod:`.population`) arriving on a seeded open-loop schedule
(:mod:`.arrivals`) against the full replicated+elastic cluster — with
the nemesis mesh underneath (every shard front door is a
:class:`~..nemesis.proxy.ChaosProxy`, byte-for-byte the same splice
``nemesis/runner.py`` uses) and the overload-control plane
(:mod:`.overload`) switchable per arm, which is what makes the
capacity A/B in the reference's ``benchmarks/soak_capacity.py`` an
experiment instead of a demo.

Execution model:

  * the **driver** is a :class:`~..replication.driver
    .ReplicatedClusterDriver` behind the nemesis mesh; an optional
    :class:`~..elastic.controller.ElasticController` polls the local
    registry (replace/promote dead shards, track the load curve);
  * **generator threads** split one global arrival schedule
    round-robin; each samples the population per arrival — a serving
    read (priority 2, through a lease-capable hot-row cache, retry
    budget + per-shard breakers attached) or a training push
    (priority 0, plain client, full retry semantics: a shed write
    would be a lost update, so writes are never shed or budgeted);
  * **latency is arrival-anchored**: every request's latency is
    ``completion − scheduled arrival``, so a backlog shows up as tail
    latency instead of thinning the offered load (no coordinated
    omission);
  * a **nemesis thread** fires ``(at_s, NemesisOp)`` entries through
    :func:`~..nemesis.runner._execute_op` — the same op vocabulary,
    executed on a wall-clock schedule instead of a round counter
    (a soak has no training rounds to key on);
  * the **goodput ledger** classifies every arrival exactly once:
    ``ok`` (answered within the SLO deadline), ``late`` (answered,
    too slow), ``shed`` (typed overload rejection — fast badput),
    ``error`` (anything else), bucketed per second for the timeline
    artifacts.

After teardown the nemesis invariant checkers run: exactly-once ledger
(writer-acked rows == shard-applied rows), lease staleness at the
WIDENED bound (brownout may have stretched it — the checker enforces
the stretched value), serving error budget, zero leaked threads.

:func:`autoscaler_score` turns a timeline into the controller-quality
figure: SLO-seconds burned vs an ideal controller on the same trace
(ideal = burns only where the offered load exceeds what the LARGEST
configuration can serve at all).

The runner is WORKLOAD-GENERIC (``SoakConfig.workload`` →
workloads/registry.py): the table shape, train-push synthesis and
read-id mapping come from the registered workload, and the push path
can run the q8 codec (``wire_format="q8"``, bypassed for increment
workloads) and the aggregation tree (``push_aggregate=True`` — one
combined uplink push per train drain round, exactly-once on the
uplink).  docs/workloads.md; the arms are recorded in
``results/cpu/soak_capacity.md`` and the workload battery.
"""
from __future__ import annotations

import dataclasses
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .arrivals import RateFn, constant_rate, poisson_arrivals, split_slots
from .overload import (
    PRIORITY_CRITICAL,
    PRIORITY_SHEDDABLE,
    BreakerBoard,
    BrownoutController,
    OverloadGuard,
    OverloadedError,
    RetryBudget,
)
from .population import UserPopulation
from ..utils.device import DeviceLike, resolve_device

OUTCOMES = ("ok", "late", "shed", "error")


class GoodputLedger:
    """Every arrival classified exactly once, bucketed per second.

    ``record`` takes the request's SCHEDULED arrival offset (the
    honest timestamp) and its outcome; admitted requests (ok | late)
    also record their arrival-anchored latency.  ``summary`` closes
    the books: totals per outcome, goodput rate, and arrival-anchored
    p50/p99 over admitted requests."""

    def __init__(self, duration_s: float):
        self.duration_s = float(duration_s)
        n = max(1, int(np.ceil(self.duration_s)))
        self._lock = threading.Lock()
        self._buckets = {o: np.zeros(n, np.int64) for o in OUTCOMES}
        self._latencies: List[float] = []  # admitted, arrival-anchored
        self._shed_lat: List[float] = []   # fail-fast turnaround
        self.arrivals = 0

    def record(
        self, arrival_s: float, outcome: str,
        latency_s: Optional[float] = None,
    ) -> None:
        if outcome not in OUTCOMES:
            raise ValueError(f"outcome {outcome!r}: one of {OUTCOMES}")
        b = min(
            len(self._buckets[outcome]) - 1, max(0, int(arrival_s))
        )
        with self._lock:
            self.arrivals += 1
            self._buckets[outcome][b] += 1
            if latency_s is not None:
                if outcome in ("ok", "late"):
                    self._latencies.append(float(latency_s))
                elif outcome == "shed":
                    self._shed_lat.append(float(latency_s))

    def timeline(self) -> List[Dict[str, int]]:
        with self._lock:
            n = len(self._buckets["ok"])
            return [
                {
                    "t": t,
                    **{o: int(self._buckets[o][t]) for o in OUTCOMES},
                }
                for t in range(n)
            ]

    def summary(self) -> Dict[str, object]:
        with self._lock:
            totals = {
                o: int(self._buckets[o].sum()) for o in OUTCOMES
            }
            lats = np.asarray(self._latencies, np.float64)
            shed_lats = np.asarray(self._shed_lat, np.float64)
            arrivals = self.arrivals
        out: Dict[str, object] = {
            "arrivals": arrivals,
            **totals,
            "admitted": totals["ok"] + totals["late"],
            "goodput_rps": round(totals["ok"] / self.duration_s, 1),
            "offered_rps_observed": round(arrivals / self.duration_s, 1),
            # the honesty flag the --soak artifact lint requires: all
            # latency figures below are measured against the SCHEDULED
            # arrival, never the send time
            "latency_anchor": "arrival",
        }
        if lats.size:
            out["p50_ms"] = round(float(np.percentile(lats, 50)) * 1e3, 3)
            out["p99_ms"] = round(float(np.percentile(lats, 99)) * 1e3, 3)
            out["mean_ms"] = round(float(lats.mean()) * 1e3, 3)
        else:
            out["p50_ms"] = out["p99_ms"] = out["mean_ms"] = None
        out["shed_turnaround_p99_ms"] = (
            round(float(np.percentile(shed_lats, 99)) * 1e3, 3)
            if shed_lats.size else None
        )
        return out


@dataclasses.dataclass
class SoakConfig:
    """One soak experiment.  ``overload_control`` is the A/B switch:
    False runs the identical topology and traffic with no guard, no
    budget, no breakers, no brownout — the collapse arm."""

    duration_s: float = 8.0
    offered_rps: float = 120.0
    rate_fn: Optional[RateFn] = None    # None → constant offered_rps
    rate_max: Optional[float] = None    # required with rate_fn
    generators: int = 4                 # open-loop generator threads
    # training pushes run on their OWN worker pool, fed by a queue
    # from the generators: a push stalled behind a partition (writes
    # keep the 5 s durability-grade timeout) must never block the
    # latency-bound serve traffic sharing its arrival stream
    train_workers: int = 2
    # population shape
    num_users: int = 512
    num_items: int = 1024
    batch_ids: int = 4
    zipf_s: float = 1.1
    regions: Optional[Sequence] = None  # None → population default
    # topology
    dim: int = 8
    num_shards: int = 2
    replication_factor: int = 1
    # the registered workload under soak (workloads/registry.py):
    # "mf" (the incumbent) | "pa" | "sketch" — table shape, push
    # synthesis and read-id mapping all come from the workload, so the
    # open-loop harness regresses any learner the registry knows
    workload: str = "mf"
    # train-push payload encoding (compression/, docs/compression.md):
    # "q8" quantizes push deltas with error feedback — a
    # follow-on arm, bandwidth-sensitive now that proc shards exist.
    # Increment workloads (sketches) bypass it (exactness carve-out).
    wire_format: str = "b64"
    # two-level aggregation tree on the train-push path: the
    # train workers rendezvous per drain round and ONE combined push
    # per round crosses the wire through a combiner uplink client
    # (compression/aggregator.py; the exactly-once ledger balances on
    # the uplink)
    push_aggregate: bool = False
    # straggler-adaptive runtime kill-switch (adaptive/): the soak
    # runs a single uplink worker on an async serve clock, so the
    # dynamic SSP bounds are inert here — but the push hedger rides
    # the train uplink, and flipping this arms it end to end
    adaptive: bool = False
    adaptive_push_hedge_after_s: Optional[float] = None
    link_delay_ms: float = 1.0          # per-request mesh delay (c2s)
    # the goodput deadline: an answer later than this is badput
    slo_ms: float = 100.0
    # overload-control plane (the arm switch + its knobs)
    overload_control: bool = True
    shed_sheddable_depth: int = 6
    shed_read_depth: int = 24
    retry_budget_capacity: float = 6.0
    breaker_min_failures: int = 8
    breaker_cooldown_s: float = 0.25
    brownout_widen: float = 4.0
    brownout_enter_sheds: int = 16
    # client-edge deadline shedding (the third shed point, after the
    # shard and serving edges): a serve request already older than
    # ``client_deadline_frac × slo_ms`` at DISPATCH is dead on
    # arrival — issuing it would return an answer the caller has
    # given up on while delaying every fresher request behind it, so
    # the overload-control arm sheds it client-side in microseconds.
    # The fraction leaves service-time headroom so admitted requests
    # can still finish inside the SLO.  Train pushes are never
    # deadline-shed (a dropped push is a lost update).
    client_deadline_frac: float = 0.5
    # hot-row cache (both arms: the hot-cache tier is part of the stack)
    cache_bound: int = 32
    cache_capacity: int = 512
    hot_top_n: int = 64
    lease_ttl: int = 64
    # elastic controller (None = fixed topology)
    controller_policy: Optional[object] = None
    controller_interval_s: float = 0.5
    # nemesis schedule under the soak: (at_s, NemesisOp) pairs
    nemesis: Sequence[Tuple[float, object]] = ()
    # closed-loop warmup before the schedule arms: dials connections,
    # and pays the first requests' work on the device (the card's
    # allocator and the first gathers and scatter-adds of each shape) —
    # cold-start costs belong to the stack's birth, not to the soak's tail
    warmup_requests: int = 64
    # client plumbing.  Serve clients run on LATENCY-SCALE deadlines:
    # a serving read blocked 5 s behind a partition is worthless, so
    # its socket/read timeout is a small multiple of the healthy p99
    # and its total retry window is short (the budget sheds the rest).
    # Train clients keep the generous timeouts — a push must land.
    request_timeout: float = 5.0
    connect_timeout: float = 2.0
    retry_timeout: float = 8.0
    serve_timeout_s: float = 0.4
    serve_retry_timeout_s: float = 2.0
    serving_error_budget: int = 0
    # two-tier parameter store (tierstore/, docs/tierstore.md): the
    # shard slices run hot-in-RAM / cold-in-mmap at a bounded resident
    # set.  Purely a store swap — same WAL, same wire, same ledger.
    tiered: bool = False
    tier_hot_rows: int = 4096
    seed: int = 0


@dataclasses.dataclass
class SoakReport:
    """One soak's full outcome: ledger summary + timeline + verdicts."""

    summary: Dict[str, object]
    timeline: List[Dict[str, int]]
    verdicts: List[object]           # nemesis/invariants.Verdict
    faults: Dict[str, int]
    cache: Dict[str, object]
    overload: Dict[str, object]
    controller_events: List[dict]
    wall_s: float
    # the metric-series window from an attached TimelineRecorder
    # (telemetry/timeline.py) — distinct from `timeline`, which is the
    # goodput ledger's per-second offered/completed buckets
    metric_timeline: Optional[dict] = None

    @property
    def ok(self) -> bool:
        return all(v.ok for v in self.verdicts)

    def as_dict(self) -> dict:
        return {
            "summary": self.summary,
            "timeline": self.timeline,
            "verdicts": [v.as_dict() for v in self.verdicts],
            "faults": dict(sorted(self.faults.items())),
            "cache": self.cache,
            "overload": self.overload,
            "controller_events": self.controller_events,
            "wall_s": round(self.wall_s, 3),
            "ok": self.ok,
            "metric_timeline": self.metric_timeline,
        }


def _make_driver_class():
    from ..nemesis.runner import _NemesisMeshMixin
    from ..replication.driver import ReplicatedClusterDriver

    class _GuardedShards:
        """Attach the overload guard to every shard server this
        driver ever builds — initial spin-up, scale-out and
        replacement alike (the same chokepoint discipline as the
        nemesis mesh, one layer further in: the guard rides the REAL
        server, the proxy wraps outside it)."""

        guard_factory = None  # set post-construction, pre-start

        def _build_shard(self, shard_id, partitioner=None):
            shard, server = super()._build_shard(shard_id, partitioner)
            if self.guard_factory is not None:
                server.overload = self.guard_factory(int(shard_id))
            return shard, server

    class SoakMeshDriver(
        _NemesisMeshMixin, _GuardedShards, ReplicatedClusterDriver
    ):
        """Replicated cluster, every primary behind the chaos mesh,
        every shard server behind the overload guard."""

    return SoakMeshDriver


class SoakRunner:
    """Build the stack from a :class:`SoakConfig`, run the open-loop
    soak, tear down, audit.  One-shot: construct → :meth:`run`."""

    def __init__(self, config: SoakConfig, *, registry=None,
                 timeline=None, device: DeviceLike = None):
        self.config = config
        # the workload's table and the shards' slices live here
        self.device = resolve_device(device)
        from ..telemetry.registry import MetricsRegistry
        from ..workloads import WorkloadParams, create_workload

        self.registry = (
            registry if registry is not None else MetricsRegistry()
        )
        # optional TimelineRecorder (telemetry/timeline.py) sampling
        # this runner's registry for the duration of the soak; its
        # window lands on the report as `metric_timeline` and its
        # detector firings pressure the elastic controller when one
        # is configured
        self.timeline = timeline
        # num_users=64 keeps the MF logic identical to the pre-registry
        # soak (worker state is never trained here — driver.run() is
        # not called — but the table shape and init must not move under
        # the capacity ledger); num_items/dim size the table
        self.workload = create_workload(config.workload, WorkloadParams(
            num_users=64, num_items=config.num_items, dim=config.dim,
            seed=1,
        ), device=self.device)

    # -- internals -----------------------------------------------------------
    def _build_driver(self, wal_dir: str):
        from ..replication.driver import ReplicatedClusterConfig
        from ..workloads import build_cluster_driver

        cfg = self.config
        cls = _make_driver_class()
        driver = build_cluster_driver(
            self.workload,
            config=ReplicatedClusterConfig(
                store_backend=("tiered" if cfg.tiered else "socket"),
                tier_hot_rows=cfg.tier_hot_rows,
                num_shards=cfg.num_shards,
                num_workers=1,
                staleness_bound=None,  # serve-side async clock
                wal_dir=wal_dir,
                wire_format=cfg.wire_format,
                replication_factor=cfg.replication_factor,
                adaptive=cfg.adaptive,
                adaptive_push_hedge_after_s=cfg.adaptive_push_hedge_after_s,
                request_timeout=cfg.request_timeout,
                connect_timeout=cfg.connect_timeout,
                retry_timeout=cfg.retry_timeout,
            ),
            driver_cls=cls,
            registry=self.registry,
            driver_kwargs={"nemesis_seed": cfg.seed},
            device=self.device,
        )
        if cfg.overload_control:
            reg = self.registry

            def factory(shard_id: int) -> OverloadGuard:
                return OverloadGuard(
                    sheddable_depth=cfg.shed_sheddable_depth,
                    read_depth=cfg.shed_read_depth,
                    write_depth=None,
                    registry=reg,
                    shard=shard_id,
                )

            driver.guard_factory = factory
        return driver

    def _make_serve_client(self, driver, name: str, policy, brownout):
        from ..cluster.client import ClusterClient
        from ..hotcache.cache import HotRowCache

        cfg = self.config
        cache = HotRowCache(
            cfg.cache_bound, capacity=cfg.cache_capacity,
            registry=self.registry, worker=name,
        )
        if brownout is not None:
            brownout.attach(cache)
        budget = breakers = None
        if cfg.overload_control:
            budget = RetryBudget(
                cfg.retry_budget_capacity,
                registry=self.registry, worker=name,
            )
            breakers = BreakerBoard(
                min_failures=cfg.breaker_min_failures,
                cooldown_s=cfg.breaker_cooldown_s,
                registry=self.registry, worker=name,
            )
        client = ClusterClient(
            value_shape=self.workload.value_shape,
            membership=driver.membership,
            registry=self.registry,
            worker=name,
            timeout=cfg.serve_timeout_s,
            connect_timeout=min(
                cfg.connect_timeout, cfg.serve_timeout_s
            ),
            retry_timeout=cfg.serve_retry_timeout_s,
            retry_budget=budget,
            breakers=breakers,
            priority=(
                PRIORITY_SHEDDABLE if cfg.overload_control else None
            ),
            hotcache=cache,
            lease_policy=policy,
            lease_ttl=cfg.lease_ttl,
        )
        return client, cache

    def _make_train_client(self, driver, name: str):
        from ..cluster.client import ClusterClient

        cfg = self.config
        # the push-path codec rides the TRAIN clients only (pulls are
        # never quantized); increment workloads get the exactness
        # carve-out here, same rule as ClusterDriver._make_client
        wire_format = cfg.wire_format
        if self.workload.push_semantics == "increment" and \
                wire_format in ("q8", "bf16"):
            wire_format = "b64"
        return ClusterClient(
            value_shape=self.workload.value_shape,
            membership=driver.membership,
            registry=self.registry,
            worker=name,
            timeout=cfg.request_timeout,
            connect_timeout=cfg.connect_timeout,
            retry_timeout=cfg.retry_timeout,
            wire_format=wire_format,
            priority=PRIORITY_CRITICAL if cfg.overload_control else None,
        )

    # -- the run -------------------------------------------------------------
    def run(self) -> SoakReport:
        from ..hotcache.policy import StaticHotSet
        from ..nemesis.invariants import (
            ThreadLedger,
            check_exactly_once,
            check_lease_staleness,
            check_serving_budget,
        )
        from ..nemesis.runner import _execute_op

        cfg = self.config
        if cfg.rate_fn is not None:
            if cfg.rate_max is None:
                raise ValueError("rate_fn needs rate_max (thinning bound)")
            rate_fn, rate_max = cfg.rate_fn, float(cfg.rate_max)
        else:
            rate_fn, rate_max = constant_rate(cfg.offered_rps)
        population = UserPopulation(
            cfg.num_users, cfg.num_items,
            zipf_s=cfg.zipf_s, batch_ids=cfg.batch_ids,
            regions=cfg.regions, seed=cfg.seed,
        )
        arrivals = poisson_arrivals(
            rate_fn, rate_max, cfg.duration_s, seed=cfg.seed + 1
        )
        slots = split_slots(arrivals, cfg.generators)
        ledger = GoodputLedger(cfg.duration_s)
        thread_ledger = ThreadLedger()
        policy = StaticHotSet(population.hot_items(cfg.hot_top_n))
        brownout = (
            BrownoutController(
                widen_factor=cfg.brownout_widen,
                enter_sheds=cfg.brownout_enter_sheds,
                registry=self.registry,
            )
            if cfg.overload_control else None
        )
        workload = self.workload
        t_wall0 = time.perf_counter()
        wal_root = tempfile.mkdtemp(prefix="soak-wal-")
        driver = self._build_driver(wal_root)
        driver.start()
        controller = None
        if cfg.controller_policy is not None:
            from ..elastic.controller import ElasticController

            controller = ElasticController(
                driver, policy=cfg.controller_policy,
                registry=self.registry,
                interval_s=cfg.controller_interval_s,
                timeline=self.timeline,
            )
        if self.timeline is not None:
            self.timeline.mark("soak_start", scenario="soak")
            self.timeline.start()
        serve_clients: List = []
        caches: List = []
        train_clients: List = []
        serve_errors = [0]
        served = [0]
        deadline_sheds = [0]
        error_samples: List[str] = []
        err_lock = threading.Lock()
        push_agg = None
        agg_stop = threading.Event()
        try:
            if cfg.link_delay_ms > 0:
                for proxy in driver.mesh.values():
                    # request leg only: one delay per request burst,
                    # the LAN-RTT model hotcache_storm.py established
                    proxy.set_delay(cfg.link_delay_ms, 0.0, "c2s")
            for g in range(cfg.generators):
                sc, cache = self._make_serve_client(
                    driver, f"loadgen-serve-{g}", policy, brownout
                )
                serve_clients.append(sc)
                caches.append(cache)
            # the aggregation-tree arm funnels every train push through
            # ONE combiner uplink client (its own pid space — the
            # exactly-once ledger balances on the uplink); otherwise
            # one client per train worker
            if cfg.push_aggregate and cfg.train_workers > 1:
                from ..compression.aggregator import PushAggregator

                class _StopAwareAggregator(PushAggregator):
                    """Rendezvous combiner whose shutdown is decided AT
                    a barrier round: the action flips ``finished`` when
                    the stop event is set, so every worker observes the
                    flip after the SAME rendezvous and exits in
                    lockstep (no sibling left parked at the barrier)."""

                    finished = False

                    def _combine(self) -> None:
                        super()._combine()
                        if agg_stop.is_set():
                            self.finished = True

                uplink = self._make_train_client(
                    driver, "loadgen-train-uplink"
                )
                push_agg = _StopAwareAggregator(
                    cfg.train_workers, uplink,
                    registry=self.registry, timeout=30.0,
                )
                train_clients.append(uplink)
            else:
                for w in range(cfg.train_workers):
                    train_clients.append(
                        self._make_train_client(
                            driver, f"loadgen-train-{w}"
                        )
                    )

            # warmup (closed loop, unrecorded): every client touches
            # every shard before the open-loop clock starts
            wrng = np.random.default_rng(cfg.seed + 999)
            per_gen = max(1, int(cfg.warmup_requests) // cfg.generators)
            for g in range(cfg.generators):
                for _ in range(per_gen):
                    try:
                        serve_clients[g].pull_batch(
                            workload.soak_read_ids(
                                population.sample(wrng).ids
                            )
                        )
                    except Exception:  # noqa: BLE001 — warmup only
                        pass
            for tc in train_clients:
                for _ in range(4):
                    try:
                        wids, wdeltas = workload.soak_push(
                            wrng, population.sample(wrng).ids
                        )
                        tc.push_batch(wids, wdeltas * 0.0)
                    except Exception:  # noqa: BLE001 — warmup only
                        pass

            t_start = time.perf_counter() + 0.05
            stop = threading.Event()

            deadline_s = (
                cfg.client_deadline_frac * cfg.slo_ms / 1e3
                if cfg.overload_control else None
            )

            def _record_error(req, offset: float, e: BaseException):
                ledger.record(float(offset), "error")
                with err_lock:
                    if req.kind == "serve":
                        serve_errors[0] += 1
                    if len(error_samples) < 12:
                        error_samples.append(
                            f"{req.kind}: {type(e).__name__}: {e}"
                        )

            import queue as _queue

            train_q: "_queue.Queue" = _queue.Queue()

            def _record_pushed(batch, done: float) -> None:
                for offset, target, _req in batch:
                    lat = done - target
                    ledger.record(
                        float(offset),
                        "ok" if lat <= cfg.slo_ms / 1e3 else "late",
                        lat,
                    )

            def train_worker_loop(w: int) -> None:
                rng = np.random.default_rng(cfg.seed + 700 + w)
                client = train_clients[w]
                while True:
                    item = train_q.get()
                    if item is None:
                        return
                    # combination-sender semantics under backlog: drain
                    # whatever else queued and push it as ONE aggregated
                    # batch (duplicate ids sum client-side) — the same
                    # sender-side aggregation the cluster client applies
                    # per frame, lifted to the request queue, which is
                    # what keeps unsheddable write traffic inside its
                    # capacity share under overload
                    batch = [item]
                    while len(batch) < 32:
                        try:
                            nxt = train_q.get_nowait()
                        except _queue.Empty:
                            break
                        if nxt is None:
                            train_q.put(None)  # re-arm shutdown
                            break
                        batch.append(nxt)
                    ids, deltas = workload.soak_push(
                        rng, np.concatenate([b[2].ids for b in batch])
                    )
                    try:
                        client.push_batch(ids, deltas)
                        _record_pushed(batch, time.perf_counter())
                    except Exception as e:  # noqa: BLE001
                        for offset, _target, req in batch:
                            _record_error(req, offset, e)

            def train_worker_agg_loop(w: int) -> None:
                """The aggregation-tree train path: every drain round is
                a rendezvous (possibly with an EMPTY contribution — the
                barrier must see all workers each round), and the
                combiner pushes one merged batch through the uplink.
                Exit is lockstep via the barrier-action stop flag;
                stragglers left in the queue are drained by the main
                thread directly through the uplink."""
                rng = np.random.default_rng(cfg.seed + 700 + w)
                while True:
                    batch = []
                    try:
                        item = train_q.get(timeout=0.05)
                        if item is not None:
                            batch.append(item)
                    except _queue.Empty:
                        pass
                    while batch and len(batch) < 32:
                        try:
                            nxt = train_q.get_nowait()
                        except _queue.Empty:
                            break
                        if nxt is not None:
                            batch.append(nxt)
                    if batch:
                        ids, deltas = workload.soak_push(
                            rng,
                            np.concatenate([b[2].ids for b in batch]),
                        )
                    else:
                        ids = np.empty(0, np.int64)
                        deltas = np.empty(
                            (0,) + tuple(workload.value_shape),
                            np.float32,
                        )
                    try:
                        push_agg.push_batch(w, ids, deltas)
                        if batch:
                            _record_pushed(batch, time.perf_counter())
                    except BaseException as e:  # noqa: BLE001
                        for offset, _target, req in batch:
                            _record_error(req, offset, e)
                        if agg_stop.is_set():
                            return  # barrier broken at teardown
                    if push_agg.finished:
                        return

            def generator_loop(g: int) -> None:
                rng = np.random.default_rng(cfg.seed + 100 + g)
                serve = serve_clients[g]
                for offset in slots[g]:
                    if stop.is_set():
                        # teardown mid-schedule (nemesis wedged the
                        # run): the remainder is recorded as errors —
                        # an arrival we never served is not goodput
                        ledger.record(float(offset), "error")
                        continue
                    target = t_start + float(offset)
                    now = time.perf_counter()
                    if target > now:
                        time.sleep(target - now)
                    req = population.sample(rng)
                    if req.kind == "train":
                        # pushes ride their own worker pool: a write
                        # stalled behind a fault (writes keep the
                        # durability-grade timeout) must never block
                        # this generator's latency-bound serve traffic
                        train_q.put((float(offset), target, req))
                        continue
                    if (
                        deadline_s is not None
                        and time.perf_counter() - target > deadline_s
                    ):
                        with err_lock:
                            deadline_sheds[0] += 1
                        # dead on arrival: the generator is behind
                        # schedule past the deadline budget — shed at
                        # the client edge instead of serving an answer
                        # nobody is waiting for
                        ledger.record(
                            float(offset), "shed",
                            time.perf_counter() - target,
                        )
                        if brownout is not None:
                            brownout.note_shed()
                        continue
                    try:
                        serve.pull_batch(workload.soak_read_ids(req.ids))
                        with err_lock:
                            served[0] += 1
                        lat = time.perf_counter() - target
                        ledger.record(
                            float(offset),
                            "ok" if lat <= cfg.slo_ms / 1e3 else "late",
                            lat,
                        )
                        if brownout is not None:
                            brownout.note_ok()
                    except OverloadedError:
                        ledger.record(
                            float(offset), "shed",
                            time.perf_counter() - target,
                        )
                        if brownout is not None:
                            brownout.note_shed()
                    except Exception as e:  # noqa: BLE001 — budgeted
                        _record_error(req, offset, e)

            def nemesis_loop() -> None:
                for at_s, op in sorted(
                    self.config.nemesis, key=lambda e: e[0]
                ):
                    wait = (t_start + float(at_s)) - time.perf_counter()
                    if wait > 0 and stop.wait(wait):
                        return
                    try:
                        _execute_op(driver, op)
                    except Exception:  # noqa: BLE001 — a failed op is
                        pass  # a no-op fault, not a failed soak

            threads = [
                threading.Thread(
                    target=generator_loop, args=(g,),
                    name=f"loadgen-generator-{g}", daemon=True,
                )
                for g in range(cfg.generators)
            ]
            train_threads = [
                threading.Thread(
                    target=(
                        train_worker_agg_loop if push_agg is not None
                        else train_worker_loop
                    ),
                    args=(w,),
                    name=f"loadgen-train-worker-{w}", daemon=True,
                )
                for w in range(cfg.train_workers)
            ]
            nem = threading.Thread(
                target=nemesis_loop, name="loadgen-nemesis", daemon=True
            )
            if controller is not None:
                controller.start()
            nem.start()
            for t in train_threads:
                t.start()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if push_agg is not None:
                # lockstep shutdown at a rendezvous round, then drain
                # stragglers directly through the uplink
                agg_stop.set()
                for t in train_threads:
                    t.join(timeout=60)
                push_agg.abort()
                drain_rng = np.random.default_rng(cfg.seed + 799)
                uplink_client = train_clients[0]
                while True:
                    try:
                        item = train_q.get_nowait()
                    except _queue.Empty:
                        break
                    if item is None:
                        continue
                    offset, target, req = item
                    try:
                        ids, deltas = workload.soak_push(
                            drain_rng, req.ids
                        )
                        uplink_client.push_batch(ids, deltas)
                        _record_pushed(
                            [item], time.perf_counter()
                        )
                    except Exception as e:  # noqa: BLE001
                        _record_error(req, offset, e)
            else:
                # drain the push queue, then release the workers
                for _ in train_threads:
                    train_q.put(None)
                for t in train_threads:
                    t.join(timeout=60)
            stop.set()
            nem.join(timeout=10)
        finally:
            stop.set()
            if controller is not None:
                controller.stop()
            if self.timeline is not None:
                self.timeline.sample()   # final tick: post-run state
                self.timeline.stop()
                self.timeline.mark("soak_end", scenario="soak")
            for proxy in driver.mesh.values():
                proxy.heal()
                proxy.clear_delay()
                proxy.clear_drip()
            acked = sum(c.rows_pushed for c in train_clients)
            for c in serve_clients + train_clients:
                try:
                    c.close()
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass
            applied = sum(sh.rows_applied for sh in driver.all_shards)
            faults = driver.faults_injected()
            driver.stop()
            shutil.rmtree(wal_root, ignore_errors=True)

        # -- the audit --------------------------------------------------------
        widened_bound = int(np.ceil(
            cfg.cache_bound
            * (cfg.brownout_widen if brownout is not None
               and brownout.entries else 1.0)
        ))
        cache_stats: Dict[str, object] = {}
        _summable = (
            "hits", "misses", "fills", "revocations", "stale_rejects",
            "evictions", "entries",
        )
        for c in caches:
            stats = c.stats()
            for k in _summable:
                cache_stats[k] = cache_stats.get(k, 0) + stats[k]
        cache_stats["bound"] = cfg.cache_bound
        cache_stats["widened_bound"] = widened_bound
        cache_stats["max_served_age"] = max(
            (c.stats()["max_served_age"] for c in caches), default=0
        )
        verdicts = [
            check_exactly_once(acked, applied),
            check_lease_staleness(cache_stats, bound=widened_bound),
            check_serving_budget(
                served[0], serve_errors[0],
                budget=cfg.serving_error_budget,
            ),
            thread_ledger.check(),
        ]
        overload_stats: Dict[str, object] = {
            "control": cfg.overload_control,
            "brownouts": 0 if brownout is None else brownout.entries,
            "widen_factor": (
                cfg.brownout_widen if cfg.overload_control else 1.0
            ),
            "wire_format": cfg.wire_format,
            "push_aggregate": push_agg is not None,
        }
        if push_agg is not None:
            overload_stats["combined_pushes"] = push_agg.rounds_combined
            overload_stats["combined_rows_saved"] = max(
                0, push_agg.rows_in - push_agg.rows_pushed
            )
        # push-path codec effect (compression/): bytes the q8 arm kept
        # off the wire, summed over every train client's compressor
        saved = sum(
            int(inst.value)
            for inst in self.registry.instruments()
            if inst.name == "compression_bytes_saved_total"
        )
        if saved:
            overload_stats["compression_bytes_saved"] = saved
        if cfg.overload_control:
            overload_stats["client_deadline_sheds"] = deadline_sheds[0]
            overload_stats["shard_edge_sheds"] = int(sum(
                inst.value
                for inst in self.registry.instruments()
                if inst.name == "overload_shed_total"
                and inst.labels.get("edge") == "shard"
            ))
            overload_stats["budget_exhausted"] = sum(
                c.retry_budget.exhausted for c in serve_clients
                if c.retry_budget is not None
            )
            overload_stats["breakers_open_transitions"] = sum(
                b.transitions["open"]
                for c in serve_clients
                if c.breakers is not None
                for b in c.breakers._breakers.values()
            )
        summary = ledger.summary()
        summary["error_samples"] = list(error_samples)
        return SoakReport(
            summary=summary,
            timeline=ledger.timeline(),
            verdicts=verdicts,
            faults=faults,
            cache=cache_stats,
            overload=overload_stats,
            controller_events=(
                list(controller.events) if controller is not None else []
            ),
            wall_s=time.perf_counter() - t_wall0,
            metric_timeline=(
                self.timeline.payload() if self.timeline is not None
                else None
            ),
        )


def run_soak(config: SoakConfig, *, registry=None,
             timeline=None, device: DeviceLike = None) -> SoakReport:
    """One-call form of :class:`SoakRunner` (on ``device``: the card
    unless the caller passes ``device="cpu"``)."""
    return SoakRunner(
        config, registry=registry, timeline=timeline, device=device
    ).run()


def closed_loop_capacity(
    config: SoakConfig,
    *,
    requests_per_generator: int = 200,
    registry=None,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """CLOSED-loop calibration of one topology: the same population,
    clients and mesh links as the soak, arrivals coupled to
    completions — the sustainable completion rate, which is what the
    open-loop A/B's "2× capacity" is 2× OF.  Overload control is
    forced OFF (a calibration that sheds is measuring the shed
    policy, not the topology) and no nemesis runs.  Returns
    ``capacity_rps`` plus closed-loop p50/p99 (ms) — the curve row is
    a capacity **at the p99 SLO** only when that p99 is under it."""
    from ..hotcache.policy import StaticHotSet

    cfg = dataclasses.replace(
        config, overload_control=False, nemesis=(),
        controller_policy=None,
    )
    runner = SoakRunner(cfg, registry=registry, device=device)
    population = UserPopulation(
        cfg.num_users, cfg.num_items,
        zipf_s=cfg.zipf_s, batch_ids=cfg.batch_ids,
        regions=cfg.regions, seed=cfg.seed,
    )
    policy = StaticHotSet(population.hot_items(cfg.hot_top_n))
    wal_root = tempfile.mkdtemp(prefix="soak-calib-wal-")
    driver = runner._build_driver(wal_root)
    driver.start()
    serve_clients: List = []
    train_clients: List = []
    lat: List[List[float]] = [[] for _ in range(cfg.generators)]
    errors: List[BaseException] = []
    try:
        if cfg.link_delay_ms > 0:
            for proxy in driver.mesh.values():
                proxy.set_delay(cfg.link_delay_ms, 0.0, "c2s")
        for g in range(cfg.generators):
            sc, _cache = runner._make_serve_client(
                driver, f"loadgen-calib-serve-{g}", policy, None
            )
            serve_clients.append(sc)
            train_clients.append(
                runner._make_train_client(
                    driver, f"loadgen-calib-train-{g}"
                )
            )
        workload = runner.workload
        wrng = np.random.default_rng(cfg.seed + 999)
        for g in range(cfg.generators):
            for _ in range(12):
                req = population.sample(wrng)
                serve_clients[g].pull_batch(
                    workload.soak_read_ids(req.ids)
                )
                # pushes too: the first push of each shape pays the
                # device's first scatter-add work, which belongs to
                # warmup, not the measured tail
                wids, wdeltas = workload.soak_push(wrng, req.ids)
                train_clients[g].push_batch(wids, wdeltas * 0.0)

        def loop(g: int) -> None:
            rng = np.random.default_rng(cfg.seed + 500 + g)
            try:
                for _ in range(int(requests_per_generator)):
                    req = population.sample(rng)
                    t0 = time.perf_counter()
                    if req.kind == "serve":
                        serve_clients[g].pull_batch(
                            workload.soak_read_ids(req.ids)
                        )
                    else:
                        train_clients[g].push_batch(
                            *workload.soak_push(rng, req.ids)
                        )
                    lat[g].append(time.perf_counter() - t0)
            except BaseException as e:  # noqa: BLE001 — re-raised
                errors.append(e)

        threads = [
            threading.Thread(
                target=loop, args=(g,),
                name=f"loadgen-calib-{g}", daemon=True,
            )
            for g in range(cfg.generators)
        ]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
    finally:
        for c in serve_clients + train_clients:
            try:
                c.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        driver.stop()
        shutil.rmtree(wal_root, ignore_errors=True)
    all_lat = np.asarray([x for sub in lat for x in sub], np.float64)
    total = int(all_lat.size)
    return {
        "capacity_rps": round(total / wall, 1),
        "requests": total,
        "closed_p50_ms": round(
            float(np.percentile(all_lat, 50)) * 1e3, 3
        ),
        "closed_p99_ms": round(
            float(np.percentile(all_lat, 99)) * 1e3, 3
        ),
        "wall_s": round(wall, 3),
    }


def autoscaler_score(
    timeline: Sequence[Dict[str, int]],
    rate_fn: RateFn,
    max_capacity_rps: float,
    *,
    slo_target: float = 0.9,
) -> Dict[str, object]:
    """Controller quality over a soak timeline: SLO-seconds burned vs
    the ideal controller on the SAME trace.

    A second is BURNED when it saw arrivals and delivered less than
    ``slo_target`` of them as goodput (``ok``).  The ideal controller
    — instantly at the right size, never migrating — still burns the
    seconds where the offered rate exceeds what the largest measured
    configuration can serve (``max_capacity_rps``): no controller can
    scale past the hardware.  Score = 1 − excess burned fraction over
    the seconds the ideal keeps clean; 1.0 = as good as ideal, 0.0 =
    burned everything ideal would have saved."""
    burned = []
    ideal_burned = []
    for row in timeline:
        t = row["t"]
        arr = sum(row[o] for o in OUTCOMES)
        if arr == 0:
            continue
        burned.append(row["ok"] < slo_target * arr)
        ideal_burned.append(rate_fn(t + 0.5) > max_capacity_rps)
    total = len(burned)
    n_burn = sum(burned)
    n_ideal = sum(ideal_burned)
    # only seconds the ideal controller keeps clean count against us
    excess = sum(
        1 for b, i in zip(burned, ideal_burned) if b and not i
    )
    saveable = total - n_ideal
    score = 1.0 if saveable <= 0 else max(0.0, 1.0 - excess / saveable)
    return {
        "slo_seconds_burned": int(n_burn),
        "ideal_slo_seconds_burned": int(n_ideal),
        "excess_slo_seconds": int(excess),
        "active_seconds": int(total),
        "score": round(score, 4),
        "slo_target": slo_target,
    }


__all__ = [
    "GoodputLedger",
    "OUTCOMES",
    "SoakConfig",
    "SoakReport",
    "SoakRunner",
    "autoscaler_score",
    "closed_loop_capacity",
    "run_soak",
]
