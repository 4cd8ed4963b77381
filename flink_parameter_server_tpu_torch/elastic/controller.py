"""The elastic control plane: resizable cluster + metrics-driven policy.

Counterpart of ``flink_parameter_server_tpu/elastic/controller.py``.  The
mechanism and the policy are the reference's; the shards it resizes keep
their slices on the driver's device (the card unless the caller passes
``device="cpu"``), migrated rows move off and onto the card bitwise
(``elastic/migration.py``), and the worker clients take the cluster
driver's BSP and increment carve-outs on the wire format.  What leads into
modules not ported yet raises ``NotImplementedError`` naming its ROADMAP
Queue 1 #7 item: ``drain_shard`` (adaptive/rebalance) and the push hedger
(behind the ``adaptive`` knob, which the cluster driver already rejects);
the controller promotes a follower over a dead shard that has a replica
chain (``replication/``) and replaces one without a chain from its WAL.
``store_backend="mesh"`` and
``shard_procs=True`` raise under this driver, as the reference's do: the
control plane drives in-process, socket-fronted shard handles.

Two layers, deliberately separate:

  * :class:`ElasticClusterDriver` — MECHANISM.  A
    :class:`~..cluster.driver.ClusterDriver` whose shard set can change
    while a job runs: ``scale_out()`` (spin up shards, migrate the
    rendezvous-moved key ranges, flip the epoch), ``scale_in()``
    (drain-and-retire the highest shards), ``replace_shard()``
    (rebuild a dead shard bitwise from its WAL, re-publish its
    address).  Every resize is serialized under one lock and ends with
    a single membership publish — workers never see a half-flipped
    map, only ``stale-epoch``/``frozen`` rejections their client
    converts into a refresh + replay (latency, not errors).
  * :class:`ElasticController` — POLICY.  Watches the telemetry
    registry the cluster already publishes to — windowed
    ``cluster_pull_rtt_seconds`` p99, live shard queue depth, the SSP
    staleness spread, and, when given, an SLO engine's breaches
    (``slo=``) and a timeline recorder's new anomaly firings
    (``timeline=``) — plus shard liveness, and drives the mechanism:
    replace dead shards immediately, scale out past the pressure
    thresholds, scale in below the idle threshold, all behind a
    cooldown so one burst doesn't saw the topology.

This is the ROADMAP north-star's "resize and route around stragglers
while training continues" (arXiv:2204.03211's elastic aggregation +
the straggler study arXiv:2308.15482), landed on the cluster runtime.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..cluster.client import ClusterClient
from ..cluster.driver import ClusterConfig, ClusterDriver
from ..cluster.partition import ConsistentHashPartitioner
from ..telemetry.flightrec import get_recorder
from ..telemetry.timeline import percentile_from_counts
from .hedging import HedgeBudget, Hedger
from .membership import MembershipService
from .migration import MigrationReport, execute_moves, plan_moves

# migration stalls are ms-scale (freeze → flip covers only the WAL
# tail); buckets resolve that range instead of the default's seconds
STALL_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5,
)


@dataclasses.dataclass
class ElasticClusterConfig(ClusterConfig):
    """ClusterConfig + the elastic knobs.  ``partition`` defaults to
    the rendezvous map — the one whose growth/shrink moves only the
    necessary keys (cluster/partition.py)."""

    partition: str = "hash"
    # pull hedging (elastic/hedging.py): None disables; otherwise the
    # silence threshold after which a budgeted backup pull races
    hedge_after_s: Optional[float] = None
    hedge_max_fraction: float = 0.1
    # client retry budget for rejected/re-routed frames
    retry_timeout: float = 30.0
    # bitwise-compare every migrated range before the flip (cheap at
    # test scale; production tables may prefer sampling = False)
    verify_migrations: bool = True


class ElasticClusterDriver(ClusterDriver):
    """A cluster whose shard set is a runtime variable.

    Everything :class:`~..cluster.driver.ClusterDriver` runs, runs
    here unchanged — same worker loop, same BSP/SSP clock, same wire —
    plus the resize surface.  Requires the consistent-hash partitioner
    (range splits move every boundary on resize; rendezvous moves only
    the keys that must)."""

    def __init__(self, logic, **kwargs):
        config = kwargs.get("config")
        if config is None:
            kwargs["config"] = config = ElasticClusterConfig()
        super().__init__(logic, **kwargs)
        if not isinstance(self.partitioner, ConsistentHashPartitioner):
            raise ValueError(
                "elastic resize needs the consistent-hash partitioner "
                "(partition='hash'): range splits move every key "
                "boundary on a shard-count change"
            )
        self.membership: Optional[MembershipService] = None
        self.all_shards: List = []  # every shard ever live (audit)
        self._retired: List[Tuple] = []  # (shard, server) after scale-in
        self._resize_lock = threading.RLock()
        self.resize_reports: List[MigrationReport] = []
        if self.registry is not None:
            self._h_stall = self.registry.histogram(
                "elastic_migration_stall_seconds", component="elastic",
                buckets=STALL_BUCKETS,
            )
            self._c_replacements = self.registry.counter(
                "elastic_shard_replacements_total", component="elastic"
            )
            self.registry.gauge(
                "elastic_num_shards", component="elastic",
                fn=lambda: self.partitioner.num_shards,
            )
        else:
            self._h_stall = self._c_replacements = None

    # -- lifecycle ----------------------------------------------------------
    def _on_servers_started(self) -> None:
        self.membership = MembershipService(
            self.partitioner,
            [(srv.host, srv.port) for srv in self.servers],
            registry=(
                self.registry if self.registry is not None else False
            ),
        )
        self.all_shards = list(self.shards)

    def _make_client(self, worker: Optional[str] = None) -> ClusterClient:
        # (the adaptive push hedger would be built here; the cluster
        # driver rejects ``adaptive=True`` until adaptive/ is ported)
        cfg = self.config
        hedge = None
        if getattr(cfg, "hedge_after_s", None):
            hedge = Hedger(
                cfg.hedge_after_s,
                budget=HedgeBudget(cfg.hedge_max_fraction),
                registry=(
                    self.registry if self.registry is not None else False
                ),
            )
        return ClusterClient(
            value_shape=self.value_shape,
            window=cfg.window,
            chunk=cfg.chunk,
            timeout=cfg.request_timeout,
            connect_timeout=getattr(cfg, "connect_timeout", 5.0),
            wire_format=cfg.wire_format,
            wire_proto=cfg.wire_proto,
            registry=self.registry if self.registry is not None else False,
            worker=worker,
            membership=self.membership,
            hedge=hedge,
            retry_timeout=getattr(cfg, "retry_timeout", 30.0),
            tracer=self.client_tracer,
            profiler=None if cfg.profile else False,
        )

    def stop(self) -> None:
        with self._resize_lock:
            for shard, server in self._retired:
                server.stop()
                shard.close()
            self._retired = []
            super().stop()
            self.all_shards = []

    # -- observability ------------------------------------------------------
    def shard_alive(self, shard_id: int) -> bool:
        if not 0 <= shard_id < len(self.shards):
            return False
        return (
            self.servers[shard_id].running
            and self.shards[shard_id].store is not None
        )

    def kill_shard(self, shard_id: int) -> None:
        """Chaos hook: take the shard's server down AND drop its slice
        — the full process-death simulation (clients get connection
        errors until :meth:`replace_shard` publishes a successor)."""
        self.servers[shard_id].stop()
        self.shards[shard_id].crash()
        rec = get_recorder()
        if rec is not None:
            rec.note("shard_kill", shard=shard_id)

    def _addresses(self) -> List[Tuple[str, int]]:
        return [(srv.host, srv.port) for srv in self.servers]

    # -- resize: mechanism --------------------------------------------------
    def scale_out(self, add: int = 1) -> MigrationReport:
        """Grow the shard set by ``add`` while the job runs: spin up
        the new shards (no traffic yet — the live map does not route
        to them), migrate exactly the rendezvous-moved ranges
        (bitwise, WAL-consistent: elastic/migration.py), then flip the
        epoch in one publish."""
        if add < 1:
            raise ValueError(f"add={add}: must be >= 1")
        with self._resize_lock:
            if not self._started:
                raise RuntimeError("scale_out on a stopped driver")
            old_part = self.partitioner
            new_part = old_part.grown(old_part.num_shards + add)
            new_pairs = [
                self._build_shard(s, new_part)
                for s in range(old_part.num_shards, new_part.num_shards)
            ]
            try:
                report = self._migrate_and_flip(
                    old_part, new_part,
                    shards=self.shards + [sh for sh, _ in new_pairs],
                    servers=self.servers + [sv for _, sv in new_pairs],
                )
            except BaseException:
                for sh, sv in new_pairs:
                    sv.stop()
                    sh.close()
                for shard in self.shards:
                    shard.unfreeze()
                raise
            self.shards.extend(sh for sh, _ in new_pairs)
            self.servers.extend(sv for _, sv in new_pairs)
            self.all_shards.extend(sh for sh, _ in new_pairs)
            return report

    def scale_in(self, remove: int = 1) -> MigrationReport:
        """Drain-and-retire the ``remove`` HIGHEST-indexed shards (the
        rendezvous shrink direction): their keys migrate to the
        survivors that rendezvous scoring hands them back to, the
        epoch flips, and only then do the retired servers stop — an
        in-flight old-map pull drains instead of erroring."""
        if remove < 1:
            raise ValueError(f"remove={remove}: must be >= 1")
        with self._resize_lock:
            if not self._started:
                raise RuntimeError("scale_in on a stopped driver")
            old_part = self.partitioner
            keep = old_part.num_shards - remove
            if keep < 1:
                raise ValueError(
                    f"scale_in({remove}) would leave {keep} shards"
                )
            new_part = old_part.shrunk(keep)
            try:
                report = self._migrate_and_flip(
                    old_part, new_part,
                    shards=self.shards, servers=self.servers,
                )
            except BaseException:
                for shard in self.shards:
                    shard.unfreeze()
                raise
            retiring = list(
                zip(self.shards[keep:], self.servers[keep:])
            )
            self.shards = self.shards[:keep]
            self.servers = self.servers[:keep]
            for shard, server in retiring:
                server.stop()
                shard.close()
                self._retired.append((shard, server))
            return report

    def drain_shard(
        self, shard_id: int, *, weight: float = 0.0
    ) -> MigrationReport:
        """Adaptive rebalance actuator (the reference's
        adaptive/rebalance.py): lower ``shard_id``'s rendezvous weight
        so its keys migrate onto the healthy shards.  Its weighted
        partitioner (``DrainedHashPartitioner``) comes with adaptive/,
        so this raises until then."""
        raise NotImplementedError(
            "drain_shard: the weighted drain partitioner "
            "(adaptive/rebalance.py) is not ported yet (ROADMAP Queue 1 "
            "#7, adaptive/)"
        )

    def _migrate_and_flip(
        self, old_part, new_part, *, shards, servers
    ) -> MigrationReport:
        """Shared resize tail: run the data plane, then the one-shot
        flip — install on every shard (retiring shards get the
        terminal :meth:`~..cluster.shard.ParamShard.retire`), publish
        the map, observe the stall histogram."""
        cfg = self.config
        shards_by_id = {sh.shard_id: sh for sh in shards}
        addr_by_id = {
            sh.shard_id: (sv.host, sv.port)
            for sh, sv in zip(shards, servers)
        }
        moves = plan_moves(old_part, new_part)
        report = execute_moves(
            moves, shards_by_id, addr_by_id, self.value_shape,
            chunk=cfg.chunk,
            verify=getattr(cfg, "verify_migrations", True),
            registry=self.registry,
            tracer=self.client_tracer,
            timeout=cfg.request_timeout,
            connect_timeout=getattr(cfg, "connect_timeout", 5.0),
        )
        epoch = self.membership.current().epoch + 1
        for sh in shards:
            if sh.shard_id < new_part.num_shards:
                sh.install_epoch(epoch, new_part)
            else:
                sh.retire(epoch)
        self.partitioner = new_part
        live = [
            (sv.host, sv.port)
            for sh, sv in zip(shards, servers)
            if sh.shard_id < new_part.num_shards
        ]
        self.membership.publish(new_part, live)
        now = time.monotonic()
        for _src, t0 in report.freeze_started.items():
            if self._h_stall is not None:
                self._h_stall.observe(now - t0)
        self.resize_reports.append(report)
        rec = get_recorder()
        if rec is not None:
            rec.note(
                "epoch_flip", epoch=epoch,
                num_shards=new_part.num_shards,
                rows_moved=report.rows_moved,
                tail_rows=report.tail_rows,
            )
        return report

    def replace_shard(self, shard_id: int) -> int:
        """Supervised replacement of a dead shard: rebuild it bitwise
        from its WAL (deterministic init + replay — the shard recovery
        contract), serve it on a fresh port, publish the new address
        under a new epoch.  Clients retrying against the dead address
        pick up the successor on their next refresh.  Returns the
        number of WAL records replayed."""
        with self._resize_lock:
            if not 0 <= shard_id < len(self.shards):
                raise ValueError(f"no shard {shard_id}")
            if self.config.wal_dir is None:
                raise RuntimeError(
                    "replace_shard needs wal_dir: without the log a "
                    "replacement would silently re-init the slice and "
                    "lose every update it ever absorbed"
                )
            old_shard, old_server = (
                self.shards[shard_id], self.servers[shard_id]
            )
            old_server.stop()
            old_shard.close()  # release the WAL file handle FIRST
            shard, server = self._build_shard(shard_id, self.partitioner)
            replayed = self._last_replay_count(shard)
            shard.epoch = self.membership.current().epoch
            self.shards[shard_id] = shard
            self.servers[shard_id] = server
            self.all_shards.append(shard)
            self.membership.publish(self.partitioner, self._addresses())
            if self._c_replacements is not None:
                self._c_replacements.inc()
            rec = get_recorder()
            if rec is not None:
                rec.note(
                    "shard_replace", shard=shard_id, replayed=replayed,
                    epoch=self.membership.current().epoch,
                )
            return replayed

    @staticmethod
    def _last_replay_count(shard) -> int:
        # ParamShard replays during construction; the count is its
        # push_seq cursor (records it walked)
        return int(shard._push_seq)


@dataclasses.dataclass
class ScalePolicy:
    """The controller's thresholds.  RTT numbers are WINDOWED p99s
    (since the last evaluation), not run-cumulative — a cold-start
    spike ages out instead of pinning the policy forever."""

    min_shards: int = 1
    max_shards: int = 8
    scale_out_rtt_p99_s: float = 0.025
    scale_in_rtt_p99_s: float = 0.002
    scale_out_queue_depth: float = 16.0
    scale_out_staleness: Optional[int] = None  # None = staleness off
    min_window_frames: int = 50  # don't act on a starved window
    cooldown_s: float = 5.0
    # scale-in hysteresis: require this many CONSECUTIVE idle
    # evaluations before shrinking (1 = act on the first, the
    # pre-soak behaviour).  Oscillating load at the scale boundary
    # flips the windowed p99 above/below the thresholds every window;
    # cooldown bounds the action RATE, this bounds the decision —
    # one noisy idle window must not retire a shard the next window
    # would want back (tests/test_loadgen.py flapping regression).
    scale_in_consecutive: int = 1


class ElasticController:
    """Metrics → resize decisions, on a poll loop or by explicit
    :meth:`step` calls (tests drive it synchronously).

    Decision order per evaluation (first match wins):

      1. a dead (or heartbeat-silent) shard → ``promote`` when the
         driver has a replica chain for it (O(lag) failover,
         replication/failover.py), else ``replace`` (O(log) WAL
         rebuild) — both ignore cooldown, a dead shard is degrading
         every batch that routes to it;
      2. windowed pull p99 / max queue depth / staleness spread above
         the scale-out thresholds → ``scale_out`` (until
         ``max_shards``);
      3. windowed pull p99 below the idle threshold → ``scale_in``
         (until ``min_shards``).
    """

    def __init__(
        self,
        driver: ElasticClusterDriver,
        *,
        policy: Optional[ScalePolicy] = None,
        registry=None,
        interval_s: float = 0.5,
        slo=None,
        timeline=None,
    ):
        self.driver = driver
        self.policy = policy if policy is not None else ScalePolicy()
        # optional SLO engine (telemetry/slo.py): a breached objective
        # is a scale-out pressure signal alongside the raw thresholds —
        # the declarative form of the same policy
        self.slo = slo
        # optional timeline recorder (telemetry/timeline.py): NEW
        # detector firings since the last evaluation are scale-out
        # pressure alongside SLO breaches
        self.timeline = timeline
        self._anomaly_cursor = 0
        self.registry = (
            registry if registry is not None else driver.registry
        )
        if self.registry is None:
            raise ValueError(
                "ElasticController needs a registry to watch (the "
                "driver was built with registry=False)"
            )
        self.interval_s = float(interval_s)
        self.events: List[dict] = []
        self._seen_buckets: Dict[int, List[int]] = {}
        self._last_action_t = -float("inf")
        self._idle_streak = 0  # consecutive idle windows (hysteresis)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- metric reads -------------------------------------------------------
    def _windowed_rtt_p99(self) -> Tuple[Optional[float], int]:
        """p99 over every client's ``cluster_pull_rtt_seconds`` since
        the LAST call (bucket-count deltas merged across instruments)."""
        merged: Optional[List[int]] = None
        bounds = None
        for inst in self.registry.instruments():
            if (
                inst.name != "cluster_pull_rtt_seconds"
                or inst.kind != "histogram"
            ):
                continue
            counts = inst.bucket_counts()
            prev = self._seen_buckets.get(id(inst), [0] * len(counts))
            self._seen_buckets[id(inst)] = counts
            delta = [c - p for c, p in zip(counts, prev)]
            if merged is None:
                merged = delta
                bounds = inst.bounds
            else:
                merged = [m + d for m, d in zip(merged, delta)]
        if merged is None:
            return None, 0
        frames = sum(merged)
        if frames == 0:
            return None, 0
        return percentile_from_counts(bounds, merged, 99.0), frames

    def _max_queue_depth(self) -> float:
        worst = 0.0
        for inst in self.registry.instruments():
            if inst.name == "cluster_shard_queue_depth":
                v = inst.value
                if v is not None:
                    worst = max(worst, float(v))
        return worst

    def _staleness(self) -> Optional[float]:
        for inst in self.registry.instruments():
            if inst.name == "cluster_staleness_steps":
                return inst.value
        return None

    # -- decide / act -------------------------------------------------------
    def evaluate(self) -> Optional[dict]:
        """The decision WITHOUT the action (pure-ish: reads metrics,
        advances the p99 window)."""
        pol = self.policy
        n = self.driver.partitioner.num_shards
        for s in range(n):
            if not self.driver.shard_alive(s):
                # a dead/heartbeat-silent primary with a replica chain
                # is PROMOTED over (replication/failover.py — O(lag)),
                # not rebuilt from its full WAL (replace — O(log))
                can_promote = getattr(self.driver, "can_promote", None)
                if can_promote is not None and can_promote(s):
                    return {"action": "promote", "shard": s}
                return {"action": "replace", "shard": s}
        p99, frames = self._windowed_rtt_p99()
        depth = self._max_queue_depth()
        staleness = self._staleness()
        slo_breaches: List[str] = []
        if self.slo is not None:
            self.slo.sample()
            slo_breaches = self.slo.breached()
        anomalies: List[str] = []
        if self.timeline is not None:
            ledger = self.timeline.anomalies()
            anomalies = [
                f"{a['metric']}/{a['kind']}"
                for a in ledger[self._anomaly_cursor:]
            ]
            self._anomaly_cursor = len(ledger)
        decision: Optional[dict] = None
        pressured = (
            (
                p99 is not None
                and frames >= pol.min_window_frames
                and p99 > pol.scale_out_rtt_p99_s
            )
            or depth > pol.scale_out_queue_depth
            or (
                pol.scale_out_staleness is not None
                and staleness is not None
                and staleness > pol.scale_out_staleness
            )
            or bool(slo_breaches)
            or bool(anomalies)
        )
        idle = (
            p99 is not None
            and frames >= pol.min_window_frames
            and p99 < pol.scale_in_rtt_p99_s
            and depth <= 1.0
        )
        if pressured:
            self._idle_streak = 0
            if n < pol.max_shards:
                decision = {
                    "action": "scale_out", "p99_s": p99, "depth": depth,
                    "staleness": staleness, "frames": frames,
                    "slo_breaches": slo_breaches,
                    "timeline_anomalies": anomalies,
                }
        elif idle:
            # hysteresis: one idle window is a data point, not a
            # decision — shrink only after scale_in_consecutive of
            # them in a row (flapping load resets the streak above)
            self._idle_streak += 1
            if (
                self._idle_streak >= pol.scale_in_consecutive
                and n > pol.min_shards
            ):
                decision = {
                    "action": "scale_in", "p99_s": p99, "frames": frames,
                    "idle_streak": self._idle_streak,
                }
        else:
            self._idle_streak = 0
        return decision

    def step(self) -> Optional[dict]:
        """One evaluate-and-act cycle; returns the action record (with
        outcome) or None."""
        decision = self.evaluate()
        if decision is None:
            return None
        now = time.monotonic()
        if (
            decision["action"] not in ("replace", "promote")
            and now - self._last_action_t < self.policy.cooldown_s
        ):
            return None
        try:
            if decision["action"] == "replace":
                decision["replayed"] = self.driver.replace_shard(
                    decision["shard"]
                )
            elif decision["action"] == "promote":
                report = self.driver.promote_shard(decision["shard"])
                decision["follower"] = report.follower
                decision["failover_seconds"] = report.failover_seconds
                decision["records_caught_up"] = report.records_caught_up
                decision["records_salvaged"] = report.records_salvaged
            elif decision["action"] == "scale_out":
                decision["report_rows"] = self.driver.scale_out().rows_moved
            elif decision["action"] == "scale_in":
                decision["report_rows"] = self.driver.scale_in().rows_moved
                self._idle_streak = 0  # fresh streak per shrink
            decision["ok"] = True
        except Exception as e:  # noqa: BLE001 — policy must not die
            decision["ok"] = False
            decision["error"] = f"{type(e).__name__}: {e}"
        self._last_action_t = time.monotonic()
        decision["num_shards"] = self.driver.partitioner.num_shards
        self.events.append(decision)
        return decision

    # -- the loop -----------------------------------------------------------
    def start(self) -> "ElasticController":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="elastic-controller", daemon=True
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except Exception:  # noqa: BLE001 — the loop must survive
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def __enter__(self) -> "ElasticController":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


__all__ = [
    "ElasticClusterConfig",
    "ElasticClusterDriver",
    "ElasticController",
    "ScalePolicy",
    "STALL_BUCKETS",
]
