"""ReplicatedClusterDriver — the elastic cluster with replica chains.

Counterpart of ``flink_parameter_server_tpu/replication/driver.py``.
Primaries and followers keep their slices on the driver's ``device`` (the
card unless the caller passes ``device="cpu"``); the shards take the
store's ``"xla"`` arm as the reference's do, so no kernel of the port runs
in a replicated cluster.

Everything :class:`~..elastic.controller.ElasticClusterDriver` does —
live resize, dead-shard replacement, epoch-fenced routing — plus: each
primary ships its WAL to ``replication_factor`` followers (chain.py /
shipper.py), clients load-balance reads across each chain under the
staleness contract (follower.py + cluster/client.py read routing), and
a dead or heartbeat-silent primary is **promoted over**, not rebuilt
(failover.py) — recovery in O(lag) instead of O(log).

Division of labor with the controller: this driver is mechanism
(:meth:`promote_shard`, :meth:`can_promote`, heartbeat-aware
:meth:`shard_alive`); :class:`~..elastic.controller.ElasticController`
is policy — its dead-shard branch prefers ``promote`` over ``replace``
whenever a chain exists, so missed heartbeats converge to a follower
flip without any new control loop.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from ..elastic.controller import ElasticClusterConfig, ElasticClusterDriver
from .chain import ChainManager
from .failover import PromoteReport, promote


@dataclasses.dataclass
class ReplicatedClusterConfig(ElasticClusterConfig):
    """ElasticClusterConfig + the chain knobs.  ``wal_dir`` is
    REQUIRED — the WAL is the replication stream."""

    # followers per primary (1–2 is the chain story; more works)
    replication_factor: int = 1
    # follower read-staleness bound in WAL records; None derives it
    # from the SSP bound: (staleness_bound + 1) × num_workers records
    # ≈ one full SSP window of pushes (unbounded when the clock is
    # async).  See docs/elastic.md "read-staleness contract".
    follower_staleness_bound: Optional[int] = None
    # promotion: salvage the dead primary's on-disk WAL tail, and
    # optionally audit the promoted table bitwise against its replayed
    # log AFTER the flip (O(log) — integrity, not availability)
    salvage_primary_wal: bool = True
    verify_promotion: bool = False
    # replication-plane sockets run on tight timeouts: failure
    # detection for failover cannot sit behind the client's 30 s read
    repl_connect_timeout: float = 2.0
    repl_request_timeout: float = 5.0
    heartbeat_interval_s: float = 0.05
    heartbeat_timeout_s: float = 0.5
    # do WORKER clients read through the chain?  None derives it from
    # the clock: BSP (staleness_bound=0) keeps worker reads on the
    # primary — an async follower read can trail by one round, which
    # would silently break BSP's read-your-last-round guarantee (and
    # bitwise parity); SSP/async clocks already tolerate that lag, so
    # their workers enjoy chain reads.  Serving lookups
    # (serving/follower.py) always read through the chain.
    worker_read_replicas: Optional[bool] = None
    # chaos injection point for the repl stream (FaultPlan.shipper_hook)
    repl_fault_hook: Optional[Callable[[int], Optional[str]]] = None
    # delta encoding of the repl stream (compression/quantizers.py,
    # docs/compression.md): "f32" ships bitwise records (default —
    # the caught-up follower is bitwise the primary); "q8" ships
    # per-row-scaled int8 deltas with per-leg error-feedback residuals
    # — the follower tracks within one quantization granule per id and
    # the stream carries ~4× fewer delta bytes (the replication-lag
    # win on bandwidth-constrained legs).  Loads and epoch snapshots
    # always ship bitwise.
    repl_wire_format: str = "f32"


class ReplicatedClusterDriver(ElasticClusterDriver):
    """An elastic cluster whose shards are replica chains."""

    def __init__(self, logic, **kwargs):
        config = kwargs.get("config")
        if config is None:
            kwargs["config"] = config = ReplicatedClusterConfig()
        if config.wal_dir is None:
            raise ValueError(
                "replica chains need wal_dir: the WAL is the "
                "replication stream (and the follower ack's durability)"
            )
        super().__init__(logic, **kwargs)
        self.chains: Optional[ChainManager] = None
        self._wal_dir_overrides: Dict[int, str] = {}
        if self.registry is not None:
            self._c_failovers = self.registry.counter(
                "replication_failovers_total", component="replication"
            )
            self._h_failover = self.registry.histogram(
                "replication_failover_seconds", component="replication"
            )
        else:
            self._c_failovers = self._h_failover = None

    # -- WAL-dir indirection (a promotion re-homes a shard's log) ------------
    def _wal_dir_for(self, shard_id: int) -> Optional[str]:
        override = self._wal_dir_overrides.get(shard_id)
        if override is not None:
            return override
        return super()._wal_dir_for(shard_id)

    def set_wal_dir(self, shard_id: int, path: str) -> None:
        self._wal_dir_overrides[int(shard_id)] = path

    # -- lifecycle -----------------------------------------------------------
    def _worker_read_replicas(self) -> bool:
        cfg = self.config
        if cfg.worker_read_replicas is not None:
            return bool(cfg.worker_read_replicas)
        return cfg.staleness_bound != 0  # BSP reads stay on the primary

    def _make_client(self, worker: Optional[str] = None):
        client = super()._make_client(worker)
        client._read_replicas = self._worker_read_replicas()
        return client

    def _follower_bound(self) -> Optional[int]:
        cfg = self.config
        if cfg.follower_staleness_bound is not None:
            return cfg.follower_staleness_bound
        if cfg.staleness_bound is None:
            return None  # async clock → async reads
        return (int(cfg.staleness_bound) + 1) * int(cfg.num_workers)

    def _on_servers_started(self) -> None:
        from ..elastic.membership import MembershipService

        cfg = self.config
        self.chains = ChainManager(
            self,
            replication_factor=cfg.replication_factor,
            staleness_bound=self._follower_bound(),
            registry=self.registry if self.registry is not None else False,
            fault_hook=cfg.repl_fault_hook,
            connect_timeout=cfg.repl_connect_timeout,
            request_timeout=cfg.repl_request_timeout,
            heartbeat_interval_s=cfg.heartbeat_interval_s,
            heartbeat_timeout_s=cfg.heartbeat_timeout_s,
            repl_enc=cfg.repl_wire_format,
        )
        self.chains.build_all()
        self.membership = MembershipService(
            self.partitioner,
            [(srv.host, srv.port) for srv in self.servers],
            replicas=self.chains.replica_addresses(),
            registry=(
                self.registry if self.registry is not None else False
            ),
        )
        self.all_shards = list(self.shards)
        self.chains.start_heartbeats()

    def stop(self) -> None:
        if self.chains is not None:
            self.chains.stop()
            self.chains = None
        super().stop()

    # -- liveness (the controller's promote trigger) -------------------------
    def shard_alive(self, shard_id: int) -> bool:
        if not super().shard_alive(shard_id):
            return False
        if self.chains is not None and self.chains.primary_stalled(
            shard_id
        ):
            return False  # wedged, not just dead: missed heartbeats
        return True

    def can_promote(self, shard_id: int) -> bool:
        return self.chains is not None and self.chains.has_followers(
            shard_id
        )

    # -- failover ------------------------------------------------------------
    def promote_shard(self, shard_id: int) -> PromoteReport:
        """Promote the most-caught-up follower over a dead/wedged
        primary (replication/failover.py) — O(lag), one epoch flip."""
        cfg = self.config
        return promote(
            self, shard_id,
            salvage=cfg.salvage_primary_wal,
            verify=cfg.verify_promotion,
        )

    # -- resizes re-seed the affected chains ---------------------------------
    def _publish_replicas(self) -> None:
        self.membership.publish(
            self.partitioner, self._addresses(),
            replicas=self.chains.replica_addresses(),
        )

    def scale_out(self, add: int = 1):
        with self._resize_lock:
            self.chains.detach_all()
            report = super().scale_out(add)
            self.chains.build_all()
            self._publish_replicas()
            return report

    def scale_in(self, remove: int = 1):
        with self._resize_lock:
            self.chains.detach_all()
            report = super().scale_in(remove)
            self.chains.build_all()
            self._publish_replicas()
            return report

    def replace_shard(self, shard_id: int) -> int:
        with self._resize_lock:
            self.chains.detach_chain(shard_id)
            replayed = super().replace_shard(shard_id)
            self.chains.build_chain(shard_id)
            self._publish_replicas()
            return replayed


__all__ = ["ReplicatedClusterConfig", "ReplicatedClusterDriver"]
