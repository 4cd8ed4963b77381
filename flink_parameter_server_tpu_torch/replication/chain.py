"""Replica chains — per-shard follower sets + the primary health plane.

Counterpart of ``flink_parameter_server_tpu/replication/chain.py``.  Each
follower is built on its driver's device (``ReplicatedClusterDriver``'s
``device``, the card unless the caller asks for the CPU), with the torch
store backend its primary runs.

One :class:`ReplicaChain` per primary shard: 1–2
:class:`~.follower.ReplicaShard` instances (each behind its own
:class:`~..cluster.shard.ShardServer` TCP front end, each with its own
WAL), fed by one :class:`~.shipper.WALShipper` leg per follower off
the primary's :class:`~.shipper.ReplHub`.  The
:class:`ChainManager` owns every chain of a
:class:`~.driver.ReplicatedClusterDriver`, publishes the follower
addresses into the membership view (clients load-balance reads across
them), and runs the **heartbeat plane**: a poll thread pings each
primary over the wire (``stats`` — a real liveness probe through the
same socket path clients use) and beats a
:class:`~..resilience.health.HealthMonitor` per shard.  A primary
whose heartbeat age crosses the threshold is *stalled* — the signal
:class:`~..elastic.controller.ElasticController` turns into a
promotion (missed heartbeats → failover), without waiting for a 30 s
client read to time out.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

from ..cluster.shard import ShardServer
from ..resilience.health import HealthMonitor
from ..utils.net import request_lines
from .follower import ReplicaShard
from .shipper import ReplHub, WALShipper


@dataclasses.dataclass
class ReplicaChain:
    """One primary's replication leg set (parallel lists by follower
    index)."""

    shard_id: int
    hub: ReplHub
    followers: List[ReplicaShard]
    servers: List[ShardServer]
    shippers: List[WALShipper]

    def addresses(self) -> Tuple[Tuple[str, int], ...]:
        return tuple((srv.host, srv.port) for srv in self.servers)

    def lags(self) -> List[int]:
        return [s.lag() for s in self.shippers]

    def most_caught_up(self) -> int:
        """Follower index with the most durable log — the promotion
        candidate (``logged`` end seq; ties break to the lowest
        index)."""
        best, best_logged = 0, -1
        for i, f in enumerate(self.followers):
            logged = f.repl_state()["logged"]
            if logged > best_logged:
                best, best_logged = i, logged
        return best

    def stop_shipping(self) -> None:
        for sh in self.shippers:
            sh.stop()
        self.shippers = []

    def stop(self, *, close_followers: bool = True) -> None:
        self.stop_shipping()
        for srv, f in zip(self.servers, self.followers):
            srv.stop()
            if close_followers:
                f.close()
        self.servers = []
        self.followers = []


class ChainManager:
    """Build/track/stop the chains of one replicated driver + the
    primary heartbeat plane (see module docstring)."""

    def __init__(
        self,
        driver,
        *,
        replication_factor: int = 1,
        staleness_bound: Optional[int] = None,
        registry=None,
        fault_hook=None,
        on_kill_primary=None,
        connect_timeout: float = 2.0,
        request_timeout: float = 5.0,
        heartbeat_interval_s: float = 0.05,
        heartbeat_timeout_s: float = 0.5,
        repl_enc: str = "f32",
    ):
        if replication_factor < 1:
            raise ValueError(
                f"replication_factor={replication_factor}: must be >= 1"
            )
        # per-leg delta encoding (compression/, docs/compression.md):
        # "q8" ships quantized push records with per-leg error-feedback
        # residuals — follower within one granule per id, ~4× fewer
        # delta bytes; "f32" (default) keeps the bitwise contract
        self.repl_enc = str(repl_enc)
        self.driver = driver
        self.replication_factor = int(replication_factor)
        self.staleness_bound = staleness_bound
        self.registry = registry
        self._fault_hook = fault_hook
        self._connect_timeout = float(connect_timeout)
        self._request_timeout = float(request_timeout)
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.chains: Dict[int, ReplicaChain] = {}
        self.monitor = HealthMonitor(registry=False)
        self._lock = threading.Lock()
        # follower WAL dirs are generation-stamped: a re-seeded chain
        # (post-promotion, post-resize) must never append into a
        # directory a previous generation — possibly the CURRENT
        # primary's promoted log — still owns
        self._generation: Dict[int, int] = {}
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        if registry is not False and registry is not None:
            registry.gauge(
                "replication_chain_followers", component="replication",
                fn=lambda: sum(
                    len(c.followers) for c in list(self.chains.values())
                ),
            )

    # -- building ------------------------------------------------------------
    def _follower_wal_dir(self, shard_id: int, idx: int, gen: int) -> str:
        base = self.driver._wal_dir_for(shard_id)
        return f"{base}-f{idx}" if gen == 0 else f"{base}-f{idx}-g{gen}"

    def build_chain(self, shard_id: int) -> ReplicaChain:
        """Followers + servers + shipper legs for one primary.  The
        shippers bootstrap through the resync path (the primary's
        backlog from its newest snapshot barrier), so a chain attached
        to a non-empty primary converges without special casing."""
        drv = self.driver
        primary = drv.shards[shard_id]
        hub = ReplHub()
        followers: List[ReplicaShard] = []
        servers: List[ShardServer] = []
        shippers: List[WALShipper] = []
        with self._lock:
            gen = self._generation.get(shard_id, 0)
            self._generation[shard_id] = gen + 1
        for k in range(self.replication_factor):
            f = ReplicaShard(
                shard_id, drv.partitioner, drv.value_shape,
                init_fn=drv._init_fn,
                wal_dir=self._follower_wal_dir(shard_id, k, gen),
                staleness_bound=self.staleness_bound,
                follower_idx=k,
                registry=(
                    self.registry if self.registry is not None else False
                ),
                # followers mirror the primary's store: the slice (or
                # the tiered store's hot tier) on the driver's device,
                # so a promotion changes neither where the rows live
                # nor the scatter that writes them
                store_backend=(
                    "tiered" if drv.config.store_backend == "tiered"
                    else "torch"
                ),
                device=drv.device,
                tier_hot_rows=drv.config.tier_hot_rows,
                tier_slab_dir=drv.config.tier_slab_dir,
                tier_decay_window=drv.config.tier_decay_window,
            )
            f.epoch = primary.epoch
            srv = ShardServer(
                f, drv.config.host, 0, supervised=False
            ).start()
            ship = WALShipper(
                primary, (srv.host, srv.port), hub.subscribe(),
                follower_idx=k,
                registry=(
                    self.registry if self.registry is not None else False
                ),
                fault_hook=self._fault_hook,
                connect_timeout=self._connect_timeout,
                timeout=self._request_timeout,
                enc=self.repl_enc,
            )
            followers.append(f)
            servers.append(srv)
            shippers.append(ship)
        # the sink goes on BEFORE any shipper runs: a shipper's first
        # act is its bootstrap resync (a read of the primary's WAL), and
        # a push logged between that read and the attach would reach
        # neither the backlog nor the queue -- a gap the follower's log
        # accepts and a later promotion loses.  Attached first, every
        # record is in the backlog, the queue, or both (deduplicated by
        # end seq).
        primary.attach_repl_sink(hub)
        for ship in shippers:
            ship.start()
        chain = ReplicaChain(shard_id, hub, followers, servers, shippers)
        with self._lock:
            self.chains[shard_id] = chain
        return chain

    def build_all(self) -> None:
        for s in range(self.driver.partitioner.num_shards):
            self.build_chain(s)

    def rebuild_chain(self, shard_id: int) -> ReplicaChain:
        """Tear down and re-seed one shard's chain (after a resize,
        replacement, or promotion changed the primary)."""
        self.detach_chain(shard_id)
        return self.build_chain(shard_id)

    def detach_chain(self, shard_id: int) -> None:
        with self._lock:
            chain = self.chains.pop(shard_id, None)
        if chain is None:
            return
        if 0 <= shard_id < len(self.driver.shards):
            self.driver.shards[shard_id].detach_repl_sink()
        chain.stop()

    def forget(self, shard_id: int) -> None:
        """Drop a chain from tracking WITHOUT stopping its parts — the
        promotion path owns their lifecycle (it keeps the promoted
        follower's server and retires the rest itself)."""
        with self._lock:
            self.chains.pop(shard_id, None)

    def detach_all(self) -> None:
        for s in list(self.chains):
            self.detach_chain(s)

    # -- views ---------------------------------------------------------------
    def replica_addresses(self) -> Tuple[Tuple[Tuple[str, int], ...], ...]:
        """Per-shard follower address tuples, aligned with the
        membership's primary address list (empty tuple = no chain)."""
        n = self.driver.partitioner.num_shards
        with self._lock:
            return tuple(
                self.chains[s].addresses() if s in self.chains else ()
                for s in range(n)
            )

    def has_followers(self, shard_id: int) -> bool:
        with self._lock:
            chain = self.chains.get(shard_id)
            return chain is not None and bool(chain.followers)

    def chain(self, shard_id: int) -> Optional[ReplicaChain]:
        with self._lock:
            return self.chains.get(shard_id)

    def lag(self, shard_id: int) -> int:
        chain = self.chain(shard_id)
        if chain is None or not chain.shippers:
            return 0
        return min(s.lag() for s in chain.shippers)

    # -- the heartbeat plane -------------------------------------------------
    def start_heartbeats(self) -> "ChainManager":
        if self._hb_thread is None or not self._hb_thread.is_alive():
            self._hb_stop.clear()
            self._hb_thread = threading.Thread(
                target=self._hb_loop, name="repl-heartbeats", daemon=True
            )
            self._hb_thread.start()
        return self

    def _hb_loop(self) -> None:
        while not self._hb_stop.wait(self.heartbeat_interval_s):
            drv = self.driver
            for s in range(drv.partitioner.num_shards):
                try:
                    srv = drv.servers[s]
                    resp = request_lines(
                        srv.host, srv.port, ["stats"],
                        timeout=self.heartbeat_timeout_s,
                        connect_timeout=self.heartbeat_timeout_s,
                    )
                    if resp and resp[0].startswith("ok"):
                        self.monitor.beat(f"shard-{s}")
                except (OSError, IndexError):
                    continue  # no beat: the age climbs, the controller acts

    def primary_stalled(self, shard_id: int) -> bool:
        """True once the primary has missed heartbeats past the
        threshold — the failover trigger.  A primary that never beat
        (heartbeats just started) is not stalled."""
        age = self.monitor.age(f"shard-{shard_id}")
        return age is not None and age > self.heartbeat_timeout_s

    def stop(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=10)
            self._hb_thread = None
        self.detach_all()


__all__ = ["ReplicaChain", "ChainManager"]
