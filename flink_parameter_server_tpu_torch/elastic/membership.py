"""Epoch-versioned partition maps — the elastic control plane's truth.

A copy of ``flink_parameter_server_tpu/elastic/membership.py``, which
imports no JAX; each view carries the per-shard replica sets of the
replica chains (``replication/``).  Modules it names that the port does
not have yet are the reference's.

"Elastic Model Aggregation with Parameter Service" (arXiv:2204.03211)
frames the core problem of resizing a live PS as a ROUTING problem:
while the shard set changes, every participant must agree on which map
a given message was routed by, or two maps mix and a key's updates
split across owners.  The epoch protocol here pins that down with one
integer:

  * every published map is a :class:`PartitionEpoch` — an immutable
    ``(epoch, partitioner, shard addresses)`` triple; epochs are
    strictly monotone;
  * clients tag every pull/push frame with the epoch their routing
    decision used (``e=<n>`` on the wire, cluster/shard.py);
  * shards pin the epoch they serve and REJECT old-epoch writes
    (``err stale-epoch``) — a flip can therefore never mix routings:
    the worst case is a retry, never a mis-placed update;
  * a rejected client refreshes its view from the
    :class:`MembershipService` and replays the frame under the new map
    (cluster/client.py, counted in ``elastic_epoch_refreshes_total``).

The service itself is deliberately small: a thread-safe holder of the
current :class:`PartitionEpoch` plus a publish path that bumps the
epoch.  It is the single writer (the
:class:`~.controller.ElasticClusterDriver` publishes from under its
resize lock); everyone else only reads.  ``component=elastic``
instruments: a live ``elastic_epoch`` gauge and an
``elastic_epoch_flips_total`` counter.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, List, Sequence, Tuple

from ..cluster.partition import Partitioner


def _normalize_replicas(replicas) -> Tuple:
    """Deep-tuple a per-shard replica address structure (None → ())."""
    if not replicas:
        return ()
    return tuple(
        tuple(tuple(a) for a in shard_addrs) for shard_addrs in replicas
    )


@dataclasses.dataclass(frozen=True)
class PartitionEpoch:
    """One immutable generation of the cluster's routing truth.

    ``replicas`` (replication/, docs/elastic.md) carries each shard's
    follower addresses — the read-only chain members clients may
    load-balance pulls across; empty (the default) means no chains and
    every read goes to the primary.  Writes ALWAYS route by
    ``addresses``."""

    epoch: int
    partitioner: Partitioner
    addresses: Tuple[Tuple[str, int], ...]
    replicas: Tuple[Tuple[Tuple[str, int], ...], ...] = ()

    def __post_init__(self):
        if len(self.addresses) != self.partitioner.num_shards:
            raise ValueError(
                f"epoch {self.epoch}: {len(self.addresses)} addresses "
                f"for a {self.partitioner.num_shards}-shard map"
            )
        if self.replicas and len(self.replicas) != len(self.addresses):
            raise ValueError(
                f"epoch {self.epoch}: {len(self.replicas)} replica "
                f"sets for {len(self.addresses)} shards (pass one "
                f"tuple per shard — empty for chainless shards)"
            )


class MembershipService:
    """Thread-safe holder of the current :class:`PartitionEpoch`.

    ``current()`` is the read every client retry path takes;
    ``publish()`` installs the next generation (strictly monotone
    epochs — published maps never go backward, so a client can cache
    its view and only ever move forward).  Listeners registered with
    :meth:`subscribe` fire synchronously on each publish (the
    controller uses this for its event log)."""

    def __init__(
        self,
        partitioner: Partitioner,
        addresses: Sequence[Tuple[str, int]],
        *,
        replicas=None,
        registry=None,
    ):
        self._lock = threading.Lock()
        self._current = PartitionEpoch(
            0, partitioner, tuple(tuple(a) for a in addresses),
            _normalize_replicas(replicas),
        )
        self._listeners: List[Callable[[PartitionEpoch], None]] = []
        if registry is not False:
            from ..telemetry.registry import get_registry

            reg = registry if registry is not None else get_registry()
            reg.gauge(
                "elastic_epoch", component="elastic",
                fn=lambda: self.current().epoch,
            )
            self._c_flips = reg.counter(
                "elastic_epoch_flips_total", component="elastic"
            )
        else:
            self._c_flips = None

    def current(self) -> PartitionEpoch:
        with self._lock:
            return self._current

    def publish(
        self,
        partitioner: Partitioner,
        addresses: Sequence[Tuple[str, int]],
        *,
        replicas=None,
    ) -> PartitionEpoch:
        """Install the next epoch; returns the published view."""
        with self._lock:
            nxt = PartitionEpoch(
                self._current.epoch + 1,
                partitioner,
                tuple(tuple(a) for a in addresses),
                _normalize_replicas(replicas),
            )
            self._current = nxt
            listeners = list(self._listeners)
        if self._c_flips is not None:
            self._c_flips.inc()
        for fn in listeners:
            fn(nxt)
        return nxt

    def subscribe(
        self, fn: Callable[[PartitionEpoch], None]
    ) -> Callable[[], None]:
        """Register a publish listener; returns an unsubscribe."""
        with self._lock:
            self._listeners.append(fn)

        def unsubscribe() -> None:
            with self._lock:
                if fn in self._listeners:
                    self._listeners.remove(fn)

        return unsubscribe


__all__ = ["PartitionEpoch", "MembershipService"]
