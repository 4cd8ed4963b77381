"""Follower lookups — the serving plane's read path over replica chains.

Counterpart of ``flink_parameter_server_tpu/serving/follower.py``.  The
rows cross the wire as host bytes, as in the reference; the service hands
them back as a tensor on its ``device`` (the card unless the caller asks
for the CPU), where the port's callers compute with them.

The in-process serving stack (snapshot.py/engine.py) reads versioned
snapshots inside the TRAINING process; this module is the other
serving topology: a lookup service that reads the live cluster table
**through the replica chains** (replication/, docs/elastic.md), so
serving traffic keeps flowing while a primary is dead and being failed
over — the "millions of users read from followers" story.

It is a thin façade over a read-routed
:class:`~..cluster.client.ClusterClient`: lookups load-balance across
each shard's chain, honor the follower staleness contract (a lagging
follower's ``err lagging`` falls back to the primary inside the
client), and survive a promotion as a membership refresh — latency,
never an error.  The chaos failover e2e test and
``benchmarks/failover_time.py`` drive their "zero serving errors
during failover" window through this service.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.transform import to_device
from ..utils.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ChainLookupResult:
    """One answered lookup batch + its routing provenance."""

    values: torch.Tensor  # (B, *value_shape) float32, on the service's device
    epoch: Optional[int]  # membership epoch the routing used


class FollowerLookupService:
    """Serving lookups against a replica-chained cluster.

    Built from a ``membership`` view (the usual case — promotions and
    resizes are then just refreshes) or handed an existing read-routed
    client.  Timeouts default TIGHT: a serving read is latency-bound,
    and the chain gives it somewhere else to go.
    """

    def __init__(
        self,
        membership=None,
        value_shape: Sequence[int] = (),
        *,
        client=None,
        registry=None,
        timeout: float = 5.0,
        connect_timeout: float = 2.0,
        retry_timeout: float = 10.0,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if client is None:
            if membership is None:
                raise ValueError(
                    "FollowerLookupService needs membership= (or a "
                    "pre-built read-routed client=)"
                )
            from ..cluster.client import ClusterClient

            client = ClusterClient(
                value_shape=value_shape,
                membership=membership,
                read_replicas=True,
                timeout=timeout,
                connect_timeout=connect_timeout,
                retry_timeout=retry_timeout,
                registry=registry if registry is not None else None,
                worker="serving",
            )
            self._owns_client = True
        else:
            self._owns_client = False
        self._client = client
        self.lookups_served = 0
        self.lookup_errors = 0
        if registry is not False:
            from ..telemetry.registry import get_registry

            reg = registry if registry is not None else get_registry()
            self._c_lookups = reg.counter(
                "replication_serving_lookups_total",
                component="replication",
            )
        else:
            self._c_lookups = None

    def lookup(self, ids) -> ChainLookupResult:
        """Pull the rows for ``ids`` through the chain-routed client;
        every retry/fallback/refresh happens inside — a raised error
        here means the whole chain (followers AND primary) was
        unreachable past the retry budget."""
        ids = np.asarray(ids, np.int64)
        try:
            values = self._client.pull_batch(ids)
        except Exception:
            self.lookup_errors += 1
            raise
        self.lookups_served += 1
        if self._c_lookups is not None:
            self._c_lookups.inc()
        return ChainLookupResult(
            values=to_device(values, self.device),
            epoch=self._client._epoch,
        )

    def close(self) -> None:
        if self._owns_client:
            self._client.close()


__all__ = ["ChainLookupResult", "FollowerLookupService"]
