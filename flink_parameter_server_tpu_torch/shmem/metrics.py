"""shmem instrument helpers — component=shmem on the unified plane.

A copy of ``flink_parameter_server_tpu/shmem/metrics.py``, which imports
no JAX: the port imports nothing of the JAX package, whose ``__init__``
imports JAX.  It registers on the port's ``telemetry.registry``.

The catalog (docs/shmem.md) in one place: the ring depth gauge is
registered here (summed over live rings per (role, direction) so N
channels in one process share one series instead of clobbering each
other's probe fn); the doorbell counters live in ``doorbell.py``; the
borrow/reclaim counters at their call sites in ``channel.py`` /
``pump.py``; the fallback counter here.  All registrations follow the
``utils/net.NetMeter`` discipline: accounting must never fail the
transport path, so a missing telemetry plane is a silent no-op.
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict, Tuple

_LIVE: Dict[Tuple[str, str], "weakref.WeakSet"] = {}
_LIVE_LOCK = threading.Lock()


def track_ring(role: str, direction: str, ring, registry=None) -> None:
    """Fold ``ring`` into the ``shmem_ring_depth_bytes{role,dir}``
    gauge — the live byte depth between the published head and tail,
    summed across this process's rings on that (role, direction)."""
    if registry is False:
        return
    with _LIVE_LOCK:
        live = _LIVE.setdefault((role, direction), weakref.WeakSet())
        live.add(ring)
    try:
        from ..telemetry.registry import get_registry

        reg = registry if registry is not None else get_registry()
        reg.gauge(
            "shmem_ring_depth_bytes", component="shmem",
            role=role, dir=direction,
            fn=lambda live=live: float(
                sum(r.depth() for r in list(live))
            ),
        )
    except Exception:  # accounting never fails the transport
        pass


def count_fallback(reason: str, registry=None) -> None:
    """One shm dial — or one request — that landed on TCP instead:
    ``shmem_fallbacks_total{reason}`` (``hello-refused``: the peer
    declined or predates shm; ``attach-failed``: segment creation or
    negotiation died; ``not-local``: the peer is not co-located;
    ``oversize``: a single request too big for a ring record took the
    TCP-anchor detour while the channel stayed on shm)."""
    if registry is False:
        return
    try:
        from ..telemetry.registry import get_registry

        reg = registry if registry is not None else get_registry()
        reg.counter(
            "shmem_fallbacks_total", component="shmem", reason=reason
        ).inc()
    except Exception:
        pass


def count_reclaim(registry=None) -> None:
    """One server-side borrow reclaim — the lease timeout fired on a
    stale-heartbeat client while the response ring was full
    (``shmem_borrow_reclaims_total``, the reader-crash-while-borrowing
    teardown, docs/shmem.md)."""
    if registry is False:
        return
    try:
        from ..telemetry.registry import get_registry

        reg = registry if registry is not None else get_registry()
        reg.counter(
            "shmem_borrow_reclaims_total", component="shmem",
            role="server",
        ).inc()
    except Exception:
        pass


def count_teardown(reason: str, registry=None) -> None:
    """One server pump that folded its channel for ``reason`` —
    ``shmem_pump_teardowns_total{reason}`` (``error``: the serve loop
    caught an unexpected exception; the no-raise guarantee holds but
    the fold must not be silent — without this counter a programming
    error is indistinguishable from a dead peer, docs/shmem.md)."""
    if registry is False:
        return
    try:
        from ..telemetry.registry import get_registry

        reg = registry if registry is not None else get_registry()
        reg.counter(
            "shmem_pump_teardowns_total", component="shmem",
            reason=reason,
        ).inc()
    except Exception:
        pass


__all__ = [
    "count_fallback",
    "count_reclaim",
    "count_teardown",
    "track_ring",
]
