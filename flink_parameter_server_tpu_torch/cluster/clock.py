"""Bounded-staleness (SSP) vector clock for the cluster workers.

A copy of ``flink_parameter_server_tpu/cluster/clock.py``, which imports
no JAX: the port imports nothing of the JAX package, whose ``__init__``
imports JAX.  Modules it names that the port does not have yet are the
reference's.

The PS literature's consistency dial (MXNET-MPI, arXiv:1801.03855;
straggler study, arXiv:2308.15482) is one integer: how many iterations
may the fastest worker run AHEAD of the slowest before it must wait.

  ==========  =================================================
  ``bound``   semantics
  ==========  =================================================
  0           BSP — lockstep rounds; every worker's reads see
              every worker's previous-round writes
  k > 0       SSP — reads may miss at most ``k`` rounds of the
              stragglers' writes; fast workers block exactly at
              ``fastest − slowest > k``
  ``None``    fully asynchronous — never block (the reference's
              native hogwild mode)
  ==========  =================================================

Mechanics: each worker owns one monotonically increasing round counter
(``ticks completed``).  :meth:`wait_for_turn` blocks while advancing
would put the caller more than ``bound`` rounds ahead of the slowest
ACTIVE worker; :meth:`tick` completes a round and wakes the waiters; a
finished worker calls :meth:`deactivate` so its frozen counter stops
counting as "the slowest" (otherwise every stream end would deadlock
the survivors).  One condition variable covers the vector — rounds are
milliseconds-long (a network pull + a jitted step), so contention on
the clock is noise.

The live staleness (``fastest − slowest``) is the gauge the telemetry
plane scrapes (``cluster_staleness_steps{component=cluster}``) — the
mid-run observable that says whether a run is actually BSP-tight or
drifting to its bound.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional


class StalenessClock:
    """SSP vector clock over ``num_workers`` round counters."""

    def __init__(self, num_workers: int, bound: Optional[int] = 0):
        if num_workers < 1:
            raise ValueError(f"num_workers={num_workers}: must be >= 1")
        if bound is not None and bound < 0:
            raise ValueError(f"bound={bound}: must be >= 0 or None (async)")
        self.num_workers = int(num_workers)
        self.bound = None if bound is None else int(bound)
        self._clocks = [0] * self.num_workers
        self._active = [True] * self.num_workers
        self._cond = threading.Condition()
        # how many times each worker actually blocked at the bound —
        # the test/bench surface for "SSP is being enforced"
        self.block_counts = [0] * self.num_workers

    # -- the protocol ------------------------------------------------------
    def wait_for_turn(self, worker: int, timeout: Optional[float] = None) -> bool:
        """Block until worker may START its next round without exceeding
        the bound, i.e. while ``clock[worker] − min(active clocks) >
        bound``.  Returns False on timeout (deadlock guard for tests),
        True when clear.  ``bound=None`` never blocks.

        The gate bounds the lead at round START: a worker that was
        allowed to start still completes that round, so the momentary
        completed-round lead (and the staleness gauge) tops out at
        ``bound + 1`` right before the next wait blocks."""
        if self.bound is None:
            return True
        with self._cond:
            blocked = False

            def clear() -> bool:
                return self._clear_locked(worker)

            if not clear():
                blocked = True
                self.block_counts[worker] += 1
            ok = self._cond.wait_for(clear, timeout=timeout)
            return ok or not blocked

    def _clear_locked(self, worker: int) -> bool:
        """Gate predicate, evaluated under ``self._cond``.  Subclasses
        (``adaptive.bounds.AdaptiveClock``) override this to apply
        per-worker allowances instead of the single global bound."""
        return self._clocks[worker] - self._min_active_locked() <= self.bound

    def tick(self, worker: int) -> int:
        """Worker completed a round (its pushes are durable at the
        shards); returns its new round count and wakes any waiter."""
        with self._cond:
            self._clocks[worker] += 1
            self._cond.notify_all()
            return self._clocks[worker]

    def deactivate(self, worker: int) -> None:
        """Worker finished its stream: exclude its (frozen) counter from
        the slowest-active computation so survivors can proceed."""
        with self._cond:
            self._active[worker] = False
            self._cond.notify_all()

    # -- reads -------------------------------------------------------------
    def _min_active_locked(self) -> int:
        act = [c for c, a in zip(self._clocks, self._active) if a]
        return min(act) if act else max(self._clocks, default=0)

    def clocks(self) -> List[int]:
        with self._cond:
            return list(self._clocks)

    def staleness(self) -> int:
        """``fastest − slowest`` over ACTIVE workers — the live gauge."""
        with self._cond:
            act = [c for c, a in zip(self._clocks, self._active) if a]
            if not act:
                return 0
            return max(act) - min(act)

    def snapshot(self) -> Dict[str, object]:
        with self._cond:
            act = [c for c, a in zip(self._clocks, self._active) if a]
            return {
                "clocks": list(self._clocks),
                "active": list(self._active),
                "bound": self.bound,
                "staleness": (max(act) - min(act)) if act else 0,
                "block_counts": list(self.block_counts),
            }


__all__ = ["StalenessClock"]
