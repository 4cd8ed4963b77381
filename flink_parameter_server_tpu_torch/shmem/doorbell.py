"""Adaptive spin-then-park wakeup for shm rings — the doorbell.

A copy of ``flink_parameter_server_tpu/shmem/doorbell.py``, which imports
no JAX: the port imports nothing of the JAX package, whose ``__init__``
imports JAX.

TCP's wakeup primitive is the kernel: a blocked ``recv`` costs two
scheduler round trips per request/response — the very floor the shm
transport exists to remove.  Shared
memory has no kernel to ring, so the doorbell replaces it with a
two-phase wait:

  * **spin phase** — up to ``spin`` iterations of check-then-yield
    (``time.sleep(0)``).  The yield matters more than the spin: a
    co-located peer needs the GIL (same-process thread shards) or a
    core (proc shards) to make progress, and a hot non-yielding loop
    would hold exactly the resource the peer is waiting for.  A wait
    satisfied here costs no timed sleep at all — tens of
    microseconds, not the ~0.3 ms kernel-wakeup floor.
  * **park phase** — past the spin budget the waiter PARKS: escalating
    timed sleeps from ``sleep_min_s`` doubling to ``sleep_max_s``,
    with the ring's parked flag raised so the producing side (and
    ``psctl``) can see a cold reader.  Parking is the idle-connection
    path; it trades latency for CPU exactly like the selectors loop
    parking an idle socket.

When BOTH ring ends live in one process the ring carries a shared
*bell* (``ring.ShmRing.bell``, a pipe-byte wakeup) and the phases
invert: the spin is skipped entirely — yielding would only steal the
GIL from the very peer thread we wait on — and the park blocks LONG
on the bell, which the publisher rings (only while the parked flag is
up, so the fast path pays nothing).  A cross-process peer never rings
the process-local bell and the wait degrades to the timed park above.

Every wait is accounted (docs/shmem.md instrument table):
``shmem_doorbell_spins_total`` (spin iterations),
``shmem_doorbell_parks_total`` (waits that overran the spin budget),
``shmem_doorbell_wakes_total`` (parked waits that woke to data —
parks minus wakes ≈ waits that timed out or aborted).  Accounting
must never fail the wait path: a missing telemetry plane leaves the
doorbell silent, same discipline as ``utils/net.NetMeter``.
"""
from __future__ import annotations

import time
from typing import Callable, Optional


class Doorbell:
    """One side's waiter (see module docstring).  ``ring`` is optional
    and only used for the parked flag; counters are registered lazily
    per ``role`` label."""

    def __init__(
        self,
        role: str,
        *,
        ring=None,
        spin: int = 200,
        sleep_min_s: float = 50e-6,
        sleep_max_s: float = 1e-3,
        registry=None,
    ):
        self.role = role
        self.ring = ring
        self.spin = int(spin)
        self.sleep_min_s = float(sleep_min_s)
        self.sleep_max_s = float(sleep_max_s)
        # local tallies (always live — the tests read these);
        # registry counters mirror them when a plane is attached
        self.spins = 0
        self.parks = 0
        self.wakes = 0
        self._c_spins = self._c_parks = self._c_wakes = None
        if registry is not False:
            try:
                from ..telemetry.registry import get_registry

                reg = registry if registry is not None else get_registry()
                labels = {"component": "shmem", "role": role}
                self._c_spins = reg.counter(
                    "shmem_doorbell_spins_total", **labels
                )
                self._c_parks = reg.counter(
                    "shmem_doorbell_parks_total", **labels
                )
                self._c_wakes = reg.counter(
                    "shmem_doorbell_wakes_total", **labels
                )
            except Exception:  # accounting never fails the wait path
                pass

    def wait(
        self,
        ready: Callable[[], bool],
        *,
        timeout: Optional[float] = None,
        should_abort: Optional[Callable[[], bool]] = None,
    ) -> bool:
        """Wait until ``ready()`` — True on success, False on timeout
        or abort.  Matches the ``waiter=`` signature
        :meth:`~.ring.ShmRing.produce`/``consume`` accept."""
        ring = self.ring
        bell = getattr(ring, "bell", None)
        shared = bell is not None and getattr(bell, "shared", False)
        spins = 0
        # an in-process peer is woken by the bell, not by our yields —
        # spinning would only steal the GIL from the very thread we
        # are waiting on, so skip straight to the park
        while not shared and spins < self.spin:
            if ready():
                self.spins += spins
                if self._c_spins is not None and spins:
                    self._c_spins.inc(spins)
                return True
            if should_abort is not None and should_abort():
                return False
            spins += 1
            time.sleep(0)
        self.spins += spins
        if self._c_spins is not None and spins:
            self._c_spins.inc(spins)
        # -- park ----------------------------------------------------------
        self.parks += 1
        if self._c_parks is not None:
            self._c_parks.inc()
        if ring is not None:
            try:
                ring.set_parked(True)
            except (TypeError, ValueError):
                pass
        deadline = (
            None if timeout is None else time.monotonic() + timeout
        )
        bell = getattr(ring, "bell", None)
        sleep = self.sleep_min_s
        try:
            while True:
                if ready():
                    self.wakes += 1
                    if self._c_wakes is not None:
                        self._c_wakes.inc()
                    return True
                if should_abort is not None and should_abort():
                    return False
                if deadline is not None and time.monotonic() >= deadline:
                    return False
                if bell is not None:
                    # clear-check-wait so a publish between the clear
                    # and the wait is never a lost wakeup; a same-
                    # process peer's publish wakes us at pipe speed
                    # (park LONG there — a short timeout would wake us
                    # just to steal the GIL from the peer mid-work),
                    # while a remote peer never sets the process-local
                    # bell and the wait degrades to the timed park
                    bell.clear()
                    if ready():
                        continue
                    bell.wait(0.005 if shared else sleep)
                else:
                    time.sleep(sleep)
                sleep = min(sleep * 2, self.sleep_max_s)
        finally:
            if ring is not None:
                try:
                    ring.set_parked(False)
                except (TypeError, ValueError):
                    pass


__all__ = ["Doorbell"]
