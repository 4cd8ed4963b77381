"""Cluster invariants — what must hold no matter what the network did.

Counterpart of ``flink_parameter_server_tpu/nemesis/invariants.py``,
which imports no JAX: a copy, since the port imports nothing of the JAX
package (whose ``__init__`` imports JAX).  The checks read host numbers
(counters, a host copy of the final table, thread names), so nothing here
touches the card.

Each checker returns a :class:`Verdict` (name, ok, detail) so the
runner can report ALL violations, not just the first: a Jepsen-style
post-mortem starts from the full verdict table.  Checkers are split
into live probes (sampled while the scenario runs — staleness, serving
errors) and post-hoc audits (run after teardown — ledger, parity,
thread leaks, lock order).

The invariants, and why each is the right oracle:

  * **exactly-once ledger** — every unique delta row a worker client
    counted as acked (``ClusterClient.rows_pushed``) was applied on
    exactly one shard (``ParamShard.rows_applied``, summed over every
    shard EVER live, replacements included).  Retries after torn
    frames/lost acks are deduplicated by the ``(pid, id)`` window, so
    a fault can add latency but never a lost or double-counted update.
  * **final-table parity** — the faulted run's assembled table is
    allclose-equal (fp32) to a fault-free oracle trained on the SAME
    stream.  This is the end-to-end consistency oracle: anything that
    silently mis-routed, re-ordered (under BSP), dropped or corrupted
    an update shows up here even when every counter balances.
  * **SSP staleness bound** — the live ``fastest − slowest`` spread
    never exceeds ``bound + 1`` (the clock gates round STARTS, so the
    momentary completed-round lead legally tops out one past the
    bound — cluster/clock.py).  For BSP (bound 0) this plus parity is
    the read-your-last-round guarantee: the barrier admitted no round
    whose reads missed the previous round's writes.
  * **serving error budget** — a reader thread issuing pulls through
    its own membership client across the whole scenario sees at most
    ``budget`` errors (default 0: faults are latency, never failures).
  * **tier residency** — on tiered scenarios (tierstore/), every live
    sample of every tiered store shows ``resident ≤ hot capacity``:
    demotion pressure, spills and recovery replays may move rows
    between tiers but never grow the bounded hot set.
  * **no leaked threads** — after teardown every thread the PS stack
    spawned (shards, pumps, workers, shippers, controllers) is gone;
    a fault that orphans a handler fails here, not three suites later.
  * **no lock inversions** — the scenario runs under the
    :mod:`~..telemetry.lockwitness` capture and the witnessed
    acquisition order stays cycle-free (the runtime half of fpsanalyze
    L001).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

# thread-name prefixes owned by this package (utils/net.py names
# handlers "<server>-conn-*", the drivers name their workers, the
# proxy names its pumps): the leak check is scoped to OUR threads so a
# persistent torch or library pool never false-positives it
_OWNED_THREAD_PREFIXES = (
    "shard-", "nemesis-", "cluster-", "elastic-", "repl-", "serving",
    "chaos", "line-server", "wal-", "hb-", "ship-", "telemetry",
    "hotcache-", "loadgen-", "adaptive", "timeline-",
)


@dataclasses.dataclass
class Verdict:
    """One invariant's outcome; ``detail`` carries the evidence either
    way (a passing verdict still says what it measured)."""

    name: str
    ok: bool
    detail: str

    def as_dict(self) -> dict:
        return {"name": self.name, "ok": self.ok, "detail": self.detail}


def check_no_errors(errors: Sequence[str]) -> Verdict:
    return Verdict(
        "no_errors",
        not errors,
        "clean run" if not errors else "; ".join(errors[:4]),
    )


def check_exactly_once(acked_rows: int, applied_rows: int) -> Verdict:
    """The ledger audit: client-acked unique delta rows == shard-applied
    delta rows, summed over every client and every shard ever live."""
    ok = acked_rows == applied_rows and acked_rows > 0
    return Verdict(
        "exactly_once_ledger", ok,
        f"acked={acked_rows} applied={applied_rows}"
        + ("" if ok else " — lost or duplicated updates"),
    )


def check_parity(
    values: np.ndarray,
    oracle: np.ndarray,
    *,
    rtol: float = 1e-4,
    atol: float = 1e-6,
) -> Verdict:
    """Final table vs the fault-free oracle on the same stream (the
    repo-wide BSP parity tolerance, tests/test_cluster.py)."""
    if values.shape != oracle.shape:
        return Verdict(
            "final_table_parity", False,
            f"shape {values.shape} vs oracle {oracle.shape}",
        )
    err = np.abs(values - oracle)
    tol = atol + rtol * np.abs(oracle)
    bad = int((err > tol).sum())
    return Verdict(
        "final_table_parity", bad == 0,
        f"max_abs_err={float(err.max()):.3e} mismatched_elems={bad}",
    )


def check_parity_bitwise(
    values: np.ndarray, oracle: np.ndarray
) -> Verdict:
    """Final table vs the oracle, BIT FOR BIT — the parity mode for
    workloads whose update combine is structurally deterministic
    (workloads/pa.py: the on-device dense combine leaves exactly one
    fp32 row per id per round on both arms).  Same verdict name as the
    allclose mode so corpus expectations stay uniform; the detail says
    which bar was applied."""
    if values.shape != oracle.shape:
        return Verdict(
            "final_table_parity", False,
            f"shape {values.shape} vs oracle {oracle.shape}",
        )
    a = np.asarray(values, np.float32)
    b = np.asarray(oracle, np.float32)
    mismatched = int((a.view(np.uint32) != b.view(np.uint32)).sum())
    return Verdict(
        "final_table_parity", mismatched == 0,
        f"bitwise: mismatched_words={mismatched} of {a.size}"
        + ("" if mismatched == 0 else
           f" max_abs_err={float(np.abs(a - b).max()):.3e}"),
    )


def check_count_parity(
    values: np.ndarray, oracle: np.ndarray
) -> Verdict:
    """Integer-exact parity for increment workloads (sketches): every
    delivered counter must be an integer and EQUAL the ground-truth
    count — no float tolerance.  Exactness is legitimate because
    integer increments are exact in fp32 below 2^24 and integer adds
    commute, so no schedule (retries, promotion replay, resharding,
    multi-worker interleaving) may change a single count."""
    if values.shape != oracle.shape:
        return Verdict(
            "final_table_parity", False,
            f"shape {values.shape} vs oracle {oracle.shape}",
        )
    v = np.asarray(values, np.float64)
    nonint = int((v != np.round(v)).sum())
    diff = int((v != np.asarray(oracle, np.float64)).sum())
    total = int(v.sum())
    ok = nonint == 0 and diff == 0
    return Verdict(
        "final_table_parity", ok,
        f"integer-exact: total_count={total} "
        f"mismatched_cells={diff} non_integer_cells={nonint}",
    )


def check_staleness(
    samples: Sequence[int], bound: Optional[int]
) -> Verdict:
    """Sampled live spread ≤ bound + 1 (see module docstring); async
    (bound None) always passes — there is no bound to exceed."""
    worst = max(samples) if samples else 0
    if bound is None:
        return Verdict(
            "ssp_staleness_bound", True,
            f"async clock, worst observed spread {worst}",
        )
    ok = worst <= bound + 1
    return Verdict(
        "ssp_staleness_bound", ok,
        f"worst spread {worst} vs bound {bound} (+1 round in flight)",
    )


def check_adaptive_bound(
    samples: Sequence[Sequence[int]],
    bound: Optional[int],
    ceiling: Optional[int],
) -> Verdict:
    """The adaptive-bounds safety envelope (adaptive/bounds.py): every
    live-sampled per-worker EFFECTIVE bound stays within
    ``[bound, ceiling]`` — widening never exceeds the declared ceiling
    and narrowing never undercuts the correctness bound.  Vacuous
    passes are rejected the way lease_staleness rejects them: at least
    one sample must have been taken from a live adaptive clock,
    otherwise the scenario never exercised the invariant it claims to
    prove.  Async (bound None) has no allowances to audit and passes
    on the sampler having seen the clock."""
    n = len(samples)
    if bound is None:
        return Verdict(
            "adaptive_bound_envelope", n > 0,
            f"async clock, {n} sample(s)"
            + ("" if n else " — never sampled (vacuous)"),
        )
    low = min(
        (min(row) for row in samples if len(row)), default=bound
    )
    high = max(
        (max(row) for row in samples if len(row)), default=bound
    )
    ok = n > 0 and low >= bound and high <= ceiling
    return Verdict(
        "adaptive_bound_envelope", ok,
        f"samples={n} effective bounds in [{low}, {high}] vs "
        f"declared [{bound}, {ceiling}]"
        + ("" if high <= ceiling else " — CEILING VIOLATED")
        + ("" if low >= bound else " — CORRECTNESS BOUND VIOLATED")
        + ("" if n else " — never sampled (vacuous)"),
    )


def check_serving_budget(
    served: int, errors: int, *, budget: int = 0
) -> Verdict:
    ok = errors <= budget and served > 0
    return Verdict(
        "serving_error_budget", ok,
        f"served={served} errors={errors} budget={budget}",
    )


def check_lease_staleness(
    cache_stats: dict, bound: int
) -> Verdict:
    """The hot-key cache's staleness contract under fault
    (docs/hotcache.md): every row the client-edge cache SERVED was at
    most ``bound`` ticks old — through partitions, lost invalidations
    and shard restarts, because the bound is enforced client-locally.
    Vacuous passes are rejected: the cache must actually have served
    (``hits > 0``), otherwise the scenario never exercised the tier it
    claims to prove."""
    hits = int(cache_stats.get("hits", 0))
    worst = int(cache_stats.get("max_served_age", 0))
    revoked = int(cache_stats.get("revocations", 0))
    stale = int(cache_stats.get("stale_rejects", 0))
    ok = hits > 0 and worst <= bound
    return Verdict(
        "lease_staleness", ok,
        f"cache_hits={hits} worst_served_age={worst} bound={bound} "
        f"revocations={revoked} stale_rejects={stale}"
        + ("" if worst <= bound else " — BOUND VIOLATED")
        + ("" if hits else " — cache never served (vacuous)"),
    )


def check_tier_residency(samples: Sequence[dict]) -> Verdict:
    """The two-tier store's bounded-residency contract (tierstore/,
    docs/tierstore.md): at EVERY live sample, every tiered shard's
    resident (hot) row count stays within its configured hot capacity
    — through demotion storms, kills, promotions and WAL replays,
    because oversized admissions spill write-through to the cold slab
    instead of growing the hot tier.  Each sample is
    ``{label: (resident_rows, hot_capacity_rows)}`` as collected by
    :class:`TierResidencySampler`.  Vacuous passes are rejected: at
    least one sample from at least one live tiered store must have
    been taken, otherwise the scenario never exercised the tier it
    claims to prove."""
    n = 0
    worst_over = 0
    worst_label = ""
    peak = 0
    cap_seen = 0
    for sample in samples:
        for label, (resident, cap) in sample.items():
            n += 1
            peak = max(peak, int(resident))
            cap_seen = max(cap_seen, int(cap))
            over = int(resident) - int(cap)
            if over > worst_over:
                worst_over = over
                worst_label = str(label)
    ok = n > 0 and worst_over <= 0
    return Verdict(
        "tier_residency", ok,
        f"samples={n} peak_resident={peak} hot_capacity={cap_seen}"
        + ("" if worst_over <= 0 else
           f" — CAPACITY EXCEEDED by {worst_over} rows on {worst_label}")
        + ("" if n else " — never sampled (vacuous)"),
    )


def check_lock_inversions(inversions) -> Verdict:
    n = len(inversions)
    return Verdict(
        "no_lock_inversions", n == 0,
        "witnessed order is cycle-free" if n == 0
        else f"{n} inversion(s): {inversions[0]}",
    )


class ThreadLedger:
    """Before/after thread accounting for the leak invariant.

    Snapshot before the topology is built; after teardown,
    :meth:`check` polls (teardown joins run with timeouts) until every
    package-owned thread born since the snapshot is gone, or the grace
    window expires — the survivors are the leak."""

    def __init__(self):
        self._before = {t.ident for t in threading.enumerate()}

    def _leaked(self) -> List[str]:
        return sorted(
            t.name for t in threading.enumerate()
            if t.ident not in self._before and t.is_alive()
            and t is not threading.current_thread()
            and t.name.startswith(_OWNED_THREAD_PREFIXES)
        )

    def check(self, *, grace_s: float = 5.0) -> Verdict:
        deadline = time.monotonic() + grace_s
        leaked = self._leaked()
        while leaked and time.monotonic() < deadline:
            time.sleep(0.05)
            leaked = self._leaked()
        return Verdict(
            "no_leaked_threads", not leaked,
            "all package threads joined" if not leaked
            else f"leaked: {leaked[:6]}",
        )


class AdaptiveBoundSampler:
    """Polls the driver clock's per-worker effective bounds while a
    scenario runs (same re-read-every-tick discipline as
    :class:`StalenessSampler` — the driver swaps in a fresh clock at
    run start).  Only adaptive clocks yield samples; a stock clock
    leaves ``samples`` empty and :func:`check_adaptive_bound` then
    rejects the run as vacuous."""

    def __init__(self, driver, interval_s: float = 0.002):
        self._driver = driver
        self._interval = float(interval_s)
        self.samples: List[List[int]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def __enter__(self) -> "AdaptiveBoundSampler":
        self._thread = threading.Thread(
            target=self._loop, name="nemesis-adaptive-sampler",
            daemon=True,
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            clock = self._driver.clock
            bounds = getattr(clock, "effective_bounds", None)
            if bounds is not None:
                try:
                    self.samples.append(list(bounds()))
                except Exception:  # clock mid-swap: skip the tick
                    pass

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


class TierResidencySampler:
    """Polls every live tiered store's ``(resident, capacity)`` pair
    while a scenario runs, through the process-wide tiers snapshot
    registry (tierstore/metrics.py) — which is what covers chain
    FOLLOWERS too, not just the shards the driver lists.  A store
    mid-crash/restart yields no entry for that tick (its stats
    callable answers ``None``); a non-tiered scenario leaves
    ``samples`` empty and :func:`check_tier_residency` then rejects
    the run as vacuous."""

    def __init__(self, interval_s: float = 0.005):
        self._interval = float(interval_s)
        self.samples: List[dict] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def __enter__(self) -> "TierResidencySampler":
        self._thread = threading.Thread(
            target=self._loop, name="nemesis-tier-sampler", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        from ..tierstore.metrics import tiers_snapshot

        while not self._stop.wait(self._interval):
            snap = tiers_snapshot()
            if not snap:
                continue
            tick = {}
            for label, st in snap.items():
                try:
                    tick[label] = (
                        int(st["resident_rows"]),
                        int(st["hot_capacity_rows"]),
                    )
                except (KeyError, TypeError, ValueError):
                    continue
            if tick:
                self.samples.append(tick)

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


class StalenessSampler:
    """Polls ``driver.clock.staleness()`` on its own thread while a
    scenario runs (the driver swaps in a fresh clock at run start, so
    the sampler re-reads the attribute every tick)."""

    def __init__(self, driver, interval_s: float = 0.002):
        self._driver = driver
        self._interval = float(interval_s)
        self.samples: List[int] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def __enter__(self) -> "StalenessSampler":
        self._thread = threading.Thread(
            target=self._loop, name="nemesis-staleness-sampler", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            clock = self._driver.clock
            if clock is not None:
                try:
                    self.samples.append(int(clock.staleness()))
                except Exception:  # clock mid-swap: skip the tick
                    pass

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


__all__ = [
    "AdaptiveBoundSampler",
    "StalenessSampler",
    "ThreadLedger",
    "TierResidencySampler",
    "Verdict",
    "check_adaptive_bound",
    "check_count_parity",
    "check_exactly_once",
    "check_lease_staleness",
    "check_lock_inversions",
    "check_no_errors",
    "check_parity",
    "check_parity_bitwise",
    "check_serving_budget",
    "check_staleness",
    "check_tier_residency",
]
