"""Cluster invariants — the final-table verdicts and the lease and lock
checks.

Of the reference's ``nemesis/invariants.py`` these are ported:
:class:`Verdict`, :func:`check_no_errors`, the exactly-once ledger audit
(:func:`check_exactly_once`), the three parity modes
(:func:`check_parity`, :func:`check_parity_bitwise`,
:func:`check_count_parity`), the hot-key cache's staleness contract
(:func:`check_lease_staleness`) and the lock witness's verdict
(:func:`check_lock_inversions`).  They are copies of the reference's
functions, which import no JAX.  The live samplers (staleness, adaptive
bound, tier residency), the serving-budget, tier and thread-leak checks
wait for ROADMAP Queue 1 #7's ``nemesis/`` item.

Why each is the right oracle:

  * **exactly-once ledger** — every unique delta row a worker client
    counted as acked (``ClusterClient.rows_pushed``) was applied on
    exactly one shard (``ParamShard.rows_applied``, summed over every
    shard EVER live, replacements included).  Retries after torn
    frames/lost acks are deduplicated by the ``(pid, id)`` window, so
    a fault can add latency but never a lost or double-counted update.
  * **final-table parity** — the run's assembled table is allclose-equal
    (fp32) to an oracle trained on the SAME stream; bitwise for
    workloads whose combine is structurally deterministic (PA), and
    integer-exact for counters (the sketches).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


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


def check_lock_inversions(inversions) -> Verdict:
    n = len(inversions)
    return Verdict(
        "no_lock_inversions", n == 0,
        "witnessed order is cycle-free" if n == 0
        else f"{n} inversion(s): {inversions[0]}",
    )


__all__ = [
    "Verdict",
    "check_count_parity",
    "check_exactly_once",
    "check_lease_staleness",
    "check_lock_inversions",
    "check_no_errors",
    "check_parity",
    "check_parity_bitwise",
]
