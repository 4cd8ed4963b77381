"""nemesis/ — the parity verdicts and the lease and lock checks.

Of the reference's fault-injection harness the final-table verdicts of
:mod:`.invariants` are ported (what ``Workload.parity_verdict``,
``workloads/base.py``, returns), with the hot-key cache's lease-staleness
check and the lock witness's inversion check.  The scenarios, the runner,
the samplers and the tier check wait for ROADMAP Queue 1 #7's ``nemesis/``
item.
"""
from .invariants import (
    Verdict,
    check_count_parity,
    check_exactly_once,
    check_lease_staleness,
    check_lock_inversions,
    check_no_errors,
    check_parity,
    check_parity_bitwise,
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
