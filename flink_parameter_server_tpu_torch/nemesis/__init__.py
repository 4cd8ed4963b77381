"""nemesis/ — the parity verdicts, the lease and lock checks, and the
adaptive-bound and tier-residency invariants with their live samplers.

Of the reference's fault-injection harness the final-table verdicts of
:mod:`.invariants` are ported (what ``Workload.parity_verdict``,
``workloads/base.py``, returns), with the hot-key cache's lease-staleness
check, the lock witness's inversion check, the adaptive runtime's bound
envelope (``check_adaptive_bound``, ``AdaptiveBoundSampler``) and the
two-tier store's residency contract (``check_tier_residency``,
``TierResidencySampler``).  The scenarios, the runner, the proxy and the
remaining samplers and checks wait for ROADMAP Queue 1 #7g.
"""
from .invariants import (
    AdaptiveBoundSampler,
    TierResidencySampler,
    Verdict,
    check_adaptive_bound,
    check_count_parity,
    check_exactly_once,
    check_lease_staleness,
    check_lock_inversions,
    check_no_errors,
    check_parity,
    check_parity_bitwise,
    check_tier_residency,
)

__all__ = [
    "AdaptiveBoundSampler",
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
    "check_tier_residency",
]
