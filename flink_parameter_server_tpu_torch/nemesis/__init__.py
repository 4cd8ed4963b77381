"""nemesis/ — the parity verdicts the workloads are judged by.

Of the reference's fault-injection harness only the final-table verdicts
of :mod:`.invariants` are ported: what ``Workload.parity_verdict``
(``workloads/base.py``) returns.  The scenarios, the runner, the samplers
and the lease, tier and lock checks wait for ROADMAP Queue 1 #7's
``nemesis/`` item.
"""
from .invariants import (
    Verdict,
    check_count_parity,
    check_exactly_once,
    check_parity,
    check_parity_bitwise,
)

__all__ = [
    "Verdict",
    "check_count_parity",
    "check_exactly_once",
    "check_parity",
    "check_parity_bitwise",
]
