"""loadgen/ — the overload-control plane the cluster client raises through.

Of the reference's ``loadgen/`` only ``overload.py`` is ported so far: the
client's typed shed error (``OverloadedError``), the circuit breakers a
user can attach to a client and the ``OverloadGuard`` a shard server
takes.  The module is the reference's whole: its retry budget serves the
soak harness, which waits for the rest of loadgen/, and its brownout
widens the hot cache's staleness bound (``hotcache/``); the arrival
schedules, the Zipf population and the soak runner are ROADMAP Queue 1
#7 too.
"""
from .overload import (
    PRIORITY_CRITICAL,
    PRIORITY_NORMAL,
    PRIORITY_SHEDDABLE,
    BreakerBoard,
    BrownoutController,
    CircuitBreaker,
    LoadShedder,
    OverloadedError,
    OverloadGuard,
    RetryBudget,
    RetryBudgetExhausted,
)

__all__ = [
    "BreakerBoard",
    "BrownoutController",
    "CircuitBreaker",
    "LoadShedder",
    "OverloadGuard",
    "OverloadedError",
    "PRIORITY_CRITICAL",
    "PRIORITY_NORMAL",
    "PRIORITY_SHEDDABLE",
    "RetryBudget",
    "RetryBudgetExhausted",
]
