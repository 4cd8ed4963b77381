"""resilience/ — the fault-tolerance layer over the train-while-serve
stack.

What the reference could never do (SURVEY.md §5: Flink's iteration API
gave its PS no usable checkpointing — a lost worker was a lost job),
assembled from four pieces:

  * :mod:`.wal` — bounded write-ahead update log: every consumed
    microbatch is durable before the step applies it; recovery =
    checkpoint + WAL-tail replay, bitwise-equal to the uninterrupted
    run.
  * :mod:`.recovery` — :class:`~.recovery.RecoveringDriver`: supervised
    restart with failure classification, capped exponential backoff
    with jitter, a restart budget, and cursor fast-forward so re-fed
    input is never double-applied.
  * :mod:`.chaos` — deterministic, seeded fault injection
    (:class:`~.chaos.FaultPlan`) so every recovery path runs in tier-1
    tests on CPU.
  * :mod:`.health` — per-component heartbeats + a stall watchdog
    (straggler/stall detection; arxiv 2308.15482's failure mode).

See the JAX package's docs/resilience.md for the failure model and the
recovery-semantics table (what is lost/replayed per failure class); the
port keeps both.  ``wal``, ``chaos`` and ``health`` are copies of the JAX
package's modules (none imports JAX); ``recovery`` maps torch's device
errors where the reference maps XLA's.
"""
from .chaos import (
    ChaosError,
    ChaosLineServer,
    Fault,
    FaultPlan,
    corrupt_latest_checkpoint,
)
from .health import HealthMonitor, StallWatchdog
from .recovery import (
    FailureClass,
    RecoveringDriver,
    RecoveryFailed,
    RestartPolicy,
    classify_failure,
)
from .wal import UpdateWAL, WALRecord

__all__ = [
    "UpdateWAL",
    "WALRecord",
    "RecoveringDriver",
    "RestartPolicy",
    "RecoveryFailed",
    "FailureClass",
    "classify_failure",
    "FaultPlan",
    "Fault",
    "ChaosError",
    "ChaosLineServer",
    "corrupt_latest_checkpoint",
    "HealthMonitor",
    "StallWatchdog",
]
