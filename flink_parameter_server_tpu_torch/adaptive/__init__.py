"""adaptive/: straggler-adaptive runtime.

The port's copy of ``flink_parameter_server_tpu/adaptive/``: host control
code over the cluster's clock, router and clients, which imports no JAX.
Nothing here touches a tensor; the shards the runtime steers keep their
slices on the driver's device.

Closed-loop control over the SSP consistency dial, built on the
timeline plane (``telemetry/timeline``): detection (SkewTracker gauges
+ the anomaly ledger) feeds three actuators —

* :mod:`.bounds` — per-worker dynamic staleness allowances
  (:class:`AdaptiveClock`) widened for flagged stragglers, narrowed
  with hysteresis, always inside ``[bound, bound_ceiling]``;
* :mod:`.hedge` — budgeted backup pushes raced on a second connection
  (:class:`PushHedger`), duplicate-apply suppression structural via
  the (pid, id) exactly-once dedupe window;
* :mod:`.rebalance` — :class:`RebalancePolicy` that routes
  ``worker_key`` row groups away from *persistent* stragglers and can
  drain shards through the elastic migration plane
  (plan_moves/execute_moves), rate-limited and cooldown-gated.

:mod:`.controller` glues detection → bounds → hedge → rebalance into
one :class:`AdaptiveRuntime` loop with per-decision records and
``component=adaptive`` instruments.  Kill switch: ``ClusterConfig.
adaptive`` (inherited by Elastic/Replicated configs).
"""
from .bounds import AdaptiveClock, BoundPolicy
from .hedge import PushHedger
from .rebalance import RebalancePolicy, WorkRouter, DrainedHashPartitioner
from .controller import (
    AdaptiveRuntime,
    get_adaptive_runtime,
    set_adaptive_runtime,
)

__all__ = [
    "AdaptiveClock",
    "BoundPolicy",
    "PushHedger",
    "RebalancePolicy",
    "WorkRouter",
    "DrainedHashPartitioner",
    "AdaptiveRuntime",
    "get_adaptive_runtime",
    "set_adaptive_runtime",
]
