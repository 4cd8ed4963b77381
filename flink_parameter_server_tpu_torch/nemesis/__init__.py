"""nemesis/ — network-level fault injection + cluster invariant checking.

Counterpart of ``flink_parameter_server_tpu/nemesis/``: a Jepsen-lite for
the parameter-server cluster, in which every robustness claim the stack
makes — exactly-once updates across retries, parity with a fault-free
run, SSP staleness bounds, sub-second failover — becomes a *checked
invariant under composed network faults* instead of an anecdote.

  * :mod:`.proxy` — :class:`ChaosProxy`, a seeded byte-level TCP chaos
    proxy fronting any ``LineServer`` (shard, serving, repl leg):
    partitions (one-way and two-way), delay/jitter, bandwidth drip,
    frame duplication/reorder, mid-frame truncation + RST, half-open
    accepts;
  * :mod:`.scenarios` — the scenario DSL: network faults composed with
    cluster operations, serializable to a canonical JSON schedule
    byte-identical to the reference's (a schedule names no device);
  * :mod:`.invariants` — the checkers: exactly-once ledger audit,
    final-table parity vs a fault-free oracle, SSP staleness bound,
    serving error budget, lease staleness, the adaptive bound envelope,
    tier residency, zero leaked threads, zero lock inversions;
  * :mod:`.runner` — proxied cluster drivers (every client↔shard byte
    crosses the mesh) whose slices live on ``device=`` (the card unless
    the caller passes ``device="cpu"``), the scenario executor, a
    randomized scenario search whose failures are reproducible from
    ``(seed, schedule)``, a shrinker that minimizes failing schedules,
    and the committed regression corpus (``nemesis/corpus/``).
"""
from .invariants import (
    AdaptiveBoundSampler,
    StalenessSampler,
    ThreadLedger,
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
    check_serving_budget,
    check_staleness,
    check_tier_residency,
)
from .proxy import ChaosProxy, ProxiedServer
from .runner import (
    NemesisElasticDriver,
    NemesisReplicatedDriver,
    ScenarioReport,
    load_corpus,
    replay_corpus,
    run_scenario,
    search_scenarios,
    shrink,
)
from .scenarios import BUILTIN_SCENARIOS, NemesisOp, Scenario

__all__ = [
    "AdaptiveBoundSampler",
    "BUILTIN_SCENARIOS",
    "ChaosProxy",
    "NemesisElasticDriver",
    "NemesisOp",
    "NemesisReplicatedDriver",
    "ProxiedServer",
    "Scenario",
    "ScenarioReport",
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
    "load_corpus",
    "replay_corpus",
    "run_scenario",
    "search_scenarios",
    "shrink",
]
