"""elastic/ — live shard membership for the multi-shard PS runtime.

The control plane over cluster/ that turns a fixed deployment into a
resizable service (the ROADMAP north-star's scaling story; elastic
aggregation arXiv:2204.03211, straggler mitigation arXiv:2308.15482):

  * :mod:`.membership` — epoch-versioned partition maps: every
    pull/push frame is tagged with the epoch that routed it, shards
    reject stale-epoch writes, so a map flip can never mix routings;
  * :mod:`.migration` — WAL-consistent key handoff: bulk rows move
    unfrozen, a brief freeze covers only the WAL-tail catch-up,
    migrated rows land bitwise-equal, non-moving keys never block;
  * :mod:`.controller` — :class:`~.controller.ElasticClusterDriver`
    (scale-out / drain-and-retire scale-in / dead-shard replacement,
    mid-job) and :class:`~.controller.ElasticController` (the
    registry-watching policy loop that drives it);
  * :mod:`.hedging` — budgeted backup pulls raced against a straggling
    shard, first answer wins, duplicates counted, never double-applied.

Counterpart of ``flink_parameter_server_tpu/elastic/``: the shards it
resizes keep their slices on the card unless the caller passes
``device="cpu"``.  The reference's docs/elastic.md describes the epoch
protocol, the migration state machine, and the hedging budget semantics.
"""
from .controller import (
    ElasticClusterConfig,
    ElasticClusterDriver,
    ElasticController,
    ScalePolicy,
)
from .hedging import HedgeBudget, Hedger
from .membership import MembershipService, PartitionEpoch
from .migration import MigrationReport, Move, execute_moves, plan_moves

__all__ = [
    "ElasticClusterConfig",
    "ElasticClusterDriver",
    "ElasticController",
    "HedgeBudget",
    "Hedger",
    "MembershipService",
    "MigrationReport",
    "Move",
    "PartitionEpoch",
    "ScalePolicy",
    "execute_moves",
    "plan_moves",
]
