"""The nemesis scenario DSL — composed faults as reproducible schedules.

Counterpart of ``flink_parameter_server_tpu/nemesis/scenarios.py``, which
imports no JAX: a copy, since the port imports nothing of the JAX package
(whose ``__init__`` imports JAX).  The canonical JSON is
byte-identical to the reference's, so a schedule carries no device: the
device is an argument of the runner (:func:`~.runner.run_scenario`).

A scenario is a fixed workload (the same seeded synthetic-ratings
stream every parity test in this repo trains on) plus an ordered list
of :class:`NemesisOp`\\ s, each keyed to a TRAINING ROUND rather than a
wall-clock instant: op ``k`` fires once any worker reaches
``at_round`` (the nemesis thread waits on the round counter, then
executes ops in list order).  Round-keyed schedules are what make a
failing run reproducible from its ``(seed, schedule)`` pair — the
schedule says *where in the computation* each fault landed, not when
on somebody's laptop clock.

Ops come in two vocabularies, deliberately mixed (the Jepsen recipe —
a nemesis composes network faults WITH cluster operations):

  * **wire ops** → the shard's :class:`~.proxy.ChaosProxy`:
    ``partition`` (one-way/two-way, optionally self-healing after
    ``ms``), ``heal``, ``delay``/``clear_delay``, ``drip``/
    ``clear_drip``, ``truncate_next``, ``dup_next``, ``reorder_next``,
    ``half_open``;
  * **cluster ops** → the driver: ``kill_shard``, ``replace_shard``,
    ``promote_shard``, ``scale_out``, ``scale_in``, ``sleep``, and
    ``corrupt_row`` — a SILENT out-of-band row perturbation (no WAL,
    no ledger entry: simulated bit-rot) whose only witness is the
    final-table parity checker.  It exists to prove the checkers can
    catch a real violation; every other op the stack must survive.

Serialization is canonical (sorted keys, no whitespace): a schedule
round-trips byte-identically through :meth:`Scenario.to_json` /
:meth:`Scenario.from_json`, which is the regression-corpus contract
(``nemesis/corpus/``) and what the shrinker's minimized output is
committed as.

``BUILTIN_SCENARIOS`` is the fixed-seed battery tier-1 replays —
fourteen scenarios covering every proxy fault class, including the
asymmetric partition splitting a live migration,
kill-primary-under-partition, the partition-client-mid-lease schedule
proving the hot-key cache's staleness bound holds through a fault
(hotcache/, docs/hotcache.md), and the two full-stack
workload scenarios (``pa_full_stack``, ``sketch_full_stack``:
train-while-serve-while-resize-while-faulted for the non-MF learners,
workloads/ + docs/workloads.md), and the
``kill_promote_cold_tier`` anchor (failover over a mostly-demoted
two-tier store, tierstore/ + docs/tierstore.md) — plus
``VIOLATION_SCENARIO``, the
deliberately seeded corruption the checkers must catch.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np

WIRE_ACTIONS = frozenset({
    "partition", "heal", "delay", "clear_delay", "drip", "clear_drip",
    "truncate_next", "dup_next", "reorder_next", "half_open",
})
CLUSTER_ACTIONS = frozenset({
    "kill_shard", "replace_shard", "promote_shard", "scale_out",
    "scale_in", "sleep", "corrupt_row",
})
ACTIONS = WIRE_ACTIONS | CLUSTER_ACTIONS


@dataclasses.dataclass(frozen=True)
class NemesisOp:
    """One scheduled operation.  ``ms`` is overloaded per action:
    partition self-heal duration, delay per-frame latency, sleep
    duration.  ``mode`` is the wire direction (``c2s``/``s2c``/
    ``both``); one-shot frame faults default ``mode='both'`` to the
    direction named in their docstring (``s2c`` — responses)."""

    at_round: int
    action: str
    shard: int = 0
    mode: str = "both"
    ms: float = 0.0
    jitter_ms: float = 0.0
    bytes_per_sec: float = 0.0
    keep_frac: float = 0.35
    count: int = 1
    gid: int = 0
    # truncate_next aim over BINARY frames (utils/frames.py): "frame"
    # cuts anywhere (keep_frac of the bytes — the line-protocol cut
    # too), "header" tears inside the 24-byte fixed header (the
    # length prefix never completes), "payload" past it (the length
    # promised more than EOF delivered)
    cut: str = "frame"

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(
                f"action {self.action!r}: one of {sorted(ACTIONS)}"
            )
        if self.at_round < 0:
            raise ValueError(f"at_round={self.at_round}: must be >= 0")

    def to_dict(self) -> dict:
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
        }


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One reproducible experiment: workload shape + op schedule.

    ``parity=True`` runs the fault-free oracle on the same stream and
    requires the final table allclose-equal (only meaningful under
    BSP, ``staleness_bound=0`` — SSP reorders updates by design).
    ``expect`` records the corpus contract: ``"pass"`` scenarios must
    satisfy every checker; ``"violation"`` scenarios must FAIL one
    (they pin that the checkers still catch what they exist to catch).
    """

    name: str
    ops: Tuple[NemesisOp, ...]
    seed: int = 0
    # the registered workload this scenario trains (workloads/
    # registry.py): "mf" | "pa" | "sketch" — the runner resolves the
    # logic, stream, init and PARITY MODE (allclose for MF, bitwise
    # for PA, integer-exact for sketches) through the registry, so
    # one schedule vocabulary drives every learner
    workload: str = "mf"
    rounds: int = 12
    batch: int = 96
    num_users: int = 48
    num_items: int = 64
    dim: int = 4
    num_shards: int = 2
    num_workers: int = 2
    staleness_bound: Optional[int] = 0
    replicated: bool = False
    parity: bool = True
    serving_reads: bool = True
    # the reader thread serves through a client-edge hot-key lease
    # cache (hotcache/, docs/hotcache.md) and the run must satisfy the
    # lease_staleness invariant — no cached row served past the bound,
    # through whatever the schedule does to the wire.  Workers stay
    # BSP-uncached (the carve-out), so parity remains meaningful.
    hotcache: bool = False
    # client payload encoding (cluster/driver.py ClusterConfig):
    # "b64" = the exact default; "q8"/"bf16" replay the schedule over
    # QUANTIZED-enc connections (compression/, docs/compression.md) —
    # the torn-quantized-frame regression rides this field.  BSP
    # scenarios keep parity either way (the driver's bound-0 carve-out
    # downgrades worker clients to exact fp32).
    wire_format: str = "b64"
    request_timeout: float = 15.0
    retry_timeout: float = 60.0
    # straggler-adaptive runtime (adaptive/, docs/adaptive.md): the
    # driver gets the AdaptiveClock + push hedging kill switch and the
    # runner attaches a timeline-fed AdaptiveRuntime, samples the
    # per-worker effective bounds live, and audits the
    # adaptive_bound_envelope invariant.  The staleness check then
    # judges the spread against the CEILING (widened allowances
    # legally raise the spread to ceiling + 1).
    adaptive: bool = False
    # two-tier parameter store (tierstore/, docs/tierstore.md): the
    # shard slices run store_backend="tiered" with a DELIBERATELY tiny
    # hot tier, so the schedule's reads and the recovery paths (WAL
    # replay, promotion catch-up) must cross the demoted cold set.
    # The runner samples per-shard tier stats live and audits the
    # tier_residency invariant: resident rows never exceed the
    # configured hot capacity, at any sample, through every fault.
    tiered: bool = False
    tier_hot_rows: int = 24
    expect: str = "pass"

    def __post_init__(self):
        if self.expect not in ("pass", "violation"):
            raise ValueError(f"expect={self.expect!r}: 'pass' | 'violation'")
        if self.parity and self.staleness_bound != 0:
            raise ValueError(
                f"{self.name}: parity vs the fault-free oracle needs "
                f"BSP (staleness_bound=0) — SSP reorders updates"
            )

    # -- canonical JSON (the corpus / shrinker round-trip contract) --------
    def to_json(self) -> str:
        doc = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.name != "ops"
        }
        doc["ops"] = [op.to_dict() for op in self.ops]
        return json.dumps(doc, sort_keys=True, separators=(",", ":"))

    @classmethod
    def from_json(cls, text: str) -> "Scenario":
        doc = json.loads(text)
        ops = tuple(NemesisOp(**op) for op in doc.pop("ops"))
        return cls(ops=ops, **doc)

    def with_ops(self, ops) -> "Scenario":
        return dataclasses.replace(self, ops=tuple(ops))

    # -- the randomized search's generator ---------------------------------
    @classmethod
    def from_seed(cls, seed: int, **overrides) -> "Scenario":
        """Sample a small schedule deterministically: 2–4 ops from the
        survivable vocabulary, faults landing in the middle half of the
        stream so the run both feels them and recovers.  Same seed ⇒
        same scenario, any host — the search's failures are replayable
        by seed alone."""
        rng = np.random.default_rng(seed)
        rounds = int(overrides.get("rounds", 12))
        num_shards = int(overrides.get("num_shards", 2))
        n_ops = int(rng.integers(2, 5))
        ops = []
        for _ in range(n_ops):
            at = int(rng.integers(rounds // 4, max(rounds // 4 + 1,
                                                   (3 * rounds) // 4)))
            shard = int(rng.integers(0, num_shards))
            kind = int(rng.integers(0, 4))
            if kind == 0:
                ops.append(NemesisOp(
                    at, "partition", shard=shard,
                    mode=["both", "c2s", "s2c"][int(rng.integers(0, 3))],
                    ms=float(rng.uniform(100.0, 300.0)),
                ))
            elif kind == 1:
                ops.append(NemesisOp(
                    at, "delay", shard=shard,
                    ms=float(rng.uniform(2.0, 15.0)),
                    jitter_ms=float(rng.uniform(0.0, 10.0)),
                ))
                ops.append(NemesisOp(
                    min(rounds - 1, at + int(rng.integers(1, 4))),
                    "clear_delay", shard=shard,
                ))
            elif kind == 2:
                ops.append(NemesisOp(
                    at, "truncate_next", shard=shard,
                    mode=["c2s", "s2c"][int(rng.integers(0, 2))],
                    keep_frac=float(rng.uniform(0.1, 0.9)),
                ))
            else:
                ops.append(NemesisOp(
                    at, "kill_shard", shard=shard,
                ))
                ops.append(NemesisOp(
                    at, "replace_shard", shard=shard,
                ))
        ops.sort(key=lambda o: o.at_round)
        overrides.setdefault("name", f"rand-{seed}")
        overrides.setdefault("seed", int(seed))
        return cls(ops=tuple(ops), **overrides)


# ---------------------------------------------------------------------------
# the fixed-seed battery (tier-1 replays these from nemesis/corpus/)
# ---------------------------------------------------------------------------

BUILTIN_SCENARIOS: Tuple[Scenario, ...] = (
    # 1. a clean two-way partition that heals: clients stall, retry,
    # converge — zero lost/duplicated updates, parity holds
    Scenario(
        "two_way_partition_heal",
        (NemesisOp(3, "partition", shard=0, mode="both", ms=250.0),),
        seed=101,
    ),
    # 2. one-way partition: requests blackholed, responses flow — the
    # half of a partial partition a liveness check built on responses
    # alone would miss
    Scenario(
        "one_way_partition_c2s",
        (NemesisOp(4, "partition", shard=1, mode="c2s", ms=250.0),),
        seed=102,
    ),
    # 3. anchor: an ASYMMETRIC partition splits a live migration
    # mid-flight — scale-out's xfer/load traffic crosses the mesh, the
    # s2c leg stalls, the migration waits it out, the flip still
    # verifies bitwise
    Scenario(
        "asym_partition_during_migration",
        (
            NemesisOp(4, "partition", shard=0, mode="s2c", ms=300.0),
            NemesisOp(4, "scale_out"),
        ),
        seed=103,
        rounds=14,
    ),
    # 4. anchor: kill-primary-under-partition — the shard dies
    # WHILE clients are partitioned from it; replacement publishes a
    # fresh address under a new epoch and everyone converges
    Scenario(
        "kill_primary_under_partition",
        (
            NemesisOp(4, "partition", shard=1, mode="both", ms=300.0),
            NemesisOp(4, "kill_shard", shard=1),
            NemesisOp(4, "replace_shard", shard=1),
        ),
        seed=104,
        rounds=14,
    ),
    # 5. promote-while-client-partitioned: replica chains — the dead
    # primary's clients are partitioned from its proxy; promotion
    # flips the epoch to the follower's (un-partitioned) address
    Scenario(
        "promote_while_client_partitioned",
        (
            NemesisOp(4, "partition", shard=0, mode="c2s", ms=300.0),
            NemesisOp(4, "kill_shard", shard=0),
            NemesisOp(4, "promote_shard", shard=0),
        ),
        seed=105,
        rounds=14,
        replicated=True,
    ),
    # 6. scale-out-during-drip: the link is bandwidth-starved while the
    # migration's bulk xfer crosses it
    Scenario(
        "scale_out_during_drip",
        (
            NemesisOp(3, "drip", shard=0, bytes_per_sec=200_000.0),
            NemesisOp(5, "scale_out"),
            NemesisOp(7, "clear_drip", shard=0),
        ),
        seed=106,
        rounds=14,
    ),
    # 7. slow-shard straggler storm under SSP: one shard's frames are
    # delayed+jittered for a window; the staleness bound must hold
    # (parity is off — SSP reorders updates by design).  Runs with the
    # adaptive runtime live: the per-worker effective bounds are
    # sampled through the storm and the adaptive_bound_envelope
    # invariant must hold.
    Scenario(
        "straggler_storm_ssp",
        (
            NemesisOp(3, "delay", shard=0, ms=10.0, jitter_ms=8.0),
            NemesisOp(8, "clear_delay", shard=0),
        ),
        seed=107,
        rounds=14,
        staleness_bound=2,
        parity=False,
        adaptive=True,
    ),
    # 8. mid-frame RST on a pull RESPONSE: the payload is torn
    # mid-frame and the connection reset — the client replays; pulls
    # are idempotent, parity holds.  Over the binary transport the
    # two cuts are AIMED: one inside the 24-byte fixed header (the
    # length prefix never completes), one inside the row payload (the
    # length promised more than EOF delivered) — the two torn-read
    # shapes a length-prefixed reader must survive.
    Scenario(
        "mid_frame_rst_pull",
        (
            NemesisOp(3, "truncate_next", shard=0, mode="s2c",
                      keep_frac=0.4, cut="header"),
            NemesisOp(7, "truncate_next", shard=0, mode="s2c",
                      keep_frac=0.7, cut="payload"),
        ),
        seed=108,
    ),
    # 9. mid-frame RST on a push REQUEST: the delta payload dies
    # mid-wire; the replay carries the same pid, the (pid,id) ledger
    # absorbs any half-applied ambiguity — exactly-once audit
    # balances.  Same header/payload aim as #8, on the request leg.
    Scenario(
        "mid_frame_rst_push",
        (
            NemesisOp(3, "truncate_next", shard=0, mode="c2s",
                      keep_frac=0.3, cut="header"),
            NemesisOp(7, "truncate_next", shard=1, mode="c2s",
                      keep_frac=0.6, cut="payload"),
        ),
        seed=109,
    ),
    # 10. anchor: partition the CLIENT mid-lease — the reader
    # holds hot-key leases (hotcache/) when shard 0's link blackholes
    # both ways, then shard 1's response leg stalls.  Piggybacked
    # invalidations cannot arrive through a partition, which is exactly
    # the case the client-local staleness bound exists for: the
    # lease_staleness checker proves no cached row was ever served
    # past the bound, while cached hits keep the serving error budget
    # clean through the fault window.
    Scenario(
        "partition_client_mid_lease",
        (
            NemesisOp(3, "partition", shard=0, mode="both", ms=250.0),
            NemesisOp(6, "partition", shard=1, mode="s2c", ms=150.0),
        ),
        seed=111,
        rounds=14,
        hotcache=True,
    ),
    # 11. half-open accept: the dial succeeds, the server never answers
    # — the client's read deadline, not the connect, is what saves it.
    # The preceding mid-frame RST kills the pooled connection, so the
    # redial is what lands on the half-open accept (pooled connections
    # never re-dial on their own).
    Scenario(
        "half_open_accept",
        (
            NemesisOp(3, "half_open", shard=0, count=1),
            NemesisOp(3, "truncate_next", shard=0, mode="s2c",
                      keep_frac=0.5),
        ),
        seed=110,
        request_timeout=1.0,
    ),
    # 12. full-stack acceptance, PA: the passive-aggressive classifier
    # through the FULL stack — train-while-serve-while-resize-while-
    # faulted: a both-ways partition, a live scale-out, then
    # kill-primary→promote, with the serving reader issuing `predict`
    # probes throughout.  num_workers=1 because the parity bar is
    # BITWISE (workloads/pa.py: with one writer the dense-combined
    # update order is structurally deterministic; two writers'
    # interleaved fp32 adds are not associative).
    Scenario(
        "pa_full_stack",
        (
            NemesisOp(3, "partition", shard=0, mode="both", ms=250.0),
            NemesisOp(5, "scale_out"),
            NemesisOp(8, "kill_shard", shard=1),
            NemesisOp(8, "promote_shard", shard=1),
        ),
        seed=112,
        rounds=14,
        num_workers=1,
        replicated=True,
        workload="pa",
    ),
    # 13. full-stack acceptance, sketches: the count-min layer through
    # the same resize+failover gauntlet PLUS a mid-frame RST on a push
    # request — the torn-frame replay must not lose or double a single
    # increment.  wire_format="q8" is REQUESTED to pin the
    # increment-semantics carve-out: the driver bypasses quantization
    # for increment workloads, so counts stay integer-exact (the
    # parity checker runs with no float tolerance) even though the
    # config asked for the quantized codec.  Two workers: integer adds
    # commute, so exactness must survive interleaving too.
    # 14. anchor: kill→promote over a COLD tier — the whole
    # chain runs store_backend="tiered" with a hot tier far smaller
    # than the table (24 rows vs a 56-row slice), so by round 4 most
    # mutated rows live in the mmap cold slab.  Killing the primary
    # and promoting its follower forces the promotion catch-up (WAL
    # tail drain) and the post-flip serving reads through demoted
    # rows; parity against the all-RAM oracle proves the tier swap is
    # invisible to correctness, and the sampled tier_residency
    # invariant proves the resident set stayed within the configured
    # hot capacity throughout.
    Scenario(
        "kill_promote_cold_tier",
        (
            NemesisOp(4, "kill_shard", shard=0),
            NemesisOp(4, "promote_shard", shard=0),
        ),
        seed=114,
        rounds=14,
        replicated=True,
        tiered=True,
    ),
    Scenario(
        "sketch_full_stack",
        (
            NemesisOp(3, "truncate_next", shard=0, mode="c2s",
                      keep_frac=0.5, cut="payload"),
            NemesisOp(4, "partition", shard=1, mode="both", ms=250.0),
            NemesisOp(6, "scale_out"),
            NemesisOp(9, "kill_shard", shard=0),
            NemesisOp(9, "promote_shard", shard=0),
        ),
        seed=113,
        rounds=14,
        replicated=True,
        workload="sketch",
        wire_format="q8",
    ),
)

# The deliberately seeded invariant violation (NOT part of the passing
# battery): silent out-of-band row corruption buried in survivable
# noise ops.  The parity checker must catch it; the shrinker must
# reduce the schedule to the single corrupt_row op.
VIOLATION_SCENARIO = Scenario(
    "seeded_corruption",
    (
        NemesisOp(2, "delay", shard=0, ms=2.0),
        NemesisOp(4, "clear_delay", shard=0),
        NemesisOp(5, "corrupt_row", shard=0, gid=7),
        NemesisOp(7, "partition", shard=1, mode="both", ms=100.0),
    ),
    seed=666,
    rounds=10,
    serving_reads=False,
    expect="violation",
)


__all__ = [
    "ACTIONS",
    "BUILTIN_SCENARIOS",
    "CLUSTER_ACTIONS",
    "NemesisOp",
    "Scenario",
    "VIOLATION_SCENARIO",
    "WIRE_ACTIONS",
]
