"""WAL-consistent key migration — the resize's data plane.

A copy of ``flink_parameter_server_tpu/elastic/migration.py``, which
imports no JAX.  The shards it moves rows between keep their slices on
the card (``cluster/shard.py``): ``xfer`` copies the rows off the device
under the shard lock that also reads the sequence number, and ``load``
writes them into the destination's slice tensor, so the bitwise handoff
holds across the device boundary.  Modules it names that the port does
not have yet are the reference's.

Moving a key range between shards while training continues has one
hard requirement and one hard constraint: the moved rows must land on
the new owner BITWISE-equal to the source's final pre-flip values (the
cluster's parity story is exact fp32 — migration must not be the step
that breaks it), and keys that are NOT moving must never block.  The
protocol, per ``(source, destination, ids)`` move:

  1. **bulk transfer, unfrozen** — ``xfer`` snapshots the moving rows
     atomically WITH the source's push sequence (one lock hold:
     ``rows`` reflect exactly the pushes ≤ ``seq``) and ``load``
     assigns them on the destination (WAL-logged, kind=``load``).
     Writes keep landing on the source the whole time — the bulk
     bytes, which dominate migration wall time, cost zero stall;
  2. **freeze** — the source rejects further pushes to the moving
     range (``err frozen``; clients back off and replay — the stall
     clock starts here, and ONLY writes to moving keys feel it);
  3. **WAL tail replay** — the source's log records after each
     chunk's snapshot seq, keyed-filtered to the moving range
     (:meth:`~..resilience.wal.UpdateWAL.replay_range`), are applied
     host-side to the snapshot in log order — the same fp32 additions
     the source applied, so the caught-up rows are bitwise the
     source's — and the touched rows are re-``load``-ed (a handful of
     rows: only keys written between snapshot and freeze);
  4. **exactly-once handoff** — the source's ``(pid, id)`` dedupe
     pairs covering the range move to the destination, so a client
     retry of a push whose ack was lost stays deduplicated ACROSS the
     flip;
  5. **verify** (optional, on by default) — re-read both sides and
     compare bitwise; a mismatch aborts the resize before the flip
     makes it the live truth.

The caller (:class:`~.controller.ElasticClusterDriver`) then flips the
epoch — ``install_epoch`` on every shard, publish on the membership
service — which lifts the freeze.  The stall histogram
(``elastic_migration_stall_seconds``) is observed at that point: per
source, freeze → flip.

Shards without a WAL fall back to freeze-first (freeze, then xfer +
load): correct, but the stall covers the bulk transfer — the module
docstring reason to give shards a ``wal_dir``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..cluster.client import ShardConnection, _check_ok
from ..cluster.partition import Partitioner
from ..cluster.shard import ParamShard, format_rows, parse_rows
from ..telemetry.distributed import TraceContext, format_token, new_trace
from ..telemetry.spans import gen_id


@dataclasses.dataclass(frozen=True)
class Move:
    """One directed key transfer: ``ids`` leave ``src`` for ``dst``."""

    src: int
    dst: int
    ids: np.ndarray


def plan_moves(old: Partitioner, new: Partitioner) -> List[Move]:
    """The ownership diff between two maps, grouped by (src, dst).

    Every key whose owner changes appears in EXACTLY one move (the
    epoch-transition property tests/test_cluster_properties.py pins
    over the whole parameter space); stationary keys appear in none.
    Works for growth (moves land on new shards only, the rendezvous
    invariant), shrink (retired shards drain to survivors), and any
    same-capacity remap — including the adaptive straggler drain
    (adaptive/rebalance.DrainedHashPartitioner), whose weighted remap
    moves keys exclusively OFF the drained shard."""
    if old.capacity != new.capacity:
        raise ValueError(
            f"cannot migrate between maps of capacity {old.capacity} "
            f"and {new.capacity}"
        )
    ids = np.arange(old.capacity, dtype=np.int64)
    before = old.shard_of(ids)
    after = new.shard_of(ids)
    moved = before != after
    moves: List[Move] = []
    for src in np.unique(before[moved]):
        from_src = moved & (before == src)
        for dst in np.unique(after[from_src]):
            sel = from_src & (after == dst)
            moves.append(Move(int(src), int(dst), ids[sel]))
    return moves


@dataclasses.dataclass
class MigrationReport:
    """What a resize's data plane did — the audit surface the e2e
    parity test checks."""

    rows_moved: int = 0
    tail_rows: int = 0  # rows re-loaded from the WAL tail catch-up
    tail_records: int = 0
    pairs_handed_off: int = 0
    freeze_started: Dict[int, float] = dataclasses.field(
        default_factory=dict
    )  # src shard → monotonic freeze time (stall measured at flip)
    verified: bool = False
    mismatches: int = 0
    moves: int = 0


def _xfer_rows(
    conn: ShardConnection,
    ids: np.ndarray,
    value_shape: Tuple[int, ...],
    chunk: int,
    tok: str = "",
) -> Tuple[np.ndarray, np.ndarray]:
    """Pull ``(rows, per_id_snapshot_seq)`` over the wire.  Each chunk
    is one atomic ``xfer``; its seq stamps every id in it, so the tail
    condition is per-id (``record seq > seq0[id]``) and a delta landing
    between two chunks is never applied twice."""
    rows = np.empty((len(ids),) + value_shape, np.float32)
    seqs = np.empty(len(ids), np.int64)
    chunks = [ids[i: i + chunk] for i in range(0, len(ids), chunk)]
    lines = [
        "xfer " + ",".join(str(int(x)) for x in c) + tok for c in chunks
    ]
    pos = 0
    for resp, c in zip(conn.request_many(lines), chunks):
        _check_ok(resp, "xfer")
        _ok, _n, seq_tok, payload = resp.split(" ", 3)
        seq = int(seq_tok.partition("=")[2])
        vals = parse_rows(payload, value_shape)
        if len(vals) != len(c):
            raise RuntimeError(
                f"xfer answered {len(vals)} rows for {len(c)} ids"
            )
        rows[pos: pos + len(c)] = vals
        seqs[pos: pos + len(c)] = seq
        pos += len(c)
    return rows, seqs


def _load_rows(
    conn: ShardConnection,
    ids: np.ndarray,
    rows: np.ndarray,
    chunk: int,
    tok: str = "",
) -> None:
    chunks = range(0, len(ids), chunk)
    lines = [
        "load "
        + ",".join(str(int(x)) for x in ids[i: i + chunk])
        + " "
        + format_rows(rows[i: i + chunk], "b64")
        + tok
        for i in chunks
    ]
    for resp in conn.request_many(lines):
        _check_ok(resp, "load")


def execute_moves(
    moves: Sequence[Move],
    shards_by_id: Dict[int, ParamShard],
    addr_by_id: Dict[int, Tuple[str, int]],
    value_shape: Sequence[int],
    *,
    chunk: int = 1024,
    verify: bool = True,
    registry=None,
    tracer=None,
    timeout: float = 30.0,
    connect_timeout: float = 5.0,
) -> MigrationReport:
    """Run the migration protocol for every move; the caller flips the
    epoch afterwards (sources stay frozen until then).  ``shards_by_id``
    holds in-process handles (WAL tail + pid handoff + freeze are
    control-plane local); bulk rows move over the wire via
    ``addr_by_id``.  With a ``tracer``, the whole migration becomes one
    distributed trace: per-move ``migrate.move`` spans on the control
    plane, and every ``xfer``/``load`` frame stamped with a
    ``t=<trace>:<span>`` token so the involved shards' server spans
    stitch into the same story."""
    value_shape = tuple(int(s) for s in value_shape)
    report = MigrationReport(moves=len(moves))
    ctx = root_cm = None
    if tracer is not None and tracer.enabled:
        ctx = new_trace()
        root_cm = tracer.span(
            "migrate", "elastic",
            trace_id=ctx.trace_id, span_id=ctx.span_id,
        )
        root_cm.__enter__()

    def _move_trace(src: int, dst: int):
        """(token, span_cm) for one move's wire frames."""
        if ctx is None:
            return "", None
        span_id = gen_id(4)
        tok = " " + format_token(TraceContext(ctx.trace_id, span_id))
        return tok, tracer.span(
            f"migrate.move.{src}-{dst}", "elastic",
            trace_id=ctx.trace_id, parent_id=ctx.span_id, span_id=span_id,
        )
    if registry is not False and registry is not None:
        c_rows = registry.counter(
            "elastic_rows_migrated_total", component="elastic"
        )
        c_tail = registry.counter(
            "elastic_tail_rows_replayed_total", component="elastic"
        )
    else:
        c_rows = c_tail = None
    conns: Dict[int, ShardConnection] = {}

    def conn(shard_id: int) -> ShardConnection:
        if shard_id not in conns:
            host, port = addr_by_id[shard_id]
            conns[shard_id] = ShardConnection(
                host, port, window=8, timeout=timeout,
                connect_timeout=connect_timeout,
            )
        return conns[shard_id]

    by_src: Dict[int, List[Move]] = {}
    for mv in moves:
        by_src.setdefault(mv.src, []).append(mv)

    try:
        for src, src_moves in sorted(by_src.items()):
            src_shard = shards_by_id[src]
            moving = np.concatenate([mv.ids for mv in src_moves])
            has_wal = src_shard._wal is not None
            if not has_wal:
                # no log to catch up from: freeze-first (stall covers
                # the bulk transfer — correct, just slower)
                src_shard.freeze(moving)
                report.freeze_started[src] = time.monotonic()
            snap: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
            for mv in src_moves:
                tok, move_cm = _move_trace(mv.src, mv.dst)
                if move_cm is not None:
                    move_cm.__enter__()
                try:
                    rows, seqs = _xfer_rows(
                        conn(src), mv.ids, value_shape, chunk, tok
                    )
                    _load_rows(conn(mv.dst), mv.ids, rows, chunk, tok)
                finally:
                    if move_cm is not None:
                        move_cm.__exit__(None, None, None)
                snap[mv.dst] = (mv.ids, rows, seqs)
                report.rows_moved += int(len(mv.ids))
                if c_rows is not None:
                    c_rows.inc(len(mv.ids))
            if has_wal:
                src_shard.freeze(moving)
                report.freeze_started[src] = time.monotonic()
                # catch-up: apply the source's post-snapshot log tail
                # to the snapshot, host-side, in log order — the same
                # fp32 adds the source applied, hence bitwise
                min_seq = min(
                    int(s.min()) for _, _, s in snap.values()
                ) if snap else 0
                tail = src_shard.wal_tail(min_seq, moving)
                for dst, (ids, rows, seqs) in snap.items():
                    touched = np.zeros(len(ids), bool)
                    order = np.argsort(ids)
                    sorted_ids = ids[order]
                    for rec in tail:
                        payload = rec.payload
                        rec_ids = np.asarray(payload["ids"], np.int64)
                        pos = np.searchsorted(sorted_ids, rec_ids)
                        ok = (pos < len(sorted_ids)) & (
                            sorted_ids[
                                np.minimum(pos, len(sorted_ids) - 1)
                            ] == rec_ids
                        )
                        if not ok.any():
                            continue
                        report.tail_records += 1
                        rows_idx = order[pos[ok]]
                        # per-id snapshot fencing: a record already in
                        # the chunk's snapshot must not re-apply
                        fresh = rec.end_step > seqs[rows_idx]
                        rows_idx = rows_idx[fresh]
                        if not len(rows_idx):
                            continue
                        if payload.get("kind") == "load":
                            rows[rows_idx] = np.asarray(
                                payload["values"], np.float32
                            )[ok][fresh]
                        else:
                            from ..compression.quantizers import (
                                record_deltas,
                            )

                            rows[rows_idx] = rows[rows_idx] + (
                                record_deltas(payload)[ok][fresh]
                            )
                        touched[rows_idx] = True
                    if touched.any():
                        _load_rows(
                            conn(dst), ids[touched], rows[touched], chunk
                        )
                        report.tail_rows += int(touched.sum())
                        if c_tail is not None:
                            c_tail.inc(int(touched.sum()))
            # exactly-once handoff: the dedupe pairs covering the range
            # follow the rows to the new owner
            for mv in src_moves:
                pairs = src_shard.applied_pairs_for(mv.ids)
                shards_by_id[mv.dst].merge_applied_pairs(pairs)
                report.pairs_handed_off += len(pairs)
            if verify:
                for mv in src_moves:
                    src_rows, _ = src_shard.snapshot_rows(mv.ids)
                    dst_rows = shards_by_id[mv.dst].peek_rows(mv.ids)
                    if not np.array_equal(
                        src_rows.astype(np.float32),
                        dst_rows.astype(np.float32),
                    ):
                        report.mismatches += int(
                            (src_rows != dst_rows).any(
                                axis=tuple(range(1, src_rows.ndim))
                            ).sum()
                        )
                if report.mismatches:
                    src_shard.unfreeze()
                    raise RuntimeError(
                        f"migration verify failed: {report.mismatches} "
                        f"rows differ between source {src} and their "
                        f"destinations — resize aborted before the flip"
                    )
        report.verified = bool(verify)
    finally:
        for c in conns.values():
            c.close()
        if root_cm is not None:
            root_cm.__exit__(None, None, None)
    return report


__all__ = ["Move", "plan_moves", "MigrationReport", "execute_moves"]
