"""ReplicaShard — a chain follower: WAL-fed state, read-only service.

Counterpart of ``flink_parameter_server_tpu/replication/follower.py``.
The follower's slice sits on ``device`` like a primary's (the card unless
the caller asks for the CPU): each logged record goes through the same
:meth:`~..cluster.shard.ParamShard._apply` — the store's ``"xla"`` arm,
``ops/rows.accumulate_rows_``, one record per call in log order — so a
caught-up follower is bitwise its primary on either device.  Quantized
records decode through ``compression.quantizers.record_deltas`` on the
host before they reach the device.  Under a tiered primary the follower
is tiered too (``store_backend="tiered"``, its hot tier on ``device``), so
a promotion does not change where the slice lives.

A follower is a :class:`~..cluster.shard.ParamShard` whose state is
maintained exclusively by the replication stream: each inbound ``repl``
record is appended to the follower's OWN WAL first (write-ahead — the
ack means *durable here*, and the follower's log is what a promotion
catches up from), then applied asynchronously by a dedicated applier
thread through the exact same scatter path the primary used — which is
what makes a caught-up follower's slice **bitwise** the primary's (same
deterministic init, same records, same fp32 op order).

The read-staleness contract (the SSP bound of ``cluster/clock.py``
carried to the read path): every ``repl`` frame carries the primary's
head sequence; the follower's lag is ``head − applied``.  A pull
arriving while ``lag > staleness_bound`` raises
:class:`~..cluster.shard.FollowerLagging` (``err lagging`` on the
wire) and the client falls back to the primary — a degraded replica
sheds reads instead of serving arbitrarily stale rows.  Writes
(``push``/``load``) always answer ``err not-primary``.

Promotion (replication/failover.py) is three local steps, all O(lag):
:meth:`catch_up` (drain the follower's own WAL tail past its applied
cursor), :meth:`ingest` (salvage the dead primary's unshipped log
tail, when its disk survived), :meth:`promote_to_primary` (flip the
role + epoch; the shard then IS a primary — same write surface, same
WAL, seq space continuous with the old primary's).
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from ..cluster.partition import Partitioner
from ..cluster.shard import FollowerLagging, NotPrimary, ParamShard
from ..utils.device import DeviceLike


class ReplicaShard(ParamShard):
    """A follower in a replica chain (see module docstring).

    ``staleness_bound`` is in WAL records (one primary push/load each):
    ``None`` serves reads at any lag, ``0`` only when fully applied.
    """

    def __init__(
        self,
        shard_id: int,
        partitioner: Partitioner,
        value_shape=(),
        *,
        init_fn=None,
        dtype=None,
        wal_dir: Optional[str] = None,
        staleness_bound: Optional[int] = None,
        follower_idx: int = 0,
        registry=None,
        profiler=None,
        store_backend: str = "torch",
        device: DeviceLike = None,
        tier_hot_rows: int = 65536,
        tier_slab_dir: Optional[str] = None,
        tier_decay_window: int = 0,
    ):
        if wal_dir is None:
            raise ValueError(
                "a ReplicaShard needs its own wal_dir: the follower's "
                "log is both the ack's durability and what a promotion "
                "catches up from"
            )
        # set before super().__init__: a tiered follower registers on
        # the tiers snapshot registry during construction, and its
        # label (shard-N-fK) must not clobber the primary's (shard-N)
        self.follower_idx = int(follower_idx)
        # cluster counters off (a follower shares its primary's
        # shard_id — registering the same labels would fork the series);
        # replication-plane instruments below are the follower's own
        super().__init__(
            shard_id, partitioner, value_shape,
            init_fn=init_fn, dtype=dtype, wal_dir=wal_dir,
            registry=False, profiler=profiler,
            store_backend=store_backend, device=device,
            tier_hot_rows=tier_hot_rows,
            tier_slab_dir=tier_slab_dir,
            tier_decay_window=tier_decay_window,
        )
        self.role = "follower"
        self.staleness_bound = (
            None if staleness_bound is None else int(staleness_bound)
        )
        self.follower_idx = int(follower_idx)
        # sequence cursors: _applied_end trails the WAL head while the
        # applier drains; _known_head trails the primary (updated from
        # repl frames' head= option).  All three guarded by self._lock.
        self._applied_end = self._push_seq
        self._known_head = self._push_seq
        self._apply_cv = threading.Condition(self._lock)
        self.reads_served = 0
        self.reads_rejected = 0
        self._applier: Optional[threading.Thread] = None
        self._applier_stop = threading.Event()
        if registry is not False:
            from ..telemetry.registry import get_registry

            reg = registry if registry is not None else get_registry()
            labels = {
                "shard": str(self.shard_id),
                "follower": str(self.follower_idx),
            }
            self._c_reads = reg.counter(
                "replication_follower_reads_total",
                component="replication", **labels,
            )
            self._c_rejects = reg.counter(
                "replication_follower_rejects_total",
                component="replication", **labels,
            )
            reg.gauge(
                "replication_apply_lag", component="replication",
                fn=self.apply_lag, **labels,
            )
        else:
            self._c_reads = self._c_rejects = None
        self._start_applier()

    # -- the inbound stream --------------------------------------------------
    def apply_repl(self, record, head=None) -> dict:
        """One shipped WAL record: write-ahead into the follower's own
        log (the ack point), wake the applier, report the durable
        cursor.  Idempotent — a record whose end seq is already logged
        is acked without re-logging (the shipper's resync/fast-path
        race lands here)."""
        with self._lock:
            if self.role != "follower":
                raise NotPrimary(
                    f"shard {self.shard_id} was promoted; the repl "
                    f"stream must re-target"
                )
            # fpsanalyze: allow[B001] write-ahead ordering, same contract as ParamShard.push: the record must be durable in the follower's log (fsync_every=0 → buffered write) before it is acked, and the ack carries the seq assigned under this lock
            appended = self._wal.append(
                record.start_step, record.n_steps, record.payload
            )
            if head is not None:
                self._known_head = max(self._known_head, int(head))
            self._known_head = max(self._known_head, record.end_step)
            if appended:
                self._apply_cv.notify_all()
            return {
                "seg": self._wal.segments_rotated,
                "seq": self._wal.last_step_logged,
                "applied": self._applied_end,
                "appended": appended,
            }

    # -- the applier (asynchronous apply) ------------------------------------
    def _start_applier(self) -> None:
        if self._applier is None or not self._applier.is_alive():
            self._applier_stop.clear()
            self._applier = threading.Thread(
                target=self._apply_loop,
                name=f"repl-apply-{self.shard_id}-f{self.follower_idx}",
                daemon=True,
            )
            self._applier.start()

    def _stop_applier(self) -> None:
        self._applier_stop.set()
        with self._lock:
            self._apply_cv.notify_all()
        if self._applier is not None:
            self._applier.join(timeout=10)
            self._applier = None

    def _apply_loop(self) -> None:
        while not self._applier_stop.is_set():
            with self._lock:
                logged = self._wal.last_step_logged
                behind = (
                    logged is not None and logged > self._applied_end
                )
                if not behind:
                    self._apply_cv.wait(timeout=0.1)
                    continue
            try:
                self._drain_tail()
            except Exception:  # a poisoned record must not kill serving
                self._applier_stop.wait(0.05)

    def _drain_tail(self) -> int:
        """Apply every logged-but-unapplied record, in log order, under
        the shard lock — the same records, the same scatter path, the
        same fp32 order as the primary."""
        with self._lock:
            # fpsanalyze: allow[B001] the replay flush is a buffered-write sync of the follower's OWN log (fsync_every=0) and apply order must be serialized with inbound apply_repl appends under this lock — releasing it mid-drain could interleave a fresh record between two replayed ones
            records = self._wal.replay(self._applied_end)
            n = 0
            for rec in records:
                self._apply_record(rec)
                n += 1
            return n

    # fpsanalyze: allow[S001] _apply_record runs under self._lock at every call site (_drain_tail, ingest — both acquire it); the lock is the caller's
    def _apply_record(self, rec) -> None:
        p = rec.payload
        kind = p.get("kind", "push") if isinstance(p, dict) else "push"
        if kind == "snapshot":
            self._restore_snapshot(p)
        elif kind == "load":
            self._assign(
                np.asarray(p["ids"], np.int64),
                np.asarray(p["values"], np.float32),
            )
        else:
            from ..compression.quantizers import record_deltas

            ids = np.asarray(p["ids"], np.int64)
            # record_deltas: exact f32 records and quantized ones (a
            # q8 leg ships qdeltas+scales — compression/) decode
            # through one seam, so the applier, promotion replay and
            # the verify-against-log audit all see identical rows
            self._apply(ids, record_deltas(p))
            if p.get("pid") is not None:
                self._remember_pairs(p["pid"], ids)
        self._push_seq = rec.end_step
        self._applied_end = rec.end_step

    # -- reads under the staleness contract ----------------------------------
    def apply_lag(self) -> int:
        with self._lock:
            return max(0, self._known_head - self._applied_end)

    def pull(self, global_ids, *, epoch=None):
        with self._lock:
            lag = max(0, self._known_head - self._applied_end)
            fresh = (
                self.role != "follower"
                or self.staleness_bound is None
                or lag <= self.staleness_bound
            )
            if not fresh:
                self.reads_rejected += 1
                if self._c_rejects is not None:
                    self._c_rejects.inc()
                raise FollowerLagging(lag)
            vals = super().pull(global_ids, epoch=epoch)
            self.reads_served += 1
            if self._c_reads is not None:
                self._c_reads.inc()
            return vals

    # -- the write surface is the primary's ----------------------------------
    def push(
        self, global_ids, deltas, *, epoch=None, pid=None, sess=None
    ) -> int:
        if self.role == "follower":
            raise NotPrimary(f"shard {self.shard_id} is a follower")
        return super().push(
            global_ids, deltas, epoch=epoch, pid=pid, sess=sess
        )

    def assign_rows(self, global_ids, values) -> int:
        if self.role == "follower":
            raise NotPrimary(f"shard {self.shard_id} is a follower")
        return super().assign_rows(global_ids, values)

    def lease_rows(self, global_ids, sess, *, epoch=None, ttl=None):
        # a follower cannot grant hot-key leases: invalidations are
        # driven by the write path, which lands on the primary — a
        # grant here would never be revoked (hotcache/, docs/hotcache.md)
        if self.role == "follower":
            raise NotPrimary(f"shard {self.shard_id} is a follower")
        return super().lease_rows(
            global_ids, sess, epoch=epoch, ttl=ttl
        )

    # -- promotion (replication/failover.py) ---------------------------------
    def catch_up(self) -> int:
        """Stop the applier and drain the follower's own WAL tail —
        the O(lag) half of a promotion.  Returns records applied."""
        self._stop_applier()
        return self._drain_tail()

    def ingest(self, records) -> int:
        """Salvage records the dead primary logged but never shipped
        (its on-disk WAL tail past this follower's log head): each is
        write-ahead logged here, then applied — O(tail).  Returns the
        number actually ingested (idempotent by end seq)."""
        with self._lock:
            n = 0
            for rec in records:
                # fpsanalyze: allow[B001] write-ahead ordering (see apply_repl): salvage records must be durable in the promoted log, in order, before the flip publishes this shard as primary
                if self._wal.append(
                    rec.start_step, rec.n_steps, rec.payload
                ):
                    self._apply_record(rec)
                    n += 1
            return n

    def promote_to_primary(self, epoch: int) -> None:
        """The role flip: the shard becomes a write-absorbing primary
        pinned at ``epoch`` (the membership flip's new epoch — the old
        primary is fenced below it by the stale-epoch machinery).  The
        caller must have run :meth:`catch_up` (and :meth:`ingest`)
        first."""
        self._stop_applier()
        with self._lock:
            self.role = "primary"
            self.epoch = int(epoch)
            self._known_head = self._applied_end

    def repl_state(self) -> dict:
        with self._lock:
            logged = self._wal.last_step_logged
            return {
                "shard": self.shard_id,
                "role": self.role,
                "follower": self.follower_idx,
                "seq": self._push_seq,
                "logged": -1 if logged is None else logged,
                "applied": self._applied_end,
                "head": self._known_head,
                "lag": max(0, self._known_head - self._applied_end),
                "bound": self.staleness_bound,
                "epoch": self.epoch,
            }

    def close(self) -> None:
        self._stop_applier()
        super().close()


__all__ = ["ReplicaShard"]
