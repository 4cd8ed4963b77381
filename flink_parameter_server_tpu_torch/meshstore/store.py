"""MeshParamStore — the parameter table as ONE tensor on the device.

Counterpart of ``flink_parameter_server_tpu/meshstore/store.py``.  Where
the socket backend fronts N :class:`~..cluster.shard.ParamShard` slices
with TCP servers, this store holds the WHOLE table as a single tensor on
the device (the card unless the caller asks for the CPU; the reference
row-block shards it over a device mesh; across devices the port's mesh
store is ROADMAP Queue 1 #9) and the batch surface becomes two device ops:

* **pull** — :func:`~..core.store.pull`: clip + row gather.  Duplicate
  ids cost one gathered row each, so the host never dedupes.  The result
  stays on the device — the worker's step consumes it without a host
  copy.
* **push** — :func:`~..core.store.push`: masked scatter-add IN PLACE on
  the table (the reference donates the buffer to the same effect),
  through the store's ``"xla"`` arm: ``ops/rows.accumulate_rows_`` sorts
  the ids stably and sums each run in order on the card, so the same
  inputs give the same bits (``index_add_``'s atomics would not).
  Duplicate-id lanes combine inside the one scatter, which is what keeps
  exactly-once structural here: an in-process push either applies or
  raises; there is no retry path that could double-apply, so the socket
  backend's ``(pid, id)`` dedupe window has nothing to dedupe.

Durability lives at the HOST boundary: with ``wal_dir`` set, every push's
raw ``(ids, deltas, mask)`` — exactly the device op's inputs, copied to
the host — is journaled to an :class:`~..resilience.wal.UpdateWAL`
record BEFORE the scatter runs.  Recovery replays the records through the
same push, so a rebuilt table is bitwise the logged one
(:meth:`MeshParamStore.verify_against_log`).

With ``momentum > 0`` the store keeps a velocity buffer — the optimizer
state of its dense momentum update (``vel = mu * vel + dense; table +=
vel``).  The reference pins that buffer to the table's row-block
sharding (``shard_opt_state_constraint``, ZeRO-1); at one device that
constraint is the identity and is left out until the multi-device port
(ROADMAP Queue 1 #9).  ``momentum=0`` (the cluster driver's setting) is
the plain scatter-add — the socket backend's apply.
"""
from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.transform import to_device, to_host
from ..utils.device import DeviceLike, reject_mesh
from .layout import SHARD_AXIS, StoreLayout, check_alignment, make_store_mesh


def _valid_lanes(ids, mask) -> int:
    """Lanes a push carries: every lane, or the mask's true lanes."""
    if mask is None:
        return int(ids.numel() if isinstance(ids, torch.Tensor) else np.size(ids))
    if isinstance(mask, torch.Tensor):
        return int(mask.to(torch.bool).sum())
    return int(np.asarray(mask).astype(bool).sum())


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else int(t.numel() * t.element_size())


class MeshParamStore:
    """One device table + the host-boundary services around it.

    Thread-safe: one lock serializes device dispatch (pull, push,
    values) — the push updates the table in place, so a pull must never
    interleave with a half-issued push.  Workers' SSP interleaving is
    the :class:`~..cluster.clock.StalenessClock`'s job, not this lock's.
    """

    def __init__(
        self,
        capacity: int,
        value_shape: Sequence[int] = (),
        *,
        init_fn=None,
        mesh=None,
        devices=None,
        partitioner=None,
        wal_dir: Optional[str] = None,
        wal_fsync_every: int = 0,
        momentum: float = 0.0,
        registry=None,
        device: DeviceLike = None,
    ):
        from ..core.store import StoreSpec

        self.capacity = int(capacity)
        self.value_shape = tuple(int(s) for s in value_shape)
        if mesh is not None and not isinstance(mesh, StoreLayout):
            reject_mesh(mesh, "the mesh store over a device mesh")
        self.mesh = (
            mesh if mesh is not None
            else make_store_mesh(devices, device=device)
        )
        if SHARD_AXIS not in self.mesh.axis_names:
            raise ValueError(
                f"mesh axes {self.mesh.axis_names} lack the store axis "
                f"{SHARD_AXIS!r} (build the layout with make_store_mesh)"
            )
        self.device = self.mesh.device
        self.n_devices = int(self.mesh.shape[SHARD_AXIS])
        if partitioner is not None:
            # the alignment rule is a precondition, not a convention:
            # misaligned shard boundaries straddle device blocks and
            # every pull pays a resharding gather
            check_alignment(partitioner, self.capacity, self.n_devices)
        self.partitioner = partitioner
        self.spec = StoreSpec(self.capacity, self.value_shape)
        self.momentum = float(momentum)
        if self.momentum and wal_dir is not None:
            raise ValueError(
                "momentum>0 with a WAL is unsupported: the journal "
                "records plain scatter-add inputs, and replaying them "
                "through a momentum update would not rebuild the table "
                "(verify_against_log must stay bitwise)"
            )
        self._init_fn = init_fn
        self._lock = threading.RLock()
        self._push_seq = 0
        self.pulls_served = 0
        self.pushes_applied = 0
        self.rows_pulled = 0
        self.rows_applied = 0

        self.table = self._create_table()
        self.opt_state = (
            torch.zeros_like(self.table) if self.momentum else None
        )

        self._wal = None
        if wal_dir is not None:
            from ..resilience.wal import UpdateWAL

            self._wal = UpdateWAL(wal_dir, fsync_every=wal_fsync_every)
            if self._wal.last_step_logged is not None:
                self._replay()

        self._register_instruments(registry)

    # -- construction / recovery ------------------------------------------
    def _create_table(self) -> torch.Tensor:
        """Materialise the padded table on the device.

        ``init_fn`` is the per-id deterministic init contract
        (:func:`~..core.store.create_table`); padding rows past
        ``capacity`` are zeroed so the init never sees an
        out-of-domain id — they are addressable but never routed."""
        from ..core.store import create_table

        init_fn = self._init_fn
        capacity = self.capacity
        value_rank = len(self.value_shape)

        def padded_init(ids):
            if init_fn is None:
                return torch.zeros(
                    tuple(ids.shape) + self.value_shape,
                    dtype=torch.float32, device=ids.device,
                )
            rows = torch.as_tensor(
                init_fn(torch.clamp_max(ids, capacity - 1))
            ).to(ids.device, torch.float32)
            live = (ids < capacity).reshape(
                tuple(ids.shape) + (1,) * value_rank
            )
            return torch.where(live, rows, torch.zeros_like(rows))

        return create_table(self.spec, padded_init, device=self.device)

    def _sync(self) -> None:
        """Wait for the device's queued work, so a timer around a
        dispatch times the device op, not its launch."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _scatter(self, table, ids, deltas, mask) -> torch.Tensor:
        """One record through the store's in-place push — construction
        replay, the live push and the audit share this seam, which is
        what makes a rebuilt table bitwise the logged one."""
        from ..core.store import push as device_push

        return device_push(
            self.spec, table,
            to_device(ids, self.device, torch.int64),
            to_device(deltas, self.device, torch.float32),
            None if mask is None else to_device(mask, self.device, torch.bool),
        )

    def _apply(self, ids, deltas, mask) -> None:
        if self.momentum:
            dense = self._scatter(
                torch.zeros_like(self.table), ids, deltas, mask
            )
            self.opt_state = self.momentum * self.opt_state + dense
            self.table.add_(self.opt_state)
        else:
            self._scatter(self.table, ids, deltas, mask)
        self._sync()

    def _replay(self) -> int:
        """Recovery: re-apply every intact WAL record in sequence order
        through the same device scatter the live path uses."""
        n = 0
        for rec in self._wal.replay():
            p = rec.payload
            self._apply(p["ids"], p["deltas"], p.get("mask"))
            self._push_seq = max(self._push_seq, int(rec.end_step))
            self.pushes_applied += 1
            n += 1
        return n

    # -- the batch surface -------------------------------------------------
    def pull(self, ids) -> torch.Tensor:
        """Gather ``table[ids]`` (any leading shape; out-of-range ids
        clip — callers carry a validity mask).  ``ids`` may be a tensor
        on the device or a host array.  Returns the DEVICE tensor: the
        worker's step consumes it directly, so the inner loop never
        copies rows to the host."""
        from ..core.store import pull as device_pull

        ids_t = to_device(ids, self.device, torch.int64)
        n = int(ids_t.numel())
        with self._lock:
            t0 = time.perf_counter()
            out = device_pull(self.spec, self.table, ids_t)
            self._sync()
            dt = time.perf_counter() - t0
            self.pulls_served += 1
            self.rows_pulled += n
            if self._h_gather is not None:
                self._h_gather.observe(dt)
                self._c_pulls.inc()
                self._c_rows_pulled.inc(n)
                self._c_gather_ops.inc()
        return out

    def push(self, ids, deltas, mask=None) -> int:
        """WRITE-AHEAD (when durable) then scatter-add; returns the
        push sequence number after this push.  ``ids``/``deltas``/
        ``mask`` (tensors on the device or host arrays) are the raw
        device-op inputs — journaled as host copies, so replay is
        bitwise (duplicate lanes recombine inside the same scatter)."""
        rows = _valid_lanes(ids, mask)
        with self._lock:
            if self._wal is not None:
                payload = {
                    "ids": to_host(ids),
                    "deltas": to_host(deltas).astype(np.float32, copy=False),
                }
                if mask is not None:
                    payload["mask"] = to_host(mask)
                self._wal.append(self._push_seq, 1, payload)
                if self._c_wal is not None:
                    self._c_wal.inc()
            self._push_seq += 1
            t0 = time.perf_counter()
            self._apply(ids, deltas, mask)
            dt = time.perf_counter() - t0
            self.pushes_applied += 1
            self.rows_applied += rows
            if self._h_scatter is not None:
                self._h_scatter.observe(dt)
                self._c_pushes.inc()
                self._c_rows_pushed.inc(rows)
                self._c_scatter_ops.inc()
            return self._push_seq

    def values(self) -> np.ndarray:
        """The logical table (host copy) — rows ``[0, capacity)`` in
        global-id order; the dump/checkpoint surface, NOT the inner
        loop."""
        with self._lock:
            return to_host(self.table[: self.capacity], copy=True)

    def flush(self) -> dict:
        """Make the journal durable (fsync) — the explicit durability
        point, outside the device lock (the WAL serializes its own
        appends/syncs)."""
        if self._wal is not None:
            self._wal.sync()
        return {"push_seq": self._push_seq, "durable": self._wal is not None}

    # -- audits ------------------------------------------------------------
    def verify_against_log(self) -> bool:
        """Rebuild deterministic-init + journal into a scratch table
        and compare bitwise with the live rows.  Safe under live
        traffic: ``(values, seq)`` are captured atomically and only
        records ``<= seq`` replay."""
        if self._wal is None:
            raise ValueError("verify_against_log needs wal_dir")
        with self._lock:
            live = self.values()
            seq = self._push_seq
        self._wal.sync()
        scratch = self._create_table()
        for rec in self._wal.replay():
            if rec.end_step > seq:
                continue
            p = rec.payload
            self._scatter(scratch, p["ids"], p["deltas"], p.get("mask"))
        rebuilt = to_host(scratch[: self.capacity])
        return bool(np.array_equal(rebuilt, live))

    # -- observability -----------------------------------------------------
    def _register_instruments(self, registry) -> None:
        if registry is False:
            self._h_gather = self._h_scatter = None
            self._c_pulls = self._c_pushes = self._c_wal = None
            self._c_rows_pulled = self._c_rows_pushed = None
            self._c_gather_ops = self._c_scatter_ops = None
            return
        from ..telemetry.registry import get_registry

        reg = registry if registry is not None else get_registry()
        self._h_gather = reg.histogram(
            "meshstore_gather_seconds", component="meshstore"
        )
        self._h_scatter = reg.histogram(
            "meshstore_scatter_seconds", component="meshstore"
        )
        self._c_pulls = reg.counter(
            "meshstore_pulls_total", component="meshstore"
        )
        self._c_pushes = reg.counter(
            "meshstore_pushes_total", component="meshstore"
        )
        self._c_rows_pulled = reg.counter(
            "meshstore_rows_pulled_total", component="meshstore"
        )
        self._c_rows_pushed = reg.counter(
            "meshstore_rows_pushed_total", component="meshstore"
        )
        self._c_wal = reg.counter(
            "meshstore_wal_appends_total", component="meshstore"
        )
        # per-round op ledger: one gather / one scatter per worker
        # round (kind= keeps them on one instrument)
        self._c_gather_ops = reg.counter(
            "meshstore_collective_ops_total", component="meshstore",
            kind="gather",
        )
        self._c_scatter_ops = reg.counter(
            "meshstore_collective_ops_total", component="meshstore",
            kind="scatter",
        )
        reg.gauge(
            "meshstore_table_bytes", component="meshstore",
            fn=lambda: (
                _nbytes(self.table) if self.table is not None else None
            ),
        )
        reg.gauge(
            "meshstore_device_bytes", component="meshstore",
            fn=self._bytes_per_device,
        )
        reg.gauge(
            "meshstore_opt_state_bytes", component="meshstore",
            fn=lambda: _nbytes(self.opt_state),
        )

    def _bytes_per_device(self) -> Optional[int]:
        """The device's resident table (+ optimizer state) bytes: the
        figure capacity planning reads (one device holds it all)."""
        if self.table is None:
            return None
        return _nbytes(self.table) + _nbytes(self.opt_state)

    def stats(self) -> dict:
        with self._lock:
            return {
                "backend": "mesh",
                "devices": self.n_devices,
                "device": str(self.device),
                "rows": self.capacity,
                "padded_rows": int(self.spec.padded_capacity),
                "row_block": int(self.spec.rows_per_shard),
                "pulls": self.pulls_served,
                "pushes": self.pushes_applied,
                "push_seq": self._push_seq,
                "rows_pulled": self.rows_pulled,
                "rows_applied": self.rows_applied,
                "wal_records": (
                    0 if self._wal is None
                    else self._wal.records_appended
                ),
                "table_bytes": _nbytes(self.table),
                "bytes_per_device": self._bytes_per_device(),
                "opt_state_bytes": _nbytes(self.opt_state),
                "momentum": self.momentum,
                "alive": self.table is not None,
            }

    def close(self) -> None:
        if self._wal is not None:
            self._wal.close()
            self._wal = None
        self.table = None
        self.opt_state = None


__all__ = ["MeshParamStore"]
