"""MeshParamStore — the parameter table as ONE table over a device layout.

Counterpart of ``flink_parameter_server_tpu/meshstore/store.py``.  Where
the socket backend fronts N :class:`~..cluster.shard.ParamShard` slices
with TCP servers, this store holds the WHOLE table in one process as the
row blocks of a :class:`~.layout.StoreLayout`: block ``i`` (rows ``[i·R,
(i+1)·R)``) is a tensor on ``devices[i]`` (the reference's one global
array ``NamedSharding(mesh, P("shard"))``; the card unless the caller asks
for the CPU), and the batch surface becomes device ops:

* **pull** — clip, then each block gathers the lanes whose ids it owns
  (:func:`~..core.store.pull` on the block) and the rows land in request
  order on the layout's first device.  Duplicate ids cost one gathered
  row each, so the host never dedupes.  The result stays on the device —
  the worker's step consumes it without a host copy.
* **push** — each lane goes to the block that owns its id (masked lanes
  too, with a zero delta, as the one-block push keeps them), in lane
  order, and the block applies them by :func:`~..core.store.push`: a
  masked scatter-add IN PLACE (the reference donates the buffer to the
  same effect), through the store's ``"xla"`` arm (``ops/rows.
  accumulate_rows_``, the reference's ``device_push``), which sorts the
  ids stably and sums each run in order on the card, so the same inputs
  give the same bits (``index_add_``'s atomics would not).  A block sees
  the same run of lanes for each of its rows as the one-block table
  does, so any block count gives the one-block table's bits.
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
sharding (``shard_opt_state_constraint``, ZeRO-1: the dense server's
owned-slice rule over the store's axis).  Here each block keeps its own
velocity tensor on its device, so each device holds 1/n of the optimizer
state by construction, never a replica.  ``momentum=0`` (the cluster
driver's setting) is the plain scatter-add — the socket backend's apply.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.transform import to_device, to_host
from ..cluster.partition import mesh_row_block
from .layout import SHARD_AXIS, StoreLayout, check_alignment, make_store_mesh


def _valid_lanes(ids, mask) -> int:
    """Lanes a push carries: every lane, or the mask's true lanes."""
    if mask is None:
        return int(ids.numel() if isinstance(ids, torch.Tensor) else np.size(ids))
    if isinstance(mask, torch.Tensor):
        return int(mask.to(torch.bool).sum())
    return int(np.asarray(mask).astype(bool).sum())


def _nbytes(t) -> int:
    """Bytes of a tensor, or of every tensor of a list; 0 for None."""
    if t is None:
        return 0
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    return int(t.numel() * t.element_size())


class MeshParamStore:
    """One table over a device layout + the host-boundary services around it.

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
            raise TypeError(
                f"the mesh store's mesh is a StoreLayout (meshstore.make_store_mesh), "
                f"got {type(mesh).__name__}"
            )
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
        # the whole table's arithmetic (n blocks of R rows) and one block's
        self.block_rows = mesh_row_block(self.capacity, self.n_devices)
        self.spec = StoreSpec(self.block_rows * self.n_devices, self.value_shape)
        self._block_spec = StoreSpec(self.block_rows, self.value_shape)
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

        self.blocks: Optional[List[torch.Tensor]] = self._create_table()
        # ZeRO-1: one velocity tensor a block, on the block's device
        self.opt_state: Optional[List[torch.Tensor]] = (
            [torch.zeros_like(b) for b in self.blocks] if self.momentum else None
        )

        self._wal = None
        if wal_dir is not None:
            from ..resilience.wal import UpdateWAL

            self._wal = UpdateWAL(wal_dir, fsync_every=wal_fsync_every)
            if self._wal.last_step_logged is not None:
                self._replay()

        self._register_instruments(registry)

    @property
    def table(self) -> Optional[torch.Tensor]:
        """The table tensor of a one-block layout (None once closed); a
        layout of several blocks has no one tensor: read :attr:`blocks`."""
        if self.blocks is None:
            return None
        if len(self.blocks) != 1:
            raise AttributeError(f"the table is {len(self.blocks)} row blocks: read .blocks")
        return self.blocks[0]

    # -- construction / recovery ------------------------------------------
    def _create_table(self) -> List[torch.Tensor]:
        """Materialise the padded table's row blocks, each on its device.

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

        R = self.block_rows
        return [
            create_table(self._block_spec, lambda ids, lo=b * R: padded_init(ids + lo), device=dev)
            for b, dev in enumerate(self.mesh.devices)
        ]

    def _sync(self) -> None:
        """Wait for the devices' queued work, so a timer around a
        dispatch times the device ops, not their launch."""
        for dev in dict.fromkeys(self.mesh.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _routes(self, ids: torch.Tensor):
        """``(block, lanes)`` for each of several blocks that some of the
        flat ``ids`` (int64, on the first device) reach: the positions of
        the ids whose rows the block owns, in lane order.  (One block
        takes every lane whole: its push drops the ids past the table.)"""
        R = self.block_rows
        for b in range(self.n_devices):
            lanes = ((ids >= b * R) & (ids < (b + 1) * R)).nonzero().reshape(-1)
            if lanes.numel():
                yield b, lanes

    def _scatter(self, blocks, ids, deltas, mask) -> List[Optional[torch.Tensor]]:
        """One record through the store's in-place push — construction
        replay, the live push and the audit share this seam, which is
        what makes a rebuilt table bitwise the logged one.  Each lane
        goes to the block that owns its id and the block pushes its lanes
        in their order.  Returns the blocks the record reached (None for
        the others)."""
        from ..core.store import push as device_push

        home = self.device
        ids = to_device(ids, home, torch.int64)
        deltas = to_device(deltas, home, torch.float32)
        mask = None if mask is None else to_device(mask, home, torch.bool)
        if self.n_devices == 1:
            return [device_push(self._block_spec, blocks[0], ids, deltas, mask)]
        flat = ids.reshape(-1)
        d = deltas.reshape((-1,) + self.value_shape)
        m = None if mask is None else mask.reshape(-1)
        touched: List[Optional[torch.Tensor]] = [None] * self.n_devices
        for b, lanes in self._routes(flat):
            dev = self.mesh.devices[b]
            touched[b] = device_push(
                self._block_spec, blocks[b],
                (flat[lanes] - b * self.block_rows).to(dev),
                d[lanes].to(dev),
                None if m is None else m[lanes].to(dev),
            )
        return touched

    def _apply(self, ids, deltas, mask) -> None:
        if self.momentum:
            dense = [torch.zeros_like(b) for b in self.blocks]
            self._scatter(dense, ids, deltas, mask)
            for b, block in enumerate(self.blocks):
                self.opt_state[b] = self.momentum * self.opt_state[b] + dense[b]
                block.add_(self.opt_state[b])
        else:
            self._scatter(self.blocks, ids, deltas, mask)
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
        ids_t = to_device(ids, self.device, torch.int64)
        n = int(ids_t.numel())
        with self._lock:
            t0 = time.perf_counter()
            out = self._gather(ids_t)
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

    def _gather(self, ids: torch.Tensor) -> torch.Tensor:
        """``table[ids]`` with ids clipped to the padded table, each block
        gathering the lanes it owns into the answer on the first device."""
        from ..core.store import pull as device_pull

        if self.n_devices == 1:
            return device_pull(self._block_spec, self.blocks[0], ids)
        flat = ids.reshape(-1).clamp(0, self.spec.padded_capacity - 1)
        out = torch.empty((flat.numel(),) + self.value_shape, dtype=torch.float32, device=self.device)
        for b, lanes in self._routes(flat):
            dev = self.mesh.devices[b]
            rows = device_pull(self._block_spec, self.blocks[b], (flat[lanes] - b * self.block_rows).to(dev))
            out[lanes] = rows.to(self.device)
        return out.reshape(tuple(ids.shape) + self.value_shape)

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
            return self._host_rows(self.blocks)

    def _host_rows(self, blocks) -> np.ndarray:
        """Rows ``[0, capacity)`` of ``blocks`` as one host array (a copy)."""
        return np.concatenate([to_host(b, copy=True) for b in blocks])[: self.capacity]

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
        return bool(np.array_equal(self._host_rows(scratch), live))

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
                _nbytes(self.blocks) if self.blocks is not None else None
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
        """The largest block's resident bytes, its velocity included: the
        figure capacity planning reads for each device of the layout (a
        block plays a device; with the row-block layout this is ``(table +
        opt state) / n``)."""
        if self.blocks is None:
            return None
        vel = self.opt_state or [None] * len(self.blocks)
        return max(_nbytes(b) + _nbytes(v) for b, v in zip(self.blocks, vel))

    def stats(self) -> dict:
        with self._lock:
            return {
                "backend": "mesh",
                "devices": self.n_devices,
                "device": str(self.device),
                "block_devices": [str(d) for d in self.mesh.devices],
                "rows": self.capacity,
                "padded_rows": int(self.spec.padded_capacity),
                "row_block": int(self.block_rows),
                "pulls": self.pulls_served,
                "pushes": self.pushes_applied,
                "push_seq": self._push_seq,
                "rows_pulled": self.rows_pulled,
                "rows_applied": self.rows_applied,
                "wal_records": (
                    0 if self._wal is None
                    else self._wal.records_appended
                ),
                "table_bytes": _nbytes(self.blocks),
                "bytes_per_device": self._bytes_per_device(),
                "opt_state_bytes": _nbytes(self.opt_state),
                "momentum": self.momentum,
                "alive": self.blocks is not None,
            }

    def close(self) -> None:
        if self._wal is not None:
            self._wal.close()
            self._wal = None
        self.blocks = None
        self.opt_state = None


__all__ = ["MeshParamStore"]
