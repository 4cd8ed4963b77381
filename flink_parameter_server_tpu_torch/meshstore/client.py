"""MeshClient — the worker's handle on the mesh store.

Counterpart of ``flink_parameter_server_tpu/meshstore/client.py``: a
drop-in for :class:`~..cluster.client.ClusterClient`'s batch surface
(`pull_batch` / `push_batch` / `flush` / `shard_stats`) plus the
:class:`~..core.api.ParameterServerClient` event API, with every wire
concern deleted rather than reimplemented: no socket, no frame, no
host-side coalescing — the device gather serves duplicate ids itself
and the device scatter sums duplicates, so the client is a thin
accounting shim over :class:`~.store.MeshParamStore`.

Contract deltas vs the socket client, all documented because tests pin
them:

* ``pull_batch`` returns the DEVICE tensor rather than a host
  ``np.ndarray`` — the driver feeds it straight into the step (moving
  it to the step's device is a no-op), which is exactly the "no host
  copy in the inner loop" contract.  ``.cpu().numpy()`` on the result
  gives a host copy where one is genuinely wanted (dumps, asserts).
* ``push_batch`` takes tensors on the device or host arrays and returns
  the count of VALID LANES pushed (duplicates included): the device
  scatter combines duplicates itself, so the socket client's host-side
  unique count does not exist here.
* there is nothing to retry or cache: an in-process push either
  applies or raises, and every read is a device-fresh gather.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.api import ParameterServerClient
from ..core.transform import to_host
from .store import MeshParamStore, _valid_lanes


class MeshClient(ParameterServerClient):
    def __init__(
        self,
        store: MeshParamStore,
        *,
        worker: Optional[str] = None,
    ):
        self.store = store
        self.worker = worker
        self.hotcache = None  # never cached: reads are device-fresh
        self.outputs: list = []
        self.pulls_coalesced = 0  # structural: the gather dedupes
        self.pushes_coalesced = 0  # structural: the scatter combines
        self.rows_pushed = 0
        self._pending_pulls: list = []
        self._pending_pushes: list = []

    # -- batched surface (what the cluster driver drives) -------------------
    def pull_batch(self, ids, mask=None, *, dtype=np.float32):
        """Gather rows for every lane of ``ids`` (any shape).  ``mask``
        is accepted for signature parity but not needed: masked lanes'
        ids still gather (clipped), and the step's mask zeroes their
        contribution — the same indifference the socket path's
        fill-id lanes already rely on."""
        return self.store.pull(ids)

    def push_batch(self, ids, deltas, mask=None) -> int:
        rows = _valid_lanes(ids, mask)
        self.store.push(ids, deltas, mask)
        self.rows_pushed += rows
        return rows

    def flush(self) -> dict:
        return self.store.flush()

    def shard_stats(self) -> list:
        return [self.store.stats()]

    # -- event API (ParameterServerClient ABC) ------------------------------
    def pull(self, param_id: int) -> None:
        """Buffer a pull; answers arrive at the next :meth:`drain` —
        the asynchronous contract of the ABC."""
        self._pending_pulls.append(int(param_id))

    def push(self, param_id: int, delta) -> None:
        self._pending_pushes.append((int(param_id), to_host(delta)))

    def output(self, w_out) -> None:
        self.outputs.append(w_out)

    def drain(self, on_pull_recv=None) -> int:
        """Flush buffered pushes and answer buffered pulls, in
        buffering order; returns the number of answers delivered."""
        if self._pending_pushes:
            ids = np.asarray(
                [i for i, _ in self._pending_pushes], np.int64
            )
            deltas = np.stack([d for _, d in self._pending_pushes])
            self._pending_pushes = []
            self.push_batch(ids, deltas)
        n = 0
        if self._pending_pulls:
            ids = np.asarray(self._pending_pulls, np.int64)
            self._pending_pulls = []
            values = to_host(self.pull_batch(ids))
            for i, pid in enumerate(ids):
                if on_pull_recv is not None:
                    on_pull_recv(int(pid), values[i], self)
                n += 1
        return n

    def close(self) -> None:
        """Nothing to tear down — the store's lifecycle belongs to the
        driver that built it."""


__all__ = ["MeshClient"]
