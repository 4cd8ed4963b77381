"""Hybrid backend: reference-style event callbacks + the device store.

Counterpart of ``flink_parameter_server_tpu/core/hybrid.py``.  The
migration middle path between the two programming models:

  * the **event API** (``core.api.WorkerLogic``) runs arbitrary Python per
    record but keeps parameters in host HashMaps,
  * the **batched API** runs everything as tensor programs but requires
    rewriting the logic as pure functions.

``transform_hybrid`` runs an *unmodified* ``WorkerLogic`` against a
:class:`~.store.ShardedParamStore`: per chunk of records it collects every
``pull`` the callbacks issue, answers them all with ONE gather from the
store, dispatches the answers back into ``on_pull_recv``, and folds every
``push`` with ONE scatter-add through the store's ``scatter_impl`` (with
``"pallas"`` on the card: one launch of the sorted scatter-add kernel a
chunk; on the CPU its plain version).  Python still executes the
per-record math, but the parameter plane becomes two store operations per
chunk, and the model lives in device memory.  A pulled value reaches the
callback as a row of the gathered tensor, on the store's device; a pushed
delta may be a tensor (on any device) or an array.  Value-shape note:
logics must push deltas matching the store's ``value_shape``.

Staleness semantics: pulls within a chunk observe the store as of the
chunk start; pushes land at chunk end (bounded staleness of one chunk —
between the reference's unbounded races and the batched backend's one
microbatch).

Custom (non-"add") store ``update`` functions: duplicate-id pushes
within one chunk are summed BEFORE ``update`` applies once per id
(:class:`~.store.StoreSpec` semantics) — the event backend applies
``update`` per push instead, so non-commutative updates diverge between
the two backends for intra-chunk duplicates.  Use ``chunk_size=1`` for
exact per-push semantics.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from .api import ParameterServerClient, WorkerLogic
from .store import ShardedParamStore
from .transform import TransformResult, _instances


class _HybridClient(ParameterServerClient):
    """Buffers the callbacks' pull/push traffic for chunk-level batching."""

    def __init__(self):
        self.pull_requests: List[int] = []
        self.push_ids: List[int] = []
        self.push_deltas: List[Any] = []
        self.outputs: List[Any] = []

    def pull(self, param_id: int) -> None:
        self.pull_requests.append(param_id)

    def push(self, param_id: int, delta) -> None:
        self.push_ids.append(param_id)
        self.push_deltas.append(delta)

    def output(self, w_out) -> None:
        self.outputs.append(w_out)


def _stack_deltas(deltas: List[Any], device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The chunk's pushed deltas as one ``(n, *value_shape)`` tensor on the
    store's device: tensors are stacked where they lie and moved once,
    arrays and scalars go over in one host copy."""
    if all(isinstance(d, torch.Tensor) for d in deltas):
        return torch.stack([d.to(device, dtype) for d in deltas])
    host = np.stack([d.detach().cpu().numpy() if isinstance(d, torch.Tensor) else np.asarray(d)
                     for d in deltas])
    return torch.from_numpy(host).to(device, dtype)


def transform_hybrid(
    data: Iterable,
    worker_logic: Union[WorkerLogic, Callable[[], WorkerLogic]],
    store: ShardedParamStore,
    *,
    chunk_size: int = 1024,
    worker_parallelism: int = 1,
    partitioner: Optional[Callable[[Any, int], int]] = None,
    dump_model: bool = True,
) -> TransformResult:
    """Run an event-API worker logic against a store on its device (the
    store's table decides: the card, or the CPU for a CPU store).

    Per chunk: deliver records (``on_recv``) buffering pulls → one
    ``store.pull`` for all unique ids → deliver answers
    (``on_pull_recv``), buffering any follow-up pulls/pushes (follow-up
    pulls are answered from the same chunk snapshot) → one
    ``store.push`` of all buffered deltas.
    """
    workers = _instances(worker_logic, worker_parallelism, "worker")
    clients = [_HybridClient() for _ in workers]
    worker_outputs: List[Any] = []
    device = store.table.device
    rr = itertools.cycle(range(len(workers)))

    def check_ids(ids, what: str) -> None:
        # unlike the event backend (arbitrary hashable keys), the device
        # store is integer-indexed: fail loudly instead of crashing deep
        # inside an index op (non-int) or silently clipping/dropping (OOB)
        for pid in ids:
            if not isinstance(pid, (int, np.integer)):
                raise TypeError(
                    f"transform_hybrid requires integer param ids; "
                    f"{what} got {pid!r} — remap keys to ints for the "
                    f"device store"
                )
            if not 0 <= pid < store.spec.capacity:
                raise ValueError(
                    f"{what} id {pid} out of range for store capacity "
                    f"{store.spec.capacity}"
                )

    def flush_chunk(records: List[Tuple[int, Any]]) -> None:
        nonlocal store
        # 1. deliver records; callbacks buffer pulls/pushes
        for widx, record in records:
            workers[widx].on_recv(record, clients[widx])
        # 2. answer ALL buffered pulls — deduped, one snapshot gather per
        # round; follow-up pulls issued inside on_pull_recv are answered
        # against the same snapshot until none remain
        snapshot = store
        while any(c.pull_requests for c in clients):
            requests = [(w, pid) for w, c in enumerate(clients) for pid in c.pull_requests]
            for c in clients:
                c.pull_requests = []
            check_ids([pid for _w, pid in requests], "pull")
            unique, inverse = np.unique(
                np.asarray([pid for _w, pid in requests], np.int64), return_inverse=True,
            )
            values = snapshot.pull(torch.from_numpy(unique).to(device))
            for (widx, pid), uidx in zip(requests, inverse.reshape(-1).tolist()):
                workers[widx].on_pull_recv(pid, values[uidx], clients[widx])
        # 3. one scatter-add for every buffered push
        all_ids = [pid for c in clients for pid in c.push_ids]
        check_ids(all_ids, "push")
        if all_ids:
            deltas = _stack_deltas([d for c in clients for d in c.push_deltas], device, store.spec.dtype)
            store = store.push(torch.tensor(all_ids, dtype=torch.int64, device=device), deltas)
        for c in clients:
            c.push_ids, c.push_deltas = [], []
            worker_outputs.extend(c.outputs)
            c.outputs = []

    chunk: List[Tuple[int, Any]] = []
    for record in data:
        widx = partitioner(record, len(workers)) if partitioner else next(rr)
        chunk.append((widx, record))
        if len(chunk) >= chunk_size:
            flush_chunk(chunk)
            chunk = []
    if chunk:
        flush_chunk(chunk)

    for w in workers:
        w.close()

    server_outputs: List[Any] = []
    if dump_model:
        server_outputs.append(
            (np.arange(store.spec.capacity), store.values().detach().cpu().numpy())
        )
    return TransformResult(
        worker_outputs=worker_outputs,
        server_outputs=server_outputs,
        store=store,
    )


__all__ = ["transform_hybrid"]
