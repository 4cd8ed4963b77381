"""The PS loop: the batched step on the card and the host event backend.

Counterpart of ``flink_parameter_server_tpu/core/transform.py``: the
batched half (``make_train_step``, ``make_scan_train_step``,
``transform_batched``, ``TransformResult``), the event backend (the
``_LocalRuntime`` event loop with FIFO queues between worker and server
partitions, reproducing the reference system's per-record callback
semantics, races included when ``input_window`` > 1), and the
``transform`` / ``transform_with_model_load`` overloads that take either.
PyTorch runs eagerly, so the batched step is a plain function; it updates
the table and the worker state in place (the reference's jitted step
donates both buffers), and :func:`transform_batched` copies the caller's
store and state first, so those stay valid.  ``steps_per_call=K`` groups
K microbatches per call, run as a loop (a CUDA graph of the group is
later work).  The event backend is host code, as in the reference; what
its logics compute per record runs where they put their tensors.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import zlib
from typing import Any, Callable, Generic, Iterable, List, Optional, Tuple, TypeVar, Union

import numpy as np
import torch

from .api import ParameterServer, ParameterServerClient, ParameterServerLogic, SimplePSLogic, WorkerLogic
from .batched import BatchedWorkerLogic
from .entities import Pull, PullAnswer, Push, PSToWorker, WorkerToPS
from .senders import SIMPLE, BufferingSender, SenderPolicy
from .store import ShardedParamStore, StoreSpec
from . import store as store_mod
from ..parallel import collectives as _coll
from ..parallel.mesh import DP_AXIS, axis_index, axis_size

WOut = TypeVar("WOut")
PSOut = TypeVar("PSOut")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map ``fn`` over the leaves of nested dicts / lists / tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def to_device(batch: Any, device: torch.device, dtype: Optional[torch.dtype] = None) -> Any:
    """Host batch (numpy arrays or tensors) -> tensors on ``device``
    (cast to ``dtype`` when given).  A read-only array (a frame decoded
    zero-copy) is copied first, since a tensor cannot wrap it."""

    def one(x):
        if isinstance(x, np.ndarray):
            if not x.flags.writeable:
                x = x.copy()
            x = torch.from_numpy(np.ascontiguousarray(x))
        if isinstance(x, torch.Tensor):
            return x.to(device, dtype, non_blocking=True)
        return x

    return tree_map(one, batch)


def to_host(x: Any, *, copy: bool = False) -> np.ndarray:
    """A tensor (copied off the card) or host array as a numpy array.
    ``copy=True`` always returns a fresh array, never a view of a CPU
    tensor or of the array given."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.to("cpu", copy=True) if copy else x.cpu()).numpy()
    return np.array(x, copy=True) if copy else np.asarray(x)


def _clone(x: Any) -> Any:
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, x)


def stable_route_hash(key) -> int:
    """Routing hash for ``hash(paramId) % psParallelism`` that is stable
    across processes (Python's ``hash`` of a string changes with
    PYTHONHASHSEED).  Ints keep their identity, as the reference system's
    ``paramId.hashCode`` does for Scala Ints."""
    if isinstance(key, (int, np.integer)):
        return int(key)
    if isinstance(key, str):
        return zlib.crc32(key.encode("utf-8"))
    if isinstance(key, bytes):
        return zlib.crc32(key)
    return zlib.crc32(repr(key).encode("utf-8"))


@dataclasses.dataclass
class TransformResult(Generic[WOut, PSOut]):
    """The worker and server output streams of a PS job (the reference
    multiplexes them into one ``Either`` stream; :meth:`either` rebuilds
    that view)."""

    worker_outputs: List[Any]
    server_outputs: List[Any]
    store: Optional[ShardedParamStore] = None
    worker_state: Any = None

    def either(self) -> List[Tuple[str, Any]]:
        return [("left", w) for w in self.worker_outputs] + [
            ("right", s) for s in self.server_outputs
        ]


# ---------------------------------------------------------------------------
# Local (event) backend: the reference system's callback semantics on the host.
# ---------------------------------------------------------------------------


class _LocalClient(ParameterServerClient):
    def __init__(self, runtime: "_LocalRuntime", worker_idx: int):
        self._rt = runtime
        self._widx = worker_idx

    def pull(self, param_id: int) -> None:
        self._rt.send_w2ps(self._widx, WorkerToPS(self._widx, Pull(param_id)))

    def push(self, param_id: int, delta) -> None:
        self._rt.send_w2ps(self._widx, WorkerToPS(self._widx, Push(param_id, delta)))

    def output(self, w_out) -> None:
        self._rt.worker_outputs.append(w_out)


class _LocalPSIface(ParameterServer):
    def __init__(self, runtime: "_LocalRuntime", server_idx: int):
        self._rt = runtime
        self._sidx = server_idx

    def answer_pull(self, param_id: int, value, worker_idx: int) -> None:
        self._rt.send_ps2w(self._sidx, PSToWorker(worker_idx, PullAnswer(param_id, value)))

    def output(self, ps_out) -> None:
        self._rt.server_outputs.append(ps_out)


class _LocalRuntime:
    """Single FIFO event loop emulating the Flink iteration.

    Input records are admitted up to ``input_window`` ahead of message
    processing, so pulls and pushes from different workers interleave:
    the reference system's asynchronous hazards (SURVEY.md §3.2),
    reproduced deterministically."""

    def __init__(
        self,
        worker_logics: List[WorkerLogic],
        ps_logics: List[ParameterServerLogic],
        partitioner: Optional[Callable[[Any, int], int]],
        input_window: int,
        client_sender: Optional[SenderPolicy] = None,
        ps_sender: Optional[SenderPolicy] = None,
    ):
        self.workers = worker_logics
        self.servers = ps_logics
        self.partitioner = partitioner
        self.input_window = max(1, input_window)
        self.events: collections.deque = collections.deque()
        self.worker_outputs: List[Any] = []
        self.server_outputs: List[Any] = []
        self.ps_ifaces = [_LocalPSIface(self, s) for s in range(len(self.servers))]
        self.clients = [_LocalClient(self, i) for i in range(len(self.workers))]
        self.tick = 0
        self.client_senders = [BufferingSender(client_sender or SIMPLE) for _ in self.workers]
        self.ps_senders = [BufferingSender(ps_sender or SIMPLE) for _ in self.servers]
        # only interval-triggered senders ever flush from poll(); the
        # default SIMPLE policy leaves this empty
        self._interval_senders = [
            ("w2ps", s) for s in self.client_senders if s.policy.interval is not None
        ] + [("ps2w", s) for s in self.ps_senders if s.policy.interval is not None]

    def send_w2ps(self, worker_idx: int, msg: WorkerToPS) -> None:
        for m in self.client_senders[worker_idx].offer(msg, self.tick):
            self.events.append(("w2ps", m))

    def send_ps2w(self, server_idx: int, msg: PSToWorker) -> None:
        for m in self.ps_senders[server_idx].offer(msg, self.tick):
            self.events.append(("ps2w", m))

    def _poll_senders(self) -> None:
        for tag, s in self._interval_senders:
            for m in s.poll(self.tick):
                self.events.append((tag, m))

    def _force_flush_senders(self) -> bool:
        flushed = False
        for s in self.client_senders:
            for m in s.flush(self.tick):
                self.events.append(("w2ps", m))
                flushed = True
        for s in self.ps_senders:
            for m in s.flush(self.tick):
                self.events.append(("ps2w", m))
                flushed = True
        return flushed

    def _route_server(self, param_id: int) -> int:
        # partitionCustom(hash(paramId) % psParallelism), with a hash
        # that does not depend on PYTHONHASHSEED
        return stable_route_hash(param_id) % len(self.servers)

    def run(self, data: Iterable) -> None:
        it = iter(data)
        rr = itertools.cycle(range(len(self.workers)))
        exhausted = False
        in_window = 0
        while True:
            while not exhausted and in_window < self.input_window:
                try:
                    record = next(it)
                except StopIteration:
                    exhausted = True
                    break
                widx = self.partitioner(record, len(self.workers)) if self.partitioner else next(rr)
                self.events.append(("input", widx, record))
                in_window += 1
            if not self.events:
                if exhausted:
                    # input done and queue drained: flush what combination
                    # senders still hold before concluding
                    if self._force_flush_senders():
                        continue
                    break
                continue
            ev = self.events.popleft()
            self.tick += 1
            if ev[0] == "input":
                _, widx, record = ev
                in_window -= 1
                self.workers[widx].on_recv(record, self.clients[widx])
            elif ev[0] == "w2ps":
                msg: WorkerToPS = ev[1]
                sidx = self._route_server(msg.message.param_id)
                if isinstance(msg.message, Pull):
                    self.servers[sidx].on_pull_recv(
                        msg.message.param_id, msg.worker_partition_index, self.ps_ifaces[sidx]
                    )
                else:
                    self.servers[sidx].on_push_recv(
                        msg.message.param_id, msg.message.delta, self.ps_ifaces[sidx]
                    )
            else:  # ps2w
                msg2: PSToWorker = ev[1]
                w = msg2.worker_partition_index
                self.workers[w].on_pull_recv(msg2.answer.param_id, msg2.answer.value, self.clients[w])
            self._poll_senders()
        # input exhausted and every message delivered: the close hooks (the
        # reference's iterationWaitTime moment, made explicit)
        for w in self.workers:
            w.close()
        for sidx, s in enumerate(self.servers):
            s.close(self.ps_ifaces[sidx])


def _instances(factory_or_instance, n: int, what: str) -> List[Any]:
    if callable(factory_or_instance) and not isinstance(
        factory_or_instance, (WorkerLogic, ParameterServerLogic)
    ):
        return [factory_or_instance() for _ in range(n)]
    if n != 1:
        raise ValueError(
            f"{what} parallelism {n} > 1 requires a zero-arg factory, got an "
            f"instance (stateful logics cannot be shared across partitions)"
        )
    return [factory_or_instance]


def _per_record_map(logic: BatchedWorkerLogic, batch: Any, n: int, fn: Callable) -> Any:
    """``fn`` applied to the batch's per-record leaves: those
    ``logic.per_record_leaves`` marks (checked against the record count
    ``n``), else every leaf whose leading dim is ``n``."""
    marks = logic.per_record_leaves(batch)
    if marks is None:
        return tree_map(
            lambda x: fn(x) if getattr(x, "ndim", 0) >= 1 and x.shape[0] == n else x, batch
        )

    def marked(x, m):
        if not m:
            return x
        if getattr(x, "ndim", 0) < 1 or x.shape[0] != n:
            raise ValueError(
                f"per_record_leaves declared a leaf of shape "
                f"{tuple(getattr(x, 'shape', ()))} per-record, but "
                f"the batch has {n} records"
            )
        return fn(x)

    return tree_map(marked, batch, marks)


def _per_record_outputs(logic: BatchedWorkerLogic, out: Any, n: int, fn: Callable) -> Any:
    """``fn`` applied to the per-record leaves of a step's output: those
    ``logic.per_record_outputs`` marks (checked against the record count
    ``n``), else every tensor leaf whose leading dim is ``n``."""
    marks = logic.per_record_outputs(out)
    if marks is None:
        return tree_map(
            lambda x: fn(x) if isinstance(x, torch.Tensor) and x.ndim >= 1 and x.shape[0] == n else x, out
        )

    def marked(x, m):
        if not m:
            return x
        if not isinstance(x, torch.Tensor) or x.ndim < 1 or x.shape[0] != n:
            raise ValueError(
                f"per_record_outputs declared an output leaf of shape "
                f"{tuple(getattr(x, 'shape', ()))} per-record, but the step "
                f"had {n} records"
            )
        return fn(x)

    return tree_map(marked, out, marks)


def _stateless(state: Any) -> bool:
    return not any(isinstance(x, torch.Tensor) for x in tree_leaves(state))


def make_train_step(
    logic: BatchedWorkerLogic,
    spec: StoreSpec,
    *,
    presort: bool = False,
    dp_axis: str = DP_AXIS,
    gather_outputs: bool = True,
) -> Callable:
    """``step(table, state, batch) -> (table, state, out)``: pull, worker
    step, push, with ``table`` and ``state`` updated in place.

    ``presort=True`` reorders the microbatch by the ROUTED store key
    (negative ids last, where push's sentinel sends them) before the pull,
    and hands push an ``ids_sorted`` promise when the logic pushes the very
    ids it pulled.  Worker outputs then come back in sorted order.  Which
    leaves are per record: those ``logic.per_record_leaves`` marks (checked
    against the record count), else every leaf whose leading dim is the
    key count.

    On the store's mesh (``spec.mesh``) every rank passes the same global
    microbatch, as the reference's jit-compiled step does.  With a ``dp``
    axis of size D the (presorted) batch splits into D contiguous slices:
    this rank pulls and steps its slice, and the slices' push requests are
    all-gathered over ``dp`` in dp order (the global lane order, so a
    presorted batch stays sorted) and pushed.  With ``gather_outputs``
    the per-record outputs are all-gathered likewise, so every rank gets
    the whole batch's: the leaves ``logic.per_record_outputs`` marks
    (checked against the slice's record count), else every leaf whose
    leading dim is that count; other leaves stay the slice's own.  Without
    it each rank keeps its slice's outputs.  The record count must divide
    by D.  Worker state must be replicated and kept in step by the logic
    (``OnlineMatrixFactorization(mesh=)``), or the logic stateless."""
    mesh = spec.mesh
    dp = axis_size(mesh, dp_axis)

    def step(table, state, batch):
        if presort or dp > 1:
            ids_pre = logic.keys(batch)
            n = ids_pre.shape[0]
        if presort:
            if ids_pre.ndim != 1:
                raise ValueError(
                    f"presort=True needs 1-D store keys, got shape "
                    f"{tuple(ids_pre.shape)} (multi-pull logics are not presortable)"
                )
            ids0 = ids_pre.to(torch.int64)
            routed = torch.where(ids0 < 0, spec.padded_capacity, ids0)
            order = torch.argsort(routed, stable=True)
            declared = logic.per_record_leaves(batch) is not None
            batch = _per_record_map(logic, batch, n, lambda x: x[order])
            if declared and logic.keys(batch) is ids_pre:
                raise ValueError(
                    "per_record_leaves did not mark the leaf that "
                    "logic.keys(batch) returns — the sort keys themselves "
                    "must be declared per-record for presort=True"
                )
        if dp > 1:
            if n % dp:
                raise ValueError(f"a microbatch of {n} records does not split over dp={dp}")
            per = n // dp
            lo = axis_index(mesh, dp_axis) * per
            batch = _per_record_map(logic, batch, n, lambda x: x[lo:lo + per])
        ids = logic.keys(batch)
        pulled = store_mod.pull(spec, table, ids)
        state, req, out = logic.step(state, batch, pulled)
        # the sorted promise holds only if the logic pushes the ids it pulled
        sorted_ids = presort and (req.ids is ids)
        r_ids, r_deltas, r_mask = req.ids, req.deltas, req.mask
        if dp > 1:
            r_ids = _coll.all_gather_cat(r_ids, mesh, dp_axis)
            r_deltas = _coll.all_gather_cat(r_deltas, mesh, dp_axis)
            if r_mask is not None:
                r_mask = _coll.all_gather_cat(r_mask, mesh, dp_axis)
            if gather_outputs:
                out = _per_record_outputs(logic, out, per, lambda x: _coll.all_gather_cat(x, mesh, dp_axis))
        table = store_mod.push(spec, table, r_ids, r_deltas, r_mask, ids_sorted=sorted_ids)
        return table, state, out

    return step


def make_scan_train_step(
    logic: BatchedWorkerLogic, spec: StoreSpec, *, presort: bool = False, dp_axis: str = DP_AXIS,
    gather_outputs: bool = True,
) -> Callable:
    """K train steps per call: ``batches`` holds (K, batch, ...) leaves;
    returns (K, ...)-stacked outputs."""
    base = make_train_step(logic, spec, presort=presort, dp_axis=dp_axis, gather_outputs=gather_outputs)

    def step(table, state, batches):
        k = next(x for x in tree_leaves(batches) if isinstance(x, torch.Tensor)).shape[0]
        outs = []
        for i in range(k):
            table, state, out = base(table, state, tree_map(lambda x: x[i], batches))
            outs.append(out)
        return table, state, tree_map(lambda *xs: torch.stack(xs), *outs)

    return step


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of nested dicts / lists / tuples, in :func:`tree_map`'s
    order."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def stack_group(group: List[Any]) -> Any:
    """Stack K host microbatches into (K, ...) leaves."""
    return tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *group)


def transform_batched(
    data: Iterable,
    worker_logic: BatchedWorkerLogic,
    store: ShardedParamStore,
    *,
    rng: Optional[torch.Generator] = None,
    mesh: Optional[Any] = None,
    dp_axis: str = DP_AXIS,
    collect_outputs: bool = True,
    dump_model: bool = True,
    on_step: Optional[Callable[[int, Any], None]] = None,
    state_callback: Optional[Callable[[int, Any, Any, Any], None]] = None,
    group_callback: Optional[Callable[[int, int, Any, Any, Any], None]] = None,
    initial_state: Any = None,
    skip_batches: int = 0,
    presort: bool = False,
    steps_per_call: int = 1,
) -> TransformResult:
    """Run the PS loop over an iterable of microbatches, on the device of
    ``store.table``.

    ``on_step(step_idx, out)`` sees each microbatch's output;
    ``state_callback(step_idx, table, state, out)`` also the live table and
    state (``steps_per_call=1`` only); ``group_callback(first_idx, n_steps,
    table, state, outs)`` fires once per call with the raw output (stacked
    when ``n_steps > 1``).  ``skip_batches`` fast-forwards the iterator;
    ``initial_state`` replaces ``worker_logic.init_state`` (it is copied).
    ``steps_per_call=K`` runs K microbatches per call; a trailing group
    shorter than K runs one step at a time.

    ``mesh`` (default ``store.spec.mesh``; the store must be built on the
    same mesh) runs the loop on every rank of a ``dp × ps`` mesh, each
    rank reading the same stream: the step splits each microbatch over
    ``dp`` (:func:`make_train_step`) and every rank gets the whole
    batch's outputs (gathered only when ``collect_outputs`` or a callback
    reads them).  A logic with worker state or ``dedup_scale`` must look
    across the ``dp`` slices itself (it is built with ``mesh=``)."""
    spec = store.spec
    if mesh is None:
        mesh = spec.mesh
    elif mesh != spec.mesh:
        raise ValueError("transform_batched: build the store on the same mesh (ShardedParamStore.create(mesh=))")
    if axis_size(mesh, dp_axis) > 1 and getattr(worker_logic, "mesh", None) != mesh:
        # a dp slice sees only its own lanes: worker state and batch-wide
        # duplicate counts need the logic to look across the slices itself
        if not _stateless(worker_logic.init_state(rng)) or getattr(worker_logic, "dedup_scale", False):
            raise ValueError(
                f"a {type(worker_logic).__name__} with worker state or dedup_scale "
                f"splits over dp={axis_size(mesh, dp_axis)} only when it looks "
                f"across the dp slices itself: build it with mesh="
            )
    device = store.table.device
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call={steps_per_call}: must be >= 1")
    if steps_per_call > 1 and state_callback is not None:
        raise ValueError(
            "steps_per_call > 1 cannot surface the live table between "
            "steps; use steps_per_call=1 with state_callback"
        )
    # a dp split gathers the slices' outputs only for a reader of them
    gather = collect_outputs or any(f is not None for f in (on_step, state_callback, group_callback))
    step = make_train_step(worker_logic, spec, presort=presort, dp_axis=dp_axis, gather_outputs=gather)
    scan_step = make_scan_train_step(worker_logic, spec, presort=presort, dp_axis=dp_axis,
                                     gather_outputs=gather)
    state = _clone(initial_state) if initial_state is not None else worker_logic.init_state(rng)
    table = store.table.clone()
    worker_outputs: List[Any] = []

    def run_one(table, state, batch, step_idx):
        table, state, out = step(table, state, to_device(batch, device))
        if on_step is not None:
            on_step(step_idx, out)
        if state_callback is not None:
            state_callback(step_idx, table, state, out)
        if group_callback is not None:
            group_callback(step_idx, 1, table, state, out)
        if collect_outputs:
            worker_outputs.append(out)
        return table, state

    def run_group(table, state, group, first_idx):
        table, state, outs = scan_step(table, state, to_device(stack_group(group), device))
        if on_step is not None or collect_outputs:
            for i in range(len(group)):
                out_i = tree_map(lambda x: x[i], outs)
                if on_step is not None:
                    on_step(first_idx + i, out_i)
                if collect_outputs:
                    worker_outputs.append(out_i)
        if group_callback is not None:
            group_callback(first_idx, len(group), table, state, outs)
        return table, state

    step_idx = 0
    group: List[Any] = []
    for batch in data:
        if skip_batches > 0:
            skip_batches -= 1
            step_idx += 1
            continue
        if steps_per_call == 1:
            table, state = run_one(table, state, batch, step_idx)
            step_idx += 1
            continue
        group.append(batch)
        if len(group) == steps_per_call:
            table, state = run_group(table, state, group, step_idx)
            step_idx += len(group)
            group = []
    for batch in group:
        table, state = run_one(table, state, batch, step_idx)
        step_idx += 1

    final_store = ShardedParamStore(spec, table)
    server_outputs: List[Any] = []
    if dump_model:
        # close()-time model flush: the final table (bfloat16 widened, as
        # numpy has no bfloat16)
        vals = final_store.values()
        if vals.dtype == torch.bfloat16:
            vals = vals.to(torch.float32)
        server_outputs.append((np.arange(spec.capacity), vals.cpu().numpy()))
    finish = worker_logic.finish(state)
    if finish is not None:
        worker_outputs.append(finish)
    return TransformResult(
        worker_outputs=worker_outputs,
        server_outputs=server_outputs,
        store=final_store,
        worker_state=state,
    )


# ---------------------------------------------------------------------------
# The public overload family.
# ---------------------------------------------------------------------------

def transform(
    data: Iterable,
    worker_logic: Union[WorkerLogic, Callable[[], WorkerLogic], BatchedWorkerLogic],
    ps_logic: Union[ParameterServerLogic, Callable[[], ParameterServerLogic], ShardedParamStore, None] = None,
    *,
    param_init: Optional[Callable[[int], Any]] = None,
    param_update: Optional[Callable[[Any, Any], Any]] = None,
    worker_parallelism: int = 1,
    ps_parallelism: int = 1,
    iteration_wait_time: Optional[float] = None,  # accepted for parity; unused
    partitioner: Optional[Callable[[Any, int], int]] = None,
    input_window: Optional[int] = None,
    client_sender: Optional[SenderPolicy] = None,
    ps_sender: Optional[SenderPolicy] = None,
    **batched_kwargs,
) -> TransformResult:
    """Wire ``data`` + worker logic + server into a PS job (the reference's
    ``FlinkParameterServer.transform`` overloads):

    * ``transform(data, worker, param_init=f, param_update=g, ...)``: the
      simple keyed-store server (``SimplePSLogic``);
    * ``transform(data, worker, ps_logic, ...)``: custom server logic;
    * ``transform(batches, batched_worker, sharded_store, **kw)``:
      :func:`transform_batched`, on the store's device.

    Worker and server logics are instances or zero-argument factories (a
    factory is needed for a parallelism above 1).  ``iteration_wait_time``
    is accepted and ignored: the job ends when the input is exhausted and
    every message is delivered.  ``client_sender`` / ``ps_sender``
    (combination batching) apply to the event backend only; the batched
    path ignores them, as the reference does."""
    if isinstance(worker_logic, BatchedWorkerLogic):
        if not isinstance(ps_logic, ShardedParamStore):
            raise TypeError("batched worker logic requires a ShardedParamStore server")
        return transform_batched(data, worker_logic, ps_logic, **batched_kwargs)
    if ps_logic is None:
        if param_init is None or param_update is None:
            raise TypeError("provide either ps_logic or (param_init, param_update)")
        ps_logic = lambda: SimplePSLogic(param_init, param_update)  # noqa: E731
    workers = _instances(worker_logic, worker_parallelism, "worker")
    servers = _instances(ps_logic, ps_parallelism, "ps")
    runtime = _LocalRuntime(
        workers,
        servers,
        partitioner,
        input_window if input_window is not None else worker_parallelism,
        client_sender=client_sender,
        ps_sender=ps_sender,
    )
    runtime.run(data)
    return TransformResult(worker_outputs=runtime.worker_outputs, server_outputs=runtime.server_outputs)


def _host_row(value: Any) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    return torch.as_tensor(np.asarray(value))


def transform_with_model_load(
    model: Iterable[Tuple[int, Any]],
    data: Iterable,
    worker_logic: Any,
    ps_logic: Union[ShardedParamStore, Any, None] = None,
    **kwargs,
) -> TransformResult:
    """Seed the server from an initial ``(id, value)`` stream before
    training — the reference's ``transformWithModelLoad`` overload.

    With a ``ShardedParamStore`` the values are SET into a copy of its
    table (negative ids wrap once, ids past the end are dropped), as the
    reference's ``table.at[ids].set`` does.  That set addresses the
    PHYSICAL table, so a packed-layout store raises where the reference
    raises: the (n, row) values do not broadcast to its (n, 128) rows.
    Seed a packed store with ``ShardedParamStore.from_values`` instead.

    On the event path (server logic, a factory of one, or ``param_init``
    / ``param_update`` in ``kwargs``) the model stream is delivered
    before the training data: a ``SimplePSLogic`` server has each value
    SET, any other server receives it through ``on_push_recv``."""
    model = list(model)
    if not isinstance(ps_logic, ShardedParamStore):
        return _event_model_load(model, data, worker_logic, ps_logic, kwargs)
    table = ps_logic.table.clone()
    ids = torch.tensor([int(i) for i, _ in model], dtype=torch.int64, device=table.device)
    vals = torch.stack([_host_row(v) for _, v in model]).to(table.device, table.dtype)
    dst = (ids.shape[0],) + tuple(table.shape[1:])
    src = tuple(vals.shape)
    if len(src) > len(dst) or any(a not in (1, b) for a, b in zip(src[::-1], dst[::-1])):
        raise ValueError(f"Incompatible shapes for broadcasting: {src} and requested shape {dst}")
    rows = table.shape[0]
    ids = torch.where(ids < 0, ids + rows, ids)
    keep = (ids >= 0) & (ids < rows)
    table[ids[keep]] = vals.expand(dst)[keep]
    return transform(data, worker_logic, ShardedParamStore(ps_logic.spec, table), **kwargs)


class _SeedIface(ParameterServer):
    """The server interface of the model-load phase: seeds never pull."""

    def __init__(self):
        self.outs: List[Any] = []

    def answer_pull(self, *args) -> None:
        raise RuntimeError("the model-load phase must not answer pulls")

    def output(self, ps_out) -> None:
        self.outs.append(ps_out)


def _event_model_load(model, data, worker_logic, ps_logic, kwargs) -> TransformResult:
    kwargs = dict(kwargs)
    if ps_logic is None:
        param_init = kwargs.pop("param_init", None)
        param_update = kwargs.pop("param_update", None)
        if param_init is None or param_update is None:
            raise TypeError("provide either ps_logic or (param_init, param_update)")
        ps_logic = lambda: SimplePSLogic(param_init, param_update)  # noqa: E731
    ps_par = kwargs.get("ps_parallelism", 1)
    servers = _instances(ps_logic, ps_par, "ps")
    for pid, value in model:
        target = servers[stable_route_hash(pid) % ps_par]
        if isinstance(target, SimplePSLogic):
            target.store[pid] = value  # a model load SETS the value
        else:
            target.on_push_recv(pid, value, _SeedIface())
    seeded = iter(servers)
    kwargs["ps_parallelism"] = ps_par
    return transform(data, worker_logic, lambda: next(seeded), **kwargs)


__all__ = [
    "TransformResult",
    "transform",
    "transform_with_model_load",
    "transform_batched",
    "make_train_step",
    "make_scan_train_step",
    "tree_map",
    "tree_leaves",
    "to_device",
    "stable_route_hash",
]
