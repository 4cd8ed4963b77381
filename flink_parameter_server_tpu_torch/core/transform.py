"""The batched PS loop: pull -> worker step -> push, once per microbatch.

Counterpart of the batched half of ``flink_parameter_server_tpu/core/
transform.py`` (``make_train_step``, ``make_scan_train_step``,
``transform_batched``, ``TransformResult``) and the batched overloads of
``transform`` and ``transform_with_model_load``; their event-API
overloads raise until the event backend is ported (ROADMAP Queue 1 #5).
PyTorch runs eagerly, so the step is a plain function; it updates the
table and the worker state in place (the reference's jitted step donates
both buffers), and :func:`transform_batched` copies the caller's store and
state first, so those stay valid.  ``steps_per_call=K`` groups K
microbatches per call, run as a loop (a CUDA graph of the group is later
work).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Generic, Iterable, List, Optional, Tuple, TypeVar, Union

import numpy as np
import torch

from .batched import BatchedWorkerLogic
from .store import ShardedParamStore, StoreSpec
from . import store as store_mod
from ..utils.device import check_mesh

WOut = TypeVar("WOut")
PSOut = TypeVar("PSOut")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map ``fn`` over the leaves of nested dicts / lists / tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def to_device(batch: Any, device: torch.device) -> Any:
    """Host batch (numpy arrays or tensors) -> tensors on ``device``."""

    def one(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if isinstance(x, torch.Tensor):
            return x.to(device, non_blocking=True)
        return x

    return tree_map(one, batch)


def _clone(x: Any) -> Any:
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, x)


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


def make_train_step(
    logic: BatchedWorkerLogic, spec: StoreSpec, *, presort: bool = False
) -> Callable:
    """``step(table, state, batch) -> (table, state, out)``: pull, worker
    step, push, with ``table`` and ``state`` updated in place.

    ``presort=True`` reorders the microbatch by the ROUTED store key
    (negative ids last, where push's sentinel sends them) before the pull,
    and hands push an ``ids_sorted`` promise when the logic pushes the very
    ids it pulled.  Worker outputs then come back in sorted order.  Which
    leaves are per record: those ``logic.per_record_leaves`` marks (checked
    against the record count), else every leaf whose leading dim is the
    key count."""

    def step(table, state, batch):
        if presort:
            ids_pre = logic.keys(batch)
            if ids_pre.ndim != 1:
                raise ValueError(
                    f"presort=True needs 1-D store keys, got shape "
                    f"{tuple(ids_pre.shape)} (multi-pull logics are not presortable)"
                )
            ids0 = ids_pre.to(torch.int64)
            routed = torch.where(ids0 < 0, spec.padded_capacity, ids0)
            order = torch.argsort(routed, stable=True)
            n = ids0.shape[0]
            marks = logic.per_record_leaves(batch)
            if marks is not None:

                def permute_marked(x, m):
                    if not m:
                        return x
                    if getattr(x, "ndim", 0) < 1 or x.shape[0] != n:
                        raise ValueError(
                            f"per_record_leaves declared a leaf of shape "
                            f"{tuple(getattr(x, 'shape', ()))} per-record, but "
                            f"the batch has {n} records"
                        )
                    return x[order]

                batch = tree_map(permute_marked, batch, marks)
                if logic.keys(batch) is ids_pre:
                    raise ValueError(
                        "per_record_leaves did not mark the leaf that "
                        "logic.keys(batch) returns — the sort keys themselves "
                        "must be declared per-record for presort=True"
                    )
            else:
                batch = tree_map(
                    lambda x: x[order]
                    if getattr(x, "ndim", 0) >= 1 and x.shape[0] == n
                    else x,
                    batch,
                )
        ids = logic.keys(batch)
        pulled = store_mod.pull(spec, table, ids)
        state, req, out = logic.step(state, batch, pulled)
        # the sorted promise holds only if the logic pushes the ids it pulled
        table = store_mod.push(
            spec, table, req.ids, req.deltas, req.mask,
            ids_sorted=presort and (req.ids is ids),
        )
        return table, state, out

    return step


def make_scan_train_step(
    logic: BatchedWorkerLogic, spec: StoreSpec, *, presort: bool = False
) -> Callable:
    """K train steps per call: ``batches`` holds (K, batch, ...) leaves;
    returns (K, ...)-stacked outputs."""
    base = make_train_step(logic, spec, presort=presort)

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
    shorter than K runs one step at a time."""
    check_mesh(mesh)
    spec = store.spec
    device = store.table.device
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call={steps_per_call}: must be >= 1")
    if steps_per_call > 1 and state_callback is not None:
        raise ValueError(
            "steps_per_call > 1 cannot surface the live table between "
            "steps; use steps_per_call=1 with state_callback"
        )
    step = make_train_step(worker_logic, spec, presort=presort)
    scan_step = make_scan_train_step(worker_logic, spec, presort=presort)
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

_EVENT_API = (
    "the event API (WorkerLogic / ParameterServerLogic and the local "
    "event runtime) is not ported yet: ROADMAP Queue 1 #5"
)


def transform(
    data: Iterable,
    worker_logic: Any,
    ps_logic: Union[ShardedParamStore, Any, None] = None,
    *,
    param_init: Optional[Callable[[int], Any]] = None,
    param_update: Optional[Callable[[Any, Any], Any]] = None,
    worker_parallelism: int = 1,
    ps_parallelism: int = 1,
    iteration_wait_time: Optional[float] = None,
    partitioner: Optional[Callable[[Any, int], int]] = None,
    input_window: Optional[int] = None,
    client_sender=None,
    ps_sender=None,
    **batched_kwargs,
) -> TransformResult:
    """Wire ``data`` + worker logic + server into a PS job (the reference's
    ``FlinkParameterServer.transform`` overloads).

    ``transform(batches, batched_worker, sharded_store, **kw)`` is
    :func:`transform_batched`; the event-API overloads (``param_init`` /
    ``param_update``, custom server logic) raise ``NotImplementedError``.
    As in the reference, the event-only arguments are ignored on the
    batched path."""
    if isinstance(worker_logic, BatchedWorkerLogic):
        if not isinstance(ps_logic, ShardedParamStore):
            raise TypeError("batched worker logic requires a ShardedParamStore server")
        return transform_batched(data, worker_logic, ps_logic, **batched_kwargs)
    raise NotImplementedError(_EVENT_API)


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
    The event-API overload raises ``NotImplementedError``."""
    if not isinstance(ps_logic, ShardedParamStore):
        raise NotImplementedError(_EVENT_API)
    model = list(model)
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
]
