"""Sharded pull and push over a ``dp × ps`` mesh: the collective message plane.

Counterpart of ``flink_parameter_server_tpu/parallel/collectives.py``,
which replaces the reference system's keyed point-to-point routing
(``hash(paramId) % psParallelism`` worker → server and back) with
collectives inside one step.  Each function here is what the reference's
``shard_map`` body runs, called on every rank with that rank's blocks:

  * the table argument is this rank's row block: ps shard ``s`` owns rows
    ``[s·R, (s+1)·R)`` (R rows a shard), replicated over ``dp``;
  * the id arguments are this rank's lanes (its dp slice).

**Pull**: each ps rank gathers the ids it owns, zeros elsewhere, and one
``all_reduce(SUM)`` over ``ps`` assembles the answer.  One value plus
zeros is exact, so a pull is bitwise the single-device gather.

**Push**: ``(ids, deltas, mask)`` are all-gathered over ``dp`` in dp order
(the worker → server shuffle), then each ps rank scatter-adds only its own
rows, with relative ids and the hit mask.  The owned-rows rule
(:func:`owned_rows`), the pull's assembly (:func:`assemble_owned`) and the
push's local arms (:func:`push_rows_`) are the one code of every sharded
pull and push: the store's, the locality MF step's, the fused sharded
step's and the sharded top-K's.  ``impl="pallas"`` runs K1
(``ops/scatter_kernel``) on the block; it takes any block shape, so unlike
the reference's Mosaic gate there is nothing to fall back from.

The list form of ``all_gather`` is used: torch 2.11 and 2.13 both have it,
for NCCL and for gloo on CPU and CUDA tensors alike (2.13 deprecates
``all_gather_into_tensor``).  Half-precision values are summed as float32
(exact for a pull: one value plus zeros), bools gathered as bytes.
:func:`collective_counts` reports calls and bytes by kind.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from .mesh import DP_AXIS, PS_AXIS, axis_group, axis_index, axis_size

_COUNTS: Dict[str, int] = {"all_reduce": 0, "all_reduce_bytes": 0, "all_gather": 0, "all_gather_bytes": 0}


def collective_counts() -> Dict[str, int]:
    """Calls and payload bytes of :func:`all_reduce_sum` and
    :func:`all_gather_cat` in this process."""
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def all_reduce_sum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``lax.psum`` over ``axis``: a new tensor, the elementwise sum of
    every rank's ``x`` along that axis."""
    wide = x.dtype in (torch.bfloat16, torch.float16)
    buf = x.to(torch.float32) if wide else x.clone()
    buf = buf.contiguous()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=axis_group(mesh, axis))
    _COUNTS["all_reduce"] += 1
    _COUNTS["all_reduce_bytes"] += buf.numel() * buf.element_size()
    return buf.to(x.dtype) if wide else buf


def all_gather_cat(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``lax.all_gather(tiled=True)`` over ``axis``: every rank's ``x``
    (same shape on each) concatenated along dim 0 in axis order."""
    boolean = x.dtype == torch.bool
    src = (x.to(torch.uint8) if boolean else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, src, group=axis_group(mesh, axis))
    _COUNTS["all_gather"] += 1
    _COUNTS["all_gather_bytes"] += src.numel() * src.element_size() * len(parts)
    out = torch.cat(parts, 0)
    return out.to(torch.bool) if boolean else out


def block_start(rows: int, mesh, ps_axis: str = PS_AXIS) -> int:
    """The first row of this rank's block of a table row-blocked over
    ``ps_axis`` in blocks of ``rows``: ps rank ``p`` owns ``[p·rows,
    (p+1)·rows)`` (the one block starts at 0 without a mesh)."""
    return axis_index(mesh, ps_axis) * rows


def owned_rows(ids: torch.Tensor, rows: int, mesh, ps_axis: str = PS_AXIS):
    """The owned-rows rule of every sharded pull and push: ``(rel, hit)``,
    each id relative to this rank's block (int64, unclipped) and whether
    this rank owns it.  Without a mesh the one block is ``[0, rows)``."""
    rel = ids.to(torch.int64) - block_start(rows, mesh, ps_axis)
    return rel, (rel >= 0) & (rel < rows)


def assemble_owned(vals: torch.Tensor, hit: torch.Tensor, mesh, ps_axis: str = PS_AXIS) -> torch.Tensor:
    """The answer of a sharded pull: ``vals`` (``hit.shape + value
    shape``, read from this rank's block) zeroed on the lanes this rank
    does not own, summed over ``ps``.  One value plus zeros: exact."""
    hit = hit.reshape(tuple(hit.shape) + (1,) * (vals.ndim - hit.ndim))
    return all_reduce_sum(torch.where(hit, vals, torch.zeros_like(vals)), mesh, ps_axis)


def shard_pull(
    table: torch.Tensor,
    ids: torch.Tensor,
    *,
    mesh,
    ps_axis: str = PS_AXIS,
    dp_axis: Optional[str] = DP_AXIS,
) -> torch.Tensor:
    """Sharded gather through one all-reduce over ``ps``.

    ``table``: this rank's (R, *value_shape) block.  ``ids``: this rank's
    lanes, any shape (the ps ranks of one dp slice pass the same ids).
    Returns ``ids.shape + value_shape``.  ``dp_axis`` is accepted for the
    reference's signature; the lanes are already this rank's."""
    rows = table.shape[0]
    rel, hit = owned_rows(ids, rows, mesh, ps_axis)
    vals = table.index_select(0, rel.clamp(0, rows - 1).reshape(-1))
    vals = vals.reshape(tuple(ids.shape) + tuple(table.shape[1:]))
    return assemble_owned(vals, hit, mesh, ps_axis)


def push_rows_(
    table: torch.Tensor,
    ids: torch.Tensor,
    deltas: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    impl: str = "xla",
    ids_sorted: bool = False,
) -> torch.Tensor:
    """The local half of every push into a dense block, in place: fold
    ``deltas`` (n, *value_shape) into rows ``ids`` (n,) of ``table`` by
    the ``impl`` arm.  ``ids`` are block rows, those at or past the
    block's end dropped; ``deltas`` are already zero on masked lanes, and
    ``mask`` (optional) only lets K1 drop those lanes outright.

    ``"xla"``: ``ops/rows.add_rows_``; ``"xla_sorted"``:
    ``ops/sorted_scatter`` (``ids_sorted`` skips its sort: the block's own
    lanes must be ascending and adjacent); ``"pallas"``: K1
    (``ops/scatter_kernel``), which takes any block shape."""
    from ..ops import scatter_kernel
    from ..ops.rows import add_rows_
    from ..ops.sorted_scatter import sorted_dedup_scatter_add

    if impl == "pallas":
        return scatter_kernel.scatter_add(table, ids, deltas, mask)
    if impl == "xla_sorted":
        return sorted_dedup_scatter_add(table, ids, deltas, None, oob=table.shape[0], ids_sorted=ids_sorted)
    if impl == "xla":
        return add_rows_(table, ids, deltas)
    raise ValueError(f"impl={impl!r} is not one of ('xla', 'xla_sorted', 'pallas')")


def shard_push_add(
    table: torch.Tensor,
    ids: torch.Tensor,
    deltas: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    mesh,
    ps_axis: str = PS_AXIS,
    dp_axis: Optional[str] = DP_AXIS,
    impl: str = "xla",
    ids_sorted: bool = False,
) -> torch.Tensor:
    """Sharded scatter-add, in place on this rank's block; returns it.

    Every dp slice's ``(ids, deltas, mask)`` is all-gathered over ``dp``
    (when the mesh has that axis; ``dp_axis=None`` takes the lanes as the
    whole batch's already), then each ps rank folds in the rows it owns
    through :func:`push_rows_`'s ``impl`` arm (``ids_sorted`` promises
    globally ascending ids, which the dp gather keeps in order)."""
    if impl not in ("xla", "xla_sorted", "pallas"):
        raise ValueError(f"impl={impl!r} is not one of ('xla', 'xla_sorted', 'pallas')")
    if dp_axis is not None and axis_size(mesh, dp_axis) > 1:
        ids = all_gather_cat(ids, mesh, dp_axis)
        deltas = all_gather_cat(deltas, mesh, dp_axis)
        if mask is not None:
            mask = all_gather_cat(mask, mesh, dp_axis)
    rows = table.shape[0]
    vshape = tuple(table.shape[1:])
    rel, hit = owned_rows(ids.reshape(-1), rows, mesh, ps_axis)
    if mask is not None:
        hit = hit & mask.reshape(-1)
    d = deltas.reshape((-1,) + vshape)
    d = torch.where(hit.reshape((-1,) + (1,) * len(vshape)), d, torch.zeros_like(d))
    return push_rows_(table, torch.where(hit, rel, rows), d, hit, impl=impl, ids_sorted=ids_sorted)


__all__ = [
    "all_gather_cat",
    "all_reduce_sum",
    "assemble_owned",
    "block_start",
    "collective_counts",
    "owned_rows",
    "push_rows_",
    "reset_collective_counts",
    "shard_pull",
    "shard_push_add",
]
