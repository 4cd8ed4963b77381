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

The dense LM's data parallelism adds three pieces, used by
``core/dense.py`` and ``models/transformer.py``: :func:`reduce_scatter_sum`
(``lax.psum_scatter(tiled=True)``, the ZeRO-1 / FSDP gradient exchange),
:func:`dp_rows` (this rank's contiguous rows of a global microbatch) and
:func:`global_mean` (a mean over the whole batch of sums the dp ranks hold
in parts: the loss's numerator and denominator in one all-reduce).
:func:`gather_rows` / :func:`take_rows` move a tensor's batch rows between
the rank's share and the global one inside autograd.

Expert parallelism adds :func:`all_to_all` (``lax.all_to_all(split_axis=0,
concat_axis=0)``), the MoE layer's dispatch and return trips
(``models/moe.moe_apply``).

Tensor, sequence and pipeline parallelism add :func:`ppermute`
(``lax.ppermute`` by a shift around an axis: the ring's K/V rotation and
the pipeline's stage hand-off), Megatron's conjugate pair
:func:`copy_to_tp` / :func:`reduce_from_tp` (identity one way, an
all-reduce the other), and :func:`take_block` / :func:`gather_block`, the
row helpers along any dim (a sequence slice over ``sp``, a head slice over
``tp``).  :func:`global_mean` takes several axes (dp and sp hold the loss's
tokens in parts).

The list forms of ``all_gather`` and ``reduce_scatter`` are used: torch
2.11 and 2.13 both have them, for NCCL and for gloo on CPU and CUDA
tensors alike (2.13 deprecates ``all_gather_into_tensor``).  The
all-to-all is ``all_to_all_single``: on torch 2.11 gloo refuses the list
``all_to_all`` ("Backend gloo does not support alltoall") for CUDA
tensors and takes ``all_to_all_single``, which NCCL takes too.  So one
route serves every backend; none is chosen by a ``try``.  :func:`ppermute`
rides the same call with one non-empty split each way (a send to one rank,
a receive from another), its payload viewed as bytes: gloo's ``send`` /
``recv`` take CPU tensors only, and bytes are summed by nobody.  Half-precision
values are summed as float32 (exact for a pull: one value plus zeros), but
travel as they are through an all-to-all, which sums nothing; bools are
gathered as bytes.  :func:`collective_counts` reports calls and bytes by
kind.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import DP_AXIS, PS_AXIS, axis_group, axis_index, axis_size

_COUNTS: Dict[str, int] = {"all_reduce": 0, "all_reduce_bytes": 0, "all_gather": 0, "all_gather_bytes": 0,
                           "reduce_scatter": 0, "reduce_scatter_bytes": 0, "all_to_all": 0,
                           "all_to_all_bytes": 0, "ppermute": 0, "ppermute_bytes": 0}


def collective_counts() -> Dict[str, int]:
    """Calls and payload bytes of :func:`all_reduce_sum`,
    :func:`all_gather_cat`, :func:`reduce_scatter_sum`, :func:`all_to_all`
    and :func:`ppermute` (each trip, forward or backward) in this
    process."""
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


def all_gather_cat(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """``lax.all_gather(tiled=True)`` over ``axis``: every rank's ``x``
    (same shape on each) concatenated along ``dim`` in axis order."""
    boolean = x.dtype == torch.bool
    src = (x.to(torch.uint8) if boolean else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, src, group=axis_group(mesh, axis))
    _COUNTS["all_gather"] += 1
    _COUNTS["all_gather_bytes"] += src.numel() * src.element_size() * len(parts)
    out = torch.cat(parts, dim)
    return out.to(torch.bool) if boolean else out


def reduce_scatter_sum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``lax.psum_scatter(tiled=True)`` over ``axis``: ``x`` (the same
    shape on each rank, dim 0 a multiple of the axis size n) cut into n
    equal chunks along dim 0; returns this rank's chunk of the elementwise
    sum over the axis.  Half precision is summed as float32."""
    n = axis_size(mesh, axis)
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter_sum: dim 0 of {tuple(x.shape)} does not split into {n}")
    wide = x.dtype in (torch.bfloat16, torch.float16)
    src = (x.to(torch.float32) if wide else x).contiguous()
    parts = list(src.chunk(n))
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM, group=axis_group(mesh, axis))
    _COUNTS["reduce_scatter"] += 1
    _COUNTS["reduce_scatter_bytes"] += src.numel() * src.element_size()
    return out.to(x.dtype) if wide else out


def _all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    n = axis_size(mesh, axis)
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} does not split into {axis}={n}")
    src = x.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=axis_group(mesh, axis))
    _COUNTS["all_to_all"] += 1
    _COUNTS["all_to_all_bytes"] += src.numel() * src.element_size()
    return out


class _AllToAll(torch.autograd.Function):
    """The trip and its reverse: the cotangent of the chunk received from
    rank s goes back to rank s, which is the same all-to-all."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_to_all(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.mesh, ctx.axis), None, None


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``lax.all_to_all(split_axis=0, concat_axis=0)`` over ``axis``: ``x``
    (the same shape on each rank, dim 0 a multiple of the axis size n) is
    cut into n equal chunks along dim 0, chunk j goes to rank j of the
    axis, and the result holds the n chunks received, in sender order, in
    ``x``'s shape and dtype (half precision travels as it is: nothing is
    summed).  Differentiable: the backward is the reverse trip.  Counted
    once per trip in :func:`collective_counts` (bytes: this rank's send)."""
    return _AllToAll.apply(x, mesh, axis)


def _ppermute(x: torch.Tensor, mesh, axis: str, shift: int) -> torch.Tensor:
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)
    src = x.contiguous().reshape(-1).view(torch.uint8)
    sends, recvs = [0] * n, [0] * n
    sends[(i + shift) % n] = recvs[(i - shift) % n] = src.numel()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, output_split_sizes=recvs, input_split_sizes=sends,
                           group=axis_group(mesh, axis))
    _COUNTS["ppermute"] += 1
    _COUNTS["ppermute_bytes"] += src.numel()
    return out.view(x.dtype).reshape(x.shape)


class _PPermute(torch.autograd.Function):
    """The shift and its transpose, the reverse shift."""

    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return _ppermute(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, grad):
        return _ppermute(grad, ctx.mesh, ctx.axis, -ctx.shift), None, None, None


def ppermute(x: torch.Tensor, mesh, axis: str, shift: int = 1) -> torch.Tensor:
    """``lax.ppermute`` with the permutation ``i -> (i + shift) mod n`` over
    ``axis``: this rank's ``x`` goes to rank ``i + shift`` of the axis and
    the result is what rank ``i - shift`` sent (same shape and dtype on
    every rank; the bits travel as they are).  Differentiable: the
    backward is the reverse shift.  Every rank of the axis must call it
    the same number of times in the same order, forward and backward.
    Counted once per trip in :func:`collective_counts`."""
    return _PPermute.apply(x, mesh, axis, int(shift))


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.mesh, ctx.axis), None, None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce_sum(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def copy_to_tp(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Megatron's ``f``: the identity forward, an all-reduce over ``axis``
    backward.  It goes before the column-parallel products of a tensor
    parallel block, whose input every ``tp`` rank holds alike: each rank's
    product sends back the gradient of its columns only, and the sum is the
    input's whole gradient, the same on every rank."""
    return _CopyToTp.apply(x, mesh, axis)


def reduce_from_tp(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Megatron's ``g``: an all-reduce over ``axis`` forward (the row-parallel
    products' partial sums), the identity backward."""
    return _ReduceFromTp.apply(x, mesh, axis)


def block_of(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous ``axis`` block of ``x`` along ``dim`` (a view;
    the dim must divide by the axis size)."""
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split into {axis}={n} equal blocks")
    per = x.shape[dim] // n
    return x.narrow(dim, i * per, per)


class _TakeBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return block_of(x, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return all_gather_cat(grad.contiguous(), ctx.mesh, ctx.axis, ctx.dim), None, None, None


def take_block(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """This rank's ``axis`` block along ``dim`` of a global tensor that
    every rank of the axis holds alike; the gradient all-gathers the
    ranks' block gradients, so every rank gets the whole tensor's
    gradient."""
    return _TakeBlock.apply(x, mesh, axis, dim)


def take_rows(x: torch.Tensor, mesh, axis: str = DP_AXIS) -> torch.Tensor:
    """This rank's ``axis`` rows of a global tensor that every rank holds
    alike (:func:`dp_rows`): :func:`take_block` along dim 0."""
    return _TakeBlock.apply(x, mesh, axis, 0)


class _GatherBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, mesh, axis, dim):
        ctx.lo, ctx.n, ctx.dim = axis_index(mesh, axis) * rows.shape[dim], rows.shape[dim], dim
        return all_gather_cat(rows, mesh, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.lo, ctx.n), None, None, None


def gather_block(rows: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The ``axis`` all-gather along ``dim`` of every rank's block (equal
    sizes) into the global tensor; its backward takes this rank's block of
    the gradient, with no collective: exact when every rank's loss is the
    same function of the global tensor, or when no other rank's loss
    reaches this rank's block (:func:`gather_rows`)."""
    return _GatherBlock.apply(rows, mesh, axis, dim)


def gather_rows(rows: torch.Tensor, mesh, axis: str = DP_AXIS) -> torch.Tensor:
    """The ``axis`` all-gather of every rank's rows (equal counts) into the
    global tensor; its backward takes this rank's rows of the gradient and
    needs no collective.  That is exact whenever no other rank's loss
    reaches this rank's rows through the global tensor, which holds for its
    caller ``flash_mha_dp`` (attention never mixes batch rows) and for the
    MoE layer's gathers over dp and sp (``models/transformer.py``, through
    :func:`gather_block`: given the routing, each token's output depends
    only on that token and the weights, so the rank's loss sends gradient
    only to its own tokens)."""
    return _GatherBlock.apply(rows, mesh, axis, 0)


def dp_rows(batch: Any, mesh, axis: str = DP_AXIS) -> Any:
    """This rank's contiguous rows of a global microbatch: every tensor or
    array leaf (of a mapping, list or tuple) with a leading dim is cut into
    ``axis``-size equal slices and slice ``axis_index`` kept; scalars and
    other leaves pass through.  A leading dim the axis does not divide
    raises."""
    n, d = axis_size(mesh, axis), axis_index(mesh, axis)

    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(cut(v) for v in x)
        if isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim > 0:
            if x.shape[0] % n:
                raise ValueError(f"batch of {x.shape[0]} rows does not split into {axis}={n} equal slices")
            per = x.shape[0] // n
            return x[d * per:(d + 1) * per]
        return x

    return cut(batch)


class _GlobalMean(torch.autograd.Function):
    """Value ``total / count``; gradient to ``local_sum`` only, ``1 / count``."""

    @staticmethod
    def forward(ctx, local_sum, total, count):
        ctx.save_for_backward(count)
        return total / count

    @staticmethod
    def backward(ctx, grad):
        (count,) = ctx.saved_tensors
        return grad / count, None, None


_SUMMED = "_fps_dp_summed"  # marks a loss whose gradients the dp ranks sum
_MADE = threading.local()  # .n: the global_mean results this thread has made


def global_mean(local_sum: torch.Tensor, local_count: torch.Tensor, mesh, axis: Any = DP_AXIS,
                *, min_count: float = 1.0) -> torch.Tensor:
    """The mean over the whole batch of a per-row sum the ``axis`` ranks
    hold in parts: ``(Σ local_sum) / max(Σ local_count, min_count)``, the
    same value on every rank, from one all-reduce of the pair over each
    axis (``axis`` names one, or is a tuple: ``("dp", "sp")`` when the
    sequence is split too; the count carries no gradient).  Its gradient is this rank's part,
    ``∂local_sum / count``: the ranks' gradients SUMMED are the whole
    batch's.  The result is marked so (:func:`is_global_mean`); the dense
    step sums such a loss's gradients instead of averaging them.  The mark
    is on this tensor only: arithmetic on it (an added regulariser) gives
    an unmarked tensor, which the step refuses (:func:`global_means_made`)."""
    both = torch.stack([local_sum.detach(), local_count.detach().to(local_sum.dtype)])
    for name in ((axis,) if isinstance(axis, str) else tuple(axis)):
        both = all_reduce_sum(both, mesh, name)
    out = _GlobalMean.apply(local_sum, both[0], torch.clamp(both[1], min=min_count))
    setattr(out, _SUMMED, True)
    _MADE.n = global_means_made() + 1
    return out


def global_means_made() -> int:
    """How many :func:`global_mean` results this thread has made.  The
    dense step reads it around ``loss_fn``: a loss_fn that made one but
    returned another, unmarked, tensor mixes the two gradient routes."""
    return getattr(_MADE, "n", 0)


def is_global_mean(loss: torch.Tensor) -> bool:
    """True for a loss made by :func:`global_mean` (already the whole
    batch's value; its gradients are parts to sum over dp)."""
    return bool(getattr(loss, _SUMMED, False))


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
    "all_to_all",
    "assemble_owned",
    "block_of",
    "block_start",
    "collective_counts",
    "copy_to_tp",
    "dp_rows",
    "gather_block",
    "gather_rows",
    "global_mean",
    "global_means_made",
    "is_global_mean",
    "owned_rows",
    "ppermute",
    "push_rows_",
    "reduce_from_tp",
    "reduce_scatter_sum",
    "reset_collective_counts",
    "shard_pull",
    "shard_push_add",
    "take_block",
    "take_rows",
]
