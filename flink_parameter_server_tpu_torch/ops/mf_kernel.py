"""Fused MF-SGD, item side: pull + SGD + push in one sorted pass.

Replaces the TPU kernel ``flink_parameter_server_tpu/ops/pallas_mf.py``
(``_kernel`` / ``_sorted_fused_call`` and the wrappers ``fused_mf_sgd``,
``fused_mf_sgd_packed``, ``make_fused_mf_train_step``) with the CUDA kernel
in ``csrc/fused_mf.cu``.  Lanes are sorted by item; each unique item row q
is read once and every lane of its run computes against that pre-batch
snapshot: ``pred = p.q``, ``e = m*lr*(r - pred)``, user delta ``e*q -
m*lr*reg*p``, item delta ``e*p - m*lr*reg*q``.  Item deltas are summed in
float32 per row and the row is written once; user deltas and predictions
come out per lane.  The user gather before the kernel and the user
scatter-add after it stay outside, as in the reference.

Semantics match the unfused step (``core/transform.make_train_step`` with
``OnlineMatrixFactorization``) on every valid lane, masked lanes
included.  Two divergences on invalid lanes only, as in the reference: an
out-of-range item predicts against the last table row, and its lane
updates no user row.

Packed tables (``ops/packed.py``): the math runs over the item's own
column slice of its physical row; user rows stay at logical width.

Bound on an H100: bytes (the per-lane user rows in and user deltas out
dominate).  Hot runs are split over warps and tiles and recombined in a
fixed order by ``csrc/runs.cuh``: the result is the same, bit for bit, on
every run with the same inputs.

:func:`fused_mf_sgd_sharded` runs the kernel once per ps rank on that
rank's row block of the item table (ps-only meshes, as the reference).

Dispatch: an item table on the CPU takes :func:`fused_mf_sgd_plain`; a
CUDA table launches the kernel or raises.  ``sorted_fused_mf_sgd.launches``
counts launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _cuda
from .packed import pack_k
from .rows import add_rows_
from .scatter_kernel import _check_sorted_args, _row_columns, run_sum_write_plain

MAX_DIM = 256  # the kernel's widest tile: 32 lanes of 256 floats in 32 KB of shared memory

_SIGNATURES = {
    "fps_fused_mf_sgd": (
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ),
    "fps_chunk_lanes": (),
}


def fused_mf_sgd_plain(
    item_table: torch.Tensor, s_items: torch.Tensor, s_p: torch.Tensor,
    s_r: torch.Tensor, s_m: torch.Tensor, *, learning_rate: float,
    regularization: float, sub_k: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: same inputs, same in-place table write,
    returns ``(udelta, pred)`` in sorted lane order."""
    W, d = item_table.shape[1], s_p.shape[1]
    q = item_table.view(-1)[_row_columns(s_items, sub_k, d, W)].to(torch.float32)
    pred = (s_p * q).sum(1)
    mlr = s_m * learning_rate
    e = (mlr * (s_r - pred)).unsqueeze(1)
    shrink = (mlr * regularization).unsqueeze(1)
    udelta = e * q - shrink * s_p
    run_sum_write_plain(item_table, s_items, e * s_p - shrink * q, sub_k=sub_k)
    return udelta, pred


def sorted_fused_mf_sgd(
    item_table: torch.Tensor, s_items: torch.Tensor, s_p: torch.Tensor,
    s_r: torch.Tensor, s_m: torch.Tensor, *, learning_rate: float,
    regularization: float, sub_k: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel call on lanes sorted by item id (in range, int32).

    ``s_p`` (n, d) float32 user rows, ``s_r``/``s_m`` (n,) float32.
    Updates ``item_table`` in place; returns float32 ``(udelta (n, d),
    pred (n,))`` in sorted lane order."""
    _check_sorted_args(item_table, s_items, s_p, sub_k)
    n, d = s_p.shape
    for name, t in (("p", s_p), ("r", s_r), ("m", s_m)):
        if t.dtype != torch.float32 or t.device != item_table.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on the table's device")
    if s_r.shape != (n,) or s_m.shape != (n,):
        raise ValueError(f"r and m must be ({n},)")
    if item_table.device.type == "cpu":
        return fused_mf_sgd_plain(
            item_table, s_items, s_p, s_r, s_m, learning_rate=learning_rate,
            regularization=regularization, sub_k=sub_k,
        )
    if item_table.device.type != "cuda":
        raise ValueError(f"no fused MF kernel for device {item_table.device}")
    if item_table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused MF kernel takes float32 or bfloat16 tables, got {item_table.dtype}")
    if d > MAX_DIM:
        raise ValueError(f"fused MF kernel takes rows of at most {MAX_DIM}, got {d}")
    lib = _cuda.load("fused_mf", _SIGNATURES)
    udelta = torch.empty((n, d), dtype=torch.float32, device=item_table.device)
    pred = torch.empty((n,), dtype=torch.float32, device=item_table.device)
    chunks = math.ceil(n / lib.fps_chunk_lanes())
    head = torch.empty((chunks, d), dtype=torch.float32, device=item_table.device)
    tail = torch.empty_like(head)
    err = lib.fps_fused_mf_sgd(
        _cuda.DTYPE_CODES[item_table.dtype], item_table.data_ptr(), item_table.shape[1],
        s_items.data_ptr(), s_p.data_ptr(), s_r.data_ptr(), s_m.data_ptr(), n, d,
        sub_k, learning_rate, regularization, udelta.data_ptr(), pred.data_ptr(),
        head.data_ptr(), tail.data_ptr(), _cuda.stream_handle(item_table.device),
    )
    _cuda.check(err, "sorted_fused_mf_sgd")
    sorted_fused_mf_sgd.launches += 1
    return udelta, pred


sorted_fused_mf_sgd.launches = 0


def sort_lanes(capacity, user_table, users, items, ratings, mask):
    """Sort lanes by item id.  Only invalid item ids are routed to the last
    row (with m = 0); masked-but-valid lanes keep their row, so their
    prediction is computed against it, as the unfused step does."""
    items = items.to(torch.int64)
    users = users.to(torch.int64)
    valid = (items >= 0) & (items < capacity)
    m = valid if mask is None else (mask & valid)
    work = torch.where(valid, items, capacity - 1)
    order = torch.argsort(work, stable=True)
    s_users = users[order]
    s_p = user_table.index_select(
        0, s_users.clamp(0, user_table.shape[0] - 1)
    ).to(torch.float32)
    return (
        order,
        work[order].to(torch.int32),
        s_users,
        ratings[order].to(torch.float32).contiguous(),
        m[order].to(torch.float32),
        s_p.contiguous(),
    )


def _finish(user_table, order, s_users, udelta, preds):
    """User scatter-add (drop-mode, as the reference) and predictions back
    in stream order."""
    add_rows_(user_table, s_users, udelta)
    pred = torch.empty_like(preds)
    pred[order] = preds
    return pred


def fused_mf_sgd(
    user_table: torch.Tensor,
    item_table: torch.Tensor,
    users: torch.Tensor,
    items: torch.Tensor,
    ratings: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    learning_rate: float = 0.01,
    regularization: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused MF-SGD microbatch step on a dense item table.

    Updates both tables in place and returns ``(user_table, item_table,
    predictions)``, predictions in the original lane order."""
    order, s_items, s_users, s_r, s_m, s_p = sort_lanes(
        item_table.shape[0], user_table, users, items, ratings, mask
    )
    udelta, preds = sorted_fused_mf_sgd(
        item_table.view(item_table.shape[0], -1), s_items, s_p, s_r, s_m,
        learning_rate=learning_rate, regularization=regularization,
    )
    return user_table, item_table, _finish(user_table, order, s_users, udelta, preds)


def fused_mf_sgd_packed(
    user_table: torch.Tensor,
    packed_item_table: torch.Tensor,
    users: torch.Tensor,
    items: torch.Tensor,
    ratings: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    capacity: int,
    dim: int,
    learning_rate: float = 0.01,
    regularization: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused step over a lane-packed item table (``capacity``/``dim``
    are the LOGICAL item count and row width).  In place, like
    :func:`fused_mf_sgd`."""
    k = pack_k(dim)
    nphys = packed_item_table.shape[0]
    if capacity > nphys * k:
        raise ValueError(
            f"capacity {capacity} exceeds the packed table's {nphys} physical "
            f"rows x k={k} = {nphys * k} logical rows"
        )
    order, s_items, s_users, s_r, s_m, s_p = sort_lanes(
        capacity, user_table, users, items, ratings, mask
    )
    udelta, preds = sorted_fused_mf_sgd(
        packed_item_table, s_items, s_p, s_r, s_m, learning_rate=learning_rate,
        regularization=regularization, sub_k=k,
    )
    return user_table, packed_item_table, _finish(user_table, order, s_users, udelta, preds)


def fused_mf_sgd_sharded(
    user_table: torch.Tensor,
    item_table: torch.Tensor,
    users: torch.Tensor,
    items: torch.Tensor,
    ratings: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    mesh,
    ps_axis: str = "ps",
    learning_rate: float = 0.01,
    regularization: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused step over an item table row-blocked over a ps-only mesh,
    on every rank: ``item_table`` is this rank's (R, d) dense block, the
    batch and the user table are the same on every rank.

    Each rank runs the kernel on its block with the lanes outside its rows
    masked (their item routed to the block's last row with m = 0, so they
    contribute a zero user delta).  A lane's item lives on exactly one
    shard, so per-lane user deltas and predictions are zero off the owner
    and ONE all-reduce over ``ps`` assembles them; every rank then applies
    the same user deltas, which keeps the user table replicated.  Updates
    both tables in place; returns ``(user_table, item_table, predictions)``
    in lane order.

    A mesh with any other axis of size > 1 raises (item blocks replicated
    over it would diverge).  On invalid lanes only it differs from
    :func:`fused_mf_sgd`, as the reference's does: a globally out-of-range
    item predicts 0.0 (no shard owns it)."""
    from ..parallel.collectives import all_reduce_sum, assemble_owned, owned_rows
    from ..utils.device import check_mesh

    check_mesh(mesh, item_table.device, ps_axis=ps_axis)
    for ax, size in zip(mesh.mesh_dim_names, mesh.shape):
        if ax != ps_axis and size != 1:
            raise ValueError(
                f"fused sharded step supports ps-only meshes (item blocks "
                f"would be replicated over axis {ax!r} (size {size}) and the "
                f"in-kernel writes would diverge)"
            )
    rows = item_table.shape[0]
    rel, hit = owned_rows(items, rows, mesh, ps_axis)
    m = hit if mask is None else (hit & mask)
    order, s_items, s_users, s_r, s_m, s_p = sort_lanes(
        rows, user_table, users, torch.where(hit, rel, -1), ratings, m
    )
    udelta, preds = sorted_fused_mf_sgd(
        item_table.view(rows, -1), s_items, s_p, s_r, s_m,
        learning_rate=learning_rate, regularization=regularization,
    )
    # back to lane order; a foreign lane's pred (against the routed row) is
    # dropped, its user delta is already zero (m = 0)
    n = items.shape[0]
    lane_udelta = torch.empty_like(udelta)
    lane_udelta[order] = udelta
    lane_pred = torch.empty_like(preds)
    lane_pred[order] = preds
    lane_udelta = all_reduce_sum(lane_udelta[:n], mesh, ps_axis)
    lane_pred = assemble_owned(lane_pred[:n], hit, mesh, ps_axis)
    add_rows_(user_table, users, lane_udelta)
    return user_table, item_table, lane_pred


def make_fused_mf_train_step(
    *,
    learning_rate: float = 0.01,
    regularization: float = 0.0,
    layout: str = "dense",
    capacity: Optional[int] = None,
    dim: Optional[int] = None,
):
    """Drop-in for ``make_train_step(OnlineMatrixFactorization, spec)``:
    ``step(item_table, user_table, batch) -> (item_table, user_table,
    out)``, both tables updated in place.  ``layout="packed"`` (with the
    LOGICAL ``capacity`` and ``dim``) takes a table from
    ``ShardedParamStore(layout="packed")``."""
    if layout not in ("dense", "packed"):
        # 'auto' is a store-construction convenience; here the layout must
        # match the concrete table, or a packed table would be read as
        # dense rows and train garbage
        raise ValueError(
            f"layout must be 'dense' or 'packed' (matching the item table's "
            f"actual layout), got {layout!r}"
        )
    if layout == "packed" and (capacity is None or dim is None):
        raise ValueError("layout='packed' needs capacity= and dim=")

    def step(item_table, user_table, batch):
        mask = batch.get("mask")
        kwargs = dict(learning_rate=learning_rate, regularization=regularization)
        if layout == "packed":
            kwargs.update(capacity=capacity, dim=dim)
            fused = fused_mf_sgd_packed
        else:
            fused = fused_mf_sgd
        user_table, item_table, pred = fused(
            user_table, item_table, batch["user"], batch["item"], batch["rating"],
            mask, **kwargs,
        )
        m = torch.ones_like(pred) if mask is None else mask.to(torch.float32)
        out = {
            "prediction": pred,
            "error": (batch["rating"].to(torch.float32) - pred) * m,
        }
        return item_table, user_table, out

    return step


__all__ = [
    "sort_lanes",
    "fused_mf_sgd",
    "fused_mf_sgd_packed",
    "fused_mf_sgd_sharded",
    "fused_mf_sgd_plain",
    "sorted_fused_mf_sgd",
    "make_fused_mf_train_step",
]
