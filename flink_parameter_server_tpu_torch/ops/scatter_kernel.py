"""Sorted, duplicate-compressing scatter-add: the push of
``scatter_impl="pallas"``.

Replaces the TPU kernel ``flink_parameter_server_tpu/ops/pallas_scatter.py``
(``_kernel`` / ``sorted_scatter_add_pallas`` / ``scatter_add``) with the
CUDA kernel in ``csrc/scatter_add.cu``.  It computes ``table[ids] +=
deltas`` with duplicates combined: :func:`scatter_add` turns masked and
out-of-range lanes into zero deltas on the last row and sorts the lanes
by id (stable, so a run keeps stream order); the kernel sums each run of
equal ids (float32 for float tables, the table's type for int32 tables,
so counts stay exact past 2^24) and writes each unique row once.

With ``sub_k > 1`` the table is lane-packed (``ops/packed.py``): logical
id ``i`` lives in physical row ``i // sub_k`` at column ``(i % sub_k) *
sub_width``, and each run writes only its own column slice.

Bound on an H100: bytes (every delta read once, every unique row read and
written once).  The lanes are cut into 256-lane tiles, one block each;
hot runs are split over warps and tiles and recombined in a fixed order
(``csrc/runs.cuh``), with no atomics, so two runs on the same inputs give
the same bits.

Dispatch: a table on the CPU takes :func:`run_sum_write_plain`, the plain
torch version of the same function; a CUDA table launches the kernel or
raises.  ``sorted_scatter_add.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _cuda

_SIGNATURES = {
    "fps_sorted_scatter_add": (
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ),
    "fps_chunk_lanes": (),
}


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Run sums: float32 for float tables, the table's type otherwise."""
    return torch.float32 if dtype.is_floating_point else dtype


def _row_columns(ids: torch.Tensor, sub_k: int, d: int, W: int) -> torch.Tensor:
    """(n, d) flat element index of each id's row slice."""
    ids = ids.to(torch.int64)
    base = (ids // sub_k) * W + (ids % sub_k) * d
    return base.unsqueeze(1) + torch.arange(d, device=ids.device).unsqueeze(0)


def run_sum_write_plain(
    table: torch.Tensor, sorted_ids: torch.Tensor, sorted_vals: torch.Tensor,
    *, sub_k: int = 1,
) -> torch.Tensor:
    """Plain version of the kernel body: sum each run of equal ids in the
    accumulator type and write each unique id's row slice once, in place.

    ``table``: (rows, W) contiguous; ``sorted_ids``: ascending, in range;
    ``sorted_vals``: (n, d) with ``d * sub_k <= W``."""
    W, d = table.shape[1], sorted_vals.shape[1]
    acc = acc_dtype(table.dtype)
    ids = sorted_ids.to(torch.int64)
    first = torch.ones_like(ids, dtype=torch.bool)
    first[1:] = ids[1:] != ids[:-1]
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    run_ids = ids[first]
    sums = torch.zeros((run_ids.shape[0], d), dtype=acc, device=table.device)
    sums.index_add_(0, seg, sorted_vals.to(acc))
    cols = _row_columns(run_ids, sub_k, d, W)
    flat = table.view(-1)
    flat[cols] = (flat[cols].to(acc) + sums).to(table.dtype)
    return table


def _check_sorted_args(table, sorted_ids, sorted_vals, sub_k):
    if table.ndim != 2 or not table.is_contiguous():
        raise ValueError(f"table must be 2-D contiguous, got {tuple(table.shape)}")
    if sorted_ids.ndim != 1 or sorted_ids.dtype != torch.int32 or not sorted_ids.is_contiguous():
        raise ValueError("sorted ids must be a contiguous 1-D int32 tensor")
    n = sorted_ids.shape[0]
    if sorted_vals.ndim != 2 or sorted_vals.shape[0] != n or not sorted_vals.is_contiguous():
        raise ValueError(
            f"values must be contiguous (n={n}, d), got {tuple(sorted_vals.shape)}"
        )
    if sub_k < 1 or sorted_vals.shape[1] * sub_k > table.shape[1]:
        raise ValueError(
            f"sub_k {sub_k} x width {sorted_vals.shape[1]} exceeds table width "
            f"{table.shape[1]}"
        )
    if table.shape[0] * sub_k > 2**31 - 1:
        raise ValueError("table ids must fit int32")
    if not (table.device == sorted_ids.device == sorted_vals.device):
        raise ValueError("table, ids and values must be on one device")


def sorted_scatter_add(
    table: torch.Tensor, sorted_ids: torch.Tensor, sorted_deltas: torch.Tensor,
    *, sub_k: int = 1,
) -> torch.Tensor:
    """The kernel call: ``table[sorted_ids] += sorted_deltas`` in place.

    ``sorted_ids`` (n,) int32 must be ascending and in range (< rows *
    sub_k); ``sorted_deltas`` (n, d) must be in the table's dtype."""
    _check_sorted_args(table, sorted_ids, sorted_deltas, sub_k)
    if sorted_deltas.dtype != table.dtype:
        raise ValueError(
            f"deltas dtype {sorted_deltas.dtype} != table dtype {table.dtype}"
        )
    # the plain version takes what the kernel takes, so the CPU shows what
    # the card would do
    code = _cuda.DTYPE_CODES.get(table.dtype)
    if code is None:
        raise ValueError(f"scatter kernel takes float32, bfloat16 or int32, got {table.dtype}")
    if table.device.type == "cpu":
        return run_sum_write_plain(table, sorted_ids, sorted_deltas, sub_k=sub_k)
    if table.device.type != "cuda":
        raise ValueError(f"no scatter kernel for device {table.device}")
    lib = _cuda.load("scatter_add", _SIGNATURES)
    n, d = sorted_deltas.shape
    chunks = math.ceil(n / lib.fps_chunk_lanes())
    head = torch.empty((chunks, d), dtype=acc_dtype(table.dtype), device=table.device)
    tail = torch.empty_like(head)
    err = lib.fps_sorted_scatter_add(
        code, table.data_ptr(), table.shape[1], sorted_ids.data_ptr(),
        sorted_deltas.data_ptr(), n, d, sub_k, head.data_ptr(), tail.data_ptr(),
        _cuda.stream_handle(table.device),
    )
    _cuda.check(err, "sorted_scatter_add")
    sorted_scatter_add.launches += 1
    return table


sorted_scatter_add.launches = 0


def scatter_add(
    table: torch.Tensor,
    ids: torch.Tensor,
    deltas: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    sub_k: int = 1,
    sub_width: int = 0,
) -> torch.Tensor:
    """``table[ids] += deltas`` in place, duplicates pre-combined; masked
    and out-of-range lanes are dropped.  Returns ``table``.

    ``sub_width > 0``: ``table`` holds lane-packed physical rows, ``ids``
    are LOGICAL ids of ``sub_k`` rows of ``sub_width`` per physical row,
    and ``deltas`` are (n, sub_width) logical rows."""
    rows = table.shape[0]
    if sub_width:
        dim, logical_cap = sub_width, rows * sub_k
    else:
        dim, logical_cap = math.prod(table.shape[1:]), rows
    s_ids, s_deltas = sort_lanes(ids, deltas.reshape(-1, dim), mask, logical_cap, table.dtype)
    sorted_scatter_add(table.view(rows, -1), s_ids, s_deltas, sub_k=sub_k)
    return table


def sort_lanes(
    ids: torch.Tensor, deltas: torch.Tensor, mask: Optional[torch.Tensor],
    logical_cap: int, dtype: torch.dtype,
):
    """The kernel's inputs: dropped lanes (masked, negative, or past
    ``logical_cap``) become zero deltas on the last row, then the lanes are
    sorted by id (stable).  Returns int32 ids and ``dtype`` deltas."""
    flat_ids = ids.reshape(-1).to(torch.int64)
    drop = (flat_ids < 0) | (flat_ids >= logical_cap)
    if mask is not None:
        drop = drop | ~mask.reshape(-1)
    work_ids = torch.where(drop, logical_cap - 1, flat_ids)
    deltas = torch.where(drop.unsqueeze(1), torch.zeros_like(deltas), deltas)
    order = torch.argsort(work_ids, stable=True)
    return work_ids[order].to(torch.int32), deltas[order].to(dtype).contiguous()


__all__ = ["scatter_add", "sort_lanes", "sorted_scatter_add", "run_sum_write_plain", "acc_dtype"]
