"""Duplicate-compressing scatter-add in plain torch: sort, segment-sum, one
add per UNIQUE row.

Counterpart of ``flink_parameter_server_tpu/ops/sorted_scatter.py`` (the
``scatter_impl="xla_sorted"`` arm).  The reference built it to stop XLA
serializing the read-modify-write of duplicate rows; here it is the
plain-torch arm of the same semantics, beside the plain row scatter-add
(``"xla"``) and the CUDA kernel (``"pallas"``).  Empty segment slots get
distinct out-of-range row ids, which the drop-mode add discards.

The segment sum goes through ``ops/rows.accumulate_rows_``, so its sums
are the same bits on every run on the card too.  Unlike the reference,
which is functional, this updates ``table`` in
place and returns it (the port's step owns its table, as a donated
buffer does under ``jit``).
"""
from __future__ import annotations

from typing import Optional

import torch

from .rows import accumulate_rows_, add_rows_

_INT32_MAX = 2**31 - 1


def sorted_dedup_scatter_add(
    table: torch.Tensor,
    ids: torch.Tensor,
    deltas: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    oob: Optional[int] = None,
    ids_sorted: bool = False,
) -> torch.Tensor:
    """``table[ids] += deltas`` with duplicates pre-combined, in place.

    ``ids``: (n,) ints; values >= ``oob`` (default: the table's rows) and
    masked lanes are dropped.  ``ids_sorted=True`` is the caller's promise
    that ``ids`` is ascending as given (negatives, if any, at the front):
    the sort is skipped, invalid lanes become zero-adds on a clipped row.
    """
    rows = table.shape[0]
    if oob is None:
        oob = rows
    n = ids.shape[0]
    if oob < rows:
        raise ValueError(f"oob={oob} must be >= table rows ({rows})")
    if oob + n - 1 > _INT32_MAX:
        raise ValueError(f"oob + n - 1 = {oob + n - 1} overflows int32 id space")
    ids = ids.to(torch.int64)
    vshape = (1,) * (deltas.ndim - 1)
    if ids_sorted:
        invalid = ids < 0
        if mask is not None:
            invalid = invalid | ~mask
        sdl = torch.where(invalid.reshape(-1, *vshape), torch.zeros_like(deltas), deltas)
        sid = ids.clamp(0, oob)
    else:
        if mask is not None:
            ids = torch.where(mask, ids, oob)
        ids = torch.where((ids < 0) | (ids > oob), oob, ids)
        order = torch.argsort(ids, stable=True)
        sid = ids[order]
        sdl = deltas[order]

    first = torch.ones_like(sid, dtype=torch.bool)
    first[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    sums = accumulate_rows_(torch.zeros_like(sdl), seg, sdl)
    # representative row per segment slot; empty slots stay out of range
    rep = oob + torch.arange(n, dtype=torch.int64, device=ids.device)
    rep[seg] = sid
    return add_rows_(table, rep, sums)


__all__ = ["sorted_dedup_scatter_add"]
