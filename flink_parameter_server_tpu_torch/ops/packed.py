"""Lane-packed table layout: k narrow rows per 128-lane physical row.

Counterpart of ``flink_parameter_server_tpu/ops/packed.py``.  Logical row
``r`` of width ``d < 128`` lives in physical row ``r // k`` at lane offset
``(r % k) * d``, with ``k = 128 // d``.  Packing is a TPU layout (the
vector lane width is 128); the port keeps it so that a packed table from
the JAX package compares with the port's element for element, and so
that ``layout="packed"`` configurations run unchanged.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

LANES = 128


def pack_k(row_width: int) -> int:
    """Logical rows per 128-lane physical row (1 when width >= 128)."""
    if row_width <= 0:
        raise ValueError(f"row width must be positive, got {row_width}")
    return max(1, LANES // row_width)


def phys_width(row_width: int) -> int:
    """Physical lane width: 128 for narrow rows, else the padded width."""
    if row_width >= LANES:
        return ((row_width + LANES - 1) // LANES) * LANES
    return LANES


def phys_rows(capacity: int, row_width: int) -> int:
    """Physical rows needed for ``capacity`` logical rows."""
    k = pack_k(row_width)
    return (capacity + k - 1) // k


def pack_table(values: torch.Tensor, capacity_phys: Optional[int] = None) -> torch.Tensor:
    """(capacity, d) logical values -> (capacity_phys, phys_width) packed."""
    capacity, d = values.shape
    k = pack_k(d)
    w = phys_width(d)
    if capacity_phys is None:
        capacity_phys = phys_rows(capacity, d)
    v = F.pad(values, (0, 0, 0, capacity_phys * k - capacity))
    v = v.reshape(capacity_phys, k * d)
    return F.pad(v, (0, w - k * d))


def unpack_table(packed: torch.Tensor, capacity: int, row_width: int) -> torch.Tensor:
    """(capacity_phys, phys_width) packed -> (capacity, d) logical values."""
    capacity_phys = packed.shape[0]
    k = pack_k(row_width)
    v = packed[:, : k * row_width].reshape(capacity_phys * k, row_width)
    return v[:capacity]


def _lane_cols(ids: torch.Tensor, row_width: int) -> torch.Tensor:
    """(n, d) physical column of each logical lane of each id's row."""
    k = pack_k(row_width)
    base = (ids.to(torch.int64) % k).unsqueeze(1) * row_width
    return base + torch.arange(row_width, device=ids.device).unsqueeze(0)


def packed_pull(packed: torch.Tensor, ids: torch.Tensor, row_width: int) -> torch.Tensor:
    """Gather logical rows ``ids`` (pre-clipped) from the packed table."""
    k = pack_k(row_width)
    ids = ids.to(torch.int64)
    phys_vals = packed.index_select(0, ids // k)  # (n, phys_width)
    if k == 1:
        return phys_vals[:, :row_width]
    return torch.gather(phys_vals, 1, _lane_cols(ids, row_width))


def lane_shift_deltas(deltas: torch.Tensor, ids: torch.Tensor, row_width: int) -> torch.Tensor:
    """(n, d) deltas -> (n, phys_width) rows shifted to their lane offset.

    Row ``i`` carries ``deltas[i]`` at lanes ``[(ids[i] % k) * d, ... + d)``
    and zeros elsewhere — ready to scatter-add at physical-row granularity.
    """
    n, d = deltas.shape
    if d != row_width:
        raise ValueError(f"deltas width {d} != row width {row_width}")
    w = phys_width(d)
    if pack_k(d) == 1:
        return F.pad(deltas, (0, w - d))
    out = torch.zeros((n, w), dtype=deltas.dtype, device=deltas.device)
    return out.scatter_(1, _lane_cols(ids, row_width), deltas)


def lane_unshift(rows: torch.Tensor, ids: torch.Tensor, row_width: int) -> torch.Tensor:
    """Inverse of :func:`lane_shift_deltas`: slice each (phys_width,)
    row back down to the (row_width,) slice at its id's lane offset."""
    if pack_k(row_width) == 1:
        return rows[:, :row_width]
    return torch.gather(rows, 1, _lane_cols(ids, row_width))


def packed_phys_ids(ids: torch.Tensor, row_width: int) -> torch.Tensor:
    """Logical ids -> physical row ids (sorting by these keeps id order).

    Floor division, as the reference's ``//`` on int32: a negative id maps
    to a negative physical row."""
    return torch.div(ids.to(torch.int32), pack_k(row_width), rounding_mode="floor")


__all__ = [
    "LANES",
    "pack_k",
    "phys_width",
    "phys_rows",
    "pack_table",
    "unpack_table",
    "packed_pull",
    "lane_shift_deltas",
    "lane_unshift",
    "packed_phys_ids",
]
