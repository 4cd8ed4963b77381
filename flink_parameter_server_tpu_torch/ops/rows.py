"""Row gather and drop-mode row scatter-add with the reference's index rules.

torch's ``index_select`` and ``index_add_`` raise on the CPU, and assert on
the device, for an index out of range.  The reference's XLA ops do not:
``jnp.take(t, i, axis=0)`` wraps a negative index once and fills rows past
the end with NaN, and ``t.at[i].add(v, mode="drop")`` wraps a negative
index once and drops the rest.  These helpers route every index into
range first, so the port keeps those rules on both devices without a
host round trip.

Duplicate indices add up in a fixed order on both devices.  On a CUDA
tensor ``index_add_`` adds them with atomics, in whatever order the
threads reach them, so two runs of the same float32 step could differ in
the last bits; there the add goes through ``index_put_(accumulate=True)``,
which sorts the indices (a stable sort) and sums each run of equal
indices in that order.  On the CPU ``index_add_`` is already repeatable
(torch lists it as nondeterministic on CUDA only), and stays.
"""
from __future__ import annotations

import torch


def _normalize(idx: torch.Tensor, rows: int):
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + rows, idx)
    valid = (idx >= 0) & (idx < rows)
    return idx.clamp(0, rows - 1), valid


def _expand(valid: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return valid.reshape(valid.shape + (1,) * (like.ndim - valid.ndim))


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, idx, axis=0)``: negatives wrap, rows past the end
    read as NaN (float tables) or the last row (integer tables)."""
    safe, valid = _normalize(idx, table.shape[0])
    out = table.index_select(0, safe.reshape(-1))
    out = out.reshape(tuple(idx.shape) + tuple(table.shape[1:]))
    if table.is_floating_point():
        out = torch.where(_expand(valid, out), out, torch.full_like(out, float("nan")))
    return out


def accumulate_rows_(table: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``table[idx[i]] += values[i]`` in place for in-range int64 ``idx``,
    duplicates summed in the same order on every run.  Returns ``table``."""
    if table.is_cuda:
        return table.index_put_((idx,), values, accumulate=True)
    return table.index_add_(0, idx, values)


def add_rows_(table: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``table.at[idx].add(values, mode="drop")`` in place: negatives wrap,
    the rest out of range add nothing.  Returns ``table``."""
    safe, valid = _normalize(idx, table.shape[0])
    values = values.to(table.dtype).reshape((-1,) + tuple(table.shape[1:]))
    valid = valid.reshape(-1)
    values = torch.where(_expand(valid, values), values, torch.zeros_like(values))
    return accumulate_rows_(table, safe.reshape(-1), values)


__all__ = ["take_rows", "add_rows_", "accumulate_rows_"]
