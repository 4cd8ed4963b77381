"""Intra-batch duplicate-id handling: device counts and host coalescing.

Counterpart of ``flink_parameter_server_tpu/ops/dedup.py``.  By default
deltas for the same id SUM within a microbatch; ``occurrence_scale`` gives
the mean-combining alternative (scale each lane by 1/count(id)), which
keeps a Zipf-hot id's step bounded however large the batch.  The host half
(``coalesce_ids``, ``aggregate_deltas``, ``aggregate_delta_batches``) is
the reference's numpy code unchanged: the cluster client collapses
duplicate ids before a pull or push goes on the wire.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import axis_index, axis_size


def occurrence_counts(
    ids: torch.Tensor, capacity: int, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Per-lane occurrence count of each lane's id within the batch.

    Returns same-shape float32 counts (>= 1).  Negative and out-of-range
    ids count into a sentinel slot and read back as the last id's count,
    as the reference's drop-mode scatter plus clipped gather does."""
    flat = ids.reshape(-1).to(torch.int64)
    routed = torch.where((flat < 0) | (flat >= capacity), capacity, flat)
    ones = torch.ones(flat.shape, dtype=torch.float32, device=flat.device)
    if mask is not None:
        ones = torch.where(mask.reshape(-1), ones, torch.zeros_like(ones))
    table = torch.zeros(capacity + 1, dtype=torch.float32, device=flat.device)
    table.index_add_(0, routed, ones)
    counts = table.index_select(0, routed.clamp(0, capacity - 1))
    return torch.clamp_min(counts, 1.0).reshape(ids.shape)


def occurrence_scale(
    ids: torch.Tensor,
    capacity: int,
    mask: Optional[torch.Tensor] = None,
    *,
    mesh: Any = None,
    axis: str = "dp",
) -> torch.Tensor:
    """1/count(id) per lane: turns duplicate-id delta *sums* into *means*.

    ``mesh``: ``ids`` (and ``mask``) are this rank's contiguous slice,
    along ``axis``, of a batch split over that axis (a train step's dp
    slice).  The counts are then the whole batch's, as on one device: the
    slices are all-gathered in axis order and this rank's lanes read back."""
    if axis_size(mesh, axis) > 1:
        from ..parallel.collectives import all_gather_cat

        n = ids.shape[0]
        start = axis_index(mesh, axis) * n
        counts = occurrence_counts(
            all_gather_cat(ids, mesh, axis), capacity,
            None if mask is None else all_gather_cat(mask, mesh, axis),
        )
        return 1.0 / counts[start:start + n]
    return 1.0 / occurrence_counts(ids, capacity, mask)


# -- host-side coalescing (the cluster client's request combiner) -----------
# The wire-protocol analogue of the combination senders: before a
# microbatch's pulls/pushes go to the network, duplicate ids collapse to
# ONE request per id (a Zipf-hot item can appear hundreds of times per
# batch — sending it hundreds of times would pay the line protocol per
# lane).  These run on the HOST (numpy): the cluster client formats
# text frames from the result, so there is no device round trip to save.


def coalesce_ids(
    ids: np.ndarray, mask: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """``(unique_ids, inverse)``: each valid lane's id appears once in
    ``unique_ids`` (sorted ascending); ``inverse`` maps every input
    lane to its unique slot so pulled values scatter back with
    ``values[inverse]``.  Masked-out lanes map to slot 0 — callers must
    treat those lanes as padding (the store contract already does)."""
    flat = np.asarray(ids).reshape(-1).astype(np.int64)
    if mask is not None:
        m = np.asarray(mask).reshape(-1).astype(bool)
        # padding lanes piggyback on the first valid id (or id 0 for an
        # all-padding batch) so unique_ids never carries a pad-only id
        fill = flat[m][0] if m.any() else np.int64(0)
        flat = np.where(m, flat, fill)
    unique, inverse = np.unique(flat, return_inverse=True)
    return unique.astype(np.int64), inverse.reshape(np.asarray(ids).shape)


def aggregate_deltas(
    ids: np.ndarray,
    deltas: np.ndarray,
    mask: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """``(unique_ids, summed)``: duplicate-id deltas SUMMED per id —
    exactly the store's duplicate semantics (intra-batch duplicates
    combine additively), applied before the bytes hit the wire.  Masked
    lanes contribute nothing.  ``deltas`` is ``(n, *value_shape)`` (or
    ``(n,)`` for scalar stores); the result rows align with
    ``unique_ids``."""
    ids_arr = np.asarray(ids)
    flat_ids = ids_arr.reshape(-1).astype(np.int64)
    d = np.asarray(deltas)
    flat_d = d.reshape((ids_arr.size,) + d.shape[ids_arr.ndim:])
    if mask is not None:
        m = np.asarray(mask).reshape(-1).astype(bool)
        flat_ids = flat_ids[m]
        flat_d = flat_d[m]
    unique, inverse = np.unique(flat_ids, return_inverse=True)
    out = np.zeros((unique.shape[0],) + flat_d.shape[1:], np.float64)
    np.add.at(out, inverse, flat_d.astype(np.float64))
    return unique.astype(np.int64), out.astype(flat_d.dtype)


def aggregate_delta_batches(batches) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`aggregate_deltas` across SEVERAL workers' batches — the
    aggregation tree's combine step (compression/aggregator.py): each
    element of ``batches`` is ``(ids, deltas)`` or ``(ids, deltas,
    mask)``; the result is one ``(unique_ids, summed)`` pair equal to
    aggregating the concatenation (per-id sums are associative — the
    f64 accumulator below makes the combine order immaterial).  Empty
    or ``None`` entries are skipped, so a worker with nothing to push
    this round costs nothing."""
    flat_ids = []
    flat_deltas = []
    for entry in batches:
        if entry is None:
            continue
        ids, deltas = entry[0], entry[1]
        mask = entry[2] if len(entry) > 2 else None
        ids_arr = np.asarray(ids).reshape(-1).astype(np.int64)
        if ids_arr.size == 0:
            continue
        d = np.asarray(deltas)
        d = d.reshape((ids_arr.size,) + d.shape[np.asarray(ids).ndim:])
        if mask is not None:
            m = np.asarray(mask).reshape(-1).astype(bool)
            ids_arr, d = ids_arr[m], d[m]
            if ids_arr.size == 0:
                continue
        flat_ids.append(ids_arr)
        flat_deltas.append(d)
    if not flat_ids:
        return np.empty(0, np.int64), np.empty(0, np.float32)
    all_ids = np.concatenate(flat_ids)
    all_deltas = np.concatenate(flat_deltas)
    return aggregate_deltas(all_ids, all_deltas)


__all__ = [
    "occurrence_counts",
    "occurrence_scale",
    "coalesce_ids",
    "aggregate_deltas",
    "aggregate_delta_batches",
]
