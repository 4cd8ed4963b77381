"""Intra-batch duplicate-id counts (device half of the reference's dedup).

Counterpart of ``occurrence_counts`` / ``occurrence_scale`` in
``flink_parameter_server_tpu/ops/dedup.py``.  By default deltas for the
same id SUM within a microbatch; ``occurrence_scale`` gives the
mean-combining alternative (scale each lane by 1/count(id)), which keeps
a Zipf-hot id's step bounded however large the batch.
"""
from __future__ import annotations

from typing import Optional

import torch


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
    ids: torch.Tensor, capacity: int, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """1/count(id) per lane: turns duplicate-id delta *sums* into *means*."""
    return 1.0 / occurrence_counts(ids, capacity, mask)


__all__ = ["occurrence_counts", "occurrence_scale"]
