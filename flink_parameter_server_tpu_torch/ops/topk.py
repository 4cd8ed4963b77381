"""Exact top-K maximum-inner-product search over the item table.

Counterpart of ``flink_parameter_server_tpu/ops/topk.py``.  The reference
scores every row with one matrix product and takes ``lax.top_k``; so does
the port, with two differences that keep its answers the reference's:

  * **The product is exact float32.**  ``torch.matmul`` on float32 CUDA
    tensors runs in TF32 when ``torch.backends.cuda.matmul.allow_tf32`` is
    set (a process-wide flag), which keeps 10 bits of each operand and
    would reorder near neighbours.  :func:`dense_topk` multiplies in
    float64 (each float32 product is exact there) and rounds the sums once
    to the result type, whatever the flag says.
  * **Ties break as ``lax.top_k`` breaks them**: equal values come lowest
    index first.  ``torch.topk`` promises no order among equal values, and
    ties are common here: padding rows past ``valid_rows`` and excluded
    lanes are all ``-inf``.  :func:`top_k` ranks a 64-bit key that packs
    each value's float32 bits (order-preserving) above its inverted index,
    so every key is distinct and ``torch.topk`` has one answer.

All functions keep a static ``(B, k)`` output: when fewer than ``k`` rows
exist, the tail is padded with ``-inf`` scores and id ``-1``.  The product
and the selection are plain torch on both devices: the reference computes
them outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..utils.device import check_mesh

_LOW32 = (1 << 32) - 1


def top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: the ``k`` largest values in
    descending order, equal values lowest index first.  Returns (values,
    int64 indices).  The order is IEEE's total order of the float32 values
    (bfloat16 widens exactly), so ``-0.0`` ranks below ``+0.0``."""
    n = scores.shape[-1]
    bits = scores.float().contiguous().view(torch.int32)
    # flip the magnitude bits of negatives: signed int order == float order
    ordered = (bits ^ ((bits >> 31) & 0x7FFFFFFF)).to(torch.int64)
    inv_idx = _LOW32 - torch.arange(n, dtype=torch.int64, device=scores.device)
    _, pos = torch.topk(ordered * (1 << 32) + inv_idx, k, dim=-1)
    return scores.gather(-1, pos), pos


def _pad_topk(scores: torch.Tensor, ids: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad a (B, k_eff) top-k result out to the requested static k."""
    k_eff = scores.shape[-1]
    if k_eff >= k:
        return scores[..., :k], ids[..., :k]
    pad = k - k_eff
    scores = torch.nn.functional.pad(scores, (0, pad), value=float("-inf"))
    ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
    return scores, ids


def dense_topk(
    table: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    *,
    valid_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device exact top-k: one product + :func:`top_k`.

    Returns (scores (B,k), ids (B,k)).  Rows at or past ``valid_rows`` score
    ``-inf`` but keep their row ids; ids are -1 only past the table's rows."""
    # (B, rows) in the promoted type, from float64 sums: no TF32
    out = torch.promote_types(queries.dtype, table.dtype)
    scores = (queries.double() @ table.double().T).to(out)
    rows = table.shape[0]
    if valid_rows is not None and valid_rows < rows:
        pad = torch.arange(rows, device=scores.device) >= valid_rows
        scores = scores.masked_fill(pad.unsqueeze(0), float("-inf"))
    top_scores, top_ids = top_k(scores, min(k, rows))
    return _pad_topk(top_scores, top_ids, k)


def sharded_topk(
    table: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    *,
    mesh: Any,
    ps_axis: str = "ps",
    valid_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a ps-sharded table: needs a device mesh, which the
    single-device port does not have (ROADMAP Queue 1 #9)."""
    check_mesh(mesh)
    raise NotImplementedError(
        "sharded_topk needs a device mesh (ROADMAP Queue 1 #9); use dense_topk"
    )


__all__ = ["top_k", "dense_topk", "sharded_topk"]
