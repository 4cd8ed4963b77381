"""Ring attention over the ``sp`` axis, and the unsharded oracle.

Counterpart of ``flink_parameter_server_tpu/parallel/ring_attention.py``.
The sequence is split over ``sp``: a rank holds one block of T/sp
positions of q, k and v.  ``S − 1`` :func:`..collectives.ppermute` trips
rotate the K/V blocks one rank along the ring while every rank folds its
queries' attention over each block it holds into an online softmax
(running max, denominator and output, all float32), so the T × T score
matrix never exists and a rank holds O((T/sp)²) scores a step.

At rotation ``j`` rank ``i`` holds the K/V of block ``(i − j) mod S``: a
block in the future is fully masked, the diagonal block takes the
triangular mask, a past block none.  Rotation 0 is the rank's own block,
so every query row has a valid key from the first step on.

The reference's dtypes: the scores are ``q kᵀ`` of the inputs with
float32 accumulation (``preferred_element_type=float32``), here the
operands upcast to float32 before the product (the products of bfloat16
values are exact in float32; a bfloat16 torch product would round its
output); ``p`` is rounded to ``v``'s dtype before ``p v``, again summed in
float32; the output is cast back to q's dtype.

The block update is the reference's plain ``einsum``, here plain torch
products: no kernel of the TPU package runs here.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import collectives as _coll
from .mesh import axis_index, axis_size


def _block_update(q, k, v, mask, m, l, o, scale):
    """One online-softmax step on (B, H, T, D) blocks: ``mask`` (T, T) bool
    (True = attend); ``m``, ``l`` (B, H, T) and ``o`` (B, H, T, D) float32."""
    scores = torch.einsum("bhtd,bhsd->bhts", q.to(torch.float32), k.to(torch.float32)) * scale
    scores = scores.masked_fill(~mask, float("-inf"))
    m_new = torch.maximum(m, scores.amax(-1))
    # a row with no valid key yet keeps m = -inf: exp(-inf - -inf) is NaN, so
    # such rows rescale from 0 (they hold nothing to rescale)
    base = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    alpha = torch.exp(m - base)
    p = torch.exp(scores - base[..., None])  # masked scores give exp(-inf) = 0
    l_new = l * alpha + p.sum(-1)
    pv = torch.einsum("bhts,bhsd->bhtd", p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return m_new, l_new, o * alpha[..., None] + pv


def ring_attention_inner(q_blk: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor, *, mesh,
                         sp_axis: str = "sp", causal: bool = True) -> torch.Tensor:
    """The ring schedule on this rank's ``(B, T/sp, H, D)`` blocks (rank
    ``i`` of ``sp_axis`` holds positions ``[i·T/sp, (i+1)·T/sp)``); returns
    this rank's block of the output.  What the reference's ``shard_map``
    body runs: call it on every rank of the axis.  With a ``tp`` axis the
    blocks hold the rank's heads, and each rank runs the ring on them."""
    qh, kh, vh = (x.movedim(2, 1) for x in (q_blk, k_blk, v_blk))
    B, H, T, D = qh.shape
    S, me = axis_size(mesh, sp_axis), axis_index(mesh, sp_axis)
    scale = 1.0 / D**0.5
    m = torch.full((B, H, T), float("-inf"), dtype=torch.float32, device=q_blk.device)
    l = torch.zeros((B, H, T), dtype=torch.float32, device=q_blk.device)
    o = torch.zeros((B, H, T, D), dtype=torch.float32, device=q_blk.device)
    tri = torch.ones(T, T, dtype=torch.bool, device=q_blk.device).tril()
    full = torch.ones_like(tri)
    kv = torch.stack([kh, vh])
    for j in range(S):
        src = (me - j) % S
        mask = full if not causal or src < me else (tri if src == me else ~full)
        # every block is computed, masked or not: each rank's autograd graph
        # must hold the same collectives, so each received block is used
        m, l, o = _block_update(qh, kv[0], kv[1], mask, m, l, o, scale)
        if j < S - 1:  # the last rotation's result would never be read
            kv = _coll.ppermute(kv, mesh, sp_axis, 1)
    out = (o / torch.clamp(l[..., None], min=1e-30)).to(q_blk.dtype)
    return out.movedim(1, 2)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mesh, sp_axis: str = "sp",
                   dp_axis: Optional[str] = "dp", tp_axis: Optional[str] = None,
                   causal: bool = True) -> torch.Tensor:
    """Multi-head attention with the sequence split over ``sp`` (the
    reference's ``ring_attention``).  ``q, k, v`` are the global ``(B, T,
    H, D)`` tensors, the same on every rank: the rank takes its block (B
    over ``dp_axis`` when the mesh has it, T over ``sp_axis``, H over
    ``tp_axis`` when given), runs :func:`ring_attention_inner` on it, and
    the output is the global one, all-gathered.  In the backward every rank
    gets the whole input gradients (:func:`..collectives.take_block`)."""
    cuts = [(dp_axis, 0), (sp_axis, 1), (tp_axis, 2)]
    cuts = [(a, d) for a, d in cuts if a and a in (mesh.mesh_dim_names or ())]
    blocks = []
    for x in (q, k, v):
        for a, d in cuts:
            x = _coll.take_block(x, mesh, a, d)
        blocks.append(x)
    out = ring_attention_inner(*blocks, mesh=mesh, sp_axis=sp_axis, causal=causal)
    for a, d in reversed(cuts):
        out = _coll.gather_block(out, mesh, a, d)
    return out


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """Unsharded attention on ``(B, T, H, D)`` tensors, ``1/sqrt(D)``
    scaled: the parity oracle of the ring and of the flash kernels.  As in
    the reference, the products and the softmax run in the inputs' dtype
    (bfloat16 stays bfloat16)."""
    qh, kh, vh = (x.movedim(2, 1) for x in (q, k, v))
    scores = torch.einsum("bhtd,bhsd->bhts", qh, kh) * (1.0 / q.shape[-1] ** 0.5)
    if causal:
        T = q.shape[1]
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", probs, vh).movedim(1, 2)


__all__ = ["reference_attention", "ring_attention", "ring_attention_inner"]
