"""Unsharded causal attention: the parity oracle of the flash kernels.

Counterpart of ``reference_attention`` in
``flink_parameter_server_tpu/parallel/ring_attention.py``.  Ring attention
over a sequence-parallel mesh waits for multi-device support (ROADMAP
Queue 1 #9).  As in the reference, the products and the softmax run in the
inputs' dtype (bfloat16 stays bfloat16).
"""
from __future__ import annotations

import torch


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """Attention on ``(B, T, H, D)`` tensors, ``1/sqrt(D)`` scaled."""
    qh, kh, vh = (x.movedim(2, 1) for x in (q, k, v))
    scores = torch.einsum("bhtd,bhsd->bhts", qh, kh) * (1.0 / q.shape[-1] ** 0.5)
    if causal:
        T = q.shape[1]
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", probs, vh).movedim(1, 2)


__all__ = ["reference_attention"]
