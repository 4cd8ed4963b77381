"""Mixture-of-experts layer: top-1 switch routing with per-expert capacity.

Counterpart of ``flink_parameter_server_tpu/models/moe.py``, single-device:
the mesh-less path the transformer takes (:func:`moe_dense`) and its dense
test oracle (:func:`moe_reference`).  Expert parallelism over an ``ep`` axis
(the reference's ``moe_apply``, two ``all_to_all`` trips) is multi-device
work and raises until ROADMAP Queue 1 #9.  The expert FFNs are batched
products (``torch.matmul`` over the expert dimension), the same on the card
and the CPU.

Semantics (the reference's):

  * gate: ``softmax(x @ w_gate)`` in float32 over a product in the model's
    dtype; each token goes to its argmax expert (ties to the lowest index),
    its output scaled by the gate probability,
  * each expert processes at most ``capacity`` tokens (first-come in token
    order); overflow tokens contribute nothing (the residual carries them),
  * one card is one shard: ``capacity`` counts over the whole batch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..utils.device import MODEL_PARALLEL, DeviceLike, reject_mesh, resolve_device


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    num_experts: int
    capacity: int  # max tokens PER EXPERT per device shard (one card: the batch)
    dtype: torch.dtype = torch.float32


def init_moe_params(generator: Optional[torch.Generator], cfg: MoEConfig, mesh: Optional[Any] = None, *,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """``w_gate`` (d, E), ``w_up`` (E, d, f), ``w_down`` (E, f, d) on
    ``device`` (``cuda`` by default): ``N(0, 1)`` float32 draws from
    ``generator`` (seed 0 on the CPU if None) times ``d**-0.5`` (gate, up)
    and ``f**-0.5`` (down), cast to ``cfg.dtype`` — the reference's shapes,
    scales and dtypes, not its random keys."""
    reject_mesh(mesh, "expert parallelism")
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32) * scale
        return w.to(dev, cfg.dtype)

    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {
        "w_gate": normal((d, E), d**-0.5),
        "w_up": normal((E, d, f), d**-0.5),
        "w_down": normal((E, f, d), f**-0.5),
    }


def _route(x: torch.Tensor, w_gate: torch.Tensor, num_experts: int, capacity: int):
    """Top-1 routing with per-expert capacity, deterministic in token
    order.  Returns (expert_idx, slot, keep_mask, gate_prob) per token."""
    logits = x @ w_gate.to(x.dtype)  # (N, E)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    expert = torch.argmax(probs, dim=-1)  # (N,), the first maximum
    gate = torch.gather(probs, 1, expert[:, None])[:, 0]
    # slot of each token within its expert bucket = running count of
    # earlier tokens routed to the same expert
    onehot = F.one_hot(expert, num_experts)  # (N, E) int64
    slot = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=-1) - 1  # (N,) 0-based
    keep = slot < capacity
    return expert, slot, keep, gate.to(x.dtype)


def _expert_ffn(w_up: torch.Tensor, w_down: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``gelu(tokens @ w_up) @ w_down`` (tanh GELU, ``jax.nn.gelu``'s
    default); batched over a leading expert dimension when there is one."""
    return F.gelu(tokens @ w_up, approximate="tanh") @ w_down


def moe_dense(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Single-device MoE: bucket tokens per expert, one batched FFN over
    the (E, C, d) buckets — 1× FLOPs plus capacity padding.  ``x`` (N, d);
    returns the gated expert outputs (0 for dropped tokens), to add to the
    residual stream.

    The reference scatters dropped tokens as zeros into bucket
    ``(E-1, clip(slot))`` with an add, so a kept token there survives.
    Here every dropped token goes to one spare row past the buckets
    instead, and the buckets are filled with an add onto zeros: each kept
    (expert, slot) pair is unique, so each bucket row is exactly its
    token, and a dropped token can never overwrite a kept one."""
    E, C, d = cfg.num_experts, cfg.capacity, cfg.d_model
    expert, slot, keep, gate = _route(x, params["w_gate"], E, C)
    dest = torch.where(keep, expert * C + slot, torch.full_like(slot, E * C))  # the spare row E*C
    kept = torch.where(keep[:, None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    rows = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device).index_add(0, dest, kept)
    buckets = rows[: E * C].reshape(E, C, d)
    y = _expert_ffn(params["w_up"], params["w_down"], buckets).reshape(E * C, d)
    out = y[torch.where(keep, expert * C + slot, torch.zeros_like(slot))]
    return torch.where(keep[:, None], out * gate[:, None], torch.zeros((), dtype=x.dtype, device=x.device))


def moe_reference(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Dense single-device oracle with identical routing semantics: every
    expert's FFN over every token, masked to the routed ones."""
    expert, slot, keep, gate = _route(x, params["w_gate"], cfg.num_experts, cfg.capacity)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    out = torch.zeros_like(x)
    for e in range(cfg.num_experts):
        sel = (expert == e) & keep
        y = _expert_ffn(params["w_up"][e], params["w_down"][e], x)
        out = out + torch.where(sel[:, None], y, zero)
    return torch.where(keep[:, None], out * gate[:, None], zero)


def moe_apply(params, x, cfg: MoEConfig, *, mesh, ep_axis: str = "ep", dp_axis: Optional[str] = "dp"):
    """Expert-parallel MoE over an ``ep`` mesh axis: multi-device."""
    raise NotImplementedError(
        f"moe_apply (expert parallelism over an ep mesh axis, two all_to_all "
        f"trips): {MODEL_PARALLEL}; use moe_dense on one device"
    )


__all__ = [
    "MoEConfig",
    "init_moe_params",
    "moe_apply",
    "moe_dense",
    "moe_reference",
]
