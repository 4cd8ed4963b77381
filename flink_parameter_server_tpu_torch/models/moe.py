"""Mixture-of-experts layer: top-1 switch routing with per-expert capacity.

Counterpart of ``flink_parameter_server_tpu/models/moe.py``: the
single-device path (:func:`moe_dense`), its dense test oracle
(:func:`moe_reference`) and expert parallelism over an ``ep`` mesh axis
(:func:`moe_apply`: the experts split over ``ep``, tokens routed to their
expert's rank and back with two ``all_to_all`` trips).  The expert FFNs are
batched products (``torch.matmul`` over the expert dimension), the same on
the card and the CPU.

Semantics (the reference's):

  * gate: ``softmax(x @ w_gate)`` in float32 over a product in the model's
    dtype; each token goes to its argmax expert (ties to the lowest index),
    its output scaled by the gate probability,
  * each expert processes at most ``capacity`` tokens per shard of tokens
    (first-come in token order); overflow tokens contribute nothing (the
    residual carries them),
  * the shard is what one call routes: the whole batch for
    :func:`moe_dense`, this rank's dp rows for :func:`moe_apply`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..parallel.collectives import all_to_all
from ..parallel.mesh import axis_index, axis_size, mesh_device
from ..utils.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    num_experts: int
    capacity: int  # max tokens PER EXPERT per shard of tokens (moe_dense: the batch; moe_apply: a dp shard)
    dtype: torch.dtype = torch.float32


def _require_device_mesh(mesh: Any, what: str) -> None:
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"{what} takes a torch DeviceMesh (parallel.mesh.make_mesh), got {type(mesh).__name__}")


def local_experts(num_experts: int, mesh: Any, ep_axis: str = "ep") -> slice:
    """The experts this rank holds on ``mesh``: ``[r·E/ep, (r+1)·E/ep)``
    for ep rank r (all of them without an ``ep_axis`` axis).  ``E % ep``
    raises, as the reference asserts."""
    ep = axis_size(mesh, ep_axis)
    if num_experts % ep:
        raise ValueError(f"num_experts={num_experts} does not split over {ep_axis}={ep}")
    per = num_experts // ep
    r = axis_index(mesh, ep_axis)
    return slice(r * per, (r + 1) * per)


def init_moe_params(generator: Optional[torch.Generator], cfg: MoEConfig, mesh: Optional[Any] = None,
                    ep_axis: str = "ep", *, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """``w_gate`` (d, E), ``w_up`` (E, d, f), ``w_down`` (E, f, d) on
    ``device`` (``cuda`` by default; with a mesh, this rank's device on
    it): ``N(0, 1)`` float32 draws from ``generator`` (seed 0 on the CPU if
    None) times ``d**-0.5`` (gate, up) and ``f**-0.5`` (down), cast to
    ``cfg.dtype`` — the reference's shapes, scales and dtypes, not its
    random keys.

    With a ``mesh`` that has ``ep_axis``, ``w_up`` and ``w_down`` are this
    rank's experts only (:func:`local_experts`): every rank draws the whole
    tensors from the same generator and keeps its slice, so the ranks'
    generator streams stay aligned, as the reference draws and then places
    the leaves over ``ep``.  ``w_gate`` is whole on every rank."""
    if mesh is not None:
        _require_device_mesh(mesh, "init_moe_params")
        device = mesh_device(mesh) if device is None else device
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    mine = local_experts(cfg.num_experts, mesh, ep_axis)

    def normal(shape, scale, keep=slice(None)):
        w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32) * scale
        return w[keep].to(dev, cfg.dtype).contiguous()

    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {
        "w_gate": normal((d, E), d**-0.5),
        "w_up": normal((E, d, f), d**-0.5, mine),
        "w_down": normal((E, f, d), f**-0.5, mine),
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


def _bucket(x: torch.Tensor, expert, slot, keep, E: int, C: int) -> torch.Tensor:
    """The (E, C, d) buckets: kept token t at ``(expert[t], slot[t])``,
    zeros elsewhere.

    The reference scatters dropped tokens as zeros into bucket
    ``(E-1, clip(slot))`` with an add, so a kept token there survives.
    Here every dropped token goes to one spare row past the buckets
    instead, and the buckets are filled with an add onto zeros: each kept
    (expert, slot) pair is unique, so each bucket row is exactly its
    token, and a dropped token can never overwrite a kept one."""
    dest = torch.where(keep, expert * C + slot, torch.full_like(slot, E * C))  # the spare row E*C
    kept = torch.where(keep[:, None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    rows = torch.zeros((E * C + 1, x.shape[1]), dtype=x.dtype, device=x.device).index_add(0, dest, kept)
    return rows[: E * C].reshape(E, C, x.shape[1])


def _unbucket(y: torch.Tensor, expert, slot, keep, gate, C: int) -> torch.Tensor:
    """Token t reads row ``(expert[t], slot[t])`` of the (E·C, d) expert
    outputs, gated; dropped tokens get 0."""
    out = y[torch.where(keep, expert * C + slot, torch.zeros_like(slot))]
    return torch.where(keep[:, None], out * gate[:, None], torch.zeros((), dtype=y.dtype, device=y.device))


def moe_dense(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Single-device MoE: bucket tokens per expert (:func:`_bucket`), one
    batched FFN over the (E, C, d) buckets — 1× FLOPs plus capacity
    padding.  ``x`` (N, d); returns the gated expert outputs (0 for dropped
    tokens), to add to the residual stream."""
    E, C, d = cfg.num_experts, cfg.capacity, cfg.d_model
    expert, slot, keep, gate = _route(x, params["w_gate"], E, C)
    buckets = _bucket(x, expert, slot, keep, E, C)
    y = _expert_ffn(params["w_up"], params["w_down"], buckets).reshape(E * C, d)
    return _unbucket(y, expert, slot, keep, gate, C)


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


class _EpCopies(torch.autograd.Function):
    """Identity forward; the backward divides the gradient by ``ep``."""

    @staticmethod
    def forward(ctx, w, ep):
        ctx.ep = ep
        return w.view_as(w)

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.ep, None


def moe_apply(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: MoEConfig, *, mesh,
              ep_axis: str = "ep", dp_axis: Optional[str] = "dp") -> torch.Tensor:
    """Expert-parallel MoE FFN, what the reference's ``shard_map`` body runs
    on each rank.  ``x`` (N, d) is this rank's token shard (its dp rows,
    the same on every ep rank of a dp row, as the reference replicates
    ``x`` over ``ep``); ``params`` hold ``w_gate`` whole and this rank's
    ``E/ep`` experts of ``w_up`` / ``w_down`` (:func:`init_moe_params` with
    the mesh).  Returns the gated expert outputs for ``x``'s tokens (0 for
    dropped ones), to add to the residual stream.  ``cfg.capacity`` counts
    per shard: N tokens.  ``dp_axis`` is accepted for the reference's
    signature; the tokens are already this rank's.  On a mesh with tp or
    sp beside ep, each (tp, sp) coordinate has its own ep group, whose
    ranks all hold the dp shard's whole tokens (the LM gathers a rank's
    positions over sp first): each expert's owner then runs identical
    copies of its buckets on its tp and sp peers, as the reference's
    layout does.

    The rank routes its tokens, buckets them into (E, C, d) (the spare-row
    bucketing of :func:`moe_dense`), and the dispatch trip
    (:func:`~..parallel.collectives.all_to_all` over ``ep``) sends bucket
    group j, shaped (E/ep, C, d), to ep rank j.  Each rank runs its local
    experts over every sender's buckets, (ep, E/ep, C, d), the return trip
    sends each sender its outputs back, and the rank unbuckets and gates.

    Gradients: the ep ranks of a dp row hold the same tokens and each
    back-propagates the same loss, so a rank's experts receive ``ep``
    identical copies of their buckets' cotangents through the return trip
    and would sum them to ``ep`` times the dp row's gradient.  The
    reference's ``shard_map`` transpose divides the cotangent of an output
    replicated over ``ep``; here the division by ``ep`` sits on the expert
    weights, the only leaves the copies reach.  A token's own gradient
    comes back to its sender once from each expert's owner, and the gate's
    is the rank's own: both are right as they are.  So every leaf's
    gradient is the dp row's, to be summed over ``dp`` only."""
    _require_device_mesh(mesh, "moe_apply")
    if ep_axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"moe_apply: ep_axis={ep_axis!r} not in mesh axes {tuple(mesh.mesh_dim_names or ())}")
    E, C, d = cfg.num_experts, cfg.capacity, cfg.d_model
    ep = axis_size(mesh, ep_axis)
    mine = local_experts(E, mesh, ep_axis)
    e_local = mine.stop - mine.start
    if tuple(params["w_up"].shape[:1]) != (e_local,):
        raise ValueError(f"w_up holds {params['w_up'].shape[0]} experts; this rank's share is E/ep={e_local}")
    expert, slot, keep, gate = _route(x, params["w_gate"], E, C)
    buckets = _bucket(x, expert, slot, keep, E, C)
    # dispatch: (ep, E/ep, C, d) -> sender s's buckets for this rank's experts
    dispatched = all_to_all(buckets.reshape(ep, e_local, C, d), mesh, ep_axis)
    w_up, w_down = params["w_up"], params["w_down"]
    if ep > 1:
        w_up, w_down = _EpCopies.apply(w_up, ep), _EpCopies.apply(w_down, ep)
    y = _expert_ffn(w_up, w_down, dispatched)  # (ep, E/ep, C, d)
    # return trip: each sender gets its buckets' outputs from every owner
    returned = all_to_all(y, mesh, ep_axis).reshape(E * C, d)
    return _unbucket(returned, expert, slot, keep, gate, C)


__all__ = [
    "MoEConfig",
    "init_moe_params",
    "local_experts",
    "moe_apply",
    "moe_dense",
    "moe_reference",
]
