"""Decoder-only Transformer LM: the dense data-parallel configuration.

Counterpart of ``flink_parameter_server_tpu/models/transformer.py``
(BASELINE config #5, "Transformer-base LM data-parallel"), trained through
:class:`..core.dense.DenseParameterServer`.  Parameters live in an
``nn.Module`` whose names and layouts are the reference pytree's
(``embed``, ``final_norm``, ``layers[i].{attn_norm, wqkv, wo, mlp_norm,
w_up, w_down}``, or ``layers[i].moe.{w_gate, w_up, w_down}`` in place of
the MLP with ``num_experts > 0``; ``wqkv`` is ``(d, 3d)`` used as
``h @ W``), so weights cross element for element
(``interop.transformer_params_from_numpy``).

Numerics follow the reference: weights and activations in ``cfg.dtype``
(bfloat16 by default), RMSNorm and RoPE in float32, norm gains float32,
tanh-approximated GELU (``jax.nn.gelu``'s default), float32 logits from
the tied embedding.  Attention goes through the flash kernels
(``ops/flash_attention.py``) when eligible, else the O(T²) reference.

With ``num_experts > 0`` every layer's MLP is a switch-MoE layer
(``models/moe.py`` ``moe_dense``: top-1 routing, ``moe_capacity`` tokens an
expert over the whole batch, as the reference's mesh-less path runs it).

**On a mesh** (``mesh=``: a ``DeviceMesh``, one rank a device) each rank
runs the model on ITS rows of the global batch: the ``tokens`` (and a
batch's ``mask``) passed with ``mesh=`` are this rank's ``cfg.dp_axis``
rows, as the dense step cuts them (``parallel.collectives.dp_rows``), and
:func:`forward` returns this rank's logits.  Two layouts
(:func:`check_lm_mesh`):

* **data parallel**: ``cfg.dp_axis`` is the only axis larger than 1.
  Attention never mixes batch rows, so the flash kernels run on the rank's
  rows through ``flash_mha`` (gated by ``eligible_dp``), with no
  collective; a reader of the global logits all-gathers them
  (``parallel.collectives.all_gather_cat``).
* **expert parallel**: the mesh has the ``cfg.ep_axis`` axis (the
  reference's ``("dp", "ep")`` mesh) and no axis but it and ``dp_axis``
  is larger than 1.  The ep ranks of a dp row hold the same rows and the
  same non-expert weights; each holds ``E/ep`` experts of every MoE layer.
  Attention runs the flash kernels on the rank's rows as on the dp mesh
  (``eligible_dp`` with ``cfg.ep_axis``).  The reference's flash gate
  asks for a dp-only mesh and takes its plain attention here; the rows,
  and so the math, are the same.

MoE layers follow the reference's choice, made by the axis NAME:

* ``cfg.ep_axis`` is an axis of the mesh: ``moe_apply`` on the rank's dp
  rows, so ``moe_capacity`` counts each dp shard's tokens;
* a mesh without that axis: ``moe_dense`` over the WHOLE global batch (the
  rank's rows all-gathered over dp, ``parallel.collectives.gather_rows``),
  so ``moe_capacity`` counts the global batch's tokens as the mesh-less
  run does, and the rank keeps its rows of the output.

:func:`lm_loss` divides the masked token sum by the WHOLE batch's count of
valid tokens (``parallel.collectives.global_mean``: one all-reduce of the
pair over dp), so ranks whose rows hold different counts weight them as the
unsharded loss does.  Ring attention and tensor / sequence / pipeline
parallelism raise: they are the next port slice (ROADMAP Queue 1 #9b).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import flash_attention as _flash
from ..parallel.ring_attention import reference_attention
from ..parallel import collectives as _coll
from ..parallel.mesh import axis_size, mesh_device, require_axis
from ..utils.device import MODEL_PARALLEL, DeviceLike, resolve_device

MOE_KEYS = ("w_gate", "w_up", "w_down")  # layers[i].moe's leaves


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 2048
    max_seq: int = 1024
    dtype: torch.dtype = torch.bfloat16
    use_ring_attention: bool = False
    # "auto": the flash kernels when eligible (a CUDA tensor, T % 128 == 0,
    # head_dim % 64 == 0, no mesh or one whose axes larger than 1 are dp and
    # ep; a head width the kernels lack raises), else the reference path;
    # "on": the kernels or an error; "off": always the reference path
    flash_attention: str = "auto"
    # recompute each block in the backward pass (activation memory per
    # layer O(T·d_model) instead of O(T·d_ff))
    remat: bool = False
    # the reference's parallelism and MoE fields: dp_axis names the data
    # axis of a mesh, ep_axis the experts' axis; tp / sp / pp raise
    # (__post_init__)
    dp_axis: Optional[str] = "dp"
    tp_axis: Optional[str] = None
    sp_axis: Optional[str] = None
    pp_axis: Optional[str] = None
    num_experts: int = 0
    ep_axis: Optional[str] = None
    moe_capacity: int = 0

    def __post_init__(self):
        if self.flash_attention not in ("auto", "on", "off"):
            raise ValueError(
                f"flash_attention must be 'auto', 'on' or 'off', got {self.flash_attention!r}"
            )
        if self.num_experts > 0 and self.moe_capacity <= 0:
            raise ValueError(
                "num_experts > 0 requires moe_capacity > 0 (capacity 0 would drop every token)"
            )
        if self.use_ring_attention or self.sp_axis or self.tp_axis or self.pp_axis:
            raise NotImplementedError(f"ring attention and tp/sp/pp: {MODEL_PARALLEL}")

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of n_heads {self.n_heads}")
        return self.d_model // self.n_heads


class TransformerBlock(nn.Module):
    """One pre-norm residual block's parameters: attention, and either a
    dense MLP (``w_up``, ``w_down``) or a switch-MoE layer (``moe``: a dict
    of ``w_gate``, ``w_up``, ``w_down``)."""

    def __init__(self, attn_norm, wqkv, wo, mlp_norm, w_up=None, w_down=None, moe=None):
        super().__init__()
        self.attn_norm = nn.Parameter(attn_norm)
        self.wqkv = nn.Parameter(wqkv)
        self.wo = nn.Parameter(wo)
        self.mlp_norm = nn.Parameter(mlp_norm)
        if (moe is None) == (w_up is None or w_down is None):
            raise ValueError("a block takes either w_up and w_down or moe")
        if moe is None:
            self.w_up = nn.Parameter(w_up)
            self.w_down = nn.Parameter(w_down)
        else:
            self.moe = nn.ParameterDict({k: nn.Parameter(moe[k]) for k in MOE_KEYS})


class TransformerLM(nn.Module):
    """The LM's parameters; ``model(tokens)`` is :func:`forward`."""

    def __init__(self, cfg: TransformerConfig, embed: torch.Tensor, final_norm: torch.Tensor,
                 layers: List[Dict[str, torch.Tensor]]):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(embed)
        self.final_norm = nn.Parameter(final_norm)
        self.layers = nn.ModuleList(TransformerBlock(**layer) for layer in layers)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens, self.cfg)


def _moe_config(cfg: TransformerConfig):
    from .moe import MoEConfig

    return MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff, num_experts=cfg.num_experts,
                     capacity=cfg.moe_capacity, dtype=cfg.dtype)


def _ep_on(mesh: Any, cfg: TransformerConfig) -> bool:
    """The reference's choice of ``moe_apply``: ``cfg.ep_axis`` names an
    axis of the mesh (of any size)."""
    return mesh is not None and bool(cfg.ep_axis) and cfg.ep_axis in (mesh.mesh_dim_names or ())


def check_lm_mesh(mesh: Any, cfg: TransformerConfig) -> None:
    """Accept a ``DeviceMesh`` with the ``cfg.dp_axis`` axis whose axes
    larger than 1 are among ``cfg.dp_axis`` and ``cfg.ep_axis`` (the
    data-parallel mesh, or the ``("dp", "ep")`` one), with or without MoE
    layers.  A mesh without that axis raises ``ValueError``; another
    layout (tp / sp / pp) ``NotImplementedError``."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise NotImplementedError(
            f"the LM over a {type(mesh).__name__} mesh: the port's LM takes a DeviceMesh "
            f"(parallel.mesh.make_mesh); {MODEL_PARALLEL}"
        )
    require_axis(mesh, cfg.dp_axis, "the LM over a mesh")
    allowed = {cfg.dp_axis} | ({cfg.ep_axis} if cfg.ep_axis else set())
    if any(int(k) > 1 and n not in allowed for n, k in zip(mesh.mesh_dim_names, mesh.shape)):
        raise NotImplementedError(
            f"the LM over mesh axes {dict(zip(mesh.mesh_dim_names, mesh.shape))}: only "
            f"{sorted(allowed)} may be larger than 1; {MODEL_PARALLEL}"
        )


def record_layout(model: "TransformerLM", mesh: Any, cfg: TransformerConfig) -> "TransformerLM":
    """Record the model-parallel layout of a model built for ``mesh``
    (``core.dense.set_model_layout``) and return it: on a mesh with
    ``cfg.ep_axis`` each MoE layer's ``w_up`` and ``w_down`` are split over
    that axis on their expert axis (the reference's ``param_shardings``:
    ``P(ep, None, None)``); nothing else is split.  ZeRO-1's and FSDP's
    specs merge dp into it; ``gather_params`` gathers those leaves whole."""
    if not _ep_on(mesh, cfg) or cfg.num_experts == 0:
        return model
    from ..core.dense import set_model_layout

    specs = {name: (cfg.ep_axis, None, None) for name, _ in model.named_parameters()
             if name.endswith(("moe.w_up", "moe.w_down"))}
    return set_model_layout(model, mesh, specs)


def init_params(cfg: TransformerConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None, *, mesh: Optional[Any] = None) -> TransformerLM:
    """A freshly initialised LM on ``device`` (``cuda`` by default; with a
    ``mesh``, this rank's device on it).  Every rank draws the same
    weights from the same ``generator`` seed, so the model is replicated
    over dp; on a mesh with ``cfg.ep_axis`` each rank keeps its experts
    of every MoE layer (``init_moe_params(mesh=)``: the whole tensors are
    drawn on every rank, so the streams stay aligned) and the model
    records that layout (:func:`record_layout`).

    The reference's shapes, scales and dtypes: weights ``N(0, 1)`` in
    float32 times ``d**-0.5`` (wqkv, w_up), ``(2·n_layers·d)**-0.5`` (wo),
    ``(2·n_layers·f)**-0.5`` (w_down) and 0.02 (the tied embedding), cast
    to ``cfg.dtype``; norm gains float32 ones; with ``num_experts > 0``
    each layer's MLP is ``init_moe_params``' (gate and up ``d**-0.5``, down
    ``f**-0.5``).  The draws come from ``generator`` (seed 0 on the CPU if
    None), not from JAX's keys."""
    if mesh is not None:
        check_lm_mesh(mesh, cfg)
        device = mesh_device(mesh) if device is None else device
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    d, f = cfg.d_model, cfg.d_ff

    def dense(shape, scale):
        w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32) * scale
        return w.to(dev, cfg.dtype)

    def ones():
        return torch.ones(d, dtype=torch.float32, device=dev)

    def mlp():
        if cfg.num_experts > 0:
            from .moe import init_moe_params

            ep_mesh = mesh if _ep_on(mesh, cfg) else None
            return dict(moe=init_moe_params(gen, _moe_config(cfg), ep_mesh, cfg.ep_axis or "ep", device=dev))
        return dict(w_up=dense((d, f), d**-0.5), w_down=dense((f, d), (2 * cfg.n_layers * f) ** -0.5))

    embed = dense((cfg.vocab_size, d), 0.02)
    layers = [
        dict(
            attn_norm=ones(),
            wqkv=dense((d, 3 * d), d**-0.5),
            wo=dense((d, d), (2 * cfg.n_layers * d) ** -0.5),
            mlp_norm=ones(),
            **mlp(),
        )
        for _ in range(cfg.n_layers)
    ]
    return record_layout(TransformerLM(cfg, embed, ones(), layers), mesh, cfg)


def _rmsnorm(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
    return (xf * scale * gain).to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary position embedding on (B, T, H, D), half-split (not interleaved)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(0, half, dtype=torch.float32, device=x.device) / half))
    angles = positions[:, :, None, None].to(torch.float32) * freqs  # B, T, 1, half
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _unsharded_attention(q, k, v, cfg: TransformerConfig, mesh: Optional[Any] = None) -> torch.Tensor:
    """The flash kernels when eligible (see TransformerConfig.flash_attention),
    else the O(T²) reference.  Without a mesh the gate is ``eligible``; on a
    dp or ``("dp", "ep")`` mesh ``eligible_dp`` over the global batch (``q``
    holds this rank's rows), and the kernels run on the rank's rows."""
    T, Dh = q.shape[1], q.shape[3]
    if cfg.flash_attention == "off":
        return reference_attention(q, k, v)
    if mesh is None:
        if _flash.eligible(T, Dh, q.device):
            return _flash.flash_mha(q, k, v)
    elif _flash.eligible_dp(T, Dh, q.shape[0] * axis_size(mesh, cfg.dp_axis), mesh, cfg.dp_axis, cfg.ep_axis):
        return _flash.flash_mha(q, k, v)
    if cfg.flash_attention == "on":
        # "on" means the kernels or an error: a quiet reference fallback
        # would mislabel measurements
        raise ValueError(
            f"flash_attention='on' but the flash path is ineligible (device={q.device}, "
            f"T={T}, head_dim={Dh}); flash needs a CUDA tensor, T % 128 == 0, "
            f"head_dim % 64 == 0 and no mesh or a mesh whose axes larger than 1 are "
            f"dp and ep, dp dividing the batch. "
            f"Use 'auto' to fall back gracefully."
        )
    return reference_attention(q, k, v)


def _apply_block(x: torch.Tensor, layer: TransformerBlock, cfg: TransformerConfig,
                 mesh: Optional[Any] = None) -> torch.Tensor:
    """One pre-norm residual block (attention + MLP) on (B, T, d)."""
    B, T, _ = x.shape
    H, Dh = cfg.n_heads, cfg.head_dim
    positions = torch.arange(T, dtype=torch.int32, device=x.device)[None].expand(B, T)
    h = _rmsnorm(x, layer.attn_norm)
    qkv = (h @ layer.wqkv).reshape(B, T, 3, H, Dh)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    q = _rope(q, positions)
    k = _rope(k, positions)
    attn = _unsharded_attention(q, k, v, cfg, mesh).reshape(B, T, H * Dh)
    x = x + attn @ layer.wo
    h = _rmsnorm(x, layer.mlp_norm)
    if cfg.num_experts > 0:
        return x + _moe_mlp(layer, h, cfg, mesh)
    return x + F.gelu(h @ layer.w_up, approximate="tanh") @ layer.w_down


def _moe_mlp(layer: TransformerBlock, h: torch.Tensor, cfg: TransformerConfig, mesh: Optional[Any]) -> torch.Tensor:
    """The MoE layer on this rank's (B, T, d) rows, by the reference's
    rule: ``moe_apply`` per dp shard when ``cfg.ep_axis`` is a mesh axis,
    else ``moe_dense`` over the whole global batch (the rows gathered over
    dp, the rank's rows of the output kept; :func:`gather_rows`'s backward
    takes the rank's rows, exact here because a token's output depends
    only on that token and the weights once the routing is fixed)."""
    from .moe import moe_apply, moe_dense

    B, T, d = h.shape
    flat = h.reshape(B * T, d)
    if _ep_on(mesh, cfg):
        y = moe_apply(layer.moe, flat, _moe_config(cfg), mesh=mesh, ep_axis=cfg.ep_axis)
    elif mesh is not None and axis_size(mesh, cfg.dp_axis) > 1:
        whole = moe_dense(layer.moe, _coll.gather_rows(flat, mesh, cfg.dp_axis), _moe_config(cfg))
        y = _coll.dp_rows(whole, mesh, cfg.dp_axis)
    else:
        y = moe_dense(layer.moe, flat, _moe_config(cfg))
    return y.reshape(B, T, d)


def forward(params: TransformerLM, tokens: torch.Tensor, cfg: TransformerConfig, *,
            mesh: Optional[Any] = None) -> torch.Tensor:
    """Causal LM forward: (B, T) int tokens -> (B, T, vocab) float32 logits.
    With a dp ``mesh``, ``tokens`` and the logits are this rank's rows."""
    if mesh is not None:
        check_lm_mesh(mesh, cfg)
    tokens = torch.as_tensor(tokens, device=params.embed.device)
    T = tokens.shape[1]
    if T > cfg.max_seq:
        raise ValueError(f"sequence length {T} > max_seq {cfg.max_seq}")
    x = params.embed[tokens.long()]
    for layer in params.layers:
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(_apply_block, x, layer, cfg, mesh, use_reentrant=False)
        else:
            x = _apply_block(x, layer, cfg, mesh)
    x = _rmsnorm(x, params.final_norm)
    return (x @ params.embed.T.to(x.dtype)).to(torch.float32)


def next_token_xent(logits: torch.Tensor, tokens: torch.Tensor,
                    row_mask: Optional[torch.Tensor] = None, *, mesh: Optional[Any] = None,
                    dp_axis: str = "dp") -> torch.Tensor:
    """Next-token cross entropy: targets are the tokens shifted left, the
    last position is masked; optional (B,) or (B, T) row mask.  With a dp
    ``mesh`` the arguments are this rank's rows and the result is the whole
    batch's loss: the masked sum over the count of valid tokens of every
    rank (``parallel.collectives.global_mean``)."""
    tokens = torch.as_tensor(tokens, device=logits.device).long()
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    mask = torch.ones_like(nll)
    mask[:, -1] = 0.0
    if row_mask is not None:
        row_mask = torch.as_tensor(row_mask, device=logits.device).to(nll.dtype)
        if row_mask.ndim == 1:  # (B,) row mask from microbatches()
            row_mask = row_mask[:, None]
        mask = mask * row_mask
    if mesh is not None:
        return _coll.global_mean(torch.sum(nll * mask), torch.sum(mask), mesh, dp_axis)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def lm_loss(params: TransformerLM, batch: Dict[str, Any], cfg: TransformerConfig, *,
            mesh: Optional[Any] = None) -> torch.Tensor:
    """Next-token cross entropy through :func:`forward`.  With a dp
    ``mesh`` the batch holds this rank's rows (the dense step passes them)
    and the loss is the whole batch's (:func:`next_token_xent`)."""
    tokens = batch["tokens"]
    logits = forward(params, tokens, cfg, mesh=mesh)
    return next_token_xent(logits, tokens, batch.get("mask"), mesh=mesh, dp_axis=cfg.dp_axis)


__all__ = [
    "MOE_KEYS",
    "TransformerConfig",
    "TransformerBlock",
    "TransformerLM",
    "check_lm_mesh",
    "init_params",
    "record_layout",
    "forward",
    "next_token_xent",
    "lm_loss",
]
