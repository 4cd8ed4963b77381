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
runs the model on ITS share of the global batch: the ``tokens`` (and a
batch's ``mask``) passed with ``mesh=`` are this rank's ``cfg.dp_axis``
rows at full length, as the dense step cuts them
(``parallel.collectives.dp_rows``), and :func:`forward` returns this
rank's logits.  The layouts (:func:`check_lm_mesh`), each named by the
config's axis fields, and any mix of them:

* **data parallel** (``cfg.dp_axis``): attention never mixes batch rows,
  so the flash kernels run on the rank's rows (gated by ``eligible_dp``),
  with no collective; a reader of the global logits all-gathers them
  (``parallel.collectives.all_gather_cat``).
* **expert parallel** (``cfg.ep_axis``, the reference's ``("dp", "ep")``
  mesh): the ep ranks of a dp row hold the same rows and the same
  non-expert weights; each holds ``E/ep`` experts of every MoE layer.  It
  composes with tp and sp: the experts split over ep, the attention over
  tp or along the ring.
* **tensor parallel** (``cfg.tp_axis``, Megatron's layout, the reference's
  ``param_shardings``): ``wqkv`` and ``w_up`` column-parallel, ``wo`` and
  ``w_down`` row-parallel, the rest replicated.  A rank holds whole heads,
  ``H/tp`` of them: its columns of each of q, k and v (so its ``wqkv`` is
  ``(d, 3d/tp)``, ``[q | k | v]`` of its heads; the reference's
  ``P(None, "tp")`` names the layout, GSPMD cuts it), the matching rows of
  ``wo``, and ``d_ff/tp`` of the MLP.  The block is ``copy_to_tp`` →
  local ``qkv`` → RoPE → attention on the rank's heads → local ``wo`` →
  ``reduce_from_tp``, the MLP the same way.  Attention never mixes heads,
  so the flash kernels run on the rank's ``(B/dp, T, H/tp, D)`` tensors
  (``eligible_dp`` with ``tp_axis``).  Heads, and a dense MLP's ``d_ff``,
  must divide by tp (GSPMD would take any split).  An MoE layer is not
  split over tp (the reference keeps the experts on ep or whole): every tp
  rank runs it whole on the tp-replicated activations.
* **sequence parallel** (``cfg.sp_axis`` with ``use_ring_attention``): rank
  ``i`` of sp keeps positions ``[i·T/sp, (i+1)·T/sp)`` of its rows, RoPE
  takes global positions, attention is ``ring_attention_inner``, and the
  logits are the rank's positions (a reader all-gathers them over sp).  It
  composes with tp (each rank runs the ring on its heads).
* **pipeline parallel** (``cfg.pp_axis``): the model built for the mesh
  holds its stage's layers as stacked leaves (``stages``: ``(1, per, ...)``,
  :func:`..parallel.pipeline.stack_stage_params`) and runs through
  :func:`forward_pipelined` (GPipe over pp, the ring inside each stage with
  an sp axis).  The stages run as the reference's do, with ``mesh=None``:
  whole on every tp rank, with no tp collective, and an MoE layer's
  experts whole on every ep rank.

The dense step sums each gradient over dp, and over sp and pp where the
ranks hold different tokens or stages (the model records which,
``core.dense.set_model_layout``); tp-replicated leaves need no tp sum
(the conjugate pair makes their gradients whole on every tp rank; an MoE
layer and a pipeline stage compute the same gradients on every tp rank).

MoE layers follow the reference's routing, whose capacity rule depends on
the layout (:func:`_moe_mlp`): ``moe_capacity`` counts

* the whole global batch without an ep axis (the reference's
  ``moe_dense`` under GSPMD): the rank's rows all-gathered over dp and its
  positions over sp, the rank keeping its block of the output;
* each dp shard's tokens, the whole sequence, when ``cfg.ep_axis`` is an
  axis of the mesh (``moe_apply`` per dp shard, the shard's positions
  gathered over sp first);
* inside pipeline stages, the stage's input alone: the rank's microbatch,
  and with the ring its sp slice of it (``moe_dense``, as the reference's
  stages run it with ``mesh=None``).

:func:`lm_loss` divides the masked token sum by the WHOLE batch's count of
valid tokens (``parallel.collectives.global_mean``: one all-reduce of the
pair over dp, and over sp when the sequence is split), so ranks whose
rows hold different counts weight them as the unsharded loss does.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import flash_attention as _flash
from ..parallel import collectives as _coll
from ..parallel.mesh import axis_index, axis_size, mesh_device, require_axis
from ..parallel.ring_attention import reference_attention, ring_attention_inner
from ..utils.device import DeviceLike, resolve_device

MOE_KEYS = ("w_gate", "w_up", "w_down")  # layers[i].moe's leaves
LAYER_KEYS = ("attn_norm", "wqkv", "wo", "mlp_norm", "w_up", "w_down")  # a dense block's leaves, in order
# Megatron's tp layout of a dense block: the dim each leaf is split on
TP_DIMS = {"wqkv": 1, "wo": 0, "w_up": 1, "w_down": 0}


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
    # head_dim % 64 == 0, no mesh or one whose axes larger than 1 are dp, ep
    # and tp; a head width the kernels lack raises), else the reference path;
    # "on": the kernels or an error; "off": always the reference path.  Ring
    # attention (an sp axis with use_ring_attention) takes precedence: this
    # knob governs the rest
    flash_attention: str = "auto"
    # recompute each block in the backward pass (activation memory per
    # layer O(T·d_model) instead of O(T·d_ff))
    remat: bool = False
    # the reference's parallelism and MoE fields: each names a mesh axis
    # (check_lm_mesh says which layouts run)
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
    """The LM's parameters; ``model(tokens)`` is :func:`forward`.  A model
    built for a pipeline mesh holds no ``layers``: its stage's blocks are
    ``stages``, a block's leaves each ``(1, per, ...)`` (this rank's block
    of :func:`..parallel.pipeline.stack_stage_params`): the keys of
    :data:`LAYER_KEYS`, or with MoE layers the four of attention and norms
    beside ``stages["moe"]``, the stacked :data:`MOE_KEYS`."""

    def __init__(self, cfg: TransformerConfig, embed: torch.Tensor, final_norm: torch.Tensor,
                 layers: List[Dict[str, torch.Tensor]], stages: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(embed)
        self.final_norm = nn.Parameter(final_norm)
        self.layers = nn.ModuleList(TransformerBlock(**layer) for layer in layers)
        if stages is not None:
            self.stages = nn.ParameterDict({k: nn.Parameter(v) for k, v in stages.items() if k != "moe"})
            if "moe" in stages:
                self.stages["moe"] = nn.ParameterDict({k: nn.Parameter(stages["moe"][k]) for k in MOE_KEYS})

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens, self.cfg)


def _moe_config(cfg: TransformerConfig):
    from .moe import MoEConfig

    return MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff, num_experts=cfg.num_experts,
                     capacity=cfg.moe_capacity, dtype=cfg.dtype)


def _on(mesh: Any, axis: Optional[str]) -> bool:
    """``axis`` is set and names an axis of ``mesh`` (of any size): the
    reference's test for each layout (``moe_apply`` on the ep axis's name,
    the ring on the sp axis's, ...)."""
    return mesh is not None and bool(axis) and axis in (mesh.mesh_dim_names or ())


def _ring_on(mesh: Any, cfg: TransformerConfig) -> bool:
    return cfg.use_ring_attention and _on(mesh, cfg.sp_axis)


def _experts_split(mesh: Any, cfg: TransformerConfig) -> bool:
    """The MoE layers' experts split over ``cfg.ep_axis``: an ep axis on
    the mesh, outside a pipeline (the reference's stages hold them whole)."""
    return cfg.num_experts > 0 and _on(mesh, cfg.ep_axis) and not _on(mesh, cfg.pp_axis)


def check_lm_mesh(mesh: Any, cfg: TransformerConfig) -> None:
    """Accept a ``DeviceMesh`` with the ``cfg.dp_axis`` axis whose axes
    larger than 1 are among the config's dp, ep, tp, sp and pp axes, in
    any mix the reference runs; raise ``ValueError`` for anything else:

    * tp > 1 outside a pipeline needs ``n_heads`` divisible by tp, and
      ``d_ff`` too with dense MLPs (a rank holds whole heads and its share
      of the dense MLP; the experts of an MoE layer are not split over
      tp);
    * sp > 1 needs ``use_ring_attention`` (the rank holds only its slice
      of the sequence; the reference would gather it for its plain
      attention);
    * a pp axis needs ``n_layers`` divisible by pp;
    * a mesh axis larger than 1 that no config axis names.

    (:func:`forward` raises for a model built for a pipeline mesh.)

    Where each leaf lives and what ``moe_capacity`` counts, by layout:

    * dp, ep, tp, sp, in any mix: the non-expert leaves on every rank,
      ``wqkv`` / ``wo`` (and a dense MLP's ``w_up`` / ``w_down``) cut over
      tp; the experts split over ep, else whole on every rank.  Capacity
      counts each dp shard's tokens, the whole sequence, with an ep axis
      (``moe_apply``), else the whole global batch (``moe_dense``).
    * with pp: every leaf of a stage's blocks on that stage's ranks,
      whole (not cut over tp, the experts not split over ep); embed and
      the final norm on every rank.  Inside a stage capacity counts the
      stage's input: the rank's microbatch of its dp shard, and with the
      ring its sp slice of it."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise ValueError(
            f"the LM over a {type(mesh).__name__} mesh: the port's LM takes a torch DeviceMesh "
            f"(parallel.mesh.make_mesh / make_nd_mesh)"
        )
    require_axis(mesh, cfg.dp_axis, "the LM over a mesh")
    named = {a for a in (cfg.dp_axis, cfg.ep_axis, cfg.tp_axis, cfg.sp_axis, cfg.pp_axis) if a}
    sizes = dict(zip(mesh.mesh_dim_names, (int(k) for k in mesh.shape)))
    stray = {n: k for n, k in sizes.items() if k > 1 and n not in named}
    if stray:
        raise ValueError(f"the LM over mesh axes {sizes}: {sorted(stray)} name none of the config's axes "
                         f"(dp_axis, ep_axis, tp_axis, sp_axis, pp_axis)")
    tp, sp, pp = (axis_size(mesh, a) if a else 1 for a in (cfg.tp_axis, cfg.sp_axis, cfg.pp_axis))
    piped = _on(mesh, cfg.pp_axis)
    if tp > 1 and not piped and (cfg.n_heads % tp or (not cfg.num_experts and cfg.d_ff % tp)):
        raise ValueError(f"tp={tp} must divide n_heads={cfg.n_heads}" + ("" if cfg.num_experts else
                         f" and d_ff={cfg.d_ff}") + " (a rank holds whole heads)")
    if sp > 1 and not cfg.use_ring_attention:
        raise ValueError(f"sp={sp} needs use_ring_attention=True: a rank holds only its slice of the sequence")
    if piped and cfg.n_layers % pp:
        raise ValueError(f"n_layers={cfg.n_layers} does not split into pp={pp} stages")


def record_layout(model: "TransformerLM", mesh: Any, cfg: TransformerConfig) -> "TransformerLM":
    """Record the model-parallel layout of a model built for ``mesh``
    (``core.dense.set_model_layout``) and return it, the counterpart of the
    reference's ``param_shardings``: on a pp mesh every stage leaf (a MoE
    stage's experts too) on its stage axis and nothing else; else on an ep
    mesh each MoE layer's ``w_up`` and ``w_down`` over ep on their expert
    axis, and on a tp mesh ``wqkv`` / a dense MLP's ``w_up`` on their
    columns and ``wo`` / a dense ``w_down`` on their rows (``wqkv``'s
    columns in 3 groups, q, k and v, so the gather puts them back in the
    reference's ``[q | k | v]`` order).  An MoE layer's leaves have no tp
    spec: every tp rank holds them whole and computes the same gradients,
    which the dense step must not sum over tp.  The gradients of every leaf
    not split over sp or pp are summed over those axes by the dense step.
    ZeRO-1's and FSDP's specs merge dp into the layout; ``gather_params``
    gathers the split leaves whole."""
    from ..core.dense import set_model_layout

    specs, groups = {}, {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("stages."):
            specs[name] = (cfg.pp_axis,) + (None,) * (p.ndim - 1)
        elif _experts_split(mesh, cfg) and name.endswith(("moe.w_up", "moe.w_down")):
            specs[name] = (cfg.ep_axis, None, None)
        elif _on(mesh, cfg.tp_axis) and name.startswith("layers.") and ".moe." not in name and leaf in TP_DIMS:
            specs[name] = tuple(cfg.tp_axis if d == TP_DIMS[leaf] else None for d in range(p.ndim))
            if leaf == "wqkv":
                groups[name] = 3
    sums = tuple(a for a in (cfg.sp_axis, cfg.pp_axis) if _on(mesh, a))
    if not specs and not sums:
        return model
    return set_model_layout(model, mesh, specs, sum_axes=sums, groups=groups)


def _tp_cut(layer: Dict[str, Any], cfg: TransformerConfig, mesh: Any) -> Dict[str, Any]:
    """This rank's tp share of a whole block: its heads' columns of each
    of q, k and v, the matching rows of ``wo``, its ``d_ff`` slice of a
    dense MLP (an MoE layer stays whole)."""
    tp, r = axis_size(mesh, cfg.tp_axis), axis_index(mesh, cfg.tp_axis)
    out = dict(layer)
    d = layer["wqkv"].shape[0]
    out["wqkv"] = layer["wqkv"].reshape(d, 3, tp, -1)[:, :, r].reshape(d, -1)
    for key in ("wo", "w_up", "w_down"):
        if key in layer:
            out[key] = _coll.block_of(layer[key], mesh, cfg.tp_axis, TP_DIMS[key])
    return {k: v.contiguous().clone() if k in TP_DIMS else v for k, v in out.items()}


def build_lm(cfg: TransformerConfig, embed: torch.Tensor, final_norm: torch.Tensor,
             layers: List[Dict[str, Any]], mesh: Any = None) -> TransformerLM:
    """The LM from WHOLE leaves (the reference's layouts), placed for
    ``mesh`` (:func:`check_lm_mesh` says where each leaf lives): on a pp
    mesh its stage's blocks stacked (:func:`..parallel.pipeline.
    stack_stage_params`, MoE layers' experts whole), else this rank's tp
    share of every block; the layout recorded (:func:`record_layout`).  MoE
    leaves arrive already cut to the rank's experts where ep splits them."""
    stages = None
    if mesh is not None:
        check_lm_mesh(mesh, cfg)
        if _on(mesh, cfg.pp_axis):
            from ..parallel.pipeline import stack_stage_params

            stacked = stack_stage_params(layers, axis_size(mesh, cfg.pp_axis), mesh=mesh, pp_axis=cfg.pp_axis)
            stages, layers = stacked, []
        elif _on(mesh, cfg.tp_axis):
            layers = [_tp_cut(layer, cfg, mesh) for layer in layers]
    return record_layout(TransformerLM(cfg, embed, final_norm, layers, stages), mesh, cfg)


def init_params(cfg: TransformerConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None, *, mesh: Optional[Any] = None) -> TransformerLM:
    """A freshly initialised LM on ``device`` (``cuda`` by default; with a
    ``mesh``, this rank's device on it).  Every rank draws the same whole
    weights from the same ``generator`` seed and keeps its share
    (:func:`build_lm`: its tp columns and rows, its pp stage; with
    ``cfg.ep_axis`` on a mesh without pp its experts of every MoE layer,
    ``init_moe_params(mesh=)``), so the generator streams stay aligned
    across ranks.

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

            ep_mesh = mesh if _experts_split(mesh, cfg) else None
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
    return build_lm(cfg, embed, ones(), layers, mesh)


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
    mesh ``eligible_dp`` over the global batch (``q`` holds this rank's rows,
    and its heads on a tp mesh), and the kernels run on the rank's tensors."""
    T, Dh = q.shape[1], q.shape[3]
    if cfg.flash_attention == "off":
        return reference_attention(q, k, v)
    if mesh is None:
        if _flash.eligible(T, Dh, q.device):
            return _flash.flash_mha(q, k, v)
    elif _flash.eligible_dp(T, Dh, q.shape[0] * axis_size(mesh, cfg.dp_axis), mesh, cfg.dp_axis, cfg.ep_axis,
                            cfg.tp_axis):
        return _flash.flash_mha(q, k, v)
    if cfg.flash_attention == "on":
        # "on" means the kernels or an error: a quiet reference fallback
        # would mislabel measurements
        raise ValueError(
            f"flash_attention='on' but the flash path is ineligible (device={q.device}, "
            f"T={T}, head_dim={Dh}); flash needs a CUDA tensor, T % 128 == 0, "
            f"head_dim % 64 == 0 and no mesh or a mesh whose axes larger than 1 are "
            f"dp, ep and tp, dp dividing the batch. "
            f"Use 'auto' to fall back gracefully."
        )
    return reference_attention(q, k, v)


def _apply_block(x: torch.Tensor, layer: Any, cfg: TransformerConfig, mesh: Optional[Any] = None,
                 ring_mesh: Optional[Any] = None, pos_offset: int = 0) -> torch.Tensor:
    """One pre-norm residual block (attention + MLP) on (B, T, d).

    ``mesh``: the LM's mesh (tp, ep, the flash gate), None inside pipeline
    stages.  ``ring_mesh``: the mesh whose ``cfg.sp_axis`` the ring runs
    over, and ``pos_offset`` the global position of the block's first
    token (RoPE takes global positions)."""
    B, T, _ = x.shape
    tp = _on(mesh, cfg.tp_axis)
    heads = cfg.n_heads // (axis_size(mesh, cfg.tp_axis) if tp else 1)
    Dh = cfg.head_dim
    positions = (torch.arange(T, dtype=torch.int32, device=x.device) + pos_offset)[None].expand(B, T)
    h = _rmsnorm(x, layer.attn_norm)
    if tp:
        h = _coll.copy_to_tp(h, mesh, cfg.tp_axis)
    qkv = (h @ layer.wqkv).reshape(B, T, 3, heads, Dh)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    q = _rope(q, positions)
    k = _rope(k, positions)
    if ring_mesh is not None:
        attn = ring_attention_inner(q, k, v, mesh=ring_mesh, sp_axis=cfg.sp_axis)
    else:
        attn = _unsharded_attention(q, k, v, cfg, mesh)
    out = attn.reshape(B, T, heads * Dh) @ layer.wo
    x = x + (_coll.reduce_from_tp(out, mesh, cfg.tp_axis) if tp else out)
    h = _rmsnorm(x, layer.mlp_norm)
    if cfg.num_experts > 0:
        return x + _moe_mlp(layer, h, cfg, mesh)
    if tp:
        h = _coll.copy_to_tp(h, mesh, cfg.tp_axis)
    out = F.gelu(h @ layer.w_up, approximate="tanh") @ layer.w_down
    return x + (_coll.reduce_from_tp(out, mesh, cfg.tp_axis) if tp else out)


def _moe_token_axes(mesh: Any, cfg: TransformerConfig) -> List[tuple]:
    """The ``(axis, dim)`` all-gathers, innermost first, that give a rank's
    MoE layer the tokens it routes together (:func:`_moe_mlp`): its
    positions over sp (dim 1), then without an ep axis its rows over dp
    (dim 0).  Axes of size 1 need none."""
    axes = [(cfg.sp_axis, 1)] if _on(mesh, cfg.sp_axis) else []
    if not _on(mesh, cfg.ep_axis):
        axes.append((cfg.dp_axis, 0))
    return [(a, dim) for a, dim in axes if axis_size(mesh, a) > 1]


def _moe_mlp(layer: Any, h: torch.Tensor, cfg: TransformerConfig, mesh: Optional[Any]) -> torch.Tensor:
    """The MoE layer on this rank's (B, T, d) activations, by the
    reference's rule for the layout:

    * no mesh (the mesh-less model, and a pipeline stage, which the
      reference runs with ``mesh=None``): ``moe_dense`` on ``h`` alone, so
      capacity counts the stage's microbatch (its sp slice with the ring);
    * an ep axis on the mesh: ``moe_apply`` on the rank's dp shard, its
      positions gathered over sp first, so capacity counts each dp
      shard's tokens over the whole sequence;
    * else ``moe_dense`` over the whole global batch: the rank's positions
      gathered over sp, then its rows over dp.

    Every rank routes the tokens in the reference's flattened ``(b, t)``
    order (a slot goes to the first token that claims it), then keeps its
    rows and positions of the output.  On a tp mesh every tp rank runs the
    layer whole on the same activations and computes the same expert
    gradients.  Each gather's backward takes the rank's block of the
    gradient (``collectives.gather_block``): exact, because once the
    routing is fixed a token's output depends only on that token and the
    weights, so the gradient reaching the gathered tokens is zero off the
    rank's own."""
    from .moe import moe_apply, moe_dense

    B, T, d = h.shape
    if mesh is None:
        return moe_dense(layer.moe, h.reshape(B * T, d), _moe_config(cfg)).reshape(B, T, d)
    axes = _moe_token_axes(mesh, cfg)
    whole = h
    for axis, dim in axes:
        whole = _coll.gather_block(whole, mesh, axis, dim)
    flat = whole.reshape(-1, d)
    if _on(mesh, cfg.ep_axis):
        y = moe_apply(layer.moe, flat, _moe_config(cfg), mesh=mesh, ep_axis=cfg.ep_axis)
    else:
        y = moe_dense(layer.moe, flat, _moe_config(cfg))
    y = y.reshape(whole.shape)
    for axis, dim in reversed(axes):
        y = _coll.block_of(y, mesh, axis, dim)
    return y


def _embed_slice(params: TransformerLM, tokens: Any, cfg: TransformerConfig, mesh: Optional[Any]):
    """The rank's token embeddings and the global position of its first
    token: on an sp mesh its ``[i·T/sp, (i+1)·T/sp)`` slice of every row."""
    tokens = torch.as_tensor(tokens, device=params.embed.device)
    T = tokens.shape[1]
    if T > cfg.max_seq:
        raise ValueError(f"sequence length {T} > max_seq {cfg.max_seq}")
    offset = 0
    if _on(mesh, cfg.sp_axis):
        tokens = _coll.block_of(tokens, mesh, cfg.sp_axis, 1)
        offset = axis_index(mesh, cfg.sp_axis) * tokens.shape[1]
    return params.embed[tokens.long()], offset


def _logits(params: TransformerLM, x: torch.Tensor) -> torch.Tensor:
    x = _rmsnorm(x, params.final_norm)
    return (x @ params.embed.T.to(x.dtype)).to(torch.float32)


def forward(params: TransformerLM, tokens: torch.Tensor, cfg: TransformerConfig, *,
            mesh: Optional[Any] = None) -> torch.Tensor:
    """Causal LM forward: (B, T) int tokens -> (B, T, vocab) float32 logits.
    With a ``mesh``, ``tokens`` are this rank's dp rows at full length and
    the logits are this rank's: its rows, and its positions on an sp mesh."""
    if mesh is not None:
        check_lm_mesh(mesh, cfg)
    if hasattr(params, "stages"):
        raise ValueError("a model built for a pipeline mesh runs through forward_pipelined")
    x, offset = _embed_slice(params, tokens, cfg, mesh)
    ring = mesh if _ring_on(mesh, cfg) else None
    for layer in params.layers:
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(_apply_block, x, layer, cfg, mesh, ring, offset, use_reentrant=False)
        else:
            x = _apply_block(x, layer, cfg, mesh, ring, offset)
    return _logits(params, x)


def forward_pipelined(params: TransformerLM, tokens: torch.Tensor, cfg: TransformerConfig, *, mesh: Any,
                      num_microbatches: int = 4) -> torch.Tensor:
    """Causal LM forward with the layer stack pipelined over ``cfg.pp_axis``
    (the GPipe schedule, :func:`..parallel.pipeline.pipeline_apply`), on
    every rank of the mesh.  ``params`` is built for the mesh (its
    ``stages`` hold this rank's stage); ``tokens`` are this rank's dp rows
    at full length; ``num_microbatches`` must divide them.  Embed, final
    norm and logits run outside the pipeline on every rank; the logits, the
    same on every pp rank, are this rank's rows (and positions, with an sp
    axis and ``cfg.use_ring_attention``: each stage then runs the ring on
    its sp slice).  Inside the stages attention is the plain reference
    path, as the reference pins it: ``flash_attention="on"`` raises.

    The stages run their blocks with no mesh, as the reference's do: each
    leaf whole on every tp and ep rank of the stage (those ranks compute
    the same thing), and an MoE layer's ``moe_dense`` on the stage's
    input alone, so its capacity counts the microbatch (with the ring, the
    rank's sp slice of it).  The routing is a function of that input, so
    the pipeline's backward recomputes it as the forward made it.

    Every pp rank computes the same loss from the logits, so their
    gradient is scaled by ``1/pp`` (:func:`..parallel.pipeline.
    scale_grad`): the pipeline's backward sums the cotangents over pp, and
    the dense step sums the replicated leaves' gradients over pp, each then
    counted once."""
    from ..parallel.pipeline import pipeline_apply, scale_grad

    check_lm_mesh(mesh, cfg)
    if not _on(mesh, cfg.pp_axis) or not hasattr(params, "stages"):
        raise ValueError(f"forward_pipelined needs a mesh with the pp_axis {cfg.pp_axis!r} and a model built "
                         f"for it (init_params(mesh=) or interop.transformer_params_from_numpy(mesh=))")
    if cfg.flash_attention == "on":
        raise ValueError(
            "flash_attention='on' is not supported in forward_pipelined (the pipeline's stages run the plain "
            "attention, as the reference pins them); use 'auto' or 'off'"
        )
    block_cfg = dataclasses.replace(cfg, flash_attention="off")
    ring = mesh if _ring_on(mesh, cfg) else None
    x, offset = _embed_slice(params, tokens, cfg, mesh if ring is not None else None)

    def stage_fn(stage, x_mb):
        for j in range(stage["wqkv"].shape[0]):
            leaves = {k: v[j] for k, v in stage.items()}
            moe = {k: leaves.pop("moe." + k) for k in MOE_KEYS if "moe." + k in leaves}
            layer = types.SimpleNamespace(**leaves, **({"moe": moe} if moe else {}))
            x_mb = _apply_block(x_mb, layer, block_cfg, None, ring, offset)
        return x_mb

    x = pipeline_apply(dict(params.stages.named_parameters()), x, stage_fn, mesh=mesh, pp_axis=cfg.pp_axis,
                       num_microbatches=num_microbatches)
    return scale_grad(_logits(params, x), 1.0 / axis_size(mesh, cfg.pp_axis))


def next_token_xent(logits: torch.Tensor, tokens: torch.Tensor,
                    row_mask: Optional[torch.Tensor] = None, *, mesh: Optional[Any] = None,
                    dp_axis: str = "dp", sp_axis: Optional[str] = None) -> torch.Tensor:
    """Next-token cross entropy: targets are the tokens shifted left, the
    last position is masked; optional (B,) or (B, T) row mask.  With a
    ``mesh`` the arguments are this rank's dp rows (``tokens`` and a (B, T)
    mask at full length) and the result is the whole batch's loss: the
    masked sum over the count of valid tokens of every rank
    (``parallel.collectives.global_mean``).  On an sp mesh (``sp_axis``)
    ``logits`` hold the rank's positions: the target of its last position
    is the next slice's first token, and only the global last position is
    masked."""
    tokens = torch.as_tensor(tokens, device=logits.device).long()
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    mask = torch.ones(tokens.shape, dtype=logits.dtype, device=logits.device)
    mask[:, -1] = 0.0
    if row_mask is not None:
        row_mask = torch.as_tensor(row_mask, device=logits.device).to(mask.dtype)
        if row_mask.ndim == 1:  # (B,) row mask from microbatches()
            row_mask = row_mask[:, None]
        mask = mask * row_mask
    axes = (dp_axis,)
    if _on(mesh, sp_axis):
        targets, mask = (_coll.block_of(t, mesh, sp_axis, 1) for t in (targets, mask))
        axes = (dp_axis, sp_axis)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    if mesh is not None:
        return _coll.global_mean(torch.sum(nll * mask), torch.sum(mask), mesh, axes)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def lm_loss(params: TransformerLM, batch: Dict[str, Any], cfg: TransformerConfig, *,
            mesh: Optional[Any] = None, num_microbatches: int = 4) -> torch.Tensor:
    """Next-token cross entropy through :func:`forward`, or through
    :func:`forward_pipelined` (``num_microbatches``) for a model built for
    a pipeline mesh.  With a ``mesh`` the batch holds this rank's dp rows
    (the dense step passes them) and the loss is the whole batch's
    (:func:`next_token_xent`)."""
    tokens = batch["tokens"]
    if hasattr(params, "stages"):
        logits = forward_pipelined(params, tokens, cfg, mesh=mesh, num_microbatches=num_microbatches)
    else:
        logits = forward(params, tokens, cfg, mesh=mesh)
    return next_token_xent(logits, tokens, batch.get("mask"), mesh=mesh, dp_axis=cfg.dp_axis, sp_axis=cfg.sp_axis)


__all__ = [
    "LAYER_KEYS",
    "MOE_KEYS",
    "TransformerConfig",
    "TransformerBlock",
    "TransformerLM",
    "build_lm",
    "check_lm_mesh",
    "init_params",
    "record_layout",
    "forward",
    "forward_pipelined",
    "next_token_xent",
    "lm_loss",
]
