"""Causal flash attention for the dense transformer path.

Replaces the TPU kernel behind ``flink_parameter_server_tpu/ops/
flash_attention.py`` (``_make_kernel``: JAX's splash attention, whose
forward, dQ and dK/dV are three ``pallas_call``s) with three CUDA kernels
in ``csrc/flash_attn.cu``:

* :func:`flash_fwd` — ``O = softmax(q kᵀ + causal) v`` with an online
  softmax over 64-key tiles; returns ``O`` (in v's dtype) and the float32
  log-sum-exp ``L`` of each query row, ``(B, H, T)``.
* :func:`flash_bwd_dq` — per query tile: ``P = exp(q kᵀ - L)``, ``D =
  rowsum(dO ∘ O)``, ``dQ = Σ dS k`` with ``dS = P ∘ (dO vᵀ - D)`` rounded
  to the inputs' dtype before that product, as splash rounds it; returns
  ``dQ`` and ``D``.
* :func:`flash_bwd_dkv` — per key tile, over the query tiles at or below
  the diagonal: ``dV = Σ Pᵀ dO``, ``dK = Σ (P ∘ (dP - D))ᵀ q``, with ``P``
  and ``dS`` rounded to the inputs' dtype before those two products, as
  splash rounds them.

Routes.  At head widths 64, 128, 192 and 256 bfloat16 takes tensor-core
kernels (bf16 ``mma.sync``, ``cp.async`` tile ring), and float32 takes
tensor-core kernels in 3xTF32: each float32 product is three TF32
``mma.sync`` products of the operands' big and small TF32 halves, which
keeps the float32 bar where one TF32 product keeps about three decimal
digits; their bound is three TF32 products over the (query, key) pairs the
causal mask keeps, at the card's TF32 rate.  Every wider head width the
reference's gate takes (a multiple of 64) runs, in both dtypes,
column-split kernels on the tensor cores: a block holds its own rows whole
in shared memory (the forward q; dQ q and dO; dK/dV k and v) and streams
the other side in 64 x 64 pieces, builds the scores once a block and
shares them with its warps, and writes a slice of the output columns (up
to 512; 256 for dK/dV, which holds two outputs); where the own rows no
longer fit whole, they stream beside each piece.  Every kernel skips
the tiles wholly above the causal diagonal and keeps scores, softmax
statistics and sums in float32.  Its bound on an H100 and its design are
in the source.

Contract of :func:`flash_mha` (that of the reference's): ``(B, T, H, D)``
in and out, causal, ``q`` scaled by ``1/sqrt(D)`` in float32 and rounded
back to q's dtype before the kernel (the kernel does not scale; the scale
stays outside the ``autograd.Function`` so autograd carries its gradient).

On a ``dp`` mesh, a ``("dp", "ep")`` one or one with a Megatron ``tp``
axis (gated by :func:`eligible_dp`), each rank runs the same kernels on its
own batch rows (:func:`flash_mha_dp`) and, on a tp mesh, its own heads.

Dispatch: each wrapper takes its plain torch version (``*_plain``, the same
tiles and the same float32 arithmetic) for tensors on the CPU; a CUDA
tensor launches the kernel or raises.  ``<wrapper>.launches`` counts
launches.  :func:`flash_mha_plain` runs the plain versions on any device.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _cuda

BLOCK = 64  # query rows and key rows per tile, as in the kernels
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "fps_flash_fwd": (_I, _I, _P, _P, _P, _STRIDES, _P, _P, _I, _I, _I, _P),
    "fps_flash_bwd_dq": (_I, _I, _P, _P, _P, _P, _P, _STRIDES, _P, _P, _P, _I, _I, _I, _P),
    "fps_flash_bwd_dkv": (_I, _I, _P, _P, _P, _P, _STRIDES, _P, _P, _P, _P, _I, _I, _I, _P),
}


def supports_shape(seq_len: int, head_dim: int) -> bool:
    """The reference's shape gate: T a multiple of 128, D of 64."""
    return seq_len % 128 == 0 and head_dim % 64 == 0 and seq_len >= 128


def eligible(seq_len: int, head_dim: int, device, mesh=None) -> bool:
    """The ``"auto"`` gate, the reference's: true iff the tensors are on
    ``cuda``, the shape passes :func:`supports_shape` and there is no mesh.
    An eligible call launches the kernels or raises: a dtype they lack is
    refused by the wrappers, never run by the reference."""
    return mesh is None and torch.device(device).type == "cuda" and supports_shape(seq_len, head_dim)


def _mesh_on_cuda(mesh) -> bool:
    return getattr(mesh, "device_type", None) == "cuda"


def eligible_dp(seq_len: int, head_dim: int, batch: int, mesh, dp_axis: str = "dp",
                ep_axis: Optional[str] = None, tp_axis: Optional[str] = None) -> bool:
    """The ``"auto"`` gate on a mesh: true iff ``mesh`` has ``dp_axis`` and
    no axis but it, ``ep_axis`` and ``tp_axis`` is larger than 1, its ranks
    are on ``cuda`` (the reference asks for the TPU backend), the shape
    passes :func:`supports_shape` and ``batch`` (the global batch) divides
    by dp.  Attention never mixes batch rows, so each rank runs the kernels
    on its own rows with no collective.  On the ``("dp", "ep")`` mesh the
    ep ranks of a dp row hold the same rows, so each runs the kernels on
    them as a dp-only rank would.  Attention never mixes heads either, so a
    Megatron tp rank, which holds whole heads (``H/tp`` of them) over its
    full sequence, runs them on its ``(B/dp, T, H/tp, D)`` tensors: exactly
    the reference's attention of those heads.  The reference's gate asks
    for a dp-only mesh and takes its plain attention on ep and tp meshes;
    the math is the same.  sp meshes run the ring and pp stages the plain
    attention, as the reference's do."""
    from ..parallel.mesh import axis_size

    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    allowed = {dp_axis} | {a for a in (ep_axis, tp_axis) if a}
    return (
        dp_axis in names
        and all(int(size) == 1 or name in allowed for name, size in zip(names, mesh.shape))
        and _mesh_on_cuda(mesh)
        and supports_shape(seq_len, head_dim)
        and batch % axis_size(mesh, dp_axis) == 0
    )


def flash_mha_dp(q, k, v, *, mesh, dp_axis: str = "dp"):
    """Causal flash attention with the batch split over ``dp``: this rank
    runs :func:`flash_mha` (K3a; K3b and K3c in the backward) on its own
    batch rows.  ``q, k, v`` are the global ``(B, T, H, D)`` tensors, the
    same on every rank (B must divide by dp), and the output is the global
    one, all-gathered over dp; in the backward each rank runs the kernels
    on its rows and the input gradients are all-gathered, so every rank
    holds the whole gradient.  (The model's forward on a dp mesh, whose
    activations are already this rank's rows, calls :func:`flash_mha` on
    them, with no collective.)"""
    from ..parallel.collectives import gather_rows, take_rows
    from ..parallel.mesh import axis_size, require_axis

    require_axis(mesh, dp_axis, "flash_mha_dp")
    B, dp = q.shape[0], axis_size(mesh, dp_axis)
    if B % dp:
        raise ValueError(f"flash_mha_dp needs batch {B} divisible by dp={dp}")
    rows = flash_mha(*(take_rows(x, mesh, dp_axis) for x in (q, k, v)))
    return gather_rows(rows, mesh, dp_axis)


# ---------------------------------------------------------------- plain versions


def _heads(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, D) -> (B, H, T, D) float32."""
    return x.permute(0, 2, 1, 3).to(torch.float32)


def _out(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, T, D) float32 -> contiguous (B, T, H, D) in ``dtype``."""
    return x.permute(0, 2, 1, 3).to(dtype).contiguous()


def _diagonal_mask(block: int, device) -> torch.Tensor:
    """True where key > query inside a tile on the diagonal."""
    return torch.ones(block, block, dtype=torch.bool, device=device).triu(1)


def flash_fwd_plain(q, k, v, *, block: int = BLOCK):
    """Plain version of :func:`flash_fwd`: the kernel's tiles and online
    softmax in float32 torch ops.  Returns ``(O, L)``."""
    B, T, H, D = q.shape
    qh, kh, vh = _heads(q), _heads(k), _heads(v)
    o = torch.empty_like(qh)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    above = _diagonal_mask(block, q.device)
    for qt in range(T // block):
        rows = slice(qt * block, (qt + 1) * block)
        m = torch.full((B, H, block), float("-inf"), device=q.device)
        l = torch.zeros((B, H, block), device=q.device)
        acc = torch.zeros((B, H, block, D), device=q.device)
        for kt in range(qt + 1):  # tiles above the diagonal are skipped
            cols = slice(kt * block, (kt + 1) * block)
            s = qh[:, :, rows] @ kh[:, :, cols].transpose(-1, -2)
            if kt == qt:
                s = s.masked_fill(above, float("-inf"))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new.unsqueeze(-1))
            l = l * alpha + p.sum(-1)
            acc = acc * alpha.unsqueeze(-1) + p @ vh[:, :, cols]
            m = m_new
        o[:, :, rows] = acc / l.unsqueeze(-1)
        lse[:, :, rows] = m + torch.log(l)
    return _out(o, v.dtype), lse


def _probs(qh, kh, lse, rows, cols, diagonal, above):
    p = torch.exp(qh[:, :, rows] @ kh[:, :, cols].transpose(-1, -2) - lse[:, :, rows].unsqueeze(-1))
    return p.masked_fill(above, 0.0) if diagonal else p


def flash_bwd_dq_plain(q, k, v, o, do, lse, *, block: int = BLOCK):
    """Plain version of :func:`flash_bwd_dq`.  Returns ``(dQ, D)``.

    dS is rounded to the inputs' dtype before its product with k, as
    splash's dQ kernel does (``ds.astype(k.dtype)``); a no-op for float32."""
    B, T, H, D = q.shape
    qh, kh, vh, doh = _heads(q), _heads(k), _heads(v), _heads(do)
    delta = (_heads(o) * doh).sum(-1)
    dq = torch.zeros_like(qh)
    above = _diagonal_mask(block, q.device)
    for qt in range(T // block):
        rows = slice(qt * block, (qt + 1) * block)
        for kt in range(qt + 1):
            cols = slice(kt * block, (kt + 1) * block)
            p = _probs(qh, kh, lse, rows, cols, kt == qt, above)
            dp = doh[:, :, rows] @ vh[:, :, cols].transpose(-1, -2)
            ds = p * (dp - delta[:, :, rows].unsqueeze(-1))
            dq[:, :, rows] += _rounded(ds, k.dtype) @ kh[:, :, cols]
    return _out(dq, q.dtype), delta


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, *, block: int = BLOCK):
    """Plain version of :func:`flash_bwd_dkv`.  Returns ``(dK, dV)``.

    P and dS are rounded to the inputs' dtype before their products with
    dO and q, as splash's dK/dV kernel does (``p.astype(do.dtype)``,
    ``ds.astype(do.dtype)``); a no-op for float32."""
    B, T, H, D = q.shape
    qh, kh, vh, doh = _heads(q), _heads(k), _heads(v), _heads(do)
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    above = _diagonal_mask(block, q.device)
    n = T // block
    for kt in range(n):
        cols = slice(kt * block, (kt + 1) * block)
        for qt in range(kt, n):  # query tiles at or below the diagonal
            rows = slice(qt * block, (qt + 1) * block)
            p = _probs(qh, kh, lse, rows, cols, kt == qt, above)
            dp = doh[:, :, rows] @ vh[:, :, cols].transpose(-1, -2)
            ds = p * (dp - delta[:, :, rows].unsqueeze(-1))
            dv[:, :, cols] += _rounded(p, do.dtype).transpose(-1, -2) @ doh[:, :, rows]
            dk[:, :, cols] += _rounded(ds, do.dtype).transpose(-1, -2) @ qh[:, :, rows]
    return _out(dk, k.dtype), _out(dv, v.dtype)


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 ``x`` rounded to ``dtype`` and back."""
    return x.to(dtype).to(torch.float32)


# ---------------------------------------------------------------- kernel wrappers


def _check(*ts: torch.Tensor) -> Tuple[int, int, int, int]:
    """What every kernel takes; the CPU path checks the same, so it shows
    what the card would do."""
    B, T, H, D = ts[0].shape
    for t in ts:
        if t.ndim != 4 or tuple(t.shape) != (B, T, H, D):
            raise ValueError(f"flash kernels take equal (B, T, H, D) tensors, got {tuple(t.shape)}")
        if t.dtype != ts[0].dtype or t.dtype not in KERNEL_DTYPES:
            raise ValueError(f"flash kernels take float32 or bfloat16 tensors of one dtype, got {t.dtype}")
        if t.device != ts[0].device:
            raise ValueError("flash kernel inputs must be on one device")
    if D <= 0 or D % 64:
        raise ValueError(f"flash kernels take head_dim a multiple of 64 (the reference's gate), got {D}")
    if T % BLOCK:
        raise ValueError(f"flash kernels take T % {BLOCK} == 0, got T={T}")
    if B * H > 65535:
        raise ValueError(f"flash kernels take B * H <= 65535, got {B * H}")
    dev = ts[0].device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"no flash kernel for device {ts[0].device}")
    return B, T, H, D


def _rows_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a fresh contiguous copy unless its rows are contiguous and
    start on 16-byte boundaries (the tensor-core kernels copy 16 B a
    thread).  A copy, not ``contiguous()``: a contiguous view that starts
    off a boundary would come back as it is."""
    step = 16 // t.element_size()
    ok = t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        s % step == 0 for n, s in zip(t.shape[:3], t.stride()[:3]) if n > 1
    )
    return t if ok else t.clone(memory_format=torch.contiguous_format)


def _strides(*ts: torch.Tensor):
    vals = [s for t in ts for s in (t.stride(0), t.stride(1), t.stride(2))]
    return (ctypes.c_int64 * len(vals))(*vals)


def _launch(fn: str, dtype: torch.dtype, D: int, *args) -> None:
    lib = _cuda.load("flash_attn", _SIGNATURES)
    _cuda.check(getattr(lib, fn)(_cuda.DTYPE_CODES[dtype], D, *args), fn)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """K3a: ``(O, L)`` for pre-scaled ``q``; see the module docstring."""
    B, T, H, D = _check(q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v)
    q, k, v = (_rows_aligned(t) for t in (q, k, v))
    o = torch.empty((B, T, H, D), dtype=v.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    _launch("fps_flash_fwd", q.dtype, D, q.data_ptr(), k.data_ptr(), v.data_ptr(), _strides(q, k, v),
            o.data_ptr(), lse.data_ptr(), B, T, H, _cuda.stream_handle(q.device))
    flash_fwd.launches += 1
    return o, lse


def flash_bwd_dq(q, k, v, o, do, lse):
    """K3b: ``(dQ, D)`` with ``D = rowsum(dO ∘ O)`` float32 ``(B, H, T)``."""
    B, T, H, D = _check(q, k, v, o, do)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, o, do, lse)
    q, k, v, o, do = (_rows_aligned(t) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    dq = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    _launch("fps_flash_bwd_dq", q.dtype, D, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), _strides(q, k, v, o, do), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), B, T, H, _cuda.stream_handle(q.device))
    flash_bwd_dq.launches += 1
    return dq, delta


def flash_bwd_dkv(q, k, v, do, lse, delta):
    """K3c: ``(dK, dV)``."""
    B, T, H, D = _check(q, k, v, do)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta)
    q, k, v, do = (_rows_aligned(t) for t in (q, k, v, do))
    lse, delta = lse.contiguous(), delta.contiguous()
    dk = torch.empty((B, T, H, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, T, H, D), dtype=v.dtype, device=q.device)
    _launch("fps_flash_bwd_dkv", q.dtype, D, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            _strides(q, k, v, do), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, T, H, _cuda.stream_handle(q.device))
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0

KERNELS = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)
PLAIN = (flash_fwd_plain, flash_bwd_dq_plain, flash_bwd_dkv_plain)


class _FlashAttention(torch.autograd.Function):
    """Attention on pre-scaled q through ``impl`` = (forward, dQ, dK/dV)."""

    @staticmethod
    def forward(ctx, q, k, v, impl):
        o, lse = impl[0](q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.impl = impl
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, delta = ctx.impl[1](q, k, v, o, do, lse)
        dk, dv = ctx.impl[2](q, k, v, do, lse, delta)
        return dq, dk, dv, None


def _attend(q, k, v, impl) -> torch.Tensor:
    B, T, H, D = q.shape
    if not supports_shape(T, D):
        raise ValueError(
            f"flash_mha needs T % 128 == 0 and D % 64 == 0; got T={T}, D={D}. "
            f"Callers should gate on supports_shape() and fall back to reference_attention."
        )
    # scale q in float32 (a bfloat16 pre-scale would round before the
    # kernel's float32 sums even start), as the reference does
    q_scaled = (q.to(torch.float32) * (1.0 / D**0.5)).to(q.dtype)
    return _FlashAttention.apply(q_scaled, k, v, impl).to(v.dtype)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal flash attention on ``(B, T, H, D)`` tensors: the kernels on a
    CUDA tensor, their plain versions on a CPU one.  Drop-in for
    ``reference_attention(q, k, v)``."""
    return _attend(q, k, v, KERNELS)


def flash_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """:func:`flash_mha` through the plain versions, on any device."""
    return _attend(q, k, v, PLAIN)


__all__ = [
    "BLOCK",
    "supports_shape",
    "eligible",
    "eligible_dp",
    "flash_mha",
    "flash_mha_dp",
    "flash_mha_plain",
    "flash_fwd",
    "flash_bwd_dq",
    "flash_bwd_dkv",
    "flash_fwd_plain",
    "flash_bwd_dq_plain",
    "flash_bwd_dkv_plain",
]
