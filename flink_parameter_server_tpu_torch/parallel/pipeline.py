"""Pipeline parallelism: the GPipe schedule over a ``pp`` axis.

Counterpart of ``flink_parameter_server_tpu/parallel/pipeline.py``.  Stage
``s`` holds its block of layers (the leaves of :func:`stack_stage_params`,
``(S, per, ...)`` whole, of which a rank keeps its ``(1, per, ...)``
block).  Time runs in ticks ``t = 0 .. S + M − 2`` (S stages, M
microbatches): at tick ``t`` stage ``s`` computes microbatch ``t − s``
when it is in ``[0, M)`` and hands its activation to stage ``s + 1`` with
one :func:`.collectives.ppermute` over ``pp``; stage 0 injects microbatch
``t``; the last stage keeps the outputs, which one all-reduce over ``pp``
(the reference's ``psum``) puts on every rank.  The bubble costs
``(S − 1)/(S + M − 1)`` of the ticks.

One rank a device: each rank runs the schedule for its stage, and an idle
tick skips the stage's block (the reference masks it; the result is the
same) but still makes the tick's ``ppermute``, so every rank of the axis
makes the same collectives in the same order.  The schedule is one
``autograd.Function`` whose backward runs the ticks in reverse: the
cotangent of each tick's output comes back over the reverse ``ppermute``,
the stage's block is recomputed from its saved input and its gradient
taken with ``torch.autograd.grad`` (a GPipe stage stores its microbatches'
inputs, not their activations).  Leaving the backward to autograd would
not do: a rank whose stage never reads a tick's hand-off (stage 0 reads
its injected microbatch) would skip that tick's collective while its
neighbours make it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from . import collectives as _coll
from .mesh import axis_index, axis_size


def _check_microbatches(rows: int, m: int) -> None:
    if m < 1 or rows % m:
        raise ValueError(f"num_microbatches={m} must divide the {rows} rows this rank pipelines (its dp shard)")


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, block_fn, keys, mesh, pp_axis, m, *leaves):
        S, s = axis_size(mesh, pp_axis), axis_index(mesh, pp_axis)
        params = dict(zip(keys, leaves))
        inputs = x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
        carry = torch.zeros_like(inputs[0])
        saved: Dict[int, torch.Tensor] = {}
        outs: List[Optional[torch.Tensor]] = [None] * m
        for t in range(S + m - 1):
            x_in = inputs[min(t, m - 1)] if s == 0 else carry
            idx = t - s
            if 0 <= idx < m:
                saved[t] = x_in
                y = block_fn(params, x_in)
                if s == S - 1:
                    outs[idx] = y
            else:
                y = x_in
            carry = _coll._ppermute(y, mesh, pp_axis, 1)
        out = torch.cat(outs) if s == S - 1 else torch.zeros_like(x)
        ctx.block_fn, ctx.keys, ctx.mesh, ctx.pp_axis, ctx.m = block_fn, keys, mesh, pp_axis, m
        ctx.saved = saved
        ctx.save_for_backward(*leaves)
        ctx.x_shape = tuple(x.shape)
        return _coll.all_reduce_sum(out, mesh, pp_axis)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out):
        mesh, pp_axis, m = ctx.mesh, ctx.pp_axis, ctx.m
        S, s = axis_size(mesh, pp_axis), axis_index(mesh, pp_axis)
        leaves = ctx.saved_tensors
        # every rank's loss reads the replicated output: the cotangents sum
        g_out = _coll.all_reduce_sum(g_out.contiguous(), mesh, pp_axis)
        g_out = g_out.reshape((m, g_out.shape[0] // m) + tuple(g_out.shape[1:]))
        g_inputs = torch.zeros_like(g_out)
        g_leaves = [torch.zeros_like(w) for w in leaves]
        g_sent = torch.zeros_like(g_out[0])  # the cotangent of the hand-off this rank received at tick t + 1
        for t in reversed(range(S + m - 1)):
            g_y = _coll._ppermute(g_sent, mesh, pp_axis, -1)
            idx = t - s
            if 0 <= idx < m:
                if s == S - 1:
                    g_y = g_y + g_out[idx]
                with torch.enable_grad():
                    x_in = ctx.saved[t].detach().requires_grad_()
                    w = [leaf.detach().requires_grad_(leaf.requires_grad) for leaf in leaves]
                    y = ctx.block_fn(dict(zip(ctx.keys, w)), x_in)
                    wrt = [x_in] + [a for a in w if a.requires_grad]
                    grads = list(torch.autograd.grad(y, wrt, g_y, allow_unused=True))
                g_x = grads.pop(0)
                g_x = torch.zeros_like(x_in) if g_x is None else g_x
                for i, a in enumerate(w):
                    if a.requires_grad:
                        g = grads.pop(0)
                        if g is not None:
                            g_leaves[i] += g
            else:
                g_x = g_y
            if s == 0:  # stage 0 reads its microbatches, never the hand-off
                if 0 <= idx < m:
                    g_inputs[idx] += g_x
                g_sent = torch.zeros_like(g_sent)
            else:
                g_sent = g_x
        ctx.saved = None
        return (g_inputs.reshape(ctx.x_shape), None, None, None, None, None, *g_leaves)


def pipeline_apply(stage_params: Dict[str, torch.Tensor], x: torch.Tensor,
                   block_fn: Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor], *, mesh,
                   pp_axis: str = "pp", num_microbatches: int) -> torch.Tensor:
    """Run ``x`` through ``S = axis_size(mesh, pp_axis)`` pipelined stages
    (the reference's ``pipeline_apply``), on every rank of the axis.

    What the reference's ``shard_map`` body sees: ``stage_params`` is this
    rank's stage, a dict of leaves ``(1, ...)`` (a block of
    :func:`stack_stage_params`); ``x`` is this rank's rows (its dp shard,
    and its sp slice of the sequence when the stages run ring attention),
    the same on every rank of the pp axis.  ``block_fn(params, x_mb)``
    runs one stage on one microbatch (same shape out), where ``params``
    holds the leaves without their leading 1.  ``num_microbatches`` must
    divide this rank's rows (the reference asserts it of each dp shard).
    Returns the last stage's output for ``x``, on every rank of the axis.
    Differentiable in ``x`` and in the stage's leaves."""
    _check_microbatches(x.shape[0], num_microbatches)
    keys = tuple(stage_params)
    leaves = [stage_params[k] for k in keys]

    def local(params, x_mb):
        return block_fn({k: v[0] for k, v in params.items()}, x_mb)

    return _Pipeline.apply(x, local, keys, mesh, pp_axis, int(num_microbatches), *leaves)


def stack_stage_params(layer_params_list: Sequence[Dict[str, Any]], num_stages: int, *,
                       mesh: Any = None, pp_axis: str = "pp") -> Dict[str, Any]:
    """Group per-layer dicts of leaves into ``num_stages`` stacked stages:
    each leaf gains leading dims ``(num_stages, layers_per_stage)``, stage
    ``s`` holding layers ``[s·per, (s+1)·per)``.  A value that is itself a
    dict of leaves (an MoE layer's ``moe``) is stacked leaf by leaf into a
    dict of the same keys, as the reference's ``tree.map`` stacks every
    leaf of the pytree.  With a ``mesh`` a rank keeps only its stage's
    ``(1, per, ...)`` block (rank ``s`` of ``pp_axis``), built from its
    own layers: the whole stack never exists on a rank.  Differentiable (a
    stack of the layers' tensors)."""
    n = len(layer_params_list)
    if num_stages < 1 or n % num_stages:
        raise ValueError(f"{n} layers do not split into {num_stages} stages")
    per = n // num_stages
    stages = range(num_stages)
    if mesh is not None:
        if axis_size(mesh, pp_axis) != num_stages:
            raise ValueError(f"num_stages={num_stages} but the mesh's {pp_axis} axis has "
                             f"{axis_size(mesh, pp_axis)} ranks")
        stages = [axis_index(mesh, pp_axis)]

    def stack(layers):
        return {k: stack([layer[k] for layer in layers]) if isinstance(v, dict) else
                torch.stack([torch.stack([layers[s * per + j][k] for j in range(per)]) for s in stages])
                for k, v in layers[0].items()}

    return stack(list(layer_params_list))


def scale_grad(x: torch.Tensor, factor: float) -> torch.Tensor:
    """``x`` unchanged, its gradient times ``factor``."""
    return _ScaleGrad.apply(x, float(factor))


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.factor, None


__all__ = ["pipeline_apply", "scale_grad", "stack_stage_params"]
