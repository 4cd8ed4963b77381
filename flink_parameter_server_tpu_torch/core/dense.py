"""DenseParameterServer: the PS API stretched to a dense model.

Counterpart of ``flink_parameter_server_tpu/core/dense.py`` (BASELINE
config #5).  For a dense model the keyed ``pull(id) / push(id, delta)``
protocol becomes "pull everything / push one gradient": the server is the
model plus an optimizer, and a push folds the gradient through the
optimizer's update.

Unlike the reference, whose server is immutable and whose push returns a
new server, this one updates the model's parameters and the optimizer's
state IN PLACE (``push`` returns ``self``).  :func:`transform_dense` works
on copies, so the caller's server is left as it was, as the reference's
donating step does.  Single-device: the dp allreduce, ZeRO-1 and FSDP wait
for ROADMAP Queue 1 #9.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Iterable, List, Optional, Sequence

import torch
from torch import nn

from .optim import OptimizerFactory
from .transform import TransformResult, to_device
from ..utils.device import reject_mesh

LossFn = Callable[[nn.Module, Any], torch.Tensor]


class DenseParameterServer:
    """(model, optimizer) with pull / push.

    ``optimizer`` is a factory from :mod:`.optim` (``adamw(lr)`` ...), kept
    as the reference keeps its ``GradientTransformation``; ``opt`` is the
    ``torch.optim`` optimizer it built over ``params``; ``opt_state`` is
    that optimizer's ``state_dict`` (pass one to resume)."""

    def __init__(self, params: nn.Module, optimizer: OptimizerFactory,
                 opt_state: Optional[dict] = None):
        self.params = params
        self.optimizer = optimizer
        self.opt = optimizer(params.parameters())
        if opt_state is not None:
            self.opt.load_state_dict(copy.deepcopy(opt_state))

    @property
    def opt_state(self) -> dict:
        return self.opt.state_dict()

    def pull(self) -> nn.Module:
        return self.params

    def push(self, grads: Sequence[Optional[torch.Tensor]]) -> "DenseParameterServer":
        """Apply one optimizer update, in place.  ``grads``: one tensor (or
        None) per parameter, in ``params.parameters()`` order, as
        ``torch.autograd.grad(loss, list(params.parameters()))`` gives them."""
        params = list(self.params.parameters())
        if len(grads) != len(params):
            raise ValueError(f"{len(grads)} gradients for {len(params)} parameters")
        for p, g in zip(params, grads):
            p.grad = None if g is None else g.to(p.device, p.dtype)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        return self

    def values(self) -> nn.Module:
        """Close-time model dump."""
        return self.params


def make_dense_train_step(loss_fn: LossFn, *, mesh=None, shard_opt_state: bool = False) -> Callable:
    """Fused pull -> grad -> push: ``step(params, opt, batch) -> (params,
    opt, loss)`` with ``opt`` the ``torch.optim`` optimizer over ``params``.
    Updates ``params`` and ``opt`` in place; ``loss`` is detached."""
    reject_mesh(mesh, "the dense train step over a mesh (the dp allreduce)")
    if shard_opt_state:
        raise NotImplementedError("ZeRO-1 optimizer-state sharding is multi-device: ROADMAP Queue 1 #9")

    def step(params: nn.Module, opt: torch.optim.Optimizer, batch: Any):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch)
        loss.backward()
        opt.step()
        return params, opt, loss.detach()

    return step


def transform_dense(
    data: Iterable,
    loss_fn: LossFn,
    server: DenseParameterServer,
    *,
    batch_sharding=None,
    on_step: Optional[Callable[[int, torch.Tensor], None]] = None,
    steps_per_call: int = 1,
) -> TransformResult:
    """The ``transform`` loop for the dense case: one pull -> grad -> push
    per microbatch, on the device of the server's model.  Returns the
    per-step losses (detached scalar tensors) as worker outputs and the
    final model as the server dump.

    ``steps_per_call=K`` runs K microbatches per call as a loop, then
    reports their losses and ``on_step`` calls; a trailing group shorter
    than K runs one step at a time.  Unlike the reference, where K steps
    are one fused dispatch, here K changes only when the ``on_step``
    callbacks fire: the steps and their launches are the same for any K
    (ROADMAP Queue 4 #4 makes a group one CUDA graph).  The server is
    copied first (model and optimizer state), so the caller's stays as it
    was."""
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call={steps_per_call}: must be >= 1")
    reject_mesh(batch_sharding, "transform_dense with a batch sharding (the dp allreduce)")
    params = copy.deepcopy(server.params)
    final = DenseParameterServer(params, server.optimizer, server.opt_state)
    step = make_dense_train_step(loss_fn)
    device = next(params.parameters()).device
    losses: List[torch.Tensor] = []

    def run(group):
        group_losses = []
        for batch in group:
            _, _, loss = step(params, final.opt, to_device(batch, device))
            group_losses.append(loss)
        for loss in group_losses:
            if on_step is not None:
                on_step(len(losses), loss)
            losses.append(loss)

    group: List[Any] = []
    for batch in data:
        group.append(batch)
        if len(group) == steps_per_call:
            run(group)
            group = []
    for batch in group:  # tail shorter than K
        run([batch])

    return TransformResult(
        worker_outputs=losses,
        server_outputs=[final.values()],
        store=None,
        worker_state=None,
    )


__all__ = ["DenseParameterServer", "make_dense_train_step", "transform_dense"]
