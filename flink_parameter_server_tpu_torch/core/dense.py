"""DenseParameterServer: the PS API stretched to a dense model.

Counterpart of ``flink_parameter_server_tpu/core/dense.py`` (BASELINE
config #5, "Transformer-base LM data-parallel").  For a dense model the
keyed ``pull(id) / push(id, delta)`` protocol becomes "pull everything /
push one gradient": the server is the model plus an optimizer, and a push
folds the (dp-reduced) gradient through the optimizer's update.

Unlike the reference, whose server is immutable and whose push returns a
new server, this one updates the model's parameters and the optimizer's
state IN PLACE (``push`` returns ``self``).  :func:`transform_dense` works
on copies, so the caller's server is left as it was, as the reference's
donating step does.

**Across devices: one rank a device.**  The reference lets XLA insert the
gradient all-reduce from the batch's dp sharding.  The port runs one
process per device under ``torch.distributed`` (``parallel/``) and writes
each collective out (``parallel/collectives.py``, counted):

* Every rank reads the same global microbatch; the step cuts it into
  contiguous row slices over ``dp`` (:func:`~..parallel.collectives.
  dp_rows`; the rows must divide by dp) and calls ``loss_fn(params,
  rows)`` on this rank's slice.
* **Two loss routes.**  A loss made by
  :func:`~..parallel.collectives.global_mean` (``lm_loss(mesh=)`` /
  ``next_token_xent(mesh=)``: a masked token sum over the WHOLE batch's
  count of valid tokens) is already the global value, and its gradient is
  this rank's part: the step SUMS the ranks' gradients.  Any other loss
  is taken as a mean whose normalisation is the same on every slice (a
  plain ``mean`` over equal slices): the step sums ``loss / dp``'s
  gradients and reports the mean of the ranks' losses.  A loss that
  normalises by a count that differs between slices (a masked mean) must
  go through ``global_mean``; the mean route would weight the slices
  wrongly.  A loss_fn that makes a ``global_mean`` but returns another
  tensor (``global_mean(...) + reg``) raises ``ValueError``: the sum is
  on neither route.
* **Replicated** (no ``shard_opt_state``, no FSDP): one all-reduce of the
  gradients (and the loss) a step; every rank runs the whole update.
* **ZeRO-1** (``shard_opt_state=True``): each eligible parameter is split
  on its first axis that divides by dp (:func:`opt_state_zero1_specs`, the
  reference's ``_merged_dp_specs``); one reduce-scatter gives each rank
  the summed gradient of its slice, the optimizer steps only that slice
  (its moments are created slice-shaped, so a rank holds 1/dp of them),
  and one all-gather puts the updated slices back together.  The port's
  optimizers are elementwise, so this computes what the replicated update
  computes.  Leaves with no such axis (scalars, odd shapes) stay
  replicated and take the all-reduce.
* **FSDP** (:func:`fsdp_place`): between steps a rank holds only its
  slice of each eligible parameter (and so of its moments).  The step
  all-gathers the slices before the forward, reduce-scatters the
  gradients and updates the slices.

**Model parallelism** (``models/transformer.py``, ``models/moe.py``): the
step cuts the batch over ``dp`` only and sums every gradient over ``dp``.
A model records its layout with :func:`set_model_layout` (the LM does on
an ep, tp, sp or pp mesh): the leaves split over a model-parallel axis (an
expert leaf ``("ep", None, None)``, Megatron's ``wqkv`` ``(None, "tp")``, a
pipeline stage's ``("pp", None, ...)``), and the axes whose ranks hold
different tokens or stages (``sp``, ``pp``): every leaf not split over
such an axis has its gradient summed over it too.  A split leaf keeps its
local gradient; a tp-replicated leaf needs no tp sum (Megatron's conjugate
pair already makes its gradient whole on every tp rank), and an expert's
gradient is already its dp row's (``moe_apply``).  ZeRO-1's and FSDP's
specs merge ``dp`` into the layout, as the reference's
``_merged_dp_specs`` merges into each leaf's sharding (``wqkv`` becomes
``("dp", "tp")``, ``wo`` ``("tp", "dp")``), and :func:`gather_params`
gathers the split leaves whole.

A one-rank mesh gives the unsharded step's bits: every collective is then
a copy.  In the port each of the three regimes is a choice of the step;
the reference's GSPMD also hands back ZeRO-1's parameters dp-sharded after
a step, while here ZeRO-1 keeps them whole (that is FSDP's layout).
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .optim import OptimizerFactory
from .transform import TransformResult, to_device
from ..parallel import collectives as _coll
from ..parallel.mesh import DP_AXIS, axis_index, axis_size, require_axis

LossFn = Callable[[nn.Module, Any], torch.Tensor]
Spec = Optional[Tuple[Optional[str], ...]]  # per leaf: the axis names of its dims, or None (replicated)

_FSDP = "_fps_fsdp"  # the attribute fsdp_place sets on the module
_LAYOUT = "_fps_model_layout"  # the attribute set_model_layout sets on the module


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


# ------------------------------------------------------------------ the dp layout


def _leaf_spec(shape: Sequence[int], dp: int, dp_axis: str, current: Spec = None) -> Spec:
    """The reference's ``_merged_dp_specs`` for one leaf: ``dp_axis`` on
    the first unsharded axis of ``current`` that divides by ``dp``; None
    for a scalar, a leaf already split over ``dp_axis`` or one with no
    such axis."""
    if len(shape) < 1:
        return None
    cur = tuple(current or ()) + (None,) * (len(shape) - len(current or ()))
    used = set()
    for e in cur:
        used.update((e,) if isinstance(e, str) else (e or ()))
    if dp_axis in used:
        return None
    for i, size in enumerate(shape):
        if cur[i] is None and int(size) % dp == 0:
            return cur[:i] + (dp_axis,) + cur[i + 1:]
    return None


class _ModelLayout:
    """What :func:`set_model_layout` recorded: the mesh, the spec of each
    leaf split over a model-parallel axis and the group count of a grouped
    split, by parameter name, and the axes whose gradients are summed."""

    def __init__(self, mesh, specs: Dict[str, Spec], sum_axes: Tuple[str, ...] = (),
                 groups: Optional[Dict[str, int]] = None):
        self.mesh, self.specs, self.sum_axes, self.groups = mesh, specs, tuple(sum_axes), dict(groups or {})

    def __deepcopy__(self, memo):  # a copied module keeps the one mesh
        return self


def set_model_layout(params: nn.Module, mesh, specs: Dict[str, Spec], *, sum_axes: Sequence[str] = (),
                     groups: Optional[Dict[str, int]] = None) -> nn.Module:
    """Record that this rank holds only its ``mesh`` slice of the named
    parameters, each along the axes its spec names (e.g. an expert leaf
    ``("ep", None, None)``: this rank's experts); returns ``params``.  The
    reference reads a leaf's layout from its sharding; a torch tensor has
    none, so the module carries it.  :func:`opt_state_zero1_specs` and
    :func:`fsdp_place` merge ``dp`` into it; :func:`gather_params` gathers
    those leaves whole.

    ``sum_axes``: axes whose ranks compute different parts of the loss
    (sp: other tokens; pp: other stages): the dense step sums the gradient
    of every leaf not split over such an axis over it.  ``groups``: a leaf
    whose split dim is ``g`` groups side by side, each split over the axis
    alike (Megatron's ``wqkv``: a rank holds its columns of each of q, k
    and v), by name; the gather interleaves the ranks' blocks group by
    group."""
    names = {n for n, _ in params.named_parameters()}
    unknown = sorted((set(specs) | set(groups or {})) - names)
    if unknown:
        raise ValueError(f"set_model_layout: no parameters named {unknown}")
    setattr(params, _LAYOUT, _ModelLayout(mesh, dict(specs), tuple(sum_axes), groups))
    return params


def model_layout(params: nn.Module) -> Optional[_ModelLayout]:
    """The layout :func:`set_model_layout` recorded on ``params``, or None."""
    return getattr(params, _LAYOUT, None)


def _current_specs(params: Optional[nn.Module]) -> Dict[int, Spec]:
    """Each parameter's model-parallel spec, by ``id`` (empty without a
    recorded layout)."""
    layout = model_layout(params) if params is not None else None
    if layout is None:
        return {}
    return {id(p): layout.specs.get(n) for n, p in params.named_parameters()}


def _opt_params(opt: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [p for group in opt.param_groups for p in group["params"]]


def opt_state_zero1_specs(opt: torch.optim.Optimizer, mesh, dp_axis: str = DP_AXIS, *,
                          params: Optional[nn.Module] = None) -> List[Spec]:
    """Per-parameter ZeRO-1 specs for the optimizer ``opt`` (one entry per
    parameter, in ``opt.param_groups`` order): the tuple of axis names of
    the parameter's dims with ``dp_axis`` merged into its first free axis
    that divides by dp, or None (left replicated).  Every state tensor of a
    parameter with a spec (Adam's moments: the parameter's shape) is split
    the same way; scalar state (the step count) stays replicated.  Call it
    with the parameters whole (the step does).

    ``params``: the module ``opt`` steps.  Its recorded model-parallel
    layout (:func:`set_model_layout`) is each leaf's current spec, which
    ``dp`` merges into, as the reference's specs merge into a placed
    leaf's sharding; the sizes are this rank's (an expert leaf's local
    experts).  On a mesh of more than one axis it is required: only the
    module knows which leaves a model-parallel axis splits."""
    require_axis(mesh, dp_axis, "opt_state_zero1_specs")
    if params is None and len(mesh.mesh_dim_names) > 1:
        raise ValueError(
            f"mesh has axes {mesh.mesh_dim_names}: pass params=<the module opt steps> so dp "
            f"merges with its recorded model-parallel layout instead of overwriting it"
        )
    dp = axis_size(mesh, dp_axis)
    current = _current_specs(params)
    return [_leaf_spec(tuple(p.shape), dp, dp_axis, current.get(id(p))) for p in _opt_params(opt)]


def _split_axis(spec: Spec, dp_axis: str) -> Optional[int]:
    return None if spec is None else spec.index(dp_axis)


def _owned(x: torch.Tensor, axis: int, dp: int, d: int) -> torch.Tensor:
    """Rank ``d``'s slice of ``x`` along ``axis`` (a contiguous copy)."""
    c = x.shape[axis] // dp
    return x.narrow(axis, d * c, c).contiguous()


def shard_opt_state_constraint(opt: torch.optim.Optimizer, mesh, dp_axis: str = DP_AXIS,
                               specs: Optional[Sequence[Spec]] = None) -> torch.optim.Optimizer:
    """ZeRO-1: cut every state tensor of ``opt`` that has its parameter's
    whole shape down to this rank's dp slice (the reference's
    ``with_sharding_constraint`` on the optimizer state), in place; returns
    ``opt``.  State already cut, scalar state and parameters whose spec is
    None are left alone, so calling it again changes nothing.

    ``specs``: from :func:`opt_state_zero1_specs`.  Without them a
    multi-axis mesh raises, as the reference's does (a model-parallel
    layout must be merged, never overwritten)."""
    require_axis(mesh, dp_axis, "shard_opt_state_constraint")
    if specs is None:
        if len(mesh.mesh_dim_names) > 1:
            raise ValueError(
                f"mesh has axes {mesh.mesh_dim_names}: pass "
                f"specs=opt_state_zero1_specs(opt, mesh, params=model) so dp merges "
                f"with the model-parallel layout instead of overwriting it"
            )
        specs = opt_state_zero1_specs(opt, mesh, dp_axis)
    dp, d = axis_size(mesh, dp_axis), axis_index(mesh, dp_axis)
    if dp == 1:  # the one slice is the whole tensor
        return opt
    for p, spec in zip(_opt_params(opt), specs):
        axis = _split_axis(spec, dp_axis)
        state = opt.state.get(p)
        if axis is None or not state:
            continue
        for key, t in state.items():
            if isinstance(t, torch.Tensor) and tuple(t.shape) == tuple(p.shape):
                state[key] = _owned(t, axis, dp, d)
    return opt


class _FSDPLayout:
    """What :func:`fsdp_place` did: the mesh, the dp axis, and each
    parameter's spec, by parameter name."""

    def __init__(self, mesh, dp_axis: str, specs: Dict[str, Spec]):
        self.mesh, self.dp_axis, self.specs = mesh, dp_axis, specs

    def __deepcopy__(self, memo):  # a copied module keeps the one mesh
        return self


def fsdp_place(params: nn.Module, mesh, dp_axis: str = DP_AXIS) -> nn.Module:
    """FSDP (ZeRO-3): re-place ``params`` so this rank holds only its dp
    slice of each parameter that has an axis dividing by dp (the reference's
    ``_merged_dp_specs``, merged into a recorded model-parallel layout:
    :func:`set_model_layout`), in place; returns ``params``.  An optimizer built
    on the placed parameters creates slice-shaped moments, so parameters and
    optimizer state are both 1/dp at rest.  :func:`make_dense_train_step`
    (with or without ``mesh=``) sees the placement and all-gathers the
    slices before the forward, reduce-scatters the gradients and updates
    the slices.  :func:`gather_params` gives the whole model back."""
    require_axis(mesh, dp_axis, "fsdp_place")
    if getattr(params, _FSDP, None) is not None:
        raise ValueError("fsdp_place: the module is placed already")
    dp, d = axis_size(mesh, dp_axis), axis_index(mesh, dp_axis)
    current = _current_specs(params)
    specs = {}
    for name, p in params.named_parameters():
        specs[name] = _leaf_spec(tuple(p.shape), dp, dp_axis, current.get(id(p)))
        axis = _split_axis(specs[name], dp_axis)
        if axis is not None:
            p.data = _owned(p.data, axis, dp, d)
    setattr(params, _FSDP, _FSDPLayout(mesh, dp_axis, specs))
    return params


def fsdp_layout(params: nn.Module) -> Optional[_FSDPLayout]:
    """The placement :func:`fsdp_place` recorded on ``params``, or None."""
    return getattr(params, _FSDP, None)


# ------------------------------------------------------------------ flat collectives


def _moved(shape: Sequence[int], axis: int) -> Tuple[int, ...]:
    shape = tuple(shape)
    return (shape[axis],) + shape[:axis] + shape[axis + 1:]


def _gather_slices(leaves: List[Tuple[nn.Parameter, int]], mesh, dp_axis: str,
                   groups: Optional[Dict[int, int]] = None) -> None:
    """Replace each parameter's slice (``p.data``, cut along ``axis``) by the
    whole tensor: one all-gather over ``dp_axis`` (dp, or a model-parallel
    axis) per dtype of every slice, flat.  ``groups`` (by ``id`` of the
    parameter): its slice is g groups along ``axis``, and the whole tensor
    is group after group, each the ranks' parts in axis order."""
    dp = axis_size(mesh, dp_axis)
    by_dtype: Dict[torch.dtype, List[Tuple[nn.Parameter, int]]] = {}
    for p, axis in leaves:
        by_dtype.setdefault(p.dtype, []).append((p, axis))
    for group in by_dtype.values():
        own = torch.cat([p.data.movedim(axis, 0).reshape(-1) for p, axis in group])
        whole = _coll.all_gather_cat(own[None], mesh, dp_axis)  # (dp, N)
        off = 0
        for p, axis in group:
            n = p.numel()
            moved = _moved(p.shape, axis)
            g = (groups or {}).get(id(p), 1)
            part = whole[:, off:off + n].reshape((dp, g, moved[0] // g) + moved[1:]).transpose(0, 1)
            p.data = part.reshape((moved[0] * dp,) + moved[1:]).movedim(0, axis).contiguous()
            off += n


def _reduce_grads(params: List[nn.Parameter], axes: List[Optional[int]], mesh, dp_axis: str,
                  loss: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Sum every parameter's gradient over dp: the replicated ones (and
    ``loss``, when given) in one all-reduce, the split ones in one
    reduce-scatter that leaves each parameter holding its slice (``p.data``
    cut to it) and the slice's summed gradient.  A gradient of None counts
    as zeros (every rank must send the same buffers).  Returns the summed
    ``loss``."""
    dp, d = axis_size(mesh, dp_axis), axis_index(mesh, dp_axis)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    wide = torch.float64 if any(g.dtype == torch.float64 for g in grads) else torch.float32
    rep = [i for i, a in enumerate(axes) if a is None]
    parts = [grads[i].reshape(-1).to(wide) for i in rep]
    if loss is not None:
        parts.append(loss.detach().reshape(1).to(wide))
    summed_loss = None
    if parts:
        red = _coll.all_reduce_sum(torch.cat(parts), mesh, dp_axis)
        off = 0
        for i in rep:
            n = grads[i].numel()
            params[i].grad = red[off:off + n].reshape(grads[i].shape).to(params[i].dtype)
            off += n
        if loss is not None:
            summed_loss = red[off].to(loss.dtype)
    split = [i for i, a in enumerate(axes) if a is not None]
    if split:
        buf = torch.cat([grads[i].movedim(axes[i], 0).reshape(dp, -1).to(wide) for i in split], dim=1)
        own = _coll.reduce_scatter_sum(buf, mesh, dp_axis)[0]
        off = 0
        for i in split:
            p, axis = params[i], axes[i]
            p.grad = None
            p.data = _owned(p.data, axis, dp, d)
            n = p.numel()
            p.grad = own[off:off + n].reshape(_moved(p.shape, axis)).movedim(0, axis).to(p.dtype).contiguous()
            off += n
    return summed_loss


def gather_params(params: nn.Module) -> nn.Module:
    """A copy of ``params`` with every parameter whole: an FSDP-placed
    module's slices all-gathered over its dp axis, then the leaves of a
    recorded model-parallel layout (an expert leaf's experts) over their
    axes (collectives: call it on every rank); any other module is copied
    as it is."""
    out = copy.deepcopy(params)
    layout = fsdp_layout(out)
    if layout is not None:
        leaves = [(p, _split_axis(layout.specs[name], layout.dp_axis)) for name, p in out.named_parameters()]
        with torch.no_grad():
            _gather_slices([(p, a) for p, a in leaves if a is not None], layout.mesh, layout.dp_axis)
        setattr(out, _FSDP, None)
    mp = model_layout(out)
    if mp is not None:
        axes = sorted({a for spec in mp.specs.values() for a in spec or () if isinstance(a, str)})
        named = list(out.named_parameters())
        groups = {id(p): mp.groups[n] for n, p in named if n in mp.groups}
        with torch.no_grad():
            for axis in axes:
                _gather_slices([(p, mp.specs[n].index(axis)) for n, p in named if axis in (mp.specs.get(n) or ())],
                               mp.mesh, axis, groups)
        setattr(out, _LAYOUT, None)
    return out


def _sum_over_model_axes(named: List[Tuple[str, nn.Parameter]], layout: Optional[_ModelLayout]) -> None:
    """Sum the gradients over the layout's ``sum_axes``: over each, one flat
    all-reduce of the gradients of every leaf not split over that axis (a
    gradient of None counts as zeros)."""
    if layout is None:
        return
    for axis in layout.sum_axes:
        leaves = [p for n, p in named if axis not in (layout.specs.get(n) or ())]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
        wide = torch.float64 if any(g.dtype == torch.float64 for g in grads) else torch.float32
        red = _coll.all_reduce_sum(torch.cat([g.reshape(-1).to(wide) for g in grads]), layout.mesh, axis)
        off = 0
        for p, g in zip(leaves, grads):
            p.grad = red[off:off + g.numel()].reshape(g.shape).to(p.dtype)
            off += g.numel()


# ------------------------------------------------------------------ the step


def make_dense_train_step(loss_fn: LossFn, *, mesh=None, dp_axis: str = DP_AXIS,
                          shard_opt_state: bool = False, opt_specs: Optional[Sequence[Spec]] = None) -> Callable:
    """Fused pull -> grad -> push: ``step(params, opt, batch) -> (params,
    opt, loss)`` with ``opt`` the ``torch.optim`` optimizer over ``params``.
    Updates ``params`` and ``opt`` in place; ``loss`` is detached (on a
    mesh: the whole batch's loss, the same on every rank).

    ``mesh``: a ``DeviceMesh`` with a ``dp_axis`` axis (the ``("dp",)``
    mesh, ``(dp, ps)``, or one with model-parallel axes: ep, tp, sp, pp);
    ``batch`` is then the global microbatch and the step trains on this
    rank's dp rows (the module docstring has the two loss routes);
    gradients are summed over dp, and over the model's recorded
    ``sum_axes`` (:func:`set_model_layout`).  ``params`` placed by
    :func:`fsdp_place` take FSDP on the placement's mesh, with or without
    ``mesh=``.

    ``shard_opt_state=True`` (requires ``mesh``): ZeRO-1 through
    :func:`shard_opt_state_constraint`.  On a multi-axis mesh also pass
    ``opt_specs=opt_state_zero1_specs(opt, mesh, params=model)``, as the
    reference asks."""
    if shard_opt_state:
        if mesh is None:
            raise ValueError("shard_opt_state=True requires mesh")
        require_axis(mesh, dp_axis, "make_dense_train_step")
        if opt_specs is None and len(mesh.mesh_dim_names) > 1:
            raise ValueError(
                f"mesh has axes {mesh.mesh_dim_names}: pass "
                f"opt_specs=opt_state_zero1_specs(server.opt, mesh, params=server.params) "
                f"so dp merges with the model-parallel layout instead of overwriting it"
            )
    elif mesh is not None:
        require_axis(mesh, dp_axis, "make_dense_train_step")

    def plain(params, opt, batch):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch)
        loss.backward()
        opt.step()
        return params, opt, loss.detach()

    def sharded(params, opt, batch):
        layout = fsdp_layout(params)
        m, ax = (mesh, dp_axis) if layout is None else (layout.mesh, layout.dp_axis)
        named = list(params.named_parameters())
        plist = [p for _, p in named]
        opt.zero_grad(set_to_none=True)
        if layout is not None:
            axes = [_split_axis(layout.specs[name], ax) for name, _ in named]
            with torch.no_grad():
                _gather_slices([(p, a) for p, a in zip(plist, axes) if a is not None], m, ax)
        elif shard_opt_state:
            # without opt_specs the mesh has one axis (checked above): no layout to merge
            specs = opt_specs if opt_specs is not None else opt_state_zero1_specs(opt, m, ax)
            by_param = {id(p): s for p, s in zip(_opt_params(opt), specs)}
            axes = [_split_axis(by_param.get(id(p)), ax) for p in plist]
            shard_opt_state_constraint(opt, m, ax, specs)
        else:
            axes = [None] * len(plist)
        made = _coll.global_means_made()
        loss = loss_fn(params, _coll.dp_rows(batch, m, ax))
        summed = _coll.is_global_mean(loss)
        if not summed and _coll.global_means_made() != made:
            raise ValueError(
                "loss_fn made a global_mean but returned another tensor (arithmetic on "
                "global_mean's result drops its mark), so the step cannot tell the loss's "
                "route: return global_mean's result itself (the sum route: the ranks' "
                "gradients are summed), or a mean over equal slices made without "
                "global_mean (the mean route: loss / dp's gradients are summed)"
            )
        dp = axis_size(m, ax)
        (loss if summed else loss / dp).backward()
        with torch.no_grad():
            _sum_over_model_axes(named, model_layout(params))
            total = _reduce_grads(plist, axes, m, ax, None if summed else loss)
        opt.step()
        if layout is None and shard_opt_state:
            with torch.no_grad():
                _gather_slices([(p, a) for p, a in zip(plist, axes) if a is not None], m, ax)
        return params, opt, loss.detach() if summed else total / dp

    def step(params, opt, batch):
        if mesh is None and fsdp_layout(params) is None:
            return plain(params, opt, batch)
        return sharded(params, opt, batch)

    return step


def transform_dense(
    data: Iterable,
    loss_fn: LossFn,
    server: DenseParameterServer,
    *,
    batch_sharding=None,
    shard_opt_state: bool = False,
    on_step: Optional[Callable[[int, torch.Tensor], None]] = None,
    steps_per_call: int = 1,
) -> TransformResult:
    """The ``transform`` loop for the dense case: one pull -> grad -> push
    per microbatch, on the device of the server's model.  Returns the
    per-step losses (detached scalar tensors) as worker outputs and the
    final model as the server dump.

    ``batch_sharding``: the reference shards the batch with a
    ``NamedSharding(mesh, P("dp"))``; here it is the ``DeviceMesh`` itself
    (with a ``"dp"`` axis: the dp mesh or the ``("dp", "ep")`` one).  Every
    rank iterates the same global ``data``, and each step trains on this
    rank's rows through :func:`make_dense_train_step` (``shard_opt_state``
    passes to it, with the specs of the server's model,
    :func:`opt_state_zero1_specs`; a server whose model :func:`fsdp_place`
    placed trains FSDP).
    The losses are the whole batch's, the same on every rank; the final
    model keeps the step's layout (:func:`gather_params` makes an FSDP one
    whole).

    ``steps_per_call=K`` runs K microbatches per call as a loop, then
    reports their losses and ``on_step`` calls; a trailing group shorter
    than K runs one step at a time.  Unlike the reference, where K steps
    are one fused dispatch, here K changes only when the ``on_step``
    callbacks fire: the steps and their launches are the same for any K
    (ROADMAP Queue 1 #11 makes a group one CUDA graph).  The server is
    copied first (model and optimizer state), so the caller's stays as it
    was."""
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call={steps_per_call}: must be >= 1")
    if batch_sharding is not None:
        from torch.distributed.device_mesh import DeviceMesh

        if not isinstance(batch_sharding, DeviceMesh):
            raise ValueError(
                f"batch_sharding is the dp DeviceMesh (parallel.mesh.make_dp_mesh), "
                f"got {type(batch_sharding).__name__}"
            )
    params = copy.deepcopy(server.params)
    final = DenseParameterServer(params, server.optimizer, server.opt_state)
    specs = None
    if shard_opt_state and batch_sharding is not None:
        specs = opt_state_zero1_specs(final.opt, batch_sharding, params=params)
    step = make_dense_train_step(loss_fn, mesh=batch_sharding, shard_opt_state=shard_opt_state, opt_specs=specs)
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


__all__ = [
    "DenseParameterServer",
    "fsdp_layout",
    "fsdp_place",
    "gather_params",
    "make_dense_train_step",
    "model_layout",
    "opt_state_zero1_specs",
    "set_model_layout",
    "shard_opt_state_constraint",
    "transform_dense",
]
