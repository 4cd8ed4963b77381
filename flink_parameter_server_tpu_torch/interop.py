"""Carry tables and worker state between the JAX package and the port.

The two packages share no code, so arrays cross as numpy.  A store crosses
as its PHYSICAL table (padding rows and, for ``layout="packed"``, the
packed lanes included): the port's ``StoreSpec`` arithmetic is the
reference's, so the same spec fields give the same table shape and every
element keeps its place.  numpy has no bfloat16 of its own, so a bfloat16
array crosses widened to float32 and is narrowed again on arrival (exact:
every bfloat16 value is a float32 value).

From the JAX side::

    spec = spec_from_reference(jax_store.spec)
    store = store_from_numpy(spec, np.asarray(jax_store.table, np.float32))
    state = state_from_numpy(np.asarray(jax_user_state, np.float32))

and back: ``to_numpy(store.table)`` is the reference's physical table
(``jax.numpy.asarray(arr, spec.dtype)``), ``to_numpy(state)`` its state.

A store sharded over the reference's ``ps`` axis crosses the same way onto
a port mesh with the same ``ps`` size: ``spec_from_reference(ref_spec,
mesh=mesh)``, then every rank passes the whole physical table to
:func:`store_from_numpy` and keeps its row block.

The LM's parameter pytree crosses the same way, leaf for leaf
(:func:`transformer_params_from_numpy`, :func:`transformer_params_to_numpy`),
onto any mesh the LM takes too: every rank passes the whole tree and keeps
its share (its experts, its tp columns and rows, its pp stage), and
:func:`dense_server_from_numpy` builds the dense server on it, FSDP-placed
when asked (ZeRO-1 needs no placement: the step cuts the optimizer state).
:func:`transformer_params_to_numpy` of a model split over a mesh
all-gathers it first (``wqkv`` back in the reference's ``[q | k | v]``
order, the stages back into layers), so call it on every rank.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .core.store import ShardedParamStore, StoreSpec
from .models.transformer import LAYER_KEYS, MOE_KEYS, TransformerConfig, TransformerLM, build_lm
from .parallel.mesh import axis_size
from .utils.device import DeviceLike, mesh_resolve_device, resolve_device

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float64": torch.float64,
    "int32": torch.int32,
    "int64": torch.int64,
}


def torch_dtype(dtype: Any) -> torch.dtype:
    """A torch dtype from a torch dtype, a dtype name, or anything numpy
    reads as a dtype (the reference's ``jnp.float32`` and friends)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _DTYPES:
        raise ValueError(f"no torch dtype for {dtype!r}")
    return _DTYPES[name]


def spec_from_reference(ref: Any, *, mesh: Any = None) -> StoreSpec:
    """The port's :class:`StoreSpec` for a reference ``StoreSpec`` (read
    by attribute, so nothing of the JAX package is imported).  Only
    ``update="add"`` crosses: a custom update is a JAX function.  A
    reference store sharded over ``ps`` needs a port ``mesh`` with the
    same ``ps`` size (the shapes then match element for element)."""
    ref_ps = 1 if ref.mesh is None else int(ref.mesh.shape[ref.ps_axis])
    if ref_ps != axis_size(mesh, ref.ps_axis):
        raise ValueError(
            f"the reference store has {ref_ps} ps shards; pass a port mesh with "
            f"the same ps size (got {axis_size(mesh, ref.ps_axis)})"
        )
    if ref.update != "add":
        raise ValueError("only update='add' stores cross between the packages")
    return StoreSpec(
        capacity=ref.capacity,
        value_shape=tuple(ref.value_shape),
        dtype=torch_dtype(ref.dtype),
        scatter_impl=ref.scatter_impl,
        mesh=mesh,
        ps_axis=ref.ps_axis,
        layout=ref.layout,
    )


def store_from_numpy(spec: StoreSpec, table: np.ndarray, *, device: DeviceLike = None) -> ShardedParamStore:
    """A store from the reference's physical table (the whole table; on
    a mesh each rank keeps its block of ``rows_per_shard`` rows)."""
    table = np.asarray(table)
    if tuple(table.shape) != tuple(spec.table_shape()):
        raise ValueError(
            f"table shape {tuple(table.shape)} != spec.table_shape() {spec.table_shape()}"
        )
    lo = spec.shard_index * spec.rows_per_shard
    block = np.array(table[lo:lo + spec.rows_per_shard])  # a copy: the source may be read-only
    dev = mesh_resolve_device(spec.mesh, device)
    return ShardedParamStore(spec, torch.from_numpy(block).to(dev, spec.dtype).contiguous())


def state_from_numpy(state: np.ndarray, *, dtype: Any = torch.float32, device: DeviceLike = None) -> torch.Tensor:
    """Worker state (e.g. MF user factors) from the reference's array."""
    t = torch.from_numpy(np.array(state))
    return t.to(resolve_device(device), torch_dtype(dtype)).contiguous()


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A table or state tensor as numpy (bfloat16 widened to float32)."""
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.detach().cpu().numpy()


def transformer_params_from_numpy(tree: Dict[str, Any], cfg: TransformerConfig, *,
                                  device: DeviceLike = None, mesh: Any = None) -> TransformerLM:
    """The LM from the reference's parameter pytree as numpy (``embed``,
    ``final_norm``, ``layers[i].{attn_norm, wqkv, wo, mlp_norm, w_up,
    w_down}``, or ``layers[i].moe.{w_gate, w_up, w_down}`` in place of the
    MLP; bfloat16 leaves widened to float32).  Layouts are the reference's,
    so the copy is element for element: weights narrow to ``cfg.dtype``,
    norm gains stay float32.  With a ``mesh`` the model is on this rank's
    device, replicated over dp; on a mesh with ``cfg.ep_axis`` (and no pp
    axis) each rank keeps its experts' slice of every MoE layer's whole
    ``(E, ...)`` leaves (``models.moe.local_experts``), on a tp mesh its
    heads' columns of ``wqkv`` (of each of q, k and v), its rows of ``wo``
    and its share of a dense MLP (an MoE layer whole), on a pp mesh its
    stage's layers stacked and whole, experts included; the model records
    that layout, as ``init_params(mesh=)`` does (``build_lm``,
    ``check_lm_mesh``)."""
    experts = slice(None)
    if mesh is not None:
        from .models.moe import local_experts
        from .models.transformer import _experts_split, check_lm_mesh
        from .parallel.mesh import mesh_device

        check_lm_mesh(mesh, cfg)
        device = mesh_device(mesh) if device is None else device
        if _experts_split(mesh, cfg):
            experts = local_experts(cfg.num_experts, mesh, cfg.ep_axis)
    dev = resolve_device(device)

    def leaf(x, dtype):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev, dtype)

    def block(layer):
        keys = [k for k in LAYER_KEYS if not ("moe" in layer and k in ("w_up", "w_down"))]
        out = {key: leaf(layer[key], torch.float32 if key.endswith("norm") else cfg.dtype) for key in keys}
        if "moe" in layer:
            out["moe"] = {key: leaf(np.asarray(layer["moe"][key])[slice(None) if key == "w_gate" else experts],
                                    cfg.dtype) for key in MOE_KEYS}
        return out

    layers = [block(layer) for layer in tree["layers"]]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers in the tree, cfg.n_layers={cfg.n_layers}")
    return build_lm(cfg, leaf(tree["embed"], cfg.dtype), leaf(tree["final_norm"], torch.float32), layers, mesh)


def dense_server_from_numpy(tree: Dict[str, Any], cfg: TransformerConfig, optimizer, *, mesh: Any = None,
                            fsdp: bool = False, device: DeviceLike = None):
    """A :class:`~.core.dense.DenseParameterServer` over the LM carried
    from the reference's pytree (:func:`transformer_params_from_numpy`),
    its parameters FSDP-placed over ``mesh``'s dp axis when ``fsdp``."""
    from .core.dense import DenseParameterServer, fsdp_place

    model = transformer_params_from_numpy(tree, cfg, device=device, mesh=mesh)
    if fsdp:
        if mesh is None:
            raise ValueError("fsdp=True needs the dp mesh")
        fsdp_place(model, mesh, cfg.dp_axis)
    return DenseParameterServer(model, optimizer)


def transformer_params_to_numpy(model: TransformerLM) -> Dict[str, Any]:
    """The reference's pytree layout as numpy (bfloat16 widened to float32);
    an FSDP-placed model, or one split over a model-parallel axis (experts
    over ``ep``, Megatron's columns and rows over ``tp``, stages over
    ``pp``), is gathered whole first (collectives: call it on every rank),
    and a pipeline model's stacked stages become its layers again."""
    from .core.dense import fsdp_layout, gather_params, model_layout

    if fsdp_layout(model) is not None or model_layout(model) is not None:
        model = gather_params(model)

    def block(layer):
        if hasattr(layer, "moe"):
            out = {key: to_numpy(getattr(layer, key)) for key in LAYER_KEYS if key not in ("w_up", "w_down")}
            out["moe"] = {key: to_numpy(layer.moe[key]) for key in MOE_KEYS}
            return out
        return {key: to_numpy(getattr(layer, key)) for key in LAYER_KEYS}

    if hasattr(model, "stages"):  # (S, per, ...) whole: layer s·per + j is [s, j]
        stacked = {k: to_numpy(v) for k, v in model.stages.named_parameters()}
        S, per = stacked["wqkv"].shape[:2]

        def unstack(s, j):
            layer = {k: v[s, j] for k, v in stacked.items() if not k.startswith("moe.")}
            if "moe.w_gate" in stacked:
                layer["moe"] = {k: stacked["moe." + k][s, j] for k in MOE_KEYS}
            return layer

        layers = [unstack(s, j) for s in range(S) for j in range(per)]
    else:
        layers = [block(layer) for layer in model.layers]
    return {
        "embed": to_numpy(model.embed),
        "final_norm": to_numpy(model.final_norm),
        "layers": layers,
    }


__all__ = [
    "torch_dtype", "spec_from_reference", "store_from_numpy", "state_from_numpy", "to_numpy",
    "transformer_params_from_numpy", "transformer_params_to_numpy", "dense_server_from_numpy",
]
