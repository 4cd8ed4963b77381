"""ShardedParamStore — the keyed parameter store, on one device or row-blocked
over the ``ps`` axis of a device mesh.

Counterpart of ``flink_parameter_server_tpu/core/store.py``.  The store is
a dense ``(capacity, *value_shape)`` tensor (or its lane-packed form);
``pull(ids)`` is a row gather and ``push(ids, deltas)`` a scatter-add.
Lazy init on first pull in the reference system uses a deterministic
per-id initializer, so eager whole-table init at create time is
observationally the same.

The ``StoreSpec`` arithmetic (row alignment, padded capacity, physical
shape) is the reference's byte for byte, so the two packages' tables
compare element for element.

With ``mesh=`` (a ``dp × ps`` ``DeviceMesh``, :mod:`..parallel.mesh`) the
table is row-blocked over ``ps``: ``num_shards`` is the ``ps`` size and each
rank holds only its block of ``rows_per_shard`` physical rows, ``[s·R,
(s+1)·R)``, replicated over ``dp``.  ``create_table`` initialises that block
by id, so it is bitwise the block of the global table.  Every rank calls
``pull`` and ``push`` with the same global lanes, as the reference's one
controller does: a pull gathers the owned ids and assembles them with one
all-reduce over ``ps`` (bitwise the single-device gather); a push folds the
owned lanes into the block through the same ``scatter_impl`` arm, with
relative ids (lanes of other shards are dropped).  ``values()`` gathers the
whole table over ``ps`` on every rank.  A train step that splits a batch
over ``dp`` all-gathers its slices' requests first (``core/transform``).

Module-level :func:`push` updates the table in place and returns it — the
port's train step owns its table, as the reference's jitted step owns a
donated buffer.  :meth:`ShardedParamStore.push` stays functional: it
pushes into a copy.

``scatter_impl`` arms: ``"xla"`` is a row scatter-add
(``ops/rows.add_rows_``, which sums duplicates in a fixed order on the
card too); ``"xla_sorted"`` is
sort + segment-sum + one add per unique row (``ops/sorted_scatter.py``);
``"pallas"`` is the CUDA sorted-run kernel (``ops/scatter_kernel.py``), or
its plain version for a table on the CPU; both take float32, bfloat16 and
int32 tables and raise on any other type.  On a mesh every arm runs on the
rank's block; none falls back (the reference's Mosaic shape gates and
dp-divisibility fallbacks have no counterpart: K1 takes any block).  Duplicate ids in one push
combine additively.  A non-``"add"`` ``update`` sums duplicate deltas
first and applies ``update`` once per touched row.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple, Union

import torch

from ..ops import packed as _packed
from ..ops import scatter_kernel as _scatter
from ..ops.rows import add_rows_
from ..parallel import collectives as _coll
from ..parallel.mesh import axis_index, axis_size
from ..utils.device import DeviceLike, check_mesh, mesh_resolve_device

InitFn = Callable[[torch.Tensor], torch.Tensor]  # ids (n,) -> (n, *value_shape)
UpdateFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (current, delta) -> new

def pallas_fallback_count() -> int:
    """Pushes where a configured ``scatter_impl`` did not run: always 0.

    The reference counts its fallbacks to the XLA scatter (Mosaic shape
    gates, sharded batches).  The port has none: a table the kernel does
    not take raises.  Kept so code written against the reference runs."""
    return 0


def _resolve_layout(layout: str, update, value_shape: Tuple[int, ...]) -> str:
    """``"auto"`` picks packed for narrow-row add-stores, dense otherwise."""
    if layout not in ("dense", "packed", "auto"):
        raise ValueError(f"layout must be 'dense', 'packed' or 'auto', got {layout!r}")
    width = 1
    for s in value_shape:
        width *= int(s)
    if layout == "auto":
        return "packed" if (update == "add" and width < 128) else "dense"
    if layout == "packed" and update != "add":
        raise ValueError(
            "layout='packed' requires update='add' (custom update "
            "functions take the dense per-row path)"
        )
    return layout


@dataclasses.dataclass(frozen=True)
class StoreSpec:
    """Static configuration of a parameter store."""

    capacity: int
    value_shape: Tuple[int, ...] = ()
    dtype: torch.dtype = torch.float32
    update: Union[str, UpdateFn] = "add"
    scatter_impl: str = "xla"
    # a torch DeviceMesh with a ``ps_axis`` axis (parallel/mesh.py), or None
    mesh: Optional[Any] = None
    ps_axis: str = "ps"
    layout: str = "dense"

    def __post_init__(self) -> None:
        valid = ("xla", "pallas", "xla_sorted")
        if self.scatter_impl not in valid:
            raise ValueError(f"scatter_impl={self.scatter_impl!r} is not one of {valid}")
        if self.layout not in ("dense", "packed"):
            raise ValueError(f"layout={self.layout!r} is not one of ('dense', 'packed')")
        check_mesh(self.mesh, ps_axis=self.ps_axis)

    @property
    def num_shards(self) -> int:
        return axis_size(self.mesh, self.ps_axis)

    @property
    def shard_index(self) -> int:
        """This rank's ``ps`` coordinate (0 without a mesh)."""
        return axis_index(self.mesh, self.ps_axis)

    @property
    def row_width(self) -> int:
        w = 1
        for s in self.value_shape:
            w *= int(s)
        return w

    @property
    def pack(self) -> int:
        """Logical rows per physical row (1 for the dense layout)."""
        if self.layout != "packed":
            return 1
        return _packed.pack_k(self.row_width)

    @property
    def rows_per_shard(self) -> int:
        """Per-shard PHYSICAL row count, aligned to 8 rows as the
        reference's is (kept so the two packages' tables line up)."""
        n = self.num_shards
        logical = (self.capacity + self.pack - 1) // self.pack
        per = (logical + n - 1) // n
        return ((per + 7) // 8) * 8

    @property
    def padded_capacity(self) -> int:
        """LOGICAL capacity including padding rows (init'd, addressable)."""
        return self.rows_per_shard * self.num_shards * self.pack

    def table_shape(self) -> Tuple[int, ...]:
        """Shape of the physical table (the whole table across shards)."""
        if self.layout == "packed":
            return (self.rows_per_shard * self.num_shards, _packed.phys_width(self.row_width))
        return (self.padded_capacity,) + tuple(self.value_shape)

    @property
    def block_logical(self) -> Tuple[int, int]:
        """(first logical id, logical rows) of this rank's block."""
        rows = self.rows_per_shard * self.pack
        return self.shard_index * rows, rows


def zeros_init(spec: StoreSpec) -> InitFn:
    def init(ids: torch.Tensor) -> torch.Tensor:
        return torch.zeros(
            tuple(ids.shape) + tuple(spec.value_shape), dtype=spec.dtype, device=ids.device
        )

    return init


def _place(spec: StoreSpec, values: torch.Tensor) -> torch.Tensor:
    """(>= capacity, *value_shape) logical values -> this rank's block of
    the physical table (the whole table without a mesh)."""
    values = values.to(spec.dtype)
    pad = spec.padded_capacity - values.shape[0]
    if pad:
        zeros = torch.zeros((pad,) + tuple(spec.value_shape), dtype=spec.dtype, device=values.device)
        values = torch.cat([values, zeros])
    lo, rows = spec.block_logical
    values = values[lo:lo + rows]
    if spec.layout == "packed":
        values = _packed.pack_table(values.reshape(-1, spec.row_width), spec.rows_per_shard)
    return values.contiguous()


def create_table(spec: StoreSpec, init_fn: Optional[InitFn] = None, *, device: DeviceLike = None) -> torch.Tensor:
    """Materialise this rank's block of the table (the whole table without
    a mesh), eagerly initialised via ``init_fn`` (deterministic per id,
    vectorised over an id tensor) on the block's own ids."""
    device = mesh_resolve_device(spec.mesh, device)
    init_fn = init_fn or zeros_init(spec)
    lo, rows = spec.block_logical
    ids = torch.arange(lo, lo + rows, dtype=torch.int32, device=device)
    values = init_fn(ids).to(spec.dtype)
    if spec.layout == "packed":
        values = _packed.pack_table(values.reshape(-1, spec.row_width), spec.rows_per_shard)
    return values.contiguous()


def pull(spec: StoreSpec, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Batched pull: ``values[i] = table[ids[i]]``; out-of-range ids are
    clipped (callers carry a validity mask alongside).  On a mesh each ps
    rank gathers the ids it owns and one all-reduce over ``ps`` assembles
    the answer (the ps ranks of a dp slice pass the same ids)."""
    ids = ids.to(torch.int64).clamp(0, spec.padded_capacity - 1)
    vshape = tuple(spec.value_shape) if spec.layout == "packed" else tuple(table.shape[1:])
    rows = spec.block_logical[1]
    rel, hit = _coll.owned_rows(ids.reshape(-1), rows, spec.mesh, spec.ps_axis)
    flat = rel.clamp(0, rows - 1)
    if spec.layout == "packed":
        vals = _packed.packed_pull(table, flat, spec.row_width)
    else:
        vals = table.index_select(0, flat)
    vals = vals.reshape(tuple(ids.shape) + vshape)
    if spec.mesh is None:
        return vals
    return _coll.assemble_owned(vals, hit.reshape(ids.shape), spec.mesh, spec.ps_axis)


def _phys_scatter_args(spec: StoreSpec, table, flat_ids, flat_deltas):
    """(ids, deltas) at PHYSICAL granularity.  Packed: lane-shift each
    delta row to its slice and divide ids down to physical rows (the
    out-of-block sentinel maps to the first row past the block)."""
    if spec.layout != "packed":
        return flat_ids, flat_deltas
    shifted = _packed.lane_shift_deltas(
        flat_deltas.reshape(-1, spec.row_width).to(table.dtype), flat_ids, spec.row_width
    )
    return _packed.packed_phys_ids(flat_ids, spec.row_width).to(torch.int64), shifted


def push(
    spec: StoreSpec,
    table: torch.Tensor,
    ids: torch.Tensor,
    deltas: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    ids_sorted: bool = False,
) -> torch.Tensor:
    """Batched push, IN PLACE: fold ``deltas`` into rows ``ids``; returns
    ``table``.  Masked lanes and out-of-range ids (negative ones included)
    change nothing; on a mesh neither do the lanes other shards own.
    ``ids_sorted=True`` promises ``ids`` ascending with any negative lanes
    at the end (``presort`` guarantees it); the ``"xla_sorted"`` arm then
    skips its sort."""
    vr = len(spec.value_shape)
    lead = tuple(deltas.shape[: deltas.ndim - vr])
    if (vr and tuple(deltas.shape[deltas.ndim - vr:]) != tuple(spec.value_shape)) or (
        lead != tuple(ids.shape)
    ):
        raise ValueError(
            f"push deltas shape {tuple(deltas.shape)} does not match ids "
            f"shape {tuple(ids.shape)} + store value shape {spec.value_shape}"
        )
    if mask is not None and tuple(mask.shape) != tuple(ids.shape):
        raise ValueError(
            f"push mask shape {tuple(mask.shape)} does not match ids shape {tuple(ids.shape)}"
        )
    # ids relative to this rank's block (the whole table without a mesh);
    # negative ids, ids past the table and other shards' route to the
    # always-out-of-range sentinel so they drop
    rows = spec.block_logical[1]
    rel, hit = _coll.owned_rows(ids.reshape(-1), rows, spec.mesh, spec.ps_axis)
    flat_ids = torch.where(hit, rel, rows)
    flat_deltas = deltas.reshape((-1,) + tuple(spec.value_shape))
    flat_mask = None
    if mask is not None:
        flat_mask = mask.reshape(-1)
        # masked lanes keep their id but carry a zero delta (a select, so
        # even a NaN-poisoned masked delta is inert)
        flat_deltas = torch.where(
            flat_mask.reshape((-1,) + (1,) * vr), flat_deltas, torch.zeros_like(flat_deltas)
        )

    if spec.update == "add":
        impl = spec.scatter_impl
        if impl == "pallas" and spec.layout == "packed":
            # logical ids and logical-width deltas: each run writes its
            # own column slice of the physical row
            return _scatter.scatter_add(
                table, flat_ids, flat_deltas.reshape(-1, spec.row_width), None,
                sub_k=spec.pack, sub_width=spec.row_width,
            )
        s_ids, s_deltas = _phys_scatter_args(spec, table, flat_ids, flat_deltas)
        return _coll.push_rows_(table, s_ids, s_deltas, flat_mask, impl=impl, ids_sorted=ids_sorted)

    # Generic path: combine duplicates densely, then apply ``update`` once
    # per touched row.  O(rows) per step — the documented slow path.
    combined = add_rows_(torch.zeros_like(table), flat_ids, flat_deltas)
    ones = torch.ones(flat_ids.shape, dtype=torch.int32, device=table.device)
    if flat_mask is not None:
        ones = torch.where(flat_mask, ones, torch.zeros_like(ones))
    counts = add_rows_(torch.zeros(rows, dtype=torch.int32, device=table.device), flat_ids, ones)
    updated = spec.update(table, combined)
    touched = (counts > 0).reshape((-1,) + (1,) * vr)
    return table.copy_(torch.where(touched, updated, table))


class ShardedParamStore:
    """Bundle of (spec, table).  Mutators return new stores."""

    def __init__(self, spec: StoreSpec, table: torch.Tensor):
        self.spec = spec
        self.table = table

    @classmethod
    def create(
        cls,
        capacity: int,
        value_shape: Tuple[int, ...] = (),
        *,
        dtype: torch.dtype = torch.float32,
        init_fn: Optional[InitFn] = None,
        update: Union[str, UpdateFn] = "add",
        scatter_impl: str = "xla",
        mesh: Optional[Any] = None,
        ps_axis: str = "ps",
        layout: str = "dense",
        device: DeviceLike = None,
    ) -> "ShardedParamStore":
        """A store of ``capacity`` rows; with ``mesh`` this rank holds its
        ``ps`` block, on the mesh's device unless ``device`` says which."""
        spec = StoreSpec(
            capacity=capacity,
            value_shape=tuple(value_shape),
            dtype=dtype,
            update=update,
            scatter_impl=scatter_impl,
            mesh=mesh,
            ps_axis=ps_axis,
            layout=_resolve_layout(layout, update, tuple(value_shape)),
        )
        return cls(spec, create_table(spec, init_fn, device=device))

    @classmethod
    def from_values(
        cls,
        values: torch.Tensor,
        *,
        update: Union[str, UpdateFn] = "add",
        scatter_impl: str = "xla",
        mesh: Optional[Any] = None,
        ps_axis: str = "ps",
        layout: str = "dense",
        device: DeviceLike = None,
    ) -> "ShardedParamStore":
        """Seed the store from a ``(capacity, *value_shape)`` tensor (the
        reference's ``transformWithModelLoad`` analogue); with ``mesh``,
        every rank passes the whole tensor and keeps its block."""
        spec = StoreSpec(
            capacity=values.shape[0],
            value_shape=tuple(values.shape[1:]),
            dtype=values.dtype,
            update=update,
            scatter_impl=scatter_impl,
            mesh=mesh,
            ps_axis=ps_axis,
            layout=_resolve_layout(layout, update, tuple(values.shape[1:])),
        )
        return cls(spec, _place(spec, values.to(mesh_resolve_device(mesh, device))))

    @classmethod
    def from_spec_values(
        cls, spec: StoreSpec, values: torch.Tensor, *, device: DeviceLike = None
    ) -> "ShardedParamStore":
        """Seed a store carrying the *full* target ``spec`` (update rule,
        ``scatter_impl``, layout) from an unpadded ``(capacity, ...)``
        value tensor — the checkpoint-restore path, which must not drop
        spec fields the way a shape-inferred rebuild would.  The table
        goes on ``device`` (default: the card, or the mesh's device); with
        a mesh, this rank keeps its block."""
        return cls(spec, _place(spec, values.to(mesh_resolve_device(spec.mesh, device), spec.dtype)))

    def pull(self, ids: torch.Tensor) -> torch.Tensor:
        return pull(self.spec, self.table, ids)

    def push(
        self, ids: torch.Tensor, deltas: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> "ShardedParamStore":
        return ShardedParamStore(
            self.spec, push(self.spec, self.table.clone(), ids, deltas, mask)
        )

    def values(self) -> torch.Tensor:
        """Final model dump (unpadded, LOGICAL layout).  On a mesh the
        blocks are gathered over ``ps``: every rank gets the whole table."""
        table = self.table
        if self.spec.mesh is not None:
            table = _coll.all_gather_cat(table, self.spec.mesh, self.spec.ps_axis)
        if self.spec.layout == "packed":
            vals = _packed.unpack_table(table, self.spec.capacity, self.spec.row_width)
            return vals.reshape((self.spec.capacity,) + tuple(self.spec.value_shape))
        return table[: self.spec.capacity]


__all__ = [
    "StoreSpec",
    "ShardedParamStore",
    "create_table",
    "pull",
    "push",
    "zeros_init",
    "pallas_fallback_count",
]
