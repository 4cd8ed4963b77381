"""Online matrix factorization on the parameter server.

Counterpart of ``flink_parameter_server_tpu/models/matrix_factorization.py``
(the reference system's ``PSOnlineMatrixFactorization.psOnlineMF``): user
vectors live in worker state, item vectors in the store; per microbatch of
ratings, pull the item rows, run SGD on each (user, item) pair, update the
user rows locally and push the item deltas.  Duplicate users or items in
one microbatch combine additively (or by mean with ``dedup_scale``).
:class:`MFWorkerLogic` is the same model in the event API, one rating at
a time.

On a ``dp × ps`` mesh (``mesh=``, :mod:`..parallel.mesh`) the item store is
row-blocked over ``ps`` and each microbatch splits over ``dp``.  The user
table is replicated on every rank: a rank computes its slice's user deltas
and applies the dp all-gather of every slice's deltas, in the global lane
order, and ``dedup_scale`` counts duplicates over every slice's lanes, so
the sharded step equals the single-device one.
:func:`make_locality_mf_step` is the alternative that block-shards the
users over ``dp`` instead, for partition-aligned batches.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..core.api import WorkerLogic
from ..core.batched import BatchedWorkerLogic, PushRequest
from ..core.store import ShardedParamStore
from ..ops.dedup import occurrence_scale
from ..ops.rows import add_rows_, take_rows
from ..ops.sorted_scatter import sorted_dedup_scatter_add
from ..parallel import collectives as _coll
from ..parallel.mesh import DP_AXIS, PS_AXIS, axis_index, axis_size
from ..utils.device import DeviceLike, mesh_resolve_device, resolve_device
from ..utils.initializers import ranged_random_factor


@dataclasses.dataclass(frozen=True)
class SGDUpdater:
    """Learning rate + L2 regularisation over a batch of (user_vec,
    item_vec, rating)."""

    learning_rate: float = 0.01
    regularization: float = 0.0

    def delta(
        self, rating: torch.Tensor, user_vec: torch.Tensor, item_vec: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Returns (user_delta, item_delta, prediction); batch-shaped."""
        pred = torch.sum(user_vec * item_vec, dim=-1)
        err = (rating - pred).unsqueeze(-1)
        lr = self.learning_rate
        reg = self.regularization
        user_delta = lr * (err * item_vec - reg * user_vec)
        item_delta = lr * (err * user_vec - reg * item_vec)
        return user_delta, item_delta, pred


class OnlineMatrixFactorization(BatchedWorkerLogic):
    """Batched MF worker logic: user factors = worker state, item factors =
    store.  Batches are dicts with ``user``, ``item``, ``rating`` and
    ``mask`` tensors (see :func:`..data.streams.microbatches`)."""

    def __init__(
        self,
        num_users: int,
        dim: int,
        *,
        updater: SGDUpdater = SGDUpdater(),
        seed: int = 0,
        init_low: float = -0.01,
        init_high: float = 0.01,
        mesh: Optional[Any] = None,
        dtype: torch.dtype = torch.float32,
        dedup_scale: bool = False,
        num_items: Optional[int] = None,
        state_scatter: str = "xla",
        device: DeviceLike = None,
        dp_axis: str = DP_AXIS,
    ):
        """``mesh``: a ``dp × ps`` mesh the logic runs on (the user table
        replicated on every rank, user deltas all-gathered over
        ``dp_axis``); ``device`` defaults to the mesh's device then."""
        self.device = mesh_resolve_device(mesh, device)
        self.mesh = mesh
        self.dp_axis = dp_axis
        self.num_users = num_users
        self.dim = dim
        self.updater = updater
        self.seed = seed
        self.init_low = init_low
        self.init_high = init_high
        self.dtype = dtype
        # mean-combine duplicate-id deltas within a batch (ops/dedup.py)
        self.dedup_scale = dedup_scale
        self.num_items = num_items
        if dedup_scale and num_items is None:
            raise ValueError("dedup_scale=True requires num_items")
        if state_scatter not in ("xla", "xla_sorted"):
            raise ValueError(f"state_scatter={state_scatter!r}: xla|xla_sorted")
        self.state_scatter = state_scatter

    def init_state(self, rng: Optional[torch.Generator] = None) -> torch.Tensor:
        # per-id deterministic init from ``seed``; ``rng`` is not needed
        init = ranged_random_factor(
            self.seed, (self.dim,), low=self.init_low, high=self.init_high
        )
        ids = torch.arange(self.num_users, dtype=torch.int32, device=self.device)
        return init(ids).to(self.dtype)

    def keys(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return batch["item"]

    def step(self, state: torch.Tensor, batch: Dict[str, torch.Tensor], pulled: torch.Tensor):
        """Updates ``state`` in place; returns (state, push request, out)."""
        users = batch["user"].to(torch.int64)
        ratings = batch["rating"].to(self.dtype)
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(users.shape, dtype=torch.bool, device=users.device)

        user_vecs = take_rows(state, users)
        user_delta, item_delta, pred = self.updater.delta(ratings, user_vecs, pulled)
        if self.dedup_scale:  # counts over the whole microbatch, every dp slice's lanes
            u_scale = occurrence_scale(users, self.num_users, mask, mesh=self.mesh, axis=self.dp_axis)
            i_scale = occurrence_scale(batch["item"], self.num_items, mask, mesh=self.mesh,
                                       axis=self.dp_axis)
            user_delta = user_delta * u_scale.unsqueeze(-1).to(self.dtype)
            item_delta = item_delta * i_scale.unsqueeze(-1).to(self.dtype)
        m = mask.unsqueeze(-1).to(self.dtype)
        s_users, s_delta, s_mask = users, user_delta * m, mask
        if axis_size(self.mesh, self.dp_axis) > 1:
            # every slice's user deltas, in dp (= global lane) order
            s_users = _coll.all_gather_cat(users, self.mesh, self.dp_axis)
            s_delta = _coll.all_gather_cat(s_delta, self.mesh, self.dp_axis)
            s_mask = _coll.all_gather_cat(mask, self.mesh, self.dp_axis)
        if self.state_scatter == "xla_sorted":
            sorted_dedup_scatter_add(state, s_users, s_delta, s_mask)
        else:
            add_rows_(state, s_users, s_delta)
        out = {"prediction": pred, "error": (ratings - pred) * mask}
        return state, PushRequest(batch["item"], item_delta, mask), out

    def per_record_outputs(self, out):
        return {"prediction": True, "error": True}

    def finish(self, state: torch.Tensor):
        # close()-time worker dump: the final user factors
        return {"user_factors": state}


class MFWorkerLogic(WorkerLogic):
    """Event-API MF worker, the reference system's programming model
    (SURVEY.md §3.2): buffer the rating, pull the item vector, and on the
    answer run SGD, update the local user vector and push the item delta.

    User vectors (per-id init from ``seed``) and the SGD math live on
    ``device`` (default ``"cuda"``); the item delta is pushed as a tensor
    there, and a pulled value is taken as a tensor on it.  Outputs are
    ``(user, item, prediction)`` with the prediction a Python float."""

    def __init__(
        self,
        dim: int,
        updater: SGDUpdater = SGDUpdater(),
        seed: int = 0,
        init_low: float = -0.01,
        init_high: float = 0.01,
        *,
        device: DeviceLike = None,
    ):
        self.dim = dim
        self.updater = updater
        self.device = resolve_device(device)
        self._init = ranged_random_factor(seed, (dim,), low=init_low, high=init_high)
        self.user_vectors: Dict[int, torch.Tensor] = {}
        self.pending: Dict[int, list] = {}

    def _user_vec(self, u: int) -> torch.Tensor:
        if u not in self.user_vectors:
            ids = torch.tensor([u], dtype=torch.int64, device=self.device)
            self.user_vectors[u] = self._init(ids)[0]
        return self.user_vectors[u]

    def on_recv(self, data, ps):
        u, i, r = data
        self.pending.setdefault(i, []).append((u, r))
        ps.pull(i)

    def on_pull_recv(self, param_id, param_value, ps):
        item_vec = torch.as_tensor(param_value, dtype=torch.float32, device=self.device)
        for u, r in self.pending.pop(param_id, []):
            user_vec = self._user_vec(u)
            rating = torch.tensor(r, dtype=torch.float32, device=self.device)
            ud, idelta, pred = self.updater.delta(rating, user_vec, item_vec)
            self.user_vectors[u] = user_vec + ud
            ps.push(param_id, idelta)
            ps.output((u, param_id, float(pred)))


def ps_online_mf(
    ratings,
    *,
    num_users: int,
    num_items: int,
    dim: int = 16,
    learning_rate: float = 0.05,
    regularization: float = 0.0,
    seed: int = 0,
    mesh: Optional[Any] = None,
    dedup_scale: bool = False,
    scatter_impl: str = "xla",
    layout: str = "dense",
    state_scatter: Optional[str] = None,
    device: DeviceLike = None,
    **transform_kwargs,
):
    """End-to-end online MF: build the item store and the MF worker and run
    :func:`..core.transform.transform_batched` over ``ratings`` (an
    iterable of microbatch dicts of numpy arrays or tensors).

    Returns the :class:`TransformResult`: ``result.store.values()`` is the
    final item-factor matrix, ``result.worker_state`` the user factors.
    ``state_scatter`` defaults to following ``scatter_impl``.  ``mesh``:
    run on every rank of a ``dp × ps`` mesh, each reading the same
    ``ratings`` (the items row-blocked over ``ps``, each microbatch split
    over ``dp``; every rank gets the whole result)."""
    from ..core.transform import transform_batched

    device = mesh_resolve_device(mesh, device)
    if state_scatter is None:
        state_scatter = "xla_sorted" if scatter_impl == "xla_sorted" else "xla"
    logic = OnlineMatrixFactorization(
        num_users,
        dim,
        updater=SGDUpdater(learning_rate, regularization),
        seed=seed,
        dedup_scale=dedup_scale,
        num_items=num_items if dedup_scale else None,
        state_scatter=state_scatter,
        device=device,
        mesh=mesh,
    )
    store = ShardedParamStore.create(
        num_items,
        (dim,),
        init_fn=ranged_random_factor(seed + 1, (dim,)),
        scatter_impl=scatter_impl,
        mesh=mesh,
        layout=layout,
        device=device,
    )
    return transform_batched(ratings, logic, store, mesh=mesh, **transform_kwargs)


def make_locality_mf_step(
    logic: OnlineMatrixFactorization,
    spec,
    mesh,
    *,
    dp_axis: str = DP_AXIS,
    ps_axis: str = PS_AXIS,
):
    """The whole MF step as one SPMD body over ``dp × ps``: the alternative
    to the replicated-user path for partition-aligned batches.

    Contract: batches are aligned by user
    (:func:`..data.streams.partitioned_microbatches` with ``key="user"``,
    ``capacity=num_users``), ``num_users`` divides by the dp size, and
    each rank holds the dp block of the user table, rows ``[d·U/D,
    (d+1)·U/D)`` of ``logic.init_state()``.  Every rank passes the same
    global batch (with a ``mask``) and takes its dp slice.  The pull is one
    all-reduce over ``ps``; the user gather and scatter are local by the
    contract (users outside the partition are masked: their lanes update
    nothing); the push is one dp all-gather of (item ids, deltas), then
    each ps rank adds its own rows.  Dense item tables only.

    ``step(local_table, local_state, batch) -> (local_table, local_state,
    out)``, both blocks updated in place, ``out`` the whole batch's."""
    dp = axis_size(mesh, dp_axis)
    ps = axis_size(mesh, ps_axis)
    if spec.layout != "dense" or spec.padded_capacity % ps:
        raise ValueError(
            f"the locality step takes a dense store built on this mesh "
            f"(padded capacity {spec.padded_capacity}, ps={ps})"
        )
    if logic.num_users % dp:
        raise ValueError(f"num_users={logic.num_users} does not split over dp={dp}")
    users_per_shard = logic.num_users // dp
    updater = logic.updater
    dtype = logic.dtype

    def step(local_table, local_state, batch):
        n = batch["user"].shape[0]
        if n % dp:
            raise ValueError(f"a microbatch of {n} records does not split over dp={dp}")
        per = n // dp
        d = axis_index(mesh, dp_axis)
        cut = slice(d * per, (d + 1) * per)
        users = batch["user"][cut].to(torch.int64)
        items = batch["item"][cut].to(torch.int64)
        ratings = batch["rating"][cut].to(dtype)
        mask = batch["mask"][cut]

        # pull: each ps rank answers its rows, one all-reduce assembles
        pulled = _coll.shard_pull(local_table, items, mesh=mesh, ps_axis=ps_axis)

        # the local user block (alignment contract: this slice's users live here)
        urel, uvalid = _coll.owned_rows(users, users_per_shard, mesh, dp_axis)
        uvalid = uvalid & mask
        user_vecs = local_state.index_select(0, urel.clamp(0, users_per_shard - 1))
        user_delta, item_delta, pred = updater.delta(ratings, user_vecs, pulled)
        um = uvalid.unsqueeze(1).to(dtype)
        add_rows_(local_state, torch.where(uvalid, urel, users_per_shard), user_delta * um)

        # push: the dp all-gather of (ids, deltas), then each ps rank's rows;
        # an out-of-partition user's item delta came from a wrong user row
        _coll.shard_push_add(local_table, items, (item_delta * um).to(local_table.dtype), mesh=mesh,
                             ps_axis=ps_axis, dp_axis=dp_axis)

        out = {"prediction": pred, "error": (ratings - pred) * uvalid}
        out = {k: _coll.all_gather_cat(v, mesh, dp_axis) for k, v in out.items()}
        return local_table, local_state, out

    return step


__all__ = [
    "SGDUpdater",
    "OnlineMatrixFactorization",
    "MFWorkerLogic",
    "make_locality_mf_step",
    "ps_online_mf",
]
