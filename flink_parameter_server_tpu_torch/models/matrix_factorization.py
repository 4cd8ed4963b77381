"""Online matrix factorization on the parameter server.

Counterpart of ``flink_parameter_server_tpu/models/matrix_factorization.py``
(the reference system's ``PSOnlineMatrixFactorization.psOnlineMF``): user
vectors live in worker state, item vectors in the store; per microbatch of
ratings, pull the item rows, run SGD on each (user, item) pair, update the
user rows locally and push the item deltas.  Duplicate users or items in
one microbatch combine additively (or by mean with ``dedup_scale``).
:class:`MFWorkerLogic` is the same model in the event API, one rating at
a time.
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
from ..utils.device import DeviceLike, check_mesh, resolve_device
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
    ):
        check_mesh(mesh)
        self.num_users = num_users
        self.dim = dim
        self.updater = updater
        self.seed = seed
        self.init_low = init_low
        self.init_high = init_high
        self.dtype = dtype
        self.device = resolve_device(device)
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
        if self.dedup_scale:
            u_scale = occurrence_scale(users, self.num_users, mask)
            i_scale = occurrence_scale(batch["item"], self.num_items, mask)
            user_delta = user_delta * u_scale.unsqueeze(-1).to(self.dtype)
            item_delta = item_delta * i_scale.unsqueeze(-1).to(self.dtype)
        m = mask.unsqueeze(-1).to(self.dtype)
        if self.state_scatter == "xla_sorted":
            sorted_dedup_scatter_add(state, users, user_delta * m, mask)
        else:
            add_rows_(state, users, user_delta * m)
        out = {"prediction": pred, "error": (ratings - pred) * mask}
        return state, PushRequest(batch["item"], item_delta, mask), out

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
    ``state_scatter`` defaults to following ``scatter_impl``."""
    from ..core.transform import transform_batched

    check_mesh(mesh)
    device = resolve_device(device)
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
    )
    store = ShardedParamStore.create(
        num_items,
        (dim,),
        init_fn=ranged_random_factor(seed + 1, (dim,)),
        scatter_impl=scatter_impl,
        layout=layout,
        device=device,
    )
    return transform_batched(ratings, logic, store, **transform_kwargs)


__all__ = ["SGDUpdater", "OnlineMatrixFactorization", "MFWorkerLogic", "ps_online_mf"]
