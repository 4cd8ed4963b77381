"""Online passive-aggressive classification on the parameter server.

Counterpart of ``flink_parameter_server_tpu/models/passive_aggressive.py``
(the reference system's ``PassiveAggressiveParameterServer.transformBinary``
/ ``transformMulticlass``, SURVEY.md §2 #9, §3.4): a linear model keyed by
feature id.  A microbatch of sparse examples is padded to ``(B, K)``
(ids, values, feature mask), the multi-pull is one gather, the PA / PA-I
/ PA-II update is elementwise math and every push is one scatter-add
(with ``scatter_impl="pallas"``, one K1 launch a step).  Binary keeps
scalar weights (value_shape ``()``); multiclass a per-feature row of
class weights (value_shape ``(num_classes,)``), so one pull fetches them
all.

:class:`PABinaryWorkerLogic` is the event-API form: per example, one pull
per feature, a countdown until every answer is in, then the update.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict

import numpy as np
import torch

from ..core.api import WorkerLogic
from ..core.batched import BatchedWorkerLogic, PushRequest
from ..core.store import ShardedParamStore
from ..core.transform import transform_batched
from ..utils.device import DeviceLike, resolve_device
from ..utils.initializers import zeros


@dataclasses.dataclass(frozen=True)
class PARule:
    """PA update-step size τ.  variant: "PA" | "PA-I" | "PA-II", with
    aggressiveness C."""

    variant: str = "PA-I"
    C: float = 1.0

    def tau(self, loss: torch.Tensor, sq_norm: torch.Tensor) -> torch.Tensor:
        sq = torch.clamp_min(sq_norm, 1e-12)
        if self.variant == "PA":
            return loss / sq
        if self.variant == "PA-I":
            return torch.clamp_max(loss / sq, self.C)
        if self.variant == "PA-II":
            return loss / (sq + 1.0 / (2.0 * self.C))
        raise ValueError(f"unknown PA variant {self.variant}")


def _features(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    x = batch["values"].to(torch.float32)
    return torch.where(batch["feat_mask"], x, torch.zeros_like(x))


class PassiveAggressiveBinary(BatchedWorkerLogic):
    """Batch: ``ids`` (B,K) int, ``values`` (B,K) float, ``feat_mask``
    (B,K) bool, ``label`` (B,) ±1, ``mask`` (B,) bool."""

    def __init__(self, rule: PARule = PARule()):
        self.rule = rule

    def init_state(self, rng=None):
        return ()  # stateless worker: the model lives on the PS

    def keys(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return batch["ids"]

    def step(self, state, batch: Dict[str, torch.Tensor], pulled: torch.Tensor):
        x = _features(batch)
        y = batch["label"].to(torch.float32)
        margin = (pulled * x).sum(dim=-1)
        loss = torch.clamp_min(1.0 - y * margin, 0.0)
        tau = self.rule.tau(loss, (x * x).sum(dim=-1))
        deltas = (tau * y).unsqueeze(1) * x
        mask = batch["feat_mask"] & batch["mask"].unsqueeze(1)
        out = {"prediction": torch.sign(margin), "margin": margin, "loss": loss * batch["mask"]}
        return state, PushRequest(batch["ids"], deltas, mask), out


class PassiveAggressiveMulticlass(BatchedWorkerLogic):
    """Multiclass PA against the highest-scoring wrong class, on
    per-feature class-weight rows; τ = loss / (2‖x‖²), since the update
    touches two class weights per feature."""

    def __init__(self, num_classes: int, rule: PARule = PARule()):
        self.num_classes = num_classes
        self.rule = rule

    def init_state(self, rng=None):
        return ()

    def keys(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return batch["ids"]

    def step(self, state, batch: Dict[str, torch.Tensor], pulled: torch.Tensor):
        x = _features(batch)
        y = batch["label"].to(torch.int64)  # (B,) class index
        scores = torch.einsum("bk,bkc->bc", x, pulled)
        B, C = scores.shape
        rows = torch.arange(B, device=scores.device)
        true_score = scores[rows, y]
        # the highest-scoring wrong class (argmax takes the first on ties)
        masked = scores.clone()
        masked[rows, y] = float("-inf")
        runner = masked.argmax(dim=1)
        runner_score = masked.max(dim=1).values
        loss = torch.clamp_min(1.0 - (true_score - runner_score), 0.0)
        tau = self.rule.tau(loss, 2.0 * (x * x).sum(dim=-1))
        direction = torch.nn.functional.one_hot(y, C) - torch.nn.functional.one_hot(runner, C)
        deltas = tau[:, None, None] * x[:, :, None] * direction[:, None, :].to(torch.float32)
        mask = batch["feat_mask"] & batch["mask"].unsqueeze(1)
        out = {"prediction": scores.argmax(dim=1), "loss": loss * batch["mask"]}
        return state, PushRequest(batch["ids"], deltas, mask), out


def transform_binary(data, *, num_features: int, rule: PARule = PARule(), mesh=None,
                     scatter_impl: str = "xla", layout: str = "dense", device: DeviceLike = None,
                     **kwargs):
    """The reference's ``transformBinary``: returns the TransformResult;
    ``result.store.values()`` is the final weight vector.  ``mesh``: a
    ``dp × ps`` mesh to run on, every rank reading the same ``data``
    (weights row-blocked over ``ps``, each batch split over ``dp``)."""
    store = ShardedParamStore.create(num_features, (), init_fn=zeros(()), mesh=mesh,
                                     scatter_impl=scatter_impl, layout=layout, device=device)
    return transform_batched(data, PassiveAggressiveBinary(rule), store, mesh=mesh, **kwargs)


def transform_multiclass(data, *, num_features: int, num_classes: int, rule: PARule = PARule(),
                         mesh=None, scatter_impl: str = "xla", layout: str = "dense",
                         device: DeviceLike = None, **kwargs):
    store = ShardedParamStore.create(num_features, (num_classes,), init_fn=zeros((num_classes,)),
                                     mesh=mesh, scatter_impl=scatter_impl, layout=layout,
                                     device=device)
    return transform_batched(data, PassiveAggressiveMulticlass(num_classes, rule), store, mesh=mesh,
                             **kwargs)


class PABinaryWorkerLogic(WorkerLogic):
    """Event-API binary PA: the reference system's per-example multi-pull
    with a countdown until every feature's answer is in (SURVEY.md §3.4).
    Each completed example's margin, loss and τ are computed in float32
    on ``device`` (default ``"cuda"``); pushes carry Python floats."""

    def __init__(self, rule: PARule = PARule(), *, device: DeviceLike = None):
        self.rule = rule
        self.device = resolve_device(device)
        self.pending: Dict[int, dict] = {}
        # param_id -> FIFO of the pending examples waiting for that answer
        self._waiting: Dict[int, collections.deque] = collections.defaultdict(collections.deque)
        self._next = 0

    def on_recv(self, data, ps):
        ids, values, label = data
        self.pending[self._next] = {
            "ids": list(ids),
            "values": dict(zip(ids, values)),
            "label": label,
            "missing": set(ids),
            "weights": {},
        }
        for fid in ids:
            self._waiting[fid].append(self._next)
            ps.pull(fid)
        self._next += 1

    def on_pull_recv(self, param_id, param_value, ps):
        done = []
        q = self._waiting.get(param_id)
        # an answer goes to the oldest example still missing this id
        while q:
            key = q.popleft()
            ex = self.pending.get(key)
            if ex is None or param_id not in ex["missing"]:
                continue  # stale entry (a duplicate id within one example)
            ex["weights"][param_id] = param_value
            ex["missing"].discard(param_id)
            if not ex["missing"]:
                done.append(key)
            break  # one answer satisfies one outstanding pull
        if q is not None and not q:
            del self._waiting[param_id]
        for key in done:
            self._finish(self.pending.pop(key), ps)

    def _finish(self, ex, ps):
        f32 = dict(dtype=torch.float32, device=self.device)
        x = torch.tensor(np.array([ex["values"][i] for i in ex["ids"]], np.float32), **f32)
        w = torch.tensor(np.array([float(ex["weights"][i]) for i in ex["ids"]], np.float32), **f32)
        y = float(ex["label"])
        margin = (w @ x).item()
        loss = max(0.0, 1.0 - y * margin)
        tau = float(self.rule.tau(torch.tensor(loss, **f32), x @ x))
        for fid, xi in zip(ex["ids"], x.tolist()):
            ps.push(fid, tau * y * xi)
        ps.output((ex["label"], float(np.sign(margin)), margin))


__all__ = [
    "PARule",
    "PassiveAggressiveBinary",
    "PassiveAggressiveMulticlass",
    "PABinaryWorkerLogic",
    "transform_binary",
    "transform_multiclass",
]
