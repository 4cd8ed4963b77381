"""Query ops over a published snapshot.

Counterpart of ``flink_parameter_server_tpu/serving/engine.py``.  Three
read ops, each a few torch calls on the snapshot's device (the reference
jit-compiles one program per shape and ``k``; the port calls the same
functions directly):

  * ``lookup(ids)`` — embedding pull: the store's gather
    (:func:`..core.store.pull`) against the snapshot table;
  * ``score(user_ids, item_ids)`` — MF dot-product scoring of explicit
    (user, item) pairs;
  * ``top_k(user_ids, k, exclude=...)`` — exact top-K recommendation
    through :func:`..models.topk_recommender.query_topk` (one product over
    the table, over-fetch + mask for excluded items).

The engine reads the snapshot pointer ONCE per call, so every answer is
internally consistent (table + user vectors + version from the same
publish) and carries its staleness as metadata.  User vectors come from
the snapshot's ``aux`` (the driver publishes worker state — MF user
factors) or from a static tensor passed at construction.  Answers come
back as numpy arrays on the host; the computing stays on the snapshot's
device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import store as store_mod
from ..models.topk_recommender import query_topk
from ..ops.rows import take_rows
from .snapshot import SnapshotManager, TableSnapshot


class NoSnapshotError(RuntimeError):
    """Query arrived before the first snapshot publish."""


@dataclasses.dataclass(frozen=True)
class TopKResult:
    """One batch of top-K answers + the snapshot provenance they came
    from.  ``item_ids`` lanes with no real candidate (catalogue smaller
    than k, or excluded) are -1 with ``-inf`` scores — the ops-level
    padding convention."""

    scores: np.ndarray  # (B, k) float
    item_ids: np.ndarray  # (B, k) int
    version: int
    train_step: int
    staleness: int


@dataclasses.dataclass(frozen=True)
class LookupResult:
    values: np.ndarray  # (B, *value_shape)
    version: int
    train_step: int
    staleness: int


def _host(t: torch.Tensor) -> np.ndarray:
    """A result on the host (bfloat16 widened: numpy has no bfloat16)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class QueryEngine:
    """Snapshot-read ops.

    One engine serves many concurrent callers: snapshots are immutable and
    the engine keeps no mutable state, so callers share nothing but the
    snapshot pointer.
    """

    def __init__(
        self,
        snapshots: SnapshotManager,
        *,
        user_vectors: Optional[torch.Tensor] = None,
    ):
        self.snapshots = snapshots
        self._static_user_vectors = user_vectors

    # -- snapshot plumbing -------------------------------------------------
    def _snap(self) -> TableSnapshot:
        snap = self.snapshots.latest()
        if snap is None:
            raise NoSnapshotError(
                "no snapshot published yet (is the trainer running / did "
                "serve_with publish the initial table?)"
            )
        return snap

    def _user_vectors(self, snap: TableSnapshot) -> torch.Tensor:
        aux = snap.aux
        if aux is not None and hasattr(aux, "ndim") and aux.ndim == 2:
            return aux
        if self._static_user_vectors is not None:
            return self._static_user_vectors
        raise ValueError(
            "top-K needs user vectors: publish the worker state as the "
            "snapshot aux (StreamingDriver.serve_with does) or pass "
            "user_vectors= to the QueryEngine"
        )

    @staticmethod
    def _ids(ids, device: torch.device) -> torch.Tensor:
        return torch.from_numpy(np.asarray(ids, np.int32)).to(device)

    # -- public query surface ----------------------------------------------
    def lookup(self, ids) -> LookupResult:
        """Batched embedding pull against the latest snapshot."""
        snap = self._snap()
        vals = store_mod.pull(snap.spec, snap.table, self._ids(ids, snap.table.device))
        return LookupResult(
            values=_host(vals),
            version=snap.version,
            train_step=snap.train_step,
            staleness=self.snapshots.staleness_of(snap),
        )

    def score(self, user_ids, item_ids) -> LookupResult:
        """MF dot-product scores for aligned (user, item) id pairs."""
        snap = self._snap()
        uv = self._user_vectors(snap)
        q = take_rows(uv, self._ids(user_ids, uv.device))
        v = store_mod.pull(snap.spec, snap.table, self._ids(item_ids, snap.table.device))
        return LookupResult(
            values=_host(torch.sum(q * v, dim=-1)),
            version=snap.version,
            train_step=snap.train_step,
            staleness=self.snapshots.staleness_of(snap),
        )

    def top_k(self, user_ids, k: int, *, exclude=None) -> TopKResult:
        """Exact top-K items for ``user_ids`` (B,), excluding the
        (B, E) ``exclude`` ids (pad unused lanes with -1)."""
        if k < 1:
            raise ValueError(f"k={k}: must be >= 1")
        snap = self._snap()
        uv = self._user_vectors(snap)
        device = snap.table.device
        excl = None if exclude is None else self._ids(exclude, device)
        scores, ids = query_topk(
            snap.store(), uv, self._ids(user_ids, uv.device), k, exclude=excl
        )
        return TopKResult(
            scores=_host(scores),
            item_ids=_host(ids),
            version=snap.version,
            train_step=snap.train_step,
            staleness=self.snapshots.staleness_of(snap),
        )


__all__ = ["QueryEngine", "TopKResult", "LookupResult", "NoSnapshotError"]
