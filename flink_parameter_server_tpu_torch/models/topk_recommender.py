"""Online MF with top-K recommendation serving.

Counterpart of ``flink_parameter_server_tpu/models/topk_recommender.py``
(the reference system's ``PSOnlineMatrixFactorizationAndTopK``): per query
it answers the user's top-K items from the worker-local user vector and
the item table.  Serving here is :func:`..ops.topk.dense_topk`, exact MIPS
by one product over the whole table (output parity with the reference's
LEMP pruning, not mechanism parity).  :func:`query_topk` answers a batch
of user queries; :func:`make_mf_topk_step` interleaves them with training
the way the reference interleaves query events in the rating stream.  A
store row-blocked over a mesh's ``ps`` axis ranks through
:func:`..ops.topk.sharded_topk` on every rank.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core import store as store_mod
from ..core.store import ShardedParamStore
from ..ops.packed import unpack_table
from ..ops.rows import take_rows
from ..ops.topk import dense_topk, sharded_topk, top_k
from ..parallel.mesh import axis_size
from .matrix_factorization import OnlineMatrixFactorization


def _logical_table(spec, table: torch.Tensor) -> torch.Tensor:
    """MIPS needs LOGICAL rows: a lane-packed table is unpacked (a view
    plus a slice of the pad lanes), (padded_capacity, d); ``valid_rows``
    masks the padding rows at the top-k call sites.  Even at pack == 1
    (widths 65-127) the physical rows are lane-padded to 128, so the gate
    is the layout alone.  On a mesh ``table`` is this rank's block and so
    is the result."""
    if spec.layout == "packed":
        return unpack_table(table, spec.block_logical[1], spec.row_width)
    return table


def _rank(spec, table: torch.Tensor, queries: torch.Tensor, k: int):
    """Top-k over the logical table: one product, or the sharded ranking
    when the store is row-blocked over a mesh."""
    table = _logical_table(spec, table)
    if spec.mesh is not None:
        return sharded_topk(table, queries, k, mesh=spec.mesh, ps_axis=spec.ps_axis,
                            valid_rows=spec.capacity)
    return dense_topk(table, queries, k, valid_rows=spec.capacity)


def query_topk(
    item_store: ShardedParamStore,
    user_vectors: torch.Tensor,
    user_ids: torch.Tensor,
    k: int,
    *,
    exclude: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k items for ``user_ids`` (B,) given worker-state user vectors.

    ``exclude``: optional (B, E) item ids to mask out (already-rated items;
    pad unused lanes with -1).  Returns (scores (B,k), item_ids (B,k)); a
    lane with no real candidate left after the exclusions is ``-inf`` / -1.
    """
    spec = item_store.spec
    queries = take_rows(user_vectors, user_ids)
    if exclude is None:
        return _rank(spec, item_store.table, queries, k)

    # over-fetch k+E candidates, then drop the excluded ones
    scores, ids = _rank(spec, item_store.table, queries, k + exclude.shape[1])
    exclude = exclude.to(ids.device, torch.int64)
    banned = (ids.unsqueeze(2) == exclude.unsqueeze(1)).any(-1)
    scores = scores.masked_fill(banned, float("-inf"))
    re_scores, pos = top_k(scores, k)
    re_ids = ids.gather(1, pos)
    # lanes that survived only as -inf (banned or padding) carry no real
    # candidate: id -1, the ops-level padding convention
    re_ids = re_ids.masked_fill(torch.isneginf(re_scores), -1)
    return re_scores, re_ids


def make_mf_topk_step(logic: OnlineMatrixFactorization, spec, k: int):
    """Train+serve step: the MF update plus a top-K answer for the batch's
    ``query_user`` ids, in ``out["topk_scores"]`` / ``out["topk_ids"]``.

    Queries are served against the *pre-push* table (bounded staleness of
    one microbatch, as training pulls) with the post-update user vectors.
    Like :func:`..core.transform.make_train_step`, the step updates
    ``table`` and ``state`` in place; the product reads the table before
    the push is queued, so stream order keeps the answer pre-push.  On a
    mesh it takes a ps-only one: it does not split batches over ``dp``
    (:func:`..core.transform.make_train_step` does)."""
    if axis_size(spec.mesh, "dp") > 1:
        raise ValueError("make_mf_topk_step takes a ps-only mesh; a dp axis needs make_train_step's split")

    def step(table: torch.Tensor, state: torch.Tensor, batch: Dict[str, torch.Tensor]):
        ids = logic.keys(batch)
        pulled = store_mod.pull(spec, table, ids)
        new_state, req, out = logic.step(state, batch, pulled)
        if "query_user" in batch:
            q = take_rows(new_state, batch["query_user"])
            scores, top_ids = _rank(spec, table, q, k)
            out = dict(out, topk_scores=scores, topk_ids=top_ids)
        table = store_mod.push(spec, table, req.ids, req.deltas, req.mask)
        return table, new_state, out

    return step


__all__ = ["query_topk", "make_mf_topk_step"]
