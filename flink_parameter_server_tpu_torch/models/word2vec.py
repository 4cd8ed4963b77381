"""Word2vec skip-gram with negative sampling (SGNS) on the PS.

Counterpart of ``flink_parameter_server_tpu/models/word2vec.py``
(BASELINE config 3, "word2vec skip-gram w/ negative sampling (async
sparse push)").  Both embedding matrices live on the server, keyed by
word id: one store row per word holds ``(2, dim)``, slot 0 the input
("in") embedding and slot 1 the output ("out") embedding, so one gather
fetches everything a pair needs.  A microbatch of B pairs with N
negatives pulls ``(B, N+2)`` rows and pushes one ``(B, N+2, 2, dim)``
scatter-add, zeros in the untouched slot (with ``scatter_impl="pallas"``,
one K1 launch a step at row width ``2·dim``).  Negatives come from the
host stream (unigram^0.75) or :func:`sample_negatives` on the device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.batched import BatchedWorkerLogic, PushRequest
from ..core.store import ShardedParamStore
from ..core.transform import transform_batched
from ..ops.dedup import occurrence_scale
from ..parallel.mesh import DP_AXIS
from ..utils.device import DeviceLike
from ..utils.initializers import ranged_random_factor

IN, OUT = 0, 1  # slots in the (2, dim) store row


class SkipGramNS(BatchedWorkerLogic):
    """Batch: ``center`` (B,), ``context`` (B,), ``negatives`` (B, N),
    ``mask`` (B,); produces the per-pair SGNS loss and sparse pushes.

    ``dedup_scale`` (needs ``vocab_size``): scale each lane's delta by
    1/count(id in the batch), so a Zipf-hot word takes one averaged step
    a microbatch instead of count× summed steps (:mod:`..ops.dedup`).
    ``mesh``: the ``dp × ps`` mesh the logic runs on; the counts are then
    over the whole microbatch, every ``dp_axis`` slice's lanes."""

    def __init__(self, learning_rate: float = 0.025, *, dedup_scale: bool = False,
                 vocab_size: Optional[int] = None, mesh: Any = None, dp_axis: str = DP_AXIS):
        self.learning_rate = learning_rate
        self.dedup_scale = dedup_scale
        self.vocab_size = vocab_size
        self.mesh = mesh
        self.dp_axis = dp_axis
        if dedup_scale and vocab_size is None:
            raise ValueError("dedup_scale=True requires vocab_size")

    def init_state(self, rng=None):
        return ()  # the whole model lives on the PS

    def keys(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat(
            [batch["center"].unsqueeze(1), batch["context"].unsqueeze(1), batch["negatives"]], dim=1
        )  # (B, N+2)

    def step(self, state, batch: Dict[str, torch.Tensor], pulled: torch.Tensor):
        # pulled: (B, N+2, 2, dim)
        lr = self.learning_rate
        v = pulled[:, 0, IN]  # (B, d) the center's input embedding
        u_pos = pulled[:, 1, OUT]  # (B, d) the context's output embedding
        u_neg = pulled[:, 2:, OUT]  # (B, N, d)

        pos_logit = (v * u_pos).sum(dim=-1)  # (B,)
        neg_logit = torch.einsum("bd,bnd->bn", v, u_neg)  # (B, N)
        # SGNS maximises log σ(pos) + Σ log σ(-neg)
        g_pos = torch.sigmoid(pos_logit) - 1.0  # dL/d(pos_logit)
        g_neg = torch.sigmoid(neg_logit)  # dL/d(neg_logit)

        d_v = g_pos.unsqueeze(1) * u_pos + torch.einsum("bn,bnd->bd", g_neg, u_neg)
        d_upos = g_pos.unsqueeze(1) * v
        d_uneg = g_neg.unsqueeze(-1) * v.unsqueeze(1)  # (B, N, d)

        B, d = v.shape
        N = u_neg.shape[1]
        deltas = torch.zeros((B, N + 2, 2, d), dtype=v.dtype, device=v.device)
        deltas[:, 0, IN] = -lr * d_v
        deltas[:, 1, OUT] = -lr * d_upos
        deltas[:, 2:, OUT] = -lr * d_uneg

        mask = batch.get("mask")
        lane_mask = None if mask is None else mask.unsqueeze(1).expand(B, N + 2)
        keys = self.keys(batch)
        if self.dedup_scale:
            scale = occurrence_scale(keys, self.vocab_size, lane_mask, mesh=self.mesh, axis=self.dp_axis)
            deltas = deltas * scale[..., None, None]

        loss = -(F.logsigmoid(pos_logit) + F.logsigmoid(-neg_logit).sum(dim=-1))
        if mask is not None:
            loss = loss * mask
        return state, PushRequest(keys, deltas, lane_mask), {"loss": loss}

    def per_record_outputs(self, out):
        return {"loss": True}


def make_store(vocab_size: int, dim: int, *, seed: int = 0, mesh=None, init_scale: float = 0.5,
               scatter_impl: str = "xla", layout: str = "dense",
               device: DeviceLike = None) -> ShardedParamStore:
    """(vocab, 2, dim) store: the input slot uniform in
    U(-init_scale/dim, init_scale/dim) (the word2vec convention), the
    output slot zero."""
    base = ranged_random_factor(seed, (dim,), low=-init_scale / dim, high=init_scale / dim)

    def init(ids: torch.Tensor) -> torch.Tensor:
        in_emb = base(ids)
        return torch.stack([in_emb, torch.zeros_like(in_emb)], dim=1)

    return ShardedParamStore.create(vocab_size, (2, dim), init_fn=init, mesh=mesh,
                                    scatter_impl=scatter_impl, layout=layout, device=device)


def sample_negatives(gen: torch.Generator, probs_cdf: torch.Tensor,
                     shape: Tuple[int, ...]) -> torch.Tensor:
    """Unigram^0.75 negatives on ``probs_cdf``'s device by inverse-CDF
    search (the left side, as ``jnp.searchsorted``): int32 of ``shape``.
    ``gen`` is a ``torch.Generator`` on that device."""
    u = torch.rand(shape, generator=gen, device=probs_cdf.device, dtype=probs_cdf.dtype)
    return torch.searchsorted(probs_cdf, u).to(torch.int32)


def train_skipgram(pairs, *, vocab_size: int, dim: int = 64, learning_rate: float = 0.025,
                   dedup_scale: bool = False, seed: int = 0, mesh=None, scatter_impl: str = "xla",
                   layout: str = "dense", device: DeviceLike = None, **kwargs):
    """SGNS over an iterable of pair microbatches.
    ``result.store.values()`` is the (vocab, 2, dim) embedding table."""
    logic = SkipGramNS(learning_rate, dedup_scale=dedup_scale, vocab_size=vocab_size, mesh=mesh)
    store = make_store(vocab_size, dim, seed=seed, mesh=mesh, scatter_impl=scatter_impl,
                       layout=layout, device=device)
    return transform_batched(pairs, logic, store, mesh=mesh, **kwargs)


__all__ = ["SkipGramNS", "make_store", "sample_negatives", "train_skipgram", "IN", "OUT"]
