"""Factorization machine (degree 2) on the PS: wide sparse embeddings.

Counterpart of ``flink_parameter_server_tpu/models/factorization_machine.py``
(BASELINE config 4, "Factorization Machine on Criteo-1TB").  Each feature
id owns a scalar weight w_i and a latent vector v_i, one store row
``(1 + dim,)`` (w_i ‖ v_i), so one gather fetches both; examples are
sparse (pull only present ids) and gradients are sparse pushes (with
``scatter_impl="pallas"``, one K1 launch a step; the 17-wide Criteo row
is not 16-byte aligned, so the dense layout takes K1's scalar staging and
``layout="packed"`` puts 7 rows in each 128-wide physical row).  The
pairwise term uses the linear-time identity

    ΣΣ ⟨v_i, v_j⟩ x_i x_j = ½ (‖Σ x_i v_i‖² − Σ ‖x_i v_i‖²).

Training is logistic (labels ±1) or squared-loss SGD; the global bias is a
reserved feature id the data pipeline appends with value 1.0.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..core.batched import BatchedWorkerLogic, PushRequest
from ..core.store import ShardedParamStore
from ..core.transform import transform_batched
from ..utils.device import DeviceLike
from ..utils.initializers import normal_factor


@dataclasses.dataclass(frozen=True)
class FMConfig:
    num_features: int
    dim: int = 8
    learning_rate: float = 0.05
    l2: float = 0.0
    loss: str = "logistic"  # or "squared"


class FactorizationMachine(BatchedWorkerLogic):
    """Batch: ``ids`` (B,K) int, ``values`` (B,K) float, ``feat_mask``
    (B,K) bool, ``label`` (B,) (±1 logistic, float squared), ``mask``
    (B,)."""

    def __init__(self, config: FMConfig):
        self.config = config

    def init_state(self, rng=None):
        return ()

    def keys(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return batch["ids"]

    def step(self, state, batch: Dict[str, torch.Tensor], pulled: torch.Tensor):
        cfg = self.config
        x = batch["values"].to(torch.float32)
        x = torch.where(batch["feat_mask"], x, torch.zeros_like(x))
        w = pulled[..., 0]  # (B, K)
        v = pulled[..., 1:]  # (B, K, d)

        linear = (w * x).sum(dim=-1)  # (B,)
        xv = x.unsqueeze(-1) * v  # (B, K, d)
        s = xv.sum(dim=1)  # (B, d)  Σ x_i v_i
        interaction = 0.5 * ((s * s).sum(dim=-1) - (xv * xv).sum(dim=(1, 2)))
        y_hat = linear + interaction

        label = batch["label"].to(torch.float32)
        if cfg.loss == "logistic":
            # dL/dŷ for y in {−1, +1}: −y σ(−y ŷ); softplus exactly as
            # logaddexp(z, 0), as jax.nn.softplus (F.softplus is linear
            # above its threshold)
            z = -label * y_hat
            g = -label * torch.sigmoid(z)
            loss = torch.logaddexp(z, torch.zeros_like(z))
        else:
            g = y_hat - label
            loss = 0.5 * g * g

        # ∂ŷ/∂w_i = x_i ;  ∂ŷ/∂v_i = x_i (s − x_i v_i)
        dw = g.unsqueeze(1) * x + cfg.l2 * w
        dv = g[:, None, None] * (x.unsqueeze(-1) * (s.unsqueeze(1) - xv)) + cfg.l2 * v
        deltas = torch.cat([-cfg.learning_rate * dw.unsqueeze(-1), -cfg.learning_rate * dv], dim=-1)

        mask = batch["feat_mask"] & batch["mask"].unsqueeze(1)
        out = {"prediction": y_hat, "loss": loss * batch["mask"]}
        return state, PushRequest(batch["ids"], deltas, mask), out


def make_store(config: FMConfig, *, seed: int = 0, init_stddev: float = 0.01, mesh=None,
               dtype: torch.dtype = torch.float32, scatter_impl: str = "xla",
               layout: str = "dense", device: DeviceLike = None) -> ShardedParamStore:
    """(num_features, 1+dim) store: w zero, v ~ N(0, init_stddev) per
    (seed, id).  ``layout="packed"`` (or ``"auto"``) puts
    ``128 // (1+dim)`` rows in each 128-wide physical row."""
    vinit = normal_factor(seed, (config.dim,), stddev=init_stddev, dtype=dtype)

    def init(ids: torch.Tensor) -> torch.Tensor:
        v = vinit(ids)
        return torch.cat([torch.zeros(tuple(ids.shape) + (1,), dtype=v.dtype, device=v.device), v], dim=-1)

    return ShardedParamStore.create(config.num_features, (1 + config.dim,), init_fn=init, mesh=mesh,
                                    dtype=dtype, scatter_impl=scatter_impl, layout=layout,
                                    device=device)


def train_fm(data, config: FMConfig, *, seed: int = 0, mesh=None, scatter_impl: str = "xla",
             layout: str = "dense", device: DeviceLike = None, **kwargs):
    """FM training over an iterable of microbatches;
    ``result.store.values()`` is the (num_features, 1+dim) model."""
    store = make_store(config, seed=seed, mesh=mesh, scatter_impl=scatter_impl, layout=layout,
                       device=device)
    return transform_batched(data, FactorizationMachine(config), store, mesh=mesh, **kwargs)


__all__ = ["FMConfig", "FactorizationMachine", "make_store", "train_fm"]
