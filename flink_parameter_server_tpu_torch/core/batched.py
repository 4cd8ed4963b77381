"""Batched worker API — one microbatch of events per step.

Counterpart of ``flink_parameter_server_tpu/core/batched.py``:

    ids            = logic.keys(batch)                # which params to pull
    pulled         = store.pull(ids)                  # row gather
    state, req, o  = logic.step(state, batch, pulled) # the training math
    store          = store.push(req.ids, req.deltas)  # scatter-add

The worker's local state (e.g. MF user vectors) is threaded through
``step`` explicitly; the port's ``step`` may update it in place.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Generic, Optional, Tuple, TypeVar

import torch

State = TypeVar("State")
Batch = TypeVar("Batch")
Out = TypeVar("Out")


@dataclasses.dataclass
class PushRequest:
    """A microbatch of pushes: fold ``deltas[i]`` into param ``ids[i]``.

    ``mask`` marks valid lanes (padding-friendly static shapes)."""

    ids: torch.Tensor
    deltas: torch.Tensor
    mask: Optional[torch.Tensor] = None


class BatchedWorkerLogic(abc.ABC, Generic[State, Batch, Out]):
    """Worker logic run once per microbatch by the train step."""

    @abc.abstractmethod
    def init_state(self, rng: Optional[torch.Generator]) -> State:
        """Create the worker-local state."""

    @abc.abstractmethod
    def keys(self, batch: Batch) -> torch.Tensor:
        """Param ids this microbatch needs pulled (static shape; pad +
        mask for variable counts)."""

    @abc.abstractmethod
    def step(
        self, state: State, batch: Batch, pulled: torch.Tensor
    ) -> Tuple[State, PushRequest, Out]:
        """One training step over the microbatch."""

    def finish(self, state: State) -> Any:  # noqa: B027
        """Optional close-time worker output (e.g. dump local user
        vectors) — counterpart of ``WorkerLogic.close``."""
        return None

    def per_record_leaves(self, batch: Batch) -> Any:
        """Optional presort contract: a tree of bools with ``batch``'s
        structure, True for leaves indexed per record.  When overridden,
        ``presort=True`` permutes exactly the True leaves and validates
        their leading dims; ``None`` (the default) keeps the shape rule
        (permute every leaf whose leading dim equals the key count)."""
        return None

    def per_record_outputs(self, out: Out) -> Any:
        """Optional dp-split contract: a tree of bools with ``out``'s
        structure, True for the step's per-record outputs, which a train
        step split over ``dp`` all-gathers (the rest stay the slice's
        own); ``None`` (the default) keeps the shape rule (every tensor
        leaf whose leading dim equals the slice's record count)."""
        return None


__all__ = ["PushRequest", "BatchedWorkerLogic"]
