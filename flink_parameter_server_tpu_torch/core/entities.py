"""Wire-level message entities of the parameter-server protocol.

Counterpart of ``flink_parameter_server_tpu/core/entities.py``, copied
(it is framework-neutral): the reference system's ``Pull``, ``Push``,
``PullAnswer``, ``WorkerToPS`` and ``PSToWorker`` (SURVEY.md §2 #5).  The
batched step never materialises them: a microbatch of pulls is one
gather and of pushes one scatter-add.  They carry the messages of the
host-side event backend (:mod:`.transform`), which reproduces the
reference's per-record callback semantics.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Generic, TypeVar, Union

P = TypeVar("P")  # parameter value type


@dataclass(frozen=True)
class Pull:
    """Worker asks the server for the current value of ``param_id``."""

    param_id: int


@dataclass(frozen=True)
class Push(Generic[P]):
    """Worker sends a delta for ``param_id`` to be folded into the store."""

    param_id: int
    delta: Any


@dataclass(frozen=True)
class PullAnswer(Generic[P]):
    """Server's reply to a :class:`Pull`."""

    param_id: int
    value: Any


@dataclass(frozen=True)
class WorkerToPS(Generic[P]):
    """Envelope on the worker→server stream.

    ``worker_partition_index`` is embedded so the server can address the
    answer back to the right worker subtask — the reference carries it in
    every message for the same reason (SURVEY.md §2 "Distributed
    communication backend").
    """

    worker_partition_index: int
    message: Union[Pull, Push]


@dataclass(frozen=True)
class PSToWorker(Generic[P]):
    """Envelope on the server→worker (feedback) stream."""

    worker_partition_index: int
    answer: PullAnswer


__all__ = [
    "Pull",
    "Push",
    "PullAnswer",
    "WorkerToPS",
    "PSToWorker",
]
