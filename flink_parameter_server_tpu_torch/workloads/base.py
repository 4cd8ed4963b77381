"""The workload contract — heterogeneous learners as first-class
cluster citizens.

Counterpart of ``flink_parameter_server_tpu/workloads/base.py``.  The
contract, the parity modes and the push semantics are the reference's;
what changed is where the step runs: a workload is built for a ``device``
(the card unless the caller passes ``device="cpu"``), its logic computes
there, and :class:`DenseCombineLogic` combines the step's lanes on that
device with the port's deterministic row scatter-add
(``ops/rows.accumulate_rows_``: a stable sort and one ordered sum per run
on the card, never ``index_add_``'s atomics).

The original Flink PS shipped online passive-aggressive classification
and streaming sketches ALONGSIDE matrix factorization (PAPER.md §0).  A
:class:`Workload` packages everything a learner needs to ride the FULL
stack:

  * a :class:`~..core.batched.BatchedWorkerLogic` for
    :class:`~..cluster.driver.ClusterDriver` (the same object the
    single-process :class:`~..training.driver.StreamingDriver` runs);
  * a deterministic row-init spec — an in-process ``init_fn`` plus the
    picklable ``proc_init`` dict :mod:`~..cluster.procs` shard worker
    processes resolve, so the SAME table renders on both arms;
  * a seeded streaming data generator (``batches()``, numpy), equal to
    the reference's bit for bit per :class:`WorkloadParams` — what makes
    a faulted run comparable to its fault-free oracle;
  * a **parity oracle** (``oracle_values()``) with a declared parity
    mode: ``"bitwise"`` (PA: a BSP cluster run must equal the streaming
    oracle bit for bit), ``"exact_int"`` (sketches: counts are integers
    — no float tolerance), or ``"allclose"`` (MF: the repo-wide fp32
    tolerance);
  * **push semantics**: ``"delta"`` workloads push fp32 deltas and may
    ride the quantized ``q8``/``bf16`` wire codecs; ``"increment"``
    workloads push integer bucket increments, for which the quantized
    paths are BYPASSED end to end (the cluster driver downgrades to
    exact fp32 — a dequantized count within-a-granule of right is still
    wrong);
  * per-workload **serving verbs** (``predict`` for PA margins,
    ``query``/``topk`` for sketches) dispatched by
    :class:`~.serving.WorkloadServingServer` over a
    :class:`~..cluster.client.ClusterClient`.

``probe_request`` is the nemesis serving reader's request
(``nemesis/runner.py``); the reference's ``soak_read_ids`` / ``soak_push``
(the open-loop soak's surface) come with ``loadgen/``'s soak (ROADMAP
Queue 1 #7h).
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.batched import BatchedWorkerLogic, PushRequest
from ..ops.rows import add_rows_
from ..utils.device import DeviceLike, resolve_device

PUSH_SEMANTICS = ("delta", "increment")
PARITY_MODES = ("bitwise", "exact_int", "allclose")


@dataclasses.dataclass(frozen=True)
class WorkloadParams:
    """The shape knobs every workload derives its topology-independent
    stream and table from.  Field names follow the nemesis scenario
    vocabulary (rounds × batch events, ``num_items`` sizes the id
    space, ``num_users`` the entity space, ``dim`` the row width where
    the workload has one); deterministic in ``seed``."""

    rounds: int = 12
    batch: int = 96
    num_users: int = 48
    num_items: int = 64
    dim: int = 4
    seed: int = 3
    # the oracle must model worker routing where fp32 update order
    # depends on it (MF's cluster oracle); order-independent workloads
    # (integer sketches) ignore it
    num_workers: int = 2


class Workload(abc.ABC):
    """One learner packaged for the full stack (see module docstring).

    Subclasses set the class attributes and implement the abstract
    surface; everything else (parity verdicts) has working defaults.
    ``device`` is where the logic computes and the oracles' tables live:
    the card unless the caller passes ``device="cpu"``."""

    name: str = "?"
    push_semantics: str = "delta"
    parity: str = "allclose"
    serving_verbs: Tuple[str, ...] = ()
    worker_key: str = "user"

    def __init__(
        self,
        params: Optional[WorkloadParams] = None,
        *,
        device: DeviceLike = None,
    ):
        if self.push_semantics not in PUSH_SEMANTICS:
            raise ValueError(
                f"{type(self).__name__}.push_semantics="
                f"{self.push_semantics!r}: one of {PUSH_SEMANTICS}"
            )
        if self.parity not in PARITY_MODES:
            raise ValueError(
                f"{type(self).__name__}.parity={self.parity!r}: "
                f"one of {PARITY_MODES}"
            )
        self.params = params if params is not None else WorkloadParams()
        self.device = resolve_device(device)

    # -- the cluster wiring --------------------------------------------------
    @property
    @abc.abstractmethod
    def capacity(self) -> int:
        """Global table rows (the ShardedParamStore capacity)."""

    @property
    def value_shape(self) -> Tuple[int, ...]:
        return ()

    @abc.abstractmethod
    def make_logic(self) -> BatchedWorkerLogic:
        """A fresh worker logic (the SAME object both the cluster and
        streaming drivers run), computing on :attr:`device`."""

    def init_fn(self):
        """In-process deterministic per-id init (None = zeros)."""
        return None

    def proc_init(self) -> Optional[dict]:
        """The picklable init spec for ``cluster/procs.py`` shard
        worker processes (None = zeros); must render the same rows as
        :meth:`init_fn` — the proc-vs-thread parity contract."""
        return None

    # -- the stream ----------------------------------------------------------
    @abc.abstractmethod
    def batches(self):
        """The seeded stream: a list of ``rounds`` microbatch dicts of
        numpy arrays (every batch carries ``mask`` and the
        ``worker_key`` column)."""

    # -- the parity oracle ---------------------------------------------------
    @abc.abstractmethod
    def oracle_values(self) -> np.ndarray:
        """The fault-free final table for :meth:`batches` under this
        workload's parity mode (a host array)."""

    def parity_verdict(self, values: np.ndarray, oracle: np.ndarray):
        """The scenario-runner checker for this workload's parity
        mode (named ``final_table_parity`` in every mode so the corpus
        expectations stay uniform)."""
        from ..nemesis.invariants import (
            check_count_parity,
            check_parity,
            check_parity_bitwise,
        )

        if self.parity == "bitwise":
            return check_parity_bitwise(values, oracle)
        if self.parity == "exact_int":
            return check_count_parity(values, oracle)
        return check_parity(values, oracle)

    # -- serving -------------------------------------------------------------
    def serve(self, client, cmd: str, arg: str) -> str:
        """Answer one serving request through ``client`` (a
        :class:`~..cluster.client.ClusterClient`); returns the response
        payload (the server prepends ``ok``).  Raise ``ValueError`` for
        a malformed request."""
        raise ValueError(
            f"workload {self.name!r} serves no {cmd!r} "
            f"(verbs: {list(self.serving_verbs)})"
        )

    def probe_request(self, rng: np.random.Generator
                      ) -> Optional[Tuple[str, str]]:
        """One representative serving request ``(cmd, arg)`` — what the
        nemesis serving reader issues.  None when the workload has no
        serving verbs."""
        return None

    def describe(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "capacity": int(self.capacity),
            "value_shape": list(self.value_shape),
            "push_semantics": self.push_semantics,
            "parity": self.parity,
            "serving_verbs": list(self.serving_verbs),
            "worker_key": self.worker_key,
        }


class DenseCombineLogic(BatchedWorkerLogic):
    """Wrap a multi-key worker logic with an ON-DEVICE combine step:
    the inner step's ``(B, K)`` lane pushes are scatter-added into one
    dense ``(capacity,)`` delta table inside the SAME step, and the
    PushRequest becomes one row per touched id.

    This is the on-device combination sender, and it is what makes
    BITWISE BSP parity between the cluster and the streaming oracle a
    structural property instead of luck: duplicate-id lane sums happen
    in exactly one place (this scatter, identical in both drivers), so
    the cluster client's host-side aggregation and the shard's scatter
    each see at most one already-combined fp32 row per id — a single
    f32 value survives the client's f64 combine unchanged, and the
    shard applies one add per row.  The scatter is the port's
    ``add_rows_`` (drop-mode index rules over ``accumulate_rows_``):
    deterministic on the card, so two runs of the same step agree bit
    for bit.  The reference's ``.at[].max`` for the touched mask is a
    boolean scatter of the valid lanes.

    Scalar value shapes only (the PA weight vector); ``capacity`` must
    be small enough that a dense per-round delta is cheap — which is
    exactly the regime sparse linear models live in."""

    def __init__(self, inner: BatchedWorkerLogic, capacity: int):
        self.inner = inner
        self.capacity = int(capacity)

    def init_state(self, rng):
        return self.inner.init_state(rng)

    def keys(self, batch):
        return self.inner.keys(batch)

    def step(self, state, batch, pulled):
        state, req, out = self.inner.step(state, batch, pulled)
        dev = req.deltas.device
        flat_ids = req.ids.reshape(-1).to(torch.int64)
        flat_d = req.deltas.reshape(-1).to(torch.float32)
        m = (
            req.mask.reshape(-1).to(torch.bool)
            if req.mask is not None
            else torch.ones(flat_d.shape, dtype=torch.bool, device=dev)
        )
        flat_d = torch.where(m, flat_d, torch.zeros_like(flat_d))
        dense = add_rows_(
            torch.zeros(self.capacity, dtype=torch.float32, device=dev),
            flat_ids, flat_d,
        )
        # .at[ids].max(mask, mode="drop"): negatives wrap once, the
        # rest out of range drop, and a row is touched when any valid
        # lane names it
        wrapped = torch.where(flat_ids < 0, flat_ids + self.capacity, flat_ids)
        hit = m & (wrapped >= 0) & (wrapped < self.capacity)
        touched = torch.zeros(self.capacity, dtype=torch.bool, device=dev)
        touched[wrapped[hit]] = True
        return state, PushRequest(
            torch.arange(self.capacity, dtype=torch.int32, device=dev),
            dense, touched,
        ), out


__all__ = [
    "PARITY_MODES",
    "PUSH_SEMANTICS",
    "DenseCombineLogic",
    "Workload",
    "WorkloadParams",
]
