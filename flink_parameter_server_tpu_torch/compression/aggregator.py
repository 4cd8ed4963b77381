"""PushAggregator — the two-level aggregation tree's host-local stage.

A copy of ``flink_parameter_server_tpu/compression/aggregator.py``, which imports
no JAX: the port imports nothing of the JAX package, whose ``__init__``
imports JAX.  Modules it names that the port does not have yet are the
reference's.

MXNET-MPI's observation (arXiv 1801.03855), applied to this topology:
workers that share a host should COMBINE their deltas locally before
anything crosses the wire — a collective inside the PS boundary — so
the shards see ONE combined push per round instead of one per worker.
With ``W`` co-located workers pushing overlapping Zipf-hot ids, that
is a ``W×`` cut in frames and up to ``W×`` in row bytes before the
payload codec (quantizers.py) even runs; stacked, the two levels are
the bytes-down story docs/compression.md commits to.

Mechanics: one :class:`PushAggregator` per driver run fronts a single
**uplink** :class:`~..cluster.client.ClusterClient` (the combiner's
own client, so the ledger keeps balancing: rows acked by the uplink ==
rows the shards apply; worker clients never touch the push wire at
all).  Each worker's
``push_batch(worker, ids, deltas, mask)`` parks at a
:class:`threading.Barrier`; the barrier ACTION — run on exactly one
thread per round, the rendezvous contract — merges every slot through
:func:`~..ops.dedup.aggregate_delta_batches` and issues the one
combined push.  An error in the combined push is re-raised in every
waiting worker (they all contributed rows to it); a worker dying
elsewhere must :meth:`abort` so siblings get ``BrokenBarrierError``
instead of a hang.

The rendezvous makes pushes per-round lockstep even under an SSP
clock — workers still *read* up to ``k`` rounds apart, but each
round's writes land together.  That is the documented trade
(docs/compression.md "aggregation tree"): fan-in for wire bytes.

Instruments (``component=compression``): ``compression_combine_fanin``
(how many workers actually contributed last round),
``compression_combined_pushes_total``, and
``compression_combined_rows_saved_total`` (duplicate rows the combine
kept off the wire).
"""
from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np

from ..ops.dedup import aggregate_delta_batches


class PushAggregator:
    """Combine co-located workers' round deltas into one uplink push
    (see module docstring).  ``num_workers`` is the rendezvous width;
    ``client`` the combiner's own uplink ClusterClient."""

    def __init__(
        self,
        num_workers: int,
        client,
        *,
        registry=None,
        timeout: float = 120.0,
    ):
        if num_workers < 1:
            raise ValueError(f"num_workers={num_workers}: must be >= 1")
        self.num_workers = int(num_workers)
        self.client = client
        self.timeout = float(timeout)
        self._slots: List[Optional[tuple]] = [None] * self.num_workers
        self._round_error: List[Optional[BaseException]] = [None]
        self.rounds_combined = 0
        self.rows_in = 0  # rows submitted by workers (pre-combine)
        self.rows_pushed = 0  # unique rows the uplink actually pushed
        self.last_fanin = 0
        self._barrier = threading.Barrier(
            self.num_workers, action=self._combine
        )
        if registry is not False and registry is not None:
            self._c_combined = registry.counter(
                "compression_combined_pushes_total",
                component="compression",
            )
            self._c_rows_saved = registry.counter(
                "compression_combined_rows_saved_total",
                component="compression",
            )
            registry.gauge(
                "compression_combine_fanin", component="compression",
                fn=lambda: self.last_fanin,
            )
        else:
            self._c_combined = self._c_rows_saved = None

    # -- the combine (barrier action: runs on exactly one thread) ----------
    def _combine(self) -> None:
        slots, self._slots = self._slots, [None] * self.num_workers
        self._round_error[0] = None
        try:
            unique, summed = aggregate_delta_batches(
                s for s in slots if s is not None
            )
            fanin = sum(
                1 for s in slots
                if s is not None and np.asarray(s[0]).size
            )
            self.last_fanin = fanin
            if unique.size == 0:
                return
            submitted = 0
            for s in slots:
                if s is None:
                    continue
                if len(s) > 2 and s[2] is not None:
                    submitted += int(np.asarray(s[2]).sum())
                else:
                    submitted += int(np.asarray(s[0]).size)
            self.client.push_batch(unique, summed)
            self.rounds_combined += 1
            self.rows_in += submitted
            self.rows_pushed += int(unique.size)
            if self._c_combined is not None:
                self._c_combined.inc()
            if self._c_rows_saved is not None:
                self._c_rows_saved.inc(
                    max(0, submitted - int(unique.size))
                )
        except BaseException as e:  # noqa: BLE001 — re-raised in waiters
            self._round_error[0] = e

    # -- the worker surface -------------------------------------------------
    def push_batch(self, worker: int, ids, deltas, mask=None) -> None:
        """Park this worker's round contribution and rendezvous; the
        combined push happens once per round, on the last arrival's
        thread.  Raises the combine's error in EVERY contributor."""
        self._slots[int(worker)] = (ids, deltas, mask)
        self._barrier.wait(timeout=self.timeout)
        err = self._round_error[0]
        if err is not None:
            raise err

    def abort(self) -> None:
        """Break the rendezvous — a worker died outside the push path;
        siblings get ``BrokenBarrierError`` instead of a hang."""
        self._barrier.abort()

    def close(self) -> None:
        self.abort()
        self.client.close()


__all__ = ["PushAggregator"]
