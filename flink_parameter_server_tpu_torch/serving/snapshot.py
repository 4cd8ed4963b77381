"""Versioned table snapshots — the read path's isolation boundary.

Counterpart of ``flink_parameter_server_tpu/serving/snapshot.py``.  The
port's train step updates the live item table and the live user state IN
PLACE (K1 and the row scatter-add write into them on every step), so a
reader holding either tensor, or a view of one, would see it change under
it without any error.  At a configurable ``publish_every`` cadence the
trainer therefore *clones* both (copy-on-publish) and swaps an immutable,
versioned :class:`TableSnapshot` behind a lock.  Readers grab the latest
snapshot pointer once per query and see a bit-identical table until the
next publish; staleness (trainer steps behind) is carried as metadata on
every answer instead of being hidden.

All publishes happen on the TRAINING thread (the driver's dispatch
callback), on the current stream, so the clone is queued after the step
that produced the values and before the next step's writes.  ``publish``
then synchronises that stream, as the reference's
``jax.block_until_ready`` waits for its copy, so a snapshot is complete
before any reader can see it.  Readers run on their threads' current
stream too — the default stream unless a caller sets another — so the
caching allocator reuses a dropped snapshot's memory only after the
reads queued on that stream.  A reader on a stream of its own would have
to ``record_stream`` the snapshot's tensors.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Optional

import torch

from ..core.store import ShardedParamStore, StoreSpec
from ..core.transform import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TableSnapshot:
    """An immutable published copy of the parameter table.

    ``aux`` carries whatever the trainer published alongside the table —
    the driver publishes the worker state (e.g. MF user factors), which
    is what the query engine scores with.  ``train_step`` is the trainer
    step the snapshot was taken at; staleness at read time is computed
    against the manager's live step counter."""

    spec: StoreSpec
    table: torch.Tensor
    aux: Any
    version: int
    train_step: int
    published_at: float

    def store(self) -> ShardedParamStore:
        """The snapshot as a read-only store (pull/top-K compose)."""
        return ShardedParamStore(self.spec, self.table)


def _clone(x: Any) -> Any:
    return x.detach().clone() if isinstance(x, torch.Tensor) else x


def _wait_for_copies(*trees: Any) -> None:
    """Block until the copies just queued on the current streams of their
    devices are done (a no-op for CPU tensors)."""
    devices = {
        leaf.device for tree in trees for leaf in tree_leaves(tree)
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda
    }
    for device in devices:
        torch.cuda.current_stream(device).synchronize()


class SnapshotManager:
    """Publish-side cadence + read-side pointer swap, thread-safe.

    ``publish_every`` is measured in trainer steps: ``maybe_publish``
    republishes only once the trainer has advanced that far past the
    last published snapshot (the first offer always publishes).  Every
    ``note_step``/``maybe_publish`` call also advances the live step
    counter that :meth:`staleness` measures against.
    """

    def __init__(self, spec: StoreSpec, *, publish_every: int = 1):
        if publish_every < 1:
            raise ValueError(f"publish_every={publish_every}: must be >= 1")
        self.spec = spec
        self.publish_every = int(publish_every)
        self._lock = threading.Lock()
        self._latest: Optional[TableSnapshot] = None
        self._current_step = 0
        self._published = threading.Event()

    # -- publish side (training thread) -----------------------------------
    def publish(self, table: torch.Tensor, step: int, aux: Any = None) -> TableSnapshot:
        """Copy-on-publish: clone the live table and ``aux`` (which the
        next step updates in place) and swap the latest pointer.  Returns
        once the copies are complete on the device."""
        copied = _clone(table)
        aux_copied = tree_map(_clone, aux)
        _wait_for_copies(copied, aux_copied)
        with self._lock:
            version = (self._latest.version + 1) if self._latest else 1
            snap = TableSnapshot(
                spec=self.spec,
                table=copied,
                aux=aux_copied,
                version=version,
                train_step=int(step),
                published_at=time.time(),
            )
            self._latest = snap
            self._current_step = max(self._current_step, int(step))
        self._published.set()
        return snap

    def maybe_publish(
        self, table: torch.Tensor, step: int, aux: Any = None
    ) -> Optional[TableSnapshot]:
        """Publish iff the cadence is due; always advances the live step
        counter (so staleness keeps ticking between publishes)."""
        self.note_step(step)
        with self._lock:
            due = (
                self._latest is None
                or int(step) - self._latest.train_step >= self.publish_every
            )
        if due:
            return self.publish(table, step, aux)
        return None

    def note_step(self, step: int) -> None:
        """Record trainer progress without publishing (staleness input)."""
        with self._lock:
            self._current_step = max(self._current_step, int(step))

    # -- read side (serving threads) ---------------------------------------
    def latest(self) -> Optional[TableSnapshot]:
        with self._lock:
            return self._latest

    @property
    def current_step(self) -> int:
        with self._lock:
            return self._current_step

    def staleness_of(self, snap: TableSnapshot) -> int:
        """Trainer steps the snapshot lags the live table (>= 0)."""
        return max(0, self.current_step - snap.train_step)

    def staleness(self) -> Optional[int]:
        snap = self.latest()
        return None if snap is None else self.staleness_of(snap)

    def wait_for_snapshot(self, timeout: Optional[float] = None) -> bool:
        """Block until the first publish (serving warm-up gate)."""
        return self._published.wait(timeout)


__all__ = ["TableSnapshot", "SnapshotManager"]
