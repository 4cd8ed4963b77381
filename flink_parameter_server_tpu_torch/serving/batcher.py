"""Request admission + microbatch coalescing for the serve path.

A copy of ``flink_parameter_server_tpu/serving/batcher.py``, which imports
no JAX: the port imports nothing of the JAX package, whose ``__init__``
imports JAX.  Modules it names that the port does not have yet are the
reference's.

The jitted query kernels want fixed-shape microbatches for exactly the
reason the ingest side does (``data/streams.py`` — SURVEY.md §7
"Dynamic shapes"): one compiled program per shape, padding + masks for
ragged reality.  This batcher is the serve-side mirror of that
discipline:

  * concurrent ``submit()`` calls land in ONE bounded queue; when the
    queue is full the request is REJECTED (``QueueFull``), never
    blocked — serving latency must stay bounded under overload, and the
    caller (TCP front end) turns the rejection into a protocol error
    the client can back off on;
  * the dispatch thread coalesces whatever is queued into a microbatch:
    flush fires when ``max_batch`` requests accumulate OR the oldest
    queued request has waited ``max_delay_ms`` (deadline-based flush —
    single stragglers never wait for a full batch);
  * batch shapes are padded UP to a bucket (powers of two up to
    ``max_batch``) so the query kernels compile once per bucket, not
    once per occupancy.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, List, Optional, Sequence, Tuple


class QueueFull(RuntimeError):
    """Admission queue at capacity: the request was rejected, not queued."""


class DeadlineExceeded(RuntimeError):
    """The request waited in the admission queue past its deadline:
    answering it now would hand the client a result it has already
    given up on, so it is failed instead of served — the queue drains
    at the cost of badput, not of growing latency for everyone
    (``err deadline`` on the serving wire)."""


def pow2_bucket(n: int, cap: int) -> int:
    """Smallest power of two >= n, capped at ``cap``."""
    b = 1
    while b < n and b < cap:
        b <<= 1
    return min(b, cap)


@dataclasses.dataclass
class PendingRequest:
    """One admitted request: opaque payload + the future its answer
    lands in + its admission timestamp (latency accounting)."""

    payload: Any
    future: Future
    t_submit: float


class RequestBatcher:
    """Bounded admission queue with deadline-flush coalescing.

    Producer side (any thread): :meth:`submit` — O(1), raises
    :class:`QueueFull` at capacity.  Consumer side (the serving dispatch
    thread): :meth:`next_batch` — blocks until a batch is due and
    returns up to ``max_batch`` admitted requests.
    """

    def __init__(
        self,
        *,
        max_batch: int = 64,
        max_delay_ms: float = 2.0,
        max_queue: int = 256,
        deadline_ms: Optional[float] = None,
        buckets: Optional[Sequence[int]] = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch={max_batch}: must be >= 1")
        if max_queue < 1:
            raise ValueError(f"max_queue={max_queue}: must be >= 1")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms={deadline_ms}: must be > 0")
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay_ms) / 1e3
        self.max_queue = int(max_queue)
        # per-request queue-wait deadline (seconds); the dispatch loop
        # fails expired requests with DeadlineExceeded instead of
        # serving answers nobody is waiting for.  None = no deadline.
        self.deadline_s = (
            None if deadline_ms is None else float(deadline_ms) / 1e3
        )
        if buckets is None:
            buckets = []
            b = 1
            while b < self.max_batch:
                buckets.append(b)
                b <<= 1
            buckets.append(self.max_batch)
        self.buckets: Tuple[int, ...] = tuple(sorted(set(int(b) for b in buckets)))
        if self.buckets[-1] != self.max_batch:
            raise ValueError(
                f"largest bucket {self.buckets[-1]} != max_batch "
                f"{self.max_batch}"
            )
        self._queue: "collections.deque[PendingRequest]" = collections.deque()
        self._cond = threading.Condition()
        self._closed = False
        self.submitted = 0
        self.rejected = 0

    # -- producer side -----------------------------------------------------
    def submit(self, payload: Any) -> Future:
        """Admit one request; returns the Future its answer resolves.

        Raises :class:`QueueFull` when ``max_queue`` requests are already
        waiting — overload sheds load instead of growing latency."""
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if len(self._queue) >= self.max_queue:
                self.rejected += 1
                raise QueueFull(
                    f"serving queue at capacity ({self.max_queue}); retry "
                    f"with backoff"
                )
            fut: Future = Future()
            self._queue.append(
                PendingRequest(payload, fut, time.monotonic())
            )
            self.submitted += 1
            self._cond.notify_all()
            return fut

    # -- consumer side -----------------------------------------------------
    def next_batch(
        self, timeout: Optional[float] = None
    ) -> Optional[List[PendingRequest]]:
        """Block until a batch is due (full, or the oldest request hit
        its deadline), then pop up to ``max_batch`` requests.  Returns
        ``None`` on ``timeout`` with nothing queued, or when closed and
        drained."""
        t_end = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._queue:
                if self._closed:
                    return None
                if t_end is not None:
                    remaining = t_end - time.monotonic()
                    if remaining <= 0:
                        return None
                    self._cond.wait(remaining)
                else:
                    self._cond.wait(0.1)
            # one request is in: flush when full OR at its deadline
            flush_at = self._queue[0].t_submit + self.max_delay
            while len(self._queue) < self.max_batch and not self._closed:
                now = time.monotonic()
                if now >= flush_at:
                    break
                self._cond.wait(flush_at - now)
            n = min(len(self._queue), self.max_batch)
            batch = [self._queue.popleft() for _ in range(n)]
            self._cond.notify_all()
            return batch

    # -- introspection / lifecycle -----------------------------------------
    @property
    def depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def bucket_for(self, n: int) -> int:
        """Smallest configured bucket >= n (pad-to-bucket shape)."""
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def close(self) -> None:
        """Stop admitting; wake consumers.  Queued requests that were
        never served get a ``RuntimeError`` set so waiters unblock."""
        with self._cond:
            self._closed = True
            while self._queue:
                p = self._queue.popleft()
                if not p.future.done():
                    p.future.set_exception(
                        RuntimeError("serving batcher closed")
                    )
            self._cond.notify_all()

    def reopen(self) -> None:
        """Resume admission after :meth:`close` — the supervised-restart
        path (``ServingService.start`` on a service that was stopped):
        a restarted trainer re-attaching its serving plane must not
        inherit a permanently-closed admission queue."""
        with self._cond:
            self._closed = False
            self._cond.notify_all()


__all__ = [
    "DeadlineExceeded",
    "QueueFull",
    "RequestBatcher",
    "PendingRequest",
    "pow2_bucket",
]
