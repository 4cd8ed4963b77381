"""Public parameter-server API surface: the event programming model.

Counterpart of ``flink_parameter_server_tpu/core/api.py``, copied (it is
framework-neutral).  The reference system's traits:

  * ``WorkerLogic[T, P, WOut]``            → :class:`WorkerLogic`
  * ``ParameterServerLogic[P, PSOut]``     → :class:`ParameterServerLogic`
  * ``ParameterServerClient[P, WOut]``     → :class:`ParameterServerClient`
  * ``ParameterServer[P, PSOut]``          → :class:`ParameterServer`
  * ``WorkerLogic.addPullLimiter``         → :func:`add_pull_limiter`

Two programming models are offered: this module's per-record callbacks
(``on_recv(data, ps)`` / ``on_pull_recv(id, value, ps)``), run on the host
by the event backend in :mod:`.transform` with the reference's
asynchronous interleaving, any Python allowed; and the batched API
(:mod:`.batched`), a function over a microbatch whose pull is a gather
and whose push a scatter-add on the card.  ``transform`` takes either.
"""
from __future__ import annotations

import abc
import collections
from typing import Callable, Generic, Optional, TypeVar

T = TypeVar("T")  # training-data record type
P = TypeVar("P")  # parameter value type
WOut = TypeVar("WOut")  # worker output type
PSOut = TypeVar("PSOut")  # server output type


class ParameterServerClient(abc.ABC, Generic[P, WOut]):
    """What worker logic calls: ``pull`` / ``push`` / ``output``.

    Mirrors the reference's ``ParameterServerClient`` (SURVEY.md §2 #4).
    """

    @abc.abstractmethod
    def pull(self, param_id: int) -> None:
        """Request the current value of ``param_id``; the answer arrives
        asynchronously via ``WorkerLogic.on_pull_recv``."""

    @abc.abstractmethod
    def push(self, param_id: int, delta: P) -> None:
        """Send a delta to be folded into the stored value."""

    @abc.abstractmethod
    def output(self, w_out: WOut) -> None:
        """Emit a record on the worker-output stream."""


class WorkerLogic(abc.ABC, Generic[T, P, WOut]):
    """User hook driving training, invoked per input record and per pull
    answer.  Mirrors the reference's ``WorkerLogic`` trait
    (SURVEY.md §2 #2: ``onRecv`` / ``onPullRecv`` / ``close``)."""

    @abc.abstractmethod
    def on_recv(self, data: T, ps: ParameterServerClient[P, WOut]) -> None:
        """Called once per training record delivered to this worker."""

    @abc.abstractmethod
    def on_pull_recv(
        self, param_id: int, param_value: P, ps: ParameterServerClient[P, WOut]
    ) -> None:
        """Called once per pull answer addressed to this worker."""

    def close(self) -> None:  # noqa: B027 — optional hook
        """Called when the input is exhausted and the loop has drained."""


class ParameterServer(abc.ABC, Generic[P, PSOut]):
    """Server-side callback interface handed to ``ParameterServerLogic``.

    Mirrors the reference's ``ParameterServer`` iface
    (``answerPull(id, value, workerIdx)`` / ``output(psOut)``)."""

    @abc.abstractmethod
    def answer_pull(self, param_id: int, value: P, worker_idx: int) -> None:
        ...

    @abc.abstractmethod
    def output(self, ps_out: PSOut) -> None:
        ...


class ParameterServerLogic(abc.ABC, Generic[P, PSOut]):
    """Server hook per pull/push.  Mirrors the reference's
    ``ParameterServerLogic`` (SURVEY.md §2 #3)."""

    @abc.abstractmethod
    def on_pull_recv(
        self, param_id: int, worker_idx: int, ps: ParameterServer[P, PSOut]
    ) -> None:
        ...

    @abc.abstractmethod
    def on_push_recv(
        self, param_id: int, delta: P, ps: ParameterServer[P, PSOut]
    ) -> None:
        ...

    def close(self, ps: ParameterServer[P, PSOut]) -> None:  # noqa: B027
        """Input exhausted: typically dumps the final model to the PS-output
        stream (the reference's "flush model on close", SURVEY.md §3.5)."""


class SimplePSLogic(ParameterServerLogic[P, PSOut]):
    """Default server logic: in-memory keyed store with user ``init`` and
    ``update`` functions — the reference's ``SimplePSLogic`` backed by a
    ``HashMap[Int, P]`` with ``getOrElseUpdate`` semantics.

    On close, dumps every ``(id, value)`` pair to the server-output stream.
    """

    def __init__(
        self,
        init: Callable[[int], P],
        update: Callable[[P, P], P],
    ) -> None:
        self.init = init
        self.update = update
        self.store: dict[int, P] = {}

    def on_pull_recv(self, param_id, worker_idx, ps):
        if param_id not in self.store:
            self.store[param_id] = self.init(param_id)
        ps.answer_pull(param_id, self.store[param_id], worker_idx)

    def on_push_recv(self, param_id, delta, ps):
        if param_id not in self.store:
            self.store[param_id] = self.init(param_id)
        self.store[param_id] = self.update(self.store[param_id], delta)

    def close(self, ps):
        for param_id, value in self.store.items():
            ps.output((param_id, value))


class _PullLimitedClient(ParameterServerClient[P, WOut]):
    """Client wrapper enforcing a bound on in-flight pulls per worker."""

    def __init__(self, inner: ParameterServerClient[P, WOut], limiter: "_PullLimiter"):
        self._inner = inner
        self._limiter = limiter

    def pull(self, param_id: int) -> None:
        self._limiter.request(param_id, self._inner)

    def push(self, param_id: int, delta) -> None:
        self._inner.push(param_id, delta)

    def output(self, w_out) -> None:
        self._inner.output(w_out)


class _PullLimiter:
    def __init__(self, limit: int):
        self.limit = limit
        self.in_flight = 0
        self.queue: collections.deque = collections.deque()

    def request(self, param_id: int, client: ParameterServerClient) -> None:
        if self.in_flight < self.limit:
            self.in_flight += 1
            client.pull(param_id)
        else:
            self.queue.append(param_id)

    def on_answer(self, client: ParameterServerClient) -> None:
        self.in_flight -= 1
        while self.queue and self.in_flight < self.limit:
            self.in_flight += 1
            client.pull(self.queue.popleft())

    def inflight(self) -> int:
        """Pulls issued but not yet answered — the pipelining depth the
        limiter is currently using (<= ``limit``; queued requests are
        NOT in flight).  Exposed so the telemetry plane can watch a
        worker's pull pipeline live instead of inferring it."""
        return self.in_flight

    def queued(self) -> int:
        """Pulls waiting for a window slot (the backpressure signal)."""
        return len(self.queue)


class _PullLimitedWorker(WorkerLogic[T, P, WOut]):
    def __init__(self, inner: WorkerLogic[T, P, WOut], limit: int):
        self._inner = inner
        self._limiter = _PullLimiter(limit)

    @property
    def limiter(self) -> _PullLimiter:
        """The wrapped limiter (its ``inflight()``/``queued()`` are the
        observability surface ``add_pull_limiter`` registers as gauges)."""
        return self._limiter

    def on_recv(self, data, ps):
        self._inner.on_recv(data, _PullLimitedClient(ps, self._limiter))

    def on_pull_recv(self, param_id, param_value, ps):
        self._limiter.on_answer(ps)
        self._inner.on_pull_recv(param_id, param_value, _PullLimitedClient(ps, self._limiter))

    def close(self):
        self._inner.close()


def add_pull_limiter(
    worker_logic: WorkerLogic[T, P, WOut],
    limit: int,
    *,
    registry=None,
    worker: Optional[str] = None,
) -> WorkerLogic[T, P, WOut]:
    """Bound the number of in-flight pulls per worker — the reference's
    ``WorkerLogic.addPullLimiter`` (SURVEY.md §2 #2).  Excess pulls queue on
    the worker and are issued as answers come back.

    The limiter's window usage is observable live: ``inflight_pulls``
    and ``queued_pulls`` probe gauges (``component=train``, plus a
    ``worker=`` label when given) register on ``registry`` — default the
    process-wide one — so a pipeline stuck at its window (inflight
    pinned at ``limit``, queue growing) shows on ``/metrics`` instead of
    being invisible inside the event loop.  ``registry=False`` opts out
    (pure-unit tests)."""
    wrapped = _PullLimitedWorker(worker_logic, limit)
    if registry is not False:
        # lazy import: core/ must not import telemetry/ at module load
        # (telemetry is a leaf plane, core is the trunk)
        from ..telemetry.registry import get_registry

        reg = registry if registry is not None else get_registry()
        labels = {"worker": worker} if worker is not None else {}
        reg.gauge(
            "inflight_pulls", component="train",
            fn=wrapped.limiter.inflight, **labels,
        )
        reg.gauge(
            "queued_pulls", component="train",
            fn=wrapped.limiter.queued, **labels,
        )
    return wrapped


__all__ = [
    "ParameterServerClient",
    "WorkerLogic",
    "ParameterServer",
    "ParameterServerLogic",
    "SimplePSLogic",
    "add_pull_limiter",
]
