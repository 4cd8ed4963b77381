"""Deterministic fault injection — every recovery path exercisable in
tier-1, on CPU, seeded.

A copy of ``flink_parameter_server_tpu/resilience/chaos.py``, which imports
no JAX: the port imports nothing of the JAX package, whose ``__init__``
imports JAX.  Modules it names that the port does not have yet are the
reference's.

A recovery layer nobody can test is a recovery layer that does not work
(the reference's was both: SURVEY.md §5).  This module makes each
failure class a *reproducible experiment*:

  * :class:`FaultPlan` — an immutable, seedable schedule of faults
    (crash the training thread at step N, delay batch K by D ms, raise a
    source error at batch K, corrupt the latest checkpoint);
  * driver injection via :meth:`FaultPlan.driver_hook` (registered with
    :meth:`StreamingDriver.add_group_hook <..training.driver.StreamingDriver.add_group_hook>`
    — fires on the training thread at dispatch boundaries, i.e. *after*
    the step's updates were applied, the worst-case crash point);
  * source injection via :meth:`FaultPlan.wrap_source` (delays and
    connection drops happen on the ingest edge, where they do in
    production);
  * :func:`corrupt_latest_checkpoint` — garble the newest checkpoint step
    dir on disk (the corrupt-restore fallback test);
  * :class:`ChaosLineServer` — a line-protocol TCP producer that drops
    the connection every ``drop_every`` lines and resumes where it left
    off, for exercising ``socket_text_stream``'s reconnect path.

Every fault fires at most once (a plan describes one incident timeline,
not a permanent failure mode), so a supervised restart that replays the
same plan does not re-crash at the same step — which is exactly how the
e2e chaos test distinguishes "recovered" from "looping".
"""
from __future__ import annotations

import dataclasses
import os
import socket
import threading
import time
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np


class ChaosError(RuntimeError):
    """The injected crash.  ``failure_class`` (a string from
    :mod:`.recovery`'s vocabulary: "source" | "device" | "unknown")
    steers :func:`~.recovery.classify_failure` so tests can exercise
    each supervision branch deterministically."""

    def __init__(self, message: str, failure_class: str = "device"):
        super().__init__(message)
        self.failure_class = failure_class


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault.

    kind: "crash" (raise on the training thread at ``at >= step``),
    "source_error" (raise from the source at batch index ``at``),
    "delay" (sleep ``delay_ms`` before yielding batch ``at``),
    "disconnect" (raise ConnectionResetError from the source at ``at``).

    Replication-stream kinds (keyed by SHIPPED-RECORD ordinal, fired
    through :meth:`FaultPlan.shipper_hook`): "repl_drop" (sever the
    repl connection — the resync path re-ships, delivery is delayed
    never lost), "repl_delay" (sleep ``delay_ms`` before the ship),
    "repl_partition" (pause the stream ``delay_ms`` — follower lag
    grows past the staleness bound and reads shed to the primary),
    "kill_primary" (invoke the caller's kill callback MID-SHIP, then
    sever — the failover storyline's crash point).
    """

    kind: str
    at: int
    delay_ms: float = 0.0
    failure_class: str = "device"

    _KINDS = (
        "crash", "source_error", "delay", "disconnect",
        "repl_drop", "repl_delay", "repl_partition", "kill_primary",
    )

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError(f"fault kind {self.kind!r}: one of {self._KINDS}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable fault schedule.  Build explicitly::

        plan = FaultPlan().crash_at(7).delay_batch(3, 50.0)

    or sample one deterministically from a seed (the ``--chaos SEED``
    example flag)::

        plan = FaultPlan.from_seed(seed, horizon=40)

    Fired-once bookkeeping is shared by every hook/wrapper handed out by
    the SAME plan object: a supervised restart that re-wraps the re-fed
    stream with the same plan does not replay the incident (each fault
    is one event on one timeline).  A fresh plan object restarts the
    timeline.
    """

    faults: Tuple[Fault, ...] = ()
    seed: Optional[int] = None

    def _fired(self) -> set:
        """The plan-wide fired-fault index set (lazily attached; the
        dataclass is frozen, so methods making new plan objects get a
        fresh timeline while hooks of one object share one)."""
        reg = getattr(self, "_fired_set", None)
        if reg is None:
            reg = set()
            object.__setattr__(self, "_fired_set", reg)
        return reg

    # -- plan construction -------------------------------------------------
    def _with(self, fault: Fault) -> "FaultPlan":
        return dataclasses.replace(self, faults=self.faults + (fault,))

    def crash_at(
        self, step: int, failure_class: str = "device"
    ) -> "FaultPlan":
        """Raise :class:`ChaosError` on the training thread at the first
        dispatch boundary with ``global_step >= step``."""
        return self._with(Fault("crash", step, failure_class=failure_class))

    def source_error_at(
        self, batch: int, failure_class: str = "source"
    ) -> "FaultPlan":
        return self._with(
            Fault("source_error", batch, failure_class=failure_class)
        )

    def delay_batch(self, batch: int, delay_ms: float) -> "FaultPlan":
        return self._with(Fault("delay", batch, delay_ms=delay_ms))

    def disconnect_at(self, batch: int) -> "FaultPlan":
        return self._with(Fault("disconnect", batch))

    # replication-stream faults (fired via :meth:`shipper_hook`; ``at``
    # is the shipper's shipped-record ordinal, not a training step)
    def drop_repl_at(self, record: int) -> "FaultPlan":
        return self._with(Fault("repl_drop", record))

    def delay_repl_at(self, record: int, delay_ms: float) -> "FaultPlan":
        return self._with(Fault("repl_delay", record, delay_ms=delay_ms))

    def partition_repl_at(
        self, record: int, duration_ms: float
    ) -> "FaultPlan":
        return self._with(
            Fault("repl_partition", record, delay_ms=duration_ms)
        )

    def kill_primary_at(self, record: int) -> "FaultPlan":
        return self._with(Fault("kill_primary", record))

    @classmethod
    def from_seed(
        cls,
        seed: int,
        *,
        horizon: int = 40,
        crashes: int = 1,
        delays: int = 1,
        max_delay_ms: float = 50.0,
    ) -> "FaultPlan":
        """Sample a small incident timeline deterministically: crash
        steps uniform over (horizon/4, horizon), delayed batches uniform
        over (0, horizon).  Same seed ⇒ same plan, any host."""
        rng = np.random.default_rng(seed)
        plan = cls(seed=seed)
        for _ in range(crashes):
            plan = plan.crash_at(int(rng.integers(horizon // 4, horizon)))
        for _ in range(delays):
            plan = plan.delay_batch(
                int(rng.integers(0, horizon)),
                float(rng.uniform(1.0, max_delay_ms)),
            )
        return plan

    # -- injection hooks ---------------------------------------------------
    def driver_hook(self):
        """A ``StreamingDriver.add_group_hook`` callable raising each
        "crash" fault once, at the first dispatch boundary at/after its
        step (cadences round up to dispatch boundaries, same as every
        other driver cadence)."""
        fired = self._fired()

        def hook(global_step, n_steps, table, state, outs):
            for i, f in enumerate(self.faults):
                if f.kind == "crash" and i not in fired and global_step >= f.at:
                    fired.add(i)
                    raise ChaosError(
                        f"chaos: injected crash at step {global_step} "
                        f"(scheduled at {f.at})",
                        failure_class=f.failure_class,
                    )

        return hook

    def shipper_hook(self, on_kill_primary=None):
        """A :class:`~..replication.shipper.WALShipper` fault hook:
        called with each shipped record's ordinal, returns the action
        the shipper must take (``"drop"`` severs the stream) or None.
        Delays and partitions sleep HERE (the shipper's thread — the
        stream itself stalls, exactly like a slow or partitioned
        link); ``kill_primary`` fires ``on_kill_primary()`` mid-ship.
        Fired-once bookkeeping is the plan-wide set, like every other
        hook: a resynced stream does not replay the incident."""
        fired = self._fired()

        def hook(record_idx: int):
            action = None
            for i, f in enumerate(self.faults):
                if i in fired or f.kind not in (
                    "repl_drop", "repl_delay", "repl_partition",
                    "kill_primary",
                ) or record_idx < f.at:
                    continue
                fired.add(i)
                if f.kind == "repl_delay":
                    time.sleep(f.delay_ms / 1e3)
                elif f.kind == "repl_partition":
                    time.sleep(f.delay_ms / 1e3)
                elif f.kind == "repl_drop":
                    action = "drop"
                elif f.kind == "kill_primary":
                    if on_kill_primary is not None:
                        on_kill_primary()
                    action = "drop"
            return action

        return hook

    def wrap_source(self, source: Iterable) -> Iterator:
        """Wrap a batch iterator with the source-side faults (delays,
        source errors, disconnects), keyed by batch index.  Restart-safe
        the same way the driver hook is: the fired set is shared across
        every wrapper of this plan object, so the supervisor re-wrapping
        the re-fed stream does not replay the incident — it happened,
        history does not repeat."""
        return _ChaosSource(self, source)


class _ChaosSource:
    """Iterator applying a plan's source faults; the fired set is the
    plan-wide one, so a fault fires at most once per plan object."""

    def __init__(self, plan: FaultPlan, source: Iterable):
        self._plan = plan
        self._it = iter(source)
        self._idx = 0
        self._fired = plan._fired()

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self._it)  # StopIteration passes through (clean end)
        idx = self._idx
        self._idx += 1
        for i, f in enumerate(self._plan.faults):
            if i in self._fired or f.at != idx:
                continue
            if f.kind == "delay":
                self._fired.add(i)
                time.sleep(f.delay_ms / 1e3)
            elif f.kind == "source_error":
                self._fired.add(i)
                raise ChaosError(
                    f"chaos: injected source error at batch {idx}",
                    failure_class=f.failure_class,
                )
            elif f.kind == "disconnect":
                self._fired.add(i)
                raise ConnectionResetError(
                    f"chaos: injected disconnect at batch {idx}"
                )
        return batch


def corrupt_latest_checkpoint(directory: str, *, seed: int = 0) -> str:
    """Wreck the newest numbered step directory of a checkpoint
    manager's tree (``training/checkpoint.JobCheckpointManager``) the way
    a crash mid-write does: truncate every data file to a
    seeded fraction of its length and garble the surviving prefix of
    one of them.  (Garbling a single file is NOT enough — a format that
    parses around noise in one chunk file would restore; a partial
    write hits *every* file still in flight.)  Returns the step dir.
    Raises FileNotFoundError when no step dir exists."""
    directory = os.path.abspath(directory)
    steps = sorted(
        (int(n), n)
        for n in os.listdir(directory)
        if n.isdigit() and os.path.isdir(os.path.join(directory, n))
    )
    if not steps:
        raise FileNotFoundError(f"no checkpoint step dirs under {directory}")
    step_dir = os.path.join(directory, steps[-1][1])
    files = []
    for root, _dirs, names in os.walk(step_dir):
        for n in sorted(names):
            p = os.path.join(root, n)
            if os.path.isfile(p) and os.path.getsize(p) > 0:
                files.append(p)
    if not files:
        raise FileNotFoundError(f"no data files under {step_dir}")
    rng = np.random.default_rng(seed)
    for p in files:
        size = os.path.getsize(p)
        keep = int(size * float(rng.uniform(0.0, 0.5)))
        with open(p, "r+b") as fh:
            fh.truncate(keep)
    garble = files[int(rng.integers(0, len(files)))]
    size = os.path.getsize(garble)
    if size:
        noise = rng.integers(0, 256, min(256, size), dtype=np.uint8)
        with open(garble, "r+b") as fh:
            fh.write(noise.tobytes())
    return step_dir


class ChaosLineServer:
    """A flaky newline-delimited TCP producer for reconnect tests.

    Serves ``lines`` in order; every ``drop_every`` lines it hard-drops
    the connection (RST via SO_LINGER 0 — an abrupt peer death, not a
    clean shutdown), and a reconnecting client resumes from the next
    line.  When all lines are sent the connection closes CLEANLY — the
    explicit end-of-stream ``socket_text_stream`` documents.  One
    client at a time (the test shape).

    ``drop_delay_s`` sleeps between the last send and the RST — the
    producer dies *between* writes, not mid-flight.  This matters for
    test determinism: an immediate RST races the client's reads and TCP
    discards whatever sits unread in the client's receive buffer (lines
    silently lost, racily).  The delay lets a loopback client drain, so
    drop-and-resume delivers every line exactly once."""

    def __init__(
        self,
        lines: Sequence[str],
        *,
        drop_every: Optional[int] = None,
        drop_delay_s: float = 0.25,
        host: str = "127.0.0.1",
    ):
        self.lines: List[str] = list(lines)
        self.drop_every = drop_every
        self.drop_delay_s = float(drop_delay_s)
        self._cursor = 0
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, 0))
        self._sock.listen(4)
        self.host, self.port = self._sock.getsockname()[:2]
        self.connections_served = 0
        self.drops = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ChaosLineServer":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._serve, name="chaos-line-server", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            # shutdown-first: close() does not wake a blocked accept()
            # on Linux (see utils/net.LineServer.stop)
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "ChaosLineServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # fpsanalyze: allow[S001] ONE serve thread owns these counters — connections are accepted and served sequentially by design (the chaos producer replays a script)
    def _serve(self) -> None:
        while not self._stop.is_set() and self._cursor < len(self.lines):
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return  # listener closed
            self.connections_served += 1
            sent_this_conn = 0
            try:
                while self._cursor < len(self.lines):
                    if (
                        self.drop_every is not None
                        and sent_this_conn >= self.drop_every
                    ):
                        # RST, not FIN: linger-0 close aborts the
                        # connection so the client sees a reset/short
                        # read, not a clean end-of-stream.  Drain-delay
                        # first (see class docstring).
                        if self.drop_delay_s > 0:
                            self._stop.wait(self.drop_delay_s)
                        self.drops += 1
                        conn.setsockopt(
                            socket.SOL_SOCKET,
                            socket.SO_LINGER,
                            # struct linger {onoff=1, linger=0}
                            b"\x01\x00\x00\x00\x00\x00\x00\x00",
                        )
                        break
                    line = self.lines[self._cursor]
                    conn.sendall(line.encode("utf-8") + b"\n")
                    self._cursor += 1
                    sent_this_conn += 1
            except OSError:
                pass
            finally:
                try:
                    conn.close()
                except OSError:
                    pass


__all__ = [
    "ChaosError",
    "Fault",
    "FaultPlan",
    "corrupt_latest_checkpoint",
    "ChaosLineServer",
]
