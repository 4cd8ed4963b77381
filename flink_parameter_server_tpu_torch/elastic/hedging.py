"""Straggler hedging — budgeted backup pulls, first answer wins.

A copy of ``flink_parameter_server_tpu/elastic/hedging.py``, which imports
no JAX.  The adaptive runtime's push hedger (``adaptive/hedge.PushHedger``)
subclasses it and swaps only the counters (``_register_counters``).

The straggler study for iterative-convergent PS training
(arXiv:2308.15482) and the classic tail-at-scale playbook agree on the
cheapest mitigation that needs no replication: when a request has
waited past the tail threshold, issue a BACKUP of the same request and
take whichever answer lands first.  Here the backup goes to the same
shard over a SECOND connection — on this runtime the straggle lives in
the per-connection handler (a shard mid-restart, a wedged handler
thread, a scheduler hiccup serializing one socket), so a fresh
connection with its own handler thread races past it while the slow
one finishes in the background.

Three safety properties, in order of importance:

  * **never double-applied** — only PULLS are hedged (the client never
    hands a push to the hedger); a pull is idempotent, and only the
    first completed answer set is delivered — the loser keeps draining
    on its own connection and its responses are dropped there, counted
    (``elastic_hedged_pulls_total`` issued /
    ``elastic_hedges_won_total`` where the backup won) but never
    delivered twice;
  * **budgeted** — hedges are capped at ``max_fraction`` of total pull
    frames (plus a small burst floor), the standard guard against the
    failure mode where hedging under load DOUBLES the load and makes
    the tail worse;
  * **no connection sharing** — a line-protocol connection is
    single-reader by construction, so a connection whose racer lost is
    never handed back while it may still be draining: when the backup
    wins, the caller's ``on_backup_won(spare)`` takes ownership of the
    (clean) spare and must retire the still-draining primary; when the
    primary wins, the spare is only re-offered for hedging once its
    racer thread has finished.

``Hedger`` is handed to :class:`~..cluster.client.ClusterClient` as
``hedge=`` and duck-types nothing else — the client calls
``request_many(primary_conn, spare_factory, lines, on_backup_won)``.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_NULL_CM = contextlib.nullcontext()


class HedgeBudget:
    """Token guard: allow a hedge while hedges stay under
    ``max_fraction`` of issued requests (+ ``burst`` head start, so the
    very first slow request can hedge before any history exists)."""

    def __init__(self, max_fraction: float = 0.1, burst: int = 4):
        if not 0.0 <= max_fraction <= 1.0:
            raise ValueError(
                f"max_fraction={max_fraction}: must be in [0, 1]"
            )
        self.max_fraction = float(max_fraction)
        self.burst = int(burst)
        self._lock = threading.Lock()
        self.requests = 0
        self.hedges = 0

    def note_requests(self, n: int) -> None:
        with self._lock:
            self.requests += int(n)

    def allow(self, n: int = 1) -> bool:
        with self._lock:
            if (
                self.hedges + n
                <= self.requests * self.max_fraction + self.burst
            ):
                self.hedges += int(n)
                return True
            return False

    def refund(self, n: int) -> None:
        """Return tokens for a hedge that could not actually launch."""
        with self._lock:
            self.hedges = max(0, self.hedges - int(n))


class _Spare:
    """A cached backup connection + the liveness of its racer thread
    (a spare still draining a lost race must not be re-raced)."""

    def __init__(self, conn):
        self.conn = conn
        self.idle = threading.Event()
        self.idle.set()


class Hedger:
    """Race a budgeted backup connection against a slow primary.

    ``after_s`` is the hedge trigger: how long the primary may stay
    silent before the backup fires (pick it near the healthy p99 —
    lower wastes budget on healthy requests, higher leaves tail on the
    table).  One spare connection is cached per shard address and
    reused across hedges."""

    def __init__(
        self,
        after_s: float = 0.05,
        *,
        budget: Optional[HedgeBudget] = None,
        registry=None,
        profiler=None,
    ):
        if after_s <= 0:
            raise ValueError(f"after_s={after_s}: must be > 0")
        self.after_s = float(after_s)
        self.budget = budget if budget is not None else HedgeBudget()
        # latency-budget phases (telemetry/profiler.py): each race leg
        # is observed as phase_seconds{verb="hedge", phase=primary|
        # backup}, so the budget view shows what the straggler cost
        # and what the backup leg bought
        from ..telemetry.profiler import NULL_PROFILER, resolve_profiler

        self._profiler = (
            NULL_PROFILER if registry is False and profiler is None
            else resolve_profiler(profiler)
        )
        self._spares: Dict[Tuple[str, int], _Spare] = {}
        self._lock = threading.Lock()
        self.hedges_issued = 0
        self.hedges_won = 0
        if registry is not False:
            from ..telemetry.registry import get_registry

            reg = registry if registry is not None else get_registry()
            self._register_counters(reg)
        else:
            self._c_issued = self._c_won = None

    def _register_counters(self, reg) -> None:
        """Subclasses (adaptive.hedge.PushHedger) register their own
        literal instrument names here."""
        self._c_issued = reg.counter(
            "elastic_hedged_pulls_total", component="elastic"
        )
        self._c_won = reg.counter(
            "elastic_hedges_won_total", component="elastic"
        )

    # -- spare lifecycle ----------------------------------------------------
    def _acquire_spare(
        self, addr: Tuple[str, int], factory: Callable
    ) -> Optional[_Spare]:
        """An idle spare for ``addr`` (building one if none cached), or
        None when the cached spare is still draining a previous race —
        the hedge is skipped rather than piling up connections."""
        with self._lock:
            spare = self._spares.get(addr)
            if spare is not None:
                if not spare.idle.is_set():
                    return None
                spare.idle.clear()
                return spare
        conn = factory()  # outside the lock: connect() can block
        spare = _Spare(conn)
        spare.idle.clear()
        with self._lock:
            if addr in self._spares:
                other = self._spares[addr]
                if other.idle.is_set():
                    # lost the build race; use the cached one instead
                    conn.close()
                    other.idle.clear()
                    return other
            self._spares[addr] = spare
        return spare

    def _evict_spare(self, addr: Tuple[str, int], spare: _Spare) -> None:
        with self._lock:
            if self._spares.get(addr) is spare:
                del self._spares[addr]

    # -- the race -----------------------------------------------------------
    def request_many(
        self,
        conn,
        spare_factory: Callable,
        lines: Sequence[str],
        on_backup_won: Optional[Callable] = None,
        *,
        trace=None,
    ) -> List[str]:
        """``conn.request_many(lines)``, hedged.  If the primary is
        still silent after ``after_s`` and the budget allows, the same
        frames race on a spare connection; the first completed answer
        set wins.  When the backup wins, ``on_backup_won(spare_conn)``
        hands the clean spare to the caller, which MUST stop using (and
        close) the still-draining primary — a line-protocol connection
        has one reader.

        ``trace`` is an optional ``(tracer, trace_id, parent_id)``
        triple: each racer is then recorded as a ``hedge.primary`` /
        ``hedge.backup`` span under the caller's shard-request span, so
        a merged trace (telemetry/distributed.py) shows the two legs
        racing."""
        self.budget.note_requests(len(lines))
        done = threading.Event()
        state: dict = {}
        lock = threading.Lock()

        def race(tag: str, c) -> None:
            try:
                if trace is not None:
                    tracer, trace_id, parent_id = trace
                    span_cm = tracer.span(
                        f"hedge.{tag}", "elastic",
                        trace_id=trace_id, parent_id=parent_id,
                    )
                else:
                    span_cm = _NULL_CM
                with span_cm, self._profiler.timer("hedge", tag):
                    resps = c.request_many(list(lines))
                with lock:
                    state.setdefault("winner", (tag, resps))
            except BaseException as e:  # noqa: BLE001 — surfaced below
                with lock:
                    state[f"{tag}_error"] = e
            finally:
                done.set()

        threading.Thread(
            target=race, args=("primary", conn), daemon=True
        ).start()
        done.wait(self.after_s)
        addr = (conn.host, conn.port)
        spare: Optional[_Spare] = None
        with lock:
            settled = "winner" in state or "primary_error" in state
        if not settled and self.budget.allow(len(lines)):
            try:
                spare = self._acquire_spare(addr, spare_factory)
            except OSError:
                spare = None
            if spare is None:
                self.budget.refund(len(lines))
            else:
                self.hedges_issued += len(lines)
                if self._c_issued is not None:
                    self._c_issued.inc(len(lines))

                def backup_race() -> None:
                    try:
                        race("backup", spare.conn)
                        with lock:
                            won = (
                                state.get("winner", ("", None))[0]
                                == "backup"
                            )
                            failed = "backup_error" in state
                        if failed:
                            spare.conn.close()
                            self._evict_spare(addr, spare)
                        elif won:
                            # ownership moves to the caller (see
                            # request_many docstring); stop caching it
                            self._evict_spare(addr, spare)
                    finally:
                        spare.idle.set()

                threading.Thread(target=backup_race, daemon=True).start()
        expected_errors = 2 if spare is not None else 1
        while True:
            done.wait()
            with lock:
                if "winner" in state:
                    tag, resps = state["winner"]
                    break
                n_err = sum(
                    1 for k in ("primary_error", "backup_error")
                    if k in state
                )
                if n_err >= expected_errors:
                    raise state.get(
                        "primary_error", state.get("backup_error")
                    )
                done.clear()
        if tag == "backup":
            self.hedges_won += len(lines)
            if self._c_won is not None:
                self._c_won.inc(len(lines))
            if on_backup_won is not None:
                on_backup_won(spare.conn)
            else:  # caller keeps the primary: the spare must die with
                # its race already won and delivered
                spare.conn.close()
                self._evict_spare(addr, spare)
        return resps

    def close(self) -> None:
        with self._lock:
            spares = list(self._spares.values())
            self._spares.clear()
        for s in spares:
            try:
                s.conn.close()
            except OSError:
                pass


__all__ = ["HedgeBudget", "Hedger"]
