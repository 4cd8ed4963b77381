"""Latency-budget profiler — where do the milliseconds of a round go?

A copy of ``flink_parameter_server_tpu/telemetry/profiler.py``, which imports
no JAX: the port imports nothing of the JAX package, whose ``__init__``
imports JAX.  Modules it names that the port does not have yet are the
reference's.

The plane built so far answers *that* a pull took 5 ms (histograms,
spans, SLO burn rates) but not *where*: ROADMAP item 2 (multiprocess
shards + binary framing) is justified by the claim that text/b64 parse
cost and handler serialization dominate the wire path, and until this
module that claim was hypothesis.  The straggler study
(arXiv:2308.15482) diagnoses PS tail latency from exactly this kind of
hidden per-phase imbalance, and MXNET-MPI (arXiv:1801.03855) motivates
its aggregation redesign with per-stage cost breakdowns — so every
cluster round is decomposed here into named phases:

    client_serialize → wire → server_queue_wait → server_parse →
    wal_append → scatter_apply → response_serialize → client_parse

Two measurement styles, one seam:

  * :class:`PhaseProfiler` — fine-grained sub-span accounting.  Call
    sites (``cluster/client.py``, ``cluster/shard.py``,
    ``elastic/hedging.py``, ``serving/server.py``) wrap each phase in
    ``profiler.timer(verb, phase)``; observations land in a registry
    histogram family ``phase_seconds{component="profiler", verb=,
    phase=}`` (live on ``/metrics``) AND in a bounded exact-sample
    reservoir per (verb, phase) — bucket-interpolated percentiles are
    fine for dashboards but too coarse for budget arithmetic, where a
    2.5× bucket straddle would swamp the 10% additivity bound the
    tests pin.  :meth:`PhaseProfiler.budget` assembles the
    per-round budget: measured phases by exact p50, ``wire`` as the
    client-RTT minus server-busy residual, ``server_other`` as the
    server-busy minus attributed-phase residual — so the phases sum to
    the round by construction *of honest residuals*, and the test
    oracle (span-trace p50 of the whole round) checks the measured
    parts actually cover it.
  * :class:`StackSampler` — a low-overhead sampling stack profiler
    (``sys._current_frames()`` on a timer thread): when a phase is
    fat, the folded-stack export says which FUNCTION inside it burns
    the time.  Export formats: collapsed stacks (flamegraph.pl /
    speedscope) and a retroactive :class:`~.spans.SpanTracer` ring
    (:meth:`StackSampler.to_tracer`) so samples ride the existing
    :class:`~.distributed.TraceCollector` lanes next to the span
    timeline.

Both are attribution, not load: a disabled profiler's ``timer()`` is a
shared no-op (two attribute reads), and the sampler costs one frame
walk per interval (default 100 ms — see :class:`StackSampler` for the
measured tax curve on a single-core host) — the overhead A/B
(``benchmarks/telemetry_overhead.py``) runs with both ON and the bar
stays ≤ 3%.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .registry import MetricsRegistry, get_registry, json_line

# Canonical phase order of one cluster round (docs/observability.md).
# ``wire`` and ``server_other`` are residuals derived at budget time;
# everything else is measured at its call site.  The BINARY transport
# (utils/frames.py) reuses these names — frame encode IS
# client_serialize, frame decode IS server_parse — which is what keeps
# the line-vs-binary A/B (results/cpu/transport_ab.md) directly
# comparable.  The vocabulary is pinned in lockstep with
# ``tools/check_metric_lines.KNOWN_BUDGET_PHASES`` (a tier-1 test
# compares the two), so a renamed/added phase must update the lint,
# the docs, and this tuple together.
PHASES: Tuple[str, ...] = (
    "client_serialize",
    "wire",
    "server_queue_wait",
    "server_parse",
    "wal_append",
    "scatter_apply",
    "response_serialize",
    "server_other",
    "client_parse",
)

# Phases measured server-side whose sum is compared against the
# server's whole-request wall (``server_total``) for the
# ``server_other`` residual.
_SERVER_PHASES: Tuple[str, ...] = (
    "server_queue_wait",
    "server_parse",
    "wal_append",
    "scatter_apply",
    "response_serialize",
)

# Phase durations are µs-to-ms scale; the default latency buckets
# (0.5 ms floor) would collapse most phases into one bin.
PROFILE_BUCKETS: Tuple[float, ...] = (
    1e-6, 2.5e-6, 5e-6, 1e-5, 2.5e-5, 5e-5,
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
    0.01, 0.025, 0.05, 0.1, 0.25, 1.0,
)


class _NullTimer:
    """Shared do-nothing context manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_TIMER = _NullTimer()


class _NullProfiler:
    """The disabled profiler: every call is a no-op, shared
    process-wide so call sites can keep unconditional `.timer(...)`."""

    __slots__ = ()
    enabled = False

    def timer(self, verb: str, phase: str):
        return _NULL_TIMER

    def observe(self, verb: str, phase: str, seconds: float) -> None:
        pass


NULL_PROFILER = _NullProfiler()


class _PhaseTimer:
    __slots__ = ("prof", "verb", "phase", "t0")

    def __init__(self, prof: "PhaseProfiler", verb: str, phase: str):
        self.prof = prof
        self.verb = verb
        self.phase = phase

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.prof.observe(
            self.verb, self.phase, time.perf_counter() - self.t0
        )
        return False


class PhaseProfiler:
    """Per-phase cost accounting over (verb, phase) keys.

    Observations land twice: a registry histogram
    ``phase_seconds{verb=,phase=}`` (the ``/metrics`` surface, bucketed)
    and an exact bounded reservoir (the budget arithmetic surface —
    exact medians, no bucket interpolation error).  The histogram's
    ``sum``/``count`` are exact too, so means come from there.
    """

    enabled = True

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        *,
        reservoir: int = 4096,
    ):
        self.registry = registry if registry is not None else get_registry()
        self.reservoir = int(reservoir)
        self._lock = threading.Lock()
        # (verb, phase) -> (histogram, deque-of-recent-values)
        self._sites: Dict[Tuple[str, str], Tuple[Any, deque]] = {}

    # -- recording ---------------------------------------------------------
    def _site(self, verb: str, phase: str) -> Tuple[Any, deque]:
        key = (verb, phase)
        site = self._sites.get(key)  # dict reads are GIL-atomic
        if site is None:
            with self._lock:
                site = self._sites.get(key)
                if site is None:
                    h = self.registry.histogram(
                        "phase_seconds", component="profiler",
                        buckets=PROFILE_BUCKETS, verb=verb, phase=phase,
                    )
                    site = (h, deque(maxlen=self.reservoir))
                    self._sites[key] = site
        return site

    def observe(self, verb: str, phase: str, seconds: float) -> None:
        h, ring = self._site(verb, phase)
        h.observe(seconds)
        ring.append(float(seconds))

    def timer(self, verb: str, phase: str):
        """``with profiler.timer("pull", "client_serialize"): ...``"""
        return _PhaseTimer(self, verb, phase)

    # -- reads -------------------------------------------------------------
    def stat(self, verb: str, phase: str) -> Dict[str, float]:
        """Exact ``{count, mean, p50, total}`` seconds for one site
        (zeros when never observed)."""
        site = self._sites.get((verb, phase))
        if site is None:
            return {"count": 0, "mean": 0.0, "p50": 0.0, "total": 0.0}
        h, ring = site
        count = h.count
        if count == 0:
            return {"count": 0, "mean": 0.0, "p50": 0.0, "total": 0.0}
        vals = sorted(ring)
        mid = len(vals) // 2
        p50 = (
            vals[mid] if len(vals) % 2
            else 0.5 * (vals[mid - 1] + vals[mid])
        )
        return {
            "count": count,
            "mean": h.sum / count,
            "p50": p50,
            "total": h.sum,
        }

    def verbs(self) -> List[str]:
        with self._lock:
            return sorted({v for (v, _p) in self._sites})

    def budget(self, verb: str = "pull") -> Dict[str, Any]:
        """The latency budget of one round of ``verb`` traffic.

        Measured phases use their exact reservoir p50; two residuals
        close the books: ``wire`` = p50(rtt) − p50(server_total)
        (client-observed round trip minus server busy time — transport
        + kernel + framing cost) and ``server_other`` =
        p50(server_total) − Σ attributed server phases (dispatch
        overhead the sub-spans don't cover).  Phases therefore sum to
        ``round_ms`` = p50(client_serialize) + p50(rtt) +
        p50(client_parse) by construction; what the span-trace oracle
        test checks is that this round matches the independently
        traced whole-round p50 — i.e. that the instrumented sites
        actually cover the round.  Without server-side data in this
        registry (a future cross-process topology), ``wire`` honestly
        absorbs the whole RTT and ``coverage`` says "client-only".
        """
        rtt = self.stat(verb, "rtt")
        srv = self.stat(verb, "server_total")
        c_ser = self.stat(verb, "client_serialize")
        c_par = self.stat(verb, "client_parse")
        coverage = "full" if srv["count"] else (
            "client-only" if rtt["count"] else "none"
        )
        measured_srv = {p: self.stat(verb, p) for p in _SERVER_PHASES}
        wire_p50 = max(0.0, rtt["p50"] - srv["p50"])
        srv_attr = sum(s["p50"] for s in measured_srv.values())
        other_p50 = max(0.0, srv["p50"] - srv_attr)
        round_s = c_ser["p50"] + rtt["p50"] + c_par["p50"]
        phases: List[Dict[str, Any]] = []

        def add(phase: str, p50: float, count: int, mean: float) -> None:
            phases.append({
                "phase": phase,
                "p50_ms": round(p50 * 1e3, 4),
                "mean_ms": round(mean * 1e3, 4),
                "count": int(count),
                "pct": round(100.0 * p50 / round_s, 1) if round_s else 0.0,
            })

        add("client_serialize", c_ser["p50"], c_ser["count"], c_ser["mean"])
        add("wire", wire_p50, rtt["count"],
            max(0.0, rtt["mean"] - srv["mean"]))
        for p in _SERVER_PHASES:
            s = measured_srv[p]
            add(p, s["p50"], s["count"], s["mean"])
        add("server_other", other_p50, srv["count"],
            max(0.0, srv["mean"] - sum(
                s["mean"] for s in measured_srv.values()
            )))
        add("client_parse", c_par["p50"], c_par["count"], c_par["mean"])
        top = max(phases, key=lambda p: p["pct"]) if round_s else None
        return {
            "verb": verb,
            "round_ms": round(round_s * 1e3, 4),
            "rounds": int(rtt["count"]),
            "coverage": coverage,
            "phases": phases,
            "top_phase": None if top is None else top["phase"],
            "top_pct": None if top is None else top["pct"],
        }

    def budget_report(self) -> Dict[str, Any]:
        """Budgets for every verb with data — the run-report /
        ``psctl budget`` payload."""
        return {
            v: self.budget(v)
            for v in self.verbs()
            if self.stat(v, "rtt")["count"]
            or self.stat(v, "server_total")["count"]
        }

    def write_budget_artifact(self, path: Optional[str] = None) -> str:
        """One JSON artifact (ts/run_id-stamped like every emitter;
        ``tools/check_metric_lines.py --budget`` lints it)."""
        line = json_line(
            {"kind": "latency_budget", "budgets": self.budget_report()},
            run_id=self.registry.run_id,
        )
        if path is not None:
            with open(path, "w") as f:
                f.write(line + "\n")
        return line


# -- sampling stack profiler --------------------------------------------------


# Per-code-object formatted frame names.  A sample tick runs WITH the
# GIL held, so the fold must be near-free: the same code objects recur
# every tick, and formatting (basename + f-string) dominates without
# this cache.  Keyed by the code object itself (not id() — id reuse
# after GC would alias frames); bounded by the program's distinct code
# objects.
_CODE_NAMES: Dict[Any, str] = {}


def _fold_stack(frame, max_depth: int) -> str:
    """``root;...;leaf`` collapsed-stack key for one thread's current
    frame (flamegraph.pl grammar: semicolon-joined, root first)."""
    parts: List[str] = []
    depth = 0
    while frame is not None and depth < max_depth:
        code = frame.f_code
        name = _CODE_NAMES.get(code)
        if name is None:
            name = (
                f"{os.path.basename(code.co_filename)}:{code.co_name}"
            )
            _CODE_NAMES[code] = name
        parts.append(name)
        frame = frame.f_back
        depth += 1
    parts.reverse()
    return ";".join(parts)


class StackSampler:
    """Low-overhead sampling profiler over every live thread.

    A daemon thread wakes every ``interval_s``, snapshots
    ``sys._current_frames()`` (one C-level dict copy — no tracing hooks,
    no per-call cost on the profiled code), and accumulates folded
    stacks.  The default 100 ms interval is chosen by measurement, not
    taste: in-process sampling shares the GIL (and, on a single-core
    box, the core) with the profiled code, so every wakeup steals real
    time — measured on the 1-core CI container, 5 ms sampling cost
    ~6% of driver throughput, 50 ms ~2.6%; 100 ms keeps the whole
    telemetry plane inside its ≤ 3% bar while still collecting 10
    samples/sec (thousands over any window worth flame-graphing — a
    parameter server is a long-running process).  Drop ``interval_s``
    for short windows on multi-core hosts, where the sampling thread
    runs on a spare core and the tax is near zero.  Exports:

      * :meth:`export_folded` — collapsed-stack text
        (``a;b;c <count>`` per line; flamegraph.pl / speedscope load
        it directly);
      * :meth:`to_tracer` — a retroactive :class:`~.spans.SpanTracer`
        ring (one ``interval_s``-wide span per sampled leaf, lane
        ``process="stack-sampler"``) so the samples merge into a
        :class:`~.distributed.TraceCollector` timeline next to the
        phase spans.

    The sampler's own thread is excluded.  The folded table is bounded
    (``max_stacks`` distinct stacks; overflow folds into ``<other>``)
    so a week-long job cannot OOM the host.
    """

    def __init__(
        self,
        interval_s: float = 0.1,
        *,
        max_depth: int = 32,
        max_stacks: int = 10_000,
        keep_samples: int = 65536,
        process: str = "stack-sampler",
    ):
        if interval_s <= 0:
            raise ValueError(f"interval_s={interval_s}: must be > 0")
        self.interval_s = float(interval_s)
        self.max_depth = int(max_depth)
        self.max_stacks = int(max_stacks)
        self.process = process
        self.samples = 0  # sampling ticks taken
        self._folded: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # (perf_counter_ts, thread_name, leaf_frame) for to_tracer()
        self._recent: deque = deque(maxlen=int(keep_samples))

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "StackSampler":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="stack-sampler", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def __enter__(self) -> "StackSampler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- sampling ----------------------------------------------------------
    def _loop(self) -> None:
        own = threading.get_ident()
        names: Dict[int, str] = {}
        refresh = 0
        while not self._stop.wait(self.interval_s):
            now = time.perf_counter()
            frames = sys._current_frames()
            if refresh == 0 or any(i not in names for i in frames):
                names = {t.ident: t.name for t in threading.enumerate()}
            refresh = (refresh + 1) % 50
            with self._lock:
                self.samples += 1
                for ident, frame in frames.items():
                    if ident == own:
                        continue
                    name = names.get(ident, f"thread-{ident}")
                    key = name + ";" + _fold_stack(frame, self.max_depth)
                    if (
                        key not in self._folded
                        and len(self._folded) >= self.max_stacks
                    ):
                        key = "<other>"
                    self._folded[key] = self._folded.get(key, 0) + 1
                    leaf = key.rsplit(";", 1)[-1]
                    self._recent.append((now, name, leaf))

    # -- exports -----------------------------------------------------------
    def folded(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._folded)

    def export_folded(self, path: Optional[str] = None) -> str:
        """Collapsed-stack text, heaviest stacks first."""
        items = sorted(
            self.folded().items(), key=lambda kv: (-kv[1], kv[0])
        )
        text = "".join(f"{stack} {n}\n" for stack, n in items)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    def top(self, n: int = 10) -> List[Tuple[str, int]]:
        """Heaviest LEAF frames (self time, in samples) — the quick
        `psctl`-style answer to "what is the process doing"."""
        leaves: Dict[str, int] = {}
        for stack, count in self.folded().items():
            leaf = stack.rsplit(";", 1)[-1]
            leaves[leaf] = leaves.get(leaf, 0) + count
        return sorted(leaves.items(), key=lambda kv: (-kv[1], kv[0]))[:n]

    def to_tracer(self, capacity: Optional[int] = None):
        """Replay the retained samples into a fresh
        :class:`~.spans.SpanTracer` ring (component ``stack``, one
        ``interval_s``-wide retroactive span per sampled leaf) —
        feed it to ``TraceCollector.add()`` to see the sampled flame
        next to the span lanes."""
        from .spans import SpanTracer

        with self._lock:
            recent = list(self._recent)
        ring = SpanTracer(
            capacity=capacity if capacity is not None else max(
                1, len(recent)
            ),
            process=self.process,
        )
        for ts, name, leaf in recent:
            ring.record(
                f"{name}: {leaf}", ts, ts + self.interval_s,
                component="stack",
            )
        return ring


# -- the process-wide default -------------------------------------------------
_DEFAULT_LOCK = threading.Lock()
_DEFAULT: Optional[PhaseProfiler] = None
_DEFAULT_AUTO = False  # True when get_profiler() created it lazily


def get_profiler() -> PhaseProfiler:
    """The process-wide default profiler (created on first use, over
    the default registry) — what the cluster/serving call sites resolve
    when not handed one explicitly.  An auto-created default follows
    registry swaps (``set_registry``): a test that isolates the
    registry gets a fresh profiler too, instead of one pinned to the
    previous test's instruments."""
    global _DEFAULT, _DEFAULT_AUTO
    with _DEFAULT_LOCK:
        if _DEFAULT is None or (
            _DEFAULT_AUTO and _DEFAULT.registry is not get_registry()
        ):
            _DEFAULT = PhaseProfiler()
            _DEFAULT_AUTO = True
        return _DEFAULT


def set_profiler(profiler: Optional[PhaseProfiler]) -> None:
    """Swap the process default (tests isolate themselves with this;
    None resets to lazy re-creation)."""
    global _DEFAULT, _DEFAULT_AUTO
    with _DEFAULT_LOCK:
        _DEFAULT = profiler
        _DEFAULT_AUTO = False


def resolve_profiler(profiler=None):
    """The call-site convention mirrors ``registry=``: None → process
    default, False → the shared no-op, an instance → itself."""
    if profiler is False:
        return NULL_PROFILER
    if profiler is None:
        return get_profiler()
    return profiler


__all__ = [
    "PHASES",
    "PROFILE_BUCKETS",
    "NULL_PROFILER",
    "PhaseProfiler",
    "StackSampler",
    "get_profiler",
    "set_profiler",
    "resolve_profiler",
]
