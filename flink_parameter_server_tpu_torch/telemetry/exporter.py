"""Live metrics surface: Prometheus-text exposition + a tiny TCP
endpoint.

A copy of ``flink_parameter_server_tpu/telemetry/exporter.py`` (host
code; the only device step behind it is the hot-key aggregator's top-K,
on the aggregator's own device).  ``/adaptive`` serves the installed
adaptive runtime's payload (``adaptive/``) and ``/tiers`` the registered
tiered stores' stats (``tierstore/``); each answers ``null`` when none is
installed, as the reference's does.

Symmetric to ``serving/server.py``: the serve path answers queries over
a newline-delimited TCP socket, the telemetry path answers scrapes over
one.  The server speaks enough HTTP/1.0 for ``curl`` and a Prometheus
scrape job (``GET /metrics``, ``GET /healthz``), and also answers the
bare line protocol (``metrics\\n`` / ``healthz\\n``) so a test or a
shell one-liner (``nc``) needs no HTTP client.  One thread per
connection, one response per request, connection closed after — a
scrape surface, not a serving plane.

Elastic-aggregation work (arXiv:2204.03211, PAPERS.md) assumes exactly
this: a queryable live parameter-service metrics surface that external
controllers poll to make scaling decisions.
"""
from __future__ import annotations

import json
import math
import socket
from typing import List, Optional

from ..utils.net import LineServer
from .registry import Histogram, MetricsRegistry, get_registry

# metric names go out namespaced; label values get minimal escaping
_PREFIX = "fps_"


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace(
        "\n", r"\n"
    )


def _fmt_labels(labels: dict, extra: Optional[dict] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    body = ",".join(
        f'{k}="{_escape(v)}"' for k, v in sorted(merged.items())
    )
    return "{" + body + "}"


def _fmt_value(v) -> str:
    if v is None:
        return "NaN"  # Prometheus-legal marker for an unreadable gauge
    f = float(v)
    if not math.isfinite(f):
        # the exposition format's spellings; the reference's int(f)
        # below raises on these and fails the whole scrape
        return "NaN" if math.isnan(f) else ("+Inf" if f > 0 else "-Inf")
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def prometheus_text(
    registry: Optional[MetricsRegistry] = None,
    *,
    collectors=None,
    include_hot_keys: bool = True,
) -> str:
    """Render the registry in Prometheus exposition format (0.0.4).

    Counters get the conventional ``_total`` suffix (unless already
    named that way); histograms expand to cumulative ``_bucket{le=}``
    series plus ``_sum``/``_count``.  The merged hot-key sketch
    (telemetry/hotkeys.py) is appended as ``fps_hot_key_traffic``
    gauge lines whenever any sketch is registered; ``collectors`` are
    extra zero-arg callables returning exposition lines."""
    reg = registry if registry is not None else get_registry()
    by_name: dict = {}
    for inst in reg.instruments():
        by_name.setdefault(inst.name, []).append(inst)
    lines: List[str] = []
    for name in sorted(by_name):
        insts = by_name[name]
        kind = insts[0].kind
        out_name = _PREFIX + name
        if kind == "counter" and not out_name.endswith("_total"):
            out_name += "_total"
        lines.append(f"# TYPE {out_name} {kind}")
        for inst in insts:
            if isinstance(inst, Histogram):
                counts = inst.bucket_counts()
                cum = 0
                for bound, c in zip(inst.bounds, counts):
                    cum += c
                    lines.append(
                        f"{out_name}_bucket"
                        f"{_fmt_labels(inst.labels, {'le': repr(float(bound))})}"
                        f" {cum}"
                    )
                cum += counts[-1]
                lines.append(
                    f"{out_name}_bucket"
                    f"{_fmt_labels(inst.labels, {'le': '+Inf'})} {cum}"
                )
                lines.append(
                    f"{out_name}_sum{_fmt_labels(inst.labels)} "
                    f"{_fmt_value(inst.sum)}"
                )
                lines.append(
                    f"{out_name}_count{_fmt_labels(inst.labels)} "
                    f"{inst.count}"
                )
            else:
                lines.append(
                    f"{out_name}{_fmt_labels(inst.labels)} "
                    f"{_fmt_value(inst.value)}"
                )
    if include_hot_keys:
        from .hotkeys import get_aggregator

        agg = get_aggregator()
        if agg.labels():
            lines.extend(agg.exposition(prefix=_PREFIX))
    for coll in collectors or ():
        try:
            lines.extend(coll())
        except Exception:  # a broken collector must not kill a scrape
            pass
    return "\n".join(lines) + "\n"


class TelemetryServer(LineServer):
    """``GET /metrics`` (Prometheus text) + ``GET /healthz`` (JSON) over
    TCP, serving LIVE registry values while training runs.

    ``port=0`` binds an ephemeral port (read it back from ``.port``).
    ``health`` is an optional ``resilience.HealthMonitor``: with one
    attached, ``/healthz`` reports per-component heartbeat ages and
    degrades ``status`` to ``"stalled"`` past ``stall_after_s`` — the
    watchdog's view, scrapeable before the watchdog fires.

    Socket plumbing comes from :class:`~..utils.net.LineServer`; the
    scrape endpoint overrides :meth:`handle_connection` whole because
    its protocol is one-shot (one answer, HTTP or bare, then close),
    not line-per-request.
    """

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        health=None,
        stall_after_s: Optional[float] = None,
        max_request_bytes: int = 8192,
        collectors=None,
        profiler=None,
    ):
        super().__init__(host, port, name="telemetry")
        self.registry = registry if registry is not None else get_registry()
        self.health = health
        self.stall_after_s = stall_after_s
        self.max_request_bytes = int(max_request_bytes)
        self.collectors = list(collectors) if collectors else []
        # the profiler whose latency budget the `budget` path serves
        # (None = the process default, resolved per request so a late
        # set_profiler() is picked up)
        self.profiler = profiler

    def start(self) -> "TelemetryServer":
        super().start()
        return self

    # -- request handling --------------------------------------------------
    def handle_connection(self, conn: socket.socket) -> None:
        conn.settimeout(5.0)
        buf = b""
        # one request line is enough; drain headers best-effort so
        # an HTTP client's request doesn't RST on early close
        while b"\n" not in buf and len(buf) < self.max_request_bytes:
            chunk = conn.recv(4096)
            if not chunk:
                return
            buf += chunk
        first = buf.split(b"\n", 1)[0].decode(
            "utf-8", "replace"
        ).strip()
        http = first.upper().startswith(("GET ", "HEAD "))
        head_only = first.upper().startswith("HEAD ")
        path = first.split()[1] if http and len(
            first.split()
        ) >= 2 else first
        path = path.strip().lstrip("/").lower() or "metrics"
        if path.startswith("metrics"):
            body = prometheus_text(
                self.registry, collectors=self.collectors
            )
            # the Prometheus text exposition content type, verbatim —
            # scrapers key the parser off version=0.0.4
            ctype = "text/plain; version=0.0.4; charset=utf-8"
            status = "200 OK"
        elif path.startswith("healthz"):
            body = json.dumps(self._healthz()) + "\n"
            ctype = "application/json"
            status = "200 OK"
        elif path.startswith("hotkeys"):
            from .hotkeys import get_aggregator

            body = json.dumps(
                {"hot_keys": get_aggregator().snapshot()}
            ) + "\n"
            ctype = "application/json"
            status = "200 OK"
        elif path.startswith("hot"):
            # the live hot-key TABLE (psctl hot): sketch top-K joined
            # with the client-edge lease-cache state — which hot keys
            # are currently leased somewhere, how old, how often hit
            body = json.dumps({"hot": self._hot_table()}) + "\n"
            ctype = "application/json"
            status = "200 OK"
        elif path.startswith("budget"):
            # the latency-budget profiler's per-verb phase breakdown
            # (telemetry/profiler.py) — the `psctl budget` answer
            from .profiler import get_profiler

            prof = (
                self.profiler if self.profiler is not None
                else get_profiler()
            )
            body = json.dumps(
                {"budgets": prof.budget_report(),
                 "run_id": self.registry.run_id}
            ) + "\n"
            ctype = "application/json"
            status = "200 OK"
        elif path.startswith("conns"):
            # this endpoint's own live connection ledger (the shard
            # servers answer their own over the `conns` wire verb)
            body = json.dumps({"conns": self.conn_table()}) + "\n"
            ctype = "application/json"
            status = "200 OK"
        elif path.startswith("timeline"):
            # the timeline recorder's series window (telemetry/
            # timeline.py): rates/values/windowed-percentiles per
            # instrument plus marks, anomalies and skew verdicts —
            # `psctl watch`/`psctl timeline` read this.  No recorder
            # installed answers null (the opt-in contract; same shape
            # as the flight recorder's)
            from .timeline import get_timeline

            tl = get_timeline()
            body = json.dumps(
                {"timeline": (
                    tl.payload() if tl is not None else None
                ),
                 "run_id": self.registry.run_id}
            ) + "\n"
            ctype = "application/json"
            status = "200 OK"
        elif path.startswith("adaptive"):
            # the adaptive runtime's live decision surface (adaptive/
            # controller.py): per-worker effective bounds + skew
            # ratios, hedged-push wins, rebalance moves, the decision
            # ring — `psctl adaptive` renders this.  No runtime
            # installed answers null (opt-in, like `timeline`)
            from ..adaptive.controller import get_adaptive_runtime

            rt = get_adaptive_runtime()
            body = json.dumps(
                {"adaptive": (
                    rt.payload() if rt is not None else None
                ),
                 "run_id": self.registry.run_id}
            ) + "\n"
            ctype = "application/json"
            status = "200 OK"
        elif path.startswith("tiers"):
            # the two-tier store's per-shard snapshot (tierstore/
            # metrics.py): resident/cold/pinned row counts, slab
            # bytes, hit/miss/promote/demote/spill counters per
            # registered tiered store — `psctl tiers` renders this.
            # No tiered shard registered answers null (the cluster is
            # not running store_backend="tiered")
            from ..tierstore.metrics import tiers_snapshot

            body = json.dumps(
                {"tiers": tiers_snapshot(),
                 "run_id": self.registry.run_id}
            ) + "\n"
            ctype = "application/json"
            status = "200 OK"
        elif path.startswith("workloads"):
            # the live per-workload rate table (workloads/runtime.py):
            # cumulative update/prediction/query counters + query
            # latency percentiles per registered workload — `psctl
            # workloads` diffs two scrapes into rates
            from ..workloads.runtime import workload_table

            body = json.dumps(
                {"workloads": workload_table(self.registry),
                 "run_id": self.registry.run_id}
            ) + "\n"
            ctype = "application/json"
            status = "200 OK"
        else:
            body = (
                f"unknown path {path!r} "
                f"(metrics|healthz|hotkeys|hot|budget|conns|"
                f"timeline|adaptive|tiers|workloads)\n"
            )
            ctype = "text/plain; charset=utf-8"
            status = "404 Not Found"
        payload = body.encode("utf-8")
        # wire accounting (utils/net.py): one frame each way per
        # scrape, attributed to the path as the verb
        verb = path.split("?", 1)[0][:16] or "metrics"
        if not verb.replace("_", "").isalnum():
            verb = "other"
        stats = self._stats_for(conn)
        stats.last_verb = verb
        stats.bytes_in += len(buf)
        stats.frames_in += 1
        self.meter.count("in", verb, len(buf))
        if http:
            head = (
                f"HTTP/1.0 {status}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(payload)}\r\n"
                f"Connection: close\r\n\r\n"
            ).encode("ascii")
            # HEAD answers headers (with the GET body's exact
            # Content-Length) and no body — RFC 9110 §9.3.2
            sent = head if head_only else head + payload
            conn.sendall(sent)
        else:
            sent = payload
            conn.sendall(sent)
        stats.bytes_out += len(sent)
        stats.frames_out += 1
        self.meter.count("out", verb, len(sent))

    def _hot_table(self, n: int = 16) -> dict:
        """The ``hot`` path's payload: the merged sketch top-K
        (telemetry/hotkeys.py) joined per key with the registered
        client-edge caches' lease state (hotcache/cache.py) — the one
        view that answers "who is hot, and is the tier absorbing
        them?" live."""
        from ..hotcache.cache import cache_snapshots
        from .hotkeys import get_aggregator

        agg = get_aggregator()
        snaps = cache_snapshots()
        # key -> the freshest lease entry across every cache
        by_key: dict = {}
        for label, snap in snaps.items():
            for entry in snap.get("keys", ()):
                cur = by_key.get(entry["key"])
                if cur is None or entry["age"] < cur["age"]:
                    by_key[entry["key"]] = {
                        "age": entry["age"],
                        "hits": entry["hits"],
                        "cache": label,
                    }
        top = []
        for rank, item in enumerate(agg.top_k(n)):
            row = {
                "rank": rank,
                "key": item["key"],
                "count": item["count"],
                "err": item["err"],
                "leased": item["key"] in by_key,
            }
            row.update(by_key.get(item["key"], {}))
            top.append(row)
        return {
            "top": top,
            "total_observed": agg.total(),
            "error_bound": agg.error_bound(),
            "caches": {
                label: {
                    k: snap[k]
                    for k in ("hits", "misses", "hit_rate", "entries",
                              "revocations", "stale_rejects", "bound")
                }
                for label, snap in snaps.items()
            },
        }

    def _healthz(self) -> dict:
        out = {"status": "ok", "run_id": self.registry.run_id}
        if self.health is not None:
            ages = self.health.ages()
            out["heartbeat_age_s"] = {
                c: round(a, 3) for c, a in sorted(ages.items())
            }
            if self.stall_after_s is not None:
                stalled = self.health.stalled(self.stall_after_s)
                if stalled:
                    out["status"] = "stalled"
                    out["stalled"] = stalled
        return out


def scrape(host: str, port: int, path: str = "metrics",
           timeout: float = 5.0) -> str:
    """One-shot line-protocol scrape (test/shell helper): send the bare
    path, read to EOF, return the body."""
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.sendall(path.strip().encode("utf-8") + b"\n")
        chunks = []
        while True:
            c = s.recv(1 << 16)
            if not c:
                break
            chunks.append(c)
    return b"".join(chunks).decode("utf-8", "replace")


__all__ = ["prometheus_text", "TelemetryServer", "scrape"]
