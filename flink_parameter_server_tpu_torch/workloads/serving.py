"""Per-workload serving front end — the workload's query verbs over TCP.

A copy of ``flink_parameter_server_tpu/workloads/serving.py``, which
imports no JAX (the port's ``utils/net.LineServer`` serves it).  Modules
it names that the port does not have yet are the reference's.

Symmetric to ``serving/server.py`` (the MF snapshot plane): one
request line in, one response line out, same ``ok``/``err`` grammar —
but the data plane is the live CLUSTER table read through a
:class:`~..cluster.client.ClusterClient` (membership-routed, so reads
survive resizes).  The verb set is the workload's
(``Workload.serving_verbs``), dispatched in :meth:`_admit`:

    predict <id:val,...[;example...]>   # PA margins, one per example
    query <k1,k2,...>                   # sketch point estimates
    topk <k>                            # sketch heavy hitters
    info                                # workload descriptor (JSON)

Every served verb lands on the ``workloads`` metric component —
``workload_predictions_total`` / ``workload_queries_total`` /
``workload_topk_total`` counters and the
``workload_query_latency_seconds`` histogram, all labelled
``workload=<name>`` — which is what the TelemetryServer ``workloads``
path and ``psctl workloads`` aggregate into live per-workload rates.
"""
from __future__ import annotations

import json
import time
from typing import List, Optional

from ..utils.net import LineServer, request_lines
from .base import Workload


class WorkloadServingServer(LineServer):
    """Line-protocol TCP front end answering one workload's verbs
    through a cluster client.  ``port=0`` binds an ephemeral port."""

    def __init__(
        self,
        workload: Workload,
        client,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        registry=None,
        max_line_bytes: int = 1 << 20,
    ):
        super().__init__(
            host, port, name="workload-serving",
            max_line_bytes=max_line_bytes,
        )
        self.workload = workload
        self.client = client
        if registry is None:
            from ..telemetry.registry import get_registry

            registry = get_registry()
        self._registry = registry if registry is not False else None
        if self._registry is not None:
            labels = {"workload": workload.name}
            self._c_pred = self._registry.counter(
                "workload_predictions_total", component="workloads",
                **labels,
            )
            self._c_query = self._registry.counter(
                "workload_queries_total", component="workloads",
                **labels,
            )
            self._c_topk = self._registry.counter(
                "workload_topk_total", component="workloads", **labels,
            )
            self._c_err = self._registry.counter(
                "workload_serving_errors_total", component="workloads",
                **labels,
            )
            self._h_lat = self._registry.histogram(
                "workload_query_latency_seconds", component="workloads",
                **labels,
            )
        else:
            self._c_pred = self._c_query = self._c_topk = None
            self._c_err = self._h_lat = None

    # -- the protocol --------------------------------------------------------
    def respond(self, line: str) -> str:
        t0 = time.perf_counter()
        parts = line.strip().split(None, 1)
        cmd = parts[0].lower() if parts else ""
        arg = parts[1] if len(parts) > 1 else ""
        try:
            payload = self._admit(cmd, arg)
        except ValueError as e:
            if self._c_err is not None:
                self._c_err.inc()
            return f"err bad-request: {e}"
        except Exception as e:  # noqa: BLE001 — typed wire answer
            if self._c_err is not None:
                self._c_err.inc()
            return f"err internal: {type(e).__name__}: {e}"
        if self._h_lat is not None:
            self._h_lat.observe(time.perf_counter() - t0)
        return f"ok {payload}" if payload else "ok"

    def _admit(self, cmd: str, arg: str) -> str:
        wl = self.workload
        if cmd == "info":
            return json.dumps(wl.describe(), sort_keys=True)
        if cmd == "predict":
            if "predict" not in wl.serving_verbs:
                raise ValueError(
                    f"workload {wl.name!r} serves no 'predict'"
                )
            out = wl.serve(self.client, "predict", arg)
            if self._c_pred is not None:
                self._c_pred.inc(max(1, out.count(",") + 1))
            return out
        if cmd == "query":
            if "query" not in wl.serving_verbs:
                raise ValueError(
                    f"workload {wl.name!r} serves no 'query'"
                )
            out = wl.serve(self.client, "query", arg)
            if self._c_query is not None:
                self._c_query.inc(max(1, out.count(",") + 1))
            return out
        if cmd == "topk":
            if "topk" not in wl.serving_verbs:
                raise ValueError(
                    f"workload {wl.name!r} serves no 'topk'"
                )
            out = wl.serve(self.client, "topk", arg)
            if self._c_topk is not None:
                self._c_topk.inc()
            return out
        raise ValueError(
            f"unknown command {cmd!r} (predict|query|topk|info)"
        )


class WorkloadServingClient:
    """One-line-per-request TCP client for the workload serving verbs
    (the test / example / probe surface)."""

    def __init__(self, host: str, port: int, *, timeout: float = 10.0):
        self.host = host
        self.port = int(port)
        self.timeout = float(timeout)

    def _ask(self, line: str) -> str:
        resp = request_lines(
            self.host, self.port, [line], timeout=self.timeout
        )[0]
        if resp.startswith("err "):
            raise RuntimeError(resp[4:])
        if resp == "ok":
            return ""
        if not resp.startswith("ok "):
            raise RuntimeError(f"malformed response {resp!r}")
        return resp[3:]

    def predict(self, examples) -> List[float]:
        """``examples``: iterable of ``[(id, val), ...]`` sparse rows;
        returns one margin per example."""
        payload = ";".join(
            ",".join(f"{int(i)}:{float(v):.6g}" for i, v in ex)
            for ex in examples
        )
        return [
            float(tok) for tok in self._ask(f"predict {payload}").split(",")
        ]

    def query(self, keys) -> List[int]:
        payload = ",".join(str(int(k)) for k in keys)
        return [
            int(tok) for tok in self._ask(f"query {payload}").split(",")
        ]

    def topk(self, k: int) -> List[tuple]:
        out = []
        body = self._ask(f"topk {int(k)}")
        for tok in body.split():
            key, _, count = tok.partition(":")
            out.append((int(key), int(count)))
        return out

    def info(self) -> dict:
        return json.loads(self._ask("info"))


__all__ = ["WorkloadServingClient", "WorkloadServingServer"]
