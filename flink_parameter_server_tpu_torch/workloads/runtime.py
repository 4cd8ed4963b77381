"""Runtime glue: registered workloads onto the cluster stack.

Counterpart of ``flink_parameter_server_tpu/workloads/runtime.py``.
``build_cluster_driver`` stamps the workload's contract onto a
:class:`~..cluster.driver.ClusterConfig` — worker routing column, push
semantics (the increment carve-out), the ``workload=`` label that puts
per-workload update rates on /metrics — and constructs any driver in the
elastic family (:class:`~..elastic.controller.ElasticClusterDriver`)
around the workload's logic and init, on the workload's device.
``serve_workload`` opens the TCP verb front end; ``workload_table``
aggregates the ``workloads`` metric component into the live
per-workload rate table."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..utils.device import DeviceLike
from .base import Workload, WorkloadParams
from .registry import create_workload


def resolve_workload(workload, params: Optional[WorkloadParams] = None,
                     *, device: DeviceLike = None) -> Workload:
    """A name or an instance → an instance (a name is built for
    ``device``; an instance keeps its own)."""
    if isinstance(workload, Workload):
        return workload
    return create_workload(str(workload), params, device=device)


def build_cluster_driver(
    workload,
    *,
    params: Optional[WorkloadParams] = None,
    config=None,
    driver_cls=None,
    registry=None,
    driver_kwargs: Optional[dict] = None,
    device: DeviceLike = None,
    **config_overrides,
):
    """Construct a cluster driver around ``workload`` (name or
    instance).  ``config`` may be any ClusterConfig-family instance
    (the elastic driver passes its own); the workload's routing column,
    push semantics and name label are stamped onto it either way.  The
    driver runs on the workload's device (a name is built for
    ``device``: the card unless the caller passes ``device="cpu"``)."""
    from ..cluster.driver import ClusterConfig, ClusterDriver

    wl = resolve_workload(workload, params, device=device)
    if config is None:
        config = ClusterConfig(**config_overrides)
    elif config_overrides:
        raise ValueError(
            "pass topology knobs either via config= or as overrides, "
            "not both"
        )
    config.worker_key = wl.worker_key
    config.push_semantics = wl.push_semantics
    config.workload = wl.name
    cls = driver_cls if driver_cls is not None else ClusterDriver
    if getattr(config, "shard_procs", False):
        config.proc_init = wl.proc_init()
    driver = cls(
        wl.make_logic(),
        capacity=wl.capacity,
        value_shape=wl.value_shape,
        init_fn=wl.init_fn(),
        config=config,
        registry=registry,
        device=wl.device,
        **(driver_kwargs or {}),
    )
    driver.workload = wl
    return driver


def serve_workload(
    workload,
    client,
    *,
    host: str = "127.0.0.1",
    port: int = 0,
    registry=None,
    device: DeviceLike = None,
):
    """Start a :class:`~.serving.WorkloadServingServer` over ``client``
    (started; caller owns stop())."""
    from .serving import WorkloadServingServer

    wl = resolve_workload(workload, device=device)
    server = WorkloadServingServer(
        wl, client, host, port, registry=registry
    )
    server.start()
    return server


# -- the live rate table (TelemetryServer `workloads` path) -------------------

_RATE_COUNTERS = (
    ("updates_total", "workload_updates_total"),
    ("predictions_total", "workload_predictions_total"),
    ("queries_total", "workload_queries_total"),
    ("topk_total", "workload_topk_total"),
    ("serving_errors_total", "workload_serving_errors_total"),
)


def workload_table(registry=None) -> Dict[str, dict]:
    """Aggregate the ``workloads`` component into
    ``{workload: {counters..., query latency percentiles}}`` — the
    payload behind the telemetry ``workloads`` path.  Counters are
    cumulative; rate derivation is the CLIENT's job (diff two scrapes),
    so the table stays a pure snapshot."""
    if registry is None:
        from ..telemetry.registry import get_registry

        registry = get_registry()
    table: Dict[str, dict] = {}

    def row(workload: str) -> dict:
        return table.setdefault(workload, {
            key: 0 for key, _ in _RATE_COUNTERS
        })

    for inst in registry.instruments():
        if inst.labels.get("component") != "workloads":
            continue
        wl = inst.labels.get("workload")
        if wl is None:
            continue
        for key, name in _RATE_COUNTERS:
            if inst.name == name:
                row(wl)[key] = row(wl).get(key, 0) + int(inst.value)
        if inst.name == "workload_query_latency_seconds":
            r = row(wl)
            r["query_latency_p50_ms"] = round(
                inst.percentile(50) * 1e3, 3
            )
            r["query_latency_p99_ms"] = round(
                inst.percentile(99) * 1e3, 3
            )
            r["queries_observed"] = int(inst.count)
    return table


def run_streaming(workload, *, params: Optional[WorkloadParams] = None,
                  device: DeviceLike = None) -> np.ndarray:
    """The single-process path: run the workload's stream through its
    streaming oracle and return the final table."""
    wl = resolve_workload(workload, params, device=device)
    return np.asarray(wl.oracle_values())


__all__ = [
    "build_cluster_driver",
    "resolve_workload",
    "run_streaming",
    "serve_workload",
    "workload_table",
]
