"""workloads/ — the workload-generic runtime.

Counterpart of ``flink_parameter_server_tpu/workloads/``: heterogeneous
learners (MF, the PA classifier, streaming sketches) as first-class
citizens of the cluster stack, on the card unless the caller passes
``device="cpu"``: one contract (:class:`~.base.Workload`), one registry
(drive any workload by name), per-workload serving verbs, and
per-workload parity oracles — bitwise for PA, integer-exact for
sketches.
"""
from .base import (
    DenseCombineLogic,
    Workload,
    WorkloadParams,
)
from .registry import (
    WorkloadRegistry,
    create_workload,
    get_workload_registry,
    workload_names,
)
from .runtime import (
    build_cluster_driver,
    resolve_workload,
    run_streaming,
    serve_workload,
    workload_table,
)
from .serving import WorkloadServingClient, WorkloadServingServer

__all__ = [
    "DenseCombineLogic",
    "Workload",
    "WorkloadParams",
    "WorkloadRegistry",
    "WorkloadServingClient",
    "WorkloadServingServer",
    "build_cluster_driver",
    "create_workload",
    "get_workload_registry",
    "resolve_workload",
    "run_streaming",
    "serve_workload",
    "workload_names",
    "workload_table",
]
