"""flink_parameter_server_tpu_torch — the parameter server in PyTorch/CUDA.

A port of ``flink_parameter_server_tpu`` (JAX on a TPU) to PyTorch on an
NVIDIA H100.  The JAX package stays the reference; this package imports
nothing of it and nothing of JAX.  Two paths are ported: online MF (per-id
init, the parameter store, the batched PS loop, and the sorted scatter-add
and fused MF-SGD kernels) and Transformer LM training through the dense
parameter server (the model, optax-default optimizers, and the causal
flash-attention forward, dQ and dK/dV kernels).  Around the MF loop sits
the job envelope (``training/``, ``resilience/``, ``telemetry/``): the
streaming driver, checkpoints, the write-ahead log and crash recovery;
beside it the query plane (``serving/``) answers exact top-K
recommendations from versioned snapshots while the driver trains.  The
other batched workloads run on the same store and push (K1 with
``scatter_impl="pallas"``): passive-aggressive classification, the
count-min / Bloom / tug-of-war sketches, word2vec SGNS and the
factorization machine; the event API (``WorkerLogic``,
``ParameterServerLogic``, ``transform`` with ``param_init`` /
``param_update``) runs the reference system's per-record callbacks on the
host.  The parameter-server cluster (``cluster/``, ``meshstore/``) runs
the same batched logics against key-partitioned shards behind TCP
servers, each slice a tensor on the card, or against one table tensor on
the card (``store_backend="mesh"``), under a BSP / SSP / async clock;
the elastic driver resizes it live, and replica chains (``replication/``)
ship each shard's log to followers on the card that take over when a
primary dies.  A hot-key lease cache (``hotcache/``) serves Zipf-hot rows
at the client edge under a staleness bound, and the telemetry plane
serves ``/metrics`` and writes the run report.  The LM takes switch-MoE layers, and
``transform_hybrid`` runs event-API callbacks against the store on the
card.  The parameter server's paths (the store, the batched loop, MF with
its fused and locality steps, PA, the sketches, top-K serving,
checkpoints) also run on a ``dp × ps`` mesh of ranks, one a device
(``parallel/``, ``make_mesh``), and the LM, MoE layers included, on data,
expert, tensor, sequence (ring attention) and pipeline parallel meshes
and every mix of them that the reference runs (``make_nd_mesh``;
``models.transformer.check_lm_mesh`` gives each layout's MoE capacity
rule).  Entry points run on ``cuda`` unless given ``device="cpu"``; on the
CPU each kernel's plain torch version runs instead.

Quickstart::

    from flink_parameter_server_tpu_torch import ps_online_mf
    from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
    from flink_parameter_server_tpu_torch.data.streams import microbatches

    data = synthetic_ratings(1000, 1200, 50_000)
    result = ps_online_mf(microbatches(data, 4096), num_users=1000,
                          num_items=1200, dim=16, scatter_impl="pallas",
                          device="cuda")
    item_factors = result.store.values()

and the LM (``batches`` yields ``{"tokens": (B, T) int array}``)::

    from flink_parameter_server_tpu_torch import (
        DenseParameterServer, TransformerConfig, adamw, init_params, lm_loss,
        transform_dense)

    cfg = TransformerConfig(flash_attention="on")
    server = DenseParameterServer(init_params(cfg, device="cuda"), adamw(3e-3))
    result = transform_dense(batches, lambda m, b: lm_loss(m, b, cfg), server)

and a job that checkpoints, logs ahead and survives a crash::

    from flink_parameter_server_tpu_torch import DriverConfig, StreamingDriver
    from flink_parameter_server_tpu_torch.resilience import RecoveringDriver

    driver = StreamingDriver(logic, store, config=DriverConfig(
        checkpoint_dir="ckpt", checkpoint_every=100, wal_dir="wal"))
    driver.resume()                    # continue a saved job, if any
    result = RecoveringDriver(driver, make_stream).run()

the other workloads (``models/{passive_aggressive,sketches,word2vec,
factorization_machine}.py``)::

    from flink_parameter_server_tpu_torch.models.passive_aggressive import transform_binary
    result = transform_binary(batches, num_features=2_000_000, scatter_impl="pallas",
                              device="cuda")

and the event API::

    from flink_parameter_server_tpu_torch import transform
    result = transform(records, MyWorkerLogic, param_init=lambda k: 0.0,
                       param_update=lambda cur, delta: cur + delta)

and a 4-shard, 2-worker BSP cluster over TCP (or ``store_backend="mesh"``)::

    from flink_parameter_server_tpu_torch import ClusterConfig, ClusterDriver
    with ClusterDriver(logic, capacity=num_items, value_shape=(dim,),
                       init_fn=init, config=ClusterConfig(
                           num_shards=4, num_workers=2, staleness_bound=0)) as d:
        result = d.run(batches)          # result.values: the final table

and one that answers queries while it trains::

    service = driver.serve_with(publish_every=4)
    client = service.client()
    ...                                  # driver.run(batches) in a thread
    answer = client.top_k(user, k=10)    # .item_ids, .scores, .staleness
"""
from .cluster import (
    ClusterClient,
    ClusterConfig,
    ClusterDriver,
    ConsistentHashPartitioner,
    ParamShard,
    RangePartitioner,
    ShardServer,
    StalenessClock,
)
from .core.api import (
    ParameterServer,
    ParameterServerClient,
    ParameterServerLogic,
    SimplePSLogic,
    WorkerLogic,
    add_pull_limiter,
)
from .core.batched import BatchedWorkerLogic, PushRequest
from .core.dense import (
    DenseParameterServer,
    fsdp_place,
    make_dense_train_step,
    opt_state_zero1_specs,
    shard_opt_state_constraint,
    transform_dense,
)
from .core.hybrid import transform_hybrid
from .core.optim import adam, adamw, sgd
from .core.store import ShardedParamStore, StoreSpec
from .core.transform import (
    TransformResult,
    make_scan_train_step,
    make_train_step,
    transform,
    transform_batched,
    transform_with_model_load,
)
from .core.entities import Pull, PullAnswer, Push, PSToWorker, WorkerToPS
from .models.matrix_factorization import (
    MFWorkerLogic,
    OnlineMatrixFactorization,
    SGDUpdater,
    ps_online_mf,
)
from .models.transformer import (
    TransformerConfig,
    TransformerLM,
    forward,
    forward_pipelined,
    init_params,
    lm_loss,
    next_token_xent,
)
from .ops.flash_attention import flash_mha
from .parallel.mesh import DP_AXIS, PS_AXIS, make_mesh, make_nd_mesh, single_device_mesh
from .ops.mf_kernel import make_fused_mf_train_step
from .serving import (
    QueryEngine,
    ServingClient,
    ServingServer,
    ServingService,
    SnapshotManager,
)
from .telemetry import (
    MetricsRegistry,
    SpanTracer,
    TelemetryServer,
    build_run_report,
    get_registry,
    get_tracer,
    prometheus_text,
    write_run_report,
)
from .hotcache import (
    CachedLookupService,
    HotRowCache,
    LeasePolicy,
)
from .training.checkpoint import load_model
from .training.driver import DriverConfig, StreamingDriver, TrainingDiverged
from .utils.initializers import normal_factor, ranged_random_factor, zeros

__all__ = [
    "ParameterServer",
    "ParameterServerClient",
    "ParameterServerLogic",
    "SimplePSLogic",
    "WorkerLogic",
    "add_pull_limiter",
    "Pull",
    "Push",
    "PullAnswer",
    "WorkerToPS",
    "PSToWorker",
    "BatchedWorkerLogic",
    "PushRequest",
    "DenseParameterServer",
    "fsdp_place",
    "make_dense_train_step",
    "opt_state_zero1_specs",
    "shard_opt_state_constraint",
    "transform_dense",
    "adam",
    "adamw",
    "sgd",
    "TransformerConfig",
    "TransformerLM",
    "forward",
    "forward_pipelined",
    "init_params",
    "lm_loss",
    "next_token_xent",
    "flash_mha",
    "ShardedParamStore",
    "StoreSpec",
    "ClusterClient",
    "ClusterConfig",
    "ClusterDriver",
    "ConsistentHashPartitioner",
    "ParamShard",
    "RangePartitioner",
    "ShardServer",
    "StalenessClock",
    "TransformResult",
    "make_scan_train_step",
    "make_train_step",
    "transform",
    "transform_batched",
    "transform_hybrid",
    "transform_with_model_load",
    "DriverConfig",
    "StreamingDriver",
    "TrainingDiverged",
    "load_model",
    "MFWorkerLogic",
    "OnlineMatrixFactorization",
    "SGDUpdater",
    "ps_online_mf",
    "make_fused_mf_train_step",
    "make_mesh",
    "make_nd_mesh",
    "single_device_mesh",
    "DP_AXIS",
    "PS_AXIS",
    "QueryEngine",
    "ServingClient",
    "ServingServer",
    "ServingService",
    "SnapshotManager",
    "MetricsRegistry",
    "SpanTracer",
    "TelemetryServer",
    "get_registry",
    "get_tracer",
    "prometheus_text",
    "build_run_report",
    "write_run_report",
    "CachedLookupService",
    "HotRowCache",
    "LeasePolicy",
    "normal_factor",
    "ranged_random_factor",
    "zeros",
]
