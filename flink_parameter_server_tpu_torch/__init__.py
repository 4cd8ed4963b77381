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
recommendations from versioned snapshots while the driver trains.
Entry points run on ``cuda`` unless given ``device="cpu"``; on the CPU
each kernel's plain torch version runs instead.

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

and one that answers queries while it trains::

    service = driver.serve_with(publish_every=4)
    client = service.client()
    ...                                  # driver.run(batches) in a thread
    answer = client.top_k(user, k=10)    # .item_ids, .scores, .staleness
"""
from .core.batched import BatchedWorkerLogic, PushRequest
from .core.dense import DenseParameterServer, make_dense_train_step, transform_dense
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
from .models.matrix_factorization import (
    OnlineMatrixFactorization,
    SGDUpdater,
    ps_online_mf,
)
from .models.transformer import (
    TransformerConfig,
    TransformerLM,
    forward,
    init_params,
    lm_loss,
    next_token_xent,
)
from .ops.flash_attention import flash_mha
from .ops.mf_kernel import make_fused_mf_train_step
from .serving import (
    QueryEngine,
    ServingClient,
    ServingServer,
    ServingService,
    SnapshotManager,
)
from .training.checkpoint import load_model
from .training.driver import DriverConfig, StreamingDriver, TrainingDiverged
from .utils.initializers import normal_factor, ranged_random_factor, zeros

__all__ = [
    "BatchedWorkerLogic",
    "PushRequest",
    "DenseParameterServer",
    "make_dense_train_step",
    "transform_dense",
    "adam",
    "adamw",
    "sgd",
    "TransformerConfig",
    "TransformerLM",
    "forward",
    "init_params",
    "lm_loss",
    "next_token_xent",
    "flash_mha",
    "ShardedParamStore",
    "StoreSpec",
    "TransformResult",
    "make_scan_train_step",
    "make_train_step",
    "transform",
    "transform_batched",
    "transform_with_model_load",
    "DriverConfig",
    "StreamingDriver",
    "TrainingDiverged",
    "load_model",
    "OnlineMatrixFactorization",
    "SGDUpdater",
    "ps_online_mf",
    "make_fused_mf_train_step",
    "QueryEngine",
    "ServingClient",
    "ServingServer",
    "ServingService",
    "SnapshotManager",
    "normal_factor",
    "ranged_random_factor",
    "zeros",
]
