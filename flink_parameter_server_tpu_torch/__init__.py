"""flink_parameter_server_tpu_torch — the parameter server in PyTorch/CUDA.

A port of ``flink_parameter_server_tpu`` (JAX on a TPU) to PyTorch on an
NVIDIA H100.  The JAX package stays the reference; this package imports
nothing of it and nothing of JAX.  This slice covers the online-MF main
path: per-id init, the parameter store, the batched PS loop and the two
hand-written CUDA kernels on it (the sorted scatter-add push and the fused
MF-SGD step).  Entry points run on ``cuda`` unless given ``device="cpu"``;
on the CPU each kernel's plain torch version runs instead.

Quickstart::

    from flink_parameter_server_tpu_torch import ps_online_mf
    from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
    from flink_parameter_server_tpu_torch.data.streams import microbatches

    data = synthetic_ratings(1000, 1200, 50_000)
    result = ps_online_mf(microbatches(data, 4096), num_users=1000,
                          num_items=1200, dim=16, scatter_impl="pallas",
                          device="cuda")
    item_factors = result.store.values()
"""
from .core.batched import BatchedWorkerLogic, PushRequest
from .core.store import ShardedParamStore, StoreSpec
from .core.transform import (
    TransformResult,
    make_scan_train_step,
    make_train_step,
    transform_batched,
)
from .models.matrix_factorization import (
    OnlineMatrixFactorization,
    SGDUpdater,
    ps_online_mf,
)
from .ops.mf_kernel import make_fused_mf_train_step
from .utils.initializers import normal_factor, ranged_random_factor, zeros

__all__ = [
    "BatchedWorkerLogic",
    "PushRequest",
    "ShardedParamStore",
    "StoreSpec",
    "TransformResult",
    "make_scan_train_step",
    "make_train_step",
    "transform_batched",
    "OnlineMatrixFactorization",
    "SGDUpdater",
    "ps_online_mf",
    "make_fused_mf_train_step",
    "normal_factor",
    "ranged_random_factor",
    "zeros",
]
