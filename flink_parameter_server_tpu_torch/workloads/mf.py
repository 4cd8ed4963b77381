"""The MF workload — the incumbent, registry-packaged.

Counterpart of ``flink_parameter_server_tpu/workloads/mf.py``: exactly the
seeded synthetic-ratings stream, logic and init every parity test of the
reference's cluster has trained; the oracle is the fault-free static
2-shard BSP cluster run on the same stream (the table is shard-count
independent — the elastic parity suite pins that), compared allclose fp32
— MF's duplicate-id delta sums make bitwise a property of scatter order,
not of correctness (see :class:`~.base.DenseCombineLogic` for the
workload shape where bitwise IS structural).  The logic, the init and the
oracle's cluster run on the workload's ``device``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .base import Workload


class MFWorkload(Workload):
    name = "mf"
    push_semantics = "delta"
    parity = "allclose"
    serving_verbs: Tuple[str, ...] = ()
    worker_key = "user"

    @property
    def capacity(self) -> int:
        return int(self.params.num_items)

    @property
    def value_shape(self) -> Tuple[int, ...]:
        return (int(self.params.dim),)

    def make_logic(self):
        from ..models.matrix_factorization import (
            OnlineMatrixFactorization,
            SGDUpdater,
        )

        return OnlineMatrixFactorization(
            self.params.num_users, self.params.dim,
            updater=SGDUpdater(0.05), seed=1, device=self.device,
        )

    def init_fn(self):
        from ..utils.initializers import ranged_random_factor

        return ranged_random_factor(7, (self.params.dim,))

    def batches(self):
        from ..data.movielens import synthetic_ratings
        from ..data.streams import microbatches

        p = self.params
        cols = synthetic_ratings(
            p.num_users, p.num_items, p.rounds * p.batch, seed=p.seed
        )
        return list(microbatches(cols, p.batch))

    def oracle_values(self) -> np.ndarray:
        from ..cluster.driver import ClusterConfig, ClusterDriver

        driver = ClusterDriver(
            self.make_logic(),
            capacity=self.capacity,
            value_shape=self.value_shape,
            init_fn=self.init_fn(),
            config=ClusterConfig(
                num_shards=2, num_workers=self.params.num_workers,
                partition="hash",
            ),
            registry=False,
            device=self.device,
        )
        with driver:
            return driver.run(self.batches()).values


__all__ = ["MFWorkload"]
