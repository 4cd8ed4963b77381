"""The passive-aggressive classifier workload (PAPER.md §0; SURVEY §2 #9).

Counterpart of ``flink_parameter_server_tpu/workloads/pa.py``.  The model
is the scalar weight vector keyed by feature id
(``models/passive_aggressive.py``), run through
:class:`~.base.DenseCombineLogic` so every round's duplicate-feature lane
sums combine ON DEVICE — which is what makes the parity mode **bitwise**:
a BSP cluster run (through sockets, WAL, migration, retries) must
reproduce the single-process streaming oracle bit for bit.  The oracle
runs the same step the cluster workers execute, on the same device
(:meth:`~.PAClassifierWorkload.oracle_values`), then the host half of the
cluster's push: :func:`~..ops.dedup.aggregate_deltas` and one float32 add
per touched id.  The stream is a seeded sparse linear-classification task
(features ~70% zero, labels from a hidden weight vector) built in numpy,
bit for bit the reference's, with a ``rec`` record-index column for
worker routing.  It is a dense ``(rounds·batch, num_items)`` float32
matrix before it is padded into sparse batches, so its size is set by
host memory.

Serving verb ``predict``: sparse examples in, margins out — one
coalesced pull of the present feature ids per request.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .base import DenseCombineLogic, Workload, WorkloadParams


def _pa_stream(params: WorkloadParams):
    """Seeded sparse classification stream: (X, y), deterministic."""
    p = params
    rng = np.random.default_rng(p.seed)
    F = int(p.num_items)
    n = int(p.rounds) * int(p.batch)
    w_true = rng.normal(0, 1, F)
    X = rng.normal(0, 1, (n, F)).astype(np.float32)
    X[rng.random(X.shape) < 0.7] = 0.0
    # keep every example non-empty (an all-zero row pulls nothing and
    # the hinge loss is degenerate): give it one feature back
    empty = ~(X != 0).any(axis=1)
    if empty.any():
        X[empty, rng.integers(0, F, int(empty.sum()))] = 1.0
    y = np.sign(X @ w_true + 1e-9).astype(np.float32)
    return X, y


class PAClassifierWorkload(Workload):
    name = "pa"
    push_semantics = "delta"
    parity = "bitwise"
    serving_verbs: Tuple[str, ...] = ("predict",)
    worker_key = "rec"

    def __init__(self, params: WorkloadParams = None, *, C: float = 1.0,
                 device=None):
        super().__init__(params, device=device)
        self.C = float(C)

    @property
    def capacity(self) -> int:
        return int(self.params.num_items)  # the feature space

    @property
    def value_shape(self) -> Tuple[int, ...]:
        return ()

    def _rule(self):
        from ..models.passive_aggressive import PARule

        return PARule("PA-I", C=self.C)

    def make_logic(self):
        from ..models.passive_aggressive import PassiveAggressiveBinary

        return DenseCombineLogic(
            PassiveAggressiveBinary(self._rule()), self.capacity
        )

    def proc_init(self) -> Optional[dict]:
        return {"kind": "zeros"}

    def batches(self):
        from ..data.streams import sparse_feature_batches

        p = self.params
        X, y = _pa_stream(p)
        out = []
        rec = 0
        for b in sparse_feature_batches(X, y, p.batch, epochs=1):
            b = dict(b)
            # stable per-record routing column (entity affinity is
            # per-example for online classification)
            n = len(b["label"])
            b["rec"] = np.arange(rec, rec + n, dtype=np.int64)
            rec += n
            out.append(b)
        return out

    def oracle_values(self) -> np.ndarray:
        """The streaming oracle — a sequential single-process run of
        the SAME step the cluster workers execute, on the same device
        (gather → step → on-device combine → one f32 add per touched
        id, on the host as the cluster client and shard do it).  The
        bitwise bar exists to catch distributed-runtime bugs — routing,
        WAL replay, migration, retry dedupe — so the oracle holds the
        numerics fixed by running the identical step."""
        import torch

        from ..core.transform import to_device, to_host
        from ..ops.dedup import aggregate_deltas

        logic = self.make_logic()
        table = np.zeros(self.capacity, np.float32)
        rng = torch.Generator(device=self.device)
        rng.manual_seed(0)
        state = logic.init_state(rng)
        for batch in self.batches():
            db = to_device(batch, self.device)
            ids = to_host(logic.keys(db))
            pulled = table[ids]
            state, req, _out = logic.step(
                state, db, to_device(pulled, self.device)
            )
            mask = None if req.mask is None else to_host(req.mask)
            uids, rows = aggregate_deltas(
                to_host(req.ids), to_host(req.deltas), mask
            )
            table[uids] += rows.astype(np.float32)
        return table

    def streaming_driver_values(self) -> np.ndarray:
        """The literal StreamingDriver run on the same stream — the
        fp32-semantics anchor :meth:`oracle_values` is pinned allclose
        against (its table adds each round's combined rows on the
        device, the oracle on the host)."""
        from ..core.store import ShardedParamStore
        from ..core.transform import to_host
        from ..training.driver import DriverConfig, StreamingDriver
        from ..utils.initializers import zeros

        store = ShardedParamStore.create(
            self.capacity, (), init_fn=zeros(()), device=self.device
        )
        driver = StreamingDriver(
            self.make_logic(), store,
            config=DriverConfig(telemetry=False, dump_model=False),
        )
        result = driver.run(self.batches())
        return to_host(result.store.values(), copy=True)

    # -- serving -------------------------------------------------------------
    @staticmethod
    def _parse_examples(arg: str):
        """``id:val,id:val;id:val...`` → list of (ids, vals) arrays."""
        examples = []
        for part in arg.strip().split(";"):
            part = part.strip()
            if not part:
                continue
            ids, vals = [], []
            for tok in part.split(","):
                fid, sep, val = tok.partition(":")
                if not sep:
                    raise ValueError(
                        f"feature {tok!r}: expected <id>:<value>"
                    )
                ids.append(int(fid))
                vals.append(float(val))
            if not ids:
                raise ValueError("empty example")
            examples.append(
                (np.asarray(ids, np.int64), np.asarray(vals, np.float32))
            )
        if not examples:
            raise ValueError(
                "predict needs id:val[,id:val...][;example...]"
            )
        return examples

    def serve(self, client, cmd: str, arg: str) -> str:
        if cmd != "predict":
            return super().serve(client, cmd, arg)
        examples = self._parse_examples(arg)
        all_ids = np.unique(np.concatenate([ids for ids, _ in examples]))
        if all_ids.min() < 0 or all_ids.max() >= self.capacity:
            raise ValueError(
                f"feature ids must be in [0, {self.capacity})"
            )
        w = np.asarray(
            client.pull_batch(all_ids), np.float32
        ).reshape(-1)
        margins = []
        for ids, vals in examples:
            margins.append(
                float(w[np.searchsorted(all_ids, ids)] @ vals)
            )
        return ",".join(f"{m:.6g}" for m in margins)

    def probe_request(self, rng: np.random.Generator
                      ) -> Tuple[str, str]:
        F = self.capacity
        k = min(3, F)
        parts = []
        for _ in range(2):
            ids = rng.choice(F, size=k, replace=False)
            vals = rng.standard_normal(k)
            parts.append(",".join(
                f"{int(i)}:{v:.4f}" for i, v in zip(ids, vals)
            ))
        return "predict", ";".join(parts)


__all__ = ["PAClassifierWorkload"]
