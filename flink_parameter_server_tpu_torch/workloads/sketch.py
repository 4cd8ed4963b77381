"""The streaming count-min / top-K sketch workload (PAPER.md §0;
SURVEY §2 #10).

Counterpart of ``flink_parameter_server_tpu/workloads/sketch.py``.  A
sketch IS a parameter store — the flat ``depth × width`` counter table
sharded over the PS — and a sketch update IS a push: hash the microbatch
of keys (``models/sketches.CountMinSketch``, on the workload's device),
scatter-add ones.  What makes it a DIFFERENT first-class citizen from
MF/PA is the push-semantics seam: pushes are integer bucket
**increments**, not fp32 deltas —

  * **integer-exact under the exactly-once ledger**: every count is an
    integer (exact in fp32 below 2^24) and integer adds commute, so
    the parity oracle is a pure-numpy ``bincount`` of the hashed
    stream, compared with NO float tolerance — through retries and
    live resharding;
  * **the q8 path is explicitly bypassed**
    (``push_semantics="increment"`` → the cluster driver downgrades
    quantized encodings to exact fp32): a dequantized increment
    within-a-granule of 1 is still the wrong count.

Serving verbs: ``query`` (point estimates — min over the depth rows'
cells) and ``topk`` (heavy hitters over the key space: estimate every
candidate on the host, rank with the port's :func:`~..ops.topk.top_k`,
which keeps ``lax.top_k``'s tie order, and pad with
:func:`~..ops.topk._pad_topk`)."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..ops.hashing import fmix32_np, hash_params
from .base import Workload, WorkloadParams


class SketchWorkload(Workload):
    name = "sketch"
    push_semantics = "increment"
    parity = "exact_int"
    serving_verbs: Tuple[str, ...] = ("query", "topk")
    worker_key = "key"

    def __init__(self, params: WorkloadParams = None, *,
                 depth: int = 4, width: Optional[int] = None,
                 device=None):
        super().__init__(params, device=device)
        self.depth = int(depth)
        # width scales with the key space; ≥ 64 keeps the ε = e/width
        # bound honest at the tiny nemesis shapes
        self.width = (
            int(width) if width is not None
            else max(64, 2 * int(self.params.num_items))
        )
        self._a, self._b = hash_params(self.depth, seed=0)
        self._row_offset = (
            np.arange(self.depth, dtype=np.int64) * self.width
        )

    # -- table ---------------------------------------------------------------
    @property
    def vocab(self) -> int:
        return int(self.params.num_items)

    @property
    def capacity(self) -> int:
        return self.width * self.depth

    @property
    def value_shape(self) -> Tuple[int, ...]:
        return ()

    def make_logic(self):
        from ..models.sketches import CountMinConfig, CountMinSketch

        return CountMinSketch(
            CountMinConfig(width=self.width, depth=self.depth, seed=0)
        )

    def proc_init(self) -> Optional[dict]:
        return {"kind": "zeros"}

    # -- hashing (host mirror of the device path, bitwise) -------------------
    def cells_np(self, keys) -> np.ndarray:
        """(n, depth) flat cell ids — the numpy mirror of
        ``CountMinSketch.cells`` (same ``fmix32`` family, same (a, b)
        constants, so host-side queries/oracles agree with the device
        step bit for bit)."""
        k = np.asarray(keys, np.int64).reshape(-1).astype(np.uint32)
        with np.errstate(over="ignore"):
            h = self._a[None, :] * k[:, None] + self._b[None, :]
        buckets = (
            np.asarray(fmix32_np(h), np.int64) % self.width
        )
        return buckets + self._row_offset[None, :]

    # -- the stream ----------------------------------------------------------
    def _tokens(self) -> np.ndarray:
        from ..data.text import synthetic_corpus

        p = self.params
        return synthetic_corpus(
            self.vocab, p.rounds * p.batch, num_topics=4,
            topic_stickiness=0.98, seed=p.seed,
        )

    def batches(self):
        p = self.params
        tokens = self._tokens()
        out = []
        for r in range(p.rounds):
            chunk = tokens[r * p.batch:(r + 1) * p.batch]
            out.append({
                "key": np.asarray(chunk, np.int64),
                "mask": np.ones(len(chunk), bool),
            })
        return out

    # -- the parity oracle ---------------------------------------------------
    def oracle_values(self) -> np.ndarray:
        """Exact ground truth: bincount of the hashed stream — no
        driver, no floats, just the integers the cluster must deliver
        exactly."""
        cells = self.cells_np(self._tokens()).reshape(-1)
        counts = np.bincount(cells, minlength=self.capacity)
        return counts.astype(np.float32)

    # -- serving -------------------------------------------------------------
    def _estimate(self, client, keys: np.ndarray) -> np.ndarray:
        cells = self.cells_np(keys)  # (n, depth)
        pulled = np.asarray(
            client.pull_batch(cells), np.float32
        ).reshape(cells.shape)
        return pulled.min(axis=1)

    def serve(self, client, cmd: str, arg: str) -> str:
        if cmd == "query":
            try:
                keys = np.asarray(
                    [int(t) for t in arg.split(",") if t.strip()],
                    np.int64,
                )
            except ValueError as e:
                raise ValueError(f"query needs integer keys: {e}")
            if keys.size == 0:
                raise ValueError("query needs at least one key")
            est = self._estimate(client, keys)
            return ",".join(str(int(v)) for v in est)
        if cmd == "topk":
            try:
                k = int(arg.strip() or "8")
            except ValueError:
                raise ValueError(f"topk needs an integer k, got {arg!r}")
            if k < 1:
                raise ValueError("k must be >= 1")
            import torch

            from ..ops.topk import _pad_topk, top_k

            candidates = np.arange(self.vocab, dtype=np.int64)
            est = self._estimate(client, candidates)
            # estimate-then-rank through the shared top-K path (the
            # same shape models/sketches.CountMinSketch.top_k uses);
            # host tensors: the estimates came off the wire
            top_est, pos = top_k(
                torch.from_numpy(est), min(k, candidates.size)
            )
            ids = torch.from_numpy(candidates)[pos]
            top_est, ids = _pad_topk(top_est[None], ids[None], k)
            return " ".join(
                f"{int(i)}:{int(c) if np.isfinite(c) else 0}"
                for i, c in zip(ids[0].numpy(), top_est[0].numpy())
                if int(i) >= 0
            )
        return super().serve(client, cmd, arg)

    def probe_request(self, rng: np.random.Generator
                      ) -> Tuple[str, str]:
        if rng.random() < 0.5:
            keys = rng.integers(0, self.vocab, size=3)
            return "query", ",".join(str(int(k)) for k in keys)
        return "topk", "4"


__all__ = ["SketchWorkload"]
