"""Delta codecs + error-feedback residuals — the quantized push path.

A copy of ``flink_parameter_server_tpu/compression/quantizers.py``, which imports
no JAX: the port imports nothing of the JAX package, whose ``__init__``
imports JAX.  Modules it names that the port does not have yet are the
reference's.

ROADMAP item 3 (docs/compression.md): the PR-7 byte ledger made
bytes-on-wire a committed baseline, and the PR-13 binary frame gave
payloads an encoding byte — this module is the codec family that
rides it.  Everything here is **numpy on the host**: the wire path
must never pay a jax import or an XLA dispatch to halve a payload.

Two delta codecs, one rule:

  * ``q8`` — per-row-scaled int8: each row is scaled by
    ``absmax/127`` and rounded to int8 (4 bytes/value → 1 byte/value
    + 4 bytes/row of scale).  The scale vector travels next to the
    payload (a ``T_SCALE`` TLV on the binary frame).
  * ``bf16`` — the PR-13 truncation (top 16 bits of each fp32), now
    with the loss captured instead of discarded.

**Error feedback** (the residual rule): quantization error is never
thrown away — the difference between the adjusted delta and what the
wire actually carried is accumulated HOST-SIDE per id
(:class:`ResidualStore`) and re-injected into that id's next push.
The long-run sum of what the table received then tracks the long-run
sum of the true deltas to within ONE quantization granule per id,
which is what the convergence property tests pin against the fp32
oracle (tests/test_compression.py).

The one invariant everything downstream leans on: the values a
compressed push DELIVERS are exactly ``dequantize(quantize(adj))`` —
computed once, client-side — regardless of which framing carries them.
A mixed fleet (binary q8 frames to new shards, fp32 lines to old
ones), a stale-epoch replay, or a replica fallback all apply the SAME
rows, so the exactly-once ledger and cross-shard determinism are
framing-independent (docs/compression.md "negotiation matrix").

WAL records: a replication leg shipping quantized records rewrites the
payload ``{"ids", "deltas"}`` → ``{"ids", "qdeltas", "scales"}``
(kind unchanged); :func:`record_deltas` is the one decode seam every
record consumer (follower apply, promotion replay, migration tail,
verify-against-log) reads deltas through.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# codec names as negotiated on the hello line (utils/frames.WIRE_ENCS)
Q8 = "q8"
BF16 = "bf16"

# T_SCALE TLVs are bounded at 64 KiB (u16 length): 4 bytes/row caps a
# q8 frame at this many rows — far above the client's default
# chunk=512, enforced here so an oversized frame fails at encode time
# with a chunking hint instead of a torn TLV at the server
MAX_Q8_ROWS = 0xFFFF // 4


def _as_rows(rows: np.ndarray) -> np.ndarray:
    arr = np.ascontiguousarray(np.asarray(rows, np.float32))
    return arr.reshape(arr.shape[0], -1) if arr.ndim > 1 else arr.reshape(-1, 1)


def quantize_q8(rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row-scaled int8: ``(q (n, width) int8, scales (n,) f32)``.
    ``scale = absmax/127`` per row; an all-zero row gets scale 0 and
    dequantizes to exact zeros.  Non-finite inputs are an error — a
    NaN delta must fail loudly, not ship as a saturated int8."""
    flat = _as_rows(rows)
    if not np.isfinite(flat).all():
        raise ValueError("q8 codec: non-finite delta rows")
    absmax = np.abs(flat).max(axis=1)
    scales = (absmax / 127.0).astype(np.float32)
    safe = np.where(scales > 0, scales, 1.0).astype(np.float32)
    q = np.clip(
        np.rint(flat / safe[:, None]), -127, 127
    ).astype(np.int8)
    return q, scales


def dequantize_q8(
    q: np.ndarray, scales: np.ndarray,
    value_shape: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Inverse of :func:`quantize_q8` → ``(n, *value_shape)`` f32
    (``value_shape=None`` keeps the codec's flat ``(n, width)``)."""
    q = np.asarray(q, np.int8)
    scales = np.asarray(scales, np.float32)
    out = q.astype(np.float32).reshape(q.shape[0], -1) * scales[:, None]
    if value_shape is None:
        return out
    return out.reshape((q.shape[0],) + tuple(int(s) for s in value_shape))


def q8_payload(rows: np.ndarray) -> Tuple[bytes, bytes]:
    """Wire rendering: ``(int8 payload bytes, f32 scale bytes)`` — the
    payload section and the ``T_SCALE`` TLV of one ``ENC_Q8`` frame."""
    flat = _as_rows(rows)
    if flat.shape[0] > MAX_Q8_ROWS:
        raise ValueError(
            f"{flat.shape[0]} rows in one q8 frame (max {MAX_Q8_ROWS}; "
            f"chunk the batch)"
        )
    q, scales = quantize_q8(flat)
    return q.tobytes(), scales.astype("<f4").tobytes()


def q8_from_payload(
    payload, scales_bytes, value_shape: Sequence[int]
) -> np.ndarray:
    """Decode one ``ENC_Q8`` frame's sections back to f32 rows."""
    if scales_bytes is None:
        raise ValueError("q8 frame without a scale section (T_SCALE)")
    scales = np.frombuffer(scales_bytes, dtype="<f4")
    q = np.frombuffer(payload, dtype=np.int8)
    width = 1
    for s in value_shape:
        width *= int(s)
    if width == 0 or q.size % width or q.size // width != scales.size:
        raise ValueError(
            f"q8 payload of {q.size} values / {scales.size} scales does "
            f"not tile value shape {tuple(value_shape)}"
        )
    return dequantize_q8(q.reshape(scales.size, width), scales, value_shape)


def bf16_roundtrip(rows: np.ndarray) -> np.ndarray:
    """What an ``ENC_BF16`` frame delivers: each fp32 truncated to its
    top 16 bits (the utils/frames codec, reproduced host-side so the
    residual can be computed BEFORE the bytes leave)."""
    arr = np.ascontiguousarray(np.asarray(rows, "<f4"))
    return (
        (arr.view("<u4") & np.uint32(0xFFFF0000)).view("<f4").copy()
    )


class ResidualStore:
    """Host-side error-feedback accumulator, keyed by global id.

    ``take(ids, width)`` hands back (and clears) the stored residual
    rows for ``ids``; after quantizing ``adj = delta + taken``,
    ``put(ids, adj - delivered)`` stores the new error.  Thread-safe —
    the fan-out pool's shard jobs never touch it (compression happens
    at the batch level, before the split), but the residual-norm probe
    gauge reads it from the scrape thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rows: Dict[int, np.ndarray] = {}
        self._sumsq = 0.0

    def take(self, ids: np.ndarray, width: int) -> np.ndarray:
        out = np.zeros((len(ids), width), np.float32)
        with self._lock:
            for j, gid in enumerate(ids):
                row = self._rows.pop(int(gid), None)
                if row is not None:
                    out[j] = row
                    self._sumsq -= float(np.dot(row, row))
            self._sumsq = max(0.0, self._sumsq)
        return out

    def put(self, ids: np.ndarray, residuals: np.ndarray) -> None:
        res = _as_rows(residuals)
        with self._lock:
            for j, gid in enumerate(ids):
                row = res[j]
                if row.any():
                    self._rows[int(gid)] = row.copy()
                    self._sumsq += float(np.dot(row, row))

    def norm(self) -> float:
        """L2 norm over every stored residual — the live
        ``compression_residual_norm`` probe."""
        with self._lock:
            return float(np.sqrt(max(0.0, self._sumsq)))

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    def clear(self) -> None:
        with self._lock:
            self._rows = {}
            self._sumsq = 0.0


class DeltaCompressor:
    """One quantized-push pipeline: residual in → codec → residual out.

    :meth:`compress` returns ``(delivered, q, scales)`` where
    ``delivered`` is the exact f32 the table must receive (the
    dequantized rows — what a non-supporting peer gets as plain fp32)
    and ``(q, scales)`` the wire sections for ``ENC_Q8`` (``scales``
    is None for bf16, whose ``delivered`` re-encodes losslessly)."""

    def __init__(self, enc: str):
        if enc not in (Q8, BF16):
            raise ValueError(f"enc={enc!r}: {Q8!r} | {BF16!r}")
        self.enc = enc
        self.residuals = ResidualStore()

    def compress(
        self, ids: np.ndarray, deltas: np.ndarray
    ) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
        flat = _as_rows(deltas)
        adj = flat + self.residuals.take(ids, flat.shape[1])
        if self.enc == Q8:
            q, scales = quantize_q8(adj)
            delivered = dequantize_q8(q, scales)
        else:
            q = scales = None
            delivered = bf16_roundtrip(adj)
        self.residuals.put(ids, adj - delivered)
        return (
            delivered.reshape(np.asarray(deltas).shape), q, scales
        )


# -- WAL-record compression (the replication leg, docs/compression.md) --------


def compress_record_payload(payload, compressor: DeltaCompressor):
    """Rewrite one push-kind WAL payload with quantized deltas (error
    feedback through ``compressor``'s residuals).  Non-push payloads
    (loads, snapshots — bitwise assignments by contract) and non-dict
    payloads pass through untouched.  Returns ``(payload,
    f32_bytes, shipped_bytes)`` so the leg can count bytes saved."""
    if (
        not isinstance(payload, dict)
        or payload.get("kind", "push") != "push"
        or "deltas" not in payload
    ):
        return payload, 0, 0
    ids = np.asarray(payload["ids"], np.int64)
    deltas = np.asarray(payload["deltas"], np.float32)
    if compressor.enc != Q8:
        delivered, _, _ = compressor.compress(ids, deltas)
        out = dict(payload)
        out["deltas"] = delivered.astype(np.float32)
        return out, 0, 0
    flat = _as_rows(deltas)
    adj = flat + compressor.residuals.take(ids, flat.shape[1])
    q, scales = quantize_q8(adj)
    compressor.residuals.put(ids, adj - dequantize_q8(q, scales))
    out = dict(payload)
    out.pop("deltas")
    # int8 rows keep the ORIGINAL delta shape so record_deltas can
    # hand every consumer back exactly what the f32 record would have
    out["qdeltas"] = q.reshape(deltas.shape)
    out["scales"] = scales
    return out, int(flat.nbytes), int(q.nbytes + scales.nbytes)


def record_deltas(payload: dict) -> np.ndarray:
    """The one decode seam for push-record deltas: plain f32
    (``deltas``) or quantized (``qdeltas`` + ``scales``) — every WAL
    consumer (replay, follower apply, promotion audit, migration
    tail) reads through here so a quantized record replays
    deterministically everywhere."""
    if "qdeltas" in payload:
        q = np.asarray(payload["qdeltas"], np.int8)
        return dequantize_q8(
            q.reshape(q.shape[0], -1),
            np.asarray(payload["scales"], np.float32),
        ).reshape(q.shape)
    return np.asarray(payload["deltas"], np.float32)


__all__ = [
    "BF16",
    "DeltaCompressor",
    "MAX_Q8_ROWS",
    "Q8",
    "ResidualStore",
    "bf16_roundtrip",
    "compress_record_payload",
    "dequantize_q8",
    "q8_from_payload",
    "q8_payload",
    "quantize_q8",
    "record_deltas",
]
