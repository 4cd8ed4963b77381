"""compression/ — quantized delta push path + hierarchical aggregation.

Copies of the reference's ``compression/quantizers.py`` (per-row-scaled
int8 and bf16 wire formats with host-side error-feedback residuals) and
``compression/aggregator.py`` (the two-level aggregation tree combining
co-located workers' deltas into one push per shard per round).  Both are
numpy on the host: shard worker processes decode ``q8`` frames through
this package without touching torch's device side.
"""
from .aggregator import PushAggregator
from .quantizers import (
    BF16,
    MAX_Q8_ROWS,
    Q8,
    DeltaCompressor,
    ResidualStore,
    bf16_roundtrip,
    compress_record_payload,
    dequantize_q8,
    q8_from_payload,
    q8_payload,
    quantize_q8,
    record_deltas,
)

__all__ = [
    "BF16",
    "DeltaCompressor",
    "MAX_Q8_ROWS",
    "PushAggregator",
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
