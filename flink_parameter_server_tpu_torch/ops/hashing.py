"""Vectorised uint32 hash families for the sketches and id spreading.

Counterpart of ``flink_parameter_server_tpu/ops/hashing.py``: the
murmur3 finalizer over ``a·x + b`` with uint32 wraparound, bit for bit.
torch's ``uint32`` lacks most arithmetic on both devices, so every value
here is a uint32 held in an ``int64`` tensor and masked with
``0xFFFFFFFF`` after each add and multiply.  A product of two uint32s
can pass 2**63, so :func:`_mul32` multiplies in two 16-bit halves, whose
products fit in 48 bits; only the low 32 bits are kept, and those are
the uint32 product's.  Shifts are taken on non-negative values, where
``>>`` is the logical shift.  ``%`` and the comparisons then act on the
unsigned values, as the reference's do.

:func:`fmix32_np` and :func:`hash_params` are numpy on the host, copied
from the reference, so the constants and the host-side routing agree.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_MIX1 = np.uint32(0x85EBCA6B)
_MIX2 = np.uint32(0xC2B2AE35)
_GOLDEN = np.uint32(0x9E3779B1)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """The uint32 view of integer ids (``x.astype(uint32)``), as int64."""
    return x.to(torch.int64) & _M32


def _mul32(a, x: torch.Tensor) -> torch.Tensor:
    """``(a * x) mod 2**32`` for uint32 values ``a`` (int or tensor) and
    ``x``, without an int64 overflow."""
    lo = (a & 0xFFFF) * x
    hi = ((a >> 16) * x) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(int(_MIX1), h)
    h = h ^ (h >> 13)
    h = _mul32(int(_MIX2), h)
    return h ^ (h >> 16)


def fmix32_np(h: np.ndarray) -> np.ndarray:
    """Host-side (numpy) murmur3 finalizer, the reference's own: input
    coerced to uint32, wraparound is the hash."""
    with np.errstate(over="ignore"):
        h = np.asarray(h).astype(np.uint32)
        h ^= h >> np.uint32(16)
        h = (h * _MIX1).astype(np.uint32)
        h ^= h >> np.uint32(13)
        h = (h * _MIX2).astype(np.uint32)
        h ^= h >> np.uint32(16)
    return h


def hash_params(num_hashes: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-hash (a, b) uint32 constants (a odd), deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    a = rng.integers(1, 2**32, num_hashes, dtype=np.uint64).astype(np.uint32) | 1
    b = rng.integers(0, 2**32, num_hashes, dtype=np.uint64).astype(np.uint32)
    return a, b


def _family(x: torch.Tensor, a: np.ndarray, b: np.ndarray) -> torch.Tensor:
    """(..., num_hashes) ``fmix32(a_i·x + b_i)``."""
    a_t = torch.as_tensor(a.astype(np.int64), device=x.device)
    b_t = torch.as_tensor(b.astype(np.int64), device=x.device)
    return _fmix32((_mul32(a_t, _u32(x).unsqueeze(-1)) + b_t) & _M32)


def bucket_hash(x: torch.Tensor, a: np.ndarray, b: np.ndarray, m: int) -> torch.Tensor:
    """``h_i(x) = fmix32(a_i·x + b_i) mod m`` for every hash i: (...,
    num_hashes) int32 buckets in [0, m)."""
    return (_family(x, a, b) % m).to(torch.int32)


def sign_hash(x: torch.Tensor, a: np.ndarray, b: np.ndarray) -> torch.Tensor:
    """±1 per (x, hash i), from the hash's top bit: (..., num_hashes)
    float32."""
    top = _family(x, a, b) >> 31
    return (1 - 2 * top).to(torch.float32)


def pair_key(x: torch.Tensor, y: torch.Tensor, num_keys: int) -> torch.Tensor:
    """Key of the unordered pair (x, y) in [0, num_keys), int32.  The min
    and max are taken on the ids as given (signed), then read as uint32."""
    lo = _u32(torch.minimum(x, y))
    hi = _u32(torch.maximum(x, y))
    k = _fmix32((_mul32(int(_GOLDEN), hi) + lo) & _M32)
    return (k % num_keys).to(torch.int32)


def permute_ids(ids: torch.Tensor, capacity: int, seed: int = 0x5BD1) -> torch.Tensor:
    """Bijective spreading of ids over [0, capacity), a power of two: an
    odd-multiplier affine map mod 2**k.  int32."""
    if capacity <= 0 or capacity & (capacity - 1):
        raise ValueError(f"permute_ids requires power-of-two capacity, got {capacity}")
    a = ((((seed << 1) | 1) * 0x9E3779B1) & _M32) | 1
    h = (_mul32(a, _u32(ids)) + 0x7F4A7C15) & _M32
    return (h & (capacity - 1)).to(torch.int32)


__all__ = [
    "fmix32_np",
    "hash_params",
    "bucket_hash",
    "sign_hash",
    "pair_key",
    "permute_ids",
]
