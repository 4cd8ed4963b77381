"""Deterministic per-id parameter initializers (Threefry-2x32 in torch).

Counterpart of ``flink_parameter_server_tpu/utils/initializers.py``:
``init(ids)`` returns ``(n, *value_shape)`` values that depend only on
(seed, id), so any shard reproduces the same initial vector for an id.
The reference computes ``jax.random.uniform(fold_in(PRNGKey(seed), id))``
vmapped over uint32 ids.  This module reproduces those bits exactly:

  * ``PRNGKey(seed)`` is the key pair ``(seed >> 32, seed & 0xFFFFFFFF)``;
  * ``fold_in(key, id)`` is ``threefry2x32(key, (0, id))``;
  * the partitionable bit stream for element ``j`` of the value shape is
    ``x0 ^ x1`` where ``(x0, x1) = threefry2x32(key, (j >> 32, j))``;
  * float32 uniform takes the top 23 bits as a mantissa in ``[1, 2)``,
    subtracts 1, then scales: ``max(low, f * (high - low) + low)``.
    XLA contracts that multiply-add into one fused multiply-add, so the
    port computes it in float64 (where the float32 product is exact) and
    rounds once to float32.

torch has no full uint32 arithmetic, so the hash runs in int64 with
``& 0xFFFFFFFF`` after every add and shift.  ``normal_factor`` maps a
uniform in ``(-1, 1)`` through ``sqrt(2) * erfinv``; torch's ``erfinv``
is not XLA's, so normal draws agree to float32 rounding, not bitwise.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

InitFn = Callable[[torch.Tensor], torch.Tensor]


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(k0, k1, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) on int64 tensors holding uint32 values.

    All four arguments broadcast against each other."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _seed_key(seed: int) -> Tuple[int, int]:
    return (seed >> 32) & _M32 if seed >= 0 else 0, seed & _M32


def _random_bits(seed: int, ids: torch.Tensor, size: int) -> torch.Tensor:
    """(n, size) int64 uint32 bits of ``fold_in(PRNGKey(seed), id)``."""
    k0, k1 = _seed_key(seed)
    ids64 = ids.to(torch.int64).reshape(-1, 1) & _M32  # uint32 view of ids
    zero = torch.zeros_like(ids64)
    f0, f1 = threefry2x32(
        torch.full_like(ids64, k0), torch.full_like(ids64, k1), zero, ids64
    )
    j = torch.arange(size, dtype=torch.int64, device=ids.device).reshape(1, -1)
    b0, b1 = threefry2x32(f0, f1, j >> 32, j & _M32)
    return b0 ^ b1


def _uniform01(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from uint32 bits, as jax.random.uniform does."""
    mant = (bits >> 9) | 0x3F800000  # exponent of 1.0, random mantissa
    return mant.to(torch.int32).view(torch.float32) - 1.0


def _scale(f: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """``max(low, fma(f, high - low, low))`` in float32, one rounding."""
    lo = torch.tensor(low, dtype=torch.float32)
    span = float(torch.tensor(high, dtype=torch.float32) - lo)
    out = (f.double() * span + float(lo)).float()
    return torch.clamp_min(out, float(lo))


def _f32(x: float) -> float:
    """``x`` rounded to float32 (the reference's constants are float32)."""
    return float(torch.tensor(x, dtype=torch.float32))


def _check_dtype(dtype: torch.dtype) -> None:
    if dtype != torch.float32:
        raise TypeError(
            f"per-id initializers reproduce the reference's float32 bits; "
            f"got dtype {dtype} (initialize in float32 and cast)"
        )


def ranged_random_factor(
    seed: int,
    value_shape: Tuple[int, ...],
    *,
    low: float = -0.01,
    high: float = 0.01,
    dtype: torch.dtype = torch.float32,
) -> InitFn:
    """``init_fn(ids) -> (n, *value_shape)`` uniform in ``[low, high)``,
    deterministic per (seed, id), on ``ids.device``."""
    _check_dtype(dtype)
    size = math.prod(value_shape)

    def init(ids: torch.Tensor) -> torch.Tensor:
        out = _scale(_uniform01(_random_bits(seed, ids, size)), low, high)
        return out.reshape(tuple(ids.shape) + tuple(value_shape))

    return init


def normal_factor(
    seed: int,
    value_shape: Tuple[int, ...],
    *,
    stddev: float = 0.01,
    dtype: torch.dtype = torch.float32,
) -> InitFn:
    """``stddev * N(0, 1)`` per (seed, id): ``sqrt(2) * erfinv(u)`` of a
    uniform ``u`` in ``(-1, 1)`` drawn from the same bits as above."""
    _check_dtype(dtype)
    size = math.prod(value_shape)
    # the float32 neighbour of -1 toward 0, as the reference takes it
    lo_f = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))

    def init(ids: torch.Tensor) -> torch.Tensor:
        u = _scale(_uniform01(_random_bits(seed, ids, size)), lo_f, 1.0)
        z = torch.erfinv(u) * _f32(math.sqrt(2.0))
        out = _f32(stddev) * z
        return out.reshape(tuple(ids.shape) + tuple(value_shape))

    return init


def zeros(value_shape: Tuple[int, ...], dtype: torch.dtype = torch.float32) -> InitFn:
    def init(ids: torch.Tensor) -> torch.Tensor:
        return torch.zeros(
            tuple(ids.shape) + tuple(value_shape), dtype=dtype, device=ids.device
        )

    return init


__all__ = ["ranged_random_factor", "normal_factor", "zeros", "threefry2x32"]
