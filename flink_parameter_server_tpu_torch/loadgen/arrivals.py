"""Open-loop arrival schedules — the honest half of a load test.

A copy of ``flink_parameter_server_tpu/loadgen/arrivals.py``, which imports
no JAX: the port imports nothing of the JAX package, whose ``__init__``
imports JAX.  Modules it names that the port does not have yet are the
reference's.

A closed-loop load generator couples arrivals to completions: when the
system stalls, the generator politely stops offering load, and the
recorded latencies hide exactly the stall being measured (coordinated
omission — the same lie the honest residuals exist to prevent in
the latency budget).  Everything here is OPEN loop: arrival times are
drawn up front from a seeded stochastic process, independent of any
response, and the soak harness (:mod:`.soak`) measures every request's
latency against its *scheduled arrival*, so a backlog shows up as tail
latency instead of silently thinning the offered load.

Three composable pieces:

  * **rate curves** — plain ``rate(t) -> requests/sec`` callables:
    :func:`constant_rate`, :func:`diurnal_rate` (a raised-cosine
    day/night swing — the morning-ramp/overnight-idle shape the
    elastic controller must track), :func:`ramp_rate` (linear sweep,
    the capacity-probe shape) and :func:`flash_crowds` (multiplicative
    spikes layered on any base curve — the celebrity-event shape);
  * **the process** — :func:`poisson_arrivals` draws a non-homogeneous
    Poisson arrival vector from any rate curve by thinning (Lewis &
    Shedler): memoryless inter-arrivals, seeded, so the same seed
    yields the same schedule on any host;
  * **the split** — :func:`split_slots` deals a schedule round-robin
    to N generator threads while every request keeps its ABSOLUTE
    arrival time (the per-thread view of one global schedule, not N
    independent schedules).

Everything is stdlib + numpy; nothing here touches the cluster.
"""
from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import numpy as np

RateFn = Callable[[float], float]


def constant_rate(rps: float) -> Tuple[RateFn, float]:
    """``(rate_fn, rate_max)`` for a flat offered load."""
    if rps <= 0:
        raise ValueError(f"rps={rps}: must be > 0")
    r = float(rps)
    return (lambda t: r), r


def diurnal_rate(
    low_rps: float, high_rps: float, period_s: float, *,
    phase: float = 0.0,
) -> Tuple[RateFn, float]:
    """Raised-cosine day/night curve: ``low`` at t=0 (+phase), peaking
    at ``high`` half a period later — the morning ramp the autoscaler
    is scored against, compressed to whatever period the soak runs."""
    if not 0 < low_rps <= high_rps:
        raise ValueError(
            f"need 0 < low ({low_rps}) <= high ({high_rps})"
        )
    if period_s <= 0:
        raise ValueError(f"period_s={period_s}: must be > 0")
    lo, hi, p = float(low_rps), float(high_rps), float(period_s)

    def rate(t: float) -> float:
        return lo + (hi - lo) * 0.5 * (
            1.0 - math.cos(2.0 * math.pi * (t / p + phase))
        )

    return rate, hi


def ramp_rate(
    start_rps: float, end_rps: float, duration_s: float
) -> Tuple[RateFn, float]:
    """Linear sweep from ``start`` to ``end`` over ``duration`` (held
    at ``end`` past it) — the capacity-probe shape."""
    if start_rps <= 0 or end_rps <= 0:
        raise ValueError("rates must be > 0")
    s, e, d = float(start_rps), float(end_rps), float(duration_s)

    def rate(t: float) -> float:
        if t >= d:
            return e
        return s + (e - s) * (t / d)

    return rate, max(s, e)


def flash_crowds(
    base: RateFn, base_max: float,
    spikes: Sequence[Tuple[float, float, float]],
) -> Tuple[RateFn, float]:
    """Layer ``(at_s, duration_s, multiplier)`` spikes onto any base
    curve — the flash-crowd shape (a linked celebrity, a market open).
    Overlapping spikes multiply."""
    sp = [(float(a), float(d), float(m)) for a, d, m in spikes]
    for a, d, m in sp:
        if d <= 0 or m <= 0:
            raise ValueError(f"spike ({a}, {d}, {m}): need d > 0, m > 0")

    def rate(t: float) -> float:
        r = base(t)
        for a, d, m in sp:
            if a <= t < a + d:
                r *= m
        return r

    worst = base_max
    for _a, _d, m in sp:
        worst = max(worst, base_max * m)
    return rate, worst


def poisson_arrivals(
    rate_fn: RateFn, rate_max: float, duration_s: float, *, seed: int = 0
) -> np.ndarray:
    """Non-homogeneous Poisson arrival offsets in ``[0, duration_s)``,
    by thinning: draw a homogeneous process at ``rate_max``, keep each
    point with probability ``rate(t) / rate_max``.  Seeded and
    host-independent — the schedule IS the experiment's identity."""
    if rate_max <= 0 or duration_s <= 0:
        raise ValueError("rate_max and duration_s must be > 0")
    rng = np.random.default_rng(seed)
    out: List[float] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / rate_max))
        if t >= duration_s:
            break
        r = rate_fn(t)
        if r > rate_max * (1.0 + 1e-9):
            raise ValueError(
                f"rate_fn({t:.3f}) = {r} exceeds rate_max={rate_max}; "
                f"thinning needs a true upper bound"
            )
        if rng.random() < r / rate_max:
            out.append(t)
    return np.asarray(out, np.float64)


def split_slots(arrivals: np.ndarray, n: int) -> List[np.ndarray]:
    """Deal one global arrival schedule to ``n`` generator threads
    round-robin; every request keeps its absolute arrival offset."""
    if n < 1:
        raise ValueError(f"n={n}: must be >= 1")
    return [np.asarray(arrivals[t::n], np.float64) for t in range(n)]


__all__ = [
    "RateFn",
    "constant_rate",
    "diurnal_rate",
    "flash_crowds",
    "poisson_arrivals",
    "ramp_rate",
    "split_slots",
]
