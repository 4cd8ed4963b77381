"""Timeline plane — the windowed-percentile helper.

Of the reference's ``telemetry/timeline.py`` only
:func:`percentile_from_counts` is ported: the delta-window percentile math
the elastic controller reads its windowed pull-RTT p99 with
(``elastic/controller.py``).  It is a copy of the reference's function,
which imports no JAX.  The ``TimelineRecorder``, the ``SkewTracker`` and
the online detectors wait for their ROADMAP Queue 1 #7 item (the
telemetry endpoint and the adaptive runtime read them).
"""
from __future__ import annotations


def percentile_from_counts(bounds, counts, q: float) -> float:
    """The registry histogram's in-bin interpolation
    (:meth:`~.registry.Histogram.percentile`) applied to an arbitrary
    bucket-count vector — typically a DELTA window between two polls.
    ``counts`` is non-cumulative with the overflow bin last; the
    overflow bin clamps to the largest finite boundary."""
    total = sum(counts)
    if total == 0:
        return 0.0
    rank = q / 100.0 * total
    seen = 0.0
    for i, c in enumerate(counts):
        if seen + c >= rank and c > 0:
            if i == len(bounds):
                return bounds[-1]
            lo = 0.0 if i == 0 else bounds[i - 1]
            frac = (rank - seen) / c
            return lo + (bounds[i] - lo) * min(1.0, max(0.0, frac))
        seen += c
    return bounds[-1]


__all__ = ["percentile_from_counts"]
