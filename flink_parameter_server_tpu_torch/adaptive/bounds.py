"""Per-worker dynamic SSP bounds.

A copy of ``flink_parameter_server_tpu/adaptive/bounds.py`` (host code)
over the port's :class:`~..cluster.clock.StalenessClock`.

The straggler study (arXiv 2308.15482) shows a single global SSP bound
is the wrong dial under skew: small ``k`` stalls the whole fleet on
one slow worker, large ``k`` blows staleness for everyone all the
time.  :class:`AdaptiveClock` keeps the *declared* bound as the
correctness floor and adds a per-worker ALLOWANCE: ``allowance[v]`` is
how many rounds the rest of the fleet may lead worker ``v``.  Widening
the allowance of the one flagged straggler un-stalls the fast workers
without relaxing consistency between any two healthy workers; the
ceiling caps worst-case staleness.

Gate (evaluated under the clock condvar): worker ``w`` may start its
next round iff for every active worker ``v``::

    clocks[w] - clocks[v] <= allowance[v]

With every allowance equal to the base bound this is exactly the stock
``StalenessClock`` gate (``clocks[w] - min(active) <= bound``).

:class:`BoundPolicy` is the decision half: it maps SkewTracker
verdicts to widen/narrow actions, widening immediately on a flagged
worker (proportional to the observed skew ratio) and narrowing only
after ``clear_evals`` consecutive clean evaluations — hysteresis so a
noisy ratio hovering at the threshold cannot make the bound flap.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..cluster.clock import StalenessClock


class AdaptiveClock(StalenessClock):
    """:class:`StalenessClock` with per-worker staleness allowances.

    ``bound`` is the correctness floor (allowances never drop below
    it); ``bound_ceiling`` the hard cap (never exceeded, enforced by
    clamping in :meth:`set_allowance`).  ``bound=None`` (async) keeps
    the never-block semantics and makes allowances moot.
    """

    def __init__(
        self,
        num_workers: int,
        bound: Optional[int] = 0,
        *,
        bound_ceiling: Optional[int] = None,
    ):
        super().__init__(num_workers, bound)
        if self.bound is None:
            ceiling = None
        else:
            ceiling = self.bound if bound_ceiling is None else int(bound_ceiling)
            if ceiling < self.bound:
                raise ValueError(
                    f"bound_ceiling={ceiling} < bound={self.bound}: the "
                    "ceiling may never undercut the correctness bound"
                )
        self.bound_ceiling = ceiling
        base = 0 if self.bound is None else self.bound
        self._allowance = [base] * self.num_workers

    # -- gate --------------------------------------------------------------
    def _clear_locked(self, worker: int) -> bool:
        c = self._clocks[worker]
        for v in range(self.num_workers):
            if not self._active[v]:
                continue
            if c - self._clocks[v] > self._allowance[v]:
                return False
        return True

    # -- control surface ---------------------------------------------------
    def set_allowance(self, worker: int, bound: int) -> int:
        """Set how far the fleet may lead ``worker``.  Clamped to
        ``[bound, bound_ceiling]``; returns the effective value.  A
        widen wakes blocked waiters immediately."""
        if self.bound is None:
            return 0
        want = int(bound)
        eff = max(self.bound, min(self.bound_ceiling, want))
        with self._cond:
            prev = self._allowance[worker]
            self._allowance[worker] = eff
            if eff > prev:
                self._cond.notify_all()
        return eff

    def allowance(self, worker: int) -> int:
        with self._cond:
            return self._allowance[worker]

    def effective_bounds(self) -> List[int]:
        with self._cond:
            return list(self._allowance)

    def snapshot(self) -> Dict[str, object]:
        snap = super().snapshot()
        snap["allowances"] = self.effective_bounds()
        snap["bound_ceiling"] = self.bound_ceiling
        return snap


class BoundPolicy:
    """Maps skew verdicts to per-worker allowance moves.

    * widen: a flagged worker's allowance jumps toward
      ``ceil(ratio × bound)``, at least one step, capped at the
      ceiling — applied on the SAME evaluation that flags (stalls are
      the expensive failure mode, so reaction is immediate);
    * narrow: one step down only after ``clear_evals`` consecutive
      evaluations where the worker was NOT flagged (hysteresis).
    """

    def __init__(self, clock: AdaptiveClock, *, clear_evals: int = 3):
        if clear_evals < 1:
            raise ValueError(f"clear_evals={clear_evals}: must be >= 1")
        self.clock = clock
        self.clear_evals = int(clear_evals)
        self._clean_streak = [0] * clock.num_workers
        self.widenings = 0
        self.narrowings = 0

    def observe(self, flagged: Dict[int, float]) -> List[dict]:
        """One evaluation: ``flagged`` maps worker index → skew ratio
        for workers the tracker flagged this window.  Returns decision
        records (empty when nothing moved)."""
        clock = self.clock
        if clock.bound is None:
            return []
        decisions: List[dict] = []
        base = clock.bound
        for w in range(clock.num_workers):
            cur = clock.allowance(w)
            if w in flagged:
                self._clean_streak[w] = 0
                ratio = float(flagged[w])
                want = max(cur + 1, int(-(-ratio * max(base, 1) // 1)))
                eff = clock.set_allowance(w, want)
                if eff != cur:
                    self.widenings += 1
                    decisions.append({
                        "action": "widen",
                        "worker": w,
                        "from": cur,
                        "to": eff,
                        "ratio": ratio,
                    })
            else:
                if cur <= base:
                    self._clean_streak[w] = 0
                    continue
                self._clean_streak[w] += 1
                if self._clean_streak[w] >= self.clear_evals:
                    self._clean_streak[w] = 0
                    eff = clock.set_allowance(w, cur - 1)
                    if eff != cur:
                        self.narrowings += 1
                        decisions.append({
                            "action": "narrow",
                            "worker": w,
                            "from": cur,
                            "to": eff,
                        })
        return decisions


__all__ = ["AdaptiveClock", "BoundPolicy"]
