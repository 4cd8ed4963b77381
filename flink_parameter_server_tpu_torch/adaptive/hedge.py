"""Push hedging — the write-side twin of the elastic pull ``Hedger``.

A copy of ``flink_parameter_server_tpu/adaptive/hedge.py`` (host code)
over the port's :class:`~..elastic.hedging.Hedger`.

The tail-at-scale argument (Dean & Barroso) applies to pushes the same
way it applies to pulls: a round is not done until its pushes are
acked, so one dripping shard link turns every round into a tail
sample.  :class:`PushHedger` reuses the entire race machinery of
:class:`elastic.hedging.Hedger` (deferred backup, budget, spare
connection cache, loser drain) and only swaps the instruments.

Safety is STRUCTURAL, not protocol-level: the client only hedges a
push when the batch carries a push id (``pid``), because the shard's
(pid, id) exactly-once dedupe window then suppresses the duplicate
apply from whichever leg loses the race — the same window that
absorbs ambiguous-retry duplicates today.  Without a pid (no
membership plane) a duplicated delta would double-apply, so the
client refuses to hedge (see ``ClusterClient._push_shard``).
"""
from __future__ import annotations

from ..elastic.hedging import Hedger, HedgeBudget


class PushHedger(Hedger):
    """Budgeted backup pushes raced on a second connection.

    Same ``after_s``/``budget`` semantics as the pull hedger; counts
    land in ``adaptive_hedged_pushes_total`` /
    ``adaptive_push_hedges_won_total`` (component=adaptive).
    """

    def _register_counters(self, reg) -> None:
        self._c_issued = reg.counter(
            "adaptive_hedged_pushes_total", component="adaptive"
        )
        self._c_won = reg.counter(
            "adaptive_push_hedges_won_total", component="adaptive"
        )


__all__ = ["PushHedger", "HedgeBudget"]
