"""Hot-work re-balancing away from persistent stragglers.

A copy of ``flink_parameter_server_tpu/adaptive/rebalance.py`` (host
numpy over the port's partitioner and ``ops/hashing.fmix32_np``, so the
routes are the reference's bit for bit).

Two actuators, both deliberately conservative (rate-limited and
cooldown-gated so transient skew never moves data):

* :class:`WorkRouter` — WORKER-side: re-route ``worker_key`` row
  groups from a persistently slow worker to a fast one.  Ownership
  stays a pure function of ``(key, round)``: the default route is the
  driver's static ``fmix32(key) % num_workers`` hash, moves reassign a
  ``(default_owner, subgroup)`` slice to a new owner from a FUTURE
  ``effective_round``, and every worker evaluates batch ``t`` with the
  same ``t`` — so each row has exactly one owner per round even while
  a move lands, and zero moves is bitwise the stock routing.

* :class:`DrainedHashPartitioner` — SHARD-side: a weighted rendezvous
  variant of :class:`~..cluster.partition.ConsistentHashPartitioner`
  whose per-shard weights scale the HRW scores.  A weight < 1 only
  ever LOWERS the drained shard's argmax, so keys move exclusively
  OFF that shard (the drain property the elastic migration plane
  relies on); feeding the old/new pair to ``plan_moves`` /
  ``execute_moves`` reuses the entire verified migration path.

:class:`RebalancePolicy` is the decision half: a worker must stay
flagged for ``persist_evals`` consecutive evaluations before any move,
moves are capped at ``max_moves`` per run, and a ``cooldown_s`` gap
separates consecutive moves.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..cluster.partition import _GOLDEN, ConsistentHashPartitioner
from ..ops.hashing import fmix32_np


class WorkRouter:
    """Round-versioned ``worker_key`` group ownership.

    Groups are ``(default_owner, subgroup)`` with both halves derived
    from the same key hash (``subgroups`` slices per worker), so a
    move shifts ~``1/subgroups`` of the straggler's rows at a time.
    """

    def __init__(self, num_workers: int, *, subgroups: int = 8):
        if num_workers < 1:
            raise ValueError(f"num_workers={num_workers}: must be >= 1")
        if subgroups < 1:
            raise ValueError(f"subgroups={subgroups}: must be >= 1")
        self.num_workers = int(num_workers)
        self.subgroups = int(subgroups)
        self._lock = threading.Lock()
        # (src_worker, subgroup) -> (dst_worker, effective_round),
        # rebuilt as an immutable tuple on every change so worker
        # threads read one consistent version without the lock
        self._moves: Tuple[Tuple[int, int, int, int], ...] = ()
        self.moves_applied = 0

    # -- routing (worker threads) ------------------------------------------
    def _route(self, keys: np.ndarray, round_idx: int) -> np.ndarray:
        with np.errstate(over="ignore"):
            h = fmix32_np(np.asarray(keys, np.int64).astype(np.uint32))
        owner = (h % np.uint32(self.num_workers)).astype(np.int32)
        moves = self._moves
        if not moves:
            return owner
        sub = ((h // np.uint32(self.num_workers))
               % np.uint32(self.subgroups)).astype(np.int32)
        for src, grp, dst, eff in moves:
            if round_idx >= eff:
                owner = np.where(
                    (owner == src) & (sub == grp), np.int32(dst), owner
                )
        return owner

    def owner_mask(
        self, keys: np.ndarray, worker: int, round_idx: int
    ) -> np.ndarray:
        return self._route(keys, round_idx) == np.int32(worker)

    # -- control (the adaptive runtime) ------------------------------------
    def shift(
        self, src: int, dst: int, *, effective_round: int,
        groups: int = 1,
    ) -> List[dict]:
        """Reassign ``groups`` of ``src``'s not-yet-moved subgroups to
        ``dst`` starting at ``effective_round`` (pick a round safely in
        the future: past rounds must never change owner retroactively).
        Returns one record per group actually moved."""
        if not (0 <= src < self.num_workers
                and 0 <= dst < self.num_workers) or src == dst:
            raise ValueError(f"shift {src}->{dst}: bad worker pair")
        records: List[dict] = []
        with self._lock:
            taken = {g for s, g, _, _ in self._moves if s == src}
            free = [g for g in range(self.subgroups) if g not in taken]
            for grp in free[: max(0, int(groups))]:
                self._moves = self._moves + (
                    (src, grp, dst, int(effective_round)),
                )
                self.moves_applied += 1
                records.append({
                    "action": "reroute",
                    "src": src,
                    "dst": dst,
                    "group": grp,
                    "effective_round": int(effective_round),
                })
        return records

    def assignments(self) -> List[dict]:
        return [
            {"src": s, "group": g, "dst": d, "effective_round": e}
            for s, g, d, e in self._moves
        ]


class DrainedHashPartitioner(ConsistentHashPartitioner):
    """Rendezvous partitioner with per-shard weights on the scores.

    ``weights[i] < 1`` drains shard ``i``: scaling only that shard's
    scores down can change the argmax solely for keys it used to win,
    so every key either stays put or leaves the drained shard — keys
    never shuffle between healthy shards (property-tested in
    tests/test_adaptive.py).
    """

    def __init__(
        self, capacity: int, num_shards: int, *, seed: int = 0,
        weights=None,
    ):
        super().__init__(capacity, num_shards, seed=seed)
        w = (np.ones(self.num_shards) if weights is None
             else np.asarray(weights, np.float64))
        if w.shape != (self.num_shards,):
            raise ValueError(
                f"weights shape {w.shape} != ({self.num_shards},)"
            )
        if (w < 0).any() or not (w > 0).any():
            raise ValueError("weights must be >= 0 with at least one > 0")
        self.weights = w

    @classmethod
    def draining(
        cls, part: ConsistentHashPartitioner, shard: int,
        weight: float = 0.0,
    ) -> "DrainedHashPartitioner":
        """``part`` with ``shard``'s weight lowered to ``weight``."""
        w = np.ones(part.num_shards)
        w[shard] = float(weight)
        return cls(part.capacity, part.num_shards, seed=part.seed,
                   weights=w)

    def shard_of(self, ids) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        if ((ids < 0) | (ids >= self.capacity)).any():
            raise ValueError(
                f"ids outside [0, {self.capacity}) cannot be routed"
            )
        with np.errstate(over="ignore"):
            k = (ids.astype(np.uint32) * _GOLDEN)[..., None]
            scores = fmix32_np(k ^ self._salts)
        return np.argmax(
            scores.astype(np.float64) * self.weights, axis=-1
        ).astype(np.int32)


class RebalancePolicy:
    """Move work only for *persistent* stragglers.

    ``observe`` is called once per evaluation with the set of flagged
    workers; a worker earns a re-route only after ``persist_evals``
    CONSECUTIVE flagged evaluations, at most ``max_moves`` moves per
    run, and never within ``cooldown_s`` of the previous move.
    """

    def __init__(
        self,
        router: Optional[WorkRouter],
        *,
        persist_evals: int = 3,
        cooldown_s: float = 5.0,
        max_moves: int = 4,
        groups_per_move: int = 1,
        round_delay: int = 2,
    ):
        if persist_evals < 1:
            raise ValueError(f"persist_evals={persist_evals}: must be >= 1")
        self.router = router
        self.persist_evals = int(persist_evals)
        self.cooldown_s = float(cooldown_s)
        self.max_moves = int(max_moves)
        self.groups_per_move = int(groups_per_move)
        self.round_delay = int(round_delay)
        self._streak: Dict[int, int] = {}
        self._last_move_t: Optional[float] = None
        self.moves = 0

    def observe(
        self, flagged: Dict[int, float], now: float, current_round: int
    ) -> List[dict]:
        router = self.router
        if router is None:
            return []
        for w in list(self._streak):
            if w not in flagged:
                del self._streak[w]
        decisions: List[dict] = []
        for w in flagged:
            self._streak[w] = self._streak.get(w, 0) + 1
            if self._streak[w] < self.persist_evals:
                continue  # transient skew: no migration
            if self.moves >= self.max_moves:
                continue
            if (self._last_move_t is not None
                    and now - self._last_move_t < self.cooldown_s):
                continue
            dst = self._pick_dst(w, flagged)
            if dst is None:
                continue
            recs = router.shift(
                w, dst,
                effective_round=current_round + self.round_delay,
                groups=self.groups_per_move,
            )
            if recs:
                self.moves += 1
                self._last_move_t = now
                self._streak[w] = 0
                decisions.extend(recs)
        return decisions

    def _pick_dst(
        self, src: int, flagged: Dict[int, float]
    ) -> Optional[int]:
        """Least-loaded healthy destination: the unflagged worker
        currently owning the fewest re-routed groups."""
        router = self.router
        healthy = [
            w for w in range(router.num_workers)
            if w != src and w not in flagged
        ]
        if not healthy:
            return None
        owned = {w: 0 for w in healthy}
        for rec in router.assignments():
            if rec["dst"] in owned:
                owned[rec["dst"]] += 1
        return min(healthy, key=lambda w: (owned[w], w))


__all__ = ["WorkRouter", "DrainedHashPartitioner", "RebalancePolicy"]
