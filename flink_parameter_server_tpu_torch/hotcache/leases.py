"""Shard-side lease bookkeeping + the wire-option idioms both ends share.

A copy of ``flink_parameter_server_tpu/hotcache/leases.py`` (host numpy
and the stdlib; no device work).

A **lease** is the shard's promise to *tell* a client when a cached row
changes: the client reads a hot row once (the ``lease`` verb — an
atomic read + grant), serves it locally, and the shard queues an
invalidation for that client's session the moment any OTHER writer
pushes the key.  The invalidation is **piggybacked**: the shard never
dials a client (the line protocol is strictly request/response), it
appends a trailing ``inv=<id1,id2,...>`` token to the NEXT response it
sends that session — and since a training worker or serving reader
contacts its shards every round, revocation lands within one round of
the conflicting write.

Correctness does NOT depend on the piggyback arriving.  The client
enforces the staleness bound locally (``cache.HotRowCache``: an entry
older than ``bound`` ticks is never served), so a lost invalidation —
partition, shard restart, evicted session — costs freshness inside the
bound, never a bound violation.  That is what lets the board be
in-memory and best-effort: :meth:`LeaseBoard.drop_all` (epoch flip,
restart) simply queues a drop-everything marker (``inv=*``) for every
session it still remembers.

Protocol-versioning contract (PR 6): every option rides as a trailing
``key=value`` token, which old servers parse-and-ignore and old
clients never send — both directions stay compatible.  The one NEW
parsing obligation is on lease-capable clients: a response line may
now end with ``inv=...`` tokens, stripped by
:func:`split_response_options` (scanned from the end; only keys in
``RESPONSE_OPTION_KEYS`` are consumed, so a b64 payload's ``=``
padding can never be mis-eaten).
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

# response-side trailing options a lease-capable client strips.  The
# scan is allowlist-keyed: anything else (payload tokens, ok-line
# fields like seq=) stays in the body untouched.
RESPONSE_OPTION_KEYS = frozenset({"inv"})

# how many invalidated ids one response token may carry; a larger
# backlog collapses to the drop-everything marker instead of an
# unbounded line
INV_BATCH = 64
DROP_ALL = "*"


def split_response_options(resp: str) -> Tuple[str, Dict[str, str]]:
    """``(body, opts)`` — strip trailing ``key=value`` tokens whose key
    is in :data:`RESPONSE_OPTION_KEYS` from a response line.  The scan
    walks tokens from the END and stops at the first non-option token,
    so payloads (which may contain ``=`` inside ``b64:...`` padding)
    are never consumed."""
    opts: Dict[str, str] = {}
    rest = resp
    while True:
        head, sep, tail = rest.rpartition(" ")
        if not sep:
            break
        key, eq, val = tail.partition("=")
        if not eq or key not in RESPONSE_OPTION_KEYS:
            break
        opts[key] = val
        rest = head
    return rest, opts


def parse_inv_token(val: str) -> Optional[np.ndarray]:
    """Decode one ``inv=`` value: ``None`` means drop-everything
    (``*``), otherwise the invalidated global ids."""
    if val == DROP_ALL:
        return None
    return np.asarray(
        [int(t) for t in val.split(",") if t.strip()], np.int64
    )


class LeaseBoard:
    """Per-shard lease registry: who holds which key, and which
    revocations are still waiting to piggyback out.

    Thread-safe behind its own lock; :meth:`note_write` is called
    under the shard lock (shard → board nesting, one direction only —
    board methods never call back into the shard).  Sessions are
    bounded: past ``max_sessions`` the least-recently-contacted
    session is evicted wholesale — its client simply stops receiving
    invalidations and falls back to the client-side staleness bound,
    which is the safety net for every lost-invalidation path.
    """

    def __init__(
        self,
        *,
        shard: Optional[int] = None,
        max_sessions: int = 64,
        max_keys_per_session: int = 4096,
        inv_batch: int = INV_BATCH,
        registry=None,
    ):
        self._lock = threading.Lock()
        # sess -> {gid: None} (insertion-ordered set); outer dict
        # insertion order doubles as the LRU (touched sessions are
        # re-inserted at the end)
        self._grants: Dict[str, Dict[int, None]] = {}
        # sess -> pending invalidations; DROP_ALL supersedes ids
        self._pending: Dict[str, object] = {}
        self.max_sessions = int(max_sessions)
        self.max_keys_per_session = int(max_keys_per_session)
        self.inv_batch = int(inv_batch)
        self.leases_granted = 0
        self.invalidations_queued = 0
        self.sessions_evicted = 0
        if registry is not False:
            from ..telemetry.registry import get_registry

            reg = registry if registry is not None else get_registry()
            labels = {"shard": str(shard)} if shard is not None else {}
            self._c_granted = reg.counter(
                "hotcache_leases_granted_total", component="hotcache",
                **labels,
            )
            self._c_inv = reg.counter(
                "hotcache_invalidations_total", component="hotcache",
                **labels,
            )
            reg.gauge(
                "hotcache_leases_active", component="hotcache",
                fn=self.active_leases, **labels,
            )
        else:
            self._c_granted = self._c_inv = None

    # -- the grant/revoke surface -------------------------------------------
    def _touch(self, sess: str) -> Dict[int, None]:
        """The session's grant set, moved to the LRU tail; new sessions
        may evict the head."""
        held = self._grants.pop(sess, None)
        if held is None:
            held = {}
            while len(self._grants) >= self.max_sessions:
                evicted, _ = next(iter(self._grants.items()))
                del self._grants[evicted]
                self._pending.pop(evicted, None)
                self.sessions_evicted += 1
        self._grants[sess] = held
        return held

    def grant(self, sess: str, ids: Iterable[int]) -> int:
        """Register leases for ``sess`` over ``ids``; returns how many
        are now held.  Idempotent per (sess, id)."""
        n = 0
        with self._lock:
            held = self._touch(str(sess))
            for gid in np.asarray(ids, np.int64).reshape(-1):
                held[int(gid)] = None
                n += 1
            # per-session cap: oldest grants fall off — the client's
            # bound covers them, the shard just stops tracking
            while len(held) > self.max_keys_per_session:
                held.pop(next(iter(held)))
            self.leases_granted += n
        if self._c_granted is not None and n:
            self._c_granted.inc(n)
        return n

    def revoke(self, sess: str, ids=None) -> int:
        """Client-requested release (the ``revoke`` verb): drop the
        session's grants for ``ids`` (None = all) — no invalidation is
        queued (the client asked)."""
        with self._lock:
            held = self._grants.get(str(sess))
            if held is None:
                return 0
            if ids is None:
                n = len(held)
                del self._grants[str(sess)]
                self._pending.pop(str(sess), None)
                return n
            n = 0
            for gid in np.asarray(ids, np.int64).reshape(-1):
                if held.pop(int(gid), -1) is None:
                    n += 1
            return n

    # -- the write path (called under the shard lock) ------------------------
    def note_write(self, ids, writer: Optional[str] = None) -> int:
        """A write landed on ``ids``: queue an invalidation for every
        OTHER session holding a lease on any of them and drop those
        grants (re-reading re-leases).  The writer's own session is
        skipped — it invalidated its local copy at push time."""
        queued = 0
        with self._lock:
            if not self._grants:
                return 0
            written = set(
                int(g) for g in np.asarray(ids, np.int64).reshape(-1)
            )
            for sess, held in self._grants.items():
                if writer is not None and sess == writer:
                    continue
                hit = written & held.keys()
                if not hit:
                    continue
                for gid in hit:
                    del held[gid]
                pend = self._pending.get(sess)
                if pend is DROP_ALL:
                    continue
                if pend is None:
                    pend = self._pending[sess] = set()
                pend.update(hit)
                queued += len(hit)
                if len(pend) > self.inv_batch * 4:
                    # runaway backlog: collapse to drop-everything
                    self._pending[sess] = DROP_ALL
            self.invalidations_queued += queued
        if self._c_inv is not None and queued:
            self._c_inv.inc(queued)
        return queued

    def drop_all(self) -> None:
        """Epoch flip / shard restart: every remembered session gets a
        drop-everything marker on its next contact; all grants are
        forgotten (post-flip reads re-lease under the new map)."""
        with self._lock:
            for sess in self._grants:
                self._pending[sess] = DROP_ALL
            for held in self._grants.values():
                held.clear()

    # -- the piggyback (called per response, outside the shard lock) ---------
    def take_invalidations(self, sess: str) -> Optional[str]:
        """The ``inv=`` token value owed to ``sess`` (``"*"``, a
        comma-joined id list capped at ``inv_batch`` — the rest stays
        queued for the next response), or None when nothing is
        pending.  The binary framing piggybacks this exact value as a
        ``T_INV`` TLV (utils/frames.py) — one grammar, two
        carriages, both decoded by :func:`parse_inv_token`."""
        with self._lock:
            pend = self._pending.get(str(sess))
            if pend is None:
                return None
            if pend is DROP_ALL:
                del self._pending[str(sess)]
                return DROP_ALL
            batch = sorted(pend)[: self.inv_batch]
            for gid in batch:
                pend.discard(gid)
            if not pend:
                del self._pending[str(sess)]
            return ",".join(str(g) for g in batch)

    # -- reads ---------------------------------------------------------------
    def active_leases(self) -> int:
        with self._lock:
            return sum(len(h) for h in self._grants.values())

    def sessions(self) -> int:
        with self._lock:
            return len(self._grants)

    def holds(self, sess: str, gid: int) -> bool:
        with self._lock:
            held = self._grants.get(str(sess))
            return held is not None and int(gid) in held

    def leased_ids(self) -> np.ndarray:
        """Every currently-leased global id (union over sessions) —
        what the tiered store pins hot (tierstore/): a leased row is
        an invalidation promise, so demoting it buys nothing.  Callers
        may hold the shard lock (this lock nests strictly under it)."""
        with self._lock:
            if not self._grants:
                return np.zeros(0, np.int64)
            ids = set()
            for held in self._grants.values():
                ids.update(held)
            return np.fromiter(ids, np.int64, len(ids))

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "sessions": len(self._grants),
                "leases_active": sum(
                    len(h) for h in self._grants.values()
                ),
                "leases_granted": self.leases_granted,
                "invalidations_queued": self.invalidations_queued,
                "sessions_evicted": self.sessions_evicted,
                "pending_sessions": len(self._pending),
            }


__all__ = [
    "DROP_ALL",
    "INV_BATCH",
    "LeaseBoard",
    "RESPONSE_OPTION_KEYS",
    "parse_inv_token",
    "split_response_options",
]
