"""Lock-order witness — the runtime oracle behind fpsanalyze L001.

A copy of ``flink_parameter_server_tpu/telemetry/lockwitness.py`` (stdlib
only); :func:`capture` wraps the locks created under this package by
default.  No module of the package imports it.

The static pass (``tools/fpsanalyze``) derives the lock-acquisition
graph from the AST; this module derives the SAME graph from live
execution, so the two cross-check each other the way the PR-7 latency
budget was checked against its span oracle: a cycle the static
analysis misses (dynamic dispatch, monkeypatching, a lock passed
through three layers) still trips the witness, and a static cycle that
never executes is visibly absent from the witnessed order.

Mechanics: a :class:`WitnessedLock` wraps a real ``threading.Lock`` /
``RLock``.  Each thread keeps its held-stack; acquiring ``B`` while
holding ``A`` records the edge ``A → B`` into one global partial
order.  If ``B ⇝ A`` already exists, that acquisition INVERTS the
established order — the classic deadlock precondition — and the
witness records it (or raises :class:`LockInversion` in strict mode).

Identity is the lock's **creation site** (``module.qualname:line``),
matching fpsanalyze's class-level lock identity: every instance of
``ParamShard._lock`` shares one node, so an inversion between two
shard instances' locks is still an inversion of the same order the
static rule reasons about.  Re-acquiring a name already held by the
current thread is treated as re-entrant (no edge, no inversion) — the
conservative choice for RLocks and for sibling instances from one
site; it can mask, never fabricate.

Opt-in and zero-cost when off: nothing in the package imports this
module on the hot path.  Tests wrap a workload with::

    from flink_parameter_server_tpu_torch.telemetry import lockwitness

    with lockwitness.capture() as w:      # patches threading.Lock/RLock
        ...build shards/clients, run traffic...
    assert w.inversions == []             # the tier-1 oracle

``capture`` only wraps locks whose creating frame lives under the
package (stdlib/torch internals keep their real locks — wrapping a lock
that ``threading.Condition`` wants to ``_release_save`` mid-``wait``
needs the delegation below, and there is no reason to pay it for
foreign code).
"""
from __future__ import annotations

import contextlib
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "LockInversion",
    "LockWitness",
    "WitnessedLock",
    "capture",
]


class LockInversion(RuntimeError):
    """Strict-mode signal: this acquisition inverted the established
    lock order (a ``B ⇝ A`` path already exists while ``A`` is held
    and ``B`` is being acquired)."""


class WitnessedLock:
    """A threading.Lock/RLock wrapper that reports acquisitions to its
    witness.  Supports the ``Condition`` protocol by delegation when
    the inner lock does (``_release_save``/``_acquire_restore``/
    ``_is_owned``)."""

    def __init__(self, inner, name: str, witness: "LockWitness"):
        self._inner = inner
        self._name = name
        self._witness = witness

    # -- core protocol -----------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            inv = self._witness._on_acquire(self._name)
            if inv is not None and self._witness.raise_on_inversion:
                # release before raising: a raised acquisition must not
                # leave the lock wedged
                self._witness._on_release(self._name)
                self._inner.release()
                raise LockInversion(inv)
        return got

    def release(self):
        self._witness._on_release(self._name)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    # -- Condition-protocol delegation -------------------------------------
    def _release_save(self):
        self._witness._on_release_all(self._name)
        if hasattr(self._inner, "_release_save"):
            return self._inner._release_save()
        self._inner.release()
        return None

    def _acquire_restore(self, state):
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        self._witness._on_acquire(self._name, check=False)

    def _is_owned(self):
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        # plain Lock heuristic (mirrors threading.Condition's fallback)
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __repr__(self):
        return f"<WitnessedLock {self._name} of {self._inner!r}>"


class LockWitness:
    """The global partial order + per-thread held stacks."""

    def __init__(self, raise_on_inversion: bool = False):
        self.raise_on_inversion = raise_on_inversion
        # real, unwrapped lock: the witness must never witness itself
        self._glock = threading._allocate_lock()
        self._edges: Dict[str, Set[str]] = {}
        self._tls = threading.local()
        self.inversions: List[dict] = []
        self.acquisitions = 0  # total witnessed acquires (liveness)

    # -- wrapping ----------------------------------------------------------
    def wrap(self, lock, name: str) -> WitnessedLock:
        return WitnessedLock(lock, name, self)

    def edges(self) -> Dict[str, Set[str]]:
        with self._glock:
            return {a: set(bs) for a, bs in self._edges.items()}

    # -- bookkeeping -------------------------------------------------------
    def _held(self) -> List[List]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st  # list of [name, count], innermost last

    def _path_exists(self, src: str, dst: str) -> bool:
        """True when src ⇝ dst in the recorded order (caller holds
        _glock)."""
        seen = {src}
        frontier = [src]
        while frontier:
            n = frontier.pop()
            if n == dst:
                return True
            for nxt in self._edges.get(n, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        return False

    def _on_acquire(self, name: str,
                    check: bool = True) -> Optional[str]:
        stack = self._held()
        for entry in stack:
            if entry[0] == name:
                entry[1] += 1  # re-entrant (RLock / sibling instance)
                return None
        inversion: Optional[str] = None
        if check and stack:
            held_names = [e[0] for e in stack]
            with self._glock:
                self.acquisitions += 1
                for h in held_names:
                    if h == name:
                        continue
                    if self._path_exists(name, h):
                        inversion = (
                            f"lock-order inversion: acquiring "
                            f"{name!r} while holding {h!r}, but the "
                            f"witnessed order already has "
                            f"{name!r} ⇝ {h!r}"
                        )
                        self.inversions.append({
                            "acquiring": name,
                            "holding": h,
                            "thread": threading.current_thread().name,
                        })
                    else:
                        self._edges.setdefault(h, set()).add(name)
        else:
            with self._glock:
                self.acquisitions += 1
        stack.append([name, 1])
        return inversion

    def _on_release(self, name: str) -> None:
        stack = self._held()
        for entry in reversed(stack):
            if entry[0] == name:
                entry[1] -= 1
                if entry[1] <= 0:
                    stack.remove(entry)
                return
        # releasing a lock this thread never witnessed acquiring (it
        # was acquired before capture started): ignore

    def _on_release_all(self, name: str) -> None:
        stack = self._held()
        for entry in reversed(stack):
            if entry[0] == name:
                stack.remove(entry)
                return


def _creation_site(depth: int = 2) -> str:
    f = sys._getframe(depth)
    code = f.f_code
    qual = getattr(code, "co_qualname", code.co_name)
    mod = f.f_globals.get("__name__", "?")
    return f"{mod}.{qual}:{f.f_lineno}"


@contextlib.contextmanager
def capture(
    raise_on_inversion: bool = False,
    include: Tuple[str, ...] = ("flink_parameter_server_tpu_torch",),
    witness: Optional[LockWitness] = None,
):
    """Patch ``threading.Lock``/``threading.RLock`` so every lock
    CREATED inside the block by a module under ``include`` is
    witnessed, named by its creation site.  Locks created elsewhere
    (stdlib, torch) stay real.  Yields the :class:`LockWitness`;
    restores the factories on exit.  Objects built inside the block
    keep their witnessed locks afterwards — harmless (the wrapper is
    a thin passthrough once the test stops reading the witness)."""
    w = witness if witness is not None else LockWitness(
        raise_on_inversion
    )
    real_lock, real_rlock = threading.Lock, threading.RLock

    def _should_wrap() -> bool:
        mod = sys._getframe(2).f_globals.get("__name__", "")
        return any(
            mod == p or mod.startswith(p + ".") for p in include
        )

    def make_lock():
        inner = real_lock()
        if not _should_wrap():
            return inner
        return w.wrap(inner, _creation_site(2))

    def make_rlock():
        inner = real_rlock()
        if not _should_wrap():
            return inner
        return w.wrap(inner, _creation_site(2))

    threading.Lock = make_lock
    threading.RLock = make_rlock
    try:
        yield w
    finally:
        threading.Lock = real_lock
        threading.RLock = real_rlock
