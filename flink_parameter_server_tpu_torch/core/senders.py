"""Combination (batching) senders for the event backend.

Counterpart of ``flink_parameter_server_tpu/core/senders.py``, copied (it
is framework-neutral).  The reference system's combination senders buffer
messages and flush on a count and/or a timer trigger (SURVEY.md §2 #6).
On the batched path the microbatch is the combination buffer, so this
module serves only the host event backend: it reproduces the observable
semantics of batching (bursty delivery, reordering across the flush
boundary).  The "timer" is the event loop's logical clock (one tick per
delivered event), so runs are deterministic.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class SenderPolicy:
    """Flush policy for a buffering sender.

    count: flush when this many messages are buffered (1 = simple sender,
    i.e. the reference's non-combination variant).
    interval: also flush every `interval` logical ticks of the event loop
    (None = count-only).
    """

    count: int = 1
    interval: Optional[int] = None

    def __post_init__(self):
        assert self.count >= 1
        assert self.interval is None or self.interval >= 1


SIMPLE = SenderPolicy(count=1)


class BufferingSender:
    """Accumulates outgoing messages; ``poll``/``force`` return what to
    deliver now.  Used for both directions (client→PS and PS→worker)."""

    def __init__(self, policy: SenderPolicy):
        self.policy = policy
        self.buffer: List = []
        self.last_flush_tick = 0

    def offer(self, message, tick: int) -> List:
        self.buffer.append(message)
        if len(self.buffer) >= self.policy.count:
            return self.flush(tick)
        return []

    def poll(self, tick: int) -> List:
        """Timer check: flush if the interval elapsed."""
        if (
            self.policy.interval is not None
            and self.buffer
            and tick - self.last_flush_tick >= self.policy.interval
        ):
            return self.flush(tick)
        return []

    def flush(self, tick: int) -> List:
        out, self.buffer = self.buffer, []
        self.last_flush_tick = tick
        return out


__all__ = ["SenderPolicy", "BufferingSender", "SIMPLE"]
