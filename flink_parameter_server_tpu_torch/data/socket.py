"""Unbounded socket text source — the ``socketTextStream`` stand-in.

A copy of ``flink_parameter_server_tpu/data/socket.py``, which imports
no JAX: the port imports nothing of the JAX package, whose ``__init__``
imports JAX.  Modules it names that the port does not have yet are the
reference's.

Reference parity: Flink's canonical unbounded-source demo reads
newline-delimited text from a TCP socket (``env.socketTextStream``), and
the reference's streaming jobs are written against exactly that kind of
source (SURVEY.md §1 L1, §5 "Config / examples parse args or
hardcode").  This module is the rebuild's host-side equivalent: a
generator of decoded lines, plus a bounded-buffer bridge that turns an
unbounded record stream into the fixed-shape microbatches the training
step needs.

Design notes:
  * ingestion stays on the HOST — the device only ever sees the
    fixed-shape microbatch pytrees (SURVEY.md §7 "Dynamic shapes");
  * the source is a plain generator, so every downstream tool
    (``microbatches`` via :func:`batches_from_records`, ``prefetch``,
    the event backend's per-record loop) composes unchanged;
  * end-of-stream is EXPLICIT (peer closes the connection), not a
    silence timeout — the reference's ``iterationWaitTime`` hack is
    deliberately not reproduced (SURVEY.md §3.5).
"""
from __future__ import annotations

import socket
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np


def socket_text_stream(
    host: str,
    port: int,
    *,
    encoding: str = "utf-8",
    errors: str = "replace",
    connect_timeout: float = 10.0,
    max_line_bytes: int = 1 << 20,
    reconnect: bool = True,
    max_reconnects: int = 8,
    backoff_base_s: float = 0.05,
    backoff_cap_s: float = 5.0,
    backoff_seed: int = 0,
) -> Iterator[str]:
    """Yield newline-delimited lines from a TCP server until the peer
    closes CLEANLY.  The trailing partial line (no newline before EOF)
    is yielded too — matching file semantics, so a line-oriented
    producer never silently loses its last record.

    Reconnect (``reconnect=True``, the default): an ABRUPT connection
    failure — reset, broken pipe, timeout, refused connect — no longer
    kills the unbounded job it feeds (the exact weakness the reference's
    socket jobs had); the stream re-dials with capped exponential
    backoff + full jitter, up to ``max_reconnects`` CONSECUTIVE failed
    attempts (the streak resets once a reconnected socket delivers
    bytes), then raises the last error.  The returned iterator exposes
    a ``reconnects`` counter (successful re-dials — the observability
    hook, like ``batches_from_records.dropped``).  A clean peer close
    (EOF) is still the explicit end-of-stream — never retried.  A
    partial line buffered when the connection drops abruptly is
    DISCARDED (its tail is unrecoverable; a half-record must not be
    yielded as a record) — producers that need exactly-once should
    sequence-number their lines.  ``reconnect=False`` preserves the old
    die-on-error behavior.

    ``errors="replace"`` (the default) maps undecodable bytes to U+FFFD
    instead of raising: one corrupt byte must not kill an unbounded
    streaming job — the mangled line then fails ``parse`` downstream
    and is *counted* (``batches_from_records.dropped``), which is the
    observable place for it.  Pass ``errors="strict"`` to crash on
    corruption instead.

    ``max_line_bytes`` bounds the reassembly buffer: a producer that
    never sends a newline would otherwise grow it without limit."""
    return _SocketLineStream(
        host, port, encoding=encoding, errors=errors,
        connect_timeout=connect_timeout, max_line_bytes=max_line_bytes,
        reconnect=reconnect, max_reconnects=max_reconnects,
        backoff_base_s=backoff_base_s, backoff_cap_s=backoff_cap_s,
        backoff_seed=backoff_seed,
    )


class _SocketLineStream:
    """Iterator with a visible ``reconnects`` counter (the socket-side
    sibling of ``_RecordBatcher.dropped``)."""

    def __init__(self, host, port, *, encoding, errors, connect_timeout,
                 max_line_bytes, reconnect, max_reconnects,
                 backoff_base_s, backoff_cap_s, backoff_seed):
        self.reconnects = 0
        self._gen = self._run(
            host, port, encoding, errors, connect_timeout, max_line_bytes,
            reconnect, max_reconnects, backoff_base_s, backoff_cap_s,
            backoff_seed,
        )

    def _run(self, host, port, encoding, errors, connect_timeout,
             max_line_bytes, reconnect, max_reconnects, backoff_base_s,
             backoff_cap_s, backoff_seed):
        rng = np.random.default_rng(backoff_seed)
        failures = 0  # consecutive failed dial/read attempts
        connected_once = False
        while True:
            try:
                s = socket.create_connection(
                    (host, port), timeout=connect_timeout
                )
            except OSError as e:
                if not reconnect:
                    raise
                failures += 1
                if failures > max_reconnects:
                    raise ConnectionError(
                        f"socket source gave up after {max_reconnects} "
                        f"consecutive failed reconnect attempts to "
                        f"{host}:{port}"
                    ) from e
                time.sleep(self._backoff(failures, backoff_base_s,
                                         backoff_cap_s, rng))
                continue
            if connected_once:
                self.reconnects += 1
                # unified plane: re-dials are a recovery signal the
                # run report rolls up (telemetry/report.py "reconnects")
                from ..telemetry.registry import get_registry

                get_registry().counter(
                    "ingest_reconnects_total", component="ingest"
                ).inc()
            connected_once = True
            buf = b""
            got_bytes = False
            try:
                with s:
                    # liveness beats latency here: the batcher downstream
                    # absorbs jitter, so no artificial read timeout once
                    # connected
                    s.settimeout(None)
                    while True:
                        chunk = s.recv(1 << 16)
                        if not chunk:
                            # clean EOF: the EXPLICIT end-of-stream —
                            # flush the trailing partial line and stop
                            if buf:
                                yield buf.decode(encoding, errors)
                            return
                        got_bytes = True
                        failures = 0  # live again: reset the streak
                        buf += chunk
                        if len(buf) > max_line_bytes and b"\n" not in buf:
                            raise ValueError(
                                f"socket line exceeded {max_line_bytes} "
                                f"bytes with no newline — not a "
                                f"line-delimited stream?"
                            )
                        *lines, buf = buf.split(b"\n")
                        for ln in lines:
                            yield ln.decode(encoding, errors)
            except OSError as e:
                if not reconnect:
                    raise
                # abrupt death mid-stream: drop the partial line (its
                # tail is gone), back off, re-dial
                if not got_bytes:
                    failures += 1
                if failures > max_reconnects:
                    raise ConnectionError(
                        f"socket source gave up after {max_reconnects} "
                        f"consecutive failed reconnect attempts to "
                        f"{host}:{port}"
                    ) from e
                time.sleep(self._backoff(max(1, failures), backoff_base_s,
                                         backoff_cap_s, rng))

    @staticmethod
    def _backoff(attempt, base, cap, rng):
        # capped exponential with full jitter (decorrelates a fleet of
        # consumers re-dialing one recovered producer)
        return float(rng.uniform(0.0, min(cap, base * (2 ** (attempt - 1)))))

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)


def batches_from_records(
    records: Iterator[Any],
    batch_size: int,
    parse: Callable[[Any], Optional[Dict[str, Any]]],
    *,
    pad_value: int = 0,
    drop_remainder: bool = False,
) -> Iterator[Dict[str, np.ndarray]]:
    """Bridge an UNBOUNDED record stream to fixed-shape microbatches.

    ``parse(record)`` returns a dict of scalars/arrays for one event, or
    ``None`` to drop the record (bad lines must not kill a streaming
    job — they are counted on the returned iterator's ``.dropped``
    attribute instead).  Batches are emitted as soon as ``batch_size``
    records accumulate — no epoch/shuffle machinery, because an
    unbounded stream has neither.  The final partial batch is zero-
    padded with a ``"mask"`` column (static shapes — SURVEY.md §7), or
    dropped with ``drop_remainder=True``.
    """
    return _RecordBatcher(records, batch_size, parse, pad_value,
                          drop_remainder)


class _RecordBatcher:
    """Iterator with a visible ``dropped`` malformed-record counter."""

    def __init__(self, records, batch_size, parse, pad_value,
                 drop_remainder):
        self.dropped = 0
        self._gen = self._run(records, batch_size, parse, pad_value,
                              drop_remainder)

    def _run(self, records, batch_size, parse, pad_value, drop_remainder):
        rows: List[Dict[str, Any]] = []
        expected_keys = None
        for rec in records:
            parsed = None
            try:
                parsed = parse(rec)
            except Exception:
                # ANY parse failure is a malformed record: count +
                # continue.  A narrower catch list (ValueError, ...)
                # would let a TypeError/AttributeError from one bad
                # line kill the whole unbounded job — the exact crash
                # this bridge exists to absorb.  The .dropped counter
                # keeps failures observable.
                pass
            if parsed is None:
                self.dropped += 1
                continue
            # Per-row key validation (not just rows[0]): a parse() that
            # returns inconsistent dict keys across records would
            # otherwise raise an uncaught KeyError at stack time —
            # killing the unbounded job this bridge exists to protect.
            # Inconsistent rows are malformed records: count + continue.
            if "mask" in parsed:
                # reserved-name misuse is a PROGRAMMING error on every
                # row it appears on, not stream corruption — stay loud
                # (checked per row, so a row-3-only 'mask' no longer
                # slips past the old rows[0]-only guard)
                raise ValueError(
                    "'mask' is reserved for the padding mask; have "
                    "parse() return the column under another name"
                )
            if expected_keys is None:
                expected_keys = frozenset(parsed)
            elif frozenset(parsed) != expected_keys:
                self.dropped += 1
                continue
            rows.append(parsed)
            if len(rows) == batch_size:
                yield self._stack(rows, batch_size, pad_value)
                rows = []
        if rows and not drop_remainder:
            yield self._stack(rows, batch_size, pad_value)

    @staticmethod
    def _stack(rows, batch_size, pad_value):
        if "mask" in rows[0]:
            # the padding mask is written below under this exact name;
            # silently clobbering a parse-produced column would train
            # with a wrong mask
            raise ValueError(
                "'mask' is reserved for the padding mask; have parse() "
                "return the column under another name"
            )
        batch: Dict[str, np.ndarray] = {}
        n = len(rows)
        for k in rows[0]:
            col = np.asarray([r[k] for r in rows])
            if n < batch_size:
                pad = np.full(
                    (batch_size - n,) + col.shape[1:], pad_value, col.dtype
                )
                col = np.concatenate([col, pad])
            batch[k] = col
        batch["mask"] = np.arange(batch_size) < n
        return batch

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)


__all__ = ["socket_text_stream", "batches_from_records"]
