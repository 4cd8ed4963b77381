"""StreamingDriver — the job runtime around the transform loop.

Port of ``flink_parameter_server_tpu/training/driver.py``, layered on the
port's :func:`..core.transform.transform_batched` (one loop, hooked — not
duplicated):

  * step metrics (updates/sec, pull→push latency percentiles),
  * periodic checkpoints + resume (``training/checkpoint``), with cursor
    fast-forward,
  * the write-ahead update log (``resilience/wal``) and the NaN guard,
  * optional ``torch.profiler`` tracing of steady-state steps,
  * close-time model dump, host prefetch.

Where the port differs from the reference: the step updates the table
and the worker state IN PLACE (the reference's jitted step donates the
buffers), so whatever keeps them past a step — a checkpoint — copies them
to the host first; ``rng`` is a ``torch.Generator``; the metrics sync
synchronises the store's device.  ``serve_with`` waits for the serving
port (ROADMAP Queue 1 #6).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Iterable, Optional

import numpy as np
import torch

from ..core.batched import BatchedWorkerLogic
from ..core.store import ShardedParamStore
from ..core.transform import TransformResult, transform_batched, tree_leaves, tree_map
from ..data.streams import prefetch as prefetch_iter
from ..telemetry.registry import get_registry
from ..telemetry.spans import SpanTracer, get_tracer
from . import checkpoint as ckpt
from .metrics import StepMetrics
from .tracing import profile_trace


class TrainingDiverged(RuntimeError):
    """Raised by the driver's NaN guard (DriverConfig.nan_check_every).

    ``step`` carries the dispatch-boundary step the guard fired at — the
    supervisor (``resilience/recovery.py``) needs it to size the input
    window it must skip (the window *caused* the divergence; replaying
    it would re-diverge deterministically)."""

    def __init__(self, message: str, step: int = 0):
        super().__init__(message)
        self.step = step


def _all_finite(*trees) -> torch.Tensor:
    """One device-side finiteness reduction over every floating leaf of
    the given trees: a 0-d bool tensor, read with a single host transfer
    at the caller's ``bool()``."""
    checks = [
        torch.isfinite(leaf).all()
        for tree in trees
        for leaf in tree_leaves(tree)
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
    ]
    if not checks:
        return torch.tensor(True)
    return torch.stack(checks).all()


def _host_batch(batch):
    """The batch as the WAL logs it: host arrays only (a CUDA tensor from
    the source is copied out, so reading the log never needs the card)."""
    return tree_map(
        lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x, batch
    )


@dataclasses.dataclass
class DriverConfig:
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0  # steps; 0 = only on close
    metrics_every: int = 0  # steps between metric emissions; 0 = off.
    # Metrics force a per-step device sync (accurate latency); with
    # metrics_every=0 the loop free-runs (bench mode).
    profile_dir: Optional[str] = None
    # (after_step, last_step): the trace is entered after relative step
    # `after_step` completes and covers steps after_step+1 .. last_step.
    profile_steps: tuple = (10, 13)
    prefetch: int = 2
    dump_model: bool = True
    # Failure detection: every N steps, verify the step outputs, the table
    # and the worker state are finite; on NaN/inf raise TrainingDiverged —
    # with a checkpoint_dir configured the driver rolls back to the last
    # durable checkpoint (the crash-recovery path).  0 = off.
    nan_check_every: int = 0
    # Periodic saves return after the device→host copy; the disk write
    # runs on a thread, overlapping the next training steps.
    async_checkpoints: bool = False
    # Batch presort (core/transform.make_train_step): sort each microbatch
    # by store key on the device before the pull.  Metrics count events
    # via the mask (order-independent) and checkpoints see step
    # boundaries; only per-record OUTPUT order changes.
    presort: bool = False
    # K microbatches per call (core/transform's grouped path).  The driver
    # runs its envelope at DISPATCH granularity: between grouped steps
    # there is no table to act on, so checkpoint/nan/metrics cadences
    # round UP to the next group boundary (a cadence of 10 with K=4 fires
    # at steps 12, 20, 24, ...), metrics latency percentiles time
    # dispatches (K steps each), and the profile window covers whole
    # dispatches.
    steps_per_call: int = 1
    # Preemption-safe shutdown: on any of these signals the driver stops
    # feeding batches, finishes the in-flight microbatches, checkpoints,
    # and run() returns the partial result — a later resume() + run()
    # continues from the cursor.  Handlers are installed only for the
    # duration of run() (main thread only) and the previous handlers are
    # restored after.
    stop_signals: tuple = ()
    # Write-ahead update log (resilience/wal.py): every microbatch
    # consumed from the source is appended (on the ingest edge, BEFORE
    # the step applies it) and each checkpoint save truncates the log —
    # recovery replays checkpoint + tail instead of losing the window.
    # None = off (zero cost).
    wal_dir: Optional[str] = None
    wal_segment_bytes: int = 16 << 20
    wal_fsync_every: int = 1  # records between fsyncs; 0 = never
    wal_max_bytes: Optional[int] = None  # soft budget (warns when over)
    # Telemetry plane (telemetry/): step/event counters, the pull→push
    # latency histogram and live gauges publish to the process-wide
    # MetricsRegistry, and the host-side phases — ingest wait, WAL append,
    # the pull/compute/push dispatch, checkpoint save — are recorded as
    # wall-clock spans on the default SpanTracer.  False = zero-touch.
    telemetry: bool = True


class StreamingDriver:
    """Run a PS job: ``driver = StreamingDriver(logic, store); driver.run(data)``.

    Resume semantics: after :meth:`resume`, the next :meth:`run` call
    fast-forwards its input iterator by the restored step cursor — i.e.
    re-feed the SAME logical stream from the beginning and the driver
    skips what was already consumed.  Pass ``fast_forward=False`` to feed
    a fresh stream instead.
    """

    def __init__(
        self,
        logic: BatchedWorkerLogic,
        store: ShardedParamStore,
        *,
        config: Optional[DriverConfig] = None,
        rng: Optional[torch.Generator] = None,
        metrics_sink=None,
        health=None,
        registry=None,
    ):
        self.logic = logic
        self.store = store
        self.config = config if config is not None else DriverConfig()
        self.rng = rng if rng is not None else torch.Generator().manual_seed(0)
        self.metrics_sink = metrics_sink
        self.metrics: Optional[StepMetrics] = None
        # telemetry plane: an explicit registry always wins; otherwise
        # the process-wide default when config.telemetry, else nothing.
        # The tracer mirrors the same switch (a disabled tracer's
        # span() is a shared no-op — call sites stay unconditional).
        if registry is not None:
            self.registry = registry
        else:
            self.registry = get_registry() if self.config.telemetry else None
        self.tracer = (
            get_tracer() if self.config.telemetry
            else SpanTracer(capacity=1, enabled=False)
        )
        self.step_idx = 0
        self._state = None
        self._pending_skip = 0
        self._stop_requested = False
        # resilience wiring: an optional HealthMonitor beaten from the
        # ingest and train threads (resilience/health.py), user group
        # hooks (chaos injection and friends), and the update WAL
        self.health = health
        self._group_hooks = []
        self._last_ckpt_step: Optional[int] = None
        self._wal = None
        if self.config.wal_dir is not None:
            from ..resilience.wal import UpdateWAL

            self._wal = UpdateWAL(
                self.config.wal_dir,
                segment_bytes=self.config.wal_segment_bytes,
                fsync_every=self.config.wal_fsync_every,
                max_bytes=self.config.wal_max_bytes,
            )
        self._ckpt_mgr: Optional[ckpt.JobCheckpointManager] = None
        if self.config.checkpoint_dir is not None:
            self._ckpt_mgr = ckpt.JobCheckpointManager(
                self.config.checkpoint_dir,
                use_async=self.config.async_checkpoints,
            )

    # -- checkpoint/resume -------------------------------------------------
    # Step-directory checkpoints: each save commits atomically to its own
    # step dir (a crash mid-write can never destroy the previous durable
    # checkpoint), old steps are pruned, and async mode overlaps disk
    # writes with training.

    def save(self) -> None:
        if self._ckpt_mgr is None:
            return
        # force: an explicit save must land even if this step was already
        # checkpointed (the manager otherwise skips duplicate steps)
        with self.tracer.span("checkpoint", component="train"):
            self._ckpt_mgr.save(
                self.step_idx, self.store, self._state, force=True
            )
            self._ckpt_mgr.wait()  # the explicit save() contract is durable
        if self.registry is not None:
            self.registry.counter(
                "checkpoints_total", component="train"
            ).inc()
        if self._wal is not None:
            # same one-checkpoint lag as the periodic path: the last
            # interval's WAL stays as the corrupt-latest fallback's
            # replay source.  Anchor on the RETAINED steps, not the
            # in-memory tracker: a close-time save re-saving the final
            # periodic step would otherwise truncate through itself and
            # strip the fallback's coverage.
            steps = self._ckpt_mgr.all_steps()
            if len(steps) >= 2:
                self._wal.truncate_through(steps[-2])
        self._last_ckpt_step = self.step_idx

    @property
    def wal(self):
        """The driver's UpdateWAL (None unless config.wal_dir is set) —
        the supervisor's replay handle."""
        return self._wal

    def add_group_hook(self, hook) -> None:
        """Register ``hook(global_step, n_steps, table, state, outs)``,
        called once per dispatch on the training thread, after the
        dispatch's updates were applied and before the checkpoint / NaN
        cadences run.  ``table`` and ``state`` are the LIVE tensors the
        next step updates in place: a hook that keeps them must copy.
        This is the injection point chaos testing uses
        (resilience/chaos.py)."""
        self._group_hooks.append(hook)

    def request_stop(self) -> None:
        """Programmatic preemption: the current ``run`` stops feeding
        batches, drains in-flight microbatches, checkpoints, and returns
        its partial result (same path as ``stop_signals``)."""
        self._stop_requested = True

    def serve_with(self, service=None, **service_kwargs):
        """Train-while-serve: waits for the serving port."""
        raise NotImplementedError(
            "StreamingDriver.serve_with needs the serving modules, which are "
            "not ported yet: ROADMAP Queue 1 #6"
        )

    def resume(self) -> bool:
        """Restore (store, worker state, step cursor) from the latest
        durable checkpoint if one exists, onto the device the driver's
        store is on; returns True on restore.  See the class docstring for
        how the cursor interacts with the next ``run``."""
        if self._ckpt_mgr is None:
            return False
        restored = self._ckpt_mgr.restore_latest(
            self.store.spec, self.store.table.device
        )
        if restored is None:
            return False
        self.store, self._state, meta = restored
        self.step_idx = int(meta.get("step", 0))
        self._pending_skip = self.step_idx
        return True

    # -- the loop ----------------------------------------------------------
    def run(
        self,
        data: Iterable,
        collect_outputs: bool = False,
        fast_forward: bool = True,
    ) -> TransformResult:
        cfg = self.config
        spec = self.store.spec
        device = self.store.table.device
        start_step = self.step_idx
        skip = self._pending_skip if fast_forward else 0
        self._pending_skip = 0
        self._stop_requested = False  # a fresh run clears a prior stop

        event_counts: "collections.deque" = collections.deque()

        tracer = self.tracer
        c_ingest = c_wal = None
        if self.registry is not None:
            c_ingest = self.registry.counter(
                "ingest_batches_total", component="ingest"
            )
            c_wal = self.registry.counter(
                "wal_appends_total", component="ingest"
            )

        def counting(source, skipped):
            src = iter(source)
            n = 0
            while True:
                if self._stop_requested:
                    # preemption: stop feeding; the batches already in
                    # the prefetch queue drain, then the loop closes
                    # normally (close-time save below persists the state)
                    return
                # the span makes a frozen source VISIBLE on the host
                # timeline: a long `ingest` bar next to idle dispatches
                with tracer.span("ingest", component="ingest"):
                    try:
                        b = next(src)
                    except StopIteration:
                        return
                if n >= skipped:  # skipped batches never reach the callback
                    if isinstance(b, dict) and "mask" in b:
                        mask = b["mask"]
                        events = mask.sum() if isinstance(mask, torch.Tensor) else np.asarray(mask).sum()
                        event_counts.append(int(events))
                    else:
                        event_counts.append(len(tree_leaves(b)[0]))
                    if c_ingest is not None:
                        c_ingest.inc()
                    if self._wal is not None:
                        # WRITE-AHEAD: durable before the step applies it
                        # (this runs on the ingest/prefetch thread, ahead
                        # of the dispatch that consumes the batch).  Step
                        # numbering matches group_callback below; appends
                        # are idempotent by step, so a recovery replay
                        # re-feeding logged batches through this same path
                        # is a no-op.
                        with tracer.span("wal_append", component="ingest"):
                            self._wal.append(
                                start_step - skip + n, 1, _host_batch(b)
                            )
                        if c_wal is not None:
                            c_wal.inc()
                    if self.health is not None:
                        self.health.beat("ingest")
                n += 1
                yield b

        it = counting(iter(data), skip)
        if cfg.prefetch:
            it = prefetch_iter(it, cfg.prefetch)

        sync_steps = cfg.metrics_every > 0 and device.type == "cuda"
        trace_ctx = {"cm": None}
        first_step_of_run = [True]
        # dispatch-span boundary: from here (or the previous callback's
        # exit) to the next callback's entry is one pull→compute→push
        # dispatch window as the HOST experiences it — recorded
        # retroactively because the step itself lives inside
        # transform_batched (wrapping it would mean forking the loop)
        t_boundary = [time.perf_counter()]

        def group_callback(first_idx, n_steps, table, state, outs):
            # One invocation per DISPATCH (n_steps == 1 when
            # steps_per_call == 1; n_steps == K for grouped calls, where
            # cadences round up to the boundary).
            if sync_steps:
                torch.cuda.synchronize(device)
            tracer.record(
                "pull_compute_push", t_boundary[0], time.perf_counter(),
                component="train",
            )
            prev_global = start_step - skip + first_idx
            global_step = prev_global + n_steps
            events = sum(
                event_counts.popleft() if event_counts else 0
                for _ in range(n_steps)
            )
            if self.metrics is None:
                self.metrics = StepMetrics(
                    events_per_step=events // max(1, n_steps),
                    registry=self.registry,
                )
            if first_step_of_run[0]:
                # this run's first dispatch start was never timestamped
                # (and any previous run's dangling step_start would fold
                # inter-run idle time into the latency window) — count,
                # don't time
                first_step_of_run[0] = False
                self.metrics.count_untimed(n_steps, events)
                self.metrics.step_start()
            else:
                # latency percentiles time DISPATCHES (n_steps steps
                # each); totals still count steps and events exactly
                self.metrics.step_end(events, n_steps=n_steps)
                self.metrics.step_start()
            self.step_idx = global_step
            if self.health is not None:
                self.health.beat("train")
            for hook in self._group_hooks:
                # user/chaos hooks see the applied dispatch before the
                # checkpoint cadence runs — a hook that raises here
                # models the worst-case crash point (updates applied,
                # boundary's checkpoint not yet taken)
                hook(global_step, n_steps, table, state, outs)

            def crossed(every):
                # did (prev_global, global_step] cross a multiple of
                # `every`?  == `global_step % every == 0` when n_steps == 1
                return every and (global_step // every) > (prev_global // every)

            if (
                cfg.profile_dir
                and trace_ctx["cm"] is None
                and not trace_ctx.get("done")
                and global_step - start_step >= cfg.profile_steps[0]
            ):
                trace_ctx["cm"] = profile_trace(cfg.profile_dir)
                trace_ctx["cm"].__enter__()
            elif (
                trace_ctx["cm"] is not None
                and global_step - start_step >= cfg.profile_steps[1]
            ):
                trace_ctx["cm"].__exit__(None, None, None)
                trace_ctx["cm"] = None
                trace_ctx["done"] = True
            is_ckpt_step = crossed(cfg.checkpoint_every)
            if crossed(cfg.nan_check_every) or (
                cfg.nan_check_every and is_ckpt_step
            ):
                # check table+state too (outputs may carry no floats), as
                # ONE device reduction + a single host transfer; always
                # check on checkpoint steps so a poisoned table is never
                # persisted as the "recovery" point.  `outs` may be
                # (K, ...)-stacked — the reduction covers every step.
                if not bool(_all_finite(outs, table, state)):
                    raise TrainingDiverged(
                        f"non-finite step output/params at step "
                        f"{global_step}",
                        step=global_step,
                    )
            if crossed(cfg.metrics_every):
                self.metrics.emit(self.metrics_sink)
            if is_ckpt_step:
                # Save from the live tensors WITHOUT stashing them on self:
                # the next step updates them in place.  Both save modes
                # copy the data to the host before returning (the sync
                # path writes fully; the async path writes on a thread).
                if self._ckpt_mgr is not None:
                    with tracer.span("checkpoint", component="train"):
                        self._ckpt_mgr.save(
                            global_step, ShardedParamStore(spec, table),
                            state,
                        )
                    if self.registry is not None:
                        self.registry.counter(
                            "checkpoints_total", component="train"
                        ).inc()
                    if self._wal is not None and self._last_ckpt_step is not None:
                        # Bound the WAL at the checkpoint cadence — lagging
                        # ONE checkpoint behind, deliberately: (a) an async
                        # save may still be in flight here, and (b) if the
                        # newest checkpoint proves corrupt at restore time,
                        # restore_latest falls back one step and the kept
                        # WAL interval still replays the difference —
                        # corrupt-latest stays lossless.
                        self._wal.truncate_through(self._last_ckpt_step)
                    self._last_ckpt_step = global_step
            # next dispatch's span starts AFTER this callback's overhead
            # (hooks/checkpoint carry their own spans)
            t_boundary[0] = time.perf_counter()

        prev_handlers = {}
        if cfg.stop_signals:
            import signal as _signal
            import threading

            def _request_stop(signum, frame):
                self._stop_requested = True

            if threading.current_thread() is threading.main_thread():
                try:
                    for s in cfg.stop_signals:
                        prev_handlers[s] = _signal.signal(s, _request_stop)
                except BaseException:
                    # partial install must not leak handlers past run()
                    for s, h in prev_handlers.items():
                        # None = prior handler installed from C (see the
                        # restore in the finally block below)
                        _signal.signal(
                            s, _signal.SIG_DFL if h is None else h
                        )
                    raise
            # non-main threads can't install handlers; the flag can still
            # be set externally via request_stop()

        try:
            result = transform_batched(
                it,
                self.logic,
                self.store,
                rng=self.rng,
                collect_outputs=collect_outputs,
                dump_model=cfg.dump_model,
                group_callback=group_callback,
                initial_state=self._state,
                skip_batches=skip,
                presort=cfg.presort,
                steps_per_call=cfg.steps_per_call,
            )
        except BaseException:
            # transform_batched worked on copies, so self.store is intact;
            # reload the last durable checkpoint anyway, so that a driver
            # after a crash holds what the reference's does (its donated
            # buffers are gone, and it reloads).
            if self._ckpt_mgr is not None:
                self.resume()
            raise
        finally:
            if prev_handlers:
                import signal as _signal

                for s, h in prev_handlers.items():
                    # A prior handler installed from C reads back as None;
                    # SIG_DFL is the closest restorable state and avoids
                    # leaking _request_stop past run().
                    _signal.signal(s, _signal.SIG_DFL if h is None else h)
            if trace_ctx["cm"] is not None:
                trace_ctx["cm"].__exit__(None, None, None)

        self.store = result.store
        self._state = result.worker_state
        self.save()
        return result


__all__ = ["DriverConfig", "StreamingDriver", "TrainingDiverged"]
