"""Checkpoint / resume for PS jobs.

Port of ``flink_parameter_server_tpu/training/checkpoint.py``.  The
reference writes orbax checkpoints; the port writes the same payload
(the LOGICAL table, the worker state, and ``meta`` with the step and the
capacity) with ``torch.save``, so it does not read the JAX package's
checkpoints, nor they its.  Layout::

    <path>/payload.pt                 a checkpoint written by :func:`save`
    <directory>/<step>/payload.pt     one step of a JobCheckpointManager

What orbax guarantees is kept by hand:

  * atomic commit — a step is written into a hidden temporary directory,
    fsynced, then renamed into place, so a crash mid-write never leaves a
    half-written numbered step (nor destroys the previous one);
  * retention of the newest ``max_to_keep`` steps (2);
  * a forced re-save of an existing step without a durability gap (the
    old copy is moved aside and dropped only after the new one commits);
  * the corrupt-latest fallback of :meth:`JobCheckpointManager.restore_latest`;
  * async mode: ``save`` copies the table and state to the host before it
    returns (the step updates them in place right after), and a writer
    thread does the disk work; :meth:`~JobCheckpointManager.wait` joins it.

A store row-blocked over a mesh saves as the same payload: every rank calls
:func:`save`, the table is gathered over ``ps`` and global rank 0 writes.
:func:`restore` onto a mesh spec gives each rank its block of the target
layout, so a job saved at one ``ps`` count restores at another.
"""
from __future__ import annotations

import os
import shutil
import threading
import uuid
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..core.store import ShardedParamStore, StoreSpec
from ..core.transform import tree_map
from ..utils.device import DeviceLike, mesh_resolve_device

PAYLOAD = "payload.pt"


def _host_copy(x: Any) -> Any:
    """A CPU tensor that owns its own storage: ``torch.save`` of a view
    would write the whole base storage, and a view of the live table
    would see later steps."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).contiguous()
    return x


def _make_payload(store, worker_state, step, extra):
    # The payload table is in LOGICAL row order for both layouts (a dense
    # store's padding rows and a packed store's 128-lane physical rows are
    # on-device details, not a portable format), copied to the host now.
    return {
        "table": _host_copy(store.values()),
        "worker_state": tree_map(_host_copy, worker_state) if worker_state is not None else (),
        "meta": {
            "step": int(step),
            "capacity": store.spec.capacity,
            **(extra or {}),
        },
    }


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _commit(final_dir: str, payload: Dict[str, Any]) -> None:
    """Write ``payload`` to ``final_dir`` atomically: a hidden temporary
    directory beside it, fsynced, then renamed into place.  ``final_dir``
    must not exist."""
    parent = os.path.dirname(final_dir)
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".tmp-{os.path.basename(final_dir)}-{uuid.uuid4().hex}")
    os.makedirs(tmp)
    try:
        with open(os.path.join(tmp, PAYLOAD), "wb") as fh:
            torch.save(payload, fh)
            fh.flush()
            os.fsync(fh.fileno())
        _fsync_dir(tmp)
        os.rename(tmp, final_dir)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _fsync_dir(parent)


def _load(path: str) -> Dict[str, Any]:
    return torch.load(os.path.join(path, PAYLOAD), map_location="cpu", weights_only=True)


def save(
    path: str,
    store: ShardedParamStore,
    worker_state: Any = None,
    *,
    step: int = 0,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    """Save (param table, worker state, cursor) atomically under ``path``,
    replacing what is there.  A store on a mesh: every rank calls this,
    rank 0 writes, and each returns once the checkpoint is committed; if
    rank 0's write fails, every rank raises (rank 0 its own error)."""
    path = os.path.abspath(path)
    payload = _make_payload(store, worker_state, step, extra)
    if store.spec.mesh is None:
        _replace(path, payload)
        return
    error: Optional[BaseException] = None
    if dist.get_rank() == 0:
        try:
            _replace(path, payload)
        except Exception as exc:  # every rank must hear of it before it raises
            error = exc
    # rank 0's verdict, summed over the world: also the barrier
    failed = torch.tensor([0 if error is None else 1], dtype=torch.int32, device=store.table.device)
    dist.all_reduce(failed)
    if error is not None:
        raise error
    if int(failed.item()):
        raise RuntimeError(f"checkpoint {path!r} was not committed: rank 0's write failed")


def _replace(path: str, payload: Dict[str, Any]) -> None:
    trash = None
    if os.path.exists(path):
        trash = os.path.join(os.path.dirname(path), f".replacing.{os.path.basename(path)}-{uuid.uuid4().hex}")
        os.rename(path, trash)
    try:
        _commit(path, payload)
    except BaseException:
        if trash is not None:
            os.rename(trash, path)
        raise
    if trash is not None:
        shutil.rmtree(trash, ignore_errors=True)


def restore(
    path: str, spec: StoreSpec, device: DeviceLike = None
) -> Tuple[ShardedParamStore, Any, Dict[str, Any]]:
    """Restore a checkpoint onto ``spec`` and ``device`` (default: the
    card).  The saved table is cut back to its logical capacity and
    re-padded for the target spec, so a table may grow or shrink."""
    return _payload_to_state(_load(os.path.abspath(path)), spec, device)


def _payload_to_state(
    payload, spec: StoreSpec, device: DeviceLike = None
) -> Tuple[ShardedParamStore, Any, Dict[str, Any]]:
    """Re-place a restored payload onto the target spec and device (by
    default the card, or the mesh's device for a mesh spec)."""
    device = mesh_resolve_device(spec.mesh, device)
    meta = payload.get("meta", {})
    capacity = int(meta.get("capacity", spec.capacity))
    values = payload["table"][: min(capacity, spec.capacity)]
    if values.shape[0] < spec.capacity:
        pad = torch.zeros((spec.capacity - values.shape[0],) + tuple(values.shape[1:]), dtype=values.dtype)
        values = torch.cat([values, pad])
    # Rebuild on the *target* spec directly so nothing is dropped in the
    # round-trip (scatter_impl in particular: a pallas-configured store
    # must restore as a pallas-configured store).
    store = ShardedParamStore.from_spec_values(spec, values, device=device)
    worker_state = tree_map(
        lambda x: x.to(device) if isinstance(x, torch.Tensor) else x,
        payload.get("worker_state"),
    )
    return store, worker_state, meta


class JobCheckpointManager:
    """Step-directory checkpoint manager for the StreamingDriver: atomic
    per-step commits (a crash mid-write can never destroy the previous
    durable checkpoint), retention of the newest ``max_to_keep`` steps,
    and optional async writes (``save()`` copies to the host and a writer
    thread does the disk work, one save at a time, in order)."""

    def __init__(self, directory: str, *, use_async: bool = False, max_to_keep: int = 2):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep={max_to_keep}: must be >= 1")
        self._directory = os.path.abspath(directory)
        os.makedirs(self._directory, exist_ok=True)
        for name in os.listdir(self._directory):  # a crash's half-written steps
            if name.startswith(".tmp-"):
                shutil.rmtree(os.path.join(self._directory, name), ignore_errors=True)
        self._use_async = use_async
        self._max_to_keep = max_to_keep
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        steps = self._disk_steps()
        self._last_step: Optional[int] = steps[-1] if steps else None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._directory, str(step))

    def _disk_steps(self) -> List[int]:
        return sorted(
            int(n) for n in os.listdir(self._directory)
            if n.isdigit() and os.path.isdir(os.path.join(self._directory, n))
        )

    def _write(self, step: int, payload: Dict[str, Any]) -> None:
        _commit(self._step_dir(step), payload)
        for old in self._disk_steps()[: -self._max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def _write_in_background(self, step: int, payload: Dict[str, Any]) -> None:
        def run():
            try:
                self._write(step, payload)
            except Exception as e:  # surfaced by the next wait()
                self._error = e

        self._writer = threading.Thread(target=run, name=f"checkpoint-{step}", daemon=True)
        self._writer.start()

    def save(
        self,
        step: int,
        store: ShardedParamStore,
        worker_state: Any = None,
        *,
        extra: Optional[Dict[str, Any]] = None,
        force: bool = False,
    ) -> bool:
        """Returns whether the save was accepted.  A step at or below the
        newest one is skipped unless ``force=True`` (the explicit-save
        path uses force so "save now" always lands).  The table and state
        are on the host when this returns, in both modes."""
        if not force and self._last_step is not None and step <= self._last_step:
            return False
        payload = _make_payload(store, worker_state, step, extra)
        self.wait()  # one write at a time, in order
        trash = None
        if os.path.isdir(self._step_dir(step)):
            # Replace without a durability gap: move the old step aside (an
            # atomic rename), drop it only after the new one has committed.
            trash = os.path.join(self._directory, f".replacing.{step}")
            shutil.rmtree(trash, ignore_errors=True)
            os.rename(self._step_dir(step), trash)
        committed = False
        try:
            if self._use_async and trash is None:
                self._write_in_background(step, payload)
            else:
                self._write(step, payload)
                committed = True
        finally:
            if trash is not None:
                if committed:
                    shutil.rmtree(trash, ignore_errors=True)
                else:
                    self._restore_replaced(step, trash)
        self._last_step = step if self._last_step is None else max(self._last_step, step)
        return True

    def _restore_replaced(self, step: int, trash: str) -> None:
        """Put a renamed-aside step back after a failed replacement.  It
        runs in a ``finally`` and must not raise (it would mask the save's
        error); if the move back fails, the old copy stays under ``trash``
        and a warning names it."""
        old_dir = self._step_dir(step)
        try:
            if os.path.exists(old_dir):
                shutil.rmtree(old_dir, ignore_errors=True)
            os.rename(trash, old_dir)
        except OSError as e:  # pragma: no cover - disk-level failures
            warnings.warn(
                f"checkpoint step {step}: replacement failed and the "
                f"previous copy could not be moved back ({e}); it is "
                f"preserved at {trash}",
                RuntimeWarning,
            )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        """Durable (retained) checkpoint steps, ascending."""
        self.wait()
        return self._disk_steps()

    def restore_latest(
        self, spec: StoreSpec, device: DeviceLike = None
    ) -> Optional[Tuple[ShardedParamStore, Any, Dict[str, Any]]]:
        """Restore the newest RESTORABLE retained step onto ``spec`` and
        ``device``.

        A corrupt or partial latest checkpoint (bit rot, a write cut short
        outside the atomic commit, a chaos test's garbling) must not kill
        the recovery it exists to serve: on a restore failure this warns
        and falls back to the next older retained step — losing one
        checkpoint interval beats losing the job (the WAL, if configured,
        still replays the difference).  Only when every retained step
        fails does the error propagate."""
        steps = self.all_steps()
        if not steps:
            return None
        last_exc: Optional[BaseException] = None
        for step in reversed(steps):
            try:
                return restore(self._step_dir(step), spec, device)
            except Exception as e:  # a truncated zip, a bad pickle, a missing file
                last_exc = e
                warnings.warn(
                    f"checkpoint step {step} failed to restore "
                    f"({type(e).__name__}: {e}); falling back to the "
                    f"previous retained step",
                    RuntimeWarning,
                )
        raise RuntimeError(
            f"no retained checkpoint step under {self._directory!r} is "
            f"restorable (tried {list(reversed(steps))})"
        ) from last_exc

    def wait(self) -> None:
        """Block until the background write (if any) is durable; re-raise
        its error here."""
        writer, self._writer = self._writer, None
        if writer is not None:
            writer.join()
        err, self._error = self._error, None
        if err is not None:
            raise err

    def close(self) -> None:
        self.wait()


def load_model(path: str, *, device: DeviceLike = None, **from_values_kwargs) -> ShardedParamStore:
    """The ``transformWithModelLoad`` analogue from a checkpoint: seed a
    fresh store from a saved table, on ``device`` (default: the card).

    ``path`` may be a checkpoint written by :func:`save` or a
    :class:`JobCheckpointManager` directory (its newest step is used)."""
    path = os.path.abspath(path)
    if not os.path.exists(os.path.join(path, PAYLOAD)):
        steps = JobCheckpointManager(path).all_steps() if os.path.isdir(path) else []
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {path!r}")
        path = os.path.join(path, str(steps[-1]))
    payload = _load(path)
    values = payload["table"][: payload["meta"]["capacity"]]
    return ShardedParamStore.from_values(values, device=device, **from_values_kwargs)


__all__ = ["save", "restore", "load_model", "JobCheckpointManager"]
