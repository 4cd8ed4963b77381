"""Shard worker processes — the GIL escape.

Counterpart of ``flink_parameter_server_tpu/cluster/procs.py``.  Every
in-process shard thread shares ONE interpreter lock with every worker
thread, so adding shards adds lock convoy, not capacity.  This module runs each
:class:`~.shard.ShardServer` in its OWN spawned process — its own
interpreter, its own GIL, its own selectors event loop — so shard-side
scatter/parse work runs in real OS-level parallelism with the workers
and with each other on multi-core hosts.

Design points:

  * **spawn, not fork** — a fork would duplicate the parent's CUDA
    context and every live thread's locks; spawn starts clean.  The
    child imports the port (and so torch) but never initialises CUDA:
    it hides every card (``CUDA_VISIBLE_DEVICES=""``) before it builds
    anything, and runs the ``store_backend="numpy"`` slice
    (:class:`~.shard._NumpyStore`), whose in-place fp32 scatter-add is
    bitwise-comparable to the torch slice over client-deduplicated ids
    and pays no device dispatch per push.  Importing torch makes the
    child's start slower than a numpy-only interpreter's; readiness
    (below) waits for it.
  * **readiness over a pipe** — the child reports ``(host, port)``
    after binding, and the parent's :meth:`ShardProcess.wait_ready`
    blocks on it.  The first dial can still race a RESPAWN, which is
    why :class:`~.client.ClusterClient` retries refused dials inside
    its ``spawn_grace_s`` window instead of spending storm-class
    retry budget (the ``_await_retry`` interaction fix).
  * **durability is the WAL's job, by design** — a killed shard
    process loses its in-memory slice only; the WAL dir, telemetry
    export, and supervised restart already treat process death as the
    ordinary failure (``docs/resilience.md``), so a respawned
    :class:`ShardProcess` over the same ``wal_dir`` rebuilds bitwise.

``init`` specs are small picklable dicts (``{"kind": "zeros"}`` /
``{"kind": "hashed_uniform", "scale": s, "seed": k}``) rather than
closures — a spawned child can't unpickle a lambda, and deterministic
per-id init is exactly what makes a shard slice equal the global
table's rows.  :func:`as_torch_init` renders the same spec as a tensor
on the device for an in-process (thread-backed) driver, which is how the
proc-vs-thread parity test pins both arms to one table.

The standard library's spawn caveat applies: a SCRIPT that creates
shard processes must guard its entry point with
``if __name__ == "__main__":`` — spawn re-imports ``__main__`` in the
child, and unguarded top-level code would recursively re-run the
whole script (the stdlib raises the usual "bootstrapping phase"
RuntimeError).  Library/pytest imports are unaffected.
"""
from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
from typing import Optional, Tuple

import numpy as np

from ..utils.device import DeviceLike

_CTX = multiprocessing.get_context("spawn")


# -- deterministic picklable init specs --------------------------------------


def resolve_init(init: Optional[dict]):
    """``init`` spec → a numpy ``f(ids) -> rows`` (or None for the
    zeros default).  Deterministic per id — the contract every shard
    rebuild and parity check rides on."""
    if init is None:
        return None
    kind = init.get("kind", "zeros")
    if kind == "zeros":
        return None
    if kind == "hashed_uniform":
        scale = float(init.get("scale", 0.1))
        seed = int(init.get("seed", 0))

        def f(ids: np.ndarray, _scale=scale, _seed=seed):
            from ..ops.hashing import fmix32_np

            ids = np.asarray(ids, np.int64)
            width = int(init.get("width", 0))
            cols = []
            for j in range(max(1, width)):
                h = fmix32_np(ids * np.int64(2654435761) + j + _seed)
                cols.append(
                    (h.astype(np.float64) / 2**32 - 0.5) * 2 * _scale
                )
            out = np.stack(cols, axis=-1).astype(np.float32)
            return out if width else out[..., 0]

        return f
    raise ValueError(
        f"init kind {kind!r}: 'zeros' | 'hashed_uniform'"
    )


def as_torch_init(
    init: Optional[dict],
    value_shape: Tuple[int, ...],
    device: DeviceLike = None,
):
    """The SAME init spec as a torch ``init_fn`` for an in-process
    driver — proc and thread arms then start from one table.  The rows
    are the numpy rows :func:`resolve_init` computes, copied onto
    ``device`` (the card unless the caller asks for the CPU)."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    init = dict(init or {"kind": "zeros"})
    width = 1
    for s in value_shape:
        width *= int(s)
    init.setdefault("width", width)
    f = resolve_init(init)
    if f is None:
        return None

    def init_fn(ids):
        import torch

        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        rows = f(np.asarray(ids)).reshape(
            (-1,) + tuple(value_shape)
        )
        return torch.from_numpy(rows).to(dev)

    return init_fn


@dataclasses.dataclass
class ShardProcSpec:
    """Everything a shard worker process needs, picklable."""

    shard_id: int
    partition: str  # "range" | "hash"
    capacity: int
    num_shards: int
    value_shape: Tuple[int, ...] = ()
    wal_dir: Optional[str] = None
    init: Optional[dict] = None
    supervised: bool = True
    host: str = "127.0.0.1"
    max_line_bytes: int = 64 << 20
    # advertise the shared-memory transport (shmem/): a co-located
    # client's "hello shm" hands the data plane to a ring pair — the
    # proc-shard case is exactly what shm exists for (same host,
    # different interpreters, no kernel socket between them)
    shm: bool = True


def _build_partitioner(spec: dict):
    from .partition import ConsistentHashPartitioner, RangePartitioner

    if spec["partition"] == "range":
        return RangePartitioner(spec["capacity"], spec["num_shards"])
    if spec["partition"] == "hash":
        return ConsistentHashPartitioner(
            spec["capacity"], spec["num_shards"]
        )
    raise ValueError(f"partition={spec['partition']!r}: 'range' | 'hash'")


def _shard_proc_main(spec: dict, pipe) -> None:
    """The child: build the numpy-backed shard + its server, report
    the bound address, serve until told to stop (or until the parent
    dies — the pipe EOF).  The WAL dir is the durable half; losing
    this process is the ordinary failure the stack already absorbs."""
    # the numpy slice needs no card; hiding them makes it structural
    # that the child never initialises CUDA
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        from .shard import ParamShard, ShardServer

        init_spec = dict(spec.get("init") or {"kind": "zeros"})
        width = 1
        for s in spec["value_shape"]:
            width *= int(s)
        init_spec.setdefault("width", width)
        base = resolve_init(init_spec)
        init_fn = None
        if base is not None:
            def init_fn(ids):
                return base(np.asarray(ids)).reshape(
                    (-1,) + tuple(spec["value_shape"])
                )
        shard = ParamShard(
            spec["shard_id"],
            _build_partitioner(spec),
            spec["value_shape"],
            init_fn=init_fn,
            wal_dir=spec["wal_dir"],
            store_backend="numpy",
        )
        server = ShardServer(
            shard, spec["host"], 0,
            supervised=spec["supervised"],
            max_line_bytes=spec["max_line_bytes"],
            enable_shm=bool(spec.get("shm", True)),
        ).start()
    except Exception as e:  # noqa: BLE001 — reported to the parent
        try:
            pipe.send(("error", f"{type(e).__name__}: {e}", 0))
        except (OSError, BrokenPipeError):
            pass
        return
    try:
        # 4th element advertises shm willingness (older parents index
        # only [1]/[2]; newer parents read it defensively)
        pipe.send(
            ("ready", server.host, server.port, bool(server.shm_enabled))
        )
        while True:
            if pipe.poll(0.25):
                msg = pipe.recv()
                if msg == "stop":
                    break
    except (EOFError, OSError, BrokenPipeError):
        pass  # parent gone: exit; the WAL dir is the durable half
    finally:
        try:
            server.stop()
            shard.close()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass
        try:
            pipe.send(("stopped",))
        except (OSError, BrokenPipeError):
            pass


class ShardProcess:
    """Parent-side handle on one spawned shard server process.

    Presents the server façade the drivers expect (``host`` / ``port``
    / ``running`` / ``stop()``), so a proc-backed topology publishes
    addresses exactly like a thread-backed one."""

    def __init__(self, spec: ShardProcSpec):
        self.spec = spec
        self._pipe, child = _CTX.Pipe()
        self.proc = _CTX.Process(
            target=_shard_proc_main,
            args=(dataclasses.asdict(spec), child),
            name=f"fps-shard-{spec.shard_id}",
            daemon=True,
        )
        self.proc.start()
        child.close()
        self.host: Optional[str] = None
        self.port: Optional[int] = None
        self.shm = False  # set from the ready message (wait_ready)

    def wait_ready(self, timeout: float = 60.0) -> "ShardProcess":
        """Block until the child reports its bound address (or died
        trying).  Clients may still dial before THIS returns on a
        respawn path — the client-side spawn grace window covers it."""
        if self.port is not None:
            return self
        if not self._pipe.poll(timeout):
            self.stop()
            raise TimeoutError(
                f"shard {self.spec.shard_id} process not ready after "
                f"{timeout}s"
            )
        try:
            msg = self._pipe.recv()
        except (EOFError, OSError):
            self.stop()
            raise RuntimeError(
                f"shard {self.spec.shard_id} process died before "
                f"reporting ready (exitcode="
                f"{self.proc.exitcode})"
            ) from None
        if msg[0] != "ready":
            self.stop()
            raise RuntimeError(
                f"shard {self.spec.shard_id} process failed: {msg[1]}"
            )
        self.host, self.port = msg[1], int(msg[2])
        # shm advertisement (absent from pre-shmem children)
        self.shm = bool(msg[3]) if len(msg) > 3 else False
        return self

    @property
    def running(self) -> bool:
        return self.proc.is_alive()

    def stop(self, timeout: float = 10.0) -> None:
        """Graceful stop (the child drains + closes its WAL), with a
        terminate fallback — the kill path IS a supported failure."""
        try:
            self._pipe.send("stop")
        except (OSError, BrokenPipeError):
            pass
        self.proc.join(timeout)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(5)
        try:
            self._pipe.close()
        except OSError:
            pass

    def kill(self) -> None:
        """The chaos path: SIGKILL, no drain — what a real shard-host
        death looks like.  A fresh :class:`ShardProcess` over the same
        ``wal_dir`` rebuilds the slice bitwise."""
        self.proc.kill()
        self.proc.join(5)


class RemoteShardStub:
    """The driver-side stand-in for an in-process :class:`ParamShard`
    when the shard lives in another process: the few read surfaces the
    driver touches (``stats``) go over the wire; lifecycle is the
    process handle's job."""

    def __init__(self, proc: ShardProcess, timeout: float = 10.0):
        self._proc = proc
        self._timeout = float(timeout)
        self.shard_id = proc.spec.shard_id

    def stats(self) -> dict:
        from ..utils.net import request_lines

        resp = request_lines(
            self._proc.host, self._proc.port, ["stats"],
            timeout=self._timeout,
        )[0]
        if not resp.startswith("ok "):
            raise RuntimeError(
                f"shard {self.shard_id} stats failed: {resp}"
            )
        return json.loads(resp[3:])

    def close(self) -> None:
        """The process handle owns teardown; nothing in-process."""


__all__ = [
    "RemoteShardStub",
    "ShardProcSpec",
    "ShardProcess",
    "as_torch_init",
    "resolve_init",
]
