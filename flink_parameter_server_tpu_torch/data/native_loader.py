"""ctypes bindings for the native (C++) rating loader/batcher.

The port's copy of ``flink_parameter_server_tpu/data/native_loader.py``
over its own copy of ``native/fps_loader.cpp`` (``csrc/fps_loader.cpp``,
byte for byte): mmap'd parsing plus a background-thread ring-buffer
batcher, keeping batch assembly off the Python GIL while the card runs
the previous step.

The shared library is built on first use with the system ``g++`` (no
pip/pybind dependency — plain C ABI via ctypes) into ``build/native/`` at
the repository root (a directory git ignores).  Its name carries a hash
of the source and the flags, and it is written under a temporary name
and renamed into place, so two processes that build at once never load
half a library.  ``load_ratings`` and ``stream_batches`` fall back to the
pure-numpy path in :mod:`.movielens` when no compiler is available; call
:func:`get_lib` first where that fallback must not happen (its ids are
compacted, the native stream's are the file's).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "fps_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib = None
_lib_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libfps_loader-{h.hexdigest()[:16]}.so"


def _build() -> str:
    out = library_path()
    if out.exists():
        return str(out)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = ["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)]
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        raise NativeUnavailable(f"building {out} failed: {e}") from e
    return str(out)


def get_lib() -> ctypes.CDLL:
    """Load (building if needed) the native library."""
    global _lib
    # fpsanalyze: allow[B001] build-once double-checked lock: every caller MUST wait for the one-time g++ build — blocking here is the contract
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build())
        lib.fps_parse.restype = ctypes.c_void_p
        lib.fps_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.fps_num_rows.restype = ctypes.c_int64
        lib.fps_num_rows.argtypes = [ctypes.c_void_p]
        lib.fps_columns.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.fps_free.argtypes = [ctypes.c_void_p]
        lib.fps_stream_open.restype = ctypes.c_void_p
        lib.fps_stream_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_uint64, ctypes.c_int64,
        ]
        lib.fps_stream_next.restype = ctypes.c_int64
        lib.fps_stream_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.fps_stream_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def load_ratings(
    path: str, *, max_rows: int = -1, compact_ids: bool = True,
    normalize: bool = False,
) -> Dict[str, np.ndarray]:
    """Parse a MovieLens-format ratings file natively into columns
    (same contract as :func:`.movielens.load_movielens`); falls back to
    the pure-numpy loader when no C++ toolchain is available."""
    try:
        lib = get_lib()
    except NativeUnavailable:
        from .movielens import load_movielens

        if not os.path.exists(path):
            raise FileNotFoundError(path)
        out = load_movielens(
            path,
            max_ratings=None if max_rows < 0 else max_rows,
            normalize=normalize,
        )
        if not compact_ids:
            raise NativeUnavailable(
                "compact_ids=False requires the native loader"
            )
        return out
    handle = lib.fps_parse(path.encode(), max_rows)
    if not handle:
        raise FileNotFoundError(path)
    try:
        n = lib.fps_num_rows(handle)
        users = np.empty(n, np.int64)
        items = np.empty(n, np.int64)
        ratings = np.empty(n, np.float32)
        lib.fps_columns(
            handle, _ptr(users, ctypes.c_int64), _ptr(items, ctypes.c_int64),
            _ptr(ratings, ctypes.c_float),
        )
    finally:
        lib.fps_free(handle)
    if compact_ids:
        _, users = np.unique(users, return_inverse=True)
        _, items = np.unique(items, return_inverse=True)
    if normalize:
        ratings = (ratings - ratings.mean()) / 2.0
    return {
        "user": users.astype(np.int32),
        "item": items.astype(np.int32),
        "rating": ratings,
    }


def stream_batches(
    path: str,
    batch_size: int,
    *,
    epochs: int = 1,
    shuffle_seed: Optional[int] = None,
    ring_capacity: int = 4,
    pad_to_batch: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Stream rating microbatches assembled by the native background
    thread (ids are raw file ids — pair with ``compact_ids=False``
    semantics; remap host-side if needed).  Falls back to a pure-numpy
    generator (same batch contract) without a C++ toolchain."""
    try:
        lib = get_lib()
    except NativeUnavailable:
        yield from _numpy_stream(
            path, batch_size, epochs=epochs, shuffle_seed=shuffle_seed,
            pad_to_batch=pad_to_batch,
        )
        return
    handle = lib.fps_stream_open(
        path.encode(), batch_size, epochs,
        1 if shuffle_seed is not None else 0,
        shuffle_seed or 0, ring_capacity,
    )
    if not handle:
        raise FileNotFoundError(path)
    try:
        u = np.empty(batch_size, np.int64)
        i = np.empty(batch_size, np.int64)
        r = np.empty(batch_size, np.float32)
        while True:
            n = lib.fps_stream_next(
                handle, _ptr(u, ctypes.c_int64), _ptr(i, ctypes.c_int64),
                _ptr(r, ctypes.c_float),
            )
            if n == 0:
                return
            if n == batch_size or not pad_to_batch:
                batch = {
                    "user": u[:n].astype(np.int32),
                    "item": i[:n].astype(np.int32),
                    "rating": r[:n].copy(),
                    "mask": np.ones(int(n), bool),
                }
            else:
                pad = batch_size - int(n)
                batch = {
                    "user": np.concatenate(
                        [u[:n], np.zeros(pad, np.int64)]
                    ).astype(np.int32),
                    "item": np.concatenate(
                        [i[:n], np.zeros(pad, np.int64)]
                    ).astype(np.int32),
                    "rating": np.concatenate([r[:n], np.zeros(pad, np.float32)]),
                    "mask": np.arange(batch_size) < int(n),
                }
            yield batch
    finally:
        lib.fps_stream_close(handle)


def _numpy_stream(path, batch_size, *, epochs, shuffle_seed, pad_to_batch):
    """Fallback batcher (numpy).  Divergence from the native stream: ids
    come out *compacted* (the numpy loader's contract), not raw file ids."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    from .movielens import load_movielens

    cols = load_movielens(path, normalize=False)
    n = len(cols["user"])
    rng = (
        np.random.default_rng(shuffle_seed) if shuffle_seed is not None else None
    )
    for _ in range(epochs):
        order = rng.permutation(n) if rng is not None else np.arange(n)
        for s in range(0, n, batch_size):
            idx = order[s : s + batch_size]
            m = len(idx)
            if m < batch_size and pad_to_batch:
                pad = batch_size - m
                yield {
                    "user": np.concatenate(
                        [cols["user"][idx], np.zeros(pad, np.int32)]
                    ),
                    "item": np.concatenate(
                        [cols["item"][idx], np.zeros(pad, np.int32)]
                    ),
                    "rating": np.concatenate(
                        [cols["rating"][idx], np.zeros(pad, np.float32)]
                    ),
                    "mask": np.arange(batch_size) < m,
                }
            else:
                yield {
                    "user": cols["user"][idx],
                    "item": cols["item"][idx],
                    "rating": cols["rating"][idx],
                    "mask": np.ones(m, bool),
                }


__all__ = ["get_lib", "load_ratings", "stream_batches", "NativeUnavailable"]
