"""The sorted-run kernels' CUDA source (K1 scatter-add, K2 fused MF-SGD),
run on the CPU under an emulation.

``csrc/scatter_add.cu`` and ``csrc/fused_mf.cu`` (with ``csrc/runs.cuh``)
are built by g++ against ``csrc/emulation/cuda_emu.h`` (one thread per
CUDA thread; shuffles and ballots across a warp; cp.async copies deferred
to the wait that covers them; shared memory filled with NaN before each
block) into libraries with the card's C interface, and their output is
held against the plain versions on the same inputs.  The cases aim at the
tile scheme: a run over many tiles, a run ending exactly on a tile's edge,
a tile wholly inside a run that continues both ways, all singletons, the
packed layout, bfloat16 and int32 tables, widths and views that take the
scalar path, and K2 at d 256, its smallest tile.  Skips where there is no
g++.

Tolerances, those of the card tests: float32 rtol 1e-5 with atol 1e-5 of
the largest value (sums in another order); bfloat16 one unit, rtol 2**-7
with atol 2**-8 of the largest value; int32 exact.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from flink_parameter_server_tpu_torch.ops import _cuda, mf_kernel, scatter_kernel

torch.set_num_threads(2)

K1_TILE = 256  # sorted lanes a block owns in scatter_add.cu


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated kernels")
    out = tmp_path_factory.mktemp("runs_emu")
    procs = {}
    for name in ("scatter_add", "fused_mf"):
        cmd = [gxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-x", "c++",
               "-I", str(_cuda.CSRC / "emulation"), "-include", "cuda_emu.h",
               "-o", str(out / f"lib{name}_emu.so"), str(_cuda.CSRC / _cuda.SOURCES[name])]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    found = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        assert proc.returncode == 0, text
        lib = ctypes.CDLL(str(out / f"lib{name}_emu.so"))
        sigs = scatter_kernel._SIGNATURES if name == "scatter_add" else mf_kernel._SIGNATURES
        for fn, argtypes in sigs.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        found[name] = lib
    return found


def _ids(kind, n, cap, rng, tile):
    """Sorted ids in [0, cap) of one of the shapes the tile scheme must get right."""
    if kind == "zipf":
        ids = (rng.zipf(1.2, n) - 1) % cap
    elif kind == "hot":  # one run over many tiles, a Zipf tail on both sides
        ids = (rng.zipf(1.2, n) - 1) % cap
        ids[: n * 3 // 4] = cap // 2
    elif kind == "edge":  # runs ending exactly on tile edges, and one lane past
        ids = np.empty(n, np.int64)
        ids[: 2 * tile] = 1
        ids[2 * tile: 3 * tile + 1] = 2
        ids[3 * tile + 1:] = 3 + np.arange(n - 3 * tile - 1) % (cap - 3)
    elif kind == "inside":  # a tile wholly inside a run that continues both ways
        ids = 2 + rng.integers(0, cap - 2, n)
        ids[tile // 2: 3 * tile + 5] = 1
        ids[: tile // 2] = 0
    elif kind == "singletons":
        ids = rng.permutation(cap)[:n]
    else:
        raise ValueError(kind)
    return torch.from_numpy(np.sort(ids).astype(np.int32))


def _scratch(tiles, d, dtype):
    """head/tail scratch filled with what no sum gives, so a partial read
    where none was written shows in the result."""
    fill = float("nan") if dtype.is_floating_point else 2**30
    return torch.full((tiles, d), fill, dtype=dtype)


def _k1(lib, table, ids, deltas, sub_k):
    n, d = deltas.shape
    acc = scatter_kernel.acc_dtype(table.dtype)
    tiles = -(-n // lib.fps_chunk_lanes())
    head, tail = _scratch(tiles, d, acc), _scratch(tiles, d, acc)
    err = lib.fps_sorted_scatter_add(_cuda.DTYPE_CODES[table.dtype], table.data_ptr(), table.shape[1],
                                     ids.data_ptr(), deltas.data_ptr(), n, d, sub_k, head.data_ptr(),
                                     tail.data_ptr(), None)
    assert err == 0
    return table


@pytest.mark.parametrize(
    "kind,dtype,n,rows,width,sub_k",
    [
        ("hot", torch.float32, 3000, 300, 64, 1),         # one run across 8 tiles
        ("edge", torch.float32, 1100, 200, 64, 1),        # runs ending on tile edges
        ("inside", torch.float32, 1300, 500, 96, 1),      # tile 1 wholly inside one run; three slabs
        ("singletons", torch.float32, 700, 2000, 32, 1),  # no run longer than one lane
        ("hot", torch.float32, 1500, 100, 64, 2),         # packed, two logical rows a physical row
        ("zipf", torch.float32, 900, 40, 17, 7),          # packed at width 17: the scalar path
        ("hot", torch.bfloat16, 2000, 64, 64, 1),         # bf16 table, sums in float32
        ("hot", torch.int32, 2500, 32, 24, 1),            # int32 exact past 2**24
        ("zipf", torch.float32, 800, 64, 17, 1),          # d 17: rows off 16 bytes, the scalar path
    ],
)
def test_emulated_scatter_add_matches_plain(libs, kind, dtype, n, rows, width, sub_k):
    rng = np.random.default_rng(n + width)
    W = 128 if sub_k > 1 else width
    ids = _ids(kind, n, rows * sub_k, rng, K1_TILE)
    if dtype == torch.int32:
        table = torch.from_numpy(rng.integers(2**25, 2**30, (rows, W)).astype(np.int32))
        deltas = torch.from_numpy(rng.integers(-5, 6, (n, width)).astype(np.int32))
    else:
        table = torch.from_numpy(rng.normal(0, 1, (rows, W)).astype(np.float32)).to(dtype)
        deltas = torch.from_numpy(rng.normal(0, 0.1, (n, width)).astype(np.float32)).to(dtype)
    want = scatter_kernel.run_sum_write_plain(table.clone(), ids, deltas, sub_k=sub_k)
    got = _k1(libs["scatter_add"], table.clone(), ids, deltas, sub_k)
    if dtype == torch.int32:
        assert torch.equal(got, want)
    else:
        _close(got, want, dtype)


def test_emulated_scatter_add_takes_deltas_off_a_16_byte_boundary(libs):
    """A contiguous deltas view 4 bytes past a boundary: the launch takes the
    scalar copy, and the sums match."""
    rng = np.random.default_rng(3)
    n, d, rows = 900, 64, 50
    ids = _ids("hot", n, rows, rng, K1_TILE)
    flat = torch.from_numpy(rng.normal(0, 0.1, n * d + 1).astype(np.float32))
    deltas = flat[1:].view(n, d)
    assert deltas.data_ptr() % 16 != 0
    table = torch.from_numpy(rng.normal(0, 1, (rows, d)).astype(np.float32))
    want = scatter_kernel.run_sum_write_plain(table.clone(), ids, deltas, sub_k=1)
    _close(_k1(libs["scatter_add"], table.clone(), ids, deltas, 1), want, torch.float32)


@pytest.mark.parametrize(
    "kind,dtype,n,rows,dim,sub_k",
    [
        ("hot", torch.float32, 1000, 200, 128, 1),        # one run across 12 tiles of 64 lanes
        ("edge", torch.float32, 500, 100, 128, 1),        # runs ending on 64-lane tile edges
        ("inside", torch.float32, 400, 300, 64, 1),       # a 128-lane tile wholly inside one run
        ("singletons", torch.float32, 300, 900, 32, 1),
        ("hot", torch.float32, 800, 150, 64, 2),          # packed, 16-byte rows
        ("zipf", torch.float32, 500, 30, 17, 7),          # packed at width 17: the scalar path
        ("hot", torch.bfloat16, 600, 64, 128, 1),         # bf16 table
        ("hot", torch.float32, 300, 40, 256, 1),          # d 256: 32-lane tiles, a hot run
        ("zipf", torch.float32, 400, 50, 17, 1),          # d 17, dense: the scalar path
    ],
)
def test_emulated_fused_mf_matches_plain(libs, kind, dtype, n, rows, dim, sub_k):
    rng = np.random.default_rng(n + dim)
    W = 128 if sub_k > 1 else dim
    tile = 256 // -(-dim // 32)  # the kernel's tile at this width
    items = _ids(kind, n, rows * sub_k, rng, tile)
    table = torch.from_numpy(rng.normal(0, 0.3, (rows, W)).astype(np.float32)).to(dtype)
    p = torch.from_numpy(rng.normal(0, 0.3, (n, dim)).astype(np.float32))
    r = torch.from_numpy(rng.normal(0, 1, n).astype(np.float32))
    m = torch.from_numpy((rng.random(n) > 0.1).astype(np.float32))
    kw = dict(learning_rate=0.05, regularization=0.01, sub_k=sub_k)
    want_t = table.clone()
    want_u, want_p = mf_kernel.fused_mf_sgd_plain(want_t, items, p, r, m, **kw)
    lib = libs["fused_mf"]
    got_t = table.clone()
    got_u, got_p = torch.empty(n, dim), torch.empty(n)
    tiles = -(-n // lib.fps_chunk_lanes())
    head, tail = _scratch(tiles, dim, torch.float32), _scratch(tiles, dim, torch.float32)
    err = lib.fps_fused_mf_sgd(_cuda.DTYPE_CODES[dtype], got_t.data_ptr(), W, items.data_ptr(), p.data_ptr(),
                               r.data_ptr(), m.data_ptr(), n, dim, sub_k, 0.05, 0.01, got_u.data_ptr(),
                               got_p.data_ptr(), head.data_ptr(), tail.data_ptr(), None)
    assert err == 0
    torch.testing.assert_close(got_p, want_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_u, want_u, rtol=1e-5, atol=1e-5)
    _close(got_t, want_t, dtype)


def _close(got, want, dtype):
    scale = float(want.float().abs().max())
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2**-7, atol=2**-8 * scale)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)
