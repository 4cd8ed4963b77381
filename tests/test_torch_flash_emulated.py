"""The flash kernels' CUDA source, run on the CPU under an emulation.

``csrc/flash_attn.cu`` is built by g++ against ``csrc/emulation/cuda_emu.h``
(one thread per CUDA thread; ldmatrix, mma.m16n8k16 (bf16) and
mma.m16n8k8 (TF32, its sums truncated as the card's are) with the PTX
ISA's fragment layouts, TF32 rounding; cp.async copies deferred to the
wait that covers them)
into a library with the same C interface as the card's, and its output
is held against the plain versions on the same inputs.  This checks the
kernels' indexing, fragment layouts, masking and tile ring without a card;
speed and the real instructions are checked on the card only.  Skips
where there is no g++.

Tolerances, those of the card tests: float32 rtol 1e-5 with atol 1e-5 of
the largest value (sums in another order; the backward's 3xTF32 products,
whose tensor-core sums the emulation truncates as the card does, carry
float32 to about 2**-21); bfloat16 outputs one bfloat16
unit, rtol 2**-7 with atol 2**-8 of the largest value; L and D float32.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from flink_parameter_server_tpu_torch.ops import _cuda
from flink_parameter_server_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated kernels")
    out = tmp_path_factory.mktemp("flash_emu") / "libflash_emu.so"
    cmd = [gxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-x", "c++",
           "-I", str(_cuda.CSRC / "emulation"), "-include", "cuda_emu.h",
           "-o", str(out), str(_cuda.CSRC / "flash_attn.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    library = ctypes.CDLL(str(out))
    for fn, argtypes in fa._SIGNATURES.items():
        getattr(library, fn).argtypes = list(argtypes)
        getattr(library, fn).restype = ctypes.c_int
    return library


def _call(lib, fn, dtype, D, *args):
    err = getattr(lib, fn)(_cuda.DTYPE_CODES[dtype], D, *args, None)
    assert err == 0, f"{fn}: error {err}"


def _inputs(B, T, H, D, dtype, seed):
    """As the LM hands them over: q scaled and contiguous, k and v strided
    views of one (B, T, 3, H, D) projection."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy((rng.normal(size=(B, T, 3, H, D)) * 0.8).astype(np.float32)).to(dtype)
    q = (qkv[:, :, 0].float() * D**-0.5).to(dtype).contiguous()
    do = torch.from_numpy(rng.normal(size=(B, T, H, D)).astype(np.float32)).to(dtype)
    return q, qkv[:, :, 1], qkv[:, :, 2], do


def _close(got, want, dtype):
    scale = float(want.float().abs().max())
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2**-7, atol=2**-8 * scale)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize(
    "B,T,H,D,dtype",
    [
        (1, 128, 2, 64, torch.bfloat16),   # the LM's width: one warp set, one softmax (or dQ key) step a tile
        (1, 192, 1, 128, torch.bfloat16),  # three tiles: the cp.async ring refills a used stage
        (1, 128, 1, 256, torch.bfloat16),  # two warp sets split O, dQ, dK and dV; 16-query passes
        (1, 192, 1, 256, torch.bfloat16),  # three tiles with two warp sets: dQ's ring refilled
        (1, 128, 1, 192, torch.float32),   # 3xTF32: 32 own rows, 16-row streamed tiles, 2 dQ / 3 dK/dV warp sets
        (1, 128, 1, 256, torch.float32),   # 3xTF32: 32 own rows, 16-row streamed tiles, 2 dQ / 4 dK/dV warp sets
        (1, 128, 1, 320, torch.float32),   # the column-split route: five 64-column slices
        (1, 128, 1, 320, torch.bfloat16),  # the same, rounding dS (and P in dK/dV) as splash does
        (1, 128, 2, 64, torch.float32),    # 3xTF32 backward: 64 own rows, 32-row streamed tiles split in place
        (1, 192, 1, 64, torch.float32),    # six streamed tiles: the cp.async ring refills a used stage
        (1, 128, 1, 128, torch.float32),   # 3xTF32: two dK/dV warp sets
        (1, 512, 1, 64, torch.float32),    # eight key tiles: a sum chained through truncating adds would drift
        (1, 128, 1, 384, torch.float32),   # the column-split route at a width neither 320 nor 512
        (1, 128, 1, 384, torch.bfloat16),
        (1, 192, 1, 512, torch.float32),   # three key tiles: the split forward's ring refills used stages
        (1, 192, 1, 512, torch.bfloat16),
        (1, 128, 1, 640, torch.float32),   # ten pieces: two column slices of five, each rebuilding S
        (1, 128, 1, 640, torch.bfloat16),
        (1, 128, 1, 1344, torch.float32),  # past where q's rows fit whole: q streamed beside each k piece
        (1, 64, 1, 2496, torch.bfloat16),
        # the column-split backward's boundaries
        (1, 64, 1, 576, torch.float32),    # dQ in two slices (5 + 4 pieces), dK/dV in three (3 + 3 + 3)
        (1, 64, 1, 576, torch.bfloat16),   # bf16 dK/dV's widest with k and v held whole (640 streams them)
        (1, 64, 1, 704, torch.float32),    # float32 dQ past where q and dO fit whole (640): streamed
        (1, 64, 1, 1216, torch.bfloat16),  # bf16 dQ's widest with q and dO held whole
        (1, 64, 1, 1280, torch.bfloat16),  # bf16 dQ streams q and dO
        (1, 192, 1, 320, torch.float32),   # three key tiles: the backward's ring refills used slots
        (1, 192, 1, 320, torch.bfloat16),
    ],
)
def test_emulated_kernels_match_plain(lib, B, T, H, D, dtype):
    q, k, v, do = _inputs(B, T, H, D, dtype, seed=D + T)
    shape, stats = (B, T, H, D), (B, H, T)
    o, dq, dk, dv = (torch.empty(shape, dtype=dtype) for _ in range(4))
    lse, delta = torch.empty(stats), torch.empty(stats)
    _call(lib, "fps_flash_fwd", dtype, D, q.data_ptr(), k.data_ptr(), v.data_ptr(), fa._strides(q, k, v),
          o.data_ptr(), lse.data_ptr(), B, T, H)
    _call(lib, "fps_flash_bwd_dq", dtype, D, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
          do.data_ptr(), fa._strides(q, k, v, o, do), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
          B, T, H)
    _call(lib, "fps_flash_bwd_dkv", dtype, D, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
          fa._strides(q, k, v, do), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, T, H)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v)
    dq_p, delta_p = fa.flash_bwd_dq_plain(q, k, v, o, do, lse)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta)
    _close(lse, lse_p, torch.float32)
    _close(delta, delta_p, torch.float32)
    for got, want in ((o, o_p), (dq, dq_p), (dk, dk_p), (dv, dv_p)):
        _close(got, want, dtype)


def test_emulated_library_refuses_a_width_it_lacks(lib):
    """96 is no multiple of 64: the reference's gate refuses it, and so does
    the library, in both dtypes."""
    lse = torch.empty(1, 1, 64)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros(1, 64, 1, 96, dtype=dtype)
        err = lib.fps_flash_fwd(_cuda.DTYPE_CODES[dtype], 96, x.data_ptr(), x.data_ptr(), x.data_ptr(),
                                fa._strides(x, x, x), x.data_ptr(), lse.data_ptr(), 1, 64, 1, None)
        assert err != 0

