"""Time variants of the column-split flash backward against each other on the card.

Each variant is ``csrc/flash_attn.cu`` with a few text substitutions (the
design choices its comments cite: own rows a block, reading the last score
slot's pieces again, float32's even / odd score sums, bf16 slot size).
Every variant is built by ``nvcc`` into its own library under
``build/flash_bwd_variants/`` (all at once), checked against the plain
versions at the split widths (dQ, delta, dK and dV at ``chip_smoke.py``'s
bars, twice, bitwise), and then timed in turns, forward order then
reverse, at B 2, T 1024, H 2, D 320 and 512 in both dtypes (medians of 15
launches, L2 flushed), beside SDPA's whole backward.  ``--parent DIR``
adds a directory holding another tree's ``flash_attn.cu``, ``mma.cuh`` and
``runs.cuh`` (for example a ``git archive`` of the parent commit's
``csrc/``) as one more variant, timed but not checked.

    python3 tools/flash_bwd_variants.py [--parent DIR] [--variants kept,rows16,...]

Needs a card and ``nvcc``; prints the card and its power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "flash_bwd_variants")

ROWS = "__host__ __device__ constexpr int bwd_split_rows() { return kDKV ? 32 : 16; }"
VARIANTS = {
    "kept": [],
    # dK/dV with 16 own rows, as dQ
    "rows16": [(ROWS, ROWS.replace("kDKV ? 32 : 16", "kDKV ? 16 : 16"))],
    # dQ with 32 own rows, as dK/dV
    "dq32": [(ROWS, ROWS.replace("kDKV ? 32 : 16", "kDKV ? 32 : 32"))],
    # every output piece streamed anew, none read from the last score slot
    "noreuse": [("const int r = nV < last ? nV : last;", "const int r = 0;")],
    # float32 scores summed in even and odd halves, as bf16's
    "pair_sums": [("constexpr int NPAR = kF32 ? 1 : 2;", "constexpr int NPAR = 2;"),
                  ("sp[pi][0][nn][e] += t[pi][nn][e];", "sp[pi][l % NPAR][nn][e] += t[pi][nn][e];")],
    # bf16 ring slots of 4 pieces (float32's size) in the backward
    "slot4": [("PIECE = split_piece<T>(), SLOT = split_slot<T>(), NSL = kSplitSlots;\n  static_assert(NT == 2",
               "PIECE = split_piece<T>(), SLOT = 4, NSL = kSplitSlots;\n  static_assert(NT == 2"),
              ("kSplitSlots * split_slot<T>() * split_piece<T>() +\n                    bwd_split_planes",
               "kSplitSlots * 4 * split_piece<T>() +\n                    bwd_split_planes")],
}
CHECKS = [(2, 1024, 2, 320), (2, 1024, 2, 512), (1, 512, 2, 640), (1, 512, 2, 1344), (1, 256, 2, 2496)]


def write_variant(name: str, edits, csrc: str) -> str:
    src = open(os.path.join(csrc, "flash_attn.cu")).read()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: {old[:60]!r} is not in flash_attn.cu exactly once")
        src = src.replace(old, new)
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    for f in ("mma.cuh", "runs.cuh"):
        shutil.copy(os.path.join(csrc, f), d)
    with open(os.path.join(d, "flash_attn.cu"), "w") as f:
        f.write(src)
    return d


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a directory with another tree's flash_attn.cu, mma.cuh and runs.cuh")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from flink_parameter_server_tpu_torch.ops import _cuda
    from flink_parameter_server_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_bwd_variants: needs a card", file=sys.stderr)
        return 1
    print("card:", cs.card_line(), "torch", torch.__version__, flush=True)
    dirs = {n: write_variant(n, VARIANTS[n], str(_cuda.CSRC)) for n in args.variants.split(",")}
    if args.parent:
        dirs["parent"] = write_variant("parent", [], args.parent)
    t0 = time.perf_counter()
    procs = {n: subprocess.Popen([_cuda.nvcc(), *_cuda.NVCC_FLAGS, "-o", os.path.join(d, "lib.so"),
                                  os.path.join(d, "flash_attn.cu")], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True) for n, d in dirs.items()}
    libs = {}
    for n, p in procs.items():
        text = p.communicate()[0]
        if p.returncode:
            print(f"build {n}: nvcc exited {p.returncode}\n{text[-4000:]}")
            return 1
        for kern, (regs, spill) in cs.ptxas_report(text).items():
            if "bwd" in kern and "split" in kern:
                print(f"build {n}: {kern}: {regs} registers, {spill} bytes spilled")
        lib = libs[n] = ctypes.CDLL(os.path.join(dirs[n], "lib.so"))
        for fn, argtypes in fa._SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    failed = 0
    for n in (v for v in libs if v != "parent"):
        _cuda._LIBS["flash_attn"] = libs[n]
        for B, T, H, D in CHECKS:
            for dtype in (torch.bfloat16, torch.float32):
                try:
                    cs._k3_against_plain(torch, dev, gen, B, T, H, D, dtype)
                    q, k, v, do = cs.flash_inputs(torch, dev, gen, B, T, H, D, dtype)
                    o, lse = fa.flash_fwd(q, k, v)
                    runs = []
                    for _ in range(2):
                        dq, delta = fa.flash_bwd_dq(q, k, v, o, do, lse)
                        runs.append((dq, delta, *fa.flash_bwd_dkv(q, k, v, do, lse, delta)))
                    cs.check(all(torch.equal(a, b) for a, b in zip(*runs)), "not bitwise repeatable")
                except cs.SmokeFailure as e:
                    failed += 1
                    print(f"check {n} (B {B}, T {T}, H {H}, D {D}) {dtype}: FAILED {e}", flush=True)
        print(f"check {n}: done, {failed} failures so far", flush=True)

    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    order = list(libs)
    for rnd, seq in enumerate((order, order[::-1])):
        for n in seq:
            _cuda._LIBS["flash_attn"] = libs[n]
            for D in cs.SPLIT_DS:
                for dtype in (torch.bfloat16, torch.float32):
                    q, k, v, do = cs.flash_inputs(torch, dev, gen, 2, 1024, 2, D, dtype)
                    o, lse = fa.flash_fwd(q, k, v)
                    _, delta = fa.flash_bwd_dq(q, k, v, o, do, lse)
                    dq_ms = cs.gpu_ms(torch, lambda: fa.flash_bwd_dq(q, k, v, o, do, lse), flush)
                    dkv_ms = cs.gpu_ms(torch, lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta), flush)
                    print(f"time round {rnd} {n} D {D} {str(dtype)[6:]}: dQ {dq_ms:.4f} dK/dV {dkv_ms:.4f} "
                          f"pair {dq_ms + dkv_ms:.4f} ms", flush=True)
    for D in cs.SPLIT_DS:
        for dtype in (torch.bfloat16, torch.float32):
            sdpa = cs._sdpa_ms(torch, *cs.flash_inputs(torch, dev, gen, 2, 1024, 2, D, dtype), flush)
            print(f"sdpa D {D} {str(dtype)[6:]}: whole backward {sdpa['bwd']:.4f} ms", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
