#!/usr/bin/env python3
"""Drive the torch port's online-MF main path on one NVIDIA card.

Run from the repository root on a machine with one CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package.  Phases, one
line each; any failure exits non-zero before the last line:

  1. build   compile every CUDA kernel of the path (one nvcc per source,
             all at once) into build/kernels/.
  2. check   each kernel against its plain torch version on the card, at
             the main path's full width (131,072 items, 65,536-lane Zipf
             microbatch), float32, bfloat16, int32 and packed tables.
  3. main    ``ps_online_mf(..., dim=64, scatter_impl="pallas")`` through
             ``transform_batched``, then ``make_fused_mf_train_step`` at
             dim 128, over 100,000 users x 131,072 items; the launch
             counts are zeroed just before each of the two and read just
             after it: each must launch its kernel once a step and the
             other kernel not at all.
             A small run is held against the CPU (plain) path first.
  4. timing  each kernel's median time beside its bound, its plain
             version's time and (for the scatter-add) ``index_add_``'s.

The line before the last is the card's name and power limit, the last is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

NUM_USERS, NUM_ITEMS, BATCH = 100_000, 131_072, 65_536  # bench.py's main-path shape
DIM_UNFUSED, DIM_FUSED = 64, 128
LEARNING_RATE = 0.01
BATCHES_PER_EPOCH, EPOCHS = 2, 6
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
REPO = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def gpu_ms(torch, fn, flush, reps: int = 15) -> float:
    """Median time of ``fn()`` on the card from CUDA events, L2 flushed
    before each call.  A sleep first holds the stream so calls queue
    behind it and the events time the card, not the host's launches."""
    fn()
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def zipf_batch(rng):
    """bench.py's microbatch: items first, then users and ratings."""
    items = ((rng.zipf(1.2, BATCH) - 1) % NUM_ITEMS).astype(np.int64)
    users = rng.integers(0, NUM_USERS, BATCH).astype(np.int64)
    ratings = rng.normal(0, 1, BATCH).astype(np.float32)
    return items, users, ratings


def phase_build():
    from flink_parameter_server_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    built = _cuda.build()
    print(f"build: {', '.join(_cuda.SOURCES)} ready in {time.perf_counter() - t0:.2f} s "
          f"({len(built)} compiled now, the rest found in {_cuda.BUILD_DIR})")


def _compare(torch, name, got, want, rtol, atol, exact=False):
    """Kernel vs plain version.  Float tolerances: ``atol`` is relative to
    the result's largest magnitude, since a sum taken in another order errs
    in proportion to the run's scale, not to each element."""
    atol = atol * float(want.float().abs().max()) if want.numel() else atol
    ok = torch.equal(got, want) if exact else bool(
        torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)
    )
    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    tol = "exact" if exact else f"rtol={rtol:g} atol={atol:g}"
    print(f"check: {name}: max_abs_err={err:.3e} ({tol}) {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{name} kernel disagrees with its plain version")
    return err


def phase_kernels(torch, dev, gen):
    """Each kernel vs its plain version on identical sorted inputs."""
    from flink_parameter_server_tpu_torch.ops import mf_kernel, scatter_kernel

    rng = np.random.default_rng(0)
    items, users, ratings = zipf_batch(rng)
    ids = torch.from_numpy(items).to(dev)
    ids[:64] = -1  # dropped lanes: negative, past the end, masked
    ids[64:128] = NUM_ITEMS + 5
    mask = torch.rand(BATCH, generator=gen, device=dev) > 0.01
    errs = {}

    def k1(label, dtype, rows, width, sub_k=1):
        W = 128 if sub_k > 1 else width
        if dtype == torch.int32:
            table = torch.randint(0, 2**30, (rows, W), generator=gen, device=dev, dtype=torch.int32)
            deltas = torch.randint(-3, 4, (BATCH, width), generator=gen, device=dev, dtype=torch.int32)
        else:
            table = (torch.randn(rows, W, generator=gen, device=dev) * 0.1).to(dtype)
            deltas = (torch.randn(BATCH, width, generator=gen, device=dev) * 0.01).to(dtype)
        s_ids, s_d = scatter_kernel.sort_lanes(ids, deltas, mask, rows * sub_k, dtype)
        got = scatter_kernel.sorted_scatter_add(table.clone(), s_ids, s_d, sub_k=sub_k)
        want = scatter_kernel.run_sum_write_plain(table.clone(), s_ids, s_d, sub_k=sub_k)
        torch.cuda.synchronize()
        if dtype == torch.int32:
            return _compare(torch, label, got, want, 0, 0, exact=True)
        if dtype == torch.bfloat16:  # one bfloat16 rounding either way
            return _compare(torch, label, got, want, rtol=2**-7, atol=2**-9)
        return _compare(torch, label, got, want, rtol=1e-5, atol=1e-5)

    errs["scatter_add"] = k1(f"scatter_add dense f32 ({NUM_ITEMS},{DIM_UNFUSED})", torch.float32,
                             NUM_ITEMS, DIM_UNFUSED)
    k1(f"scatter_add dense bf16 ({NUM_ITEMS},{DIM_UNFUSED})", torch.bfloat16, NUM_ITEMS, DIM_UNFUSED)
    k1(f"scatter_add dense int32 ({NUM_ITEMS},{DIM_UNFUSED})", torch.int32, NUM_ITEMS, DIM_UNFUSED)
    k1(f"scatter_add packed sub_k=2 f32 ({NUM_ITEMS // 2},128)", torch.float32, NUM_ITEMS // 2,
       DIM_UNFUSED, sub_k=2)

    user_table = torch.randn(NUM_USERS, DIM_FUSED, generator=gen, device=dev) * 0.1
    u = torch.from_numpy(users).to(dev)
    r = torch.from_numpy(ratings).to(dev)

    def k2(label, rows, dim, sub_k=1):
        W = 128 if sub_k > 1 else dim
        table = torch.randn(rows, W, generator=gen, device=dev) * 0.1
        lanes = mf_kernel.sort_lanes(rows * sub_k, user_table[:, :dim], u, ids, r, mask)
        _, s_items, _, s_r, s_m, s_p = lanes
        kw = dict(learning_rate=LEARNING_RATE, regularization=0.01, sub_k=sub_k)
        got_t = table.clone()
        got_u, got_p = mf_kernel.sorted_fused_mf_sgd(got_t, s_items, s_p, s_r, s_m, **kw)
        want_t = table.clone()
        want_u, want_p = mf_kernel.fused_mf_sgd_plain(want_t, s_items, s_p, s_r, s_m, **kw)
        torch.cuda.synchronize()
        e = _compare(torch, f"{label} item table", got_t, want_t, rtol=1e-5, atol=1e-5)
        e = max(e, _compare(torch, f"{label} user deltas", got_u, want_u, rtol=1e-5, atol=1e-5))
        return max(e, _compare(torch, f"{label} predictions", got_p, want_p, rtol=1e-5, atol=1e-5))

    errs["fused_mf_sgd"] = k2(f"fused_mf_sgd dense f32 ({NUM_ITEMS},{DIM_FUSED})", NUM_ITEMS, DIM_FUSED)
    k2(f"fused_mf_sgd packed sub_k=2 f32 ({NUM_ITEMS // 2},128) dim {DIM_UNFUSED}",
       NUM_ITEMS // 2, DIM_UNFUSED, sub_k=2)
    return errs


def _small_run_matches_cpu(torch):
    """The main path on a small input, on the card vs the CPU (plain) path."""
    from flink_parameter_server_tpu_torch import ps_online_mf
    from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
    from flink_parameter_server_tpu_torch.data.streams import microbatches

    data = synthetic_ratings(64, 96, 6 * 32, seed=3)
    runs = {
        dev: ps_online_mf(microbatches(data, 32), num_users=64, num_items=96, dim=16,
                          scatter_impl="pallas", device=dev)
        for dev in ("cuda", "cpu")
    }
    for what in ("items", "users"):
        a, b = (
            (r.store.values() if what == "items" else r.worker_state).cpu() for r in runs.values()
        )
        err = float((a - b).abs().max())
        print(f"main: small run (64 users, 96 items, dim 16) card vs cpu {what}: "
              f"max_abs_err={err:.3e} (rtol=1e-5 atol=1e-6)")
        check(bool(torch.allclose(a, b, rtol=1e-5, atol=1e-6)), f"small run {what} disagree")


def phase_main(torch, dev):
    from flink_parameter_server_tpu_torch import (
        OnlineMatrixFactorization, ShardedParamStore, make_fused_mf_train_step,
        ps_online_mf, ranged_random_factor,
    )
    from flink_parameter_server_tpu_torch.core.transform import to_device
    from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
    from flink_parameter_server_tpu_torch.data.streams import microbatches
    from flink_parameter_server_tpu_torch.ops import mf_kernel, scatter_kernel

    _small_run_matches_cpu(torch)
    data = synthetic_ratings(NUM_USERS, NUM_ITEMS, BATCHES_PER_EPOCH * BATCH, seed=0)
    steps = BATCHES_PER_EPOCH * EPOCHS

    def epoch_rmse(errs):
        return [round(statistics.fmean(errs[i:i + BATCHES_PER_EPOCH]), 6)
                for i in range(0, len(errs), BATCHES_PER_EPOCH)]

    def zero_counts():
        scatter_kernel.sorted_scatter_add.launches = 0
        mf_kernel.sorted_fused_mf_sgd.launches = 0

    def read_counts(path, runs):
        """This path's counts; ``runs`` names the one kernel it must launch
        once a step, and every other kernel must not have launched."""
        counts = {
            "scatter_add": scatter_kernel.sorted_scatter_add.launches,
            "fused_mf_sgd": mf_kernel.sorted_fused_mf_sgd.launches,
        }
        print(f"main: kernel launches in {path}: {counts}")
        for name, n in counts.items():
            want = steps if name == runs else 0
            check(n == want, f"{path} launched {name} {n} times, expected {want}")
        return counts[runs]

    errs, stamps = [], []

    def on_step(i, out):
        errs.append(float(out["error"].pow(2).mean().sqrt()))  # synchronises
        stamps.append(time.perf_counter())

    zero_counts()
    result = ps_online_mf(
        microbatches(data, BATCH, epochs=EPOCHS), num_users=NUM_USERS, num_items=NUM_ITEMS,
        dim=DIM_UNFUSED, learning_rate=LEARNING_RATE, scatter_impl="pallas", device=dev,
        on_step=on_step,
    )
    torch.cuda.synchronize()
    launches = {"scatter_add": read_counts("ps_online_mf", "scatter_add")}
    items, users = result.store.values(), result.worker_state
    rate = (steps - BATCHES_PER_EPOCH) * BATCH / (stamps[-1] - stamps[BATCHES_PER_EPOCH - 1])
    curve = epoch_rmse(errs)
    print(f"main: ps_online_mf scatter_impl=pallas dim {DIM_UNFUSED}: {steps} microbatches of {BATCH}, "
          f"training rmse by epoch {curve}, {rate:.0f} updates/s after the first epoch")
    check(len(errs) == steps, "ps_online_mf ran the wrong number of steps")
    check(tuple(items.shape) == (NUM_ITEMS, DIM_UNFUSED) and tuple(users.shape) == (NUM_USERS, DIM_UNFUSED),
          "ps_online_mf returned tables of the wrong shape")
    check(bool(torch.isfinite(items).all() and torch.isfinite(users).all()), "non-finite MF tables")
    check(curve[-1] < curve[0], "ps_online_mf training error did not fall")

    store = ShardedParamStore.create(NUM_ITEMS, (DIM_FUSED,), init_fn=ranged_random_factor(1, (DIM_FUSED,)),
                                     device=dev)
    item_t = store.table
    user_t = OnlineMatrixFactorization(NUM_USERS, DIM_FUSED, seed=0, device=dev).init_state()
    step = make_fused_mf_train_step(learning_rate=LEARNING_RATE)
    errs.clear()
    stamps.clear()
    zero_counts()
    for batch in microbatches(data, BATCH, epochs=EPOCHS):
        item_t, user_t, out = step(item_t, user_t, to_device(batch, dev))
        on_step(None, out)
    torch.cuda.synchronize()
    launches["fused_mf_sgd"] = read_counts("the fused step", "fused_mf_sgd")
    fused_rate = (steps - BATCHES_PER_EPOCH) * BATCH / (stamps[-1] - stamps[BATCHES_PER_EPOCH - 1])
    curve = epoch_rmse(errs)
    print(f"main: make_fused_mf_train_step dim {DIM_FUSED}: {steps} microbatches of {BATCH}, "
          f"training rmse by epoch {curve}, {fused_rate:.0f} updates/s after the first epoch")
    check(bool(torch.isfinite(item_t).all() and torch.isfinite(user_t).all()), "non-finite fused tables")
    check(curve[-1] < curve[0], "fused training error did not fall")
    return launches


def phase_timing(torch, dev, gen, launches, errs):
    """Median kernel times at the main path's shapes, beside the bound."""
    from flink_parameter_server_tpu_torch.ops import mf_kernel, scatter_kernel

    rng = np.random.default_rng(0)
    items, users, ratings = zipf_batch(rng)
    ids = torch.from_numpy(items).to(dev)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MiB > the 50 MB L2
    n = BATCH
    rows = []

    # K1: the unfused push, dense float32 dim 64
    d = DIM_UNFUSED
    table = torch.randn(NUM_ITEMS, d, generator=gen, device=dev) * 0.1
    deltas = torch.randn(n, d, generator=gen, device=dev) * 0.01
    s_ids, s_d = scatter_kernel.sort_lanes(ids, deltas, None, NUM_ITEMS, torch.float32)
    unique = int(torch.unique_consecutive(s_ids).numel())
    k_ms = gpu_ms(torch, lambda: scatter_kernel.sorted_scatter_add(table, s_ids, s_d), flush)
    p_ms = gpu_ms(torch, lambda: scatter_kernel.run_sum_write_plain(table, s_ids, s_d), flush)
    l_ms = gpu_ms(torch, lambda: table.index_add_(0, ids, deltas), flush)
    nbytes = n * d * 4 + n * 4 + 2 * unique * d * 4
    ops = n * d + unique * d
    rows.append(_row("scatter_add", "flink_parameter_server_tpu_torch/csrc/scatter_add.cu",
                     "flink_parameter_server_tpu/ops/pallas_scatter.py:73", launches, errs,
                     k_ms, p_ms, l_ms, nbytes, ops / F32_OPS_PER_S, unique, f"({NUM_ITEMS},{d}) f32"))

    # K2: the fused step, dense float32 dim 128
    d = DIM_FUSED
    table = torch.randn(NUM_ITEMS, d, generator=gen, device=dev) * 0.1
    user_table = torch.randn(NUM_USERS, d, generator=gen, device=dev) * 0.1
    _, s_items, _, s_r, s_m, s_p = mf_kernel.sort_lanes(
        NUM_ITEMS, user_table, torch.from_numpy(users).to(dev), ids,
        torch.from_numpy(ratings).to(dev), None,
    )
    unique = int(torch.unique_consecutive(s_items).numel())
    kw = dict(learning_rate=LEARNING_RATE, regularization=0.0)
    k_ms = gpu_ms(torch, lambda: mf_kernel.sorted_fused_mf_sgd(table, s_items, s_p, s_r, s_m, **kw), flush)
    p_ms = gpu_ms(torch, lambda: mf_kernel.fused_mf_sgd_plain(table, s_items, s_p, s_r, s_m, **kw), flush)
    nbytes = 2 * n * d * 4 + 4 * n * 4 + 2 * unique * d * 4  # p in, udelta out; ids r m pred; rows
    ops = n * (9 * d + 4) + unique * d
    rows.append(_row("fused_mf_sgd", "flink_parameter_server_tpu_torch/csrc/fused_mf.cu",
                     "flink_parameter_server_tpu/ops/pallas_mf.py:65", launches, errs,
                     k_ms, p_ms, None, nbytes, ops / F32_OPS_PER_S, unique, f"({NUM_ITEMS},{d}) f32"))
    return rows


def _row(name, source, replaces, launches, errs, k_ms, p_ms, l_ms, nbytes, ops_s, unique, shape):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_s * 1e3
    bound_ms, bound_by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
    lib = "n/a" if l_ms is None else f"{l_ms:.4f} ms"
    print(f"timing: {name} {shape}, {BATCH} lanes, {unique} unique rows: kernel {k_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}, {nbytes} B), plain {p_ms:.4f} ms, library {lib}")
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[name], "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": l_ms,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import flink_parameter_server_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script: {e}", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    try:
        phase_build()
        errs = phase_kernels(torch, dev, gen)
        launches = phase_main(torch, dev)
        rows = phase_timing(torch, dev, gen, launches, errs)
        card = card_line()
    except (SmokeFailure, RuntimeError, ValueError, subprocess.SubprocessError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
