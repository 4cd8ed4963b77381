#!/usr/bin/env python3
"""Drive the torch port's two paths on one NVIDIA card: online MF (bare and
through the job envelope) and Transformer LM training through the dense
parameter server.

Run from the repository root on a machine with one CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package.  Phases, one
line each; any failure exits non-zero before the last line:

  1. build   compile every CUDA kernel (one nvcc per source, all at once)
             into build/kernels/.
  2. check   each kernel against its plain torch version on the card: the
             MF kernels at the MF path's full width (131,072 items,
             65,536-lane Zipf microbatch), float32, bfloat16, int32 and
             packed tables, and in float32 twice on the same inputs, which
             must agree bit for bit; the flash-attention forward, dQ and dK/dV at
             the LM's shape (B 16, T 512, H 8, D 64, bfloat16), at B 2,
             T 1024, H 8, D 128 in float32, at head_dim 256 (B 2, T 1024,
             H 4) in both dtypes, and at head_dim 320 and 512 (B 2,
             T 1024, H 2; the column-split kernels) in both dtypes; for
             each bfloat16 output the error of scaled_dot_product_attention
             against the same plain version is printed beside the
             kernel's, as a yardstick.
  determinism  ``ps_online_mf`` twice on the same full-width stream (8
             microbatches) under each ``scatter_impl``: the item table and
             the user state must agree bit for bit; ``index_add_`` and
             ``index_put_(accumulate=True)`` twice on the user scatter's
             inputs, repeatable or not, and their times.
  driver     the job envelope at the MF path's full width (24 microbatches,
             dim 64, ``scatter_impl="pallas"``): an uninterrupted
             ``StreamingDriver`` run (K1 once a step and no other kernel),
             the same stream through ``RecoveringDriver`` with a crash at
             step 13 (restore step 8, replay the WAL tail) bitwise equal to
             it, ``load_model`` of the final checkpoint, the corrupt-latest
             fallback, the NaN guard, and the envelope's costs (updates/s
             against bare ``transform_batched``, a checkpoint save, a WAL
             append, the NaN check), each beside the card's name and power
             limit.  A ``profile_dir`` run comes last of the whole script.
  3. main    ``ps_online_mf(..., dim=64, scatter_impl="pallas")`` through
             ``transform_batched``, then ``make_fused_mf_train_step`` at
             dim 128, over 100,000 users x 131,072 items; then the LM:
             Transformer-base (vocab 32,000, d_model 512, 8 heads, 6
             layers, d_ff 2,048, bfloat16, ``flash_attention="on"``)
             through ``DenseParameterServer(init_params(...), adamw(3e-3))``
             and ``transform_dense`` for 20 steps of 16 x 512 bigram tokens.
             The launch counts are zeroed just before each path and read
             just after it: each path must launch its own kernels (once a
             step for MF, once a layer a step for the LM) and no other.
             A small run of each path is held against the CPU (plain) path
             first, and after the counted runs a few more steps of each
             path (the LM, ps_online_mf, the fused step) are traced with
             torch.profiler.
             Before the LM, small LMs at head_dim 320 (d_model 640, 2
             heads, ``flash_attention="auto"``) in both dtypes must launch
             the three flash kernels and match ``"off"``.
  4. timing  each kernel's median time beside its bound, its plain
             version's time and the library call's (``index_add_`` for
             the scatter-add, ``scaled_dot_product_attention`` forward and
             backward for the flash kernels; K3b + K3c beside the whole
             backward); the column-split kernels' times at head_dim 320
             and 512.

The line before the last is the card's name and power limit, the last is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import itertools
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
BF16_OPS_PER_S = 989e12  # H100 SXM, bfloat16 tensor cores, dense
LM_B, LM_T, LM_H, LM_D = 16, 512, 8, 64  # bench_lm's TPU shape; Transformer-base heads
LM_STEPS, LM_WARMUP, LM_TRACED = 20, 5, 4
MF_TRACED = 4  # MF steps under torch.profiler, after the counted runs
LM_FAMILIES = (("flash", ("fps::flash_",)), ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "matmul")),
               ("softmax", ("softmax",)), ("optimizer", ("multi_tensor",)), ("copy", ("copy",)))
MF_FAMILIES = (("K1/K2 pass 1", ("scatter_tile_pass", "mf_tile_pass")),
               ("K1/K2 pass 2", ("combine_spanning_runs",)), ("sort", ("sort", "radix")),
               ("gather/scatter", ("index", "gather", "scatter")), ("copy", ("copy", "memcpy", "memset")))
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
SPLIT_DS = (320, 512)  # head widths past 256: the column-split kernels
BOUND_TILE = 64  # the causal tiling the flash bound counts, fixed to the work, not to a kernel's tiles
TENSOR_CORES, SIMT = "tensor cores (bf16 mma.sync)", "SIMT (float32 FMA)"
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


def zipf_stream(seed: int, n: int) -> list:
    """``n`` microbatches of :func:`zipf_batch`, made from ``seed``: a list,
    so the same stream can be fed again from the start."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        items, users, ratings = zipf_batch(rng)
        out.append({"user": users.astype(np.int32), "item": items.astype(np.int32), "rating": ratings,
                    "mask": np.ones(BATCH, bool)})
    return out


def phase_determinism(torch, dev):
    """Two runs of ``ps_online_mf`` on the same full-width stream (8
    microbatches) under each ``scatter_impl``, with
    ``torch.use_deterministic_algorithms`` left off: the item table and the
    user state must agree bit for bit (crash recovery rests on it).  Beside
    them, ``index_add_`` itself twice on the user scatter's inputs (65,536
    lanes into 100,000 x 64 float32), whether its bits agree, and its time
    against ``index_put_(accumulate=True)``, the form the port's row
    scatter-add takes on the card."""
    from flink_parameter_server_tpu_torch import ps_online_mf

    check(not torch.are_deterministic_algorithms_enabled(), "deterministic mode is on")
    stream = zipf_stream(1, 8)
    differ = []
    for impl in ("pallas", "xla_sorted", "xla"):
        runs = [ps_online_mf(iter(stream), num_users=NUM_USERS, num_items=NUM_ITEMS, dim=DIM_UNFUSED,
                             learning_rate=LEARNING_RATE, scatter_impl=impl, device=dev,
                             collect_outputs=False, dump_model=False) for _ in range(2)]
        torch.cuda.synchronize()
        same = {}
        for what in ("item table", "user state"):
            a, b = ((r.store.values() if what == "item table" else r.worker_state) for r in runs)
            same[what] = bool(torch.equal(a, b))
            print(f"determinism: ps_online_mf scatter_impl={impl} dim {DIM_UNFUSED}, 8 microbatches twice: "
                  f"{what} bitwise equal: {'yes' if same[what] else 'NO'}, "
                  f"largest difference {float((a - b).abs().max()):.3e}")
        differ += [impl] if not all(same.values()) else []
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    users = torch.from_numpy(stream[0]["user"]).to(dev).long()
    deltas = torch.randn(BATCH, DIM_UNFUSED, generator=gen, device=dev) * 0.01
    table = torch.randn(NUM_USERS, DIM_UNFUSED, generator=gen, device=dev) * 0.1
    forms = {"index_add_": lambda t: t.index_add_(0, users, deltas),
             "index_put_(accumulate=True)": lambda t: t.index_put_((users,), deltas, accumulate=True)}
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    for name, fn in forms.items():
        a, b = fn(table.clone()), fn(table.clone())
        ms = gpu_ms(torch, lambda: fn(table), flush)
        print(f"determinism: {name} ({BATCH} lanes into ({NUM_USERS},{DIM_UNFUSED}) f32, uniform users): "
              f"two calls bitwise equal: {'yes' if torch.equal(a, b) else 'no'}, "
              f"largest difference {float((a - b).abs().max()):.3e}, {ms:.4f} ms")
    check(not differ, f"two runs on the same stream differ under scatter_impl {differ}")


DRIVER_STEPS, DRIVER_CKPT_EVERY, DRIVER_CRASH_AT = 24, 8, 13
DRIVER_REPEATS = 5  # timed runs of each loop (after one untimed run of each)


def _driver_parts(torch, dev, **cfg):
    """The driver phase's job: MF at dim 64 over the main path's tables,
    SGDUpdater(0.01), scatter_impl="pallas", no model dump."""
    from flink_parameter_server_tpu_torch import (
        OnlineMatrixFactorization, SGDUpdater, ShardedParamStore, ranged_random_factor,
    )
    from flink_parameter_server_tpu_torch.training.driver import DriverConfig, StreamingDriver

    logic = OnlineMatrixFactorization(NUM_USERS, DIM_UNFUSED, updater=SGDUpdater(LEARNING_RATE), seed=0,
                                      device=dev)
    store = ShardedParamStore.create(NUM_ITEMS, (DIM_UNFUSED,), init_fn=ranged_random_factor(1, (DIM_UNFUSED,)),
                                     scatter_impl="pallas", device=dev)
    return logic, store, StreamingDriver(logic, store, config=DriverConfig(dump_model=False, **cfg))


def _same(torch, what, a, b):
    equal = bool(torch.equal(a, b))
    print(f"driver: {what}: bitwise equal: {'yes' if equal else 'NO'}, "
          f"largest difference {float((a.double() - b.double()).abs().max()):.3e}")
    check(equal, f"{what} differ")


def phase_driver(torch, dev, card):
    """The job envelope at the main path's full width (100,000 users x
    131,072 items, dim 64, 24 microbatches of 65,536 Zipf-1.2 ratings from a
    seeded stream): an uninterrupted StreamingDriver run (K1 counted: once a
    step, no other kernel), then the same stream through RecoveringDriver
    with a crash at step 13 (restore step 8, replay the WAL tail, finish)
    held bit for bit against it; load_model of the final checkpoint; the
    corrupt-latest fallback; the NaN guard; and the envelope's costs, each
    printed beside the card's name and power limit."""
    import tempfile
    import warnings

    from flink_parameter_server_tpu_torch.core.transform import transform_batched
    from flink_parameter_server_tpu_torch.resilience import (
        FaultPlan, RecoveringDriver, RestartPolicy, corrupt_latest_checkpoint,
    )
    from flink_parameter_server_tpu_torch.training import checkpoint as ckpt
    from flink_parameter_server_tpu_torch.training.driver import TrainingDiverged

    stream = zipf_stream(2, DRIVER_STEPS)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="driver-", dir=os.path.join(REPO, "build")) as tmp:
        # 1. the oracle, K1 counted
        _, _, oracle_drv = _driver_parts(torch, dev)
        snaps = {}

        def snapshot(step, n, table, state, outs):  # the oracle's tables at the fallback step
            if step == 2 * DRIVER_CKPT_EVERY:
                snaps["table"], snaps["state"] = table[:NUM_ITEMS].clone(), state.clone()

        oracle_drv.add_group_hook(snapshot)
        zero_counts()
        oracle = oracle_drv.run(iter(stream))
        torch.cuda.synchronize()
        read_counts("StreamingDriver (oracle)", {"scatter_add": DRIVER_STEPS})
        check(oracle_drv.step_idx == DRIVER_STEPS, "the oracle ran the wrong number of steps")
        check(bool(torch.isfinite(oracle.store.values()).all()), "non-finite oracle table")

        # 2. crash at step 13, restore, replay, finish
        ck, wal = os.path.join(tmp, "ckpt"), os.path.join(tmp, "wal")
        _, _, drv = _driver_parts(torch, dev, checkpoint_every=DRIVER_CKPT_EVERY, checkpoint_dir=ck,
                                  wal_dir=wal, metrics_every=DRIVER_CKPT_EVERY)
        drv.metrics_sink = open(os.devnull, "w")
        drv.add_group_hook(FaultPlan().crash_at(DRIVER_CRASH_AT).driver_hook())
        rec = RecoveringDriver(drv, lambda: iter(stream), policy=RestartPolicy(jitter=0.0, backoff_base_s=0.0))
        zero_counts()
        t0 = time.perf_counter()
        res = rec.run()
        torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
        drv.metrics_sink.close()
        event = rec.events[0]
        print(f"driver: recovery: {rec.restarts} restart ({event['failure']}), restored step "
              f"{event.get('restored_step')}, replayed {event.get('replayed_steps')} WAL steps, "
              f"{drv.step_idx} steps in all, {rec_s:.3f} s; retained checkpoints {drv._ckpt_mgr.all_steps()}")
        check(rec.restarts == 1 and event["failure"] == "device", "recovery did not restart exactly once")
        check(event.get("restored_step") == DRIVER_CKPT_EVERY, "recovery did not restore step 8")
        check(event.get("replayed_steps", 0) >= 1, "recovery replayed no WAL step")
        check(drv.step_idx == DRIVER_STEPS, "recovery ended at the wrong step")
        # K1 once a step, replays included: 13 steps, steps 9..T replayed, T+1..24
        read_counts("RecoveringDriver", {"scatter_add": DRIVER_STEPS + DRIVER_CRASH_AT - DRIVER_CKPT_EVERY})
        _same(torch, "recovered item table vs the uninterrupted run", res.store.values(), oracle.store.values())
        _same(torch, "recovered user state vs the uninterrupted run", res.worker_state, oracle.worker_state)

        # 5. load_model of the final checkpoint
        final = ckpt.load_model(ck, device=dev, scatter_impl="pallas")
        _same(torch, f"load_model of step {drv._ckpt_mgr.latest_step()} vs the uninterrupted run",
              final.values(), oracle.store.values())

        # 4. the corrupt latest: a fresh driver falls back one step
        corrupt_latest_checkpoint(ck, seed=0)
        _, _, fresh = _driver_parts(torch, dev, checkpoint_dir=ck)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            check(fresh.resume(), "resume() after the corruption restored nothing")
        fell_back = [w for w in caught if "falling back" in str(w.message)]
        print(f"driver: corrupt latest checkpoint: resume() warned {len(fell_back)} time(s) and restored "
              f"step {fresh.step_idx}")
        check(len(fell_back) == 1 and fresh.step_idx == 2 * DRIVER_CKPT_EVERY, "no fallback to step 16")
        _same(torch, "fallback table vs the uninterrupted run's at step 16", fresh.store.values(), snaps["table"])
        _same(torch, "fallback user state vs the uninterrupted run's at step 16", fresh._state, snaps["state"])

        # 6. the NaN guard: a table poisoned at step 10 is never checkpointed
        nan_dir = os.path.join(tmp, "nan")
        _, _, guarded = _driver_parts(torch, dev, checkpoint_every=5, nan_check_every=5, checkpoint_dir=nan_dir)

        def poison(step, n, table, state, outs):
            if step == 10:
                table[0, 0] = float("nan")

        guarded.add_group_hook(poison)
        try:
            guarded.run(iter(stream[:12]))
            raised = None
        except TrainingDiverged as e:
            raised = e
        steps = guarded._ckpt_mgr.all_steps()
        print(f"driver: NaN guard: {type(raised).__name__ if raised else 'nothing'} raised at step "
              f"{getattr(raised, 'step', None)}; checkpoints on disk {steps}")
        check(raised is not None and raised.step == 10, "the NaN guard did not fire at step 10")
        check(steps == [5], "a checkpoint after the poisoned step was written")

        _driver_costs(torch, dev, card, stream, tmp, transform_batched, ckpt)


def _driver_costs(torch, dev, card, stream, tmp, transform_batched, ckpt):
    """updates/s through StreamingDriver (with and without its prefetch
    thread) against bare transform_batched on the same stream (one untimed
    run of each, then DRIVER_REPEATS of each in turns, no profiler), one
    checkpoint save (sync and async), one WAL
    append, and the NaN guard's reduction."""
    from flink_parameter_server_tpu_torch import ShardedParamStore
    from flink_parameter_server_tpu_torch.resilience import UpdateWAL
    from flink_parameter_server_tpu_torch.training.driver import _all_finite

    updates = DRIVER_STEPS * BATCH
    # the driver as configured by default, the driver without its prefetch
    # thread, and the bare loop
    arms = {"StreamingDriver": {}, "StreamingDriver prefetch=0": {"prefetch": 0}, "transform_batched": None}
    rates = {name: [] for name in arms}
    for i in range(DRIVER_REPEATS + 1):
        for name, cfg in arms.items():
            logic, store, drv = _driver_parts(torch, dev, **(cfg or {}))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if cfg is not None:
                result = drv.run(iter(stream))
            else:
                result = transform_batched(iter(stream), logic, store, collect_outputs=False, dump_model=False)
            torch.cuda.synchronize()
            if i:  # the first run of each warms up
                rates[name].append(updates / (time.perf_counter() - t0))
    for name, r in rates.items():
        print(f"driver: {name}: {DRIVER_STEPS} microbatches of {BATCH} (tables built and copied in the "
              f"timed call), median {statistics.median(r):.0f} updates/s, spread {min(r):.0f}-{max(r):.0f} "
              f"over {len(r)} runs; {card}")

    table_mb = result.store.values().numel() * 4 / 2**20
    state_mb = result.worker_state.numel() * 4 / 2**20
    for use_async in (False, True):
        mgr = ckpt.JobCheckpointManager(os.path.join(tmp, f"save-{use_async}"), use_async=use_async)
        returned, durable = [], []
        for step in range(1, 4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save(step, result.store, result.worker_state)
            returned.append((time.perf_counter() - t0) * 1e3)
            mgr.wait()
            durable.append((time.perf_counter() - t0) * 1e3)
        mode = "async" if use_async else "sync"
        print(f"driver: checkpoint save ({mode}, {table_mb:.1f} MiB table + {state_mb:.1f} MiB user state): "
              f"median {statistics.median(returned):.2f} ms until save() returns, "
              f"{statistics.median(durable):.2f} ms until durable, over 3 saves; {card}")
    wal = UpdateWAL(os.path.join(tmp, "wal-cost"))
    times = []
    for i, batch in enumerate(stream[:8]):
        t0 = time.perf_counter()
        wal.append(i, 1, batch)
        times.append((time.perf_counter() - t0) * 1e3)
    wal.close()
    print(f"driver: WAL append of one {BATCH}-rating batch ({wal.bytes_written // 8} bytes, fsync each): "
          f"median {statistics.median(times):.3f} ms, spread {min(times):.3f}-{max(times):.3f} over 8; {card}")
    outs = {"prediction": torch.zeros(BATCH, device=dev), "error": torch.zeros(BATCH, device=dev)}
    times = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(bool(_all_finite(outs, result.store.table, result.worker_state)), "finite tables read as not")
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"driver: nan_check (one reduction over the outputs, the item table and the user state, one "
          f"host read): median {statistics.median(times[2:]):.3f} ms over 18; {card}")


def phase_driver_trace(torch, dev):
    """A StreamingDriver run with profile_dir (steps 3-5 of 8 traced), last
    of all: the chrome trace it writes must hold K1's kernel events."""
    import tempfile

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="profile-", dir=os.path.join(REPO, "build")) as tmp:
        _, _, drv = _driver_parts(torch, dev, profile_dir=tmp, profile_steps=(2, 5))
        drv.run(iter(zipf_stream(3, 8)))
        torch.cuda.synchronize()
        traces = [f for f in os.listdir(tmp) if f.endswith(".json")]
        check(len(traces) == 1, f"profile_dir holds {traces}")
        with open(os.path.join(tmp, traces[0])) as fh:
            events = json.load(fh)["traceEvents"]
        k1 = [ev for ev in events if ev.get("cat") == "kernel" and "scatter_tile_pass" in ev.get("name", "")]
        print(f"driver: profile_dir trace: {len(events)} events, {len(k1)} of K1's pass-1 kernel "
              f"(fps::scatter_tile_pass) over the traced steps")
        check(len(k1) >= 1, "the driver's trace holds no K1 kernel event")


def _counters():
    """Every kernel wrapper of the port, by the name the kernels line uses."""
    from flink_parameter_server_tpu_torch.ops import flash_attention as fa
    from flink_parameter_server_tpu_torch.ops import mf_kernel, scatter_kernel

    return {
        "scatter_add": scatter_kernel.sorted_scatter_add,
        "fused_mf_sgd": mf_kernel.sorted_fused_mf_sgd,
        "flash_fwd": fa.flash_fwd,
        "flash_bwd_dq": fa.flash_bwd_dq,
        "flash_bwd_dkv": fa.flash_bwd_dkv,
    }


def zero_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_counts(path: str, want: dict) -> dict:
    """Every kernel's launches since :func:`zero_counts`: those in ``want``
    must have launched exactly that often, every other kernel not at all."""
    counts = {name: fn.launches for name, fn in _counters().items()}
    print(f"main: kernel launches in {path}: {counts}")
    for name, n in counts.items():
        check(n == want.get(name, 0), f"{path} launched {name} {n} times, expected {want.get(name, 0)}")
    return counts


def bigram_batches(n, B, T, vocab, seed=0):
    """examples/transformer_lm.py's token stream: each row follows a fixed
    random permutation from a random first token."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(vocab)
    for _ in range(n):
        toks = np.empty((B, T), np.int32)
        toks[:, 0] = rng.integers(0, vocab, B)
        for t in range(1, T):
            toks[:, t] = perm[toks[:, t - 1]]
        yield {"tokens": toks}


def phase_build():
    from flink_parameter_server_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    built = _cuda.build()
    print(f"build: {', '.join(_cuda.SOURCES)} ready in {time.perf_counter() - t0:.2f} s "
          f"({len(built)} compiled now, the rest found in {_cuda.BUILD_DIR})")
    for name, report in built.items():  # ptxas: registers and spills of each kernel
        kernels = ptxas_report(report)
        for kernel, (regs, spill) in kernels.items():
            print(f"build: {name}: {kernel}: {regs} registers, {spill} bytes spilled")
        spilled = sorted(k for k, (_, b) in kernels.items() if b)
        print(f"build: {name}: {len(kernels)} kernels, {len(spilled)} spill: {spilled or 'none'}")


def ptxas_report(text: str) -> dict:
    """``{kernel: (registers, spill store bytes)}`` from ``-Xptxas -v``."""
    import re

    out, kernel, spill = {}, None, 0
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            kernel, spill = entry.group(1), 0
        stores = re.search(r"(\d+) bytes spill stores", line)
        if stores:
            spill = int(stores.group(1))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and kernel:
            out[_demangled(kernel)] = (int(regs.group(1)), spill)
    return out


def _demangled(symbol: str) -> str:
    """fps::name<template args> from an Itanium-mangled kernel symbol, as far
    as these kernels need: the name, then each type (f, 13__nv_bfloat16) or
    integer (Li64E) argument."""
    import re

    m = re.match(r"_ZN3fps(\d+)", symbol)
    if not m:
        return symbol
    n = int(m.group(1))
    name = symbol[m.end():m.end() + n]
    rest = symbol[m.end() + n:]
    args = []
    if rest.startswith("I"):
        for tok in re.finditer(r"Li(\d+)E|13__nv_bfloat16|(?<=[IE])f", rest.split("EEv")[0] + "E"):
            args.append(tok.group(1) or ("bf16" if "bfloat" in tok.group(0) else "float"))
    return f"{name}<{', '.join(args)}>" if args else name


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

    def same_twice(label, first, again):
        """The kernel's outputs from a second call on the same inputs: no
        atomics, so every bit agrees."""
        ok = all(bool(torch.equal(a, b)) for a, b in zip(first, again))
        print(f"check: {label}: two runs on the same inputs bitwise equal: {'ok' if ok else 'MISMATCH'}")
        check(ok, f"{label} differs between two runs on the same inputs")

    def k1(label, dtype, rows, width, sub_k=1, twice=False):
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
        if twice:
            again = scatter_kernel.sorted_scatter_add(table.clone(), s_ids, s_d, sub_k=sub_k)
            same_twice(label, [got], [again])
        torch.cuda.synchronize()
        if dtype == torch.int32:
            return _compare(torch, label, got, want, 0, 0, exact=True)
        if dtype == torch.bfloat16:  # one bfloat16 rounding either way
            return _compare(torch, label, got, want, rtol=2**-7, atol=2**-9)
        return _compare(torch, label, got, want, rtol=1e-5, atol=1e-5)

    errs["scatter_add"] = k1(f"scatter_add dense f32 ({NUM_ITEMS},{DIM_UNFUSED})", torch.float32,
                             NUM_ITEMS, DIM_UNFUSED, twice=True)
    k1(f"scatter_add dense bf16 ({NUM_ITEMS},{DIM_UNFUSED})", torch.bfloat16, NUM_ITEMS, DIM_UNFUSED)
    k1(f"scatter_add dense int32 ({NUM_ITEMS},{DIM_UNFUSED})", torch.int32, NUM_ITEMS, DIM_UNFUSED)
    k1(f"scatter_add packed sub_k=2 f32 ({NUM_ITEMS // 2},128)", torch.float32, NUM_ITEMS // 2,
       DIM_UNFUSED, sub_k=2)

    user_table = torch.randn(NUM_USERS, DIM_FUSED, generator=gen, device=dev) * 0.1
    u = torch.from_numpy(users).to(dev)
    r = torch.from_numpy(ratings).to(dev)

    def k2(label, rows, dim, sub_k=1, twice=False):
        W = 128 if sub_k > 1 else dim
        table = torch.randn(rows, W, generator=gen, device=dev) * 0.1
        lanes = mf_kernel.sort_lanes(rows * sub_k, user_table[:, :dim], u, ids, r, mask)
        _, s_items, _, s_r, s_m, s_p = lanes
        kw = dict(learning_rate=LEARNING_RATE, regularization=0.01, sub_k=sub_k)
        got_t = table.clone()
        got_u, got_p = mf_kernel.sorted_fused_mf_sgd(got_t, s_items, s_p, s_r, s_m, **kw)
        want_t = table.clone()
        want_u, want_p = mf_kernel.fused_mf_sgd_plain(want_t, s_items, s_p, s_r, s_m, **kw)
        if twice:
            again_t = table.clone()
            again = mf_kernel.sorted_fused_mf_sgd(again_t, s_items, s_p, s_r, s_m, **kw)
            same_twice(label, [got_t, got_u, got_p], [again_t, *again])
        torch.cuda.synchronize()
        e = _compare(torch, f"{label} item table", got_t, want_t, rtol=1e-5, atol=1e-5)
        e = max(e, _compare(torch, f"{label} user deltas", got_u, want_u, rtol=1e-5, atol=1e-5))
        return max(e, _compare(torch, f"{label} predictions", got_p, want_p, rtol=1e-5, atol=1e-5))

    errs["fused_mf_sgd"] = k2(f"fused_mf_sgd dense f32 ({NUM_ITEMS},{DIM_FUSED})", NUM_ITEMS, DIM_FUSED,
                              twice=True)
    k2(f"fused_mf_sgd packed sub_k=2 f32 ({NUM_ITEMS // 2},128) dim {DIM_UNFUSED}",
       NUM_ITEMS // 2, DIM_UNFUSED, sub_k=2)
    errs.update(_flash_checks(torch, dev, gen))
    return errs


def flash_inputs(torch, dev, gen, B, T, H, D, dtype):
    """q, k, v as the LM hands them to the kernels: q scaled by 1/sqrt(D)
    in float32 and contiguous, k and v strided views of one (B, T, 3, H, D)
    projection; and a random dO."""
    qkv = (torch.randn(B, T, 3, H, D, generator=gen, device=dev) * 0.8).to(dtype)
    q = (qkv[:, :, 0].float() * D**-0.5).to(dtype).contiguous()
    do = torch.randn(B, T, H, D, generator=gen, device=dev).to(dtype)
    return q, qkv[:, :, 1], qkv[:, :, 2], do


def _flash_checks(torch, dev, gen):
    """K3a/b/c vs their plain versions on identical inputs, at the LM's
    shape in bfloat16, at a longer, wider float32 shape, at head_dim 256 in
    both dtypes (bfloat16 runs the tensor-core kernels, float32 the SIMT
    kernels), and at head_dim 320 and 512 in both dtypes (the column-split
    SIMT kernels).

    Tolerances.  float32: rtol 1e-5 and atol 1e-5 of the largest value, as
    for K1: both sides sum the same float32 products in another order.
    bfloat16: the outputs (O, dQ, dK, dV) are rounded to bfloat16 from
    float32 values that differ only in summation order (the forward's P
    split into two bf16 operands carries it to about 2**-16; the dQ kernel
    rounds dS, and the dK/dV kernel P and dS, to bfloat16 as their plain
    versions do), so they may land one bfloat16 unit apart: rtol 2**-7 and
    atol 2**-8 of the largest value (about 2**-8 relative).  L and D stay
    float32 in both, so they keep the float32 bar.  For each bfloat16
    output, scaled_dot_product_attention's own error against the same
    plain version is printed: the bar is no looser than the library's
    error."""
    from flink_parameter_server_tpu_torch.ops import flash_attention as fa

    errs = {}
    shapes = ((LM_B, LM_T, LM_H, LM_D, torch.bfloat16), (2, 1024, 8, 128, torch.float32),
              (2, 1024, 4, 256, torch.bfloat16), (2, 1024, 4, 256, torch.float32)) + tuple(
                  (2, 1024, 2, D, dtype) for D in SPLIT_DS for dtype in (torch.bfloat16, torch.float32))
    for B, T, H, D, dtype in shapes:
        q, k, v, do = flash_inputs(torch, dev, gen, B, T, H, D, dtype)
        o, lse = fa.flash_fwd(q, k, v)
        dq, delta = fa.flash_bwd_dq(q, k, v, o, do, lse)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        o_p, lse_p = fa.flash_fwd_plain(q, k, v)
        dq_p, delta_p = fa.flash_bwd_dq_plain(q, k, v, o, do, lse)
        dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta)
        tol = dict(rtol=2**-7, atol=2**-8) if dtype == torch.bfloat16 else dict(rtol=1e-5, atol=1e-5)
        f32 = dict(rtol=1e-5, atol=1e-5)
        label = f"(B {B}, T {T}, H {H}, D {D}) {str(dtype).replace('torch.', '')}"
        found = {
            "flash_fwd": max(_compare(torch, f"flash_fwd O {label}", o, o_p, **tol),
                             _compare(torch, f"flash_fwd L {label}", lse, lse_p, **f32)),
            "flash_bwd_dq": max(_compare(torch, f"flash_bwd_dq dQ {label}", dq, dq_p, **tol),
                                _compare(torch, f"flash_bwd_dq D {label}", delta, delta_p, **f32)),
            "flash_bwd_dkv": max(_compare(torch, f"flash_bwd_dkv dK {label}", dk, dk_p, **tol),
                                 _compare(torch, f"flash_bwd_dkv dV {label}", dv, dv_p, **tol)),
        }
        if dtype == torch.bfloat16:
            _sdpa_yardstick(torch, label, q, k, v, do, {"O": o_p, "dQ": dq_p, "dK": dk_p, "dV": dv_p})
        if not errs:  # the LM's shape: the error the kernels line reports
            errs = found
    return errs


def _sdpa_yardstick(torch, label, q, k, v, do, plain):
    """scaled_dot_product_attention's max error against the plain versions
    on the same bfloat16 inputs (timed nowhere, called nowhere in the port)."""
    import torch.nn.functional as F

    heads = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]  # (B, H, T, D) views
    out = F.scaled_dot_product_attention(*heads, is_causal=True, scale=1.0)
    grads = torch.autograd.grad(out, heads, do.transpose(1, 2))
    lib = {"O": out.detach().transpose(1, 2), "dQ": grads[0].transpose(1, 2), "dK": grads[1].transpose(1, 2),
           "dV": grads[2].transpose(1, 2)}
    errs = ", ".join(f"{n} {float((lib[n].double() - plain[n].double()).abs().max()):.3e}" for n in plain)
    print(f"check: yardstick {label}: scaled_dot_product_attention vs the plain versions: {errs}")


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

    _small_run_matches_cpu(torch)
    data = synthetic_ratings(NUM_USERS, NUM_ITEMS, BATCHES_PER_EPOCH * BATCH, seed=0)
    steps = BATCHES_PER_EPOCH * EPOCHS

    def epoch_rmse(errs):
        return [round(statistics.fmean(errs[i:i + BATCHES_PER_EPOCH]), 6)
                for i in range(0, len(errs), BATCHES_PER_EPOCH)]

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
    launches = {"scatter_add": read_counts("ps_online_mf", {"scatter_add": steps})["scatter_add"]}
    items, users = result.store.values(), result.worker_state
    rate = (steps - BATCHES_PER_EPOCH) * BATCH / (stamps[-1] - stamps[BATCHES_PER_EPOCH - 1])
    curve = epoch_rmse(errs)
    print(f"main: ps_online_mf scatter_impl=pallas dim {DIM_UNFUSED}: {steps} microbatches of {BATCH}, "
          f"training rmse by epoch {curve}, {rate:.0f} updates/s after the first epoch, "
          f"median step {median_step_ms(stamps):.3f} ms")
    check(len(errs) == steps, "ps_online_mf ran the wrong number of steps")
    check(tuple(items.shape) == (NUM_ITEMS, DIM_UNFUSED) and tuple(users.shape) == (NUM_USERS, DIM_UNFUSED),
          "ps_online_mf returned tables of the wrong shape")
    check(bool(torch.isfinite(items).all() and torch.isfinite(users).all()), "non-finite MF tables")
    check(curve[-1] < curve[0], "ps_online_mf training error did not fall")
    unfused_ms = median_step_ms(stamps)

    def drive_unfused(after_step):
        ps_online_mf(
            itertools.islice(microbatches(data, BATCH, epochs=EPOCHS), MF_TRACED + 2), num_users=NUM_USERS,
            num_items=NUM_ITEMS, dim=DIM_UNFUSED, learning_rate=LEARNING_RATE, scatter_impl="pallas",
            device=dev, on_step=lambda i, out: after_step(out),
        )

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
    launches["fused_mf_sgd"] = read_counts("the fused step", {"fused_mf_sgd": steps})["fused_mf_sgd"]
    fused_rate = (steps - BATCHES_PER_EPOCH) * BATCH / (stamps[-1] - stamps[BATCHES_PER_EPOCH - 1])
    curve = epoch_rmse(errs)
    print(f"main: make_fused_mf_train_step dim {DIM_FUSED}: {steps} microbatches of {BATCH}, "
          f"training rmse by epoch {curve}, {fused_rate:.0f} updates/s after the first epoch, "
          f"median step {median_step_ms(stamps):.3f} ms")
    check(bool(torch.isfinite(item_t).all() and torch.isfinite(user_t).all()), "non-finite fused tables")
    check(curve[-1] < curve[0], "fused training error did not fall")

    def drive_fused(after_step):
        tables = [item_t, user_t]
        for batch in itertools.islice(microbatches(data, BATCH, epochs=EPOCHS), MF_TRACED + 2):
            tables[0], tables[1], out = step(tables[0], tables[1], to_device(batch, dev))
            after_step(out)

    fused_ms = median_step_ms(stamps)
    launches.update(phase_lm(torch, dev))
    # after every counted run, so that no counted run follows a profiler
    # session in this process
    _trace_mf_steps("ps_online_mf", drive_unfused, unfused_ms)
    _trace_mf_steps("fused MF", drive_fused, fused_ms)
    return launches


def median_step_ms(stamps) -> float:
    """The counted run's median step after the first epoch, from the
    host's stamps (each taken after a synchronising read of the step)."""
    tail = stamps[BATCHES_PER_EPOCH - 1:]
    return statistics.median((b - a) * 1e3 for a, b in zip(tail, tail[1:]))


def _trace_mf_steps(what, drive, step_ms):
    """Where an MF step's time goes, outside the counted run: ``drive``
    runs MF_TRACED + 2 steps, calling its argument after each with the
    step's output; the first two are skipped (set-up, warm-up) and the rest
    recorded by torch.profiler.  Each step ends in the same synchronising
    read of the error as in the counted run."""
    from torch.profiler import ProfilerActivity, profile, schedule

    found = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=MF_TRACED, repeat=1),
                 on_trace_ready=lambda p: found.append(p.key_averages())) as prof:
        def after_step(out):
            float(out["error"].pow(2).mean())
            prof.step()

        drive(after_step)
    if not found:
        print(f"trace: torch.profiler recorded no {what} steps; the step breakdown is not measured")
        return
    _report_trace(found[-1], what, MF_TRACED, step_ms, MF_FAMILIES)


def _report_trace(averages, what, steps, step_ms, rules):
    """Device time a step by kernel family, device busy and idle share
    against ``step_ms`` (the counted run's median step), and the ten device
    kernels and host operators that take the most time."""
    # kernel events only: an operator's row, and a range such as
    # Optimizer.step's, repeat their kernels' time
    kernels = [ev for ev in averages
               if str(ev.device_type).endswith("CUDA") and ev.self_device_time_total > 0
               and not getattr(ev, "is_user_annotation", False) and "#" not in ev.key]
    families = dict.fromkeys([name for name, _ in rules] + ["other"], 0.0)
    for ev in kernels:
        key = ev.key.lower()
        family = next((name for name, marks in rules if any(m in key for m in marks)), "other")
        families[family] += ev.self_device_time_total
    busy = sum(families.values())
    if busy <= 0:
        print(f"trace: torch.profiler showed no device time for {what}; the step breakdown is not measured")
        return
    per_step = busy / 1e3 / steps
    shares = ", ".join(f"{k} {v / 1e3 / steps:.3f} ms ({v / busy:.1%})" for k, v in families.items())
    print(f"trace: {steps} {what} steps, device time a step by family: {shares}; device busy "
          f"{per_step:.3f} ms a step against the counted run's median step {step_ms:.3f} ms "
          f"(idle {1 - per_step / step_ms:.1%})")
    for ev in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"trace:   device {ev.self_device_time_total / 1e3 / steps:9.3f} ms a step  "
              f"{ev.count // steps:4d}x  {ev.key[:90]}")
    host = [ev for ev in averages if not str(ev.device_type).endswith("CUDA")]
    for ev in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"trace:   host {ev.self_cpu_time_total / 1e3 / steps:9.3f} ms a step  "
              f"{ev.count // steps:4d}x  {ev.key[:90]}")


def _small_lm_matches_cpu(torch):
    """A tiny float32 LM (vocab 256, d_model 128, 2 heads, 2 layers, T 128,
    B 4), 3 sgd(0.1) steps from the same weights: on the card with
    flash_attention="on" (the kernels) vs the CPU with "auto" (the reference
    attention).  Tolerance rtol 1e-4 / atol 1e-5: float32 throughout, but
    the card's products, the flash kernels' sums and the CPU's einsum
    attention add in different orders, and three steps carry that on."""
    from flink_parameter_server_tpu_torch import (
        DenseParameterServer, TransformerConfig, init_params, lm_loss, sgd, transform_dense,
    )
    from flink_parameter_server_tpu_torch.interop import transformer_params_to_numpy

    small = dict(vocab_size=256, d_model=128, n_heads=2, n_layers=2, d_ff=256, max_seq=128,
                 dtype=torch.float32)
    runs = {}
    for dev, mode in (("cuda", "on"), ("cpu", "auto")):
        cfg = TransformerConfig(**small, flash_attention=mode)
        model = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
        losses = []
        result = transform_dense(bigram_batches(3, 4, 128, 256, seed=1), lambda m, b, c=cfg: lm_loss(m, b, c),
                                 DenseParameterServer(model, sgd(0.1)),
                                 on_step=lambda i, loss, out=losses: out.append(float(loss)))
        runs[mode] = (np.array(losses), transformer_params_to_numpy(result.server_outputs[0]))
    (card_l, card_p), (cpu_l, cpu_p) = runs["on"], runs["auto"]
    leaves = lambda t: [t["embed"], t["final_norm"]] + [v for layer in t["layers"] for v in layer.values()]  # noqa: E731
    pairs = [(card_l, cpu_l)] + list(zip(leaves(card_p), leaves(cpu_p)))
    err = max(float(np.abs(a - b).max()) for a, b in pairs)
    ok = all(np.allclose(a, b, rtol=1e-4, atol=1e-5) for a, b in pairs)
    print(f"main: small LM (vocab 256, d 128, 2 layers, T 128, B 4, f32, sgd 0.1, 3 steps) card 'on' "
          f"vs cpu 'auto': losses {card_l.round(6).tolist()} vs {cpu_l.round(6).tolist()}, "
          f"max_abs_err over losses and params {err:.3e} (rtol=1e-4 atol=1e-5) {'ok' if ok else 'MISMATCH'}")
    check(ok, "small LM run on the card disagrees with the CPU")


def _wide_lm_matches_off(torch, dev, dtype):
    """A small LM at head_dim 320 (vocab 64, d_model 640, 2 heads, 1 layer,
    T 256, B 2) under flash_attention="auto": one forward and backward must
    launch each flash kernel once (the column-split kernels) and match
    "off" (the reference attention).  Tolerances, those of the card tests:
    float32 loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-6; bfloat16 loss
    rtol 1e-2 and each gradient within 2**-4 of its largest magnitude (the
    reference rounds its einsums to bfloat16, the kernels keep float32)."""
    import dataclasses

    from flink_parameter_server_tpu_torch import TransformerConfig, init_params, lm_loss

    cfg = TransformerConfig(vocab_size=64, d_model=640, n_heads=2, n_layers=1, d_ff=128, max_seq=256,
                            dtype=dtype, flash_attention="auto")
    model = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    batch = {"tokens": torch.randint(0, 64, (2, 256), generator=torch.Generator().manual_seed(1)).to(dev)}
    zero_counts()
    loss = lm_loss(model, batch, cfg)
    loss.backward()
    torch.cuda.synchronize()
    name = f"small LM head_dim {cfg.head_dim} {str(dtype).replace('torch.', '')} 'auto'"
    read_counts(name, {n: 1 for n in FLASH})
    got = [p.grad.clone() for p in model.parameters()]
    model.zero_grad()
    off = lm_loss(model, batch, dataclasses.replace(cfg, flash_attention="off"))
    off.backward()
    pairs = list(zip(got, (p.grad for p in model.parameters())))
    if dtype == torch.float32:
        ok = bool(torch.allclose(loss, off, rtol=1e-5, atol=0)) and all(
            bool(torch.allclose(a, g, rtol=1e-4, atol=1e-6)) for a, g in pairs)
    else:
        ok = bool(torch.allclose(loss.float(), off.float(), rtol=1e-2, atol=0)) and all(
            bool(torch.allclose(a.float(), g.float(), rtol=0, atol=2**-4 * float(g.float().abs().max())))
            for a, g in pairs)
    err = max(float((a.double() - g.double()).abs().max()) for a, g in pairs)
    print(f"main: {name} vs 'off': loss {loss.item():.6f} vs {off.item():.6f}, "
          f"max gradient difference {err:.3e} {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{name} disagrees with the reference attention")


def phase_lm(torch, dev):
    """Transformer-base LM training at full width through the dense PS, as
    examples/transformer_lm.py --mode single drives it."""
    from flink_parameter_server_tpu_torch import (
        DenseParameterServer, TransformerConfig, adamw, init_params, lm_loss, transform_dense,
    )

    _small_lm_matches_cpu(torch)
    for dtype in (torch.float32, torch.bfloat16):
        _wide_lm_matches_off(torch, dev, dtype)
    cfg = TransformerConfig(flash_attention="on")  # the defaults are Transformer-base, bfloat16
    check(cfg.head_dim == LM_D and cfg.n_heads == LM_H, "Transformer-base heads changed")
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    server = DenseParameterServer(model, adamw(3e-3))
    batches = list(bigram_batches(LM_STEPS + LM_TRACED, LM_B, LM_T, cfg.vocab_size, seed=0))
    loss_fn = lambda m, b: lm_loss(m, b, cfg)  # noqa: E731
    losses, stamps = [], []

    def on_step(i, loss):
        losses.append(float(loss))  # synchronises once a step
        stamps.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    result = transform_dense(batches[:LM_STEPS], loss_fn, server, on_step=on_step)
    torch.cuda.synchronize()
    per_run = cfg.n_layers * LM_STEPS
    counts = read_counts("transform_dense (LM)", {name: per_run for name in FLASH})
    peak = torch.cuda.max_memory_allocated()
    tokens = LM_B * LM_T
    rate = (LM_STEPS - LM_WARMUP) * tokens / (stamps[-1] - stamps[LM_WARMUP - 1])
    steps_ms = [round((b - a) * 1e3, 3) for a, b in zip(stamps[LM_WARMUP - 1:], stamps[LM_WARMUP:])]
    print(f"main: LM Transformer-base ({n_params} params, {str(cfg.dtype).replace('torch.', '')}, "
          f"flash on) {LM_STEPS} steps of "
          f"{LM_B}x{LM_T} tokens, adamw(3e-3): loss by step {[round(x, 4) for x in losses]}")
    print(f"main: LM {rate:.0f} tokens/s after {LM_WARMUP} warm-up steps (one sync a step), "
          f"step ms {steps_ms}, peak memory {peak / 2**30:.2f} GiB")
    check(len(losses) == LM_STEPS and all(np.isfinite(losses)), "LM losses missing or not finite")
    check(statistics.fmean(losses[-5:]) < losses[0], "LM loss did not fall")
    final = result.server_outputs[0]
    check(all(bool(torch.isfinite(p).all()) for p in final.parameters()), "non-finite LM parameters")
    _trace_lm_steps(torch, final, loss_fn, batches[LM_STEPS:], statistics.median(steps_ms))
    return {name: counts[name] for name in FLASH}


def _trace_lm_steps(torch, model, loss_fn, batches, step_ms):
    """Where an LM step's time goes, outside the counted run.  First the
    steps with no synchronisation between them (the host may run ahead of
    the card), on the host clock; then the same steps under torch.profiler:
    device time by kernel family (the flash kernels, the matrix products,
    the rest), the device's idle share against ``step_ms`` (the counted
    run's median step), and the host operators that take the most time."""
    from torch.profiler import ProfilerActivity, profile

    from flink_parameter_server_tpu_torch import adamw, make_dense_train_step
    from flink_parameter_server_tpu_torch.core.transform import to_device

    step = make_dense_train_step(loss_fn)
    opt = adamw(3e-3)(model.parameters())
    dev = next(model.parameters()).device

    def run():
        for batch in batches:
            step(model, opt, to_device(batch, dev))
        torch.cuda.synchronize()

    run()  # warm: the optimizer's state
    t0 = time.perf_counter()
    run()
    free_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    print(f"trace: with no synchronisation between LM steps a step takes {free_ms:.3f} ms on the host clock")
    _report_trace(prof.key_averages(), "LM", len(batches), step_ms, LM_FAMILIES)


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
                     k_ms, p_ms, l_ms, nbytes, ops / F32_OPS_PER_S,
                     f"({NUM_ITEMS},{d}) f32, {BATCH} lanes, {unique} unique rows"))

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
                     k_ms, p_ms, None, nbytes, ops / F32_OPS_PER_S,
                     f"({NUM_ITEMS},{d}) f32, {BATCH} lanes, {unique} unique rows"))
    rows += _flash_timing(torch, dev, gen, flush, launches, errs)
    return rows


def _flash_timing(torch, dev, gen, flush, launches, errs):
    """K3a/b/c at the LM's shape (bfloat16).  Bound: the larger of the
    bytes (each input read once, each output written once) over 3.35 TB/s
    and the products of the 64 x 64 tiles the causal mask keeps over the
    bfloat16 tensor-core peak.  Library: scaled_dot_product_attention,
    forward for K3a and its backward (dQ, dK and dV together) for K3b and
    K3c; it is timed here only and the port never calls it."""
    import torch.nn.functional as F

    from flink_parameter_server_tpu_torch.ops import flash_attention as fa

    B, T, H, D = LM_B, LM_T, LM_H, LM_D
    q, k, v, do = flash_inputs(torch, dev, gen, B, T, H, D, torch.bfloat16)
    o, lse = fa.flash_fwd(q, k, v)
    dq, delta = fa.flash_bwd_dq(q, k, v, o, do, lse)
    elems, stat = B * T * H * D * q.element_size(), B * H * T * 4
    n = T // BOUND_TILE
    tile_products = n * (n + 1) // 2 * B * H * 2 * BOUND_TILE * BOUND_TILE * D  # flops of one product per kept tile

    heads = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]  # (B, H, T, D) views
    out = F.scaled_dot_product_attention(*heads, is_causal=True, scale=1.0)
    do_h = do.transpose(1, 2)
    sdpa_fwd = gpu_ms(torch, lambda: F.scaled_dot_product_attention(
        *(t.detach() for t in heads), is_causal=True, scale=1.0), flush)
    sdpa_bwd = gpu_ms(torch, lambda: torch.autograd.grad(out, heads, do_h, retain_graph=True), flush)
    cases = [
        ("flash_fwd", lambda: fa.flash_fwd(q, k, v), lambda: fa.flash_fwd_plain(q, k, v), sdpa_fwd,
         4 * elems + stat, 2 * tile_products, ":1137 forward", TENSOR_CORES),
        ("flash_bwd_dq", lambda: fa.flash_bwd_dq(q, k, v, o, do, lse),
         lambda: fa.flash_bwd_dq_plain(q, k, v, o, do, lse), sdpa_bwd,
         6 * elems + 2 * stat, 3 * tile_products, ":1635 dQ", TENSOR_CORES),
        ("flash_bwd_dkv", lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta),
         lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta), sdpa_bwd,
         6 * elems + 2 * stat, 4 * tile_products, ":2196 dK/dV", TENSOR_CORES),
    ]
    rows = []
    for name, kernel, plain, l_ms, nbytes, flops, splash, design in cases:
        k_ms = gpu_ms(torch, kernel, flush)
        p_ms = gpu_ms(torch, plain, flush, reps=5)
        rows.append(_row(
            name, "flink_parameter_server_tpu_torch/csrc/flash_attn.cu",
            f"flink_parameter_server_tpu/ops/flash_attention.py:117 (splash_attention_kernel.py{splash})",
            launches, errs, k_ms, p_ms, l_ms, nbytes, flops / BF16_OPS_PER_S,
            f"(B {B}, T {T}, H {H}, D {D}) bf16, {flops} flops in kept tiles, "
            f"{launches[name] // LM_STEPS} launches a step", design))
    dq_ms, dkv_ms = rows[1]["ms"], rows[2]["ms"]
    print(f"timing: the backward, K3b + K3c {dq_ms:.4f} + {dkv_ms:.4f} = {dq_ms + dkv_ms:.4f} ms "
          f"against scaled_dot_product_attention's whole backward (dQ, dK, dV) {sdpa_bwd:.4f} ms "
          f"({(dq_ms + dkv_ms) / sdpa_bwd:.2f}x)")
    _split_timing(torch, dev, gen, flush)
    return rows


def _split_timing(torch, dev, gen, flush):
    """The column-split kernels (head widths past 256) at B 2, T 1024, H 2:
    each kernel's median time, beside the same kernel at head_dim 256 (its
    own template) for scale."""
    from flink_parameter_server_tpu_torch.ops import flash_attention as fa

    for dtype in (torch.bfloat16, torch.float32):
        for D in (256,) + SPLIT_DS:
            q, k, v, do = flash_inputs(torch, dev, gen, 2, 1024, 2, D, dtype)
            o, lse = fa.flash_fwd(q, k, v)
            dq, delta = fa.flash_bwd_dq(q, k, v, o, do, lse)
            times = [gpu_ms(torch, fn, flush) for fn in (
                lambda: fa.flash_fwd(q, k, v), lambda: fa.flash_bwd_dq(q, k, v, o, do, lse),
                lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta))]
            route = "column-split SIMT" if D in SPLIT_DS else "own template"
            print(f"timing: (B 2, T 1024, H 2, D {D}) {str(dtype).replace('torch.', '')}, {route}: "
                  f"flash_fwd {times[0]:.4f} ms, flash_bwd_dq {times[1]:.4f} ms, "
                  f"flash_bwd_dkv {times[2]:.4f} ms")


def _row(name, source, replaces, launches, errs, k_ms, p_ms, l_ms, nbytes, ops_s, detail, design=SIMT):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_s * 1e3
    bound_ms, bound_by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
    lib = "n/a" if l_ms is None else f"{l_ms:.4f} ms"
    print(f"timing: {name} {detail}, {design}: kernel {k_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}, {nbytes} B), plain {p_ms:.4f} ms, library {lib}")
    return {
        "name": name, "route": "cuda", "design": design, "source": source, "replaces": replaces,
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
        phase_determinism(torch, dev)
        card = card_line()
        phase_driver(torch, dev, card)
        launches = phase_main(torch, dev)
        rows = phase_timing(torch, dev, gen, launches, errs)
        phase_driver_trace(torch, dev)
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
