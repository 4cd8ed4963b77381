"""One rank of a gloo mesh battery for the port's multi-device tests.

    python tests/_torch_mesh_child.py <init_method> <world> <rank> <battery> <outdir>

Launched ``world`` times by :func:`run_battery` (from
``tests/test_torch_parallel*.py``).  Every rank joins a gloo process group
on the CPU (cards hidden), builds the battery's mesh, and runs each case of
the named battery in order, in lockstep with the other ranks.  A case
writes ``<outdir>/<case>.r<rank>.npz`` (its inputs and outputs, made from
seeds with numpy, so the test can feed the same inputs to the JAX
reference) or ``<case>.r<rank>.err`` with the traceback.  The script
imports only the standard library, numpy, torch and the port, never JAX.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
import traceback
import types
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
# world size and the (dp, ps) mesh of each battery; a 1-tuple is the 1-D
# ("dp",) mesh of the dense LM's batteries (tests/_torch_dense_cases.py)
BATTERIES = {"grid": (4, (2, 2)), "grid_mf": (4, (2, 2)), "wide": (8, (2, 4)), "pair": (2, (2, 1)),
             "dense": (4, (4,)), "dense2": (2, (2,)),
             "ep8": (8, (1, 8)), "ep24": (8, (2, 4)), "moe_dp": (4, (4,)), "mp": (8, (2, 4))}
# the axis names of a 2-D battery's mesh, where they are not ("dp", "ps"):
# expert parallelism's ("dp", "ep") (tests/_torch_moe_cases.py), sequence
# parallelism's ("dp", "sp") (tests/_torch_mp_cases.py, whose cases build
# their other meshes over the same ranks)
AXES = {"ep8": ("dp", "ep"), "ep24": ("dp", "ep"), "mp": ("dp", "sp")}


def run_battery(battery: str, outdir: Path, *, timeout: float = 150.0) -> dict:
    """Spawn the battery's ranks, wait at most ``timeout`` seconds (then
    kill them all), and return ``{case: [per-rank dict or error text]}``
    plus ``"_log"``, the ranks' combined output."""
    world, _ = BATTERIES[battery]
    outdir.mkdir(parents=True, exist_ok=True)
    # a file rendezvous in the battery's own directory: no port to race for
    init = "file://" + str((outdir / "rendezvous").resolve())
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    logs = [outdir / f"rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, init, str(world), str(r), battery, str(outdir)],
                env=env, stdout=fh, stderr=subprocess.STDOUT, cwd=ROOT,
            ))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = {"_log": "\n".join(f"--- rank {r} (rc {p.returncode})\n{logs[r].read_text()}"
                             for r, p in enumerate(procs))}
    for f in sorted(outdir.glob("*.r*.*")):
        case, rank_part = f.name.split(".")[:2]
        rank = int(rank_part[1:])
        slot = out.setdefault(case, [None] * world)
        if f.suffix == ".npz":
            with np.load(f) as z:
                slot[rank] = {k: z[k] for k in z.files}
        else:
            slot[rank] = f.read_text()
    return out


# --------------------------------------------------------------------------
# the cases (run on every rank; ``c`` carries the mesh and the rank)
# --------------------------------------------------------------------------


def _np(t):
    import torch

    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return np.asarray(t)


def _tensor_batch(b):
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def case_store_matches_single(c):
    import torch
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

    init = ranged_random_factor(seed=3, value_shape=(8,))
    sharded = ShardedParamStore.create(64, (8,), init_fn=init, mesh=c.mesh)
    local = ShardedParamStore.create(64, (8,), init_fn=init, device="cpu")
    ids = torch.tensor([0, 5, 63, 31, 5])
    deltas = torch.ones(5, 8)
    a, b = sharded.push(ids, deltas), local.push(ids, deltas)
    return dict(init=_np(sharded.values()), init_single=_np(local.values()),
                block=_np(sharded.table), pushed=_np(a.values()), pushed_single=_np(b.values()),
                pulled=_np(a.pull(ids)), pulled_single=_np(b.pull(ids)), ids=_np(ids))


def case_from_values(c):
    import torch
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore

    values = torch.arange(20.0).reshape(10, 2)
    store = ShardedParamStore.from_values(values, mesh=c.mesh)
    return dict(values=_np(store.values()), pulled=_np(store.pull(torch.tensor([7]))))


def case_shard_pull(c):
    import torch
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.parallel.collectives import shard_pull

    table = torch.arange(64 * 4, dtype=torch.float32).reshape(64, 4)
    store = ShardedParamStore.from_values(table, mesh=c.mesh)
    ids = torch.tensor([[0, 17, 63], [5, 5, 32]], dtype=torch.int32)
    mine = ids[c.dp_index:c.dp_index + 1]  # this rank's dp block of the lanes
    return dict(ids=_np(ids), got=_np(shard_pull(store.table, mine, mesh=c.mesh)),
                dp_index=np.int64(c.dp_index))


def case_shard_push(c):
    import torch
    from flink_parameter_server_tpu_torch.parallel.collectives import all_gather_cat, shard_push_add
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore

    store = ShardedParamStore.from_values(torch.zeros(64, 4), mesh=c.mesh)
    ids = torch.tensor([[1, 1, 40], [40, 2, 63]], dtype=torch.int32)
    deltas = torch.ones(2, 3, 4)
    mask = torch.tensor([[True, True, True], [True, True, False]])
    d = c.dp_index
    got = shard_push_add(store.table, ids[d:d + 1], deltas[d:d + 1], mask[d:d + 1], mesh=c.mesh)
    return dict(ids=_np(ids), mask=_np(mask), got=_np(all_gather_cat(got, c.mesh, "ps")))


def case_generic_update(c):
    import torch
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.utils.initializers import zeros

    def ema(current, combined):
        return 0.5 * current + 0.5 * combined

    def run(mesh):
        s = ShardedParamStore.create(12, (2,), init_fn=zeros((2,)), update=ema, mesh=mesh,
                                     device=None if mesh is not None else "cpu")
        s = s.push(torch.tensor([0, 3, 0]), torch.ones(3, 2) * 4.0)
        s = s.push(torch.tensor([3]), torch.zeros(1, 2))
        return _np(s.values())

    return dict(sharded=run(c.mesh), single=run(None))


def case_shard_push_pallas(c):
    import torch
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.parallel.collectives import all_gather_cat, shard_push_add

    rng = np.random.default_rng(0)
    ids = ((rng.zipf(1.3, 48) - 1) % 64).reshape(2, 24).astype(np.int32)
    deltas = rng.normal(0, 1, (2, 24, 4)).astype(np.float32)
    mask = rng.random((2, 24)) > 0.1
    d = c.dp_index
    out = {}
    for impl in ("xla", "pallas"):
        store = ShardedParamStore.from_values(torch.zeros(64, 4), mesh=c.mesh)
        t = shard_push_add(store.table, torch.from_numpy(ids[d:d + 1]), torch.from_numpy(deltas[d:d + 1]),
                           torch.from_numpy(mask[d:d + 1]), mesh=c.mesh, impl=impl)
        out[impl] = _np(all_gather_cat(t, c.mesh, "ps"))
    return dict(ids=ids, deltas=deltas, mask=mask, **out)


def case_store_pallas_sharded(c):
    import torch
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.utils.initializers import zeros

    rng = np.random.default_rng(3)
    ids = ((rng.zipf(1.3, 64) - 1) % 40).astype(np.int32)
    deltas = rng.normal(0, 1, (64, 4)).astype(np.float32)
    out = {}
    for impl in ("xla", "pallas"):
        s = ShardedParamStore.create(40, (4,), init_fn=zeros((4,)), mesh=c.mesh, scatter_impl=impl)
        s = s.push(torch.from_numpy(ids), torch.from_numpy(deltas))
        out[impl] = _np(s.values())
        out[impl + "_block_shape"] = np.array(s.table.shape)
    return dict(ids=ids, deltas=deltas, block_rows=np.int64(s.spec.rows_per_shard), **out)


def _presort_batch(rng, n, num_users, num_items, mask_frac=0.0):
    items = rng.integers(0, num_items, n).astype(np.int32)
    mask = rng.random(n) >= mask_frac
    return {
        "user": rng.integers(0, num_users, n).astype(np.int32),
        "item": items,
        "rating": rng.normal(0, 1, n).astype(np.float32),
        "mask": mask,
    }


def _presort_case(c, scatter_impl):
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.core.transform import make_train_step
    from flink_parameter_server_tpu_torch.models.matrix_factorization import (
        OnlineMatrixFactorization, SGDUpdater)
    from flink_parameter_server_tpu_torch.utils.initializers import normal_factor

    rng = np.random.default_rng(3)
    num_users, num_items, dim = 64, 96, 8
    b = _presort_batch(rng, 256, num_users, num_items, mask_frac=0.1)
    b["item"][:150] = 7  # a hot run straddling the dp=2 slice boundary at 128
    out = {f"batch_{k}": v for k, v in b.items()}
    for name, presort in (("plain", False), ("sorted", True)):
        logic = OnlineMatrixFactorization(num_users, dim, updater=SGDUpdater(0.05), seed=0, mesh=c.mesh)
        store = ShardedParamStore.create(num_items, (dim,), init_fn=normal_factor(0, (dim,)),
                                         mesh=c.mesh, scatter_impl=scatter_impl)
        step = make_train_step(logic, store.spec, presort=presort)
        t, s, _ = step(store.table.clone(), logic.init_state(), _tensor_batch(b))
        out[name + "_table"] = _np(ShardedParamStore(store.spec, t).values())
        out[name + "_state"] = _np(s)
    return out


def case_presort_xla(c):
    return _presort_case(c, "xla")


def case_presort_xla_sorted(c):
    return _presort_case(c, "xla_sorted")


def case_steps_per_call(c):
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.core.transform import transform_batched
    from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
    from flink_parameter_server_tpu_torch.data.streams import microbatches
    from flink_parameter_server_tpu_torch.models.matrix_factorization import (
        OnlineMatrixFactorization, SGDUpdater)
    from flink_parameter_server_tpu_torch.utils.initializers import normal_factor

    data = synthetic_ratings(64, 96, 2_048, rank=4, noise=0.01, seed=6)
    out = {}
    for spc in (1, 4):
        logic = OnlineMatrixFactorization(64, 8, updater=SGDUpdater(0.08), seed=0, mesh=c.mesh)
        store = ShardedParamStore.create(96, (8,), init_fn=normal_factor(1, (8,)), mesh=c.mesh)
        res = transform_batched(microbatches(data, 256, epochs=1, shuffle_seed=0), logic, store,
                                collect_outputs=False, steps_per_call=spc)
        out[f"table_{spc}"] = _np(res.store.values())
        out[f"state_{spc}"] = _np(res.worker_state)
    return out


def case_dedup_mf(c):
    """MF with ``dedup_scale`` on the mesh and on one device: users and
    items repeat across the dp slices of every microbatch."""
    from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
    from flink_parameter_server_tpu_torch.data.streams import microbatches
    from flink_parameter_server_tpu_torch.models.matrix_factorization import ps_online_mf

    data = synthetic_ratings(64, 96, 2_048, rank=4, noise=0.01, seed=7)
    kw = dict(num_users=64, num_items=96, dim=8, learning_rate=0.08, dedup_scale=True, collect_outputs=False)
    res = ps_online_mf(microbatches(data, 256, epochs=1, shuffle_seed=0), mesh=c.mesh, **kw)
    single = ps_online_mf(microbatches(data, 256, epochs=1, shuffle_seed=0), device="cpu", **kw)
    return dict(users=_np(res.worker_state), items=_np(res.store.values()),
                users_single=_np(single.worker_state), items_single=_np(single.store.values()),
                **{f"data_{k}": v for k, v in data.items()})


def case_dedup_sgns(c):
    """SGNS with ``dedup_scale`` on the mesh and on one device, and the
    guard against a dedup logic built without the mesh."""
    from flink_parameter_server_tpu_torch.core.transform import transform_batched
    from flink_parameter_server_tpu_torch.data.text import skipgram_batches, synthetic_corpus
    from flink_parameter_server_tpu_torch.models import word2vec as w2v

    vocab = 60
    tokens = synthetic_corpus(vocab, 3_000, num_topics=3, seed=2)
    batches = list(skipgram_batches(tokens, vocab, batch_size=256, window=2, num_negatives=3, epochs=1,
                                    seed=0))[:4]
    kw = dict(vocab_size=vocab, dim=8, learning_rate=0.3, dedup_scale=True, seed=4, collect_outputs=False)
    res = w2v.train_skipgram(iter(batches), mesh=c.mesh, **kw)
    single = w2v.train_skipgram(iter(batches), device="cpu", **kw)
    try:
        transform_batched(iter(batches), w2v.SkipGramNS(0.3, dedup_scale=True, vocab_size=vocab),
                          w2v.make_store(vocab, 8, seed=4, mesh=c.mesh), collect_outputs=False)
        refused = ""
    except ValueError as exc:
        refused = str(exc)
    return dict(table=_np(res.store.values()), table_single=_np(single.store.values()),
                refused=np.str_(refused),
                **{f"batch{i}_{k}": v for i, b in enumerate(batches) for k, v in b.items()})


def case_mf_bf16(c):
    """bf16 item table and user state on the mesh and on one device."""
    import torch
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.core.transform import transform_batched
    from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
    from flink_parameter_server_tpu_torch.data.streams import microbatches
    from flink_parameter_server_tpu_torch.models.matrix_factorization import (
        OnlineMatrixFactorization, SGDUpdater)
    from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

    data = synthetic_ratings(64, 96, 6000, rank=3, noise=0.01, seed=2)
    out = {f"data_{k}": v for k, v in data.items()}
    for tag, where in (("mesh", dict(mesh=c.mesh)), ("single", dict(device="cpu"))):
        res = transform_batched(
            microbatches(data, 256, epochs=6, shuffle_seed=0),
            OnlineMatrixFactorization(64, 8, updater=SGDUpdater(0.08), dtype=torch.bfloat16, **where),
            ShardedParamStore.create(96, (8,), dtype=torch.bfloat16, init_fn=ranged_random_factor(0, (8,)),
                                     **where),  # float32 init, cast
            collect_outputs=False)
        out[f"dtype_{tag}"] = np.str_(str(res.store.table.dtype))
        out[f"users_{tag}"] = _np(res.worker_state)
        out[f"items_{tag}"] = _np(res.store.values())
    return out


def case_output_gather(c):
    """The collectives of a dp-split MF step with and without a reader of
    its outputs, the gathered outputs against one device's, and a logic's
    declared per-record outputs."""
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.core.transform import transform_batched
    from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
    from flink_parameter_server_tpu_torch.data.streams import microbatches
    from flink_parameter_server_tpu_torch.models.matrix_factorization import (
        OnlineMatrixFactorization, ps_online_mf)
    from flink_parameter_server_tpu_torch.parallel import collectives as coll

    data = synthetic_ratings(64, 96, 1_024, rank=4, noise=0.01, seed=8)
    kw = dict(num_users=64, num_items=96, dim=8, learning_rate=0.08)
    out = {}
    for tag, collect in (("quiet", False), ("collect", True)):
        coll.reset_collective_counts()
        res = ps_online_mf(microbatches(data, 256, epochs=1, shuffle_seed=0), mesh=c.mesh,
                           collect_outputs=collect, dump_model=False, **kw)
        out[f"gathers_{tag}"] = np.int64(coll.collective_counts()["all_gather"])
    single = ps_online_mf(microbatches(data, 256, epochs=1, shuffle_seed=0), device="cpu", dump_model=False,
                          **kw)
    steps = [o for o in res.worker_outputs if "prediction" in o]  # the last is the user dump
    out["steps"] = np.int64(len(steps))
    for i, (o, o1) in enumerate(zip(steps, single.worker_outputs)):
        for k in ("prediction", "error"):
            out[f"{k}{i}"], out[f"{k}{i}_single"] = _np(o[k]), _np(o1[k])

    # a declared output leaf that is not per record, though it has the
    # slice's rows, stays the slice's own; a wrong declaration raises
    class Declared(OnlineMatrixFactorization):
        total_per_record = False

        def step(self, state, batch, pulled):
            state, req, o = super().step(state, batch, pulled)
            total = o["prediction"].sum()
            o["slice_total"] = total if self.total_per_record else total.expand(o["prediction"].shape).clone()
            return state, req, o

        def per_record_outputs(self, o):
            return {"prediction": True, "error": True, "slice_total": self.total_per_record}

    def first_output(logic):
        store = ShardedParamStore.create(96, (8,), mesh=c.mesh)
        return transform_batched(microbatches(data, 256, epochs=1, shuffle_seed=0), logic, store,
                                 dump_model=False).worker_outputs[0]

    first = first_output(Declared(64, 8, mesh=c.mesh))
    out["declared_prediction"], out["declared_total"] = _np(first["prediction"]), _np(first["slice_total"])
    wrong = Declared(64, 8, mesh=c.mesh)
    wrong.total_per_record = True  # a 0-d leaf declared per record
    try:
        first_output(wrong)
        out["refused"] = np.str_("")
    except ValueError as exc:
        out["refused"] = np.str_(str(exc))
    return out


def case_sorted_parity(c):
    import torch
    from flink_parameter_server_tpu_torch.core import store as store_mod
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.utils.initializers import normal_factor

    rng = np.random.default_rng(2)
    cap, width, n = 256, 16, 2048
    ids = ((rng.zipf(1.3, n) - 1) % cap).astype(np.int32)
    deltas = rng.normal(size=(n, width)).astype(np.float32)
    out = dict(ids=ids, deltas=deltas)
    for impl in ("xla", "xla_sorted"):
        s = ShardedParamStore.create(cap, (width,), init_fn=normal_factor(0, (width,)),
                                     scatter_impl=impl, mesh=c.mesh)
        t = store_mod.push(s.spec, s.table, torch.from_numpy(ids), torch.from_numpy(deltas))
        out[impl] = _np(ShardedParamStore(s.spec, t).values())
    return out


def _no_fallback(c, impl, init):
    import torch
    from flink_parameter_server_tpu_torch.core import store as store_mod
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.ops import scatter_kernel

    calls = []
    real = scatter_kernel.scatter_add

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    store = ShardedParamStore.create(16, (2,), init_fn=init, scatter_impl=impl, mesh=c.mesh)
    before = _np(store.values())
    scatter_kernel.scatter_add = counting
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            new = store.push(torch.tensor([1, 2, 3]), torch.ones(3, 2))  # 3 % dp=2 != 0
    finally:
        scatter_kernel.scatter_add = real
    return dict(before=before, after=_np(new.values()), warnings=np.int64(len(seen)),
                fallbacks=np.int64(store_mod.pallas_fallback_count()), k1_calls=np.int64(len(calls)))


def case_no_fallback_xla_sorted(c):
    from flink_parameter_server_tpu_torch.utils.initializers import normal_factor

    return _no_fallback(c, "xla_sorted", normal_factor(0, (2,)))


def case_no_fallback_pallas(c):
    from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

    return _no_fallback(c, "pallas", ranged_random_factor(1, (2,)))


def case_topk_dense_vs_sharded(c):
    import torch
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.models.topk_recommender import query_topk

    rng = np.random.default_rng(9)
    items, d, k = 512, 32, 10
    vals = rng.normal(size=(items, d)).astype(np.float32)
    vecs = rng.normal(size=(8, d)).astype(np.float32)
    store = ShardedParamStore.from_values(torch.from_numpy(vals), device="cpu")
    sharded = ShardedParamStore.from_values(torch.from_numpy(vals), mesh=c.mesh)
    uids = torch.arange(8, dtype=torch.int32)
    s_ex, i_ex = query_topk(store, torch.from_numpy(vecs), uids, k)
    s_sh, i_sh = query_topk(sharded, torch.from_numpy(vecs), uids, k)
    return dict(vals=vals, vecs=vecs, s_ex=_np(s_ex), i_ex=_np(i_ex), s_sh=_np(s_sh), i_sh=_np(i_sh))


def case_serving_topk(c):
    import torch
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.serving import QueryEngine, SnapshotManager

    rng = np.random.default_rng(5)
    table = rng.normal(0, 1, (256, 8)).astype(np.float32)
    uv = rng.normal(0, 1, (12, 8)).astype(np.float32)
    store = ShardedParamStore.from_values(torch.from_numpy(table), mesh=c.mesh)
    mgr = SnapshotManager(store.spec)
    mgr.publish(store.table, step=0, aux=torch.from_numpy(uv))
    res = QueryEngine(mgr).top_k(np.arange(8, dtype=np.int32), k=7)
    looked = QueryEngine(mgr).lookup(np.array([0, 100, 255], np.int32))
    return dict(table=table, uv=uv, ids=res.item_ids, scores=res.scores, lookup=looked.values)


def case_pa_sharded(c):
    from flink_parameter_server_tpu_torch.data.streams import sparse_feature_batches
    from flink_parameter_server_tpu_torch.models.passive_aggressive import transform_binary

    rng = np.random.default_rng(1)
    w_true = rng.normal(0, 1, 20)
    X = rng.normal(0, 1, (600, 20)).astype(np.float32)
    X[rng.random(X.shape) < 0.5] = 0.0
    y = np.sign(X @ w_true + 1e-9)
    res_m = transform_binary(sparse_feature_batches(X, y, 64, epochs=1), num_features=20,
                             mesh=c.mesh, collect_outputs=False)
    res_s = transform_binary(sparse_feature_batches(X, y, 64, epochs=1), num_features=20,
                             collect_outputs=False, device="cpu")
    return dict(X=X, y=y, sharded=_np(res_m.store.values()), single=_np(res_s.store.values()))


def _key_batches(keys, batch=512):
    for s in range(0, len(keys), batch):
        chunk = keys[s:s + batch]
        pad = batch - len(chunk)
        yield {"key": np.concatenate([chunk, np.zeros(pad, np.int32)]),
               "mask": np.concatenate([np.ones(len(chunk), bool), np.zeros(pad, bool)])}


def case_count_min_sharded(c):
    from flink_parameter_server_tpu_torch.core.transform import transform_batched
    from flink_parameter_server_tpu_torch.models.sketches import CountMinConfig, CountMinSketch

    keys = np.random.default_rng(1).integers(0, 500, 5000).astype(np.int32)
    sketch = CountMinSketch(CountMinConfig(width=1024, depth=4, seed=1))
    r1 = transform_batched(_key_batches(keys), sketch, sketch.make_store(device="cpu"),
                           collect_outputs=False)
    r2 = transform_batched(_key_batches(keys), sketch, sketch.make_store(mesh=c.mesh),
                           collect_outputs=False)
    return dict(keys=keys, single=_np(r1.store.values()), sharded=_np(r2.store.values()))


def case_checkpoint_roundtrip(c):
    import torch
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.training import checkpoint
    from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

    store = ShardedParamStore.create(50, (4,), init_fn=ranged_random_factor(3, (4,)), mesh=c.mesh)
    state = {"user": torch.arange(12.0).reshape(3, 4)}
    path = str(c.outdir / "ckpt1")
    checkpoint.save(path, store, state, step=7, extra={"lr": 0.1})
    restored, rstate, meta = checkpoint.restore(path, store.spec)
    return dict(saved=_np(store.values()), restored=_np(restored.values()),
                block=_np(restored.table), state=_np(rstate["user"]),
                step=np.int64(meta["step"]), lr=np.float64(meta["lr"]))


def case_checkpoint_elasticity(c):
    import torch
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore, StoreSpec
    from flink_parameter_server_tpu_torch.parallel.mesh import make_mesh
    from flink_parameter_server_tpu_torch.training import checkpoint
    from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

    init = ranged_random_factor(5, (2,))
    store = ShardedParamStore.create(10, (2,), init_fn=init, mesh=c.mesh)
    path = str(c.outdir / "ckpt2")
    checkpoint.save(path, store, step=1)
    one, _, _ = checkpoint.restore(path, StoreSpec(capacity=10, value_shape=(2,)), device="cpu")
    pushed = one.push(torch.tensor([0]), torch.ones(1, 2))
    # another ps count: every rank takes its block of the new layout
    other = make_mesh(1, c.world, device_type="cpu")
    wide, _, _ = checkpoint.restore(path, StoreSpec(capacity=10, value_shape=(2,), mesh=other))
    return dict(saved=_np(store.values()), single=_np(one.values()), pushed=_np(pushed.values()),
                wide=_np(wide.values()), wide_block=_np(wide.table),
                wide_rows=np.int64(wide.spec.rows_per_shard), wide_shards=np.int64(wide.spec.num_shards))


def case_checkpoint_write_fails(c):
    """Rank 0's write fails (the checkpoint's parent is a file): every rank
    must raise, none may return as if the checkpoint were committed."""
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.training import checkpoint

    store = ShardedParamStore.create(10, (2,), mesh=c.mesh)
    blocker = c.outdir / "blocker"
    if c.rank == 0:  # only rank 0 writes
        blocker.write_text("")
    try:
        checkpoint.save(str(blocker / "ckpt"), store, step=3)
        raised = ""
    except Exception as exc:
        raised = f"{type(exc).__name__}: {exc}"
    return dict(raised=np.str_(raised), committed=np.bool_((blocker / "ckpt").exists()))


def case_locality_mf(c):
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.core.transform import make_train_step
    from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
    from flink_parameter_server_tpu_torch.data.streams import partitioned_microbatches
    from flink_parameter_server_tpu_torch.models.matrix_factorization import (
        OnlineMatrixFactorization, SGDUpdater, make_locality_mf_step)
    from flink_parameter_server_tpu_torch.parallel.collectives import all_gather_cat
    from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

    num_users, num_items = 64, 96
    data = synthetic_ratings(num_users, num_items, 4000, rank=3, seed=4)
    logic = OnlineMatrixFactorization(num_users, 8, updater=SGDUpdater(0.05), mesh=c.mesh)
    batches = [_tensor_batch(b) for b in partitioned_microbatches(
        data, 128, c.dp, key="user", capacity=num_users, epochs=1, shuffle_seed=0)]

    store_a = ShardedParamStore.create(num_items, (8,), init_fn=ranged_random_factor(1, (8,)), mesh=c.mesh)
    step_a = make_train_step(logic, store_a.spec)
    table_a, state_a = store_a.table.clone(), logic.init_state()
    for b in batches:
        table_a, state_a, _ = step_a(table_a, state_a, b)

    store_b = ShardedParamStore.create(num_items, (8,), init_fn=ranged_random_factor(1, (8,)), mesh=c.mesh)
    step_b = make_locality_mf_step(logic, store_b.spec, c.mesh)
    per = num_users // c.dp
    table_b = store_b.table.clone()
    state_b = logic.init_state()[c.dp_index * per:(c.dp_index + 1) * per].clone()
    for b in batches:
        table_b, state_b, out = step_b(table_b, state_b, b)
    return dict(
        auto_table=_np(ShardedParamStore(store_a.spec, table_a).values()), auto_state=_np(state_a),
        loc_table=_np(ShardedParamStore(store_b.spec, table_b).values()),
        loc_state=_np(all_gather_cat(state_b, c.mesh, "dp")), loc_pred=_np(out["prediction"]),
        **{f"batch{i}_{k}": _np(v) for i, b in enumerate(batches) for k, v in b.items()})


def case_partitioned_stream_mf(c):
    from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
    from flink_parameter_server_tpu_torch.data.streams import partitioned_microbatches
    from flink_parameter_server_tpu_torch.models.matrix_factorization import ps_online_mf

    data = synthetic_ratings(128, 128, 8000, rank=4, noise=0.01, seed=1)
    stream = partitioned_microbatches(data, 256, 2, key="user", capacity=128, epochs=4, shuffle_seed=0)
    res = ps_online_mf(stream, num_users=128, num_items=128, dim=8, learning_rate=0.08,
                       mesh=c.mesh, collect_outputs=False)
    return dict(users=_np(res.worker_state), items=_np(res.store.values()),
                **{f"data_{k}": v for k, v in data.items()})


def case_fused_sharded(c):
    import torch
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.models.matrix_factorization import (
        OnlineMatrixFactorization, SGDUpdater)
    from flink_parameter_server_tpu_torch.ops import mf_kernel
    from flink_parameter_server_tpu_torch.parallel.collectives import all_gather_cat
    from flink_parameter_server_tpu_torch.parallel.mesh import make_mesh
    from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

    lr, reg = 0.07, 0.01
    ps_mesh = make_mesh(1, c.world, device_type="cpu")  # ps-only
    rng = np.random.default_rng(23)
    B, num_users, num_items, dim = 48, 10, 16, 4
    batch = {"user": rng.integers(0, num_users, B).astype(np.int32),
             "item": rng.integers(0, num_items, B).astype(np.int32),
             "rating": rng.normal(0, 1, B).astype(np.float32)}
    batch["mask"] = rng.random(B) < 0.8
    tb = _tensor_batch(batch)
    store = ShardedParamStore.create(num_items, (dim,), init_fn=ranged_random_factor(5, (dim,)), mesh=ps_mesh)
    logic = OnlineMatrixFactorization(num_users, dim, updater=SGDUpdater(lr, reg), seed=3, mesh=ps_mesh)
    users = logic.init_state()
    items = store.table.clone()
    launches = []
    real = mf_kernel.sorted_fused_mf_sgd

    def counting(*a, **k):
        launches.append(1)
        return real(*a, **k)

    mf_kernel.sorted_fused_mf_sgd = counting
    try:
        u_s, i_s, p_s = mf_kernel.fused_mf_sgd_sharded(
            users, items, tb["user"], tb["item"], tb["rating"], tb["mask"], mesh=ps_mesh,
            learning_rate=lr, regularization=reg)
    finally:
        mf_kernel.sorted_fused_mf_sgd = real
    # the unsharded fused step on the whole table, for the float bar
    whole = ShardedParamStore.create(num_items, (dim,), init_fn=ranged_random_factor(5, (dim,)), device="cpu")
    u1, i1, p1 = mf_kernel.fused_mf_sgd(logic.init_state(), whole.table.clone(), tb["user"], tb["item"],
                                        tb["rating"], tb["mask"], learning_rate=lr, regularization=reg)
    # a dp x ps mesh is refused
    try:
        mf_kernel.fused_mf_sgd_sharded(torch.zeros(4, 2), torch.zeros(4, 2), tb["user"][:8],
                                       tb["item"][:8], tb["rating"][:8], mesh=c.mesh)
        refused = ""
    except ValueError as e:
        refused = str(e)
    return dict(**{f"batch_{k}": v for k, v in batch.items()}, users=_np(u_s),
                items=_np(all_gather_cat(i_s, ps_mesh, "ps"))[:num_items], pred=_np(p_s),
                users_single=_np(u1), items_single=_np(i1)[:num_items], pred_single=_np(p1),
                launches=np.int64(len(launches)), refused=np.array(refused))


def case_multihost(c):
    import torch.distributed as dist
    from flink_parameter_server_tpu_torch.parallel import multihost
    from flink_parameter_server_tpu_torch.parallel.mesh import axis_size

    m = multihost.make_multihost_mesh(ps=c.ps, device_type="cpu")
    whole = multihost.make_multihost_mesh(ps=c.world, device_type="cpu")
    os.environ["LOCAL_WORLD_SIZE"] = str(c.ps)  # hosts of ps ranks each
    try:
        multihost.make_multihost_mesh(ps=c.world, device_type="cpu")
        refused = ""
    except ValueError as e:
        refused = str(e)
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    sl = multihost.process_local_batch_slice(64)
    return dict(dp=np.int64(axis_size(m, "dp")), ps=np.int64(axis_size(m, "ps")),
                whole_dp=np.int64(axis_size(whole, "dp")), whole_ps=np.int64(axis_size(whole, "ps")),
                refused=np.array(refused), slice=np.array([sl.start, sl.stop]),
                initialized=np.int64(multihost.initialize()), rank=np.int64(dist.get_rank()))


def case_interop(c):
    import torch
    from flink_parameter_server_tpu_torch import interop

    # the reference's sharded spec, read by attribute as interop reads it
    z = np.load(c.outdir / "inputs.npz")
    ref = types.SimpleNamespace(
        capacity=int(z["interop_capacity"]), value_shape=tuple(z["interop_value_shape"]),
        dtype=np.float32, update="add", scatter_impl="xla", layout="dense", ps_axis="ps",
        mesh=types.SimpleNamespace(shape={"dp": c.dp, "ps": c.ps}))
    spec = interop.spec_from_reference(ref, mesh=c.mesh)
    store = interop.store_from_numpy(spec, z["interop_table"])
    ids = torch.tensor([0, 33, 49, 7])
    return dict(block=_np(store.table), values=_np(store.values()), pulled=_np(store.pull(ids)),
                shape=np.array(spec.table_shape()))


def case_mf_convergence(c):
    from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
    from flink_parameter_server_tpu_torch.data.streams import microbatches
    from flink_parameter_server_tpu_torch.models.matrix_factorization import ps_online_mf

    data = synthetic_ratings(128, 256, 8_000, rank=4, noise=0.01, seed=2)
    kw = dict(num_users=128, num_items=256, dim=8, learning_rate=0.08, collect_outputs=False)
    res = ps_online_mf(microbatches(data, batch_size=256, epochs=6, shuffle_seed=0), mesh=c.mesh, **kw)
    single = ps_online_mf(microbatches(data, batch_size=256, epochs=6, shuffle_seed=0), device="cpu", **kw)
    return dict(users=_np(res.worker_state), items=_np(res.store.values()),
                users_single=_np(single.worker_state), items_single=_np(single.store.values()),
                **{f"data_{k}": v for k, v in data.items()})


def case_packed_sharded(c):
    import torch
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore

    def init(ids):
        base = (ids.to(torch.int64)[:, None] * 31 + torch.arange(17)[None, :] * 7) % 13
        return (base.to(torch.float32) - 6.0) / 10.0

    rng = np.random.default_rng(4)
    cap, d, n = 100, 17, 256
    ids = rng.integers(0, cap, n).astype(np.int32)
    deltas = rng.normal(0, 1, (n, d)).astype(np.float32)
    dense = ShardedParamStore.create(cap, (d,), init_fn=init, mesh=c.mesh)
    packed = ShardedParamStore.create(cap, (d,), init_fn=init, mesh=c.mesh, layout="packed")
    t_ids, t_deltas = torch.from_numpy(ids), torch.from_numpy(deltas)
    out = dict(ids=ids, deltas=deltas, pull_dense=_np(dense.pull(t_ids)), pull_packed=_np(packed.pull(t_ids)))
    for impl in ("xla", "pallas"):
        p = ShardedParamStore.create(cap, (d,), init_fn=init, mesh=c.mesh, layout="packed", scatter_impl=impl)
        out["packed_" + impl] = _np(p.push(t_ids, t_deltas).values())
    out["dense"] = _np(dense.push(t_ids, t_deltas).values())
    out["packed_block_shape"] = np.array(packed.table.shape)
    out["packed_table_shape"] = np.array(packed.spec.table_shape())
    return out


def case_pair_smoke(c):
    """The two-process smoke: a collective across both processes and a
    store whose ps axis spans them, pushed and pulled against numpy."""
    import torch
    import torch.distributed as dist
    from flink_parameter_server_tpu_torch.core import store as store_mod
    from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
    from flink_parameter_server_tpu_torch.parallel import multihost

    os.environ["LOCAL_WORLD_SIZE"] = "1"  # one rank a host: two hosts
    try:
        mesh = multihost.make_multihost_mesh(ps=1, device_type="cpu")
        sl = multihost.process_local_batch_slice(8 * c.world)
        x = torch.full((4,), float(c.rank + 1))
        dist.all_reduce(x)
        mesh_ps = multihost.make_multihost_mesh(dp=1, ps=c.world, ranks=range(c.world), device_type="cpu")
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    store = ShardedParamStore.create(64, (8,), mesh=mesh_ps)
    spec = store.spec
    host_rng = np.random.default_rng(7)
    ids = host_rng.integers(0, 64, 32).astype(np.int32)
    deltas = host_rng.normal(size=(32, 8)).astype(np.float32)
    t = store_mod.push(spec, store.table, torch.from_numpy(ids), torch.from_numpy(deltas))
    got = store_mod.pull(spec, t, torch.from_numpy(ids))
    oracle = np.zeros((64, 8), np.float32)
    np.add.at(oracle, ids, deltas)
    return dict(dp=np.int64(mesh.shape[0]), ps=np.int64(mesh.shape[1]), slice=np.array([sl.start, sl.stop]),
                reduced=_np(x), got=_np(got), want=oracle[ids], block_rows=np.int64(t.shape[0]))


CASES = {
    "grid": [case_store_matches_single, case_from_values, case_shard_pull, case_shard_push,
             case_generic_update, case_shard_push_pallas, case_store_pallas_sharded,
             case_sorted_parity, case_no_fallback_xla_sorted, case_no_fallback_pallas,
             case_topk_dense_vs_sharded, case_serving_topk, case_pa_sharded,
             case_count_min_sharded, case_multihost, case_interop],
    "grid_mf": [case_presort_xla, case_presort_xla_sorted, case_steps_per_call, case_locality_mf,
                case_partitioned_stream_mf, case_fused_sharded, case_dedup_mf, case_dedup_sgns,
                case_mf_bf16, case_output_gather],
    "wide": [case_store_matches_single, case_mf_convergence, case_packed_sharded,
             case_checkpoint_roundtrip, case_checkpoint_elasticity, case_checkpoint_write_fails],
    "pair": [case_pair_smoke],
}


def _cases(battery: str) -> list:
    if battery in CASES:
        return CASES[battery]
    import _torch_dense_cases
    import _torch_moe_cases
    import _torch_mp_cases

    for module in (_torch_moe_cases, _torch_mp_cases):
        if battery in module.CASES:
            return module.CASES[battery]
    return _torch_dense_cases.CASES[battery]


def main(init_method: str, world: int, rank: int, battery: str, outdir: Path) -> int:
    import torch

    from flink_parameter_server_tpu_torch.parallel import multihost
    from flink_parameter_server_tpu_torch.parallel.mesh import axis_index, make_dp_mesh, make_mesh

    torch.set_num_threads(1)
    multihost.initialize(init_method, world, rank, device_type="cpu", timeout_s=60)
    shape = BATTERIES[battery][1]
    dp, ps = (shape[0], 1) if len(shape) == 1 else shape
    axes = AXES.get(battery, ("dp", "ps"))
    mesh = (make_dp_mesh(dp, device_type="cpu") if len(shape) == 1
            else make_mesh(dp, ps, device_type="cpu", axis_names=axes))
    ctx = types.SimpleNamespace(mesh=mesh, rank=rank, world=world, dp=dp, ps=ps, outdir=outdir,
                                dp_index=axis_index(mesh, "dp"), ps_index=axis_index(mesh, "ps"),
                                ep=ps if axes[1] == "ep" else 1)
    failed = 0
    for case in _cases(battery):
        name = case.__name__[len("case_"):]
        try:
            out = case(ctx)
            np.savez(outdir / f"{name}.r{rank}.npz", **out)
        except Exception:
            failed += 1
            (outdir / f"{name}.r{rank}.err").write_text(traceback.format_exc())
    torch.distributed.destroy_process_group()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], Path(sys.argv[5])))
