"""The port's MF steps on a 2 x 2 mesh vs the JAX package's sharded functions.

Mirrors tests/test_presort.py (:129, :212), test_pallas_mf.py (:152,
:188) and test_parallel_extras.py (:48, :64, :97), and holds what a dp
split must keep whole: ``dedup_scale``'s counts (MF and SGNS) and the
outputs it gathers.  The port runs in four
spawned gloo ranks on the CPU (``tests/_torch_mesh_child.py``, one spawn
for the battery, with a wall-clock limit); the reference runs here on four
of the conftest's virtual devices at the same mesh shape, on the inputs
the ranks wrote.  Tolerances are the mirrored JAX tests' own, stated per
test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_child import run_battery

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jmesh():
    from flink_parameter_server_tpu.parallel.mesh import make_mesh

    return make_mesh(2, 2, devices=jax.devices()[:4])


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return run_battery("grid_mf", tmp_path_factory.mktemp("grid_mf"), timeout=150)


def _case(grid, name):
    """Every rank's outputs of one case; fails with the rank's traceback."""
    per_rank = grid.get(name)
    assert per_rank is not None, f"case {name} wrote nothing:\n{grid['_log'][-4000:]}"
    for r, res in enumerate(per_rank):
        assert isinstance(res, dict), f"case {name}, rank {r}:\n{res}"
    return per_rank


def _same_on_every_rank(per_rank, *keys):
    for key in keys:
        for r, res in enumerate(per_rank[1:], 1):
            np.testing.assert_array_equal(res[key], per_rank[0][key], err_msg=f"{key} rank {r}")


# --- tests/test_presort.py -------------------------------------------------


@pytest.mark.parametrize("scatter_impl", ["xla", "xla_sorted"])
def test_presort_sharded_matches(grid, jmesh, scatter_impl):
    """Presort on the dp x ps mesh, a hot run straddling the dp slice
    boundary: sorted == unsorted and == the reference's sorted step, atol
    2e-5 (the reference's bar)."""
    from flink_parameter_server_tpu.core.store import ShardedParamStore
    from flink_parameter_server_tpu.core.transform import make_train_step
    from flink_parameter_server_tpu.models.matrix_factorization import (
        OnlineMatrixFactorization, SGDUpdater)
    from flink_parameter_server_tpu.utils.initializers import normal_factor

    rs = _case(grid, f"presort_{scatter_impl}")
    _same_on_every_rank(rs, "sorted_table", "sorted_state")
    r = rs[0]
    np.testing.assert_allclose(r["plain_table"], r["sorted_table"], atol=2e-5)
    np.testing.assert_allclose(r["plain_state"], r["sorted_state"], atol=2e-5)
    logic = OnlineMatrixFactorization(64, 8, updater=SGDUpdater(0.05), seed=0, mesh=jmesh)
    store = ShardedParamStore.create(96, (8,), init_fn=normal_factor(0, (8,)), mesh=jmesh,
                                     scatter_impl=scatter_impl)
    b = {k[len("batch_"):]: jnp.asarray(v) for k, v in r.items() if k.startswith("batch_")}
    t, s, _ = jax.jit(make_train_step(logic, store.spec, presort=True))(
        store.table, logic.init_state(jax.random.PRNGKey(0)), b)
    np.testing.assert_allclose(r["sorted_table"], np.asarray(t)[:96], atol=2e-5)
    np.testing.assert_allclose(r["sorted_state"], np.asarray(s), atol=2e-5)


def test_steps_per_call_sharded_mesh(grid, jmesh):
    """K steps a call on the mesh == one a call (bitwise in the port) and
    == the reference's mesh run, atol 2e-5 (the reference's bar)."""
    from flink_parameter_server_tpu.core.store import ShardedParamStore
    from flink_parameter_server_tpu.core.transform import transform_batched
    from flink_parameter_server_tpu.data.movielens import synthetic_ratings
    from flink_parameter_server_tpu.data.streams import microbatches
    from flink_parameter_server_tpu.models.matrix_factorization import (
        OnlineMatrixFactorization, SGDUpdater)
    from flink_parameter_server_tpu.utils.initializers import normal_factor

    rs = _case(grid, "steps_per_call")
    _same_on_every_rank(rs, "table_4", "state_4")
    r = rs[0]
    np.testing.assert_array_equal(r["table_1"], r["table_4"])
    np.testing.assert_array_equal(r["state_1"], r["state_4"])
    data = synthetic_ratings(64, 96, 2_048, rank=4, noise=0.01, seed=6)
    res = transform_batched(
        microbatches(data, 256, epochs=1, shuffle_seed=0),
        OnlineMatrixFactorization(64, 8, updater=SGDUpdater(0.08), seed=0, mesh=jmesh),
        ShardedParamStore.create(96, (8,), init_fn=normal_factor(1, (8,)), mesh=jmesh),
        rng=jax.random.PRNGKey(0), mesh=jmesh, collect_outputs=False, steps_per_call=4)
    np.testing.assert_allclose(r["table_4"], np.asarray(res.store.values()), atol=2e-5)
    np.testing.assert_allclose(r["state_4"], np.asarray(res.worker_state), atol=2e-5)


# --- tests/test_pallas_mf.py -----------------------------------------------


def test_fused_sharded_matches_single_shard(grid):
    """ps-only mesh of 4: K2 once on each rank's block, one all-reduce;
    == the port's unsharded fused step, the reference's unfused step and
    the reference's sharded fused step, rtol 1e-5 atol 1e-6 (the
    reference's bar)."""
    from flink_parameter_server_tpu.core.store import ShardedParamStore
    from flink_parameter_server_tpu.core.transform import make_train_step
    from flink_parameter_server_tpu.models.matrix_factorization import (
        OnlineMatrixFactorization, SGDUpdater)
    from flink_parameter_server_tpu.utils.initializers import ranged_random_factor

    rs = _case(grid, "fused_sharded")
    _same_on_every_rank(rs, "users", "items", "pred")
    r = rs[0]
    for key in ("users", "items", "pred"):
        np.testing.assert_allclose(r[key], r[key + "_single"], rtol=1e-5, atol=1e-6)
    logic = OnlineMatrixFactorization(10, 4, updater=SGDUpdater(0.07, 0.01), seed=3)
    store = ShardedParamStore.create(16, (4,), init_fn=ranged_random_factor(5, (4,)))
    b = {k[len("batch_"):]: jnp.asarray(v) for k, v in r.items() if k.startswith("batch_")}
    table, state, out = make_train_step(logic, store.spec)(
        store.table, logic.init_state(jax.random.PRNGKey(0)), b)
    np.testing.assert_allclose(r["pred"], np.asarray(out["prediction"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r["items"], np.asarray(table)[:16], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r["users"], np.asarray(state), rtol=1e-5, atol=1e-6)
    # the reference's sharded fused step (Pallas in interpret mode) on a
    # ps-only mesh of 4
    from jax.sharding import Mesh

    from flink_parameter_server_tpu.ops.pallas_mf import fused_mf_sgd_sharded

    u_s, i_s, p_s = fused_mf_sgd_sharded(
        logic.init_state(jax.random.PRNGKey(0)), store.table, b["user"], b["item"], b["rating"],
        b["mask"], mesh=Mesh(np.array(jax.devices()[:4]), ("ps",)), learning_rate=0.07,
        regularization=0.01, chunk=8, interpret=True)
    np.testing.assert_allclose(r["pred"], np.asarray(p_s), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r["items"], np.asarray(i_s)[:16], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r["users"], np.asarray(u_s), rtol=1e-5, atol=1e-6)
    assert [int(x["launches"]) for x in rs] == [1, 1, 1, 1]


def test_fused_sharded_rejects_dp_mesh(grid):
    for r in _case(grid, "fused_sharded"):
        assert "ps-only meshes" in str(r["refused"])


# --- tests/test_parallel_extras.py ------------------------------------------


def test_locality_mf_step_matches_auto_path(grid, jmesh):
    """The SPMD locality step (users dp-blocked) == the replicated-user
    step on partition-aligned batches, atol 2e-5 (the reference's bar),
    and == the reference's locality step."""
    from flink_parameter_server_tpu.core.store import ShardedParamStore
    from flink_parameter_server_tpu.models.matrix_factorization import (
        OnlineMatrixFactorization, SGDUpdater, make_locality_mf_step)
    from flink_parameter_server_tpu.utils.initializers import ranged_random_factor

    rs = _case(grid, "locality_mf")
    _same_on_every_rank(rs, "loc_table", "loc_state", "auto_table", "auto_state")
    r = rs[0]
    np.testing.assert_allclose(r["auto_table"], r["loc_table"], atol=2e-5)
    np.testing.assert_allclose(r["auto_state"], r["loc_state"], atol=2e-5)
    logic = OnlineMatrixFactorization(64, 8, updater=SGDUpdater(0.05), mesh=jmesh)
    store = ShardedParamStore.create(96, (8,), init_fn=ranged_random_factor(1, (8,)), mesh=jmesh)
    step = jax.jit(make_locality_mf_step(logic, store.spec, jmesh))
    table, state = store.table, logic.init_state(jax.random.PRNGKey(0))
    n = len({k.split("_")[0] for k in r if k.startswith("batch")})
    for i in range(n):
        b = {k: jnp.asarray(r[f"batch{i}_{k}"]) for k in ("user", "item", "rating", "mask")}
        table, state, out = step(table, state, b)
    np.testing.assert_allclose(r["loc_table"], np.asarray(table)[:96], atol=2e-5)
    np.testing.assert_allclose(r["loc_state"], np.asarray(state), atol=2e-5)
    np.testing.assert_allclose(r["loc_pred"], np.asarray(out["prediction"]), atol=2e-5)


def test_partitioned_stream_trains_mf(grid, jmesh):
    """MF on partition-aligned batches over the mesh: RMSE under 0.6 of the
    zero predictor (the reference's bar), tables within atol 1e-4 of the
    reference's mesh run."""
    from flink_parameter_server_tpu.data.streams import partitioned_microbatches
    from flink_parameter_server_tpu.models.matrix_factorization import ps_online_mf

    rs = _case(grid, "partitioned_stream_mf")
    _same_on_every_rank(rs, "users", "items")
    r = rs[0]
    data = {k[len("data_"):]: v for k, v in r.items() if k.startswith("data_")}
    pred = np.einsum("ij,ij->i", r["users"][data["user"]], r["items"][data["item"]])
    rmse = float(np.sqrt(np.mean((pred - data["rating"]) ** 2)))
    assert rmse < 0.6 * float(np.sqrt(np.mean(data["rating"] ** 2)))
    ref = ps_online_mf(partitioned_microbatches(data, 256, 2, key="user", capacity=128, epochs=4,
                                                shuffle_seed=0),
                       num_users=128, num_items=128, dim=8, learning_rate=0.08, mesh=jmesh,
                       collect_outputs=False)
    np.testing.assert_allclose(r["items"], np.asarray(ref.store.values()), atol=1e-4)
    np.testing.assert_allclose(r["users"], np.asarray(ref.worker_state), atol=1e-4)


def test_mf_bfloat16_path(grid, jmesh):
    """bf16 tables and user state on the 2 x 2 mesh: bitwise the port's
    one-device bf16 run (the dp split keeps the global lane order), and
    RMSE under 0.8 of the zero predictor (the reference's looser bf16 bar)
    in both packages.  Against the reference's mesh run the port's RMSE
    is held within 1.25x: torch rounds every bf16 op on the CPU, XLA's
    fusions compute in float32 and round once, which costs the port about
    a fifth here (0.047 against 0.039); a bf16 path that loses more than
    that to a fault fails, and the float32 runs above hold the math."""
    from flink_parameter_server_tpu.core.store import ShardedParamStore
    from flink_parameter_server_tpu.core.transform import transform_batched
    from flink_parameter_server_tpu.data.streams import microbatches
    from flink_parameter_server_tpu.models.matrix_factorization import (
        OnlineMatrixFactorization, SGDUpdater)
    from flink_parameter_server_tpu.utils.initializers import ranged_random_factor

    rs = _case(grid, "mf_bf16")
    _same_on_every_rank(rs, "users_mesh", "items_mesh")
    r = rs[0]
    assert str(r["dtype_mesh"]) == str(r["dtype_single"]) == "torch.bfloat16"
    np.testing.assert_array_equal(r["items_mesh"], r["items_single"])
    np.testing.assert_array_equal(r["users_mesh"], r["users_single"])
    data = {k[len("data_"):]: v for k, v in r.items() if k.startswith("data_")}
    base = float(np.sqrt(np.mean(data["rating"] ** 2)))

    def rmse(uf, itf):
        pred = np.einsum("ij,ij->i", uf[data["user"]], itf[data["item"]])
        return float(np.sqrt(np.mean((pred - data["rating"]) ** 2)))

    ref = transform_batched(
        microbatches(data, 256, epochs=6, shuffle_seed=0),
        OnlineMatrixFactorization(64, 8, updater=SGDUpdater(0.08), dtype=jnp.bfloat16, mesh=jmesh),
        ShardedParamStore.create(96, (8,), dtype=jnp.bfloat16, mesh=jmesh,
                                 init_fn=ranged_random_factor(0, (8,), dtype=jnp.bfloat16)),
        mesh=jmesh, collect_outputs=False)
    assert ref.store.table.dtype == jnp.bfloat16
    theirs = rmse(np.asarray(ref.worker_state.astype(jnp.float32)),
                  np.asarray(ref.store.values().astype(jnp.float32)))
    mine = rmse(r["users_mesh"], r["items_mesh"])
    assert np.isfinite(mine) and mine < 0.8 * base
    assert theirs < 0.8 * base and mine < 1.25 * theirs, (mine, theirs)


# --- dedup_scale on a dp split ------------------------------------------------


def test_dedup_scale_mf_counts_over_the_whole_batch(grid, jmesh):
    """MF with ``dedup_scale`` on the 2 x 2 mesh, ids repeating across the
    dp slices: the counts are the whole microbatch's, so the run is bitwise
    the port's one-device run and within atol 2e-5 (the reference's mesh
    bar) of the reference's mesh run."""
    from flink_parameter_server_tpu.data.streams import microbatches
    from flink_parameter_server_tpu.models.matrix_factorization import ps_online_mf

    rs = _case(grid, "dedup_mf")
    _same_on_every_rank(rs, "users", "items")
    r = rs[0]
    np.testing.assert_array_equal(r["items"], r["items_single"])
    np.testing.assert_array_equal(r["users"], r["users_single"])
    data = {k[len("data_"):]: v for k, v in r.items() if k.startswith("data_")}
    ref = ps_online_mf(microbatches(data, 256, epochs=1, shuffle_seed=0), num_users=64, num_items=96, dim=8,
                       learning_rate=0.08, dedup_scale=True, mesh=jmesh, collect_outputs=False)
    np.testing.assert_allclose(r["items"], np.asarray(ref.store.values()), atol=2e-5)
    np.testing.assert_allclose(r["users"], np.asarray(ref.worker_state), atol=2e-5)


def test_dedup_scale_sgns_counts_over_the_whole_batch(grid, jmesh):
    """SGNS with ``dedup_scale`` on the 2 x 2 mesh: bitwise the port's
    one-device run, and rtol 1e-5 (atol 1e-5 of the largest entry) of the
    reference's mesh run, the SGNS parity bar; a dedup logic built
    without the mesh is refused."""
    from flink_parameter_server_tpu.models import word2vec as ref_w2v

    rs = _case(grid, "dedup_sgns")
    _same_on_every_rank(rs, "table")
    r = rs[0]
    np.testing.assert_array_equal(r["table"], r["table_single"])
    n = len({k.split("_")[0] for k in r if k.startswith("batch")})
    batches = [{k: r[f"batch{i}_{k}"] for k in ("center", "context", "negatives", "mask")} for i in range(n)]
    ref = ref_w2v.train_skipgram(iter(batches), vocab_size=60, dim=8, learning_rate=0.3, dedup_scale=True,
                                 seed=4, mesh=jmesh, collect_outputs=False)
    want = np.asarray(ref.store.values())
    np.testing.assert_allclose(r["table"], want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))
    for res in rs:
        assert "build it with mesh=" in str(res["refused"])


def test_outputs_gathered_only_for_a_reader(grid):
    """A dp-split MF step all-gathers its outputs only when they are read:
    6 all-gathers a step without a reader (users, user deltas and mask for
    the user table; ids, deltas and mask for the push), 8 with one; the
    gathered outputs are bitwise one device's."""
    rs = _case(grid, "output_gather")
    for r in rs:
        steps = int(r["steps"])
        assert steps == 4
        assert int(r["gathers_quiet"]) == 6 * steps
        assert int(r["gathers_collect"]) == 8 * steps
        for i in range(steps):
            for k in ("prediction", "error"):
                np.testing.assert_array_equal(r[f"{k}{i}"], r[f"{k}{i}_single"])


def test_declared_outputs_choose_what_is_gathered(grid):
    """``per_record_outputs`` decides which output leaves a dp split
    gathers: a leaf with the slice's 128 rows declared not per record stays
    the slice's own (the shape rule would have gathered it), and a 0-d leaf
    declared per record raises."""
    for r in _case(grid, "output_gather"):
        assert r["declared_prediction"].shape == (256,)
        assert r["declared_total"].shape == (128,)
        assert "per_record_outputs declared an output leaf of shape ()" in str(r["refused"])
