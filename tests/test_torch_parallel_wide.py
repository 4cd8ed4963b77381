"""The port's parameter server on the conftest's 2 x 4 mesh, and across two processes.

Mirrors the tests whose table shapes depend on the ``ps`` count:
tests/test_matrix_factorization.py:43, test_packed_store.py:99,
test_aux.py:21 and :35 (checkpoints and shard elasticity) and
test_store.py:71 at four shards; tests/test_multihost.py, the
two-process smoke; and a checkpoint whose rank-0 write fails.  The port runs in eight (then two) spawned gloo ranks
on the CPU (``tests/_torch_mesh_child.py``, one spawn a battery, each with
a wall-clock limit); the reference runs here on the conftest's 8 virtual
devices.  Tolerances are stated per test: init and pulls bitwise, MF and
float pushes at the mirrored JAX test's rtol / atol.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_child import run_battery

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    return run_battery("wide", tmp_path_factory.mktemp("wide"), timeout=150)


def _case(res, name):
    per_rank = res.get(name)
    assert per_rank is not None, f"case {name} wrote nothing:\n{res['_log'][-4000:]}"
    for r, out in enumerate(per_rank):
        assert isinstance(out, dict), f"case {name}, rank {r}:\n{out}"
    return per_rank


def _same_on_every_rank(per_rank, *keys):
    for key in keys:
        for r, out in enumerate(per_rank[1:], 1):
            np.testing.assert_array_equal(out[key], per_rank[0][key], err_msg=f"{key} rank {r}")


def test_sharded_store_matches_single_device_at_four_shards(wide, mesh):
    """Init bitwise; a push bitwise the port's single-device push and
    rtol 1e-6 of the reference's sharded store; pulls bitwise; each rank
    holds 16 of the 64 rows."""
    from flink_parameter_server_tpu.core.store import ShardedParamStore
    from flink_parameter_server_tpu.utils.initializers import ranged_random_factor

    rs = _case(wide, "store_matches_single")
    _same_on_every_rank(rs, "init", "pushed", "pulled")
    r = rs[0]
    ref = ShardedParamStore.create(64, (8,), init_fn=ranged_random_factor(3, (8,)), mesh=mesh)
    np.testing.assert_array_equal(r["init"], np.asarray(ref.values()))
    a = ref.push(jnp.asarray(r["ids"]), jnp.ones((5, 8)))
    np.testing.assert_allclose(r["pushed"], np.asarray(a.values()), rtol=1e-6)
    np.testing.assert_array_equal(r["pushed"], r["pushed_single"])
    np.testing.assert_array_equal(r["pulled"], r["pulled_single"])
    assert {out["block"].shape for out in rs} == {(16, 8)}


def test_mf_sharded_matches_convergence(wide, mesh):
    """MF on the 2 x 4 mesh: RMSE under 0.6 of the zero predictor (the
    reference's bar); the tables bitwise the port's single-device run
    (the user deltas are gathered in lane order) and within atol 1e-4 of
    the reference's sharded run (the reference's sharded-vs-single bar)."""
    from flink_parameter_server_tpu.data.streams import microbatches
    from flink_parameter_server_tpu.models.matrix_factorization import ps_online_mf

    rs = _case(wide, "mf_convergence")
    _same_on_every_rank(rs, "users", "items")
    r = rs[0]
    data = {k[len("data_"):]: v for k, v in r.items() if k.startswith("data_")}
    pred = np.einsum("ij,ij->i", r["users"][data["user"]], r["items"][data["item"]])
    rmse = float(np.sqrt(np.mean((pred - data["rating"]) ** 2)))
    assert rmse < 0.6 * float(np.sqrt(np.mean(data["rating"] ** 2)))
    np.testing.assert_array_equal(r["items"], r["items_single"])
    np.testing.assert_array_equal(r["users"], r["users_single"])
    ref = ps_online_mf(microbatches(data, batch_size=256, epochs=6, shuffle_seed=0),
                       num_users=128, num_items=256, dim=8, learning_rate=0.08, mesh=mesh,
                       collect_outputs=False)
    np.testing.assert_allclose(r["items"], np.asarray(ref.store.values()), atol=1e-4)
    np.testing.assert_allclose(r["users"], np.asarray(ref.worker_state), atol=1e-4)


def test_packed_store_sharded_mesh(wide, mesh):
    """Packed rows over four shards: pulls bitwise the dense store's; a
    push (xla and K1's plain version) within rtol 1e-4 atol 1e-5 of the
    dense push and of the reference's packed sharded push (its bar); each
    rank holds a quarter of the physical rows."""
    from flink_parameter_server_tpu.core.store import ShardedParamStore

    def init(ids):
        base = (ids[:, None] * 31 + jnp.arange(17)[None, :] * 7) % 13
        return (base.astype(jnp.float32) - 6.0) / 10.0

    rs = _case(wide, "packed_sharded")
    _same_on_every_rank(rs, "pull_packed", "packed_xla", "packed_pallas")
    r = rs[0]
    np.testing.assert_array_equal(r["pull_packed"], r["pull_dense"])
    for impl in ("xla", "pallas"):
        np.testing.assert_allclose(r["packed_" + impl], r["dense"], rtol=1e-4, atol=1e-5)
    ref = ShardedParamStore.create(100, (17,), init_fn=init, mesh=mesh, layout="packed")
    np.testing.assert_array_equal(r["pull_packed"], np.asarray(ref.pull(jnp.asarray(r["ids"]))))
    want = np.asarray(ref.push(jnp.asarray(r["ids"]), jnp.asarray(r["deltas"])).values())
    np.testing.assert_allclose(r["packed_xla"], want, rtol=1e-4, atol=1e-5)
    assert tuple(r["packed_table_shape"]) == tuple(ref.table.shape)
    assert tuple(r["packed_block_shape"]) == (ref.table.shape[0] // 4, ref.table.shape[1])


def test_checkpoint_roundtrip(wide):
    """Saved from a sharded store (gathered to rank 0, which writes) and
    restored onto the same spec: exact, with the worker state and meta."""
    for r in _case(wide, "checkpoint_roundtrip"):
        np.testing.assert_array_equal(r["restored"], r["saved"])
        np.testing.assert_array_equal(r["state"], np.arange(12.0).reshape(3, 4))
        assert int(r["step"]) == 7 and float(r["lr"]) == pytest.approx(0.1)
        assert r["block"].shape == (16, 4)  # 64 padded rows over 4 shards


def test_checkpoint_shard_elasticity(wide):
    """Saved at ps 4, restored exactly onto one device and onto ps 8 (each
    rank its block of the new layout); the restored store takes a push."""
    rs = _case(wide, "checkpoint_elasticity")
    for r in rs:
        np.testing.assert_array_equal(r["single"], r["saved"])
        np.testing.assert_array_equal(r["wide"], r["saved"])
        assert r["pushed"][0, 0] == pytest.approx(r["saved"][0, 0] + 1.0)
        assert (int(r["wide_shards"]), int(r["wide_rows"])) == (8, 8)
    # the eight blocks of the ps-8 layout tile the padded table
    blocks = np.concatenate([r["wide_block"] for r in rs])
    np.testing.assert_array_equal(blocks[:10], rs[0]["saved"])


def test_two_process_distributed_smoke(tmp_path):
    """Two processes, one rank a host: the mesh lays dp across them, each
    loads its slice of the global batch, one all-reduce crosses both, and
    a store whose ps axis spans both processes pushes and pulls equal to a
    numpy oracle (rtol 1e-6 atol 1e-6: duplicate ids summed in float32)."""
    res = run_battery("pair", tmp_path / "pair", timeout=90)
    for rank, r in enumerate(_case(res, "pair_smoke")):
        assert (int(r["dp"]), int(r["ps"])) == (2, 1)
        assert list(r["slice"]) == [8 * rank, 8 * (rank + 1)]
        np.testing.assert_array_equal(r["reduced"], np.full(4, 3.0))
        assert int(r["block_rows"]) == 32
        np.testing.assert_allclose(r["got"], r["want"], rtol=1e-6, atol=1e-6)


def test_checkpoint_write_failure_raises_on_every_rank(wide):
    """Rank 0's write fails (the target's parent is a file): rank 0 raises
    its own error, every other rank a RuntimeError, and nothing is
    committed."""
    rs = _case(wide, "checkpoint_write_fails")
    assert str(rs[0]["raised"]).startswith(("FileExistsError", "NotADirectoryError")), rs[0]["raised"]
    for r in rs[1:]:
        assert "was not committed: rank 0's write failed" in str(r["raised"])
    assert not any(bool(r["committed"]) for r in rs)
