"""Port of the fused MF-SGD step (K2) and the MF worker logic.

The reference side runs ``ops/pallas_mf.fused_mf_sgd[_packed]`` in
interpret mode (as tests/test_pallas_mf.py does) and the unfused
``make_train_step(OnlineMatrixFactorization)``; the port runs on CPU
tensors, so the fused wrapper takes the kernel's plain torch version.
Tolerance rtol 1e-5 / atol 1e-6: float32 sums of the same terms in
another order (dot products, per-row delta sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_parameter_server_tpu.core.store import ShardedParamStore as RefStore
from flink_parameter_server_tpu.core.transform import make_train_step as ref_make_train_step
from flink_parameter_server_tpu.models import matrix_factorization as ref_mf
from flink_parameter_server_tpu.ops import pallas_mf as ref_fused
from flink_parameter_server_tpu.utils.initializers import ranged_random_factor as ref_init
from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
from flink_parameter_server_tpu_torch.core.transform import make_train_step
from flink_parameter_server_tpu_torch.models import matrix_factorization as mf
from flink_parameter_server_tpu_torch.ops import mf_kernel
from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

torch.set_num_threads(2)

LR, REG = 0.07, 0.01
TOL = dict(rtol=1e-5, atol=1e-6)


def _batch(rng, B, num_users, num_items, mask=None):
    return {
        "user": rng.integers(0, num_users, B).astype(np.int32),
        "item": rng.integers(0, num_items, B).astype(np.int32),
        "rating": rng.normal(0, 1, B).astype(np.float32),
        "mask": np.ones(B, bool) if mask is None else mask,
    }


def _tables(num_users, num_items, dim):
    users = np.asarray(ref_init(3, (dim,))(jnp.arange(num_users)))
    items = np.asarray(ref_init(5, (dim,))(jnp.arange(num_items)))
    return users, items


def _ref_fused(users, items, batch, **kw):
    u, i, p = ref_fused.fused_mf_sgd(
        jnp.asarray(users), jnp.asarray(items), *(jnp.asarray(batch[k]) for k in ("user", "item", "rating", "mask")),
        learning_rate=LR, regularization=REG, chunk=16, interpret=True, **kw,
    )
    return np.asarray(u), np.asarray(i), np.asarray(p)


def _port_fused(users, items, batch):
    u, i, p = mf_kernel.fused_mf_sgd(
        torch.from_numpy(users.copy()), torch.from_numpy(items.copy()),
        *(torch.from_numpy(batch[k]) for k in ("user", "item", "rating", "mask")),
        learning_rate=LR, regularization=REG,
    )
    return u.numpy(), i.numpy(), p.numpy()


def test_fused_matches_reference_kernel_zipf_masked():
    """Zipf-hot items (long runs), masked lanes: every output matches,
    masked lanes' predictions included."""
    rng = np.random.default_rng(7)
    B = 96
    batch = _batch(rng, B, 10, 12, mask=rng.random(B) < 0.7)
    batch["item"] = ((rng.zipf(1.1, B) - 1) % 12).astype(np.int32)
    users, items = _tables(10, 12, 8)
    for got, want in zip(_port_fused(users, items, batch), _ref_fused(users, items, batch)):
        np.testing.assert_allclose(got, want, **TOL)


def test_invalid_item_lanes_follow_the_reference():
    """The two documented invalid-lane divergences from the unfused step:
    an out-of-range item predicts against the LAST row, and its lane
    updates no user row."""
    rng = np.random.default_rng(13)
    batch = _batch(rng, 16, 8, 16)
    batch["item"][3] = -1
    batch["item"][7] = 99
    users, items = _tables(8, 16, 4)
    got = _port_fused(users, items, batch)
    for g, w in zip(got, _ref_fused(users, items, batch)):
        np.testing.assert_allclose(g, w, **TOL)
    pred = got[2]
    np.testing.assert_allclose(pred[7], items[-1] @ users[batch["user"][7]], rtol=1e-5)
    lone = np.ones(16, bool)
    lone[7] = False
    only_oob = dict(batch, mask=~lone)  # just the out-of-range lane, unmasked
    u_after, _, _ = _port_fused(users, items, only_oob)
    np.testing.assert_array_equal(u_after, users)


@pytest.mark.parametrize("dim", [64, 4])
def test_fused_packed_matches_reference_kernel(dim):
    rng = np.random.default_rng(dim)
    num_items, num_users, B = 20, 9, 64
    batch = _batch(rng, B, num_users, num_items, mask=rng.random(B) < 0.8)
    batch["item"] = ((rng.zipf(1.2, B) - 1) % (num_items + 2)).astype(np.int32)  # a few invalid
    ref_store = RefStore.create(num_items, (dim,), init_fn=ref_init(5, (dim,)), layout="packed")
    users = np.asarray(ref_init(3, (dim,))(jnp.arange(num_users)))
    want = ref_fused.fused_mf_sgd_packed(
        jnp.asarray(users), ref_store.table,
        *(jnp.asarray(batch[k]) for k in ("user", "item", "rating", "mask")),
        capacity=num_items, dim=dim, learning_rate=LR, regularization=REG, chunk=16, interpret=True,
    )
    port_store = ShardedParamStore.create(num_items, (dim,), init_fn=ranged_random_factor(5, (dim,)),
                                          layout="packed", device="cpu")
    got = mf_kernel.fused_mf_sgd_packed(
        torch.from_numpy(users.copy()), port_store.table,
        *(torch.from_numpy(batch[k]) for k in ("user", "item", "rating", "mask")),
        capacity=num_items, dim=dim, learning_rate=LR, regularization=REG,
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_fused_matches_unfused_reference_step():
    rng = np.random.default_rng(40)
    batch = _batch(rng, 40, 12, 24)
    logic = ref_mf.OnlineMatrixFactorization(12, 4, updater=ref_mf.SGDUpdater(LR, REG), seed=3)
    store = RefStore.create(24, (4,), init_fn=ref_init(5, (4,)))
    state = logic.init_state(jax.random.PRNGKey(0))
    table, state, out = ref_make_train_step(logic, store.spec)(
        store.table, state, {k: jnp.asarray(v) for k, v in batch.items()}
    )
    step = mf_kernel.make_fused_mf_train_step(learning_rate=LR, regularization=REG)
    p_store = ShardedParamStore.create(24, (4,), init_fn=ranged_random_factor(5, (4,)), device="cpu")
    p_logic = mf.OnlineMatrixFactorization(12, 4, seed=3, device="cpu")
    items, users, p_out = step(p_store.table, p_logic.init_state(),
                               {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(items.numpy(), np.asarray(table), **TOL)
    np.testing.assert_allclose(users.numpy(), np.asarray(state), **TOL)
    for k in ("prediction", "error"):
        np.testing.assert_allclose(p_out[k].numpy(), np.asarray(out[k]), **TOL)


def test_train_step_layout_guard():
    with pytest.raises(ValueError, match="'dense' or 'packed'"):
        mf_kernel.make_fused_mf_train_step(layout="auto")
    with pytest.raises(ValueError, match="needs capacity"):
        mf_kernel.make_fused_mf_train_step(layout="packed", dim=8)
    with pytest.raises(ValueError, match="exceeds the packed table"):
        mf_kernel.fused_mf_sgd_packed(
            torch.zeros(4, 8), torch.zeros(8, 128), torch.zeros(2, dtype=torch.long),
            torch.zeros(2, dtype=torch.long), torch.zeros(2), capacity=200, dim=8,
        )


def test_sgd_updater_matches():
    rng = np.random.default_rng(1)
    r = rng.normal(0, 1, 10).astype(np.float32)
    u = rng.normal(0, 1, (10, 6)).astype(np.float32)
    q = rng.normal(0, 1, (10, 6)).astype(np.float32)
    want = ref_mf.SGDUpdater(0.1, 0.02).delta(jnp.asarray(r), jnp.asarray(u), jnp.asarray(q))
    got = mf.SGDUpdater(0.1, 0.02).delta(*(torch.from_numpy(x) for x in (r, u, q)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("dedup_scale,state_scatter", [(True, "xla"), (False, "xla_sorted"),
                                                       (True, "xla_sorted")])
def test_online_mf_step_matches(dedup_scale, state_scatter):
    rng = np.random.default_rng(2)
    batch = _batch(rng, 48, 6, 10, mask=rng.random(48) < 0.8)  # hot users and items
    kw = dict(updater=None, seed=3, dedup_scale=dedup_scale, state_scatter=state_scatter)
    kw_ref = dict(kw, updater=ref_mf.SGDUpdater(LR, REG), num_items=10 if dedup_scale else None)
    kw_port = dict(kw, updater=mf.SGDUpdater(LR, REG), num_items=10 if dedup_scale else None)
    logic = ref_mf.OnlineMatrixFactorization(6, 4, **kw_ref)
    store = RefStore.create(10, (4,), init_fn=ref_init(5, (4,)))
    table, state, out = ref_make_train_step(logic, store.spec)(
        store.table, logic.init_state(jax.random.PRNGKey(0)),
        {k: jnp.asarray(v) for k, v in batch.items()},
    )
    p_logic = mf.OnlineMatrixFactorization(6, 4, device="cpu", **kw_port)
    p_store = ShardedParamStore.create(10, (4,), init_fn=ranged_random_factor(5, (4,)), device="cpu")
    p_table, p_state, p_out = make_train_step(p_logic, p_store.spec)(
        p_store.table, p_logic.init_state(), {k: torch.from_numpy(v) for k, v in batch.items()}
    )
    np.testing.assert_allclose(p_table.numpy(), np.asarray(table), **TOL)
    np.testing.assert_allclose(p_state.numpy(), np.asarray(state), **TOL)
    np.testing.assert_allclose(p_out["error"].numpy(), np.asarray(out["error"]), **TOL)


def test_online_mf_argument_checks():
    with pytest.raises(ValueError, match="requires num_items"):
        mf.OnlineMatrixFactorization(4, 2, dedup_scale=True, device="cpu")
    with pytest.raises(ValueError, match="state_scatter"):
        mf.OnlineMatrixFactorization(4, 2, state_scatter="pallas", device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 #9"):
        mf.OnlineMatrixFactorization(4, 2, mesh=object(), device="cpu")
