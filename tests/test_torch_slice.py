"""The port's online-MF slice end to end vs the JAX package.

``ps_online_mf`` over the same microbatch stream (64 users, 96 items,
dim 16, 6 microbatches of 32) for every ``scatter_impl``, with presort on
and off and ``steps_per_call`` 1 and 3: the final item table and user state
must match.  Tolerance rtol 1e-5 / atol 1e-7 (float32 sums of the same
terms; on this CPU they come out bitwise equal).  Also: the fused step over
several microbatches, the interop round trip, the loop's callbacks, and
the device rules (cuda by default, no quiet CPU fallback).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_parameter_server_tpu.core.store import ShardedParamStore as RefStore
from flink_parameter_server_tpu.core.transform import make_train_step as ref_make_train_step
from flink_parameter_server_tpu.data import movielens as ref_movielens
from flink_parameter_server_tpu.data import streams as ref_streams
from flink_parameter_server_tpu.models import matrix_factorization as ref_mf
from flink_parameter_server_tpu.utils.initializers import ranged_random_factor as ref_init
from flink_parameter_server_tpu_torch import interop
from flink_parameter_server_tpu_torch.core.store import ShardedParamStore
from flink_parameter_server_tpu_torch.data.movielens import synthetic_ratings
from flink_parameter_server_tpu_torch.data.streams import microbatches
from flink_parameter_server_tpu_torch.models.matrix_factorization import ps_online_mf
from flink_parameter_server_tpu_torch.ops.mf_kernel import make_fused_mf_train_step
from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-7)
DATA = synthetic_ratings(64, 96, 6 * 32, seed=3)


@pytest.mark.parametrize("impl", ["xla", "xla_sorted", "pallas"])
@pytest.mark.parametrize("presort,spc", [(False, 1), (True, 1), (True, 3)])
def test_ps_online_mf_matches(impl, presort, spc):
    kw = dict(num_users=64, num_items=96, dim=16, scatter_impl=impl, presort=presort,
              steps_per_call=spc, layout="packed" if impl == "pallas" and spc == 3 else "dense")
    want = ref_mf.ps_online_mf(ref_streams.microbatches(DATA, 32), **kw)
    got = ps_online_mf(microbatches(DATA, 32), device="cpu", **kw)
    np.testing.assert_allclose(got.store.values().numpy(), np.asarray(want.store.values()), **TOL)
    np.testing.assert_allclose(got.worker_state.numpy(), np.asarray(want.worker_state), **TOL)
    assert len(got.worker_outputs) == len(want.worker_outputs) == 7  # 6 steps + finish
    np.testing.assert_allclose(
        got.worker_outputs[5]["error"].numpy(), np.asarray(want.worker_outputs[5]["error"]), **TOL
    )
    np.testing.assert_allclose(got.server_outputs[0][1], np.asarray(want.server_outputs[0][1]), **TOL)


def test_fused_step_over_a_stream_matches_unfused_reference():
    """Three microbatches through make_fused_mf_train_step (the kernel's
    plain version here) against the reference's unfused step."""
    logic = ref_mf.OnlineMatrixFactorization(64, 16, updater=ref_mf.SGDUpdater(0.05), seed=0)
    store = RefStore.create(96, (16,), init_fn=ref_init(1, (16,)))
    ref_step = jax.jit(ref_make_train_step(logic, store.spec))
    table, state = store.table, logic.init_state(jax.random.PRNGKey(0))
    port_store = ShardedParamStore.create(96, (16,), init_fn=ranged_random_factor(1, (16,)),
                                          device="cpu")
    p_table = port_store.table.clone()
    p_state = ranged_random_factor(0, (16,))(torch.arange(64))
    step = make_fused_mf_train_step(learning_rate=0.05)
    for batch in list(microbatches(DATA, 32))[:3]:
        table, state, _ = ref_step(table, state, {k: jnp.asarray(v) for k, v in batch.items()})
        p_table, p_state, _ = step(p_table, p_state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(p_table.numpy(), np.asarray(table), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p_state.numpy(), np.asarray(state), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout", ["dense", "packed"])
def test_interop_round_trip(layout):
    ref_store = RefStore.create(45, (16,), init_fn=ref_init(2, (16,)), layout=layout,
                                scatter_impl="xla_sorted")
    spec = interop.spec_from_reference(ref_store.spec)
    assert spec.table_shape() == ref_store.spec.table_shape()
    store = interop.store_from_numpy(spec, np.asarray(ref_store.table), device="cpu")
    assert spec.scatter_impl == "xla_sorted" and spec.layout == layout
    back = RefStore(ref_store.spec, jnp.asarray(interop.to_numpy(store.table), ref_store.spec.dtype))
    np.testing.assert_array_equal(np.asarray(back.values()), np.asarray(ref_store.values()))
    state = np.asarray(ref_init(0, (16,))(jnp.arange(10)))
    np.testing.assert_array_equal(interop.to_numpy(interop.state_from_numpy(state, device="cpu")), state)


def test_interop_bfloat16_and_errors():
    vals = np.random.default_rng(0).normal(0, 1, (16, 8)).astype(np.float32)
    ref_store = RefStore.from_values(jnp.asarray(vals, jnp.bfloat16))
    spec = interop.spec_from_reference(ref_store.spec)
    assert spec.dtype == torch.bfloat16
    store = interop.store_from_numpy(spec, np.asarray(ref_store.table, np.float32), device="cpu")
    np.testing.assert_array_equal(
        interop.to_numpy(store.table), np.asarray(ref_store.table, np.float32)
    )
    with pytest.raises(ValueError, match="table_shape"):
        interop.store_from_numpy(spec, np.zeros((3, 8), np.float32), device="cpu")
    custom = RefStore.create(8, (4,), update=lambda t, d: t + d)
    with pytest.raises(ValueError, match="update='add'"):
        interop.spec_from_reference(custom.spec)


def test_transform_callbacks_skip_and_initial_state_match():
    events = {"ref": [], "port": []}

    def recorder(tag):
        def on_step(i, out):
            events[tag].append(("step", i, np.asarray(out["error"]).round(6).tolist()))

        def group_cb(i, n, table, state, outs):
            events[tag].append(("group", i, n))

        return on_step, group_cb

    init_state = np.asarray(ref_init(9, (16,))(jnp.arange(64)))
    kw = dict(num_users=64, num_items=96, dim=16, skip_batches=2, steps_per_call=3)
    on_step, group_cb = recorder("ref")
    want = ref_mf.ps_online_mf(ref_streams.microbatches(DATA, 32), on_step=on_step,
                               group_callback=group_cb, initial_state=jnp.asarray(init_state), **kw)
    on_step, group_cb = recorder("port")
    start = torch.from_numpy(init_state.copy())
    got = ps_online_mf(microbatches(DATA, 32), device="cpu", on_step=on_step,
                       group_callback=group_cb, initial_state=start, **kw)
    assert events["port"] == events["ref"]
    assert [e[:3] for e in events["port"] if e[0] == "group"] == [("group", 2, 3), ("group", 5, 1)]
    np.testing.assert_array_equal(start.numpy(), init_state)  # the caller's state stays valid
    np.testing.assert_allclose(got.worker_state.numpy(), np.asarray(want.worker_state), **TOL)

    seen = []
    ps_online_mf(microbatches(DATA, 32), num_users=64, num_items=96, dim=16, device="cpu",
                 state_callback=lambda i, t, s, o: seen.append((i, tuple(t.shape))))
    assert seen == [(i, (96, 16)) for i in range(6)]
    with pytest.raises(ValueError, match="steps_per_call > 1"):
        ps_online_mf(microbatches(DATA, 32), num_users=64, num_items=96, device="cpu",
                     steps_per_call=2, state_callback=lambda *a: None)


def test_presort_rejects_multi_pull_keys_and_unmarked_keys():
    from flink_parameter_server_tpu_torch.core.transform import make_train_step
    from flink_parameter_server_tpu_torch.models.matrix_factorization import (
        OnlineMatrixFactorization,
    )

    class TwoD(OnlineMatrixFactorization):
        def keys(self, batch):
            return batch["item"].reshape(2, -1)

    class Unmarked(OnlineMatrixFactorization):
        def per_record_leaves(self, batch):
            return {k: k == "user" for k in batch}

    store = ShardedParamStore.create(96, (4,), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in next(microbatches(DATA, 32)).items()}
    for cls, match in [(TwoD, "1-D store keys"), (Unmarked, "did not mark")]:
        logic = cls(64, 4, device="cpu")
        with pytest.raises(ValueError, match=match):
            make_train_step(logic, store.spec, presort=True)(store.table, logic.init_state(), batch)


def test_data_copies_match_the_reference():
    want = ref_movielens.synthetic_ratings(50, 70, 300, seed=4)
    got = synthetic_ratings(50, 70, 300, seed=4)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for g, w in zip(microbatches(got, 64, shuffle_seed=1), ref_streams.microbatches(want, 64, shuffle_seed=1)):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedParamStore.create(8, (4,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ps_online_mf(microbatches(DATA, 32), num_users=64, num_items=96)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.state_from_numpy(np.zeros((2, 2), np.float32))
    with pytest.raises(NotImplementedError, match="Queue 1 #9"):
        ps_online_mf(microbatches(DATA, 32), num_users=64, num_items=96, device="cpu", mesh=object())
