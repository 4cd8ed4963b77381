"""Port of the parameter store vs flink_parameter_server_tpu/core/store.py.

Mirrors tests/test_store.py, test_sorted_scatter.py and
test_packed_store.py: the same numpy inputs go through both stores.  The
reference's ``scatter_impl="pallas"`` runs its Pallas kernel in interpret
mode on the CPU; the port's runs the kernel's plain torch version.
Tolerances: shape arithmetic and init are exact; float pushes rtol 1e-6
(both sum duplicates in float32, in an order that may differ by one add);
integer tables exact.
"""
import itertools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_parameter_server_tpu.core import store as ref
from flink_parameter_server_tpu.utils.initializers import ranged_random_factor as ref_init
from flink_parameter_server_tpu_torch.core import store as port
from flink_parameter_server_tpu_torch.utils.initializers import ranged_random_factor as port_init

torch.set_num_threads(2)

RTOL, ATOL = 1e-6, 1e-7
IMPLS = ["xla", "xla_sorted", "pallas"]
LAYOUTS = ["dense", "packed"]


def _stores(capacity, value_shape, **kw):
    a = ref.ShardedParamStore.create(
        capacity, value_shape, init_fn=ref_init(4, value_shape), **kw
    )
    b = port.ShardedParamStore.create(
        capacity, value_shape, init_fn=port_init(4, value_shape), device="cpu", **kw
    )
    return a, b


def _push_inputs(rng, n, capacity, width):
    ids = ((rng.zipf(1.3, n) - 1) % capacity).astype(np.int32)
    ids[:4] = [-1, capacity, capacity + 50, -7]  # dropped lanes
    deltas = rng.normal(0, 1, (n, width)).astype(np.float32)
    mask = rng.random(n) > 0.2
    deltas[~mask] = np.nan  # masked lanes are inert even as NaN
    return ids, deltas, mask


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spec_arithmetic_identical(layout):
    for capacity, shape in itertools.product(
        [1, 7, 8, 9, 30, 129, 1000, 131_072], [(), (1,), (17,), (64,), (100,), (128,), (2, 5), (300,)]
    ):
        a = ref.StoreSpec(capacity, shape, layout=layout)
        b = port.StoreSpec(capacity, shape, layout=layout)
        assert (b.pack, b.rows_per_shard, b.padded_capacity, b.table_shape()) == (
            a.pack, a.rows_per_shard, a.padded_capacity, a.table_shape()
        ), (capacity, shape, layout)
    for layout_arg, shape, update in [("auto", (17,), "add"), ("auto", (128,), "add"),
                                      ("auto", (8,), lambda t, d: t + d)]:
        assert port._resolve_layout(layout_arg, update, shape) == ref._resolve_layout(
            layout_arg, update, shape
        )


@pytest.mark.parametrize("layout", LAYOUTS)
def test_create_and_pull_match(layout):
    a, b = _stores(45, (16,), layout=layout)
    np.testing.assert_array_equal(b.table.numpy(), np.asarray(a.table))
    ids = np.asarray([0, 3, 44, 47, -5, 999, 3], np.int32)
    np.testing.assert_array_equal(
        b.pull(torch.from_numpy(ids)).numpy(), np.asarray(a.pull(jnp.asarray(ids)))
    )
    np.testing.assert_array_equal(b.values().numpy(), np.asarray(a.values()))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_push_matches(impl, layout):
    rng = np.random.default_rng(IMPLS.index(impl) * 2 + LAYOUTS.index(layout))
    a, b = _stores(40, (16,), scatter_impl=impl, layout=layout)
    ids, deltas, mask = _push_inputs(rng, 96, 40, 16)
    a2 = a.push(jnp.asarray(ids), jnp.asarray(deltas), jnp.asarray(mask))
    b2 = b.push(torch.from_numpy(ids), torch.from_numpy(deltas), torch.from_numpy(mask))
    np.testing.assert_allclose(b2.table.numpy(), np.asarray(a2.table), rtol=RTOL, atol=ATOL)
    # functional store API: the pushed-from store is unchanged
    np.testing.assert_array_equal(b.table.numpy(), np.asarray(a.table))


@pytest.mark.parametrize("impl", ["xla", "xla_sorted"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_push_ids_sorted_matches(impl, layout):
    """The presort promise: ascending ids, negative lanes at the END."""
    rng = np.random.default_rng(5)
    a, b = _stores(40, (16,), scatter_impl=impl, layout=layout)
    ids = np.sort(((rng.zipf(1.3, 60) - 1) % 45)).astype(np.int32)  # some past the end
    ids = np.concatenate([ids, [-1, -3]]).astype(np.int32)
    deltas = rng.normal(0, 1, (62, 16)).astype(np.float32)
    mask = rng.random(62) > 0.2
    want = ref.push(a.spec, a.table, jnp.asarray(ids), jnp.asarray(deltas), jnp.asarray(mask),
                    ids_sorted=True)
    got = port.push(b.spec, b.table.clone(), torch.from_numpy(ids), torch.from_numpy(deltas),
                    torch.from_numpy(mask), ids_sorted=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_generic_update_matches():
    rng = np.random.default_rng(6)

    def ref_update(cur, d):
        return cur * 0.5 + d

    def port_update(cur, d):
        return cur * 0.5 + d

    a = ref.ShardedParamStore.create(20, (4,), init_fn=ref_init(1, (4,)), update=ref_update)
    b = port.ShardedParamStore.create(20, (4,), init_fn=port_init(1, (4,)), update=port_update,
                                      device="cpu")
    ids = np.asarray([1, 1, 5, -2, 30, 7, 7, 7], np.int32)
    deltas = rng.normal(0, 1, (8, 4)).astype(np.float32)
    mask = np.asarray([1, 1, 1, 1, 1, 0, 1, 1], bool)
    a2 = a.push(jnp.asarray(ids), jnp.asarray(deltas), jnp.asarray(mask))
    b2 = b.push(torch.from_numpy(ids), torch.from_numpy(deltas), torch.from_numpy(mask))
    np.testing.assert_allclose(b2.table.numpy(), np.asarray(a2.table), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_int32_table_exact_past_2_24(impl):
    big = 20_000_000
    a = ref.ShardedParamStore.from_values(jnp.full((16, 4), big, jnp.int32), scatter_impl=impl)
    b = port.ShardedParamStore.from_values(torch.full((16, 4), big, dtype=torch.int32),
                                           scatter_impl=impl, device="cpu")
    ids = np.asarray([0] * 20 + [3, 3, -1, 99], np.int32)
    deltas = np.ones((24, 4), np.int32)
    a2 = a.push(jnp.asarray(ids), jnp.asarray(deltas))
    b2 = b.push(torch.from_numpy(ids), torch.from_numpy(deltas))
    np.testing.assert_array_equal(b2.values().numpy(), np.asarray(a2.values()))
    assert b2.values()[0, 0].item() == big + 20


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_scalar_store_matches(impl):
    rng = np.random.default_rng(8)
    a, b = _stores(12, (), scatter_impl=impl)
    ids = rng.integers(-2, 15, 30).astype(np.int32)
    deltas = rng.normal(0, 1, 30).astype(np.float32)
    a2 = a.push(jnp.asarray(ids), jnp.asarray(deltas))
    b2 = b.push(torch.from_numpy(ids), torch.from_numpy(deltas))
    np.testing.assert_allclose(b2.values().numpy(), np.asarray(a2.values()), rtol=RTOL, atol=ATOL)


def test_from_values_matches_packed():
    vals = np.random.default_rng(9).normal(0, 1, (21, 32)).astype(np.float32)
    a = ref.ShardedParamStore.from_values(jnp.asarray(vals), layout="packed")
    b = port.ShardedParamStore.from_values(torch.from_numpy(vals), layout="packed", device="cpu")
    np.testing.assert_array_equal(b.table.numpy(), np.asarray(a.table))
    np.testing.assert_array_equal(b.values().numpy(), vals)


def test_pallas_rejects_a_dtype_the_kernel_lacks():
    """A table type the kernel does not take raises, on the CPU as on the
    card: no push quietly runs another scatter."""
    b = port.ShardedParamStore.from_values(torch.zeros(8, 4, dtype=torch.float64),
                                           scatter_impl="pallas", device="cpu")
    with pytest.raises(ValueError, match="float32, bfloat16 or int32"):
        b.push(torch.tensor([1, 1]), torch.ones(2, 4, dtype=torch.float64))
    f = port.ShardedParamStore.create(8, (4,), scatter_impl="pallas", device="cpu")
    assert f.push(torch.tensor([1, 1]), torch.ones(2, 4)).values()[1].tolist() == [2.0] * 4
    assert port.pallas_fallback_count() == 0


def test_errors():
    b = port.ShardedParamStore.create(8, (4,), device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        b.push(torch.tensor([1, 2]), torch.ones(2, 3))
    with pytest.raises(ValueError, match="mask shape"):
        b.push(torch.tensor([1, 2]), torch.ones(2, 4), torch.tensor([True]))
    with pytest.raises(ValueError, match="scatter_impl"):
        port.StoreSpec(8, (4,), scatter_impl="sorted")
    with pytest.raises(NotImplementedError, match="Queue 1 #9"):
        port.StoreSpec(8, (4,), mesh=object())
    with pytest.raises(ValueError, match="requires update='add'"):
        port.ShardedParamStore.create(8, (4,), layout="packed", update=lambda t, d: t, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port.ShardedParamStore.create(8, (4,), scatter_impl="pallas", device="cpu").push(
            torch.tensor([1]), torch.ones(1, 4)
        )
