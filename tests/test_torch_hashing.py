"""The port's uint32 hash family against the JAX package's, bit for bit.

The same numpy ids go through ``flink_parameter_server_tpu/ops/hashing.py``
(jax, CPU) and the port's ``ops/hashing.py`` (torch int64 holding uint32
values).  Every output is compared exactly: these are integer hashes, and
the sketches' tables follow from them.  The ids cover the whole uint32
range, the edges 0, 2**31 - 1, 2**31 and 2**32 - 1 included, given as
uint32 and as the int32 a stream would carry.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from flink_parameter_server_tpu.ops import hashing as ref
from flink_parameter_server_tpu_torch.ops import hashing as port

torch.set_num_threads(2)

EDGES = np.array([0, 1, 2, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 2, 2**32 - 1, 12345, 3_000_000_000],
                 dtype=np.uint64)


def _ids(values: np.ndarray, as_int32: bool):
    """The same ids to both packages: uint32 or the int32 bit pattern."""
    u = values.astype(np.uint32)
    x = u.view(np.int32) if as_int32 else u
    return jnp.asarray(x), torch.from_numpy(x.astype(np.int64) if not as_int32 else x.copy())


@pytest.mark.parametrize("as_int32", [False, True])
def test_bucket_and_sign_hash_edges_bitwise(as_int32):
    a, b = ref.hash_params(8, 3)
    xj, xt = _ids(EDGES, as_int32)
    for m in (1, 7, 4096, 1 << 30, 2**31 - 1):
        np.testing.assert_array_equal(port.bucket_hash(xt, a, b, m).numpy(),
                                      np.asarray(ref.bucket_hash(xj, a, b, m)))
    np.testing.assert_array_equal(port.sign_hash(xt, a, b).numpy(), np.asarray(ref.sign_hash(xj, a, b)))
    assert port.bucket_hash(xt, a, b, 4096).dtype == torch.int32
    assert port.sign_hash(xt, a, b).dtype == torch.float32


@pytest.mark.parametrize("as_int32", [False, True])
def test_pair_key_and_permute_ids_edges_bitwise(as_int32):
    xj, xt = _ids(EDGES, as_int32)
    yj, yt = _ids(EDGES[::-1].copy(), as_int32)
    for keys in (1 << 30, 1000, 2**31 - 1):
        np.testing.assert_array_equal(port.pair_key(xt, yt, keys).numpy(),
                                      np.asarray(ref.pair_key(xj, yj, keys)))
    for cap, seed in ((1, 0x5BD1), (1 << 10, 7), (1 << 20, 0x5BD1), (1 << 31, 3)):
        np.testing.assert_array_equal(port.permute_ids(xt, cap, seed).numpy(),
                                      np.asarray(ref.permute_ids(xj, cap, seed)))


def test_fmix32_np_and_hash_params_match():
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(port.fmix32_np(EDGES), ref.fmix32_np(EDGES))
    for n, seed in ((4, 0), (256, 1), (3, 99)):
        for got, want in zip(port.hash_params(n, seed), ref.hash_params(n, seed)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == np.uint32
    # the device finalizer and the host one agree
    h = port._fmix32(torch.from_numpy(EDGES.astype(np.int64))).numpy()
    np.testing.assert_array_equal(h.astype(np.uint32), ref.fmix32_np(EDGES))


def test_permute_ids_rejects_a_capacity_off_a_power_of_two():
    with pytest.raises(ValueError, match="power-of-two"):
        port.permute_ids(torch.arange(4), 1000)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(0, 2**32 - 1), min_size=64, max_size=64), st.integers(0, 2**16),
       st.integers(1, 2**31 - 1))
def test_random_uint32_ids_bitwise(values, seed, m):
    ids = np.array(values, dtype=np.uint64)
    a, b = ref.hash_params(5, seed)
    xj, xt = _ids(ids, as_int32=False)
    np.testing.assert_array_equal(port.bucket_hash(xt, a, b, m).numpy(), np.asarray(ref.bucket_hash(xj, a, b, m)))
    np.testing.assert_array_equal(port.sign_hash(xt, a, b).numpy(), np.asarray(ref.sign_hash(xj, a, b)))
    yj, yt = _ids(ids[::-1].copy(), as_int32=True)
    xj32, xt32 = _ids(ids, as_int32=True)
    np.testing.assert_array_equal(port.pair_key(xt32, yt, m).numpy(), np.asarray(ref.pair_key(xj32, yj, m)))
    np.testing.assert_array_equal(port.permute_ids(xt, 1 << 16, seed).numpy(),
                                  np.asarray(ref.permute_ids(xj, 1 << 16, seed)))
